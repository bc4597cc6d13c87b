"""The ``open_loop`` traffic kind: independent users of a served
detector."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from perfbench import inputs
from perfbench.harness import Detector
from perfbench.trace import Tracer


class Driver(Detector):
    """Single images offered on a fixed seeded schedule through
    ``BatchingDetectionService.submit`` from a pool of submitter threads,
    each request timed from when it was due."""

    def make_inputs(self) -> None:
        run, t = self.run, self.t
        self.pool = inputs.make_images(t["distinct_images"], run.cfg,
                                       run.seed, "serve.images", run.device
                                       ).cpu().numpy()
        self.schedule(t["rate_per_s"], run.seconds)

    def schedule(self, rate: float, seconds: float,
                 stream: str = "serve") -> None:
        """The due times and the pool image of each request."""
        run = self.run
        self.due = inputs.arrivals(rate, seconds, run.seed, stream)
        self.which = inputs.pick(len(self.due), len(self.pool), run.seed,
                                 stream + ".which")

    def setup(self) -> None:
        from vision_transformer_detector_tpu_torch.serving import (
            BatchingDetectionService)

        t = self.t
        self.make_inputs()
        self.service = self.make_service()
        self.batcher = BatchingDetectionService(
            self.service, max_batch=t["max_batch"],
            max_wait_ms=t["max_wait_ms"],
            pipeline_depth=t["pipeline_depth"],
            completer_threads=t["completer_threads"],
            bucket_mode=t["bucket_mode"])
        self.batcher.warmup()
        self.service.raws.clear()
        self.executor = ThreadPoolExecutor(max_workers=t["submit_threads"])
        # Start every submitter thread now, not in the window.
        barrier = threading.Barrier(t["submit_threads"])
        for f in [self.executor.submit(barrier.wait)
                  for _ in range(t["submit_threads"])]:
            f.result()
        self.run.spans["predict_raw"].clear()

    def _request(self, i: int, due: float) -> None:
        try:
            dets = self.batcher.submit(self.pool[self.which[i]],
                                       timeout=self.timeout)
            self.latency[i] = time.perf_counter() - due
            # Only the sampled answers are kept: the window retains no
            # Python object per detection.
            if i in self.sampled:
                self.answers[i] = dets
        except Exception as exc:       # counted as failed, never as correct
            self.errors[i] = repr(exc)
        finally:
            with self._lock:
                self._pending -= 1
                if not self._pending:
                    self._all_done.set()

    def offer(self, seconds: float) -> np.ndarray:
        """Offer ``self.due``'s requests on time, wait for every answer (a
        minute past the close at most); returns how late each was sent."""
        n = len(self.due)
        self.timeout = seconds + 60.0
        self.latency = np.full(n, np.nan)
        self.sampled = set(self.sample(np.arange(n)).tolist())
        self.answers: Dict[int, list] = {}
        self.errors: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._pending = n
        self._all_done = threading.Event()
        late = np.zeros(n)
        start = time.perf_counter() + 0.01
        for i in range(n):
            due = start + self.due[i]
            now = time.perf_counter()
            while now < due:
                time.sleep(min(due - now, 0.001))
                now = time.perf_counter()
            late[i] = now - due
            self.executor.submit(self._request, i, due)
        self.run.counters["queue_depth_at_last_send"] = \
            self.batcher.stats()["queue_depth"]
        self._all_done.wait(max(0.0, start + seconds + 60.0
                                - time.perf_counter()))
        return late

    def window(self, seconds: float) -> None:
        run = self.run
        before = self.batcher.stats()
        spans = run.spans["predict_raw"]
        late = self.offer(seconds)
        after = self.batcher.stats()
        n = len(self.due)
        done = np.isfinite(self.latency)
        run.window_s = float(np.nanmax(self.latency + self.due)
                             ) if done.any() else seconds
        run.units = len(spans)
        run.attempted = n
        run.failed = int(n - done.sum())
        run.images = int(done.sum())
        run.answered_all = run.failed == 0
        run.counters["batches_served"] = (after["batches_served"]
                                          - before["batches_served"])
        run.counters["images_served"] = (after["images_served"]
                                          - before["images_served"])
        if self.errors:
            run.notes.append(f"{len(self.errors)} requests failed; the first: "
                             f"{next(iter(self.errors.values()))}")
        run.notes.append(
            f"generator lateness: median {np.median(late) * 1e3:.3f} ms, "
            f"p95 {np.percentile(late, 95) * 1e3:.3f} ms, "
            f"max {late.max() * 1e3:.3f} ms over {n} requests")

    def trace(self, tracer: Tracer) -> None:
        """``trace_seconds`` more of the same traffic, traced; its answers
        are not kept."""
        kept = (self.due, self.which, self.latency, self.answers,
                self.errors, self.timeout, self.sampled,
                list(self.service.raws))
        self.schedule(self.t["rate_per_s"], self.t["trace_seconds"],
                      "serve.trace")
        spans = self.run.spans["predict_raw"]
        tracer.begin(len(spans))
        self.offer(self.t["trace_seconds"])
        tracer.end(len(spans))
        (self.due, self.which, self.latency, self.answers, self.errors,
         self.timeout, self.sampled, self.service.raws) = kept

    def end_to_end(self) -> Dict[str, float]:
        # A request that failed or never came counts at the timeout.
        lat = np.where(np.isfinite(self.latency), self.latency,
                       self.timeout) * 1e3
        return {"serve_p50_ms": float(np.percentile(lat, 50)),
                "serve_p95_ms": float(np.percentile(lat, 95))}

    def release(self) -> None:
        self.batcher.stop()
        self.executor.shutdown(wait=True)
        self.raws = [r.cpu().numpy() for r in self.service.raws]
        del self.batcher, self.service

    def sample(self, answered: np.ndarray) -> np.ndarray:
        picked = inputs.choice(self.t["check_requests"], len(answered),
                               self.run.seed, "check")
        return answered[picked]

    def check(self) -> Dict[str, float]:
        chosen = np.array(sorted(self.answers), dtype=int)
        images = self.pool[self.which[chosen]]
        return self.compare_answers([self.answers[i] for i in chosen],
                                    images, self.raws)

    def control(self) -> Dict[str, float]:
        chosen = self.sample(np.arange(len(self.due)))
        images = self.pool[self.which[chosen]]
        answers, raws = self.control_answers(images)
        return self.compare_answers(answers, images, raws)
