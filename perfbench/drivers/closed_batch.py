"""The ``closed_batch`` traffic kind: offline batch inference."""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np

from perfbench import inputs
from perfbench.harness import Detector
from perfbench.trace import Tracer


class Driver(Detector):
    """One caller sending batches back to back, call i + 1 dispatched
    before call i's detections are read back
    (``DetectionService.predict_raw`` + ``raw_to_detections``)."""

    def make_inputs(self) -> None:
        run = self.run
        self.batch = self.t["batch"]
        self.pool = [inputs.make_images(self.batch, run.cfg, run.seed,
                                        f"images.{r}", run.device
                                        ).cpu().numpy()
                     for r in range(self.t["distinct_batches"])]

    def setup(self) -> None:
        self.make_inputs()
        self.service = self.make_service()
        for i in range(self.t["warmup_calls"]):
            self.service.raw_to_detections(self.service.predict_raw(
                self.pool[i % len(self.pool)]))
        self.run.spans["predict_raw"].clear()
        self.service.raws.clear()

    def calls(self, seconds: float = math.inf, count: int = 0) -> int:
        """Call after call, each dispatched before the previous call's
        detections are read back, for ``seconds`` or ``count`` calls. The
        packed outputs stay in ``service.raws``; the detections read back
        are dropped (the check converts the sampled calls' packed outputs
        again after the window), so the window retains no Python object
        per detection."""
        service, pool = self.service, self.pool
        calls, pending = 0, None
        tic = time.perf_counter()
        while True:
            raw = service.predict_raw(pool[calls % len(pool)])
            if pending is not None:
                service.raw_to_detections(pending)
            pending = raw
            calls += 1
            if calls == count or time.perf_counter() - tic >= seconds:
                break
        service.raw_to_detections(pending)
        return calls

    def window(self, seconds: float) -> None:
        run = self.run
        tic = time.perf_counter()
        calls = self.calls(seconds)
        run.window_s = time.perf_counter() - tic
        run.units = calls
        run.images = run.attempted = calls * self.batch

    def trace(self, tracer: Tracer) -> None:
        kept = list(self.service.raws)
        tracer.begin(0)
        tracer.end(self.calls(count=self.t["trace_units"]))
        self.service.raws = kept

    def end_to_end(self) -> Dict[str, float]:
        return {"infer_img_per_s": self.run.images / self.run.window_s}

    def release(self) -> None:
        self.raws = [r.cpu().numpy() for r in self.service.raws]
        self.calls_made = len(self.raws)
        del self.service

    def sample(self):
        """The (call, image) pairs checked: drawn from the seed over every
        image the window answered."""
        picked = inputs.choice(self.t["check_images"],
                               self.calls_made * self.batch,
                               self.run.seed, "check")
        calls, rows = picked // self.batch, picked % self.batch
        images = np.stack([self.pool[c % len(self.pool)][r]
                           for c, r in zip(calls, rows)])
        return calls, rows, images

    def check(self) -> Dict[str, float]:
        calls, rows, images = self.sample()
        from vision_transformer_detector_tpu_torch.serving import (
            DetectionService)

        answers = [DetectionService.raw_to_detections(self.raws[c][r:r + 1])[0]
                   for c, r in zip(calls, rows)]
        return self.compare_answers(answers, images, self.raws)

    def control(self) -> Dict[str, float]:
        self.calls_made = self.t["distinct_batches"]
        _, _, images = self.sample()
        answers, raws = self.control_answers(images)
        return self.compare_answers(answers, images, raws)
