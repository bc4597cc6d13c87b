"""One run of one cell: set-up, the measured window, the check of what the
timed path produced against the plain reference.

A traffic mix's ``kind`` names its driver, ``drivers/<kind>.py``, found by
name as a metric's reader is; every number a driver uses (batch, pool of
inputs, rates, batcher settings, sample sizes, limits) comes from the
mix's file. A driver module defines ``Driver(run)`` with ``setup()``,
``window(seconds)``, ``trace(tracer)``, ``end_to_end()``, ``release()``,
``check()`` and, for the readings, ``make_inputs()`` and ``control()``.
The program is the PyTorch port; this module and the drivers import it
only inside functions, and the reference (``perfbench/reference``) never.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, inputs, manifest
from perfbench.reference import vit_detector as ref
from perfbench.trace import Tracer

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_config(cfg: dict):
    from vision_transformer_detector_tpu_torch.config import configs_from_dict

    return configs_from_dict({"detector": cfg})[0]


def port_model(config, weights: Dict[str, torch.Tensor]):
    """The port's model holding the benchmark's weights (no copy)."""
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        ViTDetector)

    with torch.device("meta"):
        model = ViTDetector(config)
    model.load_state_dict(weights, strict=True, assign=True)
    return model


class Run:
    """What one run measured. The per-layer readers (``metrics/``) read
    it: ``cfg``, ``traffic``, ``images``, ``units``, ``window_s``,
    ``spans`` (host seconds by span name), ``counters``, ``trace`` (a
    ``trace.Summary`` or None) and ``peak_bytes``."""

    def __init__(self, cell, seed: int, seconds: float, device):
        self.cell = cell
        self.cfg = cell.config["detector"]
        self.traffic = cell.traffic
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.port_cfg = port_config(self.cfg)
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.counters: Dict[str, float] = {}
        self.trace = None
        self.window_s = 0.0
        self.units = 0
        self.images = 0
        self.attempted = 0
        self.failed = 0
        self.answered_all = True
        self.peak_bytes = 0
        self.setup_s = 0.0
        self.end_to_end: Dict[str, float] = {}
        self.numbers: Dict[str, float] = {}
        self.detail: dict = {}       # per-leaf norms of a training check
        self.notes: List[str] = []


class SpanService:
    """Delegates to a ``DetectionService`` and times each ``predict_raw``
    call on the host (until it returns; the device work is not waited
    for)."""

    def __init__(self, service, spans: List[float]):
        self.service = service
        self.config = service.config
        self.spans = spans
        self.raws: list = []     # every packed output, for nms_breaks

    def predict_raw(self, images):
        with torch.profiler.record_function("perfbench.predict_raw"):
            tic = time.perf_counter()
            raw = self.service.predict_raw(images)
            self.spans.append(time.perf_counter() - tic)
        self.raws.append(raw)
        return raw

    def raw_to_detections(self, raw):
        with torch.profiler.record_function("perfbench.raw_to_detections"):
            return self.service.raw_to_detections(raw)


class Detector:
    """What the inference drivers share: the service on the seeded
    weights, and the check of sampled answers against the reference."""

    def __init__(self, run: Run):
        self.run = run
        self.t = run.traffic

    def make_service(self):
        from vision_transformer_detector_tpu_torch.serving import (
            DetectionService)

        run = self.run
        weights = inputs.make_weights(run.cfg, run.seed, run.device)
        model = port_model(run.port_cfg, weights)
        del weights
        service = DetectionService(run.port_cfg, model, device=run.device)
        return SpanService(service, run.spans["predict_raw"])

    def reference_decoded(self, images: np.ndarray,
                          prec=ref.EXACT) -> np.ndarray:
        """(n, slots, 6) decoded reference values of uint8 ``images``."""
        run = self.run
        weights = inputs.make_weights(run.cfg, run.seed, run.device)
        out = []
        chunk = self.t["reference_chunk"]
        with torch.no_grad(), ref.strict_fp32():
            for start in range(0, len(images), chunk):
                x = torch.from_numpy(images[start:start + chunk]).to(
                    run.device)
                out.append(ref.decode(ref.forward(weights, x, run.cfg, prec),
                                      run.cfg).double().cpu().numpy())
        del weights
        return np.concatenate(out)

    def compare_answers(self, answers, images: np.ndarray,
                        raws) -> Dict[str, float]:
        cfg = self.run.cfg
        height, width = cfg["image_size"]
        numbers = compare.detection_gaps(
            answers, self.reference_decoded(images), float(width),
            float(height), cfg["num_classes"])
        numbers["nms_breaks"] = compare.nms_breaks(raws)
        return numbers

    def control_answers(self, images: np.ndarray) -> list:
        """The control in the program's place: the reference with its
        products in float8 e4m3, through the same decode and NMS."""
        decoded = torch.from_numpy(self.reference_decoded(images,
                                                          ref.fp8_e4m3()))
        return ref.detections(decoded), [ref.packed(decoded)]


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started: float, prepare=None) -> Run:
    """Set up, measure ``seconds``, with ``trace`` trace a few more units
    of the same work, free the program, check. ``started``
    is the process's start on the host clock; ``prepare(driver)`` may
    change the driver before set-up (the tests plant faults there)."""
    run = Run(cell, seed, seconds, device)
    driver = manifest.driver(cell.traffic["kind"])(run)
    if prepare is not None:
        prepare(driver)
    driver.setup()
    _sync(run.device)
    run.setup_s = time.perf_counter() - started
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    driver.window(seconds)
    _sync(run.device)
    if run.device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
    if trace:
        tracer = Tracer(sync=lambda: _sync(run.device))
        driver.trace(tracer)
        run.trace = tracer.summary
    run.end_to_end = driver.end_to_end()
    driver.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.numbers = driver.check()
    return run
