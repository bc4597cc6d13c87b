"""Profiling and timing utilities.

Counterpart of vision_transformer_detector_tpu/utils/profiling.py:
  * ``trace`` — context manager around ``torch.profiler`` (host and, on a
    card, device activity) writing a Chrome trace;
  * ``time_cuda`` — warm up, then time a loop of calls: on a card with
    CUDA events around the loop and one synchronize at its end, on the CPU
    with the host clock;
  * ``flops_estimate`` — analytic FLOPs of a detector config, copied as it
    is from the JAX package (tests/test_torch_self_contained.py holds the
    copy equal).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

from ..config import DetectorConfig


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/trace') as prof: step()``.
    Writes ``<log_dir>/trace.json`` (chrome://tracing, Perfetto) when the
    block ends and yields the profiler, whose ``key_averages()`` sums the
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(device) -> None:
    import torch

    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(result):
    """The device of the first tensor in ``result`` (a tensor or a nest of
    tuples, lists and dicts), or None."""
    import torch

    if isinstance(result, torch.Tensor):
        return result.device
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            device = _device_of(item)
            if device is not None:
                return device
    return None


def time_cuda(fn: Callable, *args, iterations: int = 10,
              warmup: int = 1) -> Tuple[float, float]:
    """(seconds_per_call, calls_per_second) of ``fn(*args)``.

    ``warmup`` calls first (at least one: builds, autotuning and caches),
    then ``iterations`` calls timed as one loop. When the warm-up result
    lies on a card, the loop is bracketed by CUDA events and ends in one
    synchronize, so the time is the device's; otherwise it is the host
    clock's. Raises ValueError for a non-positive ``iterations``."""
    import torch

    if iterations <= 0:
        raise ValueError(f"iterations must be positive, got {iterations}")
    result = None
    for _ in range(max(1, warmup)):
        result = fn(*args)
    device = _device_of(result)
    _synchronize(device)
    if device is not None and device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn(*args)
        end.record()
        end.synchronize()
        elapsed = start.elapsed_time(end) / 1e3
    else:
        tic = time.perf_counter()
        for _ in range(iterations):
            fn(*args)
        elapsed = time.perf_counter() - tic
    per_call = elapsed / iterations
    return per_call, 1.0 / per_call


def flops_estimate(config: DetectorConfig, batch_size: int = 1) -> float:
    """Analytic forward FLOPs (matmuls only; 2*M*N*K convention)."""
    tokens = config.num_patches
    d = config.embedding_dim
    h, k = config.num_heads, config.key_dim

    flops = 2.0 * tokens * config.patch_dim * d  # patch projection

    per_block = 0.0
    per_block += 3 * 2.0 * tokens * d * h * k       # qkv projections
    if config.attention_window:
        window_tokens = config.attention_window ** 2
        per_block += 2 * 2.0 * tokens * window_tokens * h * k
    else:
        per_block += 2 * 2.0 * tokens * tokens * h * k  # scores + p@v
    per_block += 2.0 * tokens * h * k * d           # output projection
    in_dim = d
    for units in config.encoder_mlp_units:
        per_block += 2.0 * tokens * in_dim * units
        in_dim = units
    flops += config.encoder_blocks * per_block

    if config.head_scales == (1,):
        flops += 2.0 * tokens * d * config.max_objects  # token dense
        in_dim = config.num_patches
    else:
        # Multi-scale head (models/vit_detector.py): one token-dense per
        # pooled grid; the per-slot feature concatenates over scales.
        gh, gw = config.grid_size
        in_dim = 0
        for s in config.head_scales:
            pooled = (gh // s) * (gw // s)
            flops += 2.0 * pooled * d * config.max_objects
            in_dim += pooled
    for units in config.head_units:
        for _ in range(config.head_block_repeats):
            flops += 2.0 * config.max_objects * in_dim * units
            in_dim = units
    flops += 2.0 * config.max_objects * in_dim * 6

    return flops * batch_size
