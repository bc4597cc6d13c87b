"""What the per-layer readers (``metrics/<name>.py``) compute from a run."""

from __future__ import annotations

import statistics
from typing import Optional

from perfbench import flops


def _tokens(cfg: dict) -> int:
    h, w = cfg["image_size"]
    p = cfg["patch_size"]
    return (-(-h // p)) * (-(-w // p))


def mean_span_ms(run, span: str) -> Optional[float]:
    values = run.spans.get(span)
    return statistics.fmean(values) * 1e3 if values else None


def mfu_pct(run, passes: float) -> Optional[float]:
    """``passes`` forward passes' FLOPs an image (3 for a training step)
    over the window, against the bf16 peak."""
    if not run.window_s or not run.images:
        return None
    rate = flops.forward_flops(run.cfg) * passes * run.images / run.window_s
    return 100.0 * rate / flops.PEAK_BF16_FLOPS


def group_ms_per_unit(run, group: str) -> Optional[float]:
    trace = run.trace
    if trace is None or not trace.units or group not in trace.group_s:
        return None
    return trace.group_s[group] / trace.units * 1e3


def idle_pct(run) -> Optional[float]:
    trace = run.trace
    if trace is None or not trace.window_s or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def flash_roofline_pct(run, backward: bool) -> Optional[float]:
    """Each traced call's attention bound (``blocks`` flash calls of
    (batch * heads, tokens, key_dim), forward with the lse when the step
    trains, and the backward) over the flash kernels' device time."""
    trace, cfg = run.trace, run.cfg
    if trace is None or not trace.units or cfg["compute_dtype"] != "bfloat16":
        return None
    groups = ("flash_fwd", "flash_bwd") if backward else ("flash_fwd",)
    seconds = sum(trace.group_s.get(g, 0.0) for g in groups)
    if not seconds or (backward and not trace.group_s.get("flash_bwd")):
        return None
    bh = run.traffic["batch"] * cfg["num_heads"]
    n, k = _tokens(cfg), cfg["key_dim"]
    bound = flops.bound_seconds(*flops.flash_forward(bh, n, k, 2,
                                                     with_lse=backward))
    if backward:
        bound += flops.bound_seconds(*flops.flash_backward(bh, n, k, 2))
    return 100.0 * trace.units * cfg["encoder_blocks"] * bound / seconds
