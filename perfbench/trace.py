"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
more units of the cell's work after the measured window (calls, steps, or
seconds of serving), so the window itself runs as in ``--trace 0``.
Reduced in memory to what the per-layer metrics and the breakdown read;
no chrome trace is written.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from perfbench import kernel_groups


@dataclasses.dataclass
class Summary:
    window_s: float                  # the traced window, host clock
    busy_s: float                    # device activity, union of intervals
    units: int                       # calls or steps inside the window
    group_s: Dict[str, float]        # device seconds by kernel group
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Tracer:
    """``begin`` and ``end`` bracket the traced work, each after a
    synchronize, so the trace holds the device work of exactly the traced
    units; ``summary`` holds what the trace read."""

    def __init__(self, sync=None):
        self.sync = sync or (lambda: None)
        self.prof = None
        self.summary: Optional[Summary] = None
        self._t0 = 0.0
        self._units0 = 0

    def begin(self, units: int = 0) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()
        self._units0 = units

    def end(self, units: int = 0) -> None:
        self.sync()
        window = time.perf_counter() - self._t0
        self.prof.stop()
        self.summary = summarize(self.prof, window, units - self._units0)
        self.prof = None


def _is_device(event) -> bool:
    """A kernel, copy or fill on the card; not a host span mirrored onto
    the device timeline (``record_function``'s user annotations)."""
    kind = str(getattr(event, "device_type", ""))
    return (kind.endswith("CUDA")
            and not getattr(event, "is_user_annotation", False)
            and not event.name.startswith("perfbench."))


def summarize(prof, window_s: float, units: int) -> Summary:
    events = prof.events()
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if _is_device(e):
            device.append((start, end, e.name))
        elif not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host.append((start, end, e.name))
    group_s: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for start, end, name in device:
        group = kernel_groups.group_of(name)
        group_s[group] += (end - start) / 1e6
        by_name[name] += (end - start) / 1e6
    # Device busy: the union of the activity intervals.
    merged: List[List[float]] = []
    for start, end, _ in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged) / 1e6
    gaps = []
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        gaps.append((start - end, end, start))
    gaps.sort(reverse=True)
    host.sort()
    idle = []
    for length, start, end in gaps[:10]:
        idle.append((_host_at(host, (start + end) / 2), length / 1e6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s, busy, units, dict(group_s),
                   [(n[:200], s) for n, s in ops], idle)


def _host_at(host, t: float) -> str:
    """What the host was doing at ``t``: the outermost and the innermost
    host event that spans it."""
    spanning = [(end - start, name) for start, end, name in host
                if start <= t <= end]
    if not spanning:
        return "no host event"
    spanning.sort()
    inner, outer = spanning[0][1], spanning[-1][1]
    name = outer if inner == outer else f"{outer} > {inner}"
    return name[:200]
