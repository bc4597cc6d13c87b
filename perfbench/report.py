"""The result line of a run."""

from __future__ import annotations

import math
import subprocess
from typing import Dict, List

from perfbench import compare, manifest


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def metrics(run, cell, traced: bool) -> Dict[str, dict]:
    if not traced:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run, cell, traced: bool) -> dict:
    import torch

    limits = cell.traffic["limits"]
    checks = {k: {"value": run.numbers[k], "limit": limits[k]}
              for k in limits}
    correct = compare.verdict(run.numbers, limits) and run.failed == 0 \
        and run.answered_all
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(run.device),
              "count": cell.chips,
              "memory_peak_bytes": int(run.peak_bytes),
              "power_limit": _power_limit()}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed),
           "metrics": metrics(run, cell, traced), "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    for check in checks.values():
        if not math.isfinite(check["value"]):
            check["value"] = str(check["value"])
    out["checks"] = checks
    return out


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']} (limit {c['limit']})"
            for name, c in checks.items()]
