"""Where the time of one PyTorch-port train step goes, on one GPU.

Runs the reference_608 train step (fp32, flash attention through the
port's CUDA kernels) at batch 8 on seeded weights and synthetic data:
the median wall time of 10 synchronised steps, then ``torch.profiler``
over 3 steps: device time by kernel name, the device's busy share of the
wall time, and the share of the flash kernels. Prints one JSON line.

Usage: python tools/profile_train_torch.py [--batch 8]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()
    preset, top_kernels = "reference_608", 12

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: needs a CUDA device")
    config = get_config(preset)
    trainer = Trainer(config, LossConfig(), TrainConfig(), device="cuda")
    state = trainer.init_state()
    images, labels = (torch.from_numpy(a).to("cuda") for a in next(
        synthetic_batches(config, args.batch, 1, seed=0)))

    def step():
        trainer.train_step(state, images, labels)

    for _ in range(3):
        step()
    wall = []
    for _ in range(10):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - tic) * 1e3)

    steps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - tic) * 1e3 / steps
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + us / 1e3
                            / steps, evt.count // steps)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        raise SystemExit("profile_train_torch: the profiler saw no device "
                         "time; time with CUDA events instead")
    flash = sum(ms for name, (ms, _) in kernels.items()
                if "flash_fwd_kernel" in name or "flash_bwd_kernel" in name)
    gemm = sum(ms for name, (ms, _) in kernels.items()
               if "gemm" in name.lower())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top_kernels]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "preset": preset, "batch": args.batch, "card": card,
        "step_ms_median": float(np.median(wall)), "step_ms_min": min(wall),
        "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy, "busy_share": busy / profiled_ms,
        "flash_ms": flash, "flash_share_of_busy": flash / busy,
        "gemm_ms": gemm, "gemm_share_of_busy": gemm / busy,
        "kernel_launches": sum(n for _, n in kernels.values()),
        "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                for name, (ms, n) in top],
    }))


if __name__ == "__main__":
    main()
