"""Where the time of one PyTorch-port train step goes, on one GPU.

Runs a preset's train step (reference_608 by default: fp32, flash
attention through the port's CUDA kernels) at batch 8 on seeded weights
and synthetic data: the median wall time of 10 synchronised steps, then
``torch.profiler`` over 3 steps: device time by kernel name and by group
(flash forward, flash backward, GEMMs, dropout masks, copies and casts,
the rest), the device's busy share of the wall time, the flash kernels'
launches per step and the peak memory. For a windowed preset it also
times one window fold (the heads-major ``(B, H * windows, tokens, K)``
copy of q, k or v) with CUDA events. Prints one JSON line.

``--dropout`` and ``--remat-policy`` override the preset's fields for
this run (tool options, not package features), e.g. highres_1024 as its
docstring trains it with dropout:

    python tools/profile_train_torch.py --preset highres_1024 \\
        --dropout 0.1 --remat-policy none

``--graph`` profiles the windowed loop instead (train/trainer.py:
make_multi_step, the train step captured once as a CUDA graph and
replayed): a step is one call of one epoch of one batch, with its batch
and seed-row copies; the flash launch counters then count only the
capture, so the launches come from the profiler's kernel events.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Kernel-name fragments of each group; a kernel joins the first group that
# names it. cuBLAS's Hopper GEMMs are "nvjet" or "gemm" kernels; the MLP
# and head dropout is csrc/dropout.cu's "dropout_kernel"; the window folds
# are strided copies, among the "copy" kernels with the dtype casts.
GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_bwd", ("flash_bwd_kernel", "flash_bwd_dq_kernel",
                         "flash_bwd_dq_sum_kernel")),
          ("gemm", ("gemm", "nvjet", "cutlass")),
          ("dropout", ("dropout_kernel",)),
          ("copies_and_casts", ("copy",)))


def _group(name: str) -> str:
    lower = name.lower()
    for group, fragments in GROUPS:
        if any(f in lower for f in fragments):
            return group
    return "rest"


def _fold_ms(config, batch: int) -> float:
    """CUDA-event mean of one heads-major window fold of q (or k, or v)."""
    import torch

    gh, gw = config.grid_size
    n, h, k = gh * gw, config.num_heads, config.key_dim
    tokens = config.attention_window ** 2
    dtype = getattr(torch, config.compute_dtype)
    q = torch.randn(batch, n, h, k, device="cuda").to(dtype)

    def fold():
        return q.transpose(1, 2).reshape(batch, h * (n // tokens), tokens, k)

    for _ in range(3):
        fold()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        fold()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="reference_608")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--dropout", type=float, default=None,
                        help="override the preset's dropout rate")
    parser.add_argument("--remat-policy", default=None,
                        choices=("none", "dots", "alternate"),
                        help="override the preset's remat policy (and "
                             "turn remat on)")
    parser.add_argument("--graph", action="store_true",
                        help="profile the CUDA-graph windowed loop")
    args = parser.parse_args()
    top_kernels = 12

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, make_multi_step)

    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: needs a CUDA device")
    config = get_config(args.preset)
    if args.dropout is not None:
        config = config.replace(dropout=args.dropout)
    if args.remat_policy is not None:
        config = config.replace(
            remat_encoder=True,
            remat_policy=None if args.remat_policy == "none"
            else args.remat_policy)
    trainer = Trainer(config, LossConfig(), TrainConfig(), device="cuda")
    state = trainer.init_state()
    images, labels = (torch.from_numpy(a).to("cuda") for a in next(
        synthetic_batches(config, args.batch, 1, seed=0)))

    if args.graph:
        multi_step = make_multi_step(config, LossConfig(), trainer.optimizer)

        def step():
            multi_step(state, images[None], labels[None], 1)
    else:
        def step():
            trainer.train_step(state, images, labels)

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(10):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - tic) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = 3
    counters = ("launches", "lse_launches", "drop_launches",
                "backward_launches", "backward_drop_launches")
    before = {c: getattr(fa.flash_attention, c) for c in counters}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - tic) * 1e3 / steps
    flash_launches = {c: (getattr(fa.flash_attention, c) - before[c]) / steps
                      for c in counters}
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
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["rest"] = 0.0
    for name, (ms, _) in kernels.items():
        groups[_group(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top_kernels]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {
        "preset": args.preset, "batch": args.batch, "card": card,
        "loop": "cuda_graph" if args.graph else "eager",
        "dropout": config.dropout, "remat_encoder": config.remat_encoder,
        "remat_policy": config.remat_policy,
        "step_ms_median": float(np.median(wall)), "step_ms_min": min(wall),
        "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy, "busy_share": busy / profiled_ms,
        "groups_ms": groups,
        "groups_share_of_busy": {k: v / busy for k, v in groups.items()},
        "flash_launches_per_step": flash_launches,
        "kernel_launches": sum(n for _, n in kernels.values()),
        "peak_memory_gib": peak_gib,
        "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                for name, (ms, n) in top],
    }
    if config.attention_window is not None:
        result["window_fold_ms_each"] = _fold_ms(config, args.batch)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
