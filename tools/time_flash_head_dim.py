"""Time the flash kernels at reference_608's attention shape for each
padded head dim, on one GPU.

reference_608 has key_dim 40; the kernels have instances of fixed widths
(48, 64, 128) and read a narrower K into the next one, zero-filling the
columns past K in their loads (``head_dim_plan``). This times, at (B, N,
H, K) = (8, 1296, 8, 40) fp32 in the tokens-major layout, the forward with
lse and the backward of three calls that compute the same attention:

  * ``k40``: the wrapper as the model calls it (the 48-wide instance
    reading K = 40);
  * ``w48`` and ``w64``: q/k/v/g zero-padded to 48 and 64 by the caller,
    so each launches the kernel instance of that width at its full width
    (the output says which width ran).

Run from two checkouts, one call after the other on one card, it compares
two versions of the kernels.

The three are timed in turns (w48, w64, k40, k40, w64, w48) over
``--rounds`` rounds of ``--iters`` launches each, by CUDA events; each
prints its median, min and max over the rounds, so the spread between
rounds stands beside the gap between widths. It checks first that the
padded calls agree with the unpadded one (2e-5 of the largest value).
Prints one JSON line per direction, then the card's name and power limit.

Usage: python tools/time_flash_head_dim.py [--rounds 7] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_head_dim: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (8, 1296, 8, 40)
    q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                  for _ in range(4))
    q = q * shape[-1] ** -0.5
    calls = {"k40": (q, k, v, g)}
    for width in (48, 64):
        calls[f"w{width}"] = tuple(F.pad(t, (0, width - shape[-1]))
                                   for t in (q, k, v, g))

    def forward(name):
        qq, kk, vv, _ = calls[name]
        return fa._launch_forward(qq, kk, vv, "bnhk", with_lse=True)

    residuals = {}
    for name, (qq, kk, vv, gg) in calls.items():
        out, lse = forward(name)
        delta = fa._heads_major((gg.float() * out.float()).sum(-1),
                                "bnhk").contiguous()
        residuals[name] = (lse, delta)
        got = fa._launch_backward(qq, kk, vv, gg, lse, delta, "bnhk")
        if name == "k40":
            want_out, want_grads = out, got
            continue
        for a, b in zip((out, *got), (want_out, *want_grads)):
            a = a[..., :shape[-1]]
            err = (a - b).abs().max().item() / b.abs().max().item()
            if err > 2e-5:
                raise SystemExit(f"time_flash_head_dim: {name} differs from "
                                 f"k40 by {err} of the largest value")

    def backward(name):
        qq, kk, vv, gg = calls[name]
        return fa._launch_backward(qq, kk, vv, gg, *residuals[name], "bnhk")

    widths = {name: fa._pad_head_dim(calls[name][0]).shape[-1]
              for name in calls}
    order = ["w48", "w64", "k40"]
    order += order[::-1]
    for direction, fn in (("forward_lse", forward), ("backward", backward)):
        samples = {name: [] for name in calls}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            for name in calls:
                fn(name)
        for _ in range(args.rounds):
            for name in order:
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.iters):
                    fn(name)
                end.record()
                torch.cuda.synchronize()
                samples[name].append(start.elapsed_time(end) / args.iters)
        print(json.dumps({
            "direction": direction, "shape_bnhk": shape, "dtype": "float32",
            "rounds": args.rounds * 2, "iters": args.iters,
            "ms": {name: {"kernel_width": widths[name],
                          "median": statistics.median(s), "min": min(s),
                          "max": max(s)}
                   for name, s in samples.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
