"""Time the flash kernels at head dims past 128 (bf16) and the fused
LayerNorm past D 4096, beside their library calls, on one GPU.

Shapes (bf16, 1/sqrt(K) applied, tokens-major as the model hands them
over):

  * ``w192``, ``w256``: (8, 256, 16, K), (B*H, N, K) = (128, 256, K);
  * ``k256_b8``, ``k256_b32``: the K-256 detector (5 heads of 256) at
    batch 8 and 32, (40, 256, 256) and (160, 256, 256);
  * ``h64``, ``h128``: the 64 and 128 instances at (2048, 256, K),
    highres_1024's batch-8 fold and its K-128 counterpart;
  * ``ln768``: vit_b16_384's LayerNorm at batch 32, (18432, 768);
  * ``ln6144``, ``ln8192``: (2048, D), a batch of 8 at 256 tokens at
    ViT-22B's width, and D 8192.

For each flash shape: the forward (B1), the forward with lse (B1-lse) and
the backward (B2) in ms (CUDA events: the mean over ``--iters`` launches,
the median, min and max over ``--rounds`` rounds, after a warm-up), the
kernels each launches with their device ms a call (torch.profiler),
scaled_dot_product_attention's forward and its backward on the same
(heads-major) inputs (event and device ms), the bound (the larger of the
products at 989 TFLOP/s and the bytes, each input read once and each
output written once, at 3.35 TB/s) and the largest error against the
plain version relative to its largest value. For each LayerNorm shape:
the kernel and F.layer_norm (event and device ms) and the bound
likewise; a checkout whose kernel refuses the width says so. Prints one
JSON line per shape, then the card's name and power limit.

``--repo PATH`` imports the port from another checkout (a parent's,
unpacked with ``git archive``), so one call on one card can time two
versions in turns:

    python3 tools/time_wide_kernels_torch.py --repo parent --label parent
    python3 tools/time_wide_kernels_torch.py --label change
    python3 tools/time_wide_kernels_torch.py --label change
    python3 tools/time_wide_kernels_torch.py --repo parent --label parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
FLASH = {"w192": (8, 16, 192), "w256": (8, 16, 256),
         "k256_b8": (8, 5, 256), "k256_b32": (32, 5, 256),
         "h64": (128, 16, 64), "h128": (128, 16, 128)}
LAYER_NORM = {"ln768": (18432, 768), "ln6144": (2048, 6144),
              "ln8192": (2048, 8192)}


def _time_ms(torch, fn, iters: int, rounds: int) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return {"median": statistics.median(means), "min": min(means),
            "max": max(means)}


def _kernels(torch, fn, iters: int) -> dict:
    """The CUDA kernels a call of fn launches (torch.profiler over
    ``iters`` calls), each with its device ms a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Memcpy" not in e.key and "Memset" not in e.key}


def _bound(ops: float, nbytes: float, peak: float):
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def _flash(torch, fa, gen, name, batch, heads, kd, args) -> dict:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n = 256
    ts = [torch.randn(batch, n, heads, kd, device="cuda", generator=gen)
          for _ in range(4)]
    q, k, v, g = [t.to(torch.bfloat16) for t in (ts[0] * kd ** -0.5, *ts[1:])]
    bh = batch * heads
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            "bnhk").contiguous()
    runs = {
        "fwd": lambda: fa.flash_attention(q, k, v),
        "fwd_lse": lambda: fa.flash_attention(q, k, v, with_lse=True),
        "bwd": lambda: fa._launch_backward(q, k, v, g, lse, delta, "bnhk")}
    want = fa.reference_attention(q, k, v)
    errors = {"fwd": _rel(runs["fwd"](), want),
              "lse": (lse - fa.reference_attention_lse(q, k)).abs().max()
              .item(),
              "bwd": max(_rel(a, b) for a, b in zip(
                  runs["bwd"](), fa.reference_attention_backward(
                      q, k, v, g)))}
    operand = bh * n * kd * 2
    rows = bh * n * 4
    bounds = {"fwd": _bound(4 * bh * n * n * kd, 4 * operand, BF16_OPS_PER_S),
              "fwd_lse": _bound(4 * bh * n * n * kd, 4 * operand + rows,
                                BF16_OPS_PER_S),
              # q, k, v, g read and dk, dv, dq written in bf16; lse and
              # delta read.
              "bwd": _bound(10 * bh * n * n * kd, 7 * operand + 2 * rows,
                            BF16_OPS_PER_S)}
    hm = [fa._heads_major(t, "bnhk") for t in (q, k, v, g)]
    leaves = [t.detach().clone().requires_grad_() for t in hm[:3]]
    lib, backend_name = None, None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                lib_out = F.scaled_dot_product_attention(*leaves, scale=1.0)
            backend_name = backend.name

            def lib_fwd(backend=backend):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(*hm[:3], scale=1.0)

            lib = {"fwd": lib_fwd,
                   "bwd": lambda: torch.autograd.grad(
                       lib_out, leaves, hm[3], retain_graph=True)}
            break
        except RuntimeError:
            continue
    result = {"label": args.label, "shape": name, "bhnk": [bh, n, kd],
              "forward_kernel": fa.forward_kernel(kd, q.dtype),
              "backward_kernel": fa.backward_kernel(kd, q.dtype),
              "errors": errors, "sdpa_backend": backend_name}
    for what, fn in runs.items():
        result[what] = {"ms": _time_ms(torch, fn, args.iters, args.rounds),
                        "kernels": _kernels(torch, fn, args.iters),
                        "bound_ms": bounds[what][0],
                        "bound_by": bounds[what][1]}
    if lib is not None:
        for what in ("fwd", "bwd"):
            result[f"sdpa_{what}_ms"] = _time_ms(torch, lib[what], args.iters,
                                                 args.rounds)
            result[f"sdpa_{what}_kernels"] = _kernels(torch, lib[what],
                                                      args.iters)
    return result


def _layer_norm(torch, fused_ln, gen, name, rows, d, args) -> dict:
    import torch.nn.functional as F

    x = (3 * torch.randn(rows, d, device="cuda", generator=gen) + 1).to(
        torch.bfloat16)
    gamma, beta = (torch.randn(d, device="cuda", generator=gen)
                   for _ in range(2))
    gamma16, beta16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    result = {"label": args.label, "shape": name, "rows_d": [rows, d]}
    # x read and the output written in bf16, gamma and beta in fp32;
    # about 7 fp32 operations an element.
    result["bound_ms"], result["bound_by"] = _bound(
        7 * rows * d, 4 * rows * d + 8 * d, FP32_OPS_PER_S)
    with torch.inference_mode():
        try:
            got = fused_ln.fused_layer_norm(x, gamma, beta)
        except ValueError as refused:
            result["refused"] = str(refused)
        else:
            result["max_rel_err"] = _rel(got, fused_ln.layer_norm_reference(
                x, gamma, beta))
            result["kernel_ms"] = _time_ms(
                torch, lambda: fused_ln.fused_layer_norm(x, gamma, beta),
                args.iters, args.rounds)
            result["kernels"] = _kernels(
                torch, lambda: fused_ln.fused_layer_norm(x, gamma, beta),
                args.iters)
        result["f_layer_norm_ms"] = _time_ms(
            torch, lambda: F.layer_norm(x, (d,), gamma16, beta16, eps=1e-3),
            args.iters, args.rounds)
        result["f_layer_norm_kernels"] = _kernels(
            torch, lambda: F.layer_norm(x, (d,), gamma16, beta16, eps=1e-3),
            args.iters)
    return result


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to import")
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--shapes", default=",".join([*FLASH, *LAYER_NORM]))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, fused_ln)

    if not torch.cuda.is_available():
        raise SystemExit("time_wide_kernels_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    name_power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for name in args.shapes.split(","):
        if name in FLASH:
            result = _flash(torch, fa, gen, name, *FLASH[name], args)
        else:
            result = _layer_norm(torch, fused_ln, gen, name,
                                 *LAYER_NORM[name], args)
        print(json.dumps(dict(result, card=name_power)), flush=True)
        torch.cuda.empty_cache()
    print(name_power)


if __name__ == "__main__":
    main()
