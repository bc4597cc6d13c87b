"""Time the flash kernels at wide heads (bf16 past 128, fp32 past 64) and
the fused LayerNorm past D 4096, beside their library calls, on one GPU.

Shapes (1/sqrt(K) applied, tokens-major as the model hands them over;
(B*H, N, K)):

  * ``w192``, ``w256``: (128, 256, K) bf16 on the wgmma 256 instance;
    ``w320``, ``w384``: (128, 256, K) bf16 on the wide forward, ``w576``
    and ``w1024`` on its clusters (of 2 CTAs), ``w4160``: (32, 256, 4160)
    on the windowed one (past the clusters' reach); the backward of all of
    these past K 256 on its clusters (of ceil(K / 256) CTAs), and past its
    reach on its windowed route: ``w2112``, (32, 256, 2112);
  * ``k256_b8``, ``k256_b32``: the K-256 detector (5 heads of 256) at
    batch 8 and 32, (40, 256, 256) and (160, 256, 256);
  * ``h64``, ``h128``: the 64 and 128 instances at (2048, 256, K),
    highres_1024's batch-8 fold and its K-128 counterpart;
  * fp32: ``f80``, ``f96``, ``f128``: (128, 256, K) (ViT-H/14's K 80 at
    batch 8; the column halves, forward and backward); ``f128_h``: (2048,
    256, 128); ``fw192``, ``fw256``, ``fw320``: (128, 256, K) on the wide
    forward, ``fw512`` on its cluster of 2 CTAs (what chip_smoke.py's
    ``wide_heads`` launches at fp32 K 512), the backward of all four on its
    clusters of ceil(K / 128) CTAs; ``fw3104``: (32, 256, 3104) on the
    windowed forward (past fp32's cluster reach, 3072), its backward on the
    windowed route too; ``fw1056``: (32, 256, 1056), the forward on a
    cluster of 3 CTAs, the backward on its windowed route (past 1024);
    ``r608``: reference_608's (64, 1296, 40);
  * ``ln768``: vit_b16_384's LayerNorm at batch 32, (18432, 768);
  * ``ln6144``, ``ln8192``: (2048, D), a batch of 8 at 256 tokens at
    ViT-22B's width, and D 8192.

For each flash shape: the forward (B1), the forward with lse (B1-lse),
the forward with dropout 0.1 and lse (B1-drop) and the backward (B2; fp32
also by the split dq route) in ms (CUDA events: the mean over ``--iters``
launches, the median, min and max over ``--rounds`` rounds, after a
warm-up), the kernels each launches with their device ms a call
(torch.profiler), scaled_dot_product_attention's forward, dropout forward
and backward on the same (heads-major) inputs (the first backend that
runs, and the memory-efficient one; event and device ms), the bound (the
larger of the products at 989 TFLOP/s bf16 or 3 x 495 TF32 per fp32
product, and the bytes, each input read once and each output written
once, at 3.35 TB/s) and the largest error against the plain version
relative to its largest value. For each LayerNorm shape: the kernel and
F.layer_norm (event and device ms) and the bound likewise; a checkout
whose kernel refuses the width says so. Prints one JSON line per shape,
then the card's name and power limit.

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
TF32_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
DROP_RATE = 0.1
# name: (batch, heads, K, dtype, N)
FLASH = {"w192": (8, 16, 192, "bfloat16", 256),
         "w256": (8, 16, 256, "bfloat16", 256),
         "w320": (8, 16, 320, "bfloat16", 256),
         "w384": (8, 16, 384, "bfloat16", 256),
         "w576": (8, 16, 576, "bfloat16", 256),
         "w1024": (8, 16, 1024, "bfloat16", 256),
         "w4160": (2, 16, 4160, "bfloat16", 256),
         "w2112": (2, 16, 2112, "bfloat16", 256),
         "k256_b8": (8, 5, 256, "bfloat16", 256),
         "k256_b32": (32, 5, 256, "bfloat16", 256),
         "h64": (128, 16, 64, "bfloat16", 256),
         "h128": (128, 16, 128, "bfloat16", 256),
         "f80": (8, 16, 80, "float32", 256),
         "f96": (8, 16, 96, "float32", 256),
         "f128": (8, 16, 128, "float32", 256),
         "f128_h": (128, 16, 128, "float32", 256),
         "fw192": (8, 16, 192, "float32", 256),
         "fw256": (8, 16, 256, "float32", 256),
         "fw320": (8, 16, 320, "float32", 256),
         "fw512": (8, 16, 512, "float32", 256),
         "fw3104": (2, 16, 3104, "float32", 256),
         "fw1056": (2, 16, 1056, "float32", 256),
         "r608": (8, 8, 40, "float32", 1296)}
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


def _sdpa_runs(torch, hm, leaves, g, backend):
    """SDPA's forward, dropout forward and backward on ``backend``, or None
    where it refuses these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    try:
        with sdpa_kernel([backend]):
            lib_out = F.scaled_dot_product_attention(*leaves, scale=1.0)
            F.scaled_dot_product_attention(*hm, scale=1.0,
                                           dropout_p=DROP_RATE)
    except RuntimeError:
        return None

    def fwd(p=0.0):
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(*hm, scale=1.0,
                                                  dropout_p=p)

    return {"fwd": fwd, "fwd_drop": lambda: fwd(DROP_RATE),
            "bwd": lambda: torch.autograd.grad(lib_out, leaves, g,
                                               retain_graph=True)}


def _flash(torch, fa, gen, name, batch, heads, kd, dtype_name, n,
           args) -> dict:
    from torch.nn.attention import SDPBackend

    dtype = getattr(torch, dtype_name)
    fp32 = dtype == torch.float32
    ts = [torch.randn(batch, n, heads, kd, device="cuda", generator=gen)
          for _ in range(4)]
    q, k, v, g = [t.to(dtype) for t in (ts[0] * kd ** -0.5, *ts[1:])]
    bh = batch * heads
    seed = fa.seed_tensor(2 ** 32 - 5, "cuda")
    drop = (seed, DROP_RATE)
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            "bnhk").contiguous()
    runs = {
        "fwd": lambda: fa.flash_attention(q, k, v),
        "fwd_lse": lambda: fa.flash_attention(q, k, v, with_lse=True),
        "fwd_drop": lambda: fa.flash_attention(
            q, k, v, with_lse=True, dropout_rate=DROP_RATE,
            dropout_seed=seed),
        "bwd": lambda: fa._launch_backward(q, k, v, g, lse, delta, "bnhk")}
    if fp32:
        runs["bwd_split"] = lambda: fa._launch_backward(
            q, k, v, g, lse, delta, "bnhk", route="split")
    want = fa.reference_attention(q, k, v)
    plain_grads = fa.reference_attention_backward(q, k, v, g)
    errors = {"fwd": _rel(runs["fwd"](), want),
              "lse": (lse - fa.reference_attention_lse(q, k)).abs().max()
              .item(),
              "fwd_drop": _rel(runs["fwd_drop"]()[0],
                               fa.reference_attention(q, k, v, "bnhk",
                                                      drop)),
              "bwd": max(_rel(a, b) for a, b in zip(runs["bwd"](),
                                                    plain_grads))}
    if fp32:
        errors["bwd_split"] = max(_rel(a, b) for a, b in zip(
            runs["bwd_split"](), plain_grads))
    size = 4 if fp32 else 2
    operand = bh * n * kd * size
    rows = bh * n * 4
    # 3xTF32: three TF32 products per fp32 product.
    ops_scale = 3.0 if fp32 else 1.0
    peak = TF32_OPS_PER_S if fp32 else BF16_OPS_PER_S
    fwd_bound = _bound(ops_scale * 4 * bh * n * n * kd, 4 * operand, peak)
    lse_bound = _bound(ops_scale * 4 * bh * n * n * kd, 4 * operand + rows,
                       peak)
    # q, k, v, g read and dq, dk, dv written in the input type (the timed
    # call returns dq in q's dtype); lse and delta read.
    bwd_bound = _bound(ops_scale * 10 * bh * n * n * kd,
                       7 * operand + 2 * rows, peak)
    bounds = {"fwd": fwd_bound, "fwd_lse": lse_bound, "fwd_drop": lse_bound,
              "bwd": bwd_bound, "bwd_split": bwd_bound}
    hm = [fa._heads_major(t, "bnhk") for t in (q, k, v, g)]
    leaves = [t.detach().clone().requires_grad_() for t in hm[:3]]
    libs, backend_name = {}, None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        found = _sdpa_runs(torch, hm[:3], leaves, hm[3], backend)
        if found is not None:
            libs["sdpa"], backend_name = found, backend.name
            break
    if backend_name != "EFFICIENT_ATTENTION":
        found = _sdpa_runs(torch, hm[:3], leaves, hm[3],
                           SDPBackend.EFFICIENT_ATTENTION)
        if found is not None:
            libs["sdpa_efficient"] = found
    result = {"label": args.label, "shape": name, "bhnk": [bh, n, kd],
              "dtype": dtype_name,
              "forward_kernel": fa.forward_kernel(kd, q.dtype),
              "backward_kernel": fa.backward_kernel(kd, q.dtype),
              "errors": errors, "sdpa_backend": backend_name}
    for what, fn in runs.items():
        result[what] = {"ms": _time_ms(torch, fn, args.iters, args.rounds),
                        "kernels": _kernels(torch, fn, args.iters),
                        "bound_ms": bounds[what][0],
                        "bound_by": bounds[what][1]}
    for lib_name, lib in libs.items():
        for what, fn in lib.items():
            result[f"{lib_name}_{what}_ms"] = _time_ms(torch, fn, args.iters,
                                                       args.rounds)
            result[f"{lib_name}_{what}_kernels"] = _kernels(torch, fn,
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
    from vision_transformer_detector_tpu_torch.kernels import _build

    # Every flash library this checkout has, built at once.
    _build.load_libraries(sorted({getattr(fa, name) for name in dir(fa)
                                  if name.endswith("SOURCE")
                                  and "flash" in getattr(fa, name)}
                                 | {fused_ln.SOURCE}))
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
