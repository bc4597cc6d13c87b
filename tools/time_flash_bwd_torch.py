"""Time the flash-attention backward (B2) at the bf16 shapes of the port's
main paths, with scaled_dot_product_attention's backward beside each, on
one GPU.

Shapes, as the model hands them to the kernels (bf16, 1/sqrt(K) applied):

  * ``hr64``: highres_1024's window fold at batch 8, (8, 256, 256, 64)
    heads-major, (B*H, N, K) = (2048, 256, 64);
  * ``hr64_drop``: the same with the dropout replay, rate 0.1;
  * ``hr128``: (8, 256, 256, 128) heads-major, (2048, 256, 128);
  * ``vith_b8``, ``vith_b32``: ViT-H/14's widths, (B, 256, 16, 80)
    tokens-major at B = 8 and 32, (128, 256, 80) and (512, 256, 80);
  * ``ring``: one rank's two B2 blocks of highres_1024_ring, R = 2,
    (2, 2048 of 4096, 16, 64) tokens-major, fp32 dk/dv and dq, from the
    whole sequence's lse and delta (kernels/ring_attention.py);
  * ``tp_drop``: a tensor-parallel rank of highres_1024 at batch 2 (8 of
    16 heads, 16 windows), (2, 128, 256, 64) heads-major with the
    batch*head row map and the replay.

For each: the backward's ms (CUDA events: the mean over ``--iters``
launches, the median, min and max over ``--rounds`` rounds, after a
warm-up), the device time of its kernels alone (torch.profiler, summed
per call: where it is well under the event time the call is held by the
host), SDPA's backward on the same inputs (``retain_graph``; for the
ring, SDPA of the rank's queries over all keys), the bound (the larger of
the function's five products at 989 TFLOP/s and its bytes, each input
read once and each output written once, at 3.35 TB/s), and the largest
error against the plain version relative to its largest value. Prints
one JSON line per shape, then the card's name and power limit.

``--repo PATH`` imports the port from another checkout (a parent's,
unpacked with ``git archive``), so one call on one card can time two
versions in turns:

    python3 tools/time_flash_bwd_torch.py --repo parent --label parent
    python3 tools/time_flash_bwd_torch.py --label change
    python3 tools/time_flash_bwd_torch.py --label change
    python3 tools/time_flash_bwd_torch.py --repo parent --label parent
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
DROP_RATE = 0.1


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


def _device_ms(torch, fn, iters: int) -> dict:
    """Device ms a call of fn, by kernel name and in total (the CUDA
    kernels torch.profiler records over ``iters`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key[:80]: e.device_time_total / iters / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return {"total": sum(kernels.values()), "kernels": kernels}


def _bound(bh: int, n: int, m: int, kd: int, dkv_bytes: int,
           dq_bytes: int):
    """(ms, "bytes" | "operations") of B2 over bh rows of n queries and m
    keys: five products; q, g (n rows) and k, v (m rows) read in bf16, lse
    and delta read in fp32, dq, dk and dv written."""
    ops = 5 * 2 * bh * n * m * kd
    nbytes = bh * kd * (2 * n * 2 + 2 * m * 2 + n * dq_bytes
                        + 2 * m * dkv_bytes) \
        + bh * n * 8
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to import")
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--shapes", default="hr64,hr64_drop,hr128,vith_b8,"
                        "vith_b32,ring,tp_drop")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_bwd_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = fa.seed_tensor(2 ** 32 - 5, "cuda")

    def operands(memory_shape):
        """q (scaled by 1/sqrt(K)), k, v, g in bf16, each contiguous in
        ``memory_shape``, the layout the case hands them over in."""
        ts = [torch.randn(memory_shape, device="cuda", generator=gen)
              for _ in range(4)]
        ts[0] = ts[0] * memory_shape[-1] ** -0.5
        return [t.to(torch.bfloat16) for t in ts]

    def case(name):
        """(q, k, v, g, layout, dropout, offsets, blocks) of a shape;
        blocks: the ring's (k, v, key offset) blocks, else None."""
        if name in ("hr64", "hr64_drop", "hr128"):
            kd = 128 if name == "hr128" else 64
            q, k, v, g = operands((8, 256, 256, kd))
            drop = (seed, DROP_RATE) if name == "hr64_drop" else None
            return q, k, v, g, "bhnk", drop, (0, 0, 0), None
        if name.startswith("vith"):
            batch = int(name.split("_b")[1])
            q, k, v, g = operands((batch, 256, 16, 80))
            return q, k, v, g, "bnhk", None, (0, 0, 0), None
        if name == "ring":
            q, k, v, g = operands((2, 4096, 16, 64))
            n = 2048
            blocks = [(k[:, i * n:(i + 1) * n].contiguous(),
                       v[:, i * n:(i + 1) * n].contiguous(), i * n)
                      for i in range(2)]
            return (q[:, :n].contiguous(), k, v, g[:, :n].contiguous(),
                    "bnhk", None, (0, 0, 0), blocks)
        # tp_drop: rank 1 of 2 holds heads 8..15 of every image: local
        # row i (8 heads x 16 windows = 128 rows an image) maps to global
        # row (i // 128) * 256 + 128 + i % 128.
        q, k, v, g = operands((2, 128, 256, 64))
        return (q, k, v, g, "bhnk", (seed, DROP_RATE),
                (0, 0, 0, 128, 256, 128), None)

    name_power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for name in args.shapes.split(","):
        q, k, v, g, layout, drop, offsets, blocks = case(name)
        (b, h, n), _ = fa._axes(q, layout)
        kd = q.shape[-1]
        if blocks is None:
            out, lse = fa._launch_forward(q, k, v, layout, with_lse=True,
                                          dropout=drop, offsets=offsets)
            delta = fa._heads_major((g.float() * out.float()).sum(-1),
                                    layout).contiguous()

            def kernel():
                return fa._launch_backward(q, k, v, g, lse, delta, layout,
                                           drop, offsets=offsets)

            got = kernel()
            want = fa.reference_attention_backward(q, k, v, g, layout, drop,
                                                   offsets)
            bound = _bound(b * h, n, n, kd, 2, 2)
        else:
            lse = fa.reference_attention_lse(q, k, layout)
            delta = (g.float() * fa.reference_attention(q, k, v).float()
                     ).sum(-1).transpose(1, 2).contiguous()

            def kernel():
                return [fa._launch_backward(
                    q, kb, vb, g, lse, delta, layout, None,
                    offsets=(0, 0, origin), fp32_dq=True, fp32_dkv=True)
                    for kb, vb, origin in blocks]

            parts = kernel()
            got = (sum(p[0] for p in parts),
                   torch.cat([p[1] for p in parts], 1),
                   torch.cat([p[2] for p in parts], 1))
            want = fa.reference_attention_backward(q, k, v, g, layout)
            # Two launches of (b, h, 2048, 2048): a bound for each, summed.
            one = _bound(b * h, n, n, kd, 4, 4)
            bound = (2 * one[0], one[1])
        lib_q, lib_k, lib_v, lib_g = (fa._heads_major(t, layout)
                                      for t in (q, k, v, g))
        err = max(_rel(a, r) for a, r in zip(got, want))
        del got, want
        leaves = [t.detach().clone().requires_grad_()
                  for t in (lib_q, lib_k, lib_v)]
        rate = DROP_RATE if drop is not None else 0.0
        lib_out = None
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            try:
                with sdpa_kernel([backend]):
                    lib_out = F.scaled_dot_product_attention(
                        *leaves, scale=1.0, dropout_p=rate)
                break
            except RuntimeError:
                continue
        times = _time_ms(torch, kernel, args.iters, args.rounds)
        device = _device_ms(torch, kernel, args.iters)
        lib = (_time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, lib_g, retain_graph=True), args.iters,
            args.rounds) if lib_out is not None else None)
        print(json.dumps({
            "label": args.label, "shape": name, "bhnk": [b * h, n, kd],
            "dropout": drop is not None,
            "kernel": fa.backward_kernel(kd, q.dtype)
            if hasattr(fa, "backward_kernel") else "mma_sync",
            "kernel_ms": times, "device_ms": device, "sdpa_bwd_ms": lib,
            "sdpa_backend": backend.name if lib_out is not None else None,
            "bound_ms": bound[0], "bound_by": bound[1],
            "max_rel_err": err, "card": name_power}), flush=True)
        del q, k, v, g, lse, delta, leaves, lib_out
        torch.cuda.empty_cache()
    print(name_power)


if __name__ == "__main__":
    main()
