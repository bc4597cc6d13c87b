#!/usr/bin/env python3
"""Checks and times every instance of the port's two dense kernels on one
NVIDIA GPU, without the rest of the smoke run (about a minute):

    python3 tools/check_dense_kernels_torch.py [--no-times]

Builds csrc/int8_dense.cu and csrc/dense_mish.cu, prints what ptxas says
of each kernel (registers, spills, warnings), then runs

  * the int8 dense (both routes: bf16 out with mish, fp32 out) through its
    guarded, resident-codes and streamed-codes instances, and
  * the dense+mish in bf16 (guarded, mma.sync, wgmma) and fp32 (guarded,
    mma.sync)

against their plain PyTorch versions at the vit_b16_384 shapes and at the
tile edges, and fails on the first disagreement. Then it times each
instance at the batch-32 shapes (CUDA events, in turns) beside the bf16
``torch.addmm`` + mish that the plain bf16 service runs per layer, and
prints one JSON line per shape with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vision_transformer_detector_tpu_torch.kernels import (  # noqa: E402
    _build, fused_ffn, quantization as qz)

BF16, FP32 = torch.bfloat16, torch.float32
ONE_BF16 = 2.0 ** -7
EDGE_MN = (1, 17, 63, 64, 65, 127, 129)
EDGE_K = (28, 40, 512, 576, 1536)


def _fail(message: str) -> None:
    raise SystemExit(f"check_dense_kernels: FAILED: {message}")


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(runs: dict, iters: int) -> dict:
    names = list(runs)
    sums = {name: 0.0 for name in names}
    for name in names + names[::-1]:
        sums[name] += _time_ms(runs[name], iters) / 2
    return sums


def _quant_layer(gen, k, out_shape):
    n = 1
    for dim in out_shape:
        n *= dim
    layer = qz.QuantDense(k, out_shape, device="cuda")
    layer.kernel_q.copy_(torch.randint(-127, 128, (k, n), device="cuda",
                                       generator=gen).to(torch.int8))
    limit = (6.0 / (k + n)) ** 0.5
    layer.scale.copy_((0.5 + 0.5 * torch.rand(n, device="cuda",
                                              generator=gen)) * limit / 127)
    layer.bias.copy_(0.1 * torch.randn(out_shape, device="cuda",
                                       generator=gen))
    return layer


def _compare(name, got, ref, rel_tol):
    if got.shape != ref.shape or got.dtype != ref.dtype:
        _fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(ref.shape)} {ref.dtype}")
    if not bool(torch.isfinite(got).all()):
        _fail(f"{name}: not finite")
    err = (got.float() - ref.float()).abs().max().item()
    tol = rel_tol * ref.float().abs().max().item()
    if err > tol:
        _fail(f"{name}: max abs err {err} > {tol}")
    return err


def check_int8(gen) -> dict:
    shapes = [(576, 768, 1536), (576, 1536, 768), (17, 576, 2048),
              (768, 576, 17), (17, 512, 6), (18432, 768, 1536),
              (544, 5376, 64)]
    shapes += [(m, k, n) for m, n, k in itertools.product(
        (1, 65, 129), (17, 64, 129), EDGE_K)]
    shapes += [(m, 512, 64) for m in EDGE_MN] + [(64, 576, n)
                                                 for n in EDGE_MN]
    worst = {}
    for m, k, n in shapes:
        layer = _quant_layer(gen, k, (n,))
        for x_dtype, out_dtype, mish in ((BF16, BF16, True),
                                         (BF16, FP32, False),
                                         (FP32, FP32, False)):
            x = torch.randn(m, k, device="cuda", generator=gen).to(x_dtype)
            ref = qz.int8_dense_reference(x, layer.kernel_q, layer.scale,
                                          layer.bias, mish, out_dtype)
            instances = ["guarded"]
            if qz.tensor_core_shape(k):
                instances += ["streamed"] + (["resident"] if k <= 2560
                                             else [])
            for instance in [None] + instances:
                before = qz.int8_dense.tensor_core_launches
                got = qz._launch(x, layer, mish, out_dtype, qz.int8_dense,
                                 instance=instance)
                torch.cuda.synchronize()
                took = qz.int8_dense.tensor_core_launches - before
                want = (qz.tensor_core_shape(k) if instance is None
                        else instance != "guarded")
                if bool(took) != want:
                    _fail(f"int8 {m}x{k}x{n} {instance}: tensor-core "
                          f"launch {took}, expected {want}")
                name = (f"int8 {m}x{k}x{n} {x_dtype} -> {out_dtype} "
                        f"{instance}")
                err = _compare(name, got, ref,
                               ONE_BF16 if out_dtype == BF16 else 1e-6)
                key = f"{instance}_{str(out_dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def check_dense_mish(gen) -> dict:
    shapes = [(576, 768, 1536), (576, 1536, 768), (17, 576, 2048),
              (17, 768, 17), (17, 512, 6), (18432, 768, 1536),
              (18432, 1536, 768), (544, 2048, 1024)]
    shapes += [(m, k, n) for m, n, k in itertools.product(
        (1, 65, 129), (17, 64, 136), EDGE_K)]
    shapes += [(m, 512, 64) for m in EDGE_MN] + [(64, 576, n)
                                                 for n in EDGE_MN]
    worst = {}
    for dtype, rel_tol in ((BF16, ONE_BF16), (FP32, 1e-5)):
        for (m, k, n), mish in itertools.product(shapes, (True, False)):
            x = torch.randn(m, k, device="cuda", generator=gen)
            w = torch.randn(k, n, device="cuda", generator=gen) * (
                (6.0 / (k + n)) ** 0.5 / 3 ** 0.5)
            b = 0.1 * torch.randn(n, device="cuda", generator=gen)
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
            ref = fused_ffn.dense_mish_reference(x, w, b, mish)
            instances = ["guarded"]
            if fused_ffn.tensor_core_shape(k, n, dtype):
                instances += ["mma_sync"] + (["wgmma"] if dtype == BF16
                                             else [])
            for instance in [None] + instances:
                before = fused_ffn.fused_dense_mish.tensor_core_launches
                got = fused_ffn._launch(x, w, b, mish, instance=instance)
                torch.cuda.synchronize()
                took = (fused_ffn.fused_dense_mish.tensor_core_launches
                        - before)
                want = (fused_ffn.tensor_core_shape(k, n, dtype)
                        if instance is None else instance != "guarded")
                if bool(took) != want:
                    _fail(f"ffn {m}x{k}x{n} {dtype} {instance}: tensor-core "
                          f"launch {took}, expected {want}")
                err = _compare(f"ffn {m}x{k}x{n} {dtype} mish={mish} "
                               f"{instance}", got, ref, rel_tol)
                key = f"{instance}_{str(dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def _addmm_mish(x, w, b):
    """What the plain bf16 service runs per layer: one cuBLAS product with
    the bias, then mish in fp32 (two library calls; the port's kernels never
    call either)."""
    return fused_ffn.mish_f32(torch.addmm(b, x, w).float()).to(x.dtype)


def times(gen) -> list:
    out = []
    for m, k, n in ((18432, 768, 1536), (18432, 1536, 768),
                    (18432, 768, 768), (576, 768, 1536)):
        iters = 20 if m > 1000 else 50
        layer = _quant_layer(gen, k, (n,))
        x = torch.randn(m, k, device="cuda", generator=gen).to(BF16)
        w = (0.05 * torch.randn(k, n, device="cuda", generator=gen))
        b = 0.1 * torch.randn(n, device="cuda", generator=gen)
        w16, b16 = w.to(BF16), b.to(BF16)
        x32 = x.float()
        runs = {
            "int8_fused": lambda: qz._launch(
                x, layer, True, BF16, qz.fused_int8_dense),
            "int8_fp32_out": lambda: qz._launch(
                x, layer, False, FP32, qz.int8_dense),
            "int8_fused_streamed": lambda: qz._launch(
                x, layer, True, BF16, qz.fused_int8_dense, "streamed"),
            "int8_fused_guarded": lambda: qz._launch(
                x, layer, True, BF16, qz.fused_int8_dense, "guarded"),
            "ffn_bf16_wgmma": lambda: fused_ffn._launch(
                x, w16, b16, True, "wgmma"),
            "ffn_bf16_mma_sync": lambda: fused_ffn._launch(
                x, w16, b16, True, "mma_sync"),
            "ffn_bf16_wgmma_no_mish": lambda: fused_ffn._launch(
                x, w16, b16, False, "wgmma"),
            "ffn_bf16_guarded": lambda: fused_ffn._launch(
                x, w16, b16, True, "guarded"),
            "ffn_fp32_mma_sync": lambda: fused_ffn._launch(
                x32, w, b, True, "mma_sync"),
            "ffn_fp32_guarded": lambda: fused_ffn._launch(
                x32, w, b, True, "guarded"),
            "addmm_bf16": lambda: torch.addmm(b16, x, w16),
            "addmm_bf16_then_mish_fp32": lambda: _addmm_mish(x, w16, b16),
        }
        out.append({"shape": [m, k, n],
                    "ms": {name: round(value, 5) for name, value in
                           _in_turns(runs, iters).items()}})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-times", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_libraries([qz.SOURCE, fused_ffn.SOURCE])
    for source, log in _build.BUILD_LOGS.items():
        lines = [line.strip() for line in log.splitlines()
                 if "registers" in line or "warning" in line.lower()
                 or "spill" in line and "0 bytes spill stores, 0" not in line]
        print(json.dumps({"source": source, "ptxas": lines}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"card": card, "int8_max_abs_err": check_int8(gen)}),
          flush=True)
    print(json.dumps({"card": card,
                      "dense_mish_max_abs_err": check_dense_mish(gen)}),
          flush=True)
    if not args.no_times:
        for line in times(gen):
            print(json.dumps({"card": card, **line}), flush=True)
    print("check_dense_kernels: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
