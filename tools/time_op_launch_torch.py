"""Where the host's time of one call of each operator outside flash
attention goes, on one GPU.

The five operators of kernels/ops.py beside the two flash ones, each at a
shape of its main path:

  * ``layer_norm`` (B4, ``fused_layer_norm``): vit_b16_384's (576, 768)
    (batch 1) and (18,432, 768) (batch 32) bf16, and ViT-22B's width
    (2048, 6144) bf16 (batch 8), the block-a-row route;
  * ``dense_mish`` (B3, ``fused_dense_mish``): vit_b16_384's MLP at batch
    1, (576, 768) -> 1536 bf16, mish;
  * ``fused_int8_dense`` (B5): the same layer int8, bf16 out, mish;
  * ``int8_dense`` (B5's fp32-out route): the q/k/v projection at batch 1,
    (576, 768) -> (12, 64) fp32;
  * ``dropout``: the MLP dropout of a tensor-parallel rank, a column half
    of highres_1024's first pyramid activation at batch 2, (2, 4096, 1024)
    bf16 of a (2, 4096, 2048) tensor, rate 0.1, column base 1024 (the view
    chip_smoke.py's ``parallel`` phase times, which the operator copies to
    contiguous rows first), and the same activation contiguous with a
    sequence-sharded rank's token map (2048, 4096, 2048).

For each: the host's microseconds a call (``time.perf_counter_ns`` over
``--calls`` calls in chunks of 100, the card synchronised between chunks)
of each layer from the public wrapper down to the operator's body called
undispatched, and on a tree with launch plans the body's pieces timed
alone (the output's allocation, the address reads, the stream, the count,
the ctypes launch; "rest" is the body less the pieces: the key and its
lookup); the library call that computes the same function on the same
inputs (``F.layer_norm``, ``F.dropout``, ``torch.addmm`` in bf16 with the
dequantized weight for the int8 layers) beside it; CUDA-event ms a call
issued back to back and as 10 calls after 3 warm-ups (how chip_smoke.py's
``_in_turns`` times a kernel); and for B4 and the dropout the device ms a
call of every kernel the call launches (torch.profiler), the library's
beside it. Then ``predict_b1``: the int8 service (fused LayerNorm) and the
fused-FFN service of vit_b16_384 at batch 1, device path as chip_smoke.py
takes it, minimum and median over ``--predict-calls`` calls.

``--repo PATH`` imports the port from another checkout (a parent's,
unpacked with ``git archive``): a tree whose five operators are
``custom_op``s gives the layers, the library calls and the device times,
without the pieces. Prints one JSON line per case, then the card's name
and power limit. To compare two trees on one card, run it once per tree
in one command, in the order a, b, b, a.

Usage: python3 tools/time_op_launch_torch.py [--repo DIR] [--label L]
           [--calls 2000] [--predict-calls 100]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CHUNK = 100


def _per_call_us(torch, fn, calls: int) -> float:
    """Mean host microseconds a call of ``fn``."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(max(1, calls // CHUNK)):
        tic = time.perf_counter_ns()
        for _ in range(CHUNK):
            fn()
        total += time.perf_counter_ns() - tic
        torch.cuda.synchronize()
    return total / 1e3 / (max(1, calls // CHUNK) * CHUNK)


def _event_ms(torch, fn, calls: int, warm: int = 20) -> float:
    """CUDA-event ms a call of ``calls`` calls issued back to back."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _device_ms(torch, fn, calls: int = 50) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches, and their sum
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key[:60]: e.device_time_total / calls / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return {"total": sum(kernels.values()), "kernels": kernels}


def _plan_pieces(torch, ops, plans: str, out_shape, out_dtype, x,
                 pointers) -> dict:
    """The pieces of an operator's body on a tree with launch plans: its
    one plan (the cache ``plans`` after one call), timed piece by piece on
    the same inputs."""
    plan = next(iter(getattr(ops, plans).values()))
    out = x.new_empty(out_shape, dtype=out_dtype)
    stream = plan.stream(plan.device.index)
    module = {"_ln_plans": "fused_ln", "_ffn_plans": "fused_ffn",
              "_int8_plans": "quantization", "_drop_plans": "dropout"}[plans]
    lock = getattr(ops, module)._count_lock
    ptrs = [None if p is None else p() for p in pointers]
    ptrs.insert(-1 if plans == "_drop_plans" else len(ptrs), out.data_ptr())

    def count():
        with lock:
            pass

    pieces = {
        "the output's allocation": lambda: x.new_empty(out_shape,
                                                       dtype=out_dtype),
        f"{len(pointers) + 1} address reads": lambda: [
            p() for p in pointers if p is not None] + [out.data_ptr()],
        "the current stream": lambda: plan.stream(plan.device.index),
        "the count under its lock": count,
        "ctypes: the launch": lambda: plan.fn(plan.args_ptr, *ptrs, stream),
    }
    return pieces, plan


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to import")
    parser.add_argument("--label", default="")
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--predict-calls", type=int, default=100)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch.kernels import (
        dropout as dk, flash_attention as fa, fused_ffn, fused_ln, ops,
        quantization as qz)

    if not torch.cuda.is_available():
        raise SystemExit("time_op_launch_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    plan_tree = hasattr(ops, "layer_norm_plan")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = args.calls
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen) * scale
                ).to(dtype)

    def body(name):
        """The operator's CUDA implementation, undispatched."""
        if plan_tree:
            return {"layer_norm": ops._layer_norm_cuda,
                    "dense_mish": ops._dense_mish_cuda,
                    "fused_int8_dense": ops._fused_int8_dense_cuda,
                    "int8_dense": ops._int8_dense_cuda,
                    "dropout": ops._dropout_cuda}[name]
        return getattr(ops, "dropout_apply" if name == "dropout"
                       else name)._init_fn

    def report(case, op, shape, layers, library, pieces=None, device=None,
               plan=None):
        body_us = None
        row = {"label": args.label, "case": case, "op": op, "shape": shape,
               "path": "launch plan" if plan_tree else "custom_op, checked "
               "each call",
               "layers_us": {}, "card": card}
        for name, fn in layers.items():
            row["layers_us"][name] = body_us = _per_call_us(torch, fn, calls)
        if pieces:
            row["pieces_us"] = {name: _per_call_us(torch, fn, calls)
                                for name, fn in pieces.items()}
            row["pieces_us"]["rest: the key, its lookup, the copies' flags"] \
                = body_us - sum(row["pieces_us"].values())
        if plan is not None:
            row["copies"] = list(plan.copies)
            row["tensor_core"] = bool(plan.tensor_core)
        public = next(iter(layers.values()))
        row["event_ms"] = _event_ms(torch, public, calls)
        row["event_ms_10_calls"] = _event_ms(torch, public, 10, warm=3)
        row["library"] = {
            "call": library[0], "host_us": _per_call_us(torch, library[1],
                                                        calls),
            "event_ms": _event_ms(torch, library[1], calls),
            "event_ms_10_calls": _event_ms(torch, library[1], 10, warm=3)}
        if device:
            row["device_ms"] = _device_ms(torch, public)
            row["library"]["device_ms"] = _device_ms(torch, library[1])
        print(json.dumps(row), flush=True)

    def clear():
        if plan_tree:
            for name in ("_ln_plans", "_ffn_plans", "_int8_plans",
                         "_drop_plans"):
                getattr(ops, name).clear()

    eps = 1e-3
    # B4 at three shapes.
    for rows, d in ((576, 768), (18432, 768), (2048, 6144)):
        x, gamma, beta = rnd(rows, d), rnd(d, dtype=torch.float32), \
            rnd(d, dtype=torch.float32)
        # F.layer_norm takes its weights in x's dtype.
        gamma16, beta16 = gamma.to(bf16), beta.to(bf16)
        op = torch.ops.vtd_torch.layer_norm.default
        fn = body("layer_norm")
        layers = {
            "fused_layer_norm": lambda: fused_ln.fused_layer_norm(
                x, gamma, beta),
            "torch.ops.vtd_torch.layer_norm.default":
                lambda: op(x, gamma, beta, eps),
            "the operator's body, undispatched":
                lambda: fn(x, gamma, beta, eps)}
        clear()
        fused_ln.fused_layer_norm(x, gamma, beta)
        pieces, plan = (_plan_pieces(
            torch, ops, "_ln_plans", (rows, d), bf16, x,
            [x.data_ptr, gamma.data_ptr, beta.data_ptr])
            if plan_tree else (None, None))
        report(f"layer_norm_{rows}x{d}", "layer_norm", [rows, d, "bfloat16"],
               layers, ("F.layer_norm", lambda: F.layer_norm(
                   x, (d,), gamma16, beta16, eps)), pieces, device=True,
               plan=plan)

    # B3 and both B5 routes at vit_b16_384's batch-1 shapes.
    rows, d, wide = 576, 768, 1536
    x = rnd(rows, d)
    w, b = rnd(d, wide, scale=0.05), rnd(wide, scale=0.1)
    op = torch.ops.vtd_torch.dense_mish.default
    fn = body("dense_mish")
    clear()
    fused_ffn.fused_dense_mish(x, w, b)
    pieces, plan = (_plan_pieces(torch, ops, "_ffn_plans", (rows, wide),
                                 bf16, x, [x.data_ptr, w.data_ptr,
                                           b.data_ptr])
                    if plan_tree else (None, None))
    report("dense_mish_576x768x1536", "dense_mish",
           [rows, d, wide, "bfloat16", "mish"],
           {"fused_dense_mish": lambda: fused_ffn.fused_dense_mish(x, w, b),
            "torch.ops.vtd_torch.dense_mish.default":
                lambda: op(x, w, b, True, 0),
            "the operator's body, undispatched":
                lambda: fn(x, w, b, True, 0)},
           ("torch.addmm (bf16, no mish)", lambda: torch.addmm(b, x, w)),
           pieces, plan=plan)

    for name, out_shape, out_dtype in (
            ("fused_int8_dense", (wide,), bf16),
            ("int8_dense", (12, 64), torch.float32)):
        n = int(np.prod(out_shape))
        layer = qz.QuantDense(d, out_shape, device="cuda")
        layer.kernel_q.copy_(torch.randint(-127, 128, (d, n), device="cuda",
                                           generator=gen).to(torch.int8))
        layer.scale.copy_(torch.rand(n, device="cuda", generator=gen) / 100)
        layer.bias.copy_(rnd(*out_shape, dtype=torch.float32))
        dequant = (layer.kernel_q.float() * layer.scale).to(bf16)
        flat_bias = layer.bias.reshape(-1).to(bf16)
        fused = name == "fused_int8_dense"
        transposed = qz.transposed_codes(layer)
        op = getattr(torch.ops.vtd_torch, name).default
        fn = body(name)
        public = ((lambda: qz.fused_int8_dense(x, layer, apply_mish=True))
                  if fused else (lambda: qz.int8_dense(x, layer)))
        clear()
        public()
        pieces, plan = (_plan_pieces(
            torch, ops, "_int8_plans", (rows, n), out_dtype, x,
            [x.data_ptr, layer.kernel_q.data_ptr, transposed.data_ptr,
             layer.scale.data_ptr, layer.bias.data_ptr])
            if plan_tree else (None, None))
        report(f"{name}_576x768x{n}", name,
               [rows, d, n, "bfloat16", str(out_dtype)[6:]],
               {name: public,
                f"torch.ops.vtd_torch.{name}.default": lambda: op(
                    x, layer.kernel_q, transposed, layer.scale, layer.bias,
                    fused, 0),
                "the operator's body, undispatched": lambda: fn(
                    x, layer.kernel_q, transposed, layer.scale, layer.bias,
                    fused, 0)},
               ("torch.addmm (bf16, the dequantized weight)",
                lambda: torch.addmm(flat_bias, x, dequant)),
               pieces, plan=plan)

    # The MLP dropout: a tensor-parallel rank's column half, then a
    # sequence-sharded rank's token half (contiguous, a row map).
    seed = fa.seed_tensor(2 ** 32 - 5, "cuda")
    whole = rnd(2, 4096, 2048)
    op = torch.ops.vtd_torch.dropout.default
    fn = body("dropout")
    for case, xv, coords, view in (
            ("dropout_sharded_columns", whole[..., 1024:],
             (0, 1, 1, 0, 1024), (0, fa.IDENTITY_MAP, 1024)),
            ("dropout_sharded_tokens", rnd(2, 2048, 2048),
             (0, 2048, 4096, 2048, 0), (0, (2048, 4096, 2048), 0))):
        x2 = xv.reshape(-1, xv.shape[-1])
        clear()
        dk.dropout(xv, seed, 0.1, view[0], view[1], view[2])
        pieces = plan = None
        if plan_tree:
            pieces, plan = _plan_pieces(
                torch, ops, "_drop_plans", tuple(x2.shape), bf16, x2,
                [x2.data_ptr, seed.data_ptr])
            if plan.copies[0]:
                pieces["the copy to contiguous rows"] = x2.contiguous
        report(case, "dropout", [*xv.shape, "bfloat16", 0.1, *coords],
               {"dropout": lambda: dk.dropout(xv, seed, 0.1, view[0],
                                              view[1], view[2]),
                "torch.ops.vtd_torch.dropout.default":
                    lambda: op(x2, seed, 0.1, *coords),
                "the operator's body, undispatched":
                    lambda: fn(x2, seed, 0.1, *coords)},
               ("F.dropout", lambda: F.dropout(xv, 0.1)), pieces,
               device=True, plan=plan)
    del whole

    # Batch-1 serving through the five operators' path.
    from vision_transformer_detector_tpu_torch import get_config
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    config = get_config("vit_b16_384").replace(use_fused_layer_norm=True)
    params = init_params(config, torch.Generator().manual_seed(0))
    services = {
        "int8_fused_ln": DetectionService(
            config, qz.quantize_params(params), device="cuda"),
        "fused_ffn_fused_ln": DetectionService(
            config.replace(use_fused_ffn=True), params, device="cuda")}
    canvas = np.zeros((1, *config.image_size, 3), np.uint8)
    samples = {name: [] for name in services}
    with torch.inference_mode():
        for name in [*services, *reversed(services)]:
            service = services[name]
            for _ in range(3):
                service.raw_to_detections(service.predict_raw(canvas))
            for _ in range(args.predict_calls // 2):
                tic = time.perf_counter()
                service.raw_to_detections(service.predict_raw(canvas))
                samples[name].append((time.perf_counter() - tic) * 1e3)
    print(json.dumps({"label": args.label, "case": "predict_b1",
                      "services": {
                          name: {"ms_min": min(v),
                                 "ms_median": float(np.median(v)),
                                 "calls": len(v)}
                          for name, v in samples.items()},
                      "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
