"""Where the host's time of one flash-attention call goes, on one GPU.

Breaks one call of each flash operator into its pieces and times each
piece alone with ``time.perf_counter_ns`` over ``--calls`` calls (in
chunks of 100, the card synchronised between chunks and outside the
timed span, so no launch queue fills up):

  * ``fwd``: ``flash_attention(q, k, v)`` at vit_b16_384's serving shape,
    (B, N, H, K) = (1, 576, 12, 64) bf16, tokens-major (layout "bnhk"),
    no lse, no dropout: 12 such calls a request at batch 1;
  * ``bwd``: ``flash_attention._launch_backward`` (what the autograd
    Function's backward calls) at the ViT-H/14-width detector's shape,
    (8, 256, 16, 80) bf16 tokens-major, (B*H, N, K) = (128, 256, 80).

For each, the layers from the public call down to the C entry point
(each includes the ones below it), the pieces inside them (each timed
alone on the same inputs), and beside them:

  * a no-op operator of the forward's schema registered two ways, through
    ``torch.library.custom_op`` and through ``torch.library.Library``'s
    ``define`` and ``impl(..., "CUDA")``: what the dispatch alone costs;
  * ``cuTensorMapEncodeTiled`` (csrc/sm90_common.cuh's ``encode``) timed
    in C over 10,000 encodes of the forward's q map, built with nvcc;
  * scaled_dot_product_attention's host time a call on the same inputs.

The pieces read the port's internals, so they follow the tree: the
operator path of a tree whose operators are Python ``custom_op``s with
per-call checks, or the launch plan (one validation per shape) of a tree
whose kernels/ops.py has ``forward_plan``; there the plan's key and
lookup is the operator's body less its other pieces. ``--repo PATH``
imports the port from another checkout (a parent's, unpacked with ``git
archive``). Prints one JSON line per operator, then the card's name and
power limit.

Usage: python3 tools/time_flash_launch_torch.py [--repo DIR] [--label L]
           [--calls 2000]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

import torch

CHUNK = 100

ENCODE_SOURCE = r"""
#include <chrono>
#include "sm90_common.cuh"

extern "C" double vtd_time_encode(const void* ptr, int kdim, int seq_len,
                                  int heads, int batch, long long sb,
                                  long long sh, long long sn, int rows,
                                  int count) {
  cudaFree(nullptr);   // the device's context, current in this thread
  CUtensorMap map;
  if (!encode(&map, ptr, kdim, seq_len, heads, batch, sb, sh, sn, rows)) {
    return -1.0;
  }
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < count; ++i) {
    encode(&map, ptr, kdim, seq_len, heads, batch, sb, sh, sn, rows);
  }
  const std::chrono::duration<double, std::micro> took =
      std::chrono::steady_clock::now() - start;
  return took.count() / count;
}
"""


def _per_call_us(torch, fn, calls: int) -> dict:
    """Mean and best-chunk host microseconds a call of ``fn``."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total, best = 0, None
    for _ in range(max(1, calls // CHUNK)):
        tic = time.perf_counter_ns()
        for _ in range(CHUNK):
            fn()
        took = time.perf_counter_ns() - tic
        torch.cuda.synchronize()
        total += took
        best = took if best is None else min(best, took)
    return {"us": total / 1e3 / (max(1, calls // CHUNK) * CHUNK),
            "us_best_chunk": best / 1e3 / CHUNK}


def _event_ms(torch, fn, calls: int) -> float:
    """CUDA-event ms a call of ``calls`` calls issued back to back."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _encode_us(torch, fa, q) -> float:
    """Microseconds a cuTensorMapEncodeTiled of q's 64-row map."""
    from vision_transformer_detector_tpu_torch.kernels import _build

    out_dir = tempfile.mkdtemp(dir=_build.BUILD_DIR if os.path.isdir(
        _build.BUILD_DIR) else None)
    src = os.path.join(out_dir, "time_encode.cu")
    lib_path = os.path.join(out_dir, "libtime_encode.so")
    with open(src, "w") as f:
        f.write(ENCODE_SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", lib_path, src], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(lib_path)
    fn = lib.vtd_time_encode
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2)
    fn.restype = ctypes.c_double
    (b, h, n), (sb, sh, sn) = fa._axes(q, "bnhk")
    return fn(q.data_ptr(), q.shape[-1], n, h, b, sb, sh, sn, 64, 10000)


def _noop_dispatch(torch, q, k, v, calls: int) -> dict:
    """Host us of a no-op operator of the forward's schema, registered as
    a ``custom_op`` and through ``Library.define`` + ``impl``."""
    schema = ("(Tensor q, Tensor k, Tensor v, str layout, bool with_lse, "
              "Tensor? dropout_seed, float dropout_rate, SymInt bh_base=0, "
              "SymInt q_base=0, SymInt k_base=0, SymInt inner_local=1, "
              "SymInt inner_global=1, SymInt inner_base=0, "
              "bool out_fp32=False, Tensor? acc_in=None, Tensor? m_in=None, "
              "Tensor? l_in=None, bool suspend=False) -> "
              "(Tensor, Tensor, Tensor, Tensor)")

    @torch.library.custom_op("vtd_timing::noop_custom_op", mutates_args=(),
                             device_types="cuda")
    def noop_custom_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       layout: str, with_lse: bool,
                       dropout_seed: Optional[torch.Tensor],
                       dropout_rate: float, bh_base: int = 0,
                       q_base: int = 0, k_base: int = 0,
                       inner_local: int = 1, inner_global: int = 1,
                       inner_base: int = 0, out_fp32: bool = False,
                       acc_in: Optional[torch.Tensor] = None,
                       m_in: Optional[torch.Tensor] = None,
                       l_in: Optional[torch.Tensor] = None,
                       suspend: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
        return held

    lib = torch.library.Library("vtd_timing", "FRAGMENT")
    lib.define("noop_library" + schema)
    lib.impl("noop_library", lambda *a, **kw: held, "CUDA")
    held = tuple(torch.empty(1, device=q.device) for _ in range(4))
    custom = torch.ops.vtd_timing.noop_custom_op.default
    library = torch.ops.vtd_timing.noop_library.default
    args = (q, k, v, "bnhk", False, None, 0.0, 0, 0, 0, 1, 1, 0)
    result = {"noop_custom_op": _per_call_us(torch, lambda: custom(*args),
                                             calls),
              "noop_library_impl": _per_call_us(
                  torch, lambda: library(*args), calls)}
    lib._destroy()
    return result


def _parent_fwd_pieces(torch, fa, ops, q, k, v) -> dict:
    """The forward's pieces on a tree whose operators check every call."""
    layout, coords = "bnhk", (0, 0, 0, 1, 1, 0)
    f32 = torch.float32
    out = torch.empty_like(q)
    (b, h, n), _ = fa._axes(q, layout)
    strides = [s for t in (q, k, v, out) for s in fa._axes(t, layout)[1]]
    lib = ops._library("fwd_sm90")
    fn = getattr(lib, ops._entry("fwd_sm90"))
    stream = ops._stream(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None, None, None, None, None, None)

    def c_args(batch):
        return (*ptrs, 1, 0, batch, h, n, q.shape[-1], *strides,
                *fa._dropout_c_args(None, coords), stream)

    launch, refused = c_args(b), c_args(0)

    def device_and_stream():
        with torch.cuda.device(q.device):
            ops._stream(q.device)

    return {
        "wrapper: _dropout_args, device set, mask_coords, grad check":
            lambda: (fa._dropout_args(None, None),
                     {t.device.type for t in (q, k, v)},
                     fa.mask_coords((0, 0, 0)),
                     torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))),
        "_launch_forward: _check_inputs, _addressable, mask_coords":
            lambda: (fa._check_inputs(q, k, v), fa._addressable((q, k, v)),
                     fa.mask_coords(coords)),
        "op: _kernel_operands (3 x _misalignment)":
            lambda: fa._kernel_operands(layout, q=q, k=k, v=v),
        "op: four torch.empty":
            lambda: (torch.empty_like(q, dtype=q.dtype),
                     torch.empty((0,), dtype=f32, device=q.device),
                     torch.empty((0,), dtype=f32, device=q.device),
                     torch.empty((0,), dtype=f32, device=q.device)),
        "op: _axes (5 calls), strides list":
            lambda: (fa._axes(q, layout),
                     [s for t in (q, k, v, out)
                      for s in fa._axes(t, layout)[1]]),
        "op: _dropout, forward_kernel, _library":
            lambda: (ops._dropout(None, 0.0, q.device),
                     fa.forward_kernel(q.shape[-1], q.dtype),
                     ops._library("fwd_sm90")),
        "op: torch.cuda.device + current_stream": device_and_stream,
        "op: _dropout_c_args": lambda: fa._dropout_c_args(None, coords),
        "op: two _count": lambda: (fa._count("launches", 0),
                                   fa._count("wgmma_launches", 0)),
        "ctypes: 45 arguments, refused at once (batch 0)":
            lambda: fn(*refused),
        "ctypes: the launch (tensor maps, one kernel)": lambda: fn(*launch),
    }


def _parent_bwd_pieces(torch, fa, ops, q, k, v, g, lse, delta) -> dict:
    layout, coords = "bnhk", (0, 0, 0, 1, 1, 0)
    (b, h, n), _ = fa._axes(q, layout)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = [s for t in (q, k, v, g, dq, dk, dv)
               for s in fa._axes(t, layout)[1]]
    fn = getattr(ops._library("bwd_sm90"), ops._entry("bwd_sm90"))
    stream = ops._stream(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None)

    def c_args(batch):
        return (*ptrs, 1, 0, batch, h, n, q.shape[-1], *strides,
                *fa._dropout_c_args(None, coords), stream)

    launch, refused = c_args(b), c_args(0)

    def side_checks():
        for t in (lse, delta):
            (t.shape != (b, h, n) or t.dtype != torch.float32
             or not t.is_contiguous() or t.device != q.device)

    def device_and_stream():
        with torch.cuda.device(q.device):
            ops._stream(q.device)

    return {
        "_launch_backward: _check_inputs, _addressable, g's _misalignment, "
        "lse/delta checks, mask_coords":
            lambda: (fa._check_inputs(q, k, v, g),
                     fa._addressable((q, k, v, g)),
                     fa._misalignment(g, layout), side_checks(),
                     fa.mask_coords(coords)),
        "op: _kernel_operands (4 x _misalignment)":
            lambda: fa._kernel_operands(layout, q=q, k=k, v=v, g=g),
        "op: three torch.empty":
            lambda: (torch.empty(q.shape, dtype=torch.float32,
                                 device=q.device),
                     torch.empty_like(k), torch.empty_like(v)),
        "op: backward_kernel, dq_route, _axes (8 calls), strides list":
            lambda: (fa.backward_kernel(q.shape[-1], q.dtype),
                     fa.dq_route(q.dtype, 0, fa.partials_bytes(
                         b, h, n, q.shape[-1])),
                     fa._axes(q, layout),
                     [s for t in (q, k, v, g, dq, dk, dv)
                      for s in fa._axes(t, layout)[1]]),
        "op: torch.cuda.device + current_stream": device_and_stream,
        "op: _dropout, _library, _dropout_c_args, two _count":
            lambda: (ops._dropout(None, 0.0, q.device),
                     ops._library("bwd_sm90"),
                     fa._dropout_c_args(None, coords),
                     fa._count("backward_launches", 0),
                     fa._count("wgmma_backward_launches", 0)),
        "ctypes: 52 arguments, refused at once (batch 0)":
            lambda: fn(*refused),
        "ctypes: the launch (tensor maps, two kernels)": lambda: fn(*launch),
        "wrapper: dq cast to bf16": lambda: dq.to(q.dtype),
    }


def _plan_fwd_pieces(torch, fa, ops, q, k, v) -> dict:
    """The forward's pieces on a tree with launch plans."""
    coords = (0, 0, 0, 1, 1, 0)
    plan = ops._bound(ops.forward_plan(q, k, v, "bnhk", False, None, 0.0,
                                       coords, False, None, None, None,
                                       False))
    device = plan.device
    (shape, stride, dtype), lse_shape, m_shape, l_shape = plan.outputs
    f32 = torch.float32
    out = torch.empty_strided(shape, stride, dtype=dtype, device=device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = plan.stream(device.index)

    def allocations():
        q.new_empty_strided(shape, stride, dtype=dtype)
        q.new_empty(lse_shape, dtype=f32)
        q.new_empty(m_shape, dtype=f32)
        q.new_empty(l_shape, dtype=f32)

    return {
        "wrapper: flash_attention's checks, mask_coords":
            lambda: (fa._dropout_args(None, None),
                     q.is_cuda and k.is_cuda and v.is_cuda,
                     fa.mask_coords((0, 0, 0)),
                     q.requires_grad or k.requires_grad or v.requires_grad),
        "_launch_forward: _needs_copy, _coords":
            lambda: (fa._needs_copy(q), fa._coords((0, 0, 0))),
        "op: four allocations": allocations,
        "op: four data_ptr reads":
            lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr()),
        "op: the current stream": lambda: plan.stream(device.index),
        "op: counts": lambda: fa._count(*plan.counts, n=0),
        "ctypes: the launch (tensor maps, one kernel)":
            lambda: plan.fn(plan.args_ptr, *ptrs, None, None, None, None,
                            None, None, None, stream),
    }


def _plan_bwd_pieces(torch, fa, ops, q, k, v, g, lse, delta) -> dict:
    coords = (0, 0, 0, 1, 1, 0)
    plan = ops._bound(ops.backward_plan(q, k, v, g, lse, delta, "bnhk",
                                        None, 0.0, 0, coords, False, False))
    device = plan.device
    outputs = plan.outputs
    made = [t.new_empty_strided(s, st, dtype=d)
            for t, (s, st, d) in zip((q, k, v), outputs)]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in made))
    stream = plan.stream(device.index)
    return {
        "_launch_backward: _needs_copy, g's _misalignment, _coords":
            lambda: (fa._needs_copy(q), fa._misalignment(g, "bnhk"),
                     fa._coords((0, 0, 0))),
        "op: three allocations": lambda: [
            t.new_empty_strided(s, st, dtype=d)
            for t, (s, st, d) in zip((q, k, v), outputs)],
        "op: six data_ptr reads":
            lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), delta.data_ptr()),
        "ctypes: the launch (tensor maps, two kernels, dq in bf16)":
            lambda: plan.fn(plan.args_ptr, *ptrs, None, None, stream),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to import")
    parser.add_argument("--label", default="")
    parser.add_argument("--calls", type=int, default=2000)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, ops)

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_launch_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    plan_tree = hasattr(ops, "forward_plan")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(shape, count):
        ts = [torch.randn(shape, device="cuda", generator=gen)
              for _ in range(count)]
        ts[0] = ts[0] * shape[-1] ** -0.5
        return [t.to(torch.bfloat16) for t in ts]

    calls = args.calls
    # The forward at vit_b16_384's serving shape.
    q, k, v = operands((1, 576, 12, 64), 3)
    hm = [t.transpose(1, 2) for t in (q, k, v)]
    coords = (0, 0, 0, 1, 1, 0)
    op = torch.ops.vtd_torch.flash_attention_fwd
    layers = {
        "flash_attention": lambda: fa.flash_attention(q, k, v),
        "_launch_forward": lambda: fa._launch_forward(q, k, v, "bnhk"),
        "torch.ops.vtd_torch.flash_attention_fwd":
            lambda: op(q, k, v, "bnhk", False, None, 0.0, *coords)}
    body = (ops._flash_fwd_cuda if plan_tree
            else ops.flash_attention_fwd._init_fn)
    layers["the operator's body, undispatched"] = (
        lambda: body(q, k, v, "bnhk", False, None, 0.0, *coords))
    pieces = (_plan_fwd_pieces if plan_tree
              else _parent_fwd_pieces)(torch, fa, ops, q, k, v)
    fwd = {"shape": [1, 576, 12, 64], "layout": "bnhk", "dtype": "bfloat16",
           "path": "launch plan" if plan_tree else "custom_op, checked "
           "each call",
           "layers_us": {name: _per_call_us(torch, fn, calls)
                         for name, fn in layers.items()},
           "pieces_us": {name: _per_call_us(torch, fn, calls)
                         for name, fn in pieces.items()},
           "event_ms": _event_ms(torch, layers["flash_attention"], calls),
           "sdpa_us": _per_call_us(
               torch, lambda: F.scaled_dot_product_attention(*hm), calls),
           "sdpa_event_ms": _event_ms(
               torch, lambda: F.scaled_dot_product_attention(*hm), calls)}
    fwd.update(_noop_dispatch(torch, q, k, v, calls))
    fwd["tensor_map_encode_us"] = _encode_us(torch, fa, q)
    print(json.dumps({"label": args.label, "op": "fwd", **fwd,
                      "card": card}), flush=True)

    # The backward at the ViT-H/14-width detector's shape.
    q, k, v, g = operands((8, 256, 16, 80), 4)
    out, lse = fa._launch_forward(q, k, v, "bnhk", with_lse=True)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            "bnhk").contiguous()
    bop = torch.ops.vtd_torch.flash_attention_bwd
    layers = {
        "_launch_backward": lambda: fa._launch_backward(
            q, k, v, g, lse, delta, "bnhk"),
        "torch.ops.vtd_torch.flash_attention_bwd":
            lambda: bop(q, k, v, g, lse, delta, "bnhk", None, 0.0)}
    bwd_body = (ops._flash_bwd_cuda if plan_tree
                else ops.flash_attention_bwd._init_fn)
    layers["the operator's body, undispatched"] = (
        lambda: bwd_body(q, k, v, g, lse, delta, "bnhk", None, 0.0))
    pieces = (_plan_bwd_pieces if plan_tree
              else _parent_bwd_pieces)(torch, fa, ops, q, k, v, g, lse,
                                       delta)
    leaves = [t.transpose(1, 2).detach().clone().requires_grad_()
              for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    lib_g = g.transpose(1, 2)

    def sdpa_bwd():
        torch.autograd.grad(lib_out, leaves, lib_g, retain_graph=True)

    bwd = {"shape": [8, 256, 16, 80], "layout": "bnhk", "dtype": "bfloat16",
           "layers_us": {name: _per_call_us(torch, fn, calls)
                         for name, fn in layers.items()},
           "pieces_us": {name: _per_call_us(torch, fn, calls)
                         for name, fn in pieces.items()},
           "event_ms": _event_ms(torch, layers["_launch_backward"], calls),
           "sdpa_bwd_us": _per_call_us(torch, sdpa_bwd, calls),
           "sdpa_bwd_event_ms": _event_ms(torch, sdpa_bwd, calls)}
    print(json.dumps({"label": args.label, "op": "bwd", **bwd,
                      "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
