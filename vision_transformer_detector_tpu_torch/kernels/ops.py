"""The port's CUDA kernels as PyTorch custom operators,
``torch.ops.vtd_torch.*``.

No JAX counterpart: this is what lets ``torch.export`` (export.py) trace
a model whose kernels are ``ctypes`` calls. Each launcher of the kernel
modules is one operator with

  * a CUDA implementation only: the ``ctypes`` launch on
    ``torch.cuda.current_stream()``, the check of the CUDA error code it
    returns, and the launch counters of the public wrapper, which count at
    call time (in an exported program too);
  * a fake implementation (``register_fake``) that gives the outputs'
    shapes, dtypes and strides and nothing else, for tracing.

There is no CPU implementation: a CPU tensor handed to an operator
raises NotImplementedError. The wrappers (kernels/flash_attention.py,
dropout.py, fused_ln.py, fused_ffn.py, quantization.py) choose the plain
PyTorch version for CPU tensors before they reach an operator, and an
exported program traced on the CPU therefore holds the plain versions and
no operator.

The operators take what the kernels take: the wrappers check shapes and
dtypes, pad the flash head dim and pick an instance, the operators make
the copies a kernel needs (contiguity, 16-byte alignment) and refuse the
views the flash kernels cannot read. Importing this module (the package
``kernels`` does) registers every operator; it builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.library import custom_op

from . import (_build, dropout, flash_attention, fused_ffn, fused_ln,
               quantization)

NAMESPACE = "vtd_torch"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {
    "fwd": flash_attention.FWD_SOURCE,
    "bwd": flash_attention.BWD_SOURCE,
    "ln": fused_ln.SOURCE,
    "ffn": fused_ffn.SOURCE,
    "int8": quantization.SOURCE,
    "drop": dropout.SOURCE,
}


def _define(name: str):
    return custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                     device_types="cuda")


@functools.cache
def _library(kind: str) -> ctypes.CDLL:
    """The built library of one source, with its entry point's C types."""
    lib = _build.load_library(_SOURCES[kind])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u32 = ctypes.c_uint32
    # dropout flag, the seed's device address, keep threshold, inv_keep,
    # the mask's bh/query/key offsets, then the stream.
    dropout = [i32, ptr, u32, ctypes.c_float, u32, u32, u32, ptr]
    if kind == "fwd":
        fn = lib.vtd_flash_attention_fwd
        fn.argtypes = [ptr] * 5 + [i32] * 5 + [i64] * 12 + dropout
    elif kind == "bwd":
        fn = lib.vtd_flash_attention_bwd
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [i64] * 21 + dropout
    elif kind == "ln":
        fn = lib.vtd_layer_norm
        fn.argtypes = [ptr] * 4 + [i32] * 2 + [ctypes.c_float, i32, ptr]
    elif kind == "ffn":
        fn = lib.vtd_dense_mish
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.POINTER(i32), ptr]
    elif kind == "int8":
        fn = lib.vtd_int8_dense
        fn.argtypes = [ptr] * 6 + [i32] * 7 + [ctypes.POINTER(i32), ptr]
    else:
        fn = lib.vtd_dropout
        fn.argtypes = [ptr, ptr, i64, i32, i32, ptr, u32, ctypes.c_float,
                       u32, ptr]
    fn.restype = i32
    lib.vtd_cuda_error_string.argtypes = [i32]
    lib.vtd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _dropout(seed: Optional[torch.Tensor], rate: float, device):
    """The wrappers' ``(seed, rate)`` form, None for rate 0. The seed is a
    one-element uint32 tensor on the inputs' device, which the kernel
    reads: no host value is baked into the launch."""
    if rate == 0.0:
        return None
    if (seed is None or seed.numel() != 1 or seed.device != device
            or seed.dtype != torch.uint32):
        raise ValueError(
            "dropout needs a one-element uint32 seed tensor on "
            f"{device}, got "
            + ("None" if seed is None else
               f"{tuple(seed.shape)} {seed.dtype} on {seed.device}"))
    return seed, rate


# ---------------------------------------------------------------------------
# B1: flash-attention forward (plain, with lse, with dropout)
# ---------------------------------------------------------------------------

@_define("flash_attention_fwd")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str, with_lse: bool,
                        dropout_seed: Optional[torch.Tensor],
                        dropout_rate: float, bh_base: int = 0,
                        q_base: int = 0, k_base: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of softmax(q k^T) v over ``layout``-ordered q/k/v,
    their head dim already one of the kernel's widths. lse is ``(B, H,
    N)`` fp32 with ``with_lse``, else empty. ``dropout_rate`` 0 means no
    dropout; otherwise ``dropout_seed`` is the one-element device tensor
    the kernel reads the seed from, and ``bh_base``/``q_base``/``k_base``
    place the mask (the global coordinates of the first row, query and
    key). One launch of csrc/flash_attention_fwd.cu."""
    fa = flash_attention
    q, k, v = fa._kernel_operands(layout, q=q, k=k, v=v)
    dropout = _dropout(dropout_seed, dropout_rate, q.device)
    out = torch.empty_like(q)
    (b, h, n), _ = fa._axes(q, layout)
    lse = torch.empty((b, h, n) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    strides = [s for t in (q, k, v, out) for s in fa._axes(t, layout)[1]]
    lib = _library("fwd")
    with torch.cuda.device(q.device):
        err = lib.vtd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, _DTYPE_CODES[q.dtype],
            b, h, n, q.shape[-1], *strides,
            *fa._dropout_c_args(dropout, (bh_base, q_base, k_base)),
            _stream(q.device))
    _build.raise_on_error(lib, err, "flash attention forward")
    fa._count("drop_launches" if dropout is not None
              else "lse_launches" if with_lse else "launches")
    return out, lse


@flash_attention_fwd.register_fake
def _(q, k, v, layout, with_lse, dropout_seed, dropout_rate, bh_base=0,
      q_base=0, k_base=0):
    (b, h, n), _ = flash_attention._axes(q, layout)
    return (torch.empty_like(q),
            q.new_empty((b, h, n) if with_lse else (0,),
                        dtype=torch.float32))


# ---------------------------------------------------------------------------
# B2: flash-attention backward (plain and dropout replay)
# ---------------------------------------------------------------------------

@_define("flash_attention_bwd")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, layout: str,
                        dropout_seed: Optional[torch.Tensor],
                        dropout_rate: float, request: int = 0,
                        bh_base: int = 0, q_base: int = 0, k_base: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq fp32, dk, dv)`` at the padded head dim from the backward
    kernels (csrc/flash_attention_bwd.cu); lse and delta are contiguous
    ``(B, H, N)`` fp32; dq is summed in fp32 over the key tiles in order
    and written once, so it is the same on every run. A nonzero
    ``dropout_rate`` replays the forward's mask, its seed read from
    ``dropout_seed``'s device memory and placed by ``bh_base``/``q_base``/
    ``k_base`` as in the forward. ``request`` is one of
    ``flash_attention.DQ_ROUTES``' values (0: the route the dtype
    selects)."""
    fa = flash_attention
    q, k, v, g = fa._kernel_operands(layout, q=q, k=k, v=v, g=g)
    dropout = _dropout(dropout_seed, dropout_rate, q.device)
    (b, h, n), _ = fa._axes(q, layout)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    partials = None
    if fa.dq_route(q.dtype, request, fa.partials_bytes(
            b, h, n, q.shape[-1])) == "partials":
        partials = torch.empty((-(-n // fa.KEY_TILE), b * h, n, q.shape[-1]),
                               dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, g, dq, dk, dv)
               for s in fa._axes(t, layout)[1]]
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        err = lib.vtd_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if partials is None else partials.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, n, q.shape[-1],
            *strides, *fa._dropout_c_args(dropout, (bh_base, q_base, k_base)),
            _stream(q.device))
    _build.raise_on_error(lib, err, "flash attention backward")
    fa._count("backward_launches" if dropout is None
              else "backward_drop_launches")
    return dq, dk, dv


@flash_attention_bwd.register_fake
def _(q, k, v, g, lse, delta, layout, dropout_seed, dropout_rate, request=0,
      bh_base=0, q_base=0, k_base=0):
    return (q.new_empty(q.shape, dtype=torch.float32), torch.empty_like(k),
            torch.empty_like(v))


# ---------------------------------------------------------------------------
# B4: fused LayerNorm
# ---------------------------------------------------------------------------

@_define("layer_norm")
def layer_norm(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of the rows of 2-D ``x2`` (csrc/layer_norm.cu), output in
    x2's dtype; gamma and beta are read in fp32."""
    # The kernel loads 16 (fp32) or 8 (bf16) bytes at a time.
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    g = gamma.float().contiguous()
    b = beta.float().contiguous()
    out = torch.empty_like(x2)
    lib = _library("ln")
    with torch.cuda.device(x2.device):
        err = lib.vtd_layer_norm(x2.data_ptr(), g.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), x2.shape[0], x2.shape[1],
                                 float(eps), _DTYPE_CODES[x2.dtype],
                                 _stream(x2.device))
    _build.raise_on_error(lib, err, "layer norm")
    with fused_ln._count_lock:
        fused_ln.fused_layer_norm.launches += 1
    return out


@layer_norm.register_fake
def _(x2, gamma, beta, eps):
    return x2.new_empty(x2.shape)


# ---------------------------------------------------------------------------
# B3: fused dense + bias + mish
# ---------------------------------------------------------------------------

@_define("dense_mish")
def dense_mish(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               apply_mish: bool, request: int) -> torch.Tensor:
    """``mish(x2 @ w + b)`` (or without mish) in x2's dtype from
    csrc/dense_mish.cu; ``request`` is one of ``fused_ffn.REQUESTS``'
    values (0: the instance the shape selects)."""
    m, n = x2.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out
    x2, w, b = (t.contiguous() for t in (x2, w, b))
    taken = ctypes.c_int(-1)
    lib = _library("ffn")
    with torch.cuda.device(x2.device):
        err = lib.vtd_dense_mish(x2.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), m, n, x2.shape[1],
                                 _DTYPE_CODES[x2.dtype], int(apply_mish),
                                 request, ctypes.byref(taken),
                                 _stream(x2.device))
    _build.raise_on_error(lib, err, "dense + mish")
    route = fused_ffn.fused_dense_mish
    with fused_ffn._count_lock:
        route.launches += 1
        route.tensor_core_launches += int(taken.value > 0)
    return out


@dense_mish.register_fake
def _(x2, w, b, apply_mish, request):
    return x2.new_empty((x2.shape[0], w.shape[1]))


# ---------------------------------------------------------------------------
# B5: fused int8 dense, bf16 out (fused) and fp32 out
# ---------------------------------------------------------------------------

def _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish: bool,
                 request: int, out_dtype, route) -> torch.Tensor:
    m, n = x2.shape[0], kernel_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    x2 = x2.contiguous()
    kernel_q = kernel_q.contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().reshape(-1).contiguous()
    taken = ctypes.c_int(-1)
    lib = _library("int8")
    with torch.cuda.device(x2.device):
        err = lib.vtd_int8_dense(
            x2.data_ptr(), kernel_q.data_ptr(),
            None if transposed is None else transposed.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n,
            x2.shape[1], _DTYPE_CODES[x2.dtype], _DTYPE_CODES[out_dtype],
            int(apply_mish), request, ctypes.byref(taken),
            _stream(x2.device))
    _build.raise_on_error(lib, err, "int8 dense")
    with quantization._count_lock:
        route.launches += 1
        route.tensor_core_launches += int(taken.value > 0)
    return out


@_define("fused_int8_dense")
def fused_int8_dense(x2: torch.Tensor, kernel_q: torch.Tensor,
                     transposed: Optional[torch.Tensor], scale: torch.Tensor,
                     bias: torch.Tensor, apply_mish: bool,
                     request: int) -> torch.Tensor:
    """The fused route of csrc/int8_dense.cu: per-row int8 quantization of
    ``x2`` (M, K), the int8 product with ``kernel_q`` (K, N), scale, bias
    (+ mish), bf16 out. ``transposed`` is the (N, K) copy of the codes the
    tensor-core instances read (quantization.transposed_codes), or None
    for the guarded instance.

    Not exportable yet: the wrapper keys its cache of ``transposed`` on
    ``data_ptr()``, which a traced tensor does not have, so an int8 model
    cannot be traced by ``torch.export`` (nor can the JAX package export
    one)."""
    return _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish,
                        request, torch.bfloat16, quantization.fused_int8_dense)


@_define("int8_dense")
def int8_dense(x2: torch.Tensor, kernel_q: torch.Tensor,
               transposed: Optional[torch.Tensor], scale: torch.Tensor,
               bias: torch.Tensor, apply_mish: bool,
               request: int) -> torch.Tensor:
    """The fp32-out route of csrc/int8_dense.cu (the attention
    projections), arguments as ``fused_int8_dense``'s; not exportable
    either."""
    return _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish,
                        request, torch.float32, quantization.int8_dense)


@fused_int8_dense.register_fake
def _(x2, kernel_q, transposed, scale, bias, apply_mish, request):
    return x2.new_empty((x2.shape[0], kernel_q.shape[1]),
                        dtype=torch.bfloat16)


@int8_dense.register_fake
def _(x2, kernel_q, transposed, scale, bias, apply_mish, request):
    return x2.new_empty((x2.shape[0], kernel_q.shape[1]),
                        dtype=torch.float32)


# ---------------------------------------------------------------------------
# Dropout of the MLP and head activations (no Pallas counterpart)
# ---------------------------------------------------------------------------

@_define("dropout")
def dropout_apply(x2: torch.Tensor, seed: torch.Tensor,
                  rate: float, row_base: int = 0) -> torch.Tensor:
    """keras Dropout of the rows of 2-D ``x2`` with the counter-hash mask
    of the uint32 seed in ``seed``'s device memory (csrc/dropout.cu), rows
    counted from ``row_base``, output in x2's dtype."""
    _dropout(seed, rate, x2.device)
    x2 = x2.contiguous()
    out = torch.empty_like(x2)
    lib = _library("drop")
    with torch.cuda.device(x2.device):
        err = lib.vtd_dropout(
            x2.data_ptr(), out.data_ptr(), x2.shape[0], x2.shape[1],
            _DTYPE_CODES[x2.dtype], seed.data_ptr(),
            flash_attention._keep_threshold(rate), dropout.inv_keep(rate),
            int(row_base) & flash_attention._M32, _stream(x2.device))
    _build.raise_on_error(lib, err, "dropout")
    with dropout._count_lock:
        dropout.dropout.launches += 1
    return out


@dropout_apply.register_fake
def _(x2, seed, rate, row_base=0):
    return x2.new_empty(x2.shape)
