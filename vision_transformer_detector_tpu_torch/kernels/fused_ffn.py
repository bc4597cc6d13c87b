"""Fused dense + bias + mish: a hand-written Hopper kernel, its plain
PyTorch version, and the recompute backward.

Counterpart of vision_transformer_detector_tpu/kernels/fused_ffn.py.
``fused_dense_mish(x, w, b, apply_mish=True)`` computes ``mish(x @ w +
b)`` (or ``x @ w + b``) for x (..., K), w (K, N), b (N,), all in one
compute dtype: fp32 products and sums, the bias added in fp32, mish in
fp32 (jax.nn.softplus's form), then the cast to x's dtype. Leading axes of
x flatten into the rows.

Routing is by the device of the tensors, never by a fallback: CPU tensors
take ``dense_mish_reference``; CUDA tensors launch ``csrc/dense_mish.cu``
or raise. Both routes go through ``FusedDenseMishFunction``, whose
backward is the JAX package's recompute VJP (``_fused_bwd``) in plain
torch: z = x w + b in fp32, dz = g (t + z (1 - t^2) sigmoid(z)) with
t = tanh(softplus(z)), then dx = dz w^T, dw = x^T dz, db = sum(dz), all in
fp32 and cast to the inputs' dtypes. It is two matmuls outside any
kernel, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

SOURCE = "dense_mish.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def softplus_f32(y: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's form, max(y, 0) + log1p(exp(-|y|)): finite for
    every finite y."""
    return torch.clamp_min(y, 0.0) + torch.log1p(torch.exp(-y.abs()))


def mish_f32(y: torch.Tensor) -> torch.Tensor:
    """y * tanh(softplus(y)), as the kernels compute it."""
    return y * torch.tanh(softplus_f32(y))


def dense_mish_reference(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         apply_mish: bool = True) -> torch.Tensor:
    """Plain version on 2-D x: the operands upcast to fp32 BEFORE the
    matmul (a bf16 torch.matmul would round its accumulator to bf16),
    which is exact for bf16 products; fp32 bias, mish, cast to x's dtype."""
    y = torch.matmul(x2.float(), w.float()) + b.float()
    if apply_mish:
        y = mish_f32(y)
    return y.to(x2.dtype)


class FusedDenseMishFunction(torch.autograd.Function):
    """``mish(x @ w + b)`` on 2-D x through the kernel (``use_kernel``) or
    the plain version, with the JAX package's recompute backward."""

    @staticmethod
    def forward(ctx, x2, w, b, apply_mish: bool, use_kernel: bool):
        ctx.save_for_backward(x2, w, b)
        ctx.apply_mish = apply_mish
        if use_kernel:
            return _launch(x2, w, b, apply_mish)
        return dense_mish_reference(x2, w, b, apply_mish)

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        g2 = g.float()
        if ctx.apply_mish:
            z = torch.matmul(x2.float(), w.float()) + b.float()
            t = torch.tanh(softplus_f32(z))
            dz = g2 * (t + z * (1.0 - t * t) * torch.sigmoid(z))
        else:
            dz = g2
        dx = torch.matmul(dz, w.float().t())
        dw = torch.matmul(x2.float().t(), dz)
        db = dz.sum(dim=0)
        return dx.to(x2.dtype), dw.to(w.dtype), db.to(b.dtype), None, None


def fused_dense_mish(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     apply_mish: bool = True) -> torch.Tensor:
    """``mish(x @ w + b)`` with x (..., K), w (K, N), b (N,);
    differentiable (recompute backward)."""
    if w.dim() != 2 or b.shape != (w.shape[1],) or x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"expected x (..., K), w (K, N), b (N,), got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}")
    devices = {t.device.type for t in (x, w, b)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"fused_dense_mish takes x, w and b all on the CPU or all on "
            f"CUDA, got devices {sorted(devices)}")
    x2 = x.reshape(-1, x.shape[-1])
    y = FusedDenseMishFunction.apply(x2, w, b, apply_mish,
                                     devices == {"cuda"})
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[1],))


# Kernel launches; the plain version adds none.
fused_dense_mish.launches = 0


def _launch(x2, w, b, apply_mish: bool) -> torch.Tensor:
    dtype = x2.dtype
    if dtype not in _DTYPE_CODES or w.dtype != dtype or b.dtype != dtype:
        raise ValueError(
            f"x, w and b must share one dtype, float32 or bfloat16, got "
            f"{x2.dtype}, {w.dtype}, {b.dtype}")
    if len({t.device for t in (x2, w, b)}) != 1:
        raise ValueError("x, w and b must be on one CUDA device")
    m, k = x2.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=dtype, device=x2.device)
    if m == 0:
        return out
    x2, w, b = (t.contiguous() for t in (x2, w, b))
    lib = _library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.vtd_dense_mish(x2.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), m, n, k, _DTYPE_CODES[dtype],
                                 int(apply_mish), stream)
    _build.raise_on_error(lib, err, "dense + mish")
    with _count_lock:
        fused_dense_mish.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    fn = lib.vtd_dense_mish
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vtd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vtd_cuda_error_string.restype = ctypes.c_char_p
    return lib
