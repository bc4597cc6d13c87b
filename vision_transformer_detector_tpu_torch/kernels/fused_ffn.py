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
through ``torch.ops.vtd_torch.dense_mish`` (kernels/ops.py) or raise. A
call that needs a gradient goes through ``FusedDenseMishFunction``, whose
backward is the JAX package's recompute VJP (``_fused_bwd``) in plain
torch: z = x w + b in fp32, dz = g (t + z (1 - t^2) sigmoid(z)) with
t = tanh(softplus(z)), then dx = dz w^T, dw = x^T dz, db = sum(dz), all in
fp32 and cast to the inputs' dtypes. It is two matmuls outside any
kernel, as in the JAX package.

On the card the product runs on the tensor cores wherever the rows of x
and w can be moved in 16-byte pieces (``tensor_core_shape``: K and N
multiples of 8 in bf16, of 4 in fp32): ``wgmma`` or ``mma.sync`` in bf16,
3xTF32 ``mma.sync`` in fp32. Other shapes take the kernel's guarded
CUDA-core instance. That is dispatch by shape, decided before the launch;
``fused_dense_mish.tensor_core_launches`` counts the launches of the
tensor-core instances apart.
"""

from __future__ import annotations

import threading

import torch

SOURCE = "dense_mish.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# The kernel's instances and the request that holds the C entry point to
# each (None: by shape).
REQUESTS = {None: 0, "guarded": 1, "mma_sync": 2, "wgmma": 3}


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


def tensor_core_shape(k: int, n: int, dtype: torch.dtype) -> bool:
    """Whether x (M, k) @ w (k, n) in ``dtype`` takes a tensor-core
    instance on the card: rows of x and of w are moved in 16-byte pieces,
    so K and N must be multiples of 8 (bf16) or 4 (fp32); any M. The other
    shapes take the guarded instance."""
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    return k > 0 and n > 0 and k % per_chunk == 0 and n % per_chunk == 0


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
    use_kernel = x.is_cuda and w.is_cuda and b.is_cuda
    if not use_kernel:
        devices = {t.device.type for t in (x, w, b)}
        if devices != {"cpu"}:
            raise ValueError(
                f"fused_dense_mish takes x, w and b all on the CPU or all on "
                f"CUDA, got devices {sorted(devices)}")
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        y = FusedDenseMishFunction.apply(x2, w, b, apply_mish, use_kernel)
    elif use_kernel:
        y = _launch(x2, w, b, apply_mish)
    else:
        y = dense_mish_reference(x2, w, b, apply_mish)
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[1],))


# Kernel launches, and those of them that took a tensor-core instance; the
# plain version adds none.
fused_dense_mish.launches = 0
fused_dense_mish.tensor_core_launches = 0


def _launch(x2, w, b, apply_mish: bool,
            instance: str | None = None) -> torch.Tensor:
    """One kernel launch through ``torch.ops.vtd_torch.dense_mish``
    (kernels/ops.py). ``instance`` names one of ``REQUESTS`` to take
    instead of the one the shape selects (the tests and the timings use
    it); a shape or dtype that the named instance cannot take raises."""
    dtype = x2.dtype
    if dtype not in _DTYPE_CODES or w.dtype != dtype or b.dtype != dtype:
        raise ValueError(
            f"x, w and b must share one dtype, float32 or bfloat16, got "
            f"{x2.dtype}, {w.dtype}, {b.dtype}")
    if not x2.get_device() == w.get_device() == b.get_device():
        raise ValueError("x, w and b must be on one CUDA device")
    return _OP(x2, w, b, apply_mish, REQUESTS[instance])


# ``torch.ops.vtd_torch.dense_mish.default``, bound by kernels/ops.py when
# it registers the operator.
_OP = None
