"""Fused LayerNorm: a hand-written Hopper kernel and its plain PyTorch
version.

Counterpart of vision_transformer_detector_tpu/kernels/fused_ln.py, with
its contract: LayerNorm over the last axis of ``x`` (..., D) with D a
multiple of 128, all math in fp32 (two-pass variance, eps 1e-3 by
default), output in x's dtype; an empty batch returns x; any other D
raises ValueError. Inference only: the kernel has no backward, so a call
that would need a gradient raises (the model routes training through its
differentiable LayerNorm, as the JAX package does).

Routing is by the device of x, never by a fallback: CPU tensors take
``layer_norm_reference`` (the model's LayerNorm math); CUDA tensors launch
``csrc/layer_norm.cu`` through ``torch.ops.vtd_torch.layer_norm``
(kernels/ops.py) or raise, at any D % 128 == 0 as the JAX kernel takes:
a warp a row up to D 4096, a block a row past it. The kernel's rsqrtf is
approximate, so
on the card it agrees with the plain version to a few fp32 ulp (1e-5 in
fp32, one bf16 rounding in bf16).
"""

from __future__ import annotations

import threading

import torch

SOURCE = "layer_norm.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-3
                         ) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (keras default eps 1e-3),
    two-pass variance as jnp.var, output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    normed = centered * torch.rsqrt(var + eps)
    out = normed * gamma.float() + beta.float()
    return out.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (..., D), D % 128 == 0."""
    d = x.shape[-1]
    if d % 128 != 0:
        raise ValueError(
            f"fused_layer_norm needs the normalized axis to be a "
            f"multiple of 128 lanes, got D={d} — route this shape "
            "through the plain layer norm instead")
    if x.numel() == 0:
        return x  # empty batch: nothing to normalize
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        raise RuntimeError(
            "fused_layer_norm is inference-only and has no backward; call "
            "it under torch.no_grad() or torch.inference_mode()")
    if x.is_cuda and gamma.is_cuda and beta.is_cuda:
        return _launch(x, gamma, beta, eps)
    devices = {t.device.type for t in (x, gamma, beta)}
    if devices == {"cpu"}:
        return layer_norm_reference(x, gamma, beta, eps)
    if devices != {"cuda"}:
        raise ValueError(
            f"fused_layer_norm takes x, gamma and beta all on the CPU or "
            f"all on CUDA, got {sorted(devices)}")
    return _launch(x, gamma, beta, eps)


# Kernel launches; the plain version adds none.
fused_layer_norm.launches = 0


def _launch(x, gamma, beta, eps: float) -> torch.Tensor:
    """One launch through ``torch.ops.vtd_torch.layer_norm``
    (kernels/ops.py), on the rows of x."""
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(
            f"gamma and beta must be ({d},), got {tuple(gamma.shape)} and "
            f"{tuple(beta.shape)}")
    return _OP(x.reshape(-1, d), gamma, beta, float(eps)).reshape(x.shape)


# ``torch.ops.vtd_torch.layer_norm.default``, bound by kernels/ops.py when
# it registers the operator.
_OP = None
