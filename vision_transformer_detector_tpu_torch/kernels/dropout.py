"""Dropout of the model's MLP and head activations: a hand-written Hopper
kernel and its plain PyTorch version.

No Pallas counterpart: the JAX package draws these masks with jax.random
(``_dropout`` in vision_transformer_detector_tpu/models/vit_detector.py),
whose threefry bits the port does not reproduce. The port's mask is a pure
function of a seed and each element's index: the attention mask's counter
hash (``flash_attention.dropout_keep_mask``) of the seed at batch*head 0
over (row, column), the rows being all leading axes, kept iff below the
keep threshold, Bernoulli(1 - rate) as JAX's; ``row_base`` numbers the rows
from a global offset (a data-parallel rank passes its first row of the
global batch, so it draws the rows the whole batch draws there),
``row_map`` maps a local row to a global one first (a sequence-sharded
rank holds tokens [n0, n0 + n_l) of every image: (n_l, N, n0); see
flash_attention.map_rows), and ``col_base`` numbers the columns (a
tensor-parallel rank holds columns [c0, c0 + c_l) of a column-parallel
activation).
``dropout(x, seed, rate)`` is keras Dropout with that mask: x / (1 - rate) where kept, else 0, in x's
dtype. Since the mask depends on nothing but the seed, a block recomputed
under remat draws the mask its forward drew, and the backward is the same
function applied to the cotangent.

Routing is by the device of x, never by a fallback: CPU tensors take
``dropout_reference`` (the hash in int64 tensor ops); CUDA tensors launch
``csrc/dropout.cu`` through ``torch.ops.vtd_torch.dropout``
(kernels/ops.py), one pass over x, or raise. The kernel reads the seed
from device memory, so a CUDA graph captured over a train step replays
each step with the seed its caller wrote there: on the kernel route the
seed is a one-element uint32 tensor on x's device (the model passes views
of its seed table); an integer is copied there once per call. On the card
the two versions agree bit for bit (the kernel multiplies by the fp32
reciprocal of 1 - rate, as PyTorch's division by a scalar does there).
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .flash_attention import (
    _M32, IDENTITY_MAP, _keep_threshold, _mul32, map_rows, seed_tensor)

SOURCE = "dropout.cu"
_count_lock = threading.Lock()


def dropout_mask(seed, shape, rate: float, device, row_base: int = 0,
                 row_map=IDENTITY_MAP, col_base: int = 0) -> torch.Tensor:
    """The keep mask of ``shape``: ``dropout_keep_mask`` of ``seed`` (an
    integer or a one-element integer tensor on ``device``), batch*head
    index 0, and each element's (row, column) index over (all leading
    axes, the last axis), rows mapped by ``row_map`` and counted from
    ``row_base``, columns from ``col_base``, kept iff below the keep
    threshold. Plain tensor ops with no host sync.

    The index terms are formed on a row and a column vector, the seed
    joins the row vector, and the full-size work (one broadcast add, the
    murmur3 finalizer's three xor-shifts and two multiplies, the compare)
    runs in place on one int64 tensor: uint32 arithmetic held in int64,
    with each multiplier taken as its residue in (-2**31, 2**31) so no
    product leaves int64."""
    rows = math.prod(shape[:-1])
    row = _mul32(map_rows(torch.arange(rows, device=device), int(row_base),
                          row_map) & _M32, 0x85EBCA6B)
    col = _mul32((torch.arange(shape[-1], device=device) + int(col_base))
                 & _M32, 0xC2B2AE35)
    if isinstance(seed, torch.Tensor):
        row = row + (seed.reshape(1).to(torch.int64) & _M32)
    else:
        row = row + (int(seed) & _M32)
    x = row[:, None] + col[None, :]
    x.bitwise_and_(_M32)
    x.bitwise_xor_(x >> 16)
    x.mul_(0x7FEB352D).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 15)
    x.mul_(0x846CA68B - 2 ** 32).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 16)
    return (x < _keep_threshold(rate)).reshape(shape)


def dropout_reference(x: torch.Tensor, seed, rate: float,
                      row_base: int = 0, row_map=IDENTITY_MAP,
                      col_base: int = 0) -> torch.Tensor:
    """The plain version: x / (1 - rate) where ``dropout_mask`` keeps,
    else 0, in x's dtype (differentiable)."""
    mask = dropout_mask(seed, x.shape, rate, x.device, row_base, row_map,
                        col_base)
    return torch.where(mask, x / (1.0 - rate), 0.0).to(x.dtype)


class DropoutFunction(torch.autograd.Function):
    """The kernel with its backward: the same mask and scale applied to
    the cotangent, from the same seed."""

    @staticmethod
    def forward(ctx, x, seed, rate: float, coords: tuple):
        ctx.seed, ctx.rate, ctx.coords = seed, rate, coords
        return _launch(x, seed, rate, *coords)

    @staticmethod
    def backward(ctx, g):
        return _launch(g, ctx.seed, ctx.rate, *ctx.coords), None, None, None


def dropout(x: torch.Tensor, seed, rate: float, row_base: int = 0,
            row_map=IDENTITY_MAP, col_base: int = 0) -> torch.Tensor:
    """keras Dropout of ``x`` with the counter-hash mask of ``seed``, rows
    mapped by ``row_map`` and counted from ``row_base``, columns from
    ``col_base``; see the module docstring. ``rate`` lies in (0, 1)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    if tuple(row_map)[0] < 1:
        raise ValueError(f"row_map {row_map}: inner_local must be >= 1")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dropout_reference(x, seed, rate, row_base, row_map,
                                     col_base)
        raise ValueError(f"dropout takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    if not isinstance(seed, torch.Tensor):
        seed = seed_tensor(seed, x.device)
    coords = (row_base, *row_map, col_base)
    if torch.is_grad_enabled() and x.requires_grad:
        return DropoutFunction.apply(x, seed, rate, coords)
    return _launch(x, seed, rate, *coords)


# Kernel launches; the plain version adds none.
dropout.launches = 0


def inv_keep(rate: float) -> float:
    """1 / (1 - rate) in fp32, as PyTorch forms the reciprocal of a scalar
    divisor on the card."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _launch(x, seed, rate: float, row_base: int = 0, inner_local: int = 1,
            inner_global: int = 1, inner_base: int = 0,
            col_base: int = 0) -> torch.Tensor:
    """One launch through ``torch.ops.vtd_torch.dropout`` (kernels/ops.py)
    on x as a (rows, last axis) array, the mask placed as in
    ``dropout_mask``."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        return x.clone()
    out = _OP(x.reshape(-1, x.shape[-1]), seed, float(rate), int(row_base),
              int(inner_local), int(inner_global), int(inner_base),
              int(col_base))
    return out.reshape(x.shape)


# ``torch.ops.vtd_torch.dropout.default``, bound by kernels/ops.py when it
# registers the operator.
_OP = None
