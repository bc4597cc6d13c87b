"""The autograd pairs of tensor parallelism, sequence sharding and ring
attention over one mesh axis ('model' unless told otherwise), on
parallel/collectives.py.

No JAX counterpart: XLA inserts these collectives from the shardings
(JAX's parallel/mesh.py:param_shardings, models/vit_detector.py:
_maybe_shard_sequence). Here each one is an explicit
``torch.autograd.Function`` whose backward is the collective's transpose:

  * ``sum_grads_over``: identity forward, gradients summed over the axis
    (one flat all-reduce) in the backward: for replicated tensors each
    rank uses on its own part of the work only (the parameters of the
    blocks that run on the rank's tokens);
  * ``gather``: all-gather along a dimension forward, this rank's slice
    backward: a split tensor made whole for a consumer that every rank
    runs alike (a summing backward would multiply the gradient by the
    axis size);
  * ``split``: this rank's slice forward, all-gather backward: the
    inverse pair;
  * ``gather_scatter``: all-gather forward, reduce-scatter backward: keys
    and values of sequence sharding, which every rank's queries use;
  * ``row_parallel_matmul`` and ``column_parallel_matmul``: a rank's slice
    of a layer's product, with the sum over 'model' (in the forward and in
    the backward respectively) taken over fp32 partial products and
    rounded to the compute dtype once, where one process's GEMM rounds its
    fp32 accumulator: a sharded layer then rounds as the whole layer does.

The slices are equal, in rank order. On an axis of one every function
returns its input (the products: the plain product).
"""

from __future__ import annotations

import torch

from . import collectives
from .mesh import MODEL_AXIS, axis_group, axis_index, axis_size


def _slice(x: torch.Tensor, dim: int, parts: int, index: int):
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n).contiguous()


class _SumGradsOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = collectives.all_reduce_(
            torch.cat([g.reshape(-1) for g in grads]), ctx.group)
        parts = flat.split([g.numel() for g in grads])
        return (None,) + tuple(p.view_as(g) for p, g in zip(parts, grads))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, parts: int, index: int):
        ctx.dim, ctx.parts, ctx.index = dim, parts, index
        return collectives.all_gather_cat(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return (_slice(g, ctx.dim, ctx.parts, ctx.index),
                None, None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, parts: int, index: int):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, parts, index)

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_gather_cat(g.contiguous(), ctx.dim,
                                           ctx.group),
                None, None, None, None)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, parts: int, index: int):
        ctx.dim, ctx.group, ctx.parts, ctx.index = dim, group, parts, index
        return collectives.all_gather_cat(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        summed = collectives.all_reduce_(g.contiguous().clone(), ctx.group)
        return (_slice(summed, ctx.dim, ctx.parts, ctx.index),
                None, None, None, None)


def fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``x`` (..., K), ``w`` (K, N), one dtype) as its fp32
    sums, unrounded: what a bf16 GEMM accumulates before it rounds (bf16
    products are exact in fp32). A bf16 GEMM with an fp32 output on CUDA,
    an fp32 product of the upcast operands on the CPU."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _weight_grad(x, g):
    """dw of ``x @ w`` for the cotangent ``g``, as autograd forms it."""
    return x.reshape(-1, x.shape[-1]).t().mm(g.reshape(-1, g.shape[-1]))


class _RowParallelMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        y = collectives.all_reduce_(fp32_product(x, w), group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return torch.matmul(g, w.t()), _weight_grad(x, g), None


class _ColumnParallelMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = collectives.all_reduce_(fp32_product(g, w.t()), ctx.group)
        return dx.to(x.dtype), _weight_grad(x, g), None


def _axis(mesh, axis_name: str):
    return (axis_group(mesh, axis_name), axis_size(mesh, axis_name),
            axis_index(mesh, axis_name))


def sum_grads_over(mesh, tensors, axis_name: str = MODEL_AXIS):
    """``tensors`` as they are, but their gradients summed over the axis
    (one flat all-reduce). Without grad recording, or on an axis of one,
    the tensors themselves."""
    tensors = tuple(tensors)
    if axis_size(mesh, axis_name) == 1 or not torch.is_grad_enabled():
        return tensors
    return _SumGradsOver.apply(axis_group(mesh, axis_name), *tensors)


def gather(x: torch.Tensor, dim: int, mesh,
           axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order; the backward
    takes this rank's slice of the gradient."""
    group, parts, index = _axis(mesh, axis_name)
    if parts == 1:
        return x
    return _Gather.apply(x, dim, group, parts, index)


def split(x: torch.Tensor, dim: int, mesh,
          axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (which the axis size
    divides); the backward all-gathers the slices' gradients."""
    group, parts, index = _axis(mesh, axis_name)
    if parts == 1:
        return x
    return _Split.apply(x, dim, group, parts, index)


def gather_scatter(x: torch.Tensor, dim: int, mesh,
                   axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order; the backward
    sums the gradients over the axis and takes this rank's slice."""
    group, parts, index = _axis(mesh, axis_name)
    if parts == 1:
        return x
    return _GatherScatter.apply(x, dim, group, parts, index)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                        axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """``x @ w`` summed over the axis, ``x`` this rank's columns of the
    input and ``w`` its rows of the kernel: the fp32 partial products are
    all-reduced and rounded to x's dtype once. The backward is each
    rank's part of one process's (its input columns' gradient, its
    rows' weight gradient)."""
    group, parts, _ = _axis(mesh, axis_name)
    if parts == 1:
        return torch.matmul(x, w)
    return _RowParallelMatmul.apply(x, w, group)


def column_parallel_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                           axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """``x @ w`` of a replicated ``x`` and this rank's columns ``w`` of the
    kernel: this rank's output columns, as one process computes them. The
    input's gradient sums the ranks' fp32 partial products over the axis
    and rounds once."""
    group, parts, _ = _axis(mesh, axis_name)
    if parts == 1:
        return torch.matmul(x, w)
    return _ColumnParallelMatmul.apply(x, w, group)
