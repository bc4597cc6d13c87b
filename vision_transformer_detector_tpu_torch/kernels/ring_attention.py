"""Ring attention: exact global attention with the token axis sharded
over a ring of processes, on the flash kernels.

Counterpart of vision_transformer_detector_tpu/kernels/ring_attention.py
(``ring_attention``, ``_ring_attention_local``). Each rank of the ring
(the mesh's 'model' axis, parallel/mesh.py) holds ``(B, n_local, H, K)``
shards of q, k and v, any 1/sqrt(K) scale already applied; K/V shards
rotate around the ring while each rank attends its queries to the block
it holds, so attention memory and work divide by the ring size R.

Forward: R steps. Each step first posts the exchange of the current K/V
with the next and previous ranks (``dist.batch_isend_irecv``), then runs
the block, then takes the next K/V: the exchange overlaps the block, as
JAX's ``ppermute`` before ``block`` does. A block is one flash forward
launch with its logsumexp (B1-lse; B1-drop under dropout) on CUDA
tensors, ``reference_attention`` and ``reference_attention_lse`` on CPU
tensors. The partial outputs and logsumexps are merged in fp32 by
logsumexp weights and the output is cast to q's dtype once.

Backward (a ``torch.autograd.Function``): delta = rowsum(dO * O) in fp32,
then R steps that call the flash backward (B2; B2-replay under dropout)
for the block at hand with the GLOBAL logsumexp and delta, which give
each block its exact share of the gradients. dq accumulates in fp32 on
the rank; each step's dk/dv join fp32 accumulators that travel with
their K/V block, so after the R-th rotation they are home. On the kernel
route the block's dk and dv come out of the kernel in the input dtype
(bf16 for the preset that rings) and are added to the fp32 accumulators:
each partial is rounded once, where JAX's fp32 einsum accumulator rounds
only at the end; chip_smoke.py's ``parallel`` phase holds the ring of
2 and of 4 processes against the plain versions over the whole
sequence.

Dropout is the flash kernels' counter-hash mask on GLOBAL coordinates:
each block launches with ``bh_base`` = the rank's first global
batch*head row (its 'data' coordinate times B*H), ``q_base`` = the
rank's first query (index * n_local) and ``k_base`` = the first key of
the block it holds (origin * n_local, origin = (index - step) mod R), so
the mask is the one flash attention draws over the whole sequence and
batch, however the tokens and the batch are sharded.

On CUDA the blocks launch the kernels whatever ``use_flash_attention``
says (JAX's ring block is the same function in einsums). The exchange
goes through parallel/collectives.py: NCCL moves device tensors, gloo
stages them through host memory.

``shard_tokens``/``gather_tokens`` are the autograd pair at the model's
token split: the slice's backward all-gathers dx over the ring, and the
gather's backward slices (every rank's downstream graph is an identical
replica, so a summing backward would multiply the gradients by R);
``sum_grads_over`` makes the attention projections' parameter gradients,
which each rank computes from its own tokens only, whole.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from ..parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size)
from . import flash_attention as fa


def _block_forward(q, k, v, use_kernel: bool, dropout, offsets):
    """(out, lse) of one block: out in q's dtype, lse (B, H, n) fp32."""
    if use_kernel:
        return fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                  dropout=dropout, offsets=offsets)
    return (fa.reference_attention(q, k, v, "bnhk", dropout, offsets),
            fa.reference_attention_lse(q, k, "bnhk"))


def _block_backward(q, k, v, g, lse, delta, use_kernel: bool, dropout,
                    offsets):
    """(dq fp32, dk, dv) of one block from the global lse and delta."""
    if use_kernel:
        return fa._launch_backward(q, k, v, g, lse, delta, "bnhk", dropout,
                                   offsets=offsets, fp32_dq=True)
    return fa.reference_attention_backward(q, k, v, g, "bnhk", dropout,
                                           offsets, lse=lse, delta=delta)


def _weights(lse_old, lse_new):
    """(B, H, n) logsumexp difference as a (B, n, H, 1) factor."""
    return torch.exp(lse_old - lse_new).transpose(1, 2)[..., None]


class RingAttentionFunction(torch.autograd.Function):
    """The ring's forward and backward over ``(B, n_local, H, K)`` shards;
    see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, group, ring: int, index: int,
                use_kernel: bool, dropout, bh_base: int):
        n = q.shape[1]
        to, frm = (index + 1) % ring, (index - 1) % ring
        out = lse = None
        k_cur, v_cur = k, v
        for step in range(ring):
            pending = (collectives.Exchange([k_cur, v_cur], to, frm, group)
                       if step + 1 < ring else None)
            origin = (index - step) % ring
            block_out, block_lse = _block_forward(
                q, k_cur, v_cur, use_kernel, dropout,
                (bh_base, index * n, origin * n))
            if out is None:
                out, lse = block_out.float(), block_lse
            else:
                merged = torch.logaddexp(lse, block_lse)
                out = (out * _weights(lse, merged)
                       + block_out.float() * _weights(block_lse, merged))
                lse = merged
            if pending is not None:
                k_cur, v_cur = pending.wait()
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.index, ctx.group = ring, index, group
        ctx.use_kernel, ctx.dropout, ctx.bh_base = (use_kernel, dropout,
                                                    bh_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring, index, group = ctx.ring, ctx.index, ctx.group
        n = q.shape[1]
        to, frm = (index + 1) % ring, (index - 1) % ring
        delta = (g.float() * out.float()).sum(dim=-1).transpose(
            1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for step in range(ring):
            pending = (collectives.Exchange([k_cur, v_cur], to, frm, group)
                       if step + 1 < ring else None)
            origin = (index - step) % ring
            dq_s, dk_s, dv_s = _block_backward(
                q, k_cur, v_cur, g, lse, delta, ctx.use_kernel, ctx.dropout,
                (ctx.bh_base, index * n, origin * n))
            dq += dq_s.float()
            dk += dk_s.float()
            dv += dv_s.float()
            if pending is not None:
                k_cur, v_cur = pending.wait()
            if ring > 1:
                # The accumulators follow their block; after the R-th
                # rotation each is back on the rank that owns its keys.
                dk, dv = collectives.Exchange([dk, dv], to, frm,
                                              group).wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = MODEL_AXIS,
                   dropout_rate: float | None = None,
                   dropout_seed=None) -> torch.Tensor:
    """Exact global attention over the token axis sharded on ``axis_name``
    of ``mesh``: this rank's ``(B, n_local, H, K)`` shards in, its shard
    of the output out (q's dtype). ``dropout_rate``/``dropout_seed`` turn
    on the flash kernels' probability dropout on global coordinates (the
    seed an integer or a one-element uint32 tensor; see
    flash_attention.py). Differentiable."""
    dropout = fa._dropout_args(dropout_rate, dropout_seed)
    devices = {t.device.type for t in (q, k, v)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"ring_attention takes q/k/v all on the CPU or all on CUDA, "
            f"got devices {sorted(devices)}")
    use_kernel = devices == {"cuda"}
    if use_kernel and dropout is not None:
        seed, rate = dropout
        if not isinstance(seed, torch.Tensor):
            seed = fa.seed_tensor(seed, q.device)
        dropout = seed, rate
    bh_base = axis_index(mesh, DATA_AXIS) * q.shape[0] * q.shape[2]
    return RingAttentionFunction.apply(
        q, k, v, axis_group(mesh, axis_name), axis_size(mesh, axis_name),
        axis_index(mesh, axis_name), use_kernel, dropout, bh_base)


# ---------------------------------------------------------------------------
# The model's token split
# ---------------------------------------------------------------------------

class _ShardTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ring: int, index: int):
        ctx.group = group
        n = x.shape[1] // ring
        return x[:, index * n:(index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_gather_cat(g.contiguous(), 1, ctx.group),
                None, None, None)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ring: int, index: int):
        ctx.ring, ctx.index = ring, index
        return collectives.all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // ctx.ring
        return (g[:, ctx.index * n:(ctx.index + 1) * n].contiguous(),
                None, None, None)


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


def check_ring_tokens(n: int, mesh, axis_name: str = MODEL_AXIS) -> None:
    """The JAX wrapper's check: the token axis must divide the ring."""
    ring = axis_size(mesh, axis_name)
    if n % ring != 0:
        raise ValueError(f"token axis {n} must divide ring size {ring}")


def shard_tokens(x: torch.Tensor, mesh,
                 axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's slice of the token axis (axis 1) of a ``(B, N, ...)``
    tensor that every rank of the ring holds alike; the backward
    all-gathers the slices' gradients."""
    check_ring_tokens(x.shape[1], mesh, axis_name)
    ring = axis_size(mesh, axis_name)
    if ring == 1:
        return x
    return _ShardTokens.apply(x, axis_group(mesh, axis_name), ring,
                              axis_index(mesh, axis_name))


def gather_tokens(x: torch.Tensor, mesh,
                  axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """The ring's token slices of ``x`` joined along axis 1 in rank order;
    the backward takes this rank's slice of the gradient."""
    ring = axis_size(mesh, axis_name)
    if ring == 1:
        return x
    return _GatherTokens.apply(x, axis_group(mesh, axis_name), ring,
                               axis_index(mesh, axis_name))


def sum_grads_over(mesh, tensors, axis_name: str = MODEL_AXIS):
    """``tensors`` as they are, but their gradients summed over the ring
    (one flat all-reduce): for parameters each rank uses on its own tokens
    only. Without grad recording, or on a ring of one, the tensors
    themselves."""
    tensors = tuple(tensors)
    if axis_size(mesh, axis_name) == 1 or not torch.is_grad_enabled():
        return tensors
    return _SumGradsOver.apply(axis_group(mesh, axis_name), *tensors)
