"""Ring attention: exact global attention with the token axis sharded
over a ring of processes, on the flash kernels.

Counterpart of vision_transformer_detector_tpu/kernels/ring_attention.py
(``ring_attention``, ``_ring_attention_local``). Each rank of the ring
(the mesh's 'model' axis, parallel/mesh.py) holds ``(B, n_local, H, K)``
shards of q, k and v, any 1/sqrt(K) scale already applied; K/V shards
rotate around the ring while each rank attends its queries to the block
it holds, so attention memory and work divide by the ring size R.

Forward: R steps. Each step first posts the exchange of the current K/V
with the next and previous ranks (``dist.batch_isend_irecv``), then
hands the block on, then takes the next K/V. The blocks are attended in
key order (a block that arrives before its turn is held until the ones
before it have come). On CUDA tensors a block is one flash forward launch
(B1-lse; B1-drop under dropout) in the kernel's fp32-output instance that
resumes the online softmax's state (running max, normaliser,
unnormalised accumulator) where the launch for the previous block
suspended it, and suspends its own for the next: the chain computes, in
the same order, what one launch over the whole sequence computes, and the
output is rounded once, after the last block, as JAX's
``_ring_attention_local`` keeps its running statistics and output in fp32
across the blocks. So the ring's result does not depend on R. On CPU
tensors a block is ``reference_attention`` (fp32 out) and
``reference_attention_lse``, merged in fp32 by logsumexp weights and cast
once.

Backward (a ``torch.autograd.Function``): delta = rowsum(dO * O) in fp32,
then R steps that call the flash backward (B2; B2-replay under dropout)
for the block at hand with the GLOBAL logsumexp and delta, which give
each block its exact share of the gradients. dq accumulates in fp32 on
the rank; each step's dk/dv join fp32 accumulators that travel with
their K/V block, so after the R-th rotation they are home. The kernels
write the block's dq, dk and dv in fp32, so each gradient is rounded
once, at the end, as one launch over the whole sequence rounds it (JAX's
autodiff through its loop rounds each block's dk and dv to bf16 and sums
them in bf16); chip_smoke.py's ``parallel`` phase holds the ring of 2
and of 4 processes against the plain versions over the whole sequence.

``gathered_attention`` is the same arithmetic with K and V all-gathered
instead of passed around (its backward sums dk and dv over the group in
fp32 and keeps its own part): the global attention of sequence sharding
(models/vit_detector.py), whose blocks are slices of the gathered keys.

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

The model's token split around the ring (the slice whose backward
all-gathers, the gather whose backward slices, and the projections'
gradients summed over the ring) is parallel/tensor.py's.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from ..parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size)
from . import flash_attention as fa


def _block_forward(q, k, v, use_kernel: bool, dropout, offsets,
                   state=None, last: bool = True):
    """One block of the key-ordered chain. Kernel route: the launch
    resumes the online softmax's ``state`` of the blocks before it (None:
    the first) and, but for the ``last``, returns its own state ``(acc, m,
    l)``; the last returns ``(out fp32, lse)``, what one launch over all
    the keys returns. Plain route: ``(out fp32, lse)`` of the block alone,
    for the merge (``_attend_blocks``)."""
    if use_kernel:
        return fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                  dropout=dropout, offsets=offsets,
                                  out_fp32=True, state=state,
                                  suspend=not last)
    return (fa.reference_attention(q, k, v, "bnhk", dropout, offsets,
                                   out_dtype=torch.float32),
            fa.reference_attention_lse(q, k, "bnhk"))


def _block_backward(q, k, v, g, lse, delta, use_kernel: bool, dropout,
                    offsets):
    """(dq, dk, dv) of one block, fp32, from the global lse and delta."""
    if use_kernel:
        return fa._launch_backward(q, k, v, g, lse, delta, "bnhk", dropout,
                                   offsets=offsets, fp32_dq=True,
                                   fp32_dkv=True)
    return fa.reference_attention_backward(q, k, v, g, "bnhk", dropout,
                                           offsets, lse=lse, delta=delta,
                                           out_dtype=torch.float32)


def _weights(lse_old, lse_new):
    """(B, H, n) logsumexp difference as a (B, n, H, 1) factor."""
    return torch.exp(lse_old - lse_new).transpose(1, 2)[..., None]


def _attend_blocks(q, blocks, parts: int, use_kernel: bool, dropout,
                   bh_base: int, q_base: int):
    """(out fp32, lse) of q over the ``parts`` key blocks ``blocks``
    yields in key order, each ``(k, v, origin)`` with its first key at
    ``origin * n``. Kernel route: each launch resumes the online softmax
    where the one before it stopped, so the chain computes what one launch
    over all the keys computes. Plain route: the blocks' fp32 outputs
    merged by logsumexp weights."""
    n = q.shape[1]
    out = lse = state = None
    for i, (k_blk, v_blk, origin) in enumerate(blocks):
        offsets = (bh_base, q_base, origin * n)
        if use_kernel:
            state = _block_forward(q, k_blk, v_blk, True, dropout, offsets,
                                   state, last=i == parts - 1)
            continue
        block_out, block_lse = _block_forward(q, k_blk, v_blk, False,
                                              dropout, offsets)
        if out is None:
            out, lse = block_out, block_lse
        else:
            merged = torch.logaddexp(lse, block_lse)
            out = (out * _weights(lse, merged)
                   + block_out * _weights(block_lse, merged))
            lse = merged
    return state if use_kernel else (out, lse)


def _ring_blocks(k, v, group, ring: int, index: int):
    """The K/V blocks of a ring rank in ring order: each step first posts
    the exchange of the block at hand, then hands it out, then waits for
    the next (the exchange overlaps the block's work)."""
    to, frm = (index + 1) % ring, (index - 1) % ring
    k_cur, v_cur = k, v
    for step in range(ring):
        pending = (collectives.Exchange([k_cur, v_cur], to, frm, group)
                   if step + 1 < ring else None)
        yield k_cur, v_cur, (index - step) % ring
        if pending is not None:
            k_cur, v_cur = pending.wait()


def _in_key_order(blocks):
    """``blocks``' (k, v, origin) in ascending origin, each handed out as
    soon as it and every block before it have arrived (the rest are held:
    at most the ring's size)."""
    held, want = {}, 0
    for k, v, origin in blocks:
        held[origin] = (k, v)
        while want in held:
            yield (*held.pop(want), want)
            want += 1


def _delta(g, out):
    """rowsum(g * out) in fp32 as (B, H, n)."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


class RingAttentionFunction(torch.autograd.Function):
    """The ring's forward and backward over ``(B, n_local, H, K)`` shards;
    see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, group, ring: int, index: int,
                use_kernel: bool, dropout, bh_base: int):
        out, lse = _attend_blocks(
            q, _in_key_order(_ring_blocks(k, v, group, ring, index)), ring,
            use_kernel, dropout, bh_base, index * q.shape[1])
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
        delta = _delta(g, out)
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
            dq += dq_s
            dk += dk_s
            dv += dv_s
            if pending is not None:
                k_cur, v_cur = pending.wait()
            if ring > 1:
                # The accumulators follow their block; after the R-th
                # rotation each is back on the rank that owns its keys.
                dk, dv = collectives.Exchange([dk, dv], to, frm,
                                              group).wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


class GatheredAttentionFunction(torch.autograd.Function):
    """A rank's ``(B, n, H, K)`` queries, keys and values (the
    ``index``-th of ``parts`` token shards) attended over every rank's
    keys, all-gathered along the tokens: the ring's blocks (in key order)
    and merge without the ring. The backward sums each rank's fp32 dk and
    dv over the whole sequence across the group and keeps its own part
    (a reduce-scatter), rounded once."""

    @staticmethod
    def forward(ctx, q, k, v, group, parts: int, index: int,
                use_kernel: bool, dropout, bh_base: int):
        n = q.shape[1]
        k_all, v_all = (collectives.all_gather_cat(t, 1, group)
                        for t in (k, v))
        blocks = ((k_all[:, i * n:(i + 1) * n], v_all[:, i * n:(i + 1) * n],
                   i) for i in range(parts))
        out, lse = _attend_blocks(q, blocks, parts, use_kernel, dropout,
                                  bh_base, index * n)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k_all, v_all, out, lse)
        ctx.group, ctx.parts, ctx.index = group, parts, index
        ctx.use_kernel, ctx.dropout, ctx.bh_base = (use_kernel, dropout,
                                                    bh_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_all, v_all, out, lse = ctx.saved_tensors
        n = q.shape[1]
        delta = _delta(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.empty((2, *k_all.shape), dtype=torch.float32,
                          device=k_all.device)
        for i in range(ctx.parts):
            keys = slice(i * n, (i + 1) * n)
            dq_s, dkv[0, :, keys], dkv[1, :, keys] = _block_backward(
                q, k_all[:, keys], v_all[:, keys], g, lse, delta,
                ctx.use_kernel, ctx.dropout, (ctx.bh_base, ctx.index * n,
                                              i * n))
            dq += dq_s
        collectives.all_reduce_(dkv, ctx.group)
        mine = dkv[:, :, ctx.index * n:(ctx.index + 1) * n]
        return (dq.to(q.dtype), mine[0].to(k_all.dtype),
                mine[1].to(v_all.dtype), None, None, None, None, None, None)


def _kernel_route(q, k, v, dropout, what: str):
    """(use_kernel, dropout with a device seed): the kernels for CUDA
    tensors, the plain versions for CPU ones."""
    devices = {t.device.type for t in (q, k, v)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"{what} takes q/k/v all on the CPU or all on CUDA, "
            f"got devices {sorted(devices)}")
    use_kernel = devices == {"cuda"}
    if use_kernel and dropout is not None:
        seed, rate = dropout
        if not isinstance(seed, torch.Tensor):
            seed = fa.seed_tensor(seed, q.device)
        dropout = seed, rate
    return use_kernel, dropout


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
    use_kernel, dropout = _kernel_route(
        q, k, v, fa._dropout_args(dropout_rate, dropout_seed),
        "ring_attention")
    bh_base = axis_index(mesh, DATA_AXIS) * q.shape[0] * q.shape[2]
    return RingAttentionFunction.apply(
        q, k, v, axis_group(mesh, axis_name), axis_size(mesh, axis_name),
        axis_index(mesh, axis_name), use_kernel, dropout, bh_base)


def gathered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, axis_name: str = MODEL_AXIS,
                       dropout_rate: float | None = None,
                       dropout_seed=None) -> torch.Tensor:
    """Exact global attention over the token axis sharded on ``axis_name``
    of ``mesh``, as ``ring_attention`` (the same shards in and out, the
    same blocks, merge and dropout coordinates), but with K and V
    all-gathered along the tokens first (the backward reduce-scatters dK
    and dV in fp32) instead of passed around the ring: sequence
    sharding's global attention. Differentiable."""
    use_kernel, dropout = _kernel_route(
        q, k, v, fa._dropout_args(dropout_rate, dropout_seed),
        "gathered_attention")
    bh_base = axis_index(mesh, DATA_AXIS) * q.shape[0] * q.shape[2]
    return GatheredAttentionFunction.apply(
        q, k, v, axis_group(mesh, axis_name), axis_size(mesh, axis_name),
        axis_index(mesh, axis_name), use_kernel, dropout, bh_base)


def check_ring_tokens(n: int, mesh, axis_name: str = MODEL_AXIS) -> None:
    """The JAX wrapper's check: the token axis must divide the ring."""
    ring = axis_size(mesh, axis_name)
    if n % ring != 0:
        raise ValueError(f"token axis {n} must divide ring size {ring}")
