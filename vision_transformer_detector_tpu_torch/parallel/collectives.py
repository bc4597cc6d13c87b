"""The collectives of the port, over ``torch.distributed`` groups.

No JAX counterpart: XLA writes the JAX package's collectives from its
shardings. Here every one is explicit, and each takes tensors on the
device the caller computes on:

  * under NCCL, CUDA tensors go to the collective as they are (a CPU
    tensor, such as a host table of counts, is moved to the rank's card
    for the call and back);
  * under gloo, all-reduce, broadcast and all-gather take CPU and CUDA
    tensors as they are (gloo copies a CUDA tensor through the host
    itself). Its point-to-point operations take only host tensors, so
    ``Exchange`` stages CUDA tensors through host memory. The kernels
    still run on the card: this is how the bytes travel between
    processes, not a fallback of the computation. Two processes on one
    card can only be joined this way (NCCL refuses two ranks on one
    device).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _transport(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: a CPU tensor on the
    current CUDA device for NCCL; as it is for gloo."""
    if _backend(group) == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _p2p_transport(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's send and recv take it: the host for gloo,
    else as ``_transport``."""
    if _backend(group) == "nccl":
        return _transport(t, group)
    return t.cpu()


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place and return it."""
    moved = _transport(t, group)
    dist.all_reduce(moved, group=group)
    if moved is not t:
        t.copy_(moved)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with the global rank ``src``'s ``t``, in place."""
    moved = _transport(t, group)
    dist.broadcast(moved, src=src, group=group)
    if moved is not t:
        t.copy_(moved)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group rank order,
    on ``t``'s device."""
    moved = _transport(t.contiguous(), group)
    parts = [torch.empty_like(moved)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, moved, group=group)
    return [p.to(t.device) for p in parts]


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group rank order."""
    return torch.cat(all_gather(t, group), dim=dim)


class Exchange:
    """Posted sends of tensors to one peer and receives of the same shapes
    from another (``dist.batch_isend_irecv``); ``wait()`` returns the
    received tensors on the senders' device. Under gloo CUDA tensors
    travel through host copies (module docstring)."""

    def __init__(self, tensors: Sequence[torch.Tensor], to: int, frm: int,
                 group=None):
        self._device = tensors[0].device
        staged = [_p2p_transport(t.contiguous(), group) for t in tensors]
        self._received = [torch.empty_like(t) for t in staged]
        ops = [dist.P2POp(dist.isend, t, _global_rank(group, to), group)
               for t in staged]
        ops += [dist.P2POp(dist.irecv, t, _global_rank(group, frm), group)
                for t in self._received]
        # The sends keep their buffers alive until wait().
        self._staged = staged
        self._requests = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for request in self._requests:
            request.wait()
        self._staged = None
        return [t.to(self._device) for t in self._received]


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` gets here (an all-reduce of one
    number on the group's transport)."""
    all_reduce_(torch.zeros(1), group)


def uses_nccl(group=None) -> bool:
    """Whether ``group``'s collectives run on NCCL (which a CUDA graph can
    capture; gloo's cannot be)."""
    return _backend(group) == "nccl"
