"""Process groups and multi-process data feeding.

Counterpart of vision_transformer_detector_tpu/parallel/data.py, all six
functions, and ``local_store`` for groups of local processes. Every process is one position of the mesh
(parallel/mesh.py) and loads only its shard of the input: the rows of the
global batch at its 'data' coordinate (the global batch is the
concatenation of the shards over 'data', in rank order; the ranks along
'model' load the same rows). ``initialize_distributed`` joins the process
group: ``tcp://coordinator`` with an explicit size and rank, or torchrun's
``env://`` (the counterpart of the TPU-pod auto-detection). The local
batches stay local tensors: ``global_batch_from_local`` places a rank's
shard on its device, and the steps reduce over the groups themselves.

``synced_global_eval_batches`` keeps the JAX lockstep protocol, so
shards of unequal size (or an empty one) cannot desync the evaluation's
collectives: each round every rank shares its row count, whether its
iterator is exhausted and its batch layout; every rank pads to the
round's largest count with inert rows (zero images, EMPTY_SLOT labels);
a rank without a batch takes the layout of one that has one; the rounds
end when every rank is exhausted (a zero-row batch is not exhaustion).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import EMPTY_SLOT_VALUE
from . import collectives
from .mesh import DATA_AXIS, axis_index, axis_size

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    (and the CLI's) ``LOCAL_RANK``, else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``"cuda"`` without an index is the card
    ``LOCAL_RANK`` (one card per process; a rank beyond the visible cards
    raises rather than share one); anything else is taken as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False")
    index, count = local_rank(), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"local rank {index} needs a card of its own but {count} "
            "CUDA device(s) are visible; start at most one process per "
            "card, or name a device explicitly")
    return torch.device("cuda", index)


@contextlib.contextmanager
def local_store():
    """``(port, env)`` for a group of processes this process starts on
    its own host: a TCPStore server on 127.0.0.1, held here while the
    block runs, at a port the OS picked when binding it, and the
    environment that makes every rank's ``init_process_group`` (env:// or
    tcp://127.0.0.1:port) a client of it (torchelastic's agent store)
    rather than rank 0 binding one. A port found free by binding a socket
    and letting it go can be taken by another process before rank 0 binds
    it again; this one is never let go while the group forms."""
    store = dist.TCPStore(host_name="127.0.0.1", port=0, is_master=True,
                          wait_for_workers=False)
    try:
        yield store.port, {"MASTER_ADDR": "127.0.0.1",
                           "MASTER_PORT": str(store.port),
                           "TORCHELASTIC_USE_AGENT_STORE": "True",
                           "TORCHELASTIC_RESTART_COUNT": "0"}
    finally:
        del store


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           device="cuda") -> None:
    """Join the process group: ``tcp://coordinator_address`` with
    ``num_processes`` and ``process_id``, or, without a coordinator,
    torchrun's environment (``env://``). ``backend`` defaults to NCCL for
    a CUDA ``device`` and gloo for the CPU; under NCCL the process's card
    (``rank_device``) is made current. A no-op when the group is
    already initialised (one process may run several CLI commands, train
    then evaluate, against the same group)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError(
            "num_processes/process_id were given without "
            "coordinator_address; partial explicit configuration would "
            "be silently ignored and auto-detection could pick a "
            "different topology")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    elif all(name in os.environ for name in _TORCHRUN_ENV):
        kwargs = dict(init_method="env://")
    else:
        raise ValueError(
            "no coordinator_address and no torchrun environment "
            f"({', '.join(_TORCHRUN_ENV)}): pass coordinator_address, "
            "num_processes and process_id")
    dist.init_process_group(backend, **kwargs)
    if backend == "nccl":
        # Before the first collective, which creates the communicator.
        torch.cuda.set_device(rank_device(device))


def process_batch_indices(mesh, global_batch_size: int) -> range:
    """The rows of the GLOBAL batch this process must load: the rows of
    its 'data' coordinate (every rank along 'model' loads the same rows;
    a mesh with a data axis of 1 replicates the whole batch)."""
    data = axis_size(mesh, DATA_AXIS)
    per = global_batch_size // data
    start = axis_index(mesh, DATA_AXIS) * per
    return range(start, start + per)


def process_shard_spec(mesh, global_batch_size: int
                       ) -> Tuple[int, int, int]:
    """``(shard_index, num_shards, local_batch)`` for this process: feed
    the dataset ``image_paths[shard_index::num_shards]`` with
    ``local_batch`` rows per batch. Ranks that hold the same rows (the
    'model' replicas) get the same ``shard_index``."""
    data_size = axis_size(mesh, DATA_AXIS)
    if global_batch_size % data_size != 0:
        raise ValueError(
            f"global batch size {global_batch_size} is not divisible by "
            f"the data-parallel axis ({data_size} shards); "
            "process_batch_indices' equal-shard mapping (and the train "
            "step itself) requires divisibility")
    rows = process_batch_indices(mesh, global_batch_size)
    local = len(rows)
    # The strided image_paths[shard_index::num_shards] layout only
    # expresses equal-sized, aligned shards.
    if global_batch_size % local != 0 or rows.start % local != 0:
        raise NotImplementedError(
            f"this process holds rows [{rows.start}, {rows.stop}) of the "
            f"{global_batch_size}-row global batch — not an aligned "
            "equal-size shard; strided path sharding cannot express "
            "this layout, feed per-shard batches instead")
    return rows.start // local, global_batch_size // local, local


def global_batch_from_local(mesh, local_batch, device="cpu") -> torch.Tensor:
    """This rank's shard of the global batch as a tensor on ``device``.
    The global batch is the concatenation of the shards over 'data' in
    rank order; no copy of it exists anywhere."""
    if isinstance(local_batch, torch.Tensor):
        return local_batch.to(device)
    return torch.from_numpy(np.ascontiguousarray(local_batch)).to(device)


def global_batches(mesh, local_iterator: Iterable, device="cpu"
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Wrap a per-process (images, labels) iterator into shard tensors."""
    for images, labels in local_iterator:
        yield (global_batch_from_local(mesh, images, device),
               global_batch_from_local(mesh, labels, device))


def _multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def synced_global_eval_batches(mesh, local_iterator: Iterable, device="cpu"
                               ) -> Iterator[Tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]]:
    """Lockstep eval rounds that tolerate uneven per-process shards: each
    round yields this rank's ``(images, labels, valid)``, padded to the
    round's common row count (module docstring). ``valid`` marks the real
    rows; ``evaluate_map`` zeroes the decoded predictions of the others,
    an exact metric no-op. On one process this skips zero-row batches and
    ends with the iterator."""

    def describe(arr):
        """(dtype char code, *trailing_shape) — the consensus row format."""
        return (ord(arr.dtype.char),) + tuple(arr.shape[1:])

    it = iter(local_iterator)
    exhausted = False
    template = None
    while True:
        batch = None
        if not exhausted:
            batch = next(it, None)
            exhausted = batch is None
        if batch is not None:
            images = np.asarray(batch[0])
            labels = np.asarray(batch[1])
            n = images.shape[0]
            template = (describe(images), describe(labels))
        else:
            n = 0
        if _multi_process():
            # One row per round: this rank's count, whether its iterator
            # is exhausted, and its batch layout, so a rank without data
            # pads with the layout of one that has some.
            row = [n, int(exhausted)] + (
                [v for part in template for v in part]
                if template is not None else [])
            width = 16  # generous fixed width for the layout encoding
            row = (row + [-1] * width)[:width]
            table = torch.stack(collectives.all_gather(
                torch.tensor(row, dtype=torch.int64))).numpy()
            round_n = int(table[:, 0].max())
            if bool(table[:, 1].all()):
                return          # every rank's iterator is done
            if round_n == 0:
                continue        # an all-empty round, but streams remain
            if template is None:
                donor = table[int(table[:, 0].argmax())]
                vals = [int(v) for v in donor[2:] if v != -1]
                img_len = len(vals) - 3  # labels carry dtype + 2 dims
                template = ((vals[0],) + tuple(vals[1:img_len]),
                            tuple(vals[img_len:]))
        else:
            if exhausted:
                return
            round_n = n
            if round_n == 0:
                continue        # zero-row batch mid-stream: skip, don't end
        if batch is None:
            (img_dt, *img_tail), (lab_dt, *lab_tail) = template
            images = np.zeros((0,) + tuple(img_tail), np.dtype(chr(img_dt)))
            labels = np.zeros((0,) + tuple(lab_tail), np.dtype(chr(lab_dt)))
        pad = round_n - n
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate(
                [labels, np.full((pad,) + labels.shape[1:],
                                 EMPTY_SLOT_VALUE, labels.dtype)])
        valid = np.arange(round_n) < n
        yield (global_batch_from_local(mesh, images, device),
               global_batch_from_local(mesh, labels, device),
               global_batch_from_local(mesh, valid, device))
