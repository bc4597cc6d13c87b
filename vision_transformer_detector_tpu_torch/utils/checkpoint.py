"""Weight bridge between the JAX package's .npz export and the port, and
the port's train-state checkpoints.

The JAX package's ``save_params_npz`` (vision_transformer_detector_tpu/
utils/checkpoint.py) writes one array per parameter under its
slash-joined pytree path, e.g. ``encoder/0/mha/query/kernel``. The port's
modules keep the JAX names and layouts (dense ``(in, out)``, q/k/v
``(D, H, K)``, attention out ``(H, K, D)``, position embedding ``(P, 1)``),
so a name maps to a state-dict key by ``/`` -> ``.`` and an array loads
as it is, with no transpose.

Train-state checkpoints take the place of the JAX package's orbax trees:
one ``<name>.pt`` file per checkpoint, written by ``torch.save`` under a
private name and renamed into place, holding ``{params, opt_state, step,
best_ap, config}`` and, when the state has one, the dropout seed
generator's state (``dropout_rng``). Step-stamped ones (``step_0000000042.pt``) are listed
and pruned like the JAX package's step directories, each with its input
position sidecar (``<name>.dataset.json``).

``AsyncCheckpointManager`` is the counterpart of the JAX package's orbax
async checkpointer: the train loop pays only the copy of the state to
host memory, made on a side stream behind an event that the train stream
waits on, and a writer thread does the ``torch.save`` and the rename.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, LossConfig, TrainConfig, configs_to_dict
from ..kernels.quantization import quantize_params
from ..models.vit_detector import ViTDetector


def params_from_numpy(flat: Dict[str, np.ndarray],
                      config: DetectorConfig) -> ViTDetector:
    """A CPU ViTDetector holding the arrays of ``flat``.

    Every parameter must be present with the expected shape, and every
    array must be a parameter: a missing, extra or misshapen name raises.
    Float arrays are cast to ``config.param_dtype``. Arrays of the JAX
    package's ``quantize_params`` (``kernel_q``, ``scale``) load into the
    int8 model of kernels/quantization.py, int8 codes as they are.
    """
    quantized = any(name.endswith("/kernel_q") for name in flat)
    # The physical head dim: the query kernel's last axis, or the
    # quantized layer's (H, K) bias.
    query = flat.get("encoder/0/mha/query/bias" if quantized
                     else "encoder/0/mha/query/kernel")
    head_dim = None if query is None else int(query.shape[-1])
    model = ViTDetector(config, head_dim=head_dim)
    if quantized:
        # The int8 layout of the same model; the zeros quantize quietly
        # and are overwritten below.
        with torch.no_grad():
            for param in model.parameters():
                param.zero_()
        model = quantize_params(model)
    state = model.state_dict()
    names = {key.replace(".", "/"): key for key in state}
    missing = sorted(set(names) - set(flat))
    extra = sorted(set(flat) - set(names))
    if missing or extra:
        raise ValueError(
            f"parameter names do not match the config: missing {missing}, "
            f"unexpected {extra}")
    loaded = {}
    for name, key in names.items():
        array = np.asarray(flat[name])
        if tuple(array.shape) != tuple(state[key].shape):
            raise ValueError(
                f"{name}: shape {array.shape} != expected "
                f"{tuple(state[key].shape)}")
        host_dtype = (np.int8 if state[key].dtype == torch.int8
                      else np.float32)
        loaded[key] = torch.from_numpy(
            np.array(array, dtype=host_dtype)).to(state[key].dtype)
    model.load_state_dict(loaded)
    return model


def params_to_numpy(params: ViTDetector) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``: slash-joined names -> arrays."""
    return {key.replace(".", "/"): value.detach().cpu().numpy()
            for key, value in params.state_dict().items()}


def save_params_npz(path: str, params: ViTDetector) -> None:
    """The JAX package's ``save_params_npz`` format: one array per
    parameter (or int8 buffer) under its slash-joined name."""
    np.savez(path, **params_to_numpy(params))


def load_params_npz(path: str, config: DetectorConfig) -> ViTDetector:
    """Load a ``save_params_npz`` file into a CPU ViTDetector."""
    with np.load(path) as data:
        return params_from_numpy({name: data[name] for name in data.files},
                                 config)


CHECKPOINT_SUFFIX = ".pt"
_STEP_PREFIX = "step_"


def checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(directory, name + CHECKPOINT_SUFFIX)


def dataset_sidecar_path(directory: str, name: str) -> str:
    """The input-position sidecar beside checkpoint ``name``."""
    return os.path.join(directory, name + ".dataset.json")


def train_state_payload(state: Dict, best_ap: float, config: DetectorConfig,
                        loss_config: Optional[LossConfig] = None,
                        train_config: Optional[TrainConfig] = None) -> Dict:
    """``{params, opt_state, step, best_ap, config}`` (and the
    ``dropout_rng`` generator's state, if any), tensors where they lie."""
    payload = {
        "params": {k: v.detach()
                   for k, v in state["params"].state_dict().items()},
        "opt_state": state["opt_state"],
        "step": int(state["step"]),
        "best_ap": float(best_ap),
        "config": configs_to_dict(config, loss_config, train_config),
    }
    if state.get("dropout_rng") is not None:
        payload["dropout_rng"] = state["dropout_rng"].get_state()
    return payload


def write_payload(path: str, payload: Any) -> None:
    """``torch.save`` under a private name, then an atomic rename: a crash
    mid-write leaves the previous file intact."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class AsyncCheckpointManager:
    """Checkpoint writes that overlap training.

    ``save(path, payload)`` copies the payload's tensors to host memory
    (pinned, on a side stream, for CUDA tensors; the train stream then
    waits on that copy's event before its next kernel, so an in-place
    update cannot race it, and the host does not block) and hands the
    host copy to a writer thread, which waits for the event, writes and
    renames. A save to a path with a pending write waits for that write
    first. ``wait()`` joins every pending write and raises the first
    writer error.
    """

    def __init__(self):
        self._pending: Dict[str, threading.Thread] = {}
        self._errors: List[Exception] = []
        self._streams: Dict[Any, Any] = {}

    def _to_host(self, payload):
        """(the payload with host copies of its tensors, the event that
        the copies are done on, or None when they were made at once)."""
        devices = set()
        _map_tensors(payload, lambda t: devices.add(t.device))
        cuda = [d for d in devices if d.type == "cuda"]
        if not cuda:
            return _map_tensors(payload, lambda t: t.detach().clone()), None
        device = cuda[0]
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        stream = self._streams[device]
        main = torch.cuda.current_stream(device)

        def copy(t):
            if not t.is_cuda:
                return t.detach().clone()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t.detach(), non_blocking=True)

        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            host = _map_tensors(payload, copy)
            event = torch.cuda.Event()
            event.record(stream)
        main.wait_event(event)
        return host, event

    def save(self, path: str, payload: Any) -> None:
        previous = self._pending.pop(path, None)
        if previous is not None:
            previous.join()
        host, event = self._to_host(payload)

        def write():
            try:
                if event is not None:
                    event.synchronize()
                write_payload(path, host)
            except Exception as exc:  # raised again by wait()
                self._errors.append(exc)

        thread = threading.Thread(target=write, name=f"checkpoint:{path}",
                                  daemon=True)
        thread.start()
        self._pending[path] = thread

    def wait(self) -> None:
        pending, self._pending = self._pending, {}
        for thread in pending.values():
            thread.join()
        if self._errors:
            error, self._errors = self._errors[0], []
            raise error


def load_train_state(path: str, device) -> Dict:
    """A ``train_state_payload`` written by ``write_payload``, tensors on
    ``device``. Only
    tensors and plain containers are unpickled (``weights_only``)."""
    return torch.load(path, map_location=device, weights_only=True)


def step_checkpoint_name(step: int) -> str:
    """Name of a step-stamped checkpoint (sortable)."""
    return f"{_STEP_PREFIX}{int(step):010d}"


def list_step_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """[(step, path)] of step-stamped checkpoints, ascending by step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for entry in os.listdir(directory):
        stem, suffix = os.path.splitext(entry)
        if not stem.startswith(_STEP_PREFIX) or suffix != CHECKPOINT_SUFFIX:
            continue
        try:
            step = int(stem[len(_STEP_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(directory, entry)))
    return sorted(out)


def prune_checkpoints(directory: str, keep: int,
                      pending_step: Optional[int] = None) -> List[str]:
    """Delete all but the newest ``keep`` step-stamped checkpoints and
    their input-position sidecars; named ones (``highest_ap``,
    ``ongoing``, ``final``) are never touched. Returns the removed paths.

    ``pending_step``: a step whose checkpoint write is still in flight (an
    async save lands by a rename, so the file is not listed yet). It
    counts toward the ``keep`` window."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    entries = list_step_checkpoints(directory)
    if pending_step is not None:
        pending = int(pending_step)
        listed = {step for step, _ in entries}
        if pending not in listed and keep and sorted(
                listed | {pending})[-keep:].count(pending):
            # The pending write occupies one of the keep slots.
            keep -= 1
    doomed = entries[:-keep] if keep else entries
    for _, path in doomed:
        os.remove(path)
        sidecar = path[:-len(CHECKPOINT_SUFFIX)] + ".dataset.json"
        if os.path.exists(sidecar):
            os.remove(sidecar)
    return [path for _, path in doomed]
