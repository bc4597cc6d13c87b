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
and pruned like the JAX package's step directories.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

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


def load_params_npz(path: str, config: DetectorConfig) -> ViTDetector:
    """Load a ``save_params_npz`` file into a CPU ViTDetector."""
    with np.load(path) as data:
        return params_from_numpy({name: data[name] for name in data.files},
                                 config)


CHECKPOINT_SUFFIX = ".pt"
_STEP_PREFIX = "step_"


def checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(directory, name + CHECKPOINT_SUFFIX)


def save_train_state(path: str, state: Dict, best_ap: float,
                     config: DetectorConfig,
                     loss_config: Optional[LossConfig] = None,
                     train_config: Optional[TrainConfig] = None) -> None:
    """Write ``{params, opt_state, step, best_ap, config}`` (and the
    ``dropout_rng`` generator's state, if any) to ``path`` atomically: a
    crash mid-write leaves the previous file intact."""
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
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_train_state(path: str, device) -> Dict:
    """The payload of ``save_train_state``, tensors on ``device``. Only
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


def prune_checkpoints(directory: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` step-stamped checkpoints; named
    ones (``highest_ap``, ``ongoing``, ``final``) are never touched.
    Returns the removed paths."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    entries = list_step_checkpoints(directory)
    doomed = entries[:-keep] if keep else entries
    for _, path in doomed:
        os.remove(path)
    return [path for _, path in doomed]
