"""Weight bridge between the JAX package's .npz export and the port.

The JAX package's ``save_params_npz`` (vision_transformer_detector_tpu/
utils/checkpoint.py) writes one array per parameter under its
slash-joined pytree path, e.g. ``encoder/0/mha/query/kernel``. The port's
modules keep the JAX names and layouts (dense ``(in, out)``, q/k/v
``(D, H, K)``, attention out ``(H, K, D)``, position embedding ``(P, 1)``),
so a name maps to a state-dict key by ``/`` -> ``.`` and an array loads
as it is, with no transpose.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vision_transformer_detector_tpu.config import DetectorConfig

from ..models.vit_detector import ViTDetector


def params_from_numpy(flat: Dict[str, np.ndarray],
                      config: DetectorConfig) -> ViTDetector:
    """A CPU ViTDetector holding the arrays of ``flat``.

    Every parameter must be present with the expected shape, and every
    array must be a parameter: a missing, extra or misshapen name raises.
    Arrays are cast to ``config.param_dtype``.
    """
    quantized = sorted(name for name in flat if "kernel_q" in name)
    if quantized:
        raise NotImplementedError(
            f"int8-quantized layers are not ported yet: {quantized[:3]}")
    query = flat.get("encoder/0/mha/query/kernel")
    head_dim = None if query is None else int(query.shape[-1])
    model = ViTDetector(config, head_dim=head_dim)
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
        loaded[key] = torch.from_numpy(
            np.array(array, dtype=np.float32)).to(state[key].dtype)
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
