"""Inference artifacts: ``torch.export`` programs of the detector.

Counterpart of vision_transformer_detector_tpu/export.py, with its
artifact layout and rules. An artifact directory holds

  * ``model.pt2`` (one batch size) or ``model_b{N}.pt2`` (a bundle, one
    per size): ``torch.export`` programs of forward + decode (+ the NMS
    and top-k postprocess when baked), each a function of ``(params,
    images)`` with ``images`` float32 ``(N, H, W, 3)`` in [-1, 1];
  * ``params.npz``: the weights under the JAX package's slash-joined
    names (utils/checkpoint.py:save_params_npz), kept OUT of the graphs,
    so every graph of a bundle binds the one file;
  * ``config.json``: the DetectorConfig, the baked ``postprocess`` spec
    if any, and the ``device`` type the programs were traced on.

A program is traced on one device type, and the route it holds is that
device's: traced on CUDA it calls the hand-written kernels as the custom
operators ``torch.ops.vtd_torch.*`` (kernels/ops.py: one flash-attention
forward per encoder block, and the dense+mish and LayerNorm kernels when
the config enables them); traced on the CPU it holds their plain
versions. The loader therefore refuses an artifact on a device of
another type. Python branches on the device and on the config are
settled when the program is traced; the NMS loop, over a static number
of slots, is unrolled.

``ExportedDetector`` needs ``torch``, numpy, the config and the kernel
operators: it never imports ``models/``. The int8 model is not exported,
as the JAX package has no int8 export.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .config import DetectorConfig, configs_from_dict, configs_to_dict
from .kernels import ops as _ops  # noqa: F401  (registers torch.ops.vtd_torch)

_MODEL_FILE = "model.pt2"                 # single-batch artifact
_MODEL_FILE_TMPL = "model_b{batch}.pt2"   # multi-batch bundle
_PARAMS_FILE = "params.npz"
_CONFIG_FILE = "config.json"
DEVICE_TYPES = ("cuda", "cpu")

# Canonical keys (and defaults) of a baked-postprocess spec — the kwargs
# of ops/nms.py:postprocess_detections.
_POSTPROCESS_DEFAULTS = {
    "k": 17, "iou_threshold": 0.5, "score_threshold": 0.0,
    "per_class": True,
}


def normalize_postprocess(postprocess: Optional[dict]) -> Optional[dict]:
    """Fill defaults / reject unknown keys for a postprocess spec dict."""
    if postprocess is None:
        return None
    unknown = set(postprocess) - set(_POSTPROCESS_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown postprocess keys {sorted(unknown)}; valid: "
            f"{sorted(_POSTPROCESS_DEFAULTS)}")
    out = dict(_POSTPROCESS_DEFAULTS)
    out.update(postprocess)
    return {"k": int(out["k"]),
            "iou_threshold": float(out["iou_threshold"]),
            "score_threshold": float(out["score_threshold"]),
            "per_class": bool(out["per_class"])}


def _device_type(device) -> str:
    device_type = torch.device(device).type
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"an artifact is traced on one of {DEVICE_TYPES}, "
                         f"not {device!r}")
    return device_type


class _Inference(torch.nn.Module):
    """``(params, images) -> decoded`` (or the postprocess tuple). The
    parameters are an input, a tuple in the order of ``names``; the model
    is a skeleton on the meta device that ``functional_call`` fills, so
    the traced program holds no weights."""

    def __init__(self, config: DetectorConfig, names, head_dim: int,
                 postprocess: Optional[dict]):
        super().__init__()
        from .models.vit_detector import ViTDetector

        with torch.device("meta"):
            skeleton = ViTDetector(config, head_dim=head_dim)
        # A plain attribute, not a submodule: torch.export must not lift
        # the skeleton's (meta) parameters into the program.
        self.__dict__["skeleton"] = skeleton
        self.config = config
        self.names = tuple(names)
        self.postprocess = postprocess

    def forward(self, params, images):
        from .ops.decode import transform_predictions
        from .ops.nms import postprocess_detections

        logits = torch.func.functional_call(
            self.skeleton, dict(zip(self.names, params)), (images,))
        decoded = transform_predictions(logits, self.config)
        if self.postprocess is None:
            return decoded
        return postprocess_detections(decoded, **self.postprocess)


def export_inference(params, config: DetectorConfig, batch_size: int,
                     device="cuda",
                     postprocess: Optional[dict] = None
                     ) -> torch.export.ExportedProgram:
    """Trace forward + decode (+ ``postprocess``, keys of
    ``_POSTPROCESS_DEFAULTS``) for ``(batch_size, H, W, 3)`` float32
    images on ``device`` (``"cuda"`` or ``"cpu"``). ``params`` is a float
    ViTDetector. With ``postprocess`` the program returns ``(scores,
    class_ids, boxes, valid)`` with leading ``(batch_size, k)`` instead of
    the decoded ``(batch_size, max_objects, 6)``."""
    from .kernels.quantization import is_quantized
    from .utils.device import resolve_device

    if is_quantized(params.linear_projection):
        raise ValueError("an int8 model cannot be exported (neither can "
                         "the JAX package export one); export the float "
                         "model")
    device = resolve_device(_device_type(device))
    postprocess = normalize_postprocess(postprocess)
    state = params.state_dict()
    names = sorted(state)
    head_dim = params.encoder[0].mha.query.kernel.shape[-1] \
        if config.encoder_blocks else None
    program = _Inference(config, names, head_dim, postprocess)
    inputs = tuple(state[name].detach().to(device) for name in names)
    h, w = config.image_size
    images = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                         device=device)
    with torch.no_grad():
        return torch.export.export(program, (inputs, images))


def save_exported(directory: str, params, config: DetectorConfig,
                  batch_size, device="cuda",
                  postprocess: Optional[dict] = None) -> str:
    """Write the self-describing artifact directory; returns its path.

    ``batch_size`` may be an int (one graph, ``model.pt2``) or a sequence
    of ints (a bundle: one ``model_b{N}.pt2`` per size; the loader routes
    each request to the smallest graph that fits and pads, so serving
    covers any request size up to the largest exported batch).
    ``postprocess`` bakes NMS + top-k into every graph; the spec and the
    trace device are recorded in config.json."""
    from .utils.checkpoint import save_params_npz

    postprocess = normalize_postprocess(postprocess)
    device_type = _device_type(device)
    os.makedirs(directory, exist_ok=True)
    if isinstance(batch_size, int):
        sizes = [batch_size]
        names = [_MODEL_FILE]
    else:
        sizes = sorted(set(int(b) for b in batch_size))
        if not sizes:
            raise ValueError("batch_size sequence is empty")
        names = [_MODEL_FILE_TMPL.format(batch=b) for b in sizes]
    # Every graph, the params and the config go to temp names first and
    # are swapped in at the end: a failure mid-export leaves the old
    # artifact whole. (torch.export.save wants a .pt2 name and np.savez
    # appends .npz to other extensions, hence the temp names.)
    tmp_names = [".tmp-" + name for name in names]
    for size, tmp in zip(sizes, tmp_names):
        program = export_inference(params, config, size, device_type,
                                   postprocess=postprocess)
        torch.export.save(program, os.path.join(directory, tmp))
    params_tmp = os.path.join(directory, "params.tmp.npz")
    save_params_npz(params_tmp, params)
    payload = configs_to_dict(config)
    if postprocess is not None:
        payload["postprocess"] = postprocess
    payload["device"] = device_type
    config_tmp = os.path.join(directory, _CONFIG_FILE + ".tmp")
    with open(config_tmp, "w") as f:
        json.dump(payload, f, indent=1)
    # Everything is written: clear stale graphs (the loader takes every
    # model*.pt2 it finds, so an old model_b64 would still receive
    # requests), then rename.
    for entry in os.listdir(directory):
        if entry == _MODEL_FILE or (entry.startswith("model_b")
                                    and entry.endswith(".pt2")):
            os.remove(os.path.join(directory, entry))
    for name, tmp in zip(names, tmp_names):
        os.replace(os.path.join(directory, tmp),
                   os.path.join(directory, name))
    os.replace(params_tmp, os.path.join(directory, _PARAMS_FILE))
    os.replace(config_tmp, os.path.join(directory, _CONFIG_FILE))
    return directory


def _batch_of(program: torch.export.ExportedProgram) -> int:
    """The batch size of a program's images input (its last placeholder)."""
    inputs = [node for node in program.graph.nodes if node.op == "placeholder"]
    return int(inputs[-1].meta["val"].shape[0])


class ExportedDetector:
    """Loaded artifact: ``detector(images)`` -> decoded ``(B, max_objects,
    6)`` predictions, or the postprocess tuple of a baked artifact, on the
    artifact's device type, without importing the model code.

    ``device`` defaults to the type recorded at export (``"cuda"`` fails
    without a card); one of another type raises ValueError. A bundle
    routes each call to the smallest exported batch that fits,
    zero-padding the batch axis and slicing the result; a request larger
    than the largest graph raises ValueError. Integer images of any dtype
    are raw pixels and are normalized to [-1, 1] on the device."""

    def __init__(self, directory: str, device=None):
        from .utils.device import resolve_device

        with open(os.path.join(directory, _CONFIG_FILE)) as f:
            payload = json.load(f)
        self.config, _, _ = configs_from_dict(payload)
        #: Baked-postprocess spec (normalize_postprocess form) or None.
        self.postprocess = payload.get("postprocess")
        traced_on = payload.get("device")
        if traced_on not in DEVICE_TYPES:
            raise ValueError(f"{directory}: config.json records no trace "
                             f"device of {DEVICE_TYPES} (got {traced_on!r})")
        device = torch.device(traced_on if device is None else device)
        if device.type != traced_on:
            raise ValueError(
                f"{directory} was exported on {traced_on} and holds that "
                f"device's route; it cannot run on {device.type} (export "
                f"again with --platforms {device.type})")
        self.device = resolve_device(device)
        self._programs = {}   # batch -> callable module
        for entry in sorted(os.listdir(directory)):
            if entry == _MODEL_FILE or (entry.startswith("model_b")
                                        and entry.endswith(".pt2")):
                program = torch.export.load(os.path.join(directory, entry))
                self._programs[_batch_of(program)] = program.module()
        if not self._programs:
            raise FileNotFoundError(
                f"no model.pt2 / model_b*.pt2 under {directory}")
        with np.load(os.path.join(directory, _PARAMS_FILE)) as data:
            self._params = tuple(
                torch.from_numpy(np.asarray(data[name])).to(self.device)
                for name in sorted(data.files))

    @property
    def batch_sizes(self) -> tuple:
        return tuple(sorted(self._programs))

    @property
    def batch_size(self) -> int:
        """Largest exported batch (the single-graph batch for non-bundles)."""
        return max(self._programs)

    @torch.inference_mode()
    def __call__(self, images):
        images = torch.as_tensor(np.require(images, requirements="W")
                                 if isinstance(images, np.ndarray)
                                 else images).to(self.device)
        if not images.is_floating_point():
            # Any integer dtype is raw pixels (int64 is numpy's default
            # for Python lists): the [-1, 1] normalization of every other
            # inference path, on the device.
            images = images.float() / 127.5 - 1.0
        images = images.float()
        request = images.shape[0]
        fits = [b for b in sorted(self._programs) if b >= request]
        if not fits:
            raise ValueError(
                f"request batch {request} exceeds the largest exported "
                f"batch {max(self._programs)}; re-export with a larger "
                "batch size")
        batch = fits[0]
        if batch != request:
            images = torch.cat([images, images.new_zeros(
                (batch - request,) + tuple(images.shape[1:]))])
        out = self._programs[batch](self._params, images)
        if isinstance(out, (tuple, list)):
            # A baked postprocess returns its tuple; slice the padding
            # off every leaf.
            return tuple(leaf[:request] for leaf in out)
        return out[:request]


def load_exported(directory: str, device=None) -> ExportedDetector:
    return ExportedDetector(directory, device)
