"""TF/Keras -> .npz weight converter for the reference detector, with no
JAX: the PyTorch port's counterpart of tools/convert_tf_checkpoint.py.

The reference saves full Keras models to ``checkpoints/*.keras``
(SaveModelHighestAP, vision_transformer_detector.py:2142-2180). A ``.keras``
file is a zip archive whose ``model.weights.h5`` stores every layer's
variables; no TensorFlow is needed to read it, only h5py (host code: the
GPU machine need not have it).

The target is the port's own model: its parameter names (``state_dict``,
dots joined by slashes) and shapes come from a ``ViTDetector`` skeleton
on the meta device, so nothing is allocated and nothing of JAX is needed.
The output is the ``.npz`` that the JAX tool writes (``save_params_npz``'s
format: one array per parameter under its slash-joined name), key for key
and bit for bit, which ``utils.checkpoint.load_params_npz`` of either
package loads.

Layer-name mapping (reference names at vision_transformer_detector.py):
  linear_projection (vtd.py:297-301)      -> linear_projection/*
  position_embedding (vtd.py:148-151)     -> position_embedding
  layer_normalization* / multi_head_attention* (vtd.py:353-369, in creation
    order, two LNs + one MHA per block)   -> encoder/<i>/{ln1,ln2,mha}/*
  MLP_{i}_{j} (vtd.py:388-393)            -> encoder/<i-1>/mlp/<j-1>/*
  dense / dense_* in the head (vtd.py:454-486, creation order)
                                          -> head_token_dense/*,
                                             head_mlp/<k>/*
  MLP_Head_no_Sigmoid (vtd.py:489-493)    -> head_output/*

Keras Dense kernels are (in, out) like the port's; keras MHA kernels are
(D, heads, key_dim) for q/k/v and (heads, key_dim, D) for the output
projection, also the port's layout (models/vit_detector.py), so the
conversion is pure renaming, no transposes.

Usage:
  python tools/convert_tf_checkpoint_torch.py model.keras out.npz \
      [--image-size 608] [--patch-size 17] [--embedding-dim 28]
  then load with vision_transformer_detector_tpu_torch.utils.checkpoint.
  load_params_npz(out.npz, config).
"""

from __future__ import annotations

import argparse
import io
import os
import re
import sys
import zipfile
from typing import Dict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def read_keras_weights(path: str) -> Dict[str, np.ndarray]:
    """Extract {layer_path: array} from a .keras zip (or a bare .h5)."""
    import h5py

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = [n for n in zf.namelist() if n.endswith(".h5")]
            if not names:
                raise ValueError(f"no .h5 member in {path}")
            handle = h5py.File(io.BytesIO(zf.read(names[0])), "r")
    else:
        handle = h5py.File(path, "r")

    weights: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            weights[name] = np.asarray(obj)

    with handle as f:
        f.visititems(visit)
    return weights


def _natural_key(name: str):
    """Sort 'dense_10' after 'dense_9' (keras numbers anonymous layers;
    lexicographic order breaks past _9)."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def _match(weights: Dict[str, np.ndarray], *needles: str):
    """All (name, array) whose path contains every needle, naturally
    sorted by name."""
    return sorted(((k, v) for k, v in weights.items()
                   if all(n in k for n in needles)),
                  key=lambda kv: _natural_key(kv[0]))


def target_shapes(config) -> Dict[str, tuple]:
    """{slash-joined name: shape} of the port's model for ``config``, from
    a skeleton on the meta device."""
    import torch

    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        ViTDetector)

    with torch.device("meta"):
        skeleton = ViTDetector(config)
    return {name.replace(".", "/"): tuple(t.shape)
            for name, t in skeleton.state_dict().items()}


def convert(weights: Dict[str, np.ndarray], config) -> Dict[str, np.ndarray]:
    """Rename reference weights into the port's flat parameter names.

    Supports the legacy Keras-2 HDF5 naming ('<layer>/kernel:0', the
    format TF 2.9, the reference's pinned version (README.md:2-4),
    writes). Keras 3's .keras archives use anonymous 'layers/<i>/vars/<j>'
    paths instead; they are refused early with an actionable error rather
    than failing needle by needle. Arrays keep the dtype the file stores
    (as the JAX tool keeps them), checked against the target's shapes.
    """
    if tuple(config.head_scales) != (1,):
        # The multi-scale head (one token dense per pooling scale) is an
        # extension of this framework; the reference architecture
        # (vision_transformer_detector.py:417-495) has exactly one token
        # dense, so no TF checkpoint carries multi-scale weights. The value
        # is compared as a tuple, so a list [1] (as a JSON config gives
        # it) is the single-scale head.
        raise ValueError(
            f"config.head_scales={config.head_scales}: the multi-scale "
            "detection head has no TF/Keras counterpart to convert from; "
            "convert with head_scales=(1,) (the reference architecture) "
            "or train the multi-scale head from scratch")

    if weights and not any("kernel" in k for k in weights):
        sample = sorted(weights)[:5]
        raise ValueError(
            "no 'kernel' datasets found — this looks like a Keras 3 "
            "'layers/<i>/vars/<j>' archive, not the Keras 2 (TF 2.9) "
            "naming this converter supports; re-save the checkpoint "
            f"with TF 2.9 model.save_weights. Sample paths: {sample}")

    shapes = target_shapes(config)

    def take(*needles, index=0, kind="kernel"):
        hits = [h for h in _match(weights, *needles) if kind in h[0]]
        if len(hits) <= index:
            raise ValueError(f"no match #{index} for {needles} [{kind}]; "
                             f"have {[h[0] for h in hits]}")
        return hits[index][1]

    params: Dict[str, np.ndarray] = {}
    params["linear_projection/kernel"] = take("linear_projection")
    params["linear_projection/bias"] = take("linear_projection", kind="bias")
    emb = [v for k, v in weights.items() if "position_embedding" in k]
    if not emb:
        raise ValueError("position_embedding not found")
    params["position_embedding"] = emb[0].reshape(shapes["position_embedding"])

    for i in range(config.encoder_blocks):
        block = f"encoder/{i}"
        # Two LayerNorms per block, created ln1 then ln2 (vtd.py:353, 375).
        for which, index in (("ln1", 2 * i), ("ln2", 2 * i + 1)):
            for kind in ("gamma", "beta"):
                params[f"{block}/{which}/{kind}"] = take(
                    "layer_normalization", index=index, kind=kind)
        for proj, tf_name in (("query", "query"), ("key", "key"),
                              ("value", "value"),
                              ("out", "attention_output")):
            for kind in ("kernel", "bias"):
                params[f"{block}/mha/{proj}/{kind}"] = take(
                    "multi_head_attention", tf_name, index=i, kind=kind)
        for j in range(config.encoder_mlp_layers):
            for kind in ("kernel", "bias"):
                params[f"{block}/mlp/{j}/{kind}"] = take(
                    f"MLP_{i + 1}_{j + 1}/", kind=kind)

    # Head: anonymous Dense layers in creation order ('dense', 'dense_1',
    # ...): token dense first (vtd.py:454), then the pyramid, then the
    # named output layer.
    dense_layers = _match(weights, "dense")
    kernels = [v for k, v in dense_layers if "kernel" in k]
    biases = [v for k, v in dense_layers if "bias" in k]
    head_mlp = sum(1 for name in shapes
                   if re.fullmatch(r"head_mlp/\d+/kernel", name))
    if len(kernels) < 1 + head_mlp:
        raise ValueError(f"found {len(kernels)} anonymous dense layers, "
                         f"need {1 + head_mlp}")
    params["head_token_dense/kernel"] = kernels[0]
    params["head_token_dense/bias"] = biases[0]
    for k in range(head_mlp):
        params[f"head_mlp/{k}/kernel"] = kernels[1 + k]
        params[f"head_mlp/{k}/bias"] = biases[1 + k]
    params["head_output/kernel"] = take("MLP_Head_no_Sigmoid")
    params["head_output/bias"] = take("MLP_Head_no_Sigmoid", kind="bias")

    # Every name of the target, each with its shape.
    if set(params) != set(shapes):
        raise ValueError(
            f"converted names differ from the model's: missing "
            f"{sorted(set(shapes) - set(params))}, unexpected "
            f"{sorted(set(params) - set(shapes))}")
    for name, array in params.items():
        if tuple(array.shape) != shapes[name]:
            raise ValueError(f"{name}: {array.shape} != {shapes[name]}")
    return params


def save_npz(path: str, params: Dict[str, np.ndarray]) -> None:
    """``save_params_npz``'s format: one array per name."""
    np.savez(path, **params)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("keras_path")
    parser.add_argument("out_npz")
    parser.add_argument("--image-size", type=int, default=608)
    parser.add_argument("--patch-size", type=int, default=17)
    parser.add_argument("--embedding-dim", type=int, default=28)
    args = parser.parse_args(argv)

    from vision_transformer_detector_tpu_torch.config import DetectorConfig

    config = DetectorConfig(
        image_size=(args.image_size, args.image_size),
        patch_size=args.patch_size, embedding_dim=args.embedding_dim)
    save_npz(args.out_npz, convert(read_keras_weights(args.keras_path),
                                   config))
    print(f"wrote {args.out_npz}")


if __name__ == "__main__":
    main()
