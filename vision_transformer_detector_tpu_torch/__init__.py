"""PyTorch / CUDA port of vision_transformer_detector_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find:
  * config.py  — the configs and presets (a copy of the JAX package's)
  * data/      — COCO categories, annotations and the host input
                 pipeline (copies of the JAX package's, PIL decode)
  * models/    — the ViT detector forward (nn.Modules in the JAX layouts)
  * ops/       — decode, box geometry, the detection loss, NMS + top-k
  * kernels/   — hand-written Hopper kernels (csrc/) and their plain
                 PyTorch versions, int8 weight quantization
  * metrics/   — the reference mAP metric on the device and its NumPy
                 oracle
  * train/     — optimizer stack, train/eval steps and the Trainer
  * serving.py — the detection service, micro-batcher and HTTP server
  * cli.py     — ``serve`` and ``train`` (``vtd-torch``)
  * utils/     — the .npz weight bridge and train-state checkpoints

It imports nothing of the JAX package: the framework-neutral host modules
it needs are its own copies, held equal to the originals by
tests/test_torch_self_contained.py.
"""

from .config import (  # noqa: F401
    PRESETS,
    DetectorConfig,
    LossConfig,
    TrainConfig,
    get_config,
)
from .data.pipeline import synthetic_batches  # noqa: F401
