"""PyTorch / CUDA port of vision_transformer_detector_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find:
  * models/    — the ViT detector forward (nn.Modules in the JAX layouts)
  * ops/       — decode, box geometry, the detection loss, NMS + top-k
  * kernels/   — hand-written Hopper kernels (csrc/) and their plain
                 PyTorch versions
  * metrics/   — the reference mAP metric on the device
  * train/     — optimizer stack, train/eval steps and the Trainer
  * serving.py — the detection service behind the shared HTTP server
  * cli.py     — ``serve`` and ``train`` (``vtd-torch``)
  * utils/     — the .npz weight bridge and train-state checkpoints

Configuration, presets and the host data pipeline are reused from the
JAX package's framework-neutral modules, which import no JAX; the names
a caller needs are re-exported here, so that code built on the port
imports only this package.
"""

from vision_transformer_detector_tpu.config import (  # noqa: F401
    PRESETS,
    DetectorConfig,
    LossConfig,
    TrainConfig,
    get_config,
)
from vision_transformer_detector_tpu.data.pipeline import (  # noqa: F401
    synthetic_batches,
)
