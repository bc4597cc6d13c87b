"""PyTorch / CUDA port of vision_transformer_detector_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find:
  * models/    — the ViT detector forward (nn.Modules in the JAX layouts)
  * ops/       — decode, IoU, NMS + top-k postprocess
  * kernels/   — hand-written Hopper kernels (csrc/) and their plain
                 PyTorch versions
  * serving.py — the detection service behind the shared HTTP server
  * utils/     — the .npz weight bridge to and from the JAX package

Configuration, presets and the host data pipeline are reused from the
JAX package's framework-neutral modules, which import no JAX.
"""

from vision_transformer_detector_tpu.config import (  # noqa: F401
    PRESETS,
    DetectorConfig,
    get_config,
)
