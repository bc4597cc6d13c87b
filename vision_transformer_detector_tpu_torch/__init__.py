"""PyTorch / CUDA port of vision_transformer_detector_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find:
  * config.py  — the configs and presets (a copy of the JAX package's)
  * data/      — COCO categories, annotations and the host input
                 pipeline (copies of the JAX package's, PIL decode)
  * models/    — the ViT detector forward (nn.Modules in the JAX layouts)
  * ops/       — decode, box geometry, the detection loss, NMS + top-k
  * kernels/   — hand-written Hopper kernels (csrc/) as the custom
                 operators ``torch.ops.vtd_torch.*`` (kernels/ops.py),
                 their plain PyTorch versions, int8 weight quantization
  * metrics/   — the reference mAP metric on the device, its NumPy
                 oracle, and the official COCO protocol (coco_eval.py)
  * train/     — optimizer stack, train/eval steps, the Trainer (with
                 its CUDA-graph windowed loop) and the sweep runner
  * export.py  — torch.export artifacts and their model-free loader
  * serving.py — the detection services (live and from an artifact),
                 micro-batcher and HTTP server
  * api.py     — the reference-signature API (``Detector``, ...)
  * cli.py     — ``vtd-torch``: train, evaluate, score-coco, predict,
                 visualize, export, serve, sweep, benchmark, doctor,
                 plot, stats
  * utils/     — the .npz weight bridge, train-state checkpoints (sync
                 and async), numeric sanitizers, profiling and timing,
                 visualization and plotting

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
