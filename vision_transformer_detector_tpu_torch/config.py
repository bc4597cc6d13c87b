"""Typed configuration for the TPU-native ViT detector framework.

The PyTorch port's own copy of vision_transformer_detector_tpu/config.py,
kept as it is so both packages read one set of presets (the drift test,
tests/test_torch_self_contained.py, holds them equal field for field).
The timings quoted in its comments were measured for the JAX package on a
TPU v5e; none of them is a measurement of the port.

Replaces the reference's scattered configuration surface — the ``Constants``
Enum (vision_transformer_detector.py:19-43), the keyword defaults on
``create_vision_transformer_detector`` (vision_transformer_detector.py:498-506)
and the notebook variables (ipynb cell 7) — with one frozen dataclass that can
be hashed (so it can be a static argument under ``jax.jit``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Numeric guard used by the reference everywhere a division may hit zero
# (vision_transformer_detector.py:24).
EPSILON: float = 1e-8

# Value used to fill empty label/prediction slots. The reference writes -8
# into class id and box coordinates of empty slots
# (vision_transformer_utilities.py:497-505) and relies on it in the loss and
# metric (e.g. vision_transformer_detector.py:1351, 1466-1475).
EMPTY_SLOT_VALUE: float = -8.0

# Metric thresholds (vision_transformer_detector.py:40-43).
OBJECTNESS_THRESHOLD: float = 0.5
CLASSIFICATION_CONFIDENCE_THRESHOLD: float = 0.5


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """All hyperparameters of the ViT detector.

    Defaults reproduce the reference's measured configuration
    (vision_transformer_detector.py:498-506 and ipynb cell 7).
    """

    # --- task shape -------------------------------------------------------
    image_size: Tuple[int, int] = (608, 608)  # (height, width)
    num_classes: int = 80
    max_objects: int = 17  # MAX_DETECT_OBJECTS_QUANTITY (vtd.py:28)

    # --- backbone ---------------------------------------------------------
    patch_size: int = 17
    embedding_dim: int = 28
    num_heads: int = 8
    key_dim: int = 40            # per-head dim of the attention projections
    dropout: Optional[float] = None
    encoder_mlp_layers: int = 8  # layers in each block's descending pyramid
    encoder_blocks: int = 8

    # --- detection head ----------------------------------------------------
    head_last_units: int = 136
    head_layers: int = 7
    head_block_repeats: int = 1
    # Multi-scale head (BASELINE configs[4]): per-slot features gathered
    # from the token grid average-pooled at these strides and concatenated.
    # (1,) is the reference's single-scale head.
    head_scales: Tuple[int, ...] = (1,)

    # --- activations / regularisation --------------------------------------
    use_mish: bool = True
    max_weight: float = 10.0      # ClipWeight bound (vtd.py:209-236)
    clip_weight: bool = True

    # --- TPU execution policy ----------------------------------------------
    # Matmul/activation dtype. Box geometry, loss reductions and metric math
    # always stay in float32 (the reference documents fp16 overflow hazards at
    # vtd.py:53-55 and 862-864; bf16 shares fp32's exponent so activations are
    # safe, but accumulation precision still matters).
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    param_dtype: str = "float32"
    use_flash_attention: bool = False  # Pallas flash-attention kernel
    # Heads-major attention layout: projections emit (B, H, N, K) so the
    # flash/window folds and score einsums are free reshapes. Measured
    # faster for MXU-aligned head dims (B/16, L/16, highres: train +5-11%,
    # 1024px -11%) but SLOWER for the reference arch's narrow key_dim 40
    # TRAINING backward (98 vs 81 ms/step) while still winning its
    # batch-128 inference (543 vs 532 img/s). None = auto: heads-major
    # iff key_dim is a multiple of 64; inference-only callers with narrow
    # heads can force True (bench.py does).
    attention_heads_major: Optional[bool] = None
    # Attention path override for the TRAIN step only (None = no
    # override). The flash/einsum crossover is direction-dependent at the
    # reference arch: the flash custom-VJP's chunked backward avoids the
    # einsum backward's ~41 ms/step of N x N softmax-gradient VPU
    # reductions (88 -> 56 ms/step at 608px b8, measured round 3b) while
    # einsum keeps winning large-batch INFERENCE (543 vs 415 img/s at
    # b128). make_train_step applies this to the config it traces;
    # inference/eval paths are untouched.
    train_use_flash_attention: Optional[bool] = None
    use_fused_ffn: bool = False        # Pallas fused dense+mish kernel
    # Pallas single-round-trip LayerNorm at INFERENCE when the embedding
    # dim is 128-lane aligned (kernels/fused_ln.py); training always
    # uses XLA's differentiable LN. Off by default by measurement
    # (round 5, v5e, b8 same-session A/B): B/16 5.86->5.93 ms, L/16
    # 65.95->64.69 ms — XLA already fuses the LN normalize pass into
    # its consumers, so the kernel's VMEM residency only breaks even;
    # kept for re-testing on future XLA versions / larger shapes.
    use_fused_layer_norm: bool = False
    remat_encoder: bool = False        # jax.checkpoint each encoder block
    # Rematerialisation policy when remat_encoder is on:
    #   None        -> save nothing, recompute the whole block (max memory
    #                  saving, ~1/3 extra forward FLOPs in the backward),
    #   "dots"      -> jax.checkpoint_policies.dots_with_no_batch_dims_
    #                  saveable: matmul outputs are saved, only cheap
    #                  elementwise work is recomputed,
    #   "alternate" -> checkpoint every OTHER block: half the recompute at
    #                  roughly half of no-remat's activation memory
    #                  (measured default for highres_1024).
    remat_policy: Optional[str] = None
    # Windowed attention for the high-res variant (BASELINE configs[4]).
    attention_window: Optional[int] = None  # window size in patch rows/cols
    # Sequence parallelism: constrain encoder activations to shard the
    # token axis over the 'model' mesh axis (pairs well with windowed
    # attention, whose windows are independent). Requires tracing inside a
    # Mesh context (the Trainer handles this).
    sequence_sharding: bool = False
    # Exact global attention with the token axis sharded over the model
    # mesh axis (kernels/ring_attention.py); requires passing a mesh to
    # forward() (the Trainer does). Mutually exclusive with
    # attention_window.
    ring_attention: bool = False

    # --- metric state sizes (vtd.py:30-37) ----------------------------------
    latest_related_images: int = 3
    bboxes_per_image: int = 14

    # ----------------------------------------------------------------------
    @property
    def grid_size(self) -> Tuple[int, int]:
        """Patch grid (rows, cols) with SAME padding: ceil(size / patch)."""
        return (
            math.ceil(self.image_size[0] / self.patch_size),
            math.ceil(self.image_size[1] / self.patch_size),
        )

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3

    @property
    def encoder_mlp_units(self) -> Tuple[int, ...]:
        """Descending per-block MLP widths D*2^(m-1) .. D (vtd.py:384-386)."""
        d = self.embedding_dim
        return tuple(d * 2 ** k
                     for k in range(self.encoder_mlp_layers - 1, -1, -1))

    @property
    def head_units(self) -> Tuple[int, ...]:
        """Descending head widths last*2^(L-1) .. last (vtd.py:465-468)."""
        u = self.head_last_units
        return tuple(u * 2 ** k for k in range(self.head_layers - 1, -1, -1))

    def replace(self, **kw) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Hyperparameters of the composite loss (vtd.py:1122-1265).

    Defaults are the notebook's measured values (ipynb cell 7):
    coefficient 9, exponent 2, weight_classification 0.0074, weight_ciou 4.5.
    The function-signature defaults of the reference (4 / 2 / 0.0074 / 10,
    vtd.py:1122-1124) can be selected explicitly.
    """

    focal_binary_loss: bool = True
    focal_gamma: float = 2.0
    coefficient: float = 9.0
    exponent: float = 2.0
    weight_classification: float = 0.0074
    weight_ciou: float = 4.5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings (ipynb cell 7)."""

    learning_rate: float = 8e-5
    clip_gradient_value: float = 10.0  # Adam(clipvalue=10)
    batch_size: int = 8
    # Gradient accumulation: average grads over this many micro-batches
    # before each optimizer update (optax.MultiSteps) — large effective
    # batches without the activation memory (beyond-reference feature).
    accumulate_steps: int = 1
    epochs: int = 12_502
    # Step LR decay (vtd.py:696-728): cumulative epoch boundaries, x0.1 each.
    epochs_first_lr_decay: int = 1_000
    epochs_second_lr_decay: int = 9_000
    epochs_third_lr_decay: int = 1_000
    rate_lr_decay: float = 0.1
    allowed_decay_times: int = 3
    # Eval cadence mirroring SaveModelHighestAP (vtd.py:2063-2184).
    epochs_warm_up: int = 500
    skip_epochs: int = 500
    seed: int = 0
    # Adam moment dtypes (None = fp32). "bfloat16" halves optimizer-state
    # HBM traffic; master params stay fp32 so only the update DIRECTION
    # carries bf16 rounding. nu (second moment) in bf16 uses
    # stochastic-rounded writes (train/optimizer.py
    # scale_by_adam_compact: its 0.1%/step update is below bf16's ulp,
    # so round-to-nearest would freeze it). Measured A/B:
    # tools/bench_opt_dtypes.py.
    adam_mu_dtype: str | None = None
    adam_nu_dtype: str | None = None


# ---------------------------------------------------------------------------
# Preset configurations, one per BASELINE.json config entry.
# ---------------------------------------------------------------------------

def reference_608() -> DetectorConfig:
    """The reference's measured configuration (ipynb cell 7).

    Training routes attention through the flash custom-VJP (its chunked
    backward trains this arch 88 -> 56 ms/step, +57% throughput —
    PERFORMANCE.md round 3b); inference keeps the einsum path, which
    wins at serving batch sizes.
    """
    return DetectorConfig(train_use_flash_attention=True)


def reference_224() -> DetectorConfig:
    """BASELINE configs[0]: the reference detector at 224px."""
    return DetectorConfig(image_size=(224, 224))


def vit_s16_224() -> DetectorConfig:
    """BASELINE configs[1]: ViT-S/16 detector, 224px, MXU-aligned dims.

    Attention stays on the einsum path: at 196 tokens the blocked flash
    kernel pads to its minimum tile and loses inference by 1.6x (14,149
    vs 8,657 img/s at b64) while training is a wash (4.6 ms/step both
    ways) — measured round 3b, tools/bench_small_vits.py. ViT-B/16 at
    576 tokens is past the crossover and keeps flash.
    """
    return DetectorConfig(
        image_size=(224, 224), patch_size=16, embedding_dim=384,
        num_heads=6, key_dim=64, encoder_blocks=12, encoder_mlp_layers=2,
        head_last_units=256, head_layers=3,
        compute_dtype="bfloat16", use_flash_attention=False,
    )


def vit_b16_384() -> DetectorConfig:
    """BASELINE configs[2]: ViT-B/16 detector, 384px."""
    return DetectorConfig(
        image_size=(384, 384), patch_size=16, embedding_dim=768,
        num_heads=12, key_dim=64, encoder_blocks=12, encoder_mlp_layers=2,
        head_last_units=512, head_layers=3,
        compute_dtype="bfloat16", use_flash_attention=True,
    )


def vit_l16_640() -> DetectorConfig:
    """BASELINE configs[3]: ViT-L/16 detector, 640px, bf16 flash attention.

    remat is OFF by profiling (tools/profile_l16.py, PERFORMANCE.md
    rounds 2-2b): at batch 8 the un-remat'd train step fits in ~10 GB
    peak and runs 432 -> 258 ms; measured at batch 16 it still fits and
    scales linearly (502.7 ms, 31.8 img/s) while both remat variants are
    slower there (full 650.9 ms; 'alternate' thrashes at 2168 ms — its
    half-saved activations oversubscribe HBM at this shape). Turn remat
    back on only when a larger per-chip batch actually OOMs.
    """
    return DetectorConfig(
        image_size=(640, 640), patch_size=16, embedding_dim=1024,
        num_heads=16, key_dim=64, encoder_blocks=24, encoder_mlp_layers=2,
        head_last_units=512, head_layers=3,
        compute_dtype="bfloat16", use_flash_attention=True,
        remat_encoder=False,
    )


def highres_1024() -> DetectorConfig:
    """BASELINE configs[4]: 1024px windowed-attention variant.

    remat_policy="alternate" (checkpoint every other block) by
    measurement: remat-off and 'dots' both OOM at batch 8 while full
    remat wastes recompute — alternate trains at 610 vs 706 ms/step
    (PERFORMANCE.md round 2b).

    Training WITH dropout: use remat_policy=None (full remat). The
    non-remat'd half of 'alternate' additionally keeps the MLP dropout
    masks live as residuals, which OOMs at batch 8; full remat trains
    at 762 ms/step with dropout=0.1 (in-kernel flash dropout, measured
    2026-08-17 on v5e)."""
    return DetectorConfig(
        image_size=(1024, 1024), patch_size=16, embedding_dim=1024,
        num_heads=16, key_dim=64, encoder_blocks=24, encoder_mlp_layers=2,
        head_last_units=512, head_layers=3,
        compute_dtype="bfloat16", use_flash_attention=True,
        remat_encoder=True, remat_policy="alternate", attention_window=16,
        head_scales=(1, 2, 4),  # multi-scale detection head
    )


def highres_1024_ring() -> DetectorConfig:
    """1024px EXACT-global-attention variant for multi-chip training.

    Instead of windowing, the 4,096-token axis is sharded over the 'model'
    mesh axis and K/V shards rotate around the ICI ring
    (kernels/ring_attention.py): attention memory and FLOPs divide by the
    ring size while remaining mathematically exact global attention.
    Requires a Mesh with model axis >= 2 whose size divides 4,096
    (the Trainer and __graft_entry__.dryrun_multichip wire this up);
    use ``highres_1024`` (windowed) for single-chip work.
    """
    return DetectorConfig(
        image_size=(1024, 1024), patch_size=16, embedding_dim=1024,
        num_heads=16, key_dim=64, encoder_blocks=24, encoder_mlp_layers=2,
        head_last_units=512, head_layers=3,
        compute_dtype="bfloat16",
        remat_encoder=True, ring_attention=True,
        head_scales=(1, 2, 4),
    )


def tiny_96() -> DetectorConfig:
    """Small smoke-test config: full pipeline, minutes-scale on CPU."""
    return DetectorConfig(
        image_size=(96, 96), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=2, encoder_mlp_layers=3,
        head_last_units=16, head_layers=2)


PRESETS = {
    "tiny_96": tiny_96,
    "reference_608": reference_608,
    "reference_224": reference_224,
    "vit_s16_224": vit_s16_224,
    "vit_b16_384": vit_b16_384,
    "vit_l16_640": vit_l16_640,
    "highres_1024": highres_1024,
    "highres_1024_ring": highres_1024_ring,
}


def get_config(name: str) -> DetectorConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(
            f"Unknown preset {name!r}; available: {sorted(PRESETS)}") from None


# ---------------------------------------------------------------------------
# Serialisation: configs travel with checkpoints so a run is reproducible
# from its checkpoint directory alone (the reference re-types every
# hyperparameter in the notebook each session).
# ---------------------------------------------------------------------------

def configs_to_dict(detector: DetectorConfig,
                    loss: Optional[LossConfig] = None,
                    train: Optional["TrainConfig"] = None) -> dict:
    out = {"detector": dataclasses.asdict(detector)}
    if loss is not None:
        out["loss"] = dataclasses.asdict(loss)
    if train is not None:
        out["train"] = dataclasses.asdict(train)
    return out


def _tuplify(cls, data: dict) -> dict:
    """JSON round-trips tuples as lists; restore tuple-typed fields."""
    fixed = dict(data)
    for field in dataclasses.fields(cls):
        value = fixed.get(field.name)
        if isinstance(value, list):
            fixed[field.name] = tuple(value)
    return fixed


def configs_from_dict(data: dict):
    """Inverse of configs_to_dict -> (DetectorConfig, LossConfig|None,
    TrainConfig|None)."""
    detector = DetectorConfig(**_tuplify(DetectorConfig, data["detector"]))
    loss = (LossConfig(**_tuplify(LossConfig, data["loss"]))
            if "loss" in data else None)
    train = (TrainConfig(**_tuplify(TrainConfig, data["train"]))
             if "train" in data else None)
    return detector, loss, train


def save_configs(path: str, detector: DetectorConfig,
                 loss: Optional[LossConfig] = None,
                 train: Optional["TrainConfig"] = None) -> None:
    import json

    with open(path, "w") as f:
        json.dump(configs_to_dict(detector, loss, train), f, indent=1)


def load_configs(path: str):
    import json

    with open(path) as f:
        return configs_from_dict(json.load(f))
