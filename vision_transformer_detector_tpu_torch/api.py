"""Reference-compatible API surface, in PyTorch.

Counterpart of vision_transformer_detector_tpu/api.py: users of
westlake-moonlight/vision_transformer_detector get the names they know,
backed by the port:

  * ``create_vision_transformer_detector`` (vtd.py:498-583) -> a
    ``Detector`` bundling config + a ViTDetector with keras-Model-like
    ``predict`` / ``evaluate`` / ``save`` / ``load``, on an explicit
    ``device`` (default ``"cuda"``, which fails without a card);
  * ``transform_predictions`` (vtd.py:586-647);
  * ``my_custom_loss`` (vtd.py:1122-1265);
  * ``MeanAveragePrecision`` (vtd.py:1268-2060, the NumPy oracle);
  * ``iou_calculator`` / ``diagonal_calculator`` / ``ciou_calculator``
    (vtd.py:761-1015);
  * ``learning_rate_step_decay`` (vtd.py:696-728);
  * ``check_weights`` (vtd.py:731-758);
  * ``coco_data_vision_transformer`` (vtu.py:556-615);
  * ``visualize_predictions`` (vtd.py:2363-2456, headless).

``save`` / ``load`` go through the JAX package's ``params.npz`` format
(utils/checkpoint.py), so weights cross between the two APIs.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from .config import DetectorConfig, LossConfig
from .data.annotations import AnnotationsDict
from .data.pipeline import CocoDetectionDataset, list_image_paths
from .metrics.mean_average_precision import MeanAveragePrecision  # noqa: F401
from .models.vit_detector import count_params, init_params
from .ops.decode import transform_predictions as _transform
from .ops.geometry import ciou as ciou_calculator  # noqa: F401
from .ops.geometry import enclosing_diagonal as diagonal_calculator  # noqa: F401,E501
from .ops.geometry import iou as iou_calculator  # noqa: F401
from .ops.loss import detection_loss
from .train.trainer import evaluate_map, make_eval_step, make_predict_step
from .utils.checkpoint import load_params_npz, save_params_npz
from .utils.debugging import check_params
from .utils.device import resolve_device
from .utils.visualize import visualize_predictions  # noqa: F401


class Detector:
    """Config + a ViTDetector on ``device`` with the reference model's
    usage surface. Images may be uint8 pixels or [-1, 1] floats."""

    def __init__(self, config: DetectorConfig, params=None, seed: int = 0,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = init_params(config, torch.Generator().manual_seed(seed))
        self.params = params.to(self.device)
        self._predict = make_predict_step(config)
        self._eval = make_eval_step(config)

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images)).to(self.device)

    # keras-Model-ish surface -------------------------------------------------
    def __call__(self, images, training: bool = False) -> torch.Tensor:
        """Raw logits, like model(x, training=False) (vtd.py:531-535)."""
        del training  # inference path; training runs through train.Trainer
        return self._predict(self.params, self._images(images))

    def predict(self, images) -> np.ndarray:
        """Raw (B, max_objects, 6) logits like keras predict."""
        return self(images).float().cpu().numpy()

    def predict_decoded(self, images) -> np.ndarray:
        """Decoded detections (objectness, class, cx, cy, h, w in pixels)."""
        return self._eval(self.params,
                          self._images(images)).float().cpu().numpy()

    def evaluate(self, dataset: Iterable) -> float:
        """mAP over a dataset (SaveModelHighestAP's evaluate semantics)."""
        return evaluate_map(self.params, dataset, self.config, self._eval)

    def count_params(self) -> int:
        return count_params(self.params)

    def check_weights(self):
        """The reference's post-train weight alarm (vtd.py:731-758)."""
        return check_params(self.params)

    def save(self, path: str) -> None:
        save_params_npz(path, self.params)

    @classmethod
    def load(cls, path: str, config: DetectorConfig,
             device="cuda") -> "Detector":
        return cls(config, params=load_params_npz(path, config),
                   device=device)


def create_vision_transformer_detector(
        input_shape=None, patch_size: int = 17, embedding_dim: int = 28,
        encoder_num_heads: int = 8, encoder_key_dim: int = 40,
        dropout: Optional[float] = None, encoder_mlp_quantities: int = 8,
        encoder_repeat_times: int = 8, mlp_head_last_units: int = 136,
        mlp_head_dense_layers_quantity: int = 7,
        mlp_head_dense_mish_block_repeats: int = 1, use_mish: bool = True,
        max_weight: float = 10.0, clip_weight: bool = True,
        seed: int = 0, device="cuda", **tpu_options) -> Detector:
    """The reference factory signature (vtd.py:498-506) -> Detector.

    ``tpu_options`` forwards DetectorConfig extras (compute_dtype,
    use_flash_attention, ...); ``device`` places the model.
    """
    if input_shape is None:
        image_size = (608, 608)
    else:
        image_size = (input_shape[0], input_shape[1])
    config = DetectorConfig(
        image_size=image_size, patch_size=patch_size,
        embedding_dim=embedding_dim, num_heads=encoder_num_heads,
        key_dim=encoder_key_dim, dropout=dropout,
        encoder_mlp_layers=encoder_mlp_quantities,
        encoder_blocks=encoder_repeat_times,
        head_last_units=mlp_head_last_units,
        head_layers=mlp_head_dense_layers_quantity,
        head_block_repeats=mlp_head_dense_mish_block_repeats,
        use_mish=use_mish, max_weight=max_weight, clip_weight=clip_weight,
        **tpu_options)
    return Detector(config, seed=seed, device=device)


def transform_predictions(inputs, config: DetectorConfig = DetectorConfig()):
    """Reference signature (vtd.py:586-647); config defaults to 608px."""
    return _transform(torch.as_tensor(np.asarray(inputs)), config)


def my_custom_loss(y_true, y_pred, focal_binary_loss: bool = True,
                   coefficient: float = 4, exponent: float = 2,
                   weight_classification: float = 0.0074,
                   weight_ciou: float = 10,
                   use_transform_predictions: bool = True,
                   config: DetectorConfig = DetectorConfig()):
    """Reference loss signature with its defaults (vtd.py:1122-1125)."""
    loss_config = LossConfig(
        focal_binary_loss=focal_binary_loss, coefficient=coefficient,
        exponent=exponent, weight_classification=weight_classification,
        weight_ciou=weight_ciou)
    return detection_loss(torch.as_tensor(np.asarray(y_true)),
                          torch.as_tensor(np.asarray(y_pred)), config,
                          loss_config, use_transform_predictions)


def learning_rate_step_decay(epoch: int, lr: float,
                             epochs_first_lr_decay: int,
                             epochs_second_lr_decay: int,
                             epochs_third_lr_decay: int,
                             rate_lr_decay: float,
                             allowed_decay_times: int = 3) -> float:
    """Pure-function twin of the reference's scheduler (vtd.py:696-728);
    the stateful _allowed_decay_times global becomes an argument.

    Keras ``LearningRateScheduler`` convention: called once per epoch with
    the CURRENT lr fed back, so the decay fires only AT the exact boundary
    epoch (vtd.py:714-718 uses ``==``). The budget is consumed once per
    MATCHING EPOCH, so a zero-length decay interval collapses to one decay
    at that epoch — dedup first, then truncate.
    """
    boundaries = [epochs_first_lr_decay]
    boundaries.append(boundaries[-1] + epochs_second_lr_decay)
    boundaries.append(boundaries[-1] + epochs_third_lr_decay)
    boundaries = sorted(set(boundaries))[: max(0, allowed_decay_times)]
    if epoch in boundaries:
        lr = lr * rate_lr_decay
    return lr


def check_weights(detector_or_params):
    """Reference check_weights (vtd.py:731-758) over a Detector or model."""
    params = getattr(detector_or_params, "params", detector_or_params)
    report = check_params(params)
    return report["max_weight"]


def coco_data_vision_transformer(
        image_dir: str,
        annotations: AnnotationsDict,
        images_range=(0, 1000),
        shuffle_images: bool = False,
        batch_size: int = 8,
        config: DetectorConfig = DetectorConfig(),
        seed: Optional[int] = None) -> CocoDetectionDataset:
    """Reference dataset factory (vtu.py:556-615), with the import-time
    globals replaced by explicit ``image_dir`` + ``annotations`` arguments
    (load them with data.annotations.load_annotations_dict)."""
    paths = list_image_paths(image_dir, images_range=images_range,
                             shuffle=shuffle_images, seed=seed)
    return CocoDetectionDataset(paths, annotations, config,
                                batch_size=batch_size)
