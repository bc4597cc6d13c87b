"""Composite detection loss: focal-BCE objectness + exponential
classification regression + CIoU box loss.

Counterpart of vision_transformer_detector_tpu/ops/loss.py, term for
term: every term is a masked reduction over the full ``(B, max_objects)``
grid, in fp32. Three details each exist for a NaN gradient the JAX
package once had, and are kept exactly:
  * the classification power takes a safe base (1.0) on masked lanes;
  * masked CIoU lanes get a fixed dummy box before the CIoU;
  * with zero positives the class and CIoU terms are exactly 0.

Under data parallelism (``group``) each process holds a shard of the
global batch, and the loss is the GLOBAL batch's, as the JAX package's
GSPMD step computes it: the objectness mean divides by the global slot
count, the class and CIoU sums by the global positive count, and the
zero-positives test is global. The counts are summed over the group (one
all-reduce of two numbers, which carry no gradient), and each process
returns its share of the global loss: the shares sum to it, so summing
the shares' gradients over the group gives the global loss's gradient.
Averaging per-process losses would weight each shard by its own positive
count instead.
"""

from __future__ import annotations

import torch

from ..config import DetectorConfig, LossConfig

from ..parallel import collectives
from .decode import transform_predictions
from .geometry import ciou

# Keras clips probabilities to [eps, 1 - eps] with backend epsilon 1e-7
# before the log.
_KERAS_EPSILON = 1e-7


def binary_crossentropy(y_true: torch.Tensor,
                        y_pred: torch.Tensor) -> torch.Tensor:
    """Per-element BCE on probabilities, clipped as keras clips them."""
    p = y_pred.float().clamp(_KERAS_EPSILON, 1.0 - _KERAS_EPSILON)
    y = y_true.float()
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def binary_focal_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor,
                              gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal BCE, keras BinaryFocalCrossentropy
    (from_logits=False): ``(1 - p_t)^gamma * BCE``."""
    p = y_pred.float().clamp(_KERAS_EPSILON, 1.0 - _KERAS_EPSILON)
    y = y_true.float()
    bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
    p_t = y * p + (1.0 - y) * (1.0 - p)
    return torch.pow(1.0 - p_t, gamma) * bce


def detection_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                   config: DetectorConfig,
                   loss_config: LossConfig = LossConfig(),
                   use_transform_predictions: bool = True,
                   group=None) -> torch.Tensor:
    """Scalar loss of a batch.

    ``y_true`` is ``(B, max_objects, 6)`` labels (objectness, class id or
    -8, cx, cy, h, w or -8); ``y_pred`` the raw logits, or decoded
    predictions with ``use_transform_predictions=False``. With ``group``
    (a data-parallel process group) the batch is this process's shard and
    the result its share of the global batch's loss (module docstring).
    """
    y_true = y_true.float()
    if use_transform_predictions:
        y_pred = transform_predictions(y_pred, config)
    else:
        y_pred = y_pred.float()

    # Objectness over every slot.
    if loss_config.focal_binary_loss:
        loss_objectness = binary_focal_crossentropy(
            y_true[..., 0], y_pred[..., 0], gamma=loss_config.focal_gamma)
    else:
        loss_objectness = binary_crossentropy(y_true[..., 0], y_pred[..., 0])

    # Positive slots: isclose(y_true[..., 0], 1.0) with numpy's default
    # tolerances, as jnp.isclose.
    object_mask = torch.isclose(
        y_true[..., 0], torch.ones((), device=y_true.device),
        rtol=1e-5, atol=1e-8).float()
    positives = object_mask.sum()
    if group is None:
        loss_objectness_mean = loss_objectness.mean()
    else:
        # (positives, slots) of the global batch.
        counts = collectives.all_reduce_(torch.stack([
            positives, torch.full_like(positives, loss_objectness.numel())]),
            group)
        positives = counts[0]
        # This shard's mean weighted by its share of the global slots: the
        # shares sum to the global mean, and on a group of one the weight
        # is exactly 1.
        loss_objectness_mean = loss_objectness.mean() * (
            loss_objectness.numel() / counts[1])
    safe_count = positives.clamp(min=1.0)

    # Classification over positives: masked lanes take the safe base 1.0
    # before the power (finite gradient for every exponent) and are zeroed
    # after; torch.where routes the gradient to the selected branch only.
    classification_error = (y_pred[..., 1] - y_true[..., 1]).abs()
    safe_base = torch.where(object_mask > 0,
                            loss_config.coefficient * classification_error,
                            1.0)
    loss_classification = torch.pow(
        safe_base, loss_config.exponent) * object_mask
    loss_classification_mean = loss_classification.sum() / safe_count

    # CIoU over positives: negative slots get one fixed unit box on both
    # sides BEFORE the CIoU, so masked lanes stay finite forward and back.
    mask4 = object_mask[..., None] > 0
    # (10, 10, 5, 5), made on the device: no host copy in the train step
    # (a CUDA graph cannot capture one).
    dummy = torch.where(torch.arange(4, device=y_true.device) < 2, 10.0,
                        5.0).float()
    label_boxes = torch.where(mask4, y_true[..., -4:], dummy)
    pred_boxes = torch.where(mask4, y_pred[..., -4:], dummy)
    loss_ciou = ciou(label_boxes, pred_boxes)
    loss_ciou_mean = (loss_ciou * object_mask).sum() / safe_count

    # Zero-positives guard.
    has_positives = positives > 0
    loss_classification_mean = torch.where(
        has_positives, loss_classification_mean, 0.0)
    loss_ciou_mean = torch.where(has_positives, loss_ciou_mean, 0.0)

    return (loss_objectness_mean
            + loss_classification_mean * loss_config.weight_classification
            + loss_ciou_mean * loss_config.weight_ciou)
