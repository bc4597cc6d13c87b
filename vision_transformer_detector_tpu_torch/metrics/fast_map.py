"""The reference mAP metric on the device, in PyTorch.

Counterpart of vision_transformer_detector_tpu/metrics/fast_map.py (the
jitted metric the JAX Trainer uses by default). Same state layout and
semantics as the shared NumPy oracle, metrics/mean_average_precision.py,
which the tests hold this module to:

  * ``update`` folds images in one at a time (the ring state depends on
    order); per image all classes are processed at once, with a loop over
    the label slots for the greedy max-IoU matching;
  * ``compute`` walks each class's buffer rows in confidence order for all
    10 IoU thresholds and classes at once, with the reference's "replace
    the last precision on a false positive" rule folded into per-true-
    positive trapezoid coefficients.

Everything stays on the device of the state tensors in fp32; only
``result()`` copies one number to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    CLASSIFICATION_CONFIDENCE_THRESHOLD,
    OBJECTNESS_THRESHOLD,
    DetectorConfig,
)

from ..ops.decode import classification_confidence, transform_predictions
from ..ops.geometry import iou


def _isclose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy/jnp isclose with the default tolerances."""
    return torch.isclose(a, b, rtol=1e-5, atol=1e-8)


class MapState(NamedTuple):
    latest_positive_bboxes: torch.Tensor    # (C, R, B, 2) fp32
    labels_quantity_per_image: torch.Tensor  # (C, R) fp32
    showed_up_classes: torch.Tensor         # (C,) bool


def init_state(config: DetectorConfig, device="cpu") -> MapState:
    c, r = config.num_classes, config.latest_related_images
    b = config.bboxes_per_image
    return MapState(
        torch.zeros((c, r, b, 2), dtype=torch.float32, device=device),
        torch.zeros((c, r), dtype=torch.float32, device=device),
        torch.zeros((c,), dtype=torch.bool, device=device))


def _top_desc(conf: torch.Tensor, nb: int) -> torch.Tensor:
    """Per row, the top-nb values descending, zero-padded (rows may hold
    fewer than nb entries); -1 marks an empty entry."""
    padded = torch.cat([conf, conf.new_full((conf.shape[0], nb), -1.0)], 1)
    top = -torch.sort(-padded, dim=1).values[:, :nb]
    return top.clamp(min=0.0)


def _class_buffers(one_label, pred_positive, pred_cat, pred_conf, pred_boxes,
                   categories, nb: int):
    """One image: each class's (nb, 2) buffer of (confidence, IoU) rows,
    whether the class updates its ring, and its label count."""
    label_cat = one_label[:, 1]
    m = one_label.shape[0]
    c = categories.shape[0]

    cat_bool_label = _isclose(label_cat[None, :], categories[:, None])
    cat_bool_pred = _isclose(
        torch.where(pred_positive, pred_cat, -8.0)[None, :],
        categories[:, None])                                   # (C, Mp)
    any_label = cat_bool_label.any(dim=1)
    any_pred = cat_bool_pred.any(dim=1)
    label_counts = cat_bool_label.sum(dim=1).float()

    # Predictions only: (confidence, 0) rows.
    conf_c = _top_desc(torch.where(cat_bool_pred, pred_conf[None], -1.0), nb)
    buffer_c = torch.stack([conf_c, torch.zeros_like(conf_c)], dim=-1)

    # Labels of each class sorted by area, ascending (stable; other
    # classes' rows last, marked invalid).
    areas = one_label[:, -1] * one_label[:, -2]
    key = torch.where(cat_bool_label, areas[None], torch.inf)
    order = torch.argsort(key, dim=1, stable=True)              # (C, M)
    label_boxes = one_label[:, -4:][order]                      # (C, M, 4)
    label_valid = torch.gather(cat_bool_label, 1, order)

    # Greedy max-IoU matching, one label slot at a time for every class.
    boxes_avail = torch.where(cat_bool_pred[..., None], pred_boxes[None],
                              -8.0)                             # (C, Mp, 4)
    matched_conf = pred_conf.new_zeros((c, nb))
    matched_iou = pred_conf.new_zeros((c, nb))
    n_matched = torch.zeros((c,), dtype=torch.long, device=pred_conf.device)
    rows = torch.arange(c, device=pred_conf.device)
    for i in range(m):
        ious = iou(label_boxes[:, i:i + 1].expand_as(boxes_avail),
                   boxes_avail)                                 # (C, Mp)
        max_iou = ious.amax(dim=1)
        hit = (max_iou > 0.5) & label_valid[:, i] & (n_matched < nb)
        # Every box whose IoU is isclose to the max goes; the first one's
        # confidence is taken (the reference and the oracle do the same).
        tie_mask = _isclose(ious, max_iou[:, None])
        pos = tie_mask.to(torch.int32).argmax(dim=1)
        seat = n_matched.clamp(max=nb - 1)
        matched_conf[rows, seat] = torch.where(
            hit, pred_conf[pos], matched_conf[rows, seat])
        matched_iou[rows, seat] = torch.where(
            hit, max_iou, matched_iou[rows, seat])
        boxes_avail = torch.where((hit[:, None] & tie_mask)[..., None],
                                  -8.0, boxes_avail)
        n_matched = n_matched + hit.long()

    # Unmatched positives: confidence descending, IoU 0, in the seats
    # left after the matches. Buffer = [zero pad, matched, leftovers].
    left_mask = (boxes_avail >= 0).all(dim=-1)
    left_conf = _top_desc(torch.where(left_mask, pred_conf[None], -1.0), nb)
    n_left = torch.minimum(left_mask.sum(dim=1), nb - n_matched)
    pad = nb - n_matched - n_left
    idx = torch.arange(nb, device=pred_conf.device)[None]
    matched_idx = idx - pad[:, None]
    left_idx = matched_idx - n_matched[:, None]
    take_matched = (matched_idx >= 0) & (matched_idx < n_matched[:, None])
    take_left = (left_idx >= 0) & (left_idx < n_left[:, None])
    matched_idx = matched_idx.clamp(0, nb - 1)
    left_idx = left_idx.clamp(0, nb - 1)
    conf_d = torch.where(
        take_matched, torch.gather(matched_conf, 1, matched_idx),
        torch.where(take_left, torch.gather(left_conf, 1, left_idx), 0.0))
    iou_d = torch.where(take_matched, torch.gather(matched_iou, 1,
                                                   matched_idx), 0.0)
    buffer_d = torch.stack([conf_d, iou_d], dim=-1)

    buffer = torch.where(
        (any_pred & any_label)[:, None, None], buffer_d,
        torch.where(any_pred[:, None, None], buffer_c, 0.0))
    return buffer, any_label | any_pred, label_counts


def _update_one_image(state: MapState, one_label, one_pred,
                      config: DetectorConfig) -> MapState:
    device = one_label.device
    label_cat = one_label[:, 1]
    objectness = one_pred[:, 0]
    classification = one_pred[:, 1]
    pred_cat = torch.round(classification)
    pred_conf = classification_confidence(classification)
    pred_positive = ((objectness > OBJECTNESS_THRESHOLD)
                     & (pred_conf > CLASSIFICATION_CONFIDENCE_THRESHOLD))
    pred_boxes = torch.where(pred_positive[:, None], one_pred[:, -4:], -8.0)
    categories = torch.arange(config.num_classes, dtype=torch.float32,
                              device=device)

    buffers, update, counts = _class_buffers(
        one_label, pred_positive, pred_cat, pred_conf, pred_boxes,
        categories, config.bboxes_per_image)

    # Ring shift, for the classes this image touched only.
    bboxes = torch.where(
        update[:, None, None, None],
        torch.cat([buffers[:, None], state.latest_positive_bboxes[:, :-1]],
                  dim=1),
        state.latest_positive_bboxes)
    quantities = torch.where(
        update[:, None],
        torch.cat([counts[:, None], state.labels_quantity_per_image[:, :-1]],
                  dim=1),
        state.labels_quantity_per_image)
    # Shown classes: label classes (truncated, as the oracle's astype)
    # and positive prediction classes.
    shown_label = ((label_cat >= 0)[None]
                   & (torch.floor(label_cat)[None] == categories[:, None])
                   ).any(dim=1)
    shown_pred = (_isclose(pred_cat[None], categories[:, None])
                  & pred_positive[None]).any(dim=1)
    return MapState(bboxes, quantities,
                    state.showed_up_classes | shown_label | shown_pred)


@torch.no_grad()
def update(state: MapState, y_true: torch.Tensor, y_pred: torch.Tensor,
           config: DetectorConfig,
           use_transform_predictions: bool = True) -> MapState:
    """Consume one batch, image by image."""
    device = state.latest_positive_bboxes.device
    y_true = torch.as_tensor(y_true, dtype=torch.float32, device=device)
    y_pred = torch.as_tensor(y_pred, device=device)
    y_pred = (transform_predictions(y_pred, config)
              if use_transform_predictions else y_pred.float())
    for label, pred in zip(y_true, y_pred):
        state = _update_one_image(state, label, pred, config)
    return state


@torch.no_grad()
def compute(state: MapState, config: DetectorConfig) -> torch.Tensor:
    """mAP over 10 IoU thresholds and the classes that showed up."""
    device = state.latest_positive_bboxes.device
    thresholds = torch.from_numpy(
        np.linspace(0.5, 0.95, 10).astype(np.float32)).to(device)[:, None]
    rows = state.latest_positive_bboxes.reshape(config.num_classes, -1, 2)
    labels_quantity = state.labels_quantity_per_image.sum(dim=1)

    # Stable descending sort keeps buffer order among equal confidences
    # (matched before leftover), which oracle 5.2 requires.
    order = torch.argsort(-rows[..., 0], dim=1, stable=True)
    conf = torch.gather(rows[..., 0], 1, order)
    ious = torch.gather(rows[..., 1], 1, order)

    shape = (thresholds.shape[0], config.num_classes)       # (T, C)
    t = torch.zeros(shape, device=device)
    f = torch.zeros(shape, device=device)
    last_rp = torch.ones(shape, device=device)
    edges = torch.zeros(shape, device=device)
    for j in range(conf.shape[1]):
        is_entry = (conf[:, j] > 0)[None]
        is_tp = is_entry & (ious[:, j][None] > thresholds)
        t = t + is_tp.float()
        f = f + (is_entry & ~is_tp).float()
        precision = t / torch.clamp(t + f, min=1.0)
        coeff = torch.where(t == 1.0, 1.0, 2.0)
        edges = edges + torch.where(is_tp, coeff * last_rp, 0.0)
        last_rp = torch.where(is_entry, precision, last_rp)
    edges = edges + torch.where(t > 0, last_rp, 0.0)
    height = 1.0 / torch.clamp(labels_quantity, min=1.0)
    ap = torch.where((labels_quantity > 0)[None] & (t > 0),
                     edges * height[None] / 2.0, 0.0)

    shown = state.showed_up_classes
    n_shown = shown.sum()
    mean_per_iou = torch.where(
        n_shown > 0,
        torch.where(shown[None], ap, 0.0).sum(dim=1)
        / torch.clamp(n_shown, min=1),
        0.0)
    return mean_per_iou.mean()


class DeviceMeanAveragePrecision:
    """API twin of the NumPy oracle ``MeanAveragePrecision`` (and of the
    JAX package's ``JitMeanAveragePrecision``) with its state on
    ``device``."""

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.state = init_state(config, self.device)

    def reset_state(self) -> None:
        self.state = init_state(self.config, self.device)

    def update_state(self, y_true, y_pred,
                     use_transform_predictions: bool = True) -> None:
        self.state = update(self.state, y_true, y_pred, self.config,
                            use_transform_predictions)

    def result(self) -> float:
        return float(compute(self.state, self.config))
