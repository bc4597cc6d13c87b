"""Box geometry in fp32: elementwise IoU, enclosing diagonal, CIoU.

Counterpart of vision_transformer_detector_tpu/ops/geometry.py, over
aligned ``(..., 4)`` boxes in (center_x, center_y, height, width) order;
each function reduces the last axis away. The gradient paths follow the
JAX package's: ``_safe_sqrt`` keeps a zero gradient at 0, the IoU edge
sort is stable (as ``jnp.sort``), and the enclosing extrema use
``amax``/``amin``, which split the gradient between ties as JAX's
``max``/``min`` reductions do.
"""

from __future__ import annotations

import math

import torch

from ..config import EPSILON


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero gradient at 0 instead of inf.

    sqrt'(0) = inf, and inf times a 0 mask downstream is NaN. The
    double ``where`` keeps forward values identical and makes the backward
    exactly zero at x == 0 (``torch.where`` routes gradients like
    ``jnp.where``: the unselected branch still gets a zero-times-inf
    product if it is evaluated at the bad point, so the inner ``where``
    moves that point away)."""
    positive = x > 0
    safe = torch.where(positive, x, 1.0)
    return torch.where(positive, torch.sqrt(safe), 0.0)


def _edges(bbox: torch.Tensor):
    """(left, right, top, bottom) edges of a cxcyhw box."""
    cx, cy, h, w = bbox[..., -4], bbox[..., -3], bbox[..., -2], bbox[..., -1]
    return cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2


def iou(label_bbox: torch.Tensor,
        prediction_bbox: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned ``(..., 4)`` boxes; the last axis is
    reduced away. Edges of non-intersecting pairs are zeroed before the
    sort, so their "intersection" has zero area."""
    label_bbox = label_bbox.float()
    prediction_bbox = prediction_bbox.float()

    l_left, l_right, l_top, l_bottom = _edges(label_bbox)
    p_left, p_right, p_top, p_bottom = _edges(prediction_bbox)

    intersects = ((l_left < p_right) & (l_right > p_left)
                  & (l_top < p_bottom) & (l_bottom > p_top))

    horizontal = torch.stack([l_top, l_bottom, p_top, p_bottom], dim=-1)
    vertical = torch.stack([l_left, l_right, p_left, p_right], dim=-1)
    mask = intersects[..., None]
    # Stable, as jnp.sort: tied edges keep their order, so the gradient
    # reaches the same box as in the JAX package.
    horizontal = torch.where(mask, horizontal, 0.0).sort(
        dim=-1, stable=True).values
    vertical = torch.where(mask, vertical, 0.0).sort(
        dim=-1, stable=True).values

    intersection_h = horizontal[..., -2] - horizontal[..., -3]
    intersection_w = vertical[..., -2] - vertical[..., -3]
    intersection_area = intersection_h * intersection_w

    prediction_area = prediction_bbox[..., -1] * prediction_bbox[..., -2]
    label_area = label_bbox[..., -1] * label_bbox[..., -2]
    union_area = prediction_area + label_area - intersection_area
    return intersection_area / (union_area + EPSILON)


def enclosing_diagonal(label_bbox: torch.Tensor,
                       prediction_bbox: torch.Tensor) -> torch.Tensor:
    """Diagonal length of the smallest box enclosing both boxes."""
    label_bbox = label_bbox.float()
    prediction_bbox = prediction_bbox.float()

    l_left, l_right, l_top, l_bottom = _edges(label_bbox)
    p_left, p_right, p_top, p_bottom = _edges(prediction_bbox)

    horizontal = torch.stack([l_top, l_bottom, p_top, p_bottom], dim=-1)
    vertical = torch.stack([l_left, l_right, p_left, p_right], dim=-1)
    enclosing_h = horizontal.amax(dim=-1) - horizontal.amin(dim=-1)
    enclosing_w = vertical.amax(dim=-1) - vertical.amin(dim=-1)
    return _safe_sqrt(enclosing_h * enclosing_h + enclosing_w * enclosing_w)


def ciou(label_bbox: torch.Tensor, prediction_bbox: torch.Tensor,
         get_diou: bool = False) -> torch.Tensor:
    """CIoU loss (arXiv 1911.08287): ``1 - IoU + rho^2/c^2 + alpha * v``;
    with ``get_diou`` the DIoU ``IoU - rho^2/c^2`` instead."""
    label_bbox = label_bbox.float()
    prediction_bbox = prediction_bbox.float()

    iou_value = iou(label_bbox, prediction_bbox)

    # rho: distance between the centres.
    deltas = label_bbox[..., :2] - prediction_bbox[..., :2]
    rho = _safe_sqrt((deltas * deltas).sum(dim=-1))
    c_diagonal = enclosing_diagonal(label_bbox, prediction_bbox)
    r_diou = torch.square(rho / (c_diagonal + EPSILON))
    if get_diou:
        return iou_value - r_diou

    # Aspect-ratio consistency v; the reference takes atan(width / height)
    # for both boxes.
    atan_label = torch.atan(label_bbox[..., -1]
                            / (label_bbox[..., -2] + EPSILON))
    atan_pred = torch.atan(prediction_bbox[..., -1]
                           / (prediction_bbox[..., -2] + EPSILON))
    v_aspect = (torch.square(atan_label - atan_pred) * 4.0
                / torch.tensor(math.pi ** 2, dtype=torch.float32))
    alpha = v_aspect / ((1.0 - iou_value) + v_aspect + EPSILON)
    return 1.0 - iou_value + r_diou + alpha * v_aspect
