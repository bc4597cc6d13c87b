"""Box geometry: elementwise IoU in fp32.

Counterpart of ``iou`` in vision_transformer_detector_tpu/ops/geometry.py
(the 4-edge sort trick with an EPSILON-guarded division), over aligned
``(..., 4)`` boxes in (center_x, center_y, height, width) order. The
enclosing diagonal and CIoU serve the loss and come with it.
"""

from __future__ import annotations

import torch

from vision_transformer_detector_tpu.config import EPSILON


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
    horizontal = torch.where(mask, horizontal, 0.0).sort(dim=-1).values
    vertical = torch.where(mask, vertical, 0.0).sort(dim=-1).values

    intersection_h = horizontal[..., -2] - horizontal[..., -3]
    intersection_w = vertical[..., -2] - vertical[..., -3]
    intersection_area = intersection_h * intersection_w

    prediction_area = prediction_bbox[..., -1] * prediction_bbox[..., -2]
    label_area = label_bbox[..., -1] * label_bbox[..., -2]
    union_area = prediction_area + label_area - intersection_area
    return intersection_area / (union_area + EPSILON)
