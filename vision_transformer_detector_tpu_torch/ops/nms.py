"""Detection postprocessing on the device: scores, NMS and top-k.

Counterpart of vision_transformer_detector_tpu/ops/nms.py, with static
shapes and no host round trip. Orderings reproduce the JAX ones exactly:
``jnp.argsort`` is stable and ``lax.top_k`` puts the lower index first
among equal values, and suppressed slots all tie at score 0, so every
sort here is a stable one — ``torch.topk`` would fill the invalid slots
with other boxes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .decode import classification_confidence
from .geometry import iou


def detection_scores(decoded: torch.Tensor) -> torch.Tensor:
    """objectness * class confidence of decoded ``(..., N, 6)``."""
    return decoded[..., 0] * classification_confidence(decoded[..., 1])


def _top_k(values: torch.Tensor, k: int):
    """Largest k along the last axis, lower index first among ties."""
    top, indices = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], indices[..., :k]


def top_k_detections(decoded: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores (B, k), class_ids (B, k) int32, boxes (B, k, 4))`` of the
    k best detections per image by combined score."""
    top_scores, indices = _top_k(detection_scores(decoded), k)
    classes = torch.round(
        torch.gather(decoded[..., 1], -1, indices)).to(torch.int32)
    boxes = torch.gather(decoded[..., 2:], -2,
                         indices[..., None].expand(*indices.shape, 4))
    return top_scores, classes, boxes


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor,
                        class_ids: torch.Tensor,
                        iou_threshold: float = 0.5,
                        score_threshold: float = 0.0,
                        per_class: bool = True) -> torch.Tensor:
    """Batched greedy NMS -> ``(B, N)`` bool keep mask in input order.

    ``boxes (B, N, 4)`` cxcyhw, ``scores (B, N)``, ``class_ids (B, N)``;
    ``per_class`` suppresses only within one class.
    """
    n = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = torch.gather(boxes, -2,
                                order[..., None].expand(*order.shape, 4))
    scores_sorted = torch.gather(scores, -1, order)
    classes_sorted = torch.gather(class_ids, -1, order)

    iou_matrix = iou(boxes_sorted[..., :, None, :].expand(-1, n, n, 4),
                     boxes_sorted[..., None, :, :].expand(-1, n, n, 4))
    if per_class:
        same_class = classes_sorted[..., :, None] == classes_sorted[
            ..., None, :]
        iou_matrix = torch.where(same_class, iou_matrix, 0.0)

    # overlaps[b, i, j]: a kept box i suppresses every later j above the
    # threshold; the greedy pass walks the ranking once.
    later = torch.ones(n, n, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    overlaps = (iou_matrix > iou_threshold) & later
    keep = scores_sorted > score_threshold
    for i in range(n):
        keep = keep & ~(overlaps[:, i] & keep[:, i:i + 1])

    inverse = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(keep, -1, inverse)


def postprocess_detections(decoded: torch.Tensor, k: int = 17,
                           iou_threshold: float = 0.5,
                           score_threshold: float = 0.0,
                           per_class: bool = True):
    """Scores -> NMS -> top-k: ``(scores, class_ids, boxes, valid)``, each
    with leading ``(B, k)``; suppressed slots have score 0, valid False."""
    scores = detection_scores(decoded)
    class_ids = torch.round(decoded[..., 1]).to(torch.int32)
    boxes = decoded[..., 2:]
    keep = non_max_suppression(boxes, scores, class_ids,
                               iou_threshold=iou_threshold,
                               score_threshold=score_threshold,
                               per_class=per_class)
    masked_scores = torch.where(keep, scores, 0.0)
    top_scores, indices = _top_k(masked_scores, k)
    top_classes = torch.gather(class_ids, -1, indices)
    top_boxes = torch.gather(boxes, -2,
                             indices[..., None].expand(*indices.shape, 4))
    return top_scores, top_classes, top_boxes, top_scores > 0.0
