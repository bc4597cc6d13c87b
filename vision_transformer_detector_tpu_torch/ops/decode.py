"""Prediction decoding: raw head logits -> (confidence, class, box).

Counterpart of vision_transformer_detector_tpu/ops/decode.py. The sigmoid
stays outside the model, as in the reference; everything runs on the
logits' device in fp32.
"""

from __future__ import annotations

import torch

from vision_transformer_detector_tpu.config import (
    CLASSIFICATION_CONFIDENCE_THRESHOLD, OBJECTNESS_THRESHOLD,
    DetectorConfig)


def transform_predictions(inputs: torch.Tensor,
                          config: DetectorConfig) -> torch.Tensor:
    """Decode raw ``(B, max_objects, 6)`` logits into real-size values:
    [objectness in [0, 1], class in [0, num_classes - 1], center_x,
    center_y, height, width in pixels]."""
    inputs = torch.sigmoid(inputs.float())
    # A no-op after the sigmoid, kept for exactness with the reference.
    ratio = inputs[..., 2:].clamp(0.0, 1.0)

    height, width = config.image_size
    return torch.cat([
        inputs[..., 0:1],
        inputs[..., 1:2] * (config.num_classes - 1),
        ratio[..., 0:1] * width,
        ratio[..., 1:2] * height,
        ratio[..., 2:3] * height,
        ratio[..., 3:4] * width,
    ], dim=-1)


def classification_confidence(classification: torch.Tensor) -> torch.Tensor:
    """``(0.5 - |v - round(v)|) / 0.5``; torch.round, like jnp.round,
    rounds half to even."""
    classification = classification.float()
    error = (classification - torch.round(classification)).abs()
    return (0.5 - error) / 0.5


def select_detections(
        decoded: torch.Tensor,
        objectness_threshold: float = OBJECTNESS_THRESHOLD,
        confidence_threshold: float = CLASSIFICATION_CONFIDENCE_THRESHOLD):
    """``(keep_mask, class_id, class_confidence)`` with the metric's
    strictly-greater positivity test."""
    objectness = decoded[..., 0]
    classification = decoded[..., 1]
    confidence = classification_confidence(classification)
    keep = (objectness > objectness_threshold) & (
        confidence > confidence_threshold)
    class_id = torch.round(classification).to(torch.int32)
    return keep, class_id, confidence
