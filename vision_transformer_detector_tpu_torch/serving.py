"""Detection serving in PyTorch behind the shared HTTP server.

Counterpart of vision_transformer_detector_tpu/serving.py. Only the
device program is new here: ``DetectionService.predict_raw`` runs uint8
normalisation, forward, decode, NMS + top-k and packing on the service's
device. The host side — JPEG letterboxing, mapping boxes back to source
pixels, turning the packed tensor into detection dicts — is the JAX
package's ``DetectionService`` code, inherited unchanged; it imports no
JAX. ``DetectionServer`` and ``BatchingDetectionService`` are the JAX
package's too, re-exported here: they touch only the service's public
methods.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vision_transformer_detector_tpu import serving as _shared
from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu.serving import (  # noqa: F401
    BatchingDetectionService, DetectionServer)

from .models.vit_detector import ViTDetector, forward
from .ops.decode import transform_predictions
from .ops.nms import postprocess_detections
from .utils.device import resolve_device


def _pack_raw(scores, classes, boxes, valid) -> torch.Tensor:
    """(B, k) scores / classes / valid and (B, k, 4) boxes -> ONE
    (B, k, 7) float32 tensor: one device->host copy per batch. Class ids
    are exact in float32 and valid rides as 0/1."""
    return torch.cat([scores[..., None].float(), classes[..., None].float(),
                      boxes.float(), valid[..., None].float()], dim=-1)


class DetectionService(_shared.DetectionService):
    """End-to-end detector on one device: images in, scored boxes out.

    ``params`` is a ViTDetector (models/vit_detector.py); it is moved to
    ``device``. ``device="cuda"`` without a visible GPU raises.
    """

    def __init__(self, config: DetectorConfig, params: ViTDetector,
                 device="cuda", k: int = 17, iou_threshold: float = 0.5,
                 score_threshold: float = 0.0, fast_decode: bool = False):
        self.device = resolve_device(device)
        self.config = config
        self.params = params.to(self.device)
        self.fast_decode = fast_decode
        self.k = k
        self.iou_threshold = iou_threshold
        self.score_threshold = score_threshold

    @torch.inference_mode()
    def predict_raw(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 or [-1, 1] float images -> the packed
        (B, k, 7) detections, left on the device (no sync)."""
        # A PIL-decoded canvas is read-only; torch wants writable memory.
        x = torch.from_numpy(np.require(images, requirements=("C", "W")))
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        logits = forward(self.params, x, self.config)
        decoded = transform_predictions(logits, self.config)
        return _pack_raw(*postprocess_detections(
            decoded, k=self.k, iou_threshold=self.iou_threshold,
            score_threshold=self.score_threshold))

    @staticmethod
    def raw_to_detections(raw) -> List[List[dict]]:
        """Sync + convert ``predict_raw`` output to per-image dicts."""
        if isinstance(raw, torch.Tensor):
            raw = raw.cpu().numpy()       # one transfer, waits for the device
        return _shared.DetectionService.raw_to_detections(raw)
