"""PyTorch decode / IoU / NMS / postprocess vs the JAX ops.

Inputs are made with numpy from a seed and go through both packages on
the CPU. Continuous random scores have no ties, so keep masks and
orderings must agree exactly; the one systematic tie, suppressed slots at
score 0, must come out in the JAX order (stable, lower index first).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu.ops import decode as jax_decode
from vision_transformer_detector_tpu.ops import geometry as jax_geometry
from vision_transformer_detector_tpu.ops import nms as jax_nms
from vision_transformer_detector_tpu_torch.ops import decode, geometry, nms

CONFIG = DetectorConfig(image_size=(96, 128))
# fp32 elementwise math in the same order on both sides; 1e-6 absorbs
# libm differences in sigmoid/exp.
TOL = 1e-6


def _decoded(batch=3, n=17, seed=0, cluster=False):
    """Decoded (B, N, 6) predictions. ``cluster`` piles the boxes onto a
    few centres so NMS suppresses many of them."""
    rng = np.random.default_rng(seed)
    out = np.empty((batch, n, 6), np.float32)
    out[..., 0] = rng.uniform(0.05, 1.0, (batch, n))
    out[..., 1] = rng.uniform(0.0, 79.0, (batch, n))
    if cluster:
        centres = rng.uniform(20, 80, (batch, 3, 2))
        pick = rng.integers(0, 3, (batch, n))
        cxcy = np.take_along_axis(centres, pick[..., None], axis=1)
        out[..., 2:4] = cxcy + rng.normal(0, 2.0, (batch, n, 2))
        out[..., 4:6] = rng.uniform(25, 35, (batch, n, 2))
        # Few classes, so per-class NMS also suppresses.
        out[..., 1] = rng.choice([3.1, 7.2], (batch, n)) + rng.uniform(
            -0.3, 0.3, (batch, n))
    else:
        out[..., 2:4] = rng.uniform(0, 96, (batch, n, 2))
        out[..., 4:6] = rng.uniform(4, 60, (batch, n, 2))
    return out


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def test_transform_predictions_matches_jax():
    logits = np.random.default_rng(1).normal(0, 3, (2, 17, 6)).astype(
        np.float32)
    expected = jax_decode.transform_predictions(jnp.asarray(logits), CONFIG)
    out = decode.transform_predictions(_t(logits), CONFIG)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               atol=1e-5, rtol=TOL)


def test_classification_confidence_rounds_half_to_even():
    values = np.array([0.5, 1.5, 2.5, 3.49, 7.51, 10.0, 78.5, 0.25],
                      np.float32)
    expected = jax_decode.classification_confidence(jnp.asarray(values))
    out = decode.classification_confidence(_t(values))
    np.testing.assert_array_equal(out.numpy(), np.asarray(expected))
    _, class_id, _ = decode.select_detections(
        _t(np.stack([np.ones_like(values)] * 6, -1) * values[:, None]))
    _, jax_class_id, _ = jax_decode.select_detections(
        jnp.asarray(np.stack([np.ones_like(values)] * 6, -1)
                    * values[:, None]))
    np.testing.assert_array_equal(class_id.numpy(), np.asarray(jax_class_id))


def test_select_detections_matches_jax():
    decoded = _decoded(seed=2)
    decoded[..., 1] = np.random.default_rng(3).uniform(0, 79, (3, 17))
    keep, class_id, conf = decode.select_detections(_t(decoded))
    jkeep, jclass, jconf = jax_decode.select_detections(jnp.asarray(decoded))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(class_id.numpy(), np.asarray(jclass))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=TOL)


def test_iou_matches_jax():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0, 50, (64, 2)),
                        rng.uniform(1, 40, (64, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 50, (64, 2)),
                        rng.uniform(1, 40, (64, 2))], -1).astype(np.float32)
    b[:8] = a[:8]                      # identical pairs: IoU ~ 1
    b[8:16, :2] += 200.0               # disjoint pairs: IoU 0
    expected = np.asarray(jax_geometry.iou(jnp.asarray(a), jnp.asarray(b)))
    out = geometry.iou(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(out, expected, atol=TOL, rtol=1e-6)
    assert (out[8:16] == 0).all() and (out[:8] > 0.999).all()


def test_detection_scores_and_top_k_match_jax():
    decoded = _decoded(seed=5)
    np.testing.assert_allclose(
        nms.detection_scores(_t(decoded)).numpy(),
        np.asarray(jax_nms.detection_scores(jnp.asarray(decoded))),
        atol=TOL)
    for got, want in zip(nms.top_k_detections(_t(decoded), 5),
                         jax_nms.top_k_detections(jnp.asarray(decoded), 5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("per_class", [True, False])
@pytest.mark.parametrize("iou_threshold,score_threshold", [
    (0.5, 0.0), (0.3, 0.2), (0.7, 0.0)])
def test_nms_keep_mask_matches_jax(per_class, iou_threshold,
                                   score_threshold):
    decoded = _decoded(batch=4, n=17, seed=6, cluster=True)
    boxes, scores = decoded[..., 2:], decoded[..., 0]
    classes = np.round(decoded[..., 1]).astype(np.int32)
    expected = np.asarray(jax_nms.non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        per_class=per_class))
    keep = nms.non_max_suppression(
        _t(boxes), _t(scores), _t(classes), iou_threshold=iou_threshold,
        score_threshold=score_threshold, per_class=per_class).numpy()
    np.testing.assert_array_equal(keep, expected)
    assert 0 < keep.sum() < keep.size      # the case suppresses something


@pytest.mark.parametrize("per_class", [True, False])
def test_postprocess_matches_jax_including_zero_score_ties(per_class):
    decoded = _decoded(batch=3, n=17, seed=7, cluster=True)
    expected = jax_nms.postprocess_detections(
        jnp.asarray(decoded), k=17, iou_threshold=0.4, per_class=per_class)
    out = nms.postprocess_detections(_t(decoded), k=17, iou_threshold=0.4,
                                     per_class=per_class)
    scores, classes, boxes, valid = (t.numpy() for t in out)
    jscores, jclasses, jboxes, jvalid = (np.asarray(t) for t in expected)
    assert (~jvalid).any(), "no suppressed slots to order"
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(scores, jscores, atol=TOL)
    # Exact classes and boxes in every slot, the zero-score ones included.
    np.testing.assert_array_equal(classes, jclasses)
    np.testing.assert_array_equal(boxes, jboxes)
    assert classes.dtype == np.int32
