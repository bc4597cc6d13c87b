"""The port's device mAP metric vs the 13 reference oracles and the
shared NumPy oracle (metrics/mean_average_precision.py).

The 13 cases are those of tests/test_map_metric.py, each with its exact
expected value; the randomized streams are those of tests/test_fast_map.py
(jittered boxes, several classes, false positives, ring evictions). Both
metrics take the same already-decoded numpy predictions. Tolerance 1e-6
on the oracle values and 1e-5 against the NumPy oracle, as the JAX
package's jitted metric is held (fp32 on the port side, float64 sums in
parts of the oracle).
"""

import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu.metrics.mean_average_precision import (
    MeanAveragePrecision)
from vision_transformer_detector_tpu_torch.metrics.fast_map import (
    DeviceMeanAveragePrecision)

CFG = DetectorConfig()
SHAPE = (10, 6)


def empty_labels(batch):
    label = np.ones((batch, *SHAPE), np.float32) * -8.0
    label[..., 0] = 0.0
    return label


def _port(stream):
    metric = DeviceMeanAveragePrecision(CFG)
    for y_true, y_pred in stream:
        metric.update_state(y_true, y_pred, use_transform_predictions=False)
    return metric.result()


def _oracle(stream):
    metric = MeanAveragePrecision(CFG)
    for y_true, y_pred in stream:
        metric.update_state(y_true, y_pred, use_transform_predictions=False)
    return float(metric.result())


def _case(name):
    """(stream of (label, prediction) batches, expected mAP)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    pred = label.copy()
    if name == "1_perfect":
        return [(label, pred)], 1.0
    if name == "2_two_categories":
        label[0, 2] = (1, 78, 9.5, 9.5, 5, 5)
        return [(label, label.copy())], 1.0
    if name == "3_iou_064":
        pred[..., -4:] = (9.5, 9.5, 8, 8)
        return [(label, pred)], 0.3
    if name == "4_iou_049":
        pred[..., -4:] = (9.5, 9.5, 7, 7)
        return [(label, pred)], 0.0
    if name == "5_1_low_objectness":
        pred[0, 1, 0] = 0.49
        return [(label, pred)], 0.0
    if name == "5_2_false_positive":
        pred[0, 2] = (0.51, 79, 10.2, 10.2, 9.9, 9.9)
        return [(label, pred)], 0.75
    if name == "6_low_class_conf":
        pred[0, 1, 1] = 79.255
        return [(label, pred)], 0.0
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    if name == "7_two_images":
        label[1, 5] = label[0, 1]
        return [(label, label.copy())], 1.0
    label[1, 0] = label[0, 1]
    pred = label.copy()
    if name == "8_one_zero_ap":
        pred[1, 0, 1] = 79.001
        pred[1, 0, -4:] = (9.5, 9.5, 7, 7)
        return [(label, pred)], 0.375
    if name == "9_objectness_below":
        pred[1, 0, 0] = 0.49
        return [(label, pred)], 0.5
    if name == "10_class_conf_below":
        pred[1, 0, 1] = 79.3
        return [(label, pred)], 0.5
    if name == "11_two_categories_two_images":
        label = empty_labels(2)
        label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
        label[0, 2] = (1, 78, 10.2, 10.2, 10, 10)
        label[1] = label[0]
        pred = label.copy()
        pred[0, 1, 1] = 79.005
        pred[0, 1, -4:] = (9.5, 9.5, 7, 7)
        return [(label, pred)], 0.6875
    if name == "streaming_8":
        pred[1, 0, 1] = 79.001
        pred[1, 0, -4:] = (9.5, 9.5, 7, 7)
        return [(label[:1], pred[:1]), (label[1:], pred[1:])], 0.375
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "1_perfect", "2_two_categories", "3_iou_064", "4_iou_049",
    "5_1_low_objectness", "5_2_false_positive", "6_low_class_conf",
    "7_two_images", "8_one_zero_ap", "9_objectness_below",
    "10_class_conf_below", "11_two_categories_two_images", "streaming_8"])
def test_reference_oracles(name):
    stream, expected = _case(name)
    assert _oracle(stream) == pytest.approx(expected)
    assert _port(stream) == pytest.approx(expected, abs=1e-6)


def test_12_reset_metric():
    """reset_state zeroes all three state tensors (oracle 12)."""
    stream, _ = _case("1_perfect")
    metric = DeviceMeanAveragePrecision(CFG)
    metric.update_state(*stream[0], use_transform_predictions=False)
    assert metric.result() == pytest.approx(1.0)
    metric.reset_state()
    assert not metric.state.latest_positive_bboxes.any()
    assert not metric.state.labels_quantity_per_image.any()
    assert not metric.state.showed_up_classes.any()
    assert metric.result() == pytest.approx(0.0)


def random_stream(seed, batches=3, batch_size=2, num_classes=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        label = np.full((batch_size, 17, 6), -8.0, np.float32)
        label[..., 0] = 0.0
        pred = label.copy()
        for b in range(batch_size):
            for s in range(int(rng.integers(0, 6))):
                cls = float(rng.integers(0, num_classes))
                h, w = rng.uniform(20, 120, 2)
                cx = rng.uniform(w / 2, 608 - w / 2)
                cy = rng.uniform(h / 2, 608 - h / 2)
                label[b, s] = (1, cls, cx, cy, h, w)
                jitter = rng.uniform(0.7, 1.3)
                pred[b, s] = (float(rng.uniform(0.3, 1.0)),
                              cls + float(rng.uniform(-0.6, 0.6)),
                              cx + rng.uniform(-15, 15),
                              cy + rng.uniform(-15, 15), h * jitter,
                              w * jitter)
            if rng.uniform() < 0.5:
                pred[b, 16] = (float(rng.uniform(0.5, 1.0)),
                               float(rng.integers(0, num_classes)),
                               300, 300, 50, 50)
        out.append((label, pred))
    return out


@pytest.mark.parametrize("seed,batches,batch_size,classes", [
    (0, 3, 2, 6), (1, 3, 2, 6), (2, 3, 2, 6),
    (7, 6, 2, 2),          # more related images than the ring holds
    (10, 4, 3, 80),
])
def test_randomized_equivalence_with_numpy_oracle(seed, batches, batch_size,
                                                  classes):
    stream = random_stream(seed, batches, batch_size, classes)
    assert _port(stream) == pytest.approx(_oracle(stream), abs=1e-5)


def test_max_iou_tie_and_match_cap():
    """Tied max-IoU boxes all go (first one's confidence), and more
    same-class labels than bboxes_per_image hit the match cap."""
    label = empty_labels(1)
    label[0, 0] = (1, 5, 100.0, 100.0, 40.0, 40.0)
    label[0, 1] = (1, 5, 300.0, 300.0, 30.0, 30.0)
    pred = np.full_like(label, -8.0)
    pred[0, 0] = (0.9, 5.1, 100.0, 100.0, 40.0, 40.0)
    pred[0, 1] = (0.9, 4.9, 100.0, 100.0, 40.0, 40.0)
    pred[0, 2] = (0.9, 5.0, 300.0, 300.0, 30.0, 30.0)
    assert _port([(label, pred)]) == pytest.approx(
        _oracle([(label, pred)]), abs=1e-6)

    rng = np.random.default_rng(11)
    many = np.full((1, 17, 6), -8.0, np.float32)
    many[..., 0] = 0.0
    for s in range(17):
        h, w = rng.uniform(20, 60, 2)
        many[0, s] = (1, 7, 30.0 + s * 33.0, 300.0, h, w)
    pred = many.copy()
    pred[0, ::2, -2:] *= 0.65
    assert _port([(many, pred)]) == pytest.approx(
        _oracle([(many, pred)]), abs=1e-5)


def test_raw_logits_and_tensor_inputs():
    """``use_transform_predictions=True`` decodes raw logits as the oracle
    does; torch tensors are taken as they are."""
    rng = np.random.default_rng(3)
    label = random_stream(3, 1, 2, 6)[0][0]
    logits = rng.normal(0, 2, label.shape).astype(np.float32)
    oracle = MeanAveragePrecision(CFG)
    oracle.update_state(label, logits)
    metric = DeviceMeanAveragePrecision(CFG)
    metric.update_state(torch.from_numpy(label), torch.from_numpy(logits))
    assert metric.result() == pytest.approx(float(oracle.result()), abs=1e-5)
