"""Streaming COCO-style mAP@[.5:.95] metric.

The PyTorch port's own copy of vision_transformer_detector_tpu/metrics/
mean_average_precision.py, the NumPy oracle, kept as it is
(tests/test_torch_self_contained.py holds the two to one result).

Reimplements the reference's ``MeanAveragePrecision``
(vision_transformer_detector.py:1268-2060) with identical semantics,
validated against its 13 numeric unit-test oracles
(testcases_vision_transformer_detector.py:11-734).

Semantics recap (all cited against the reference):
  * State (vtd.py:1286-1304): per class, a ring buffer over the most recent
    ``latest_related_images`` related images of ``bboxes_per_image``
    (confidence, IoU) pairs; a parallel ring of per-image label counts; and
    a "class has shown up" flag.
  * A prediction slot is positive iff objectness > 0.5 AND class confidence
    ``(0.5 - |v - round(v)|)/0.5`` > 0.5 (vtd.py:1376-1384).
  * Per image x class, four scenarios (vtd.py:1497-1523): (a) class in
    neither label nor prediction -> no state change; (b) label only ->
    all-zero bbox row; (c) prediction only -> confidences with IoU 0;
    (d) both -> greedy max-IoU matching of label boxes sorted by area
    ascending (vtd.py:1644-1758), unmatched positives appended with IoU 0
    (vtd.py:1760-1852).
  * result() (vtd.py:1865-2049): for 10 IoU thresholds linspace(.5,.95),
    per shown class: sort (conf, IoU) pairs by confidence descending, walk
    them accumulating TP/FP with the "replace last precision on FP" rule,
    then trapezoid-integrate with a leading precision of 1 and height
    1/labels_quantity.

The update is host-side NumPy: per image it is O(classes x max_objects)
scalar work on tiny arrays, far from the training hot path (the reference
runs it eagerly for the same reason, vtd.py:2066-2069). A vectorised
on-device variant can slot in behind the same API later; this one is the
numerics oracle.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    CLASSIFICATION_CONFIDENCE_THRESHOLD,
    DetectorConfig,
    OBJECTNESS_THRESHOLD,
)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _decode_np(inputs: np.ndarray, config: DetectorConfig) -> np.ndarray:
    """NumPy twin of ops.decode.transform_predictions (vtd.py:586-647)."""
    x = _sigmoid(np.asarray(inputs, np.float32))
    height, width = config.image_size
    out = np.empty_like(x)
    out[..., 0] = x[..., 0]
    out[..., 1] = x[..., 1] * (config.num_classes - 1)
    out[..., 2] = x[..., 2] * width
    out[..., 3] = x[..., 3] * height
    out[..., 4] = x[..., 4] * height
    out[..., 5] = x[..., 5] * width
    return out


def _iou_np(label_bbox: np.ndarray, prediction_bbox: np.ndarray) -> np.ndarray:
    """NumPy twin of ops.geometry.iou (vtd.py:761-875)."""
    label_bbox = np.asarray(label_bbox, np.float32)
    prediction_bbox = np.asarray(prediction_bbox, np.float32)

    l_left = label_bbox[..., -4] - label_bbox[..., -1] / 2
    l_right = label_bbox[..., -4] + label_bbox[..., -1] / 2
    l_top = label_bbox[..., -3] - label_bbox[..., -2] / 2
    l_bottom = label_bbox[..., -3] + label_bbox[..., -2] / 2
    p_left = prediction_bbox[..., -4] - prediction_bbox[..., -1] / 2
    p_right = prediction_bbox[..., -4] + prediction_bbox[..., -1] / 2
    p_top = prediction_bbox[..., -3] - prediction_bbox[..., -2] / 2
    p_bottom = prediction_bbox[..., -3] + prediction_bbox[..., -2] / 2

    intersects = ((l_left < p_right) & (l_right > p_left)
                  & (l_top < p_bottom) & (l_bottom > p_top))

    horizontal = np.stack([l_top, l_bottom, p_top, p_bottom], axis=-1)
    vertical = np.stack([l_left, l_right, p_left, p_right], axis=-1)
    mask = intersects[..., None]
    horizontal = np.sort(np.where(mask, horizontal, 0.0), axis=-1)
    vertical = np.sort(np.where(mask, vertical, 0.0), axis=-1)

    inter = ((horizontal[..., -2] - horizontal[..., -3])
             * (vertical[..., -2] - vertical[..., -3]))
    union = (prediction_bbox[..., -1] * prediction_bbox[..., -2]
             + label_bbox[..., -1] * label_bbox[..., -2] - inter)
    return inter / (union + np.float32(1e-8))


def _class_confidence(classification: np.ndarray) -> np.ndarray:
    """(0.5 - |v - round(v)|)/0.5 (vtd.py:1369-1376)."""
    classification = np.asarray(classification, np.float32)
    error = np.abs(classification - np.round(classification))
    return (np.float32(0.5) - error) / np.float32(0.5)


class MeanAveragePrecision:
    """Streaming mAP with the reference's exact state machine."""

    def __init__(self, config: DetectorConfig = DetectorConfig()):
        self.config = config
        self._num_classes = config.num_classes
        self._images = config.latest_related_images
        self._bboxes = config.bboxes_per_image
        # State layout mirrors vtd.py:1286-1304.
        self.latest_positive_bboxes = np.zeros(
            (self._num_classes, self._images, self._bboxes, 2), np.float32)
        self.labels_quantity_per_image = np.zeros(
            (self._num_classes, self._images), np.float32)
        self.showed_up_classes = np.zeros((self._num_classes,), bool)

    # ------------------------------------------------------------------
    def reset_state(self) -> None:
        """Zero all state (vtd.py:2052-2060)."""
        self.latest_positive_bboxes[:] = 0.0
        self.labels_quantity_per_image[:] = 0.0
        self.showed_up_classes[:] = False

    # ------------------------------------------------------------------
    def update_state(self, y_true, y_pred,
                     use_transform_predictions: bool = True) -> None:
        """Consume one batch of labels/predictions (vtd.py:1310-1862)."""
        y_true = np.asarray(y_true, np.float32)
        y_pred = np.asarray(y_pred, np.float32)
        if use_transform_predictions:
            y_pred = _decode_np(y_pred, self.config)

        # --- showed_up_classes (vtd.py:1343-1411) ----------------------
        categories_label = y_true[..., 1]
        shown_label = categories_label[categories_label >= 0]

        objectness_pred = y_pred[..., 0]
        classification_pred = y_pred[..., 1]
        categories_pred = np.round(classification_pred)
        confidence_pred = _class_confidence(classification_pred)
        positive_pred = ((objectness_pred > OBJECTNESS_THRESHOLD)
                         & (confidence_pred
                            > CLASSIFICATION_CONFIDENCE_THRESHOLD))
        shown_pred = categories_pred[positive_pred]

        shown = np.union1d(shown_label.astype(np.int32),
                           shown_pred.astype(np.int32))
        for category in shown:
            if 0 <= category < self._num_classes:
                self.showed_up_classes[int(category)] = True

        # --- per-image state updates (vtd.py:1413-1862) -----------------
        for sample in range(y_true.shape[0]):
            self._update_one_image(y_true[sample], y_pred[sample])

    # ------------------------------------------------------------------
    def _update_one_image(self, one_label: np.ndarray,
                          one_pred: np.ndarray) -> None:
        categories_one_label = one_label[..., 1]

        objectness = one_pred[..., 0]
        classification = one_pred[..., 1]
        categories = np.round(classification)
        confidence = _class_confidence(classification)
        positive_index = ((objectness > OBJECTNESS_THRESHOLD)
                          & (confidence
                             > CLASSIFICATION_CONFIDENCE_THRESHOLD))

        # Negative slots are forced to -8 so they cannot collide with class 0
        # (vtd.py:1465-1475).
        positives_pred = np.where(positive_index[..., None], one_pred, -8.0)
        positives_category = np.where(positive_index, categories, -8.0)

        for category in range(self._num_classes):
            cat_bool_label = np.isclose(categories_one_label, category)
            cat_bool_pred = np.isclose(positives_category, category)
            any_label = bool(cat_bool_label.any())
            any_pred = bool(cat_bool_pred.any())

            if not (any_label or any_pred):  # scenario a (vtd.py:1498)
                continue

            # Ring-shift the label-count buffer (vtd.py:1527-1544).
            quantity = int(np.count_nonzero(cat_bool_label))
            self.labels_quantity_per_image[category, 1:] = (
                self.labels_quantity_per_image[category, :-1])
            self.labels_quantity_per_image[category, 0] = quantity

            if not any_pred:  # scenario b (vtd.py:1550-1556)
                buffer = np.zeros((self._bboxes, 2), np.float32)
            elif not any_label:  # scenario c (vtd.py:1558-1621)
                conf = confidence[cat_bool_pred & positive_index]
                if conf.shape[0] < self._bboxes:
                    conf = np.pad(conf, (0, self._bboxes - conf.shape[0]))
                else:
                    conf = np.sort(conf)[::-1][: self._bboxes]
                buffer = np.stack(
                    [conf, np.zeros_like(conf)], axis=1).astype(np.float32)
            else:  # scenario d (vtd.py:1623-1852)
                buffer = self._scenario_d(
                    one_label, positives_pred, cat_bool_label, cat_bool_pred)

            # Ring-shift the bbox buffer (vtd.py:1854-1862).
            self.latest_positive_bboxes[category, 1:] = (
                self.latest_positive_bboxes[category, :-1])
            self.latest_positive_bboxes[category, 0] = buffer

    # ------------------------------------------------------------------
    def _scenario_d(self, one_label, positives_pred,
                    cat_bool_label, cat_bool_pred) -> np.ndarray:
        """Greedy max-IoU matching, label boxes area-ascending
        (vtd.py:1623-1852)."""
        bboxes = self._bboxes

        # Class-filtered prediction boxes, -8 elsewhere (vtd.py:1630-1632).
        bboxes_iou_pred = np.where(
            cat_bool_pred[..., None], positives_pred[..., -4:], -8.0)

        label_boxes = one_label[..., -4:][cat_bool_label]
        areas = label_boxes[:, -1] * label_boxes[:, -2]
        sorted_boxes = label_boxes[np.argsort(areas, kind="stable")]

        buffer = np.zeros((bboxes, 2), np.float32)
        new_quantity = 0

        for bbox_info in sorted_boxes:
            ious = _iou_np(
                np.broadcast_to(bbox_info, bboxes_iou_pred.shape),
                bboxes_iou_pred)
            max_iou = float(ious.max())
            if max_iou > 0.5:
                new_quantity += 1
                position = np.isclose(ious, max_iou)
                matched = positives_pred[position][0]
                matched_confidence = float(
                    _class_confidence(np.float32(matched[1])))
                new_row = np.array(
                    [[matched_confidence, max_iou]], np.float32)
                # Append then keep the newest `bboxes` rows (vtd.py:1728-1738)
                buffer = np.concatenate([buffer, new_row], axis=0)[-bboxes:]
                bboxes_iou_pred = np.where(
                    position[..., None], -8.0, bboxes_iou_pred)
            if new_quantity == bboxes:
                break

        # Unmatched positives recorded with IoU 0 (vtd.py:1760-1852).
        left_bool = np.all(bboxes_iou_pred >= 0, axis=-1)
        left_pred = positives_pred[left_bool]
        if left_pred.shape[0] > 0 and new_quantity < bboxes:
            left_confidence = _class_confidence(left_pred[:, 1])
            if new_quantity + left_pred.shape[0] > bboxes:
                left_confidence = np.sort(
                    left_confidence)[::-1][: bboxes - new_quantity]
            left_rows = np.stack(
                [left_confidence, np.zeros_like(left_confidence)],
                axis=1).astype(np.float32)
            buffer = np.concatenate([buffer, left_rows], axis=0)[-bboxes:]

        return buffer

    # ------------------------------------------------------------------
    def result(self) -> np.float32:
        """mAP over 10 IoU thresholds x shown classes (vtd.py:1865-2049)."""
        thresholds = np.linspace(0.5, 0.95, 10).astype(np.float32)
        per_iou = np.zeros((10,), np.float32)

        for t, iou_threshold in enumerate(thresholds):
            average_precisions = []
            for category in range(self._num_classes):
                if not self.showed_up_classes[category]:
                    continue
                average_precisions.append(
                    self._category_ap(category, iou_threshold))
            if average_precisions:
                per_iou[t] = np.mean(
                    np.asarray(average_precisions, np.float32))
            else:
                per_iou[t] = 0.0  # no labels, no predictions (vtd.py:2029-2039)

        return np.float32(per_iou.mean())

    # ------------------------------------------------------------------
    def _category_ap(self, category: int,
                     iou_threshold: np.float32) -> np.float32:
        rows = self.latest_positive_bboxes[category].reshape(-1, 2)
        confidence = rows[:, 0]
        # Stable descending sort keeps matched-before-leftover order among
        # equal confidences, which the oracles depend on (testcases:305-370).
        order = np.argsort(-confidence, kind="stable")
        rows = rows[order]

        recall_precisions = [np.float32(1.0)]
        true_positives = np.float32(0.0)
        false_positives = np.float32(0.0)
        for conf, iou_value in rows:
            if conf <= 0:  # empty slot (vtd.py:1923-1928)
                continue
            if iou_value > iou_threshold:
                true_positives += 1
                recall_precisions.append(
                    true_positives / (true_positives + false_positives))
            else:
                false_positives += 1
                recall_precisions[-1] = (
                    true_positives / (true_positives + false_positives))

        labels_quantity = self.labels_quantity_per_image[category].sum()
        if labels_quantity <= 0:  # scenario c only (vtd.py:2002-2007)
            return np.float32(0.0)
        recalls = len(recall_precisions) - 1
        if recalls == 0:  # scenario b (vtd.py:1981-1985)
            return np.float32(0.0)
        edges = np.float32(0.0)
        for i in range(recalls):
            edges += recall_precisions[i] + recall_precisions[i + 1]
        return np.float32(edges * (1.0 / labels_quantity) / 2.0)
