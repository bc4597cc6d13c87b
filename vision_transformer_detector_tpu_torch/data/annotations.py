"""COCO annotation loading and label construction.

Replaces the reference's import-time annotation parsing
(vision_transformer_utilities.py:82-220) with explicit APIs:

  * ``build_annotations_dict(raw)`` — COCO instances JSON ->
    ``{image_id: [[category_id, cx, cy, h, w, area], ...]}`` with the same
    fixes the reference applies: top-left corner -> center format with
    3-decimal rounding (vtu.py:149-152), degenerate 0-height/width boxes set
    to 1 (vtu.py:154-166), per-image sort by area descending (vtu.py:188-199).
  * ``load_annotations_dict(path)`` — loads a pre-extracted
    train/val_annotations_dict.json (the format the reference ships;
    BASELINE.json requires this API).
  * ``letterbox_params`` / ``letterbox_boxes`` — the aspect-preserving
    resize-with-pad transform of box coordinates (vtu.py:305-368),
    vectorised over all boxes of an image instead of the reference's
    per-annotation python loop with pandas lookups (the pipeline hot spot,
    SURVEY.md §3.1).
  * ``labels_from_annotations`` — the fixed-slot ``(max_objects, 6)`` label
    tensor with the -8 empty-slot convention (vtu.py:452-507).

The PyTorch port's own copy of vision_transformer_detector_tpu/data/
annotations.py. Its native JSON parser is the port's own copy of the
core (native/coco_json.cc of this package, built at its first use by
``_native/__init__.py``); where it does not build, the pure-Python parser
runs, as it does in the JAX package.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._native import _native_coco_json  # the core builds at first use
from ..config import DetectorConfig
from .categories import COCO_ID_TO_MODEL_ID

AnnotationsDict = Dict[str, List[List[float]]]

logger = logging.getLogger(__name__)


def native_parser_available() -> bool:
    return _native_coco_json.available()


class AnnotationDiagnostics:
    """What the parse fixed or warned about (vtu.py:154-166, 182-186).

    ``fixed_boxes`` rows mirror the reference's fixed_records:
    ``[dimension ('Width'|'Height'), annotation_index, image_id,
    category_id, center_x, center_y]``. ``negative_coordinates`` rows are
    ``[annotation_index, image_id, category_id, bbox_x, bbox_y]``.
    """

    def __init__(self):
        self.fixed_boxes: List[list] = []
        self.negative_coordinates: List[list] = []

    def summary(self) -> Dict[str, int]:
        return {"fixed_boxes": len(self.fixed_boxes),
                "negative_coordinates": len(self.negative_coordinates)}


def build_annotations_dict(raw: dict,
                           area_descending: bool = True,
                           diagnostics: Optional[AnnotationDiagnostics] = None
                           ) -> AnnotationsDict:
    """COCO instances dict -> annotation dict (vtu.py:82-210).

    Each annotation becomes ``[category_id_in_coco, center_x, center_y,
    height, width, bbox_area]``; per-image lists are sorted by area
    (descending by default, BBOX_AREA_DESCENDING at vtu.py:51-53).

    Pass an ``AnnotationDiagnostics`` to collect which degenerate boxes
    were fixed and which annotations carry negative coordinates — the
    reference records/prints these (vtu.py:154-166, 182-186); negative
    coordinates are also logged either way.
    """
    annotations_dict: AnnotationsDict = {}
    for i, each in enumerate(raw["annotations"]):
        image_id = str(each["image_id"])
        category_id = each["category_id"]
        bbox = each["bbox"]
        top_left_x, top_left_y, width, height = bbox

        center_x = round(top_left_x + width / 2, 3)
        center_y = round(top_left_y + height / 2, 3)
        # Degenerate boxes: a 0 width/height is set to 1 so the object is
        # not lost (vtu.py:154-166).
        if np.isclose(width, 0):
            width = 1
            if diagnostics is not None:
                diagnostics.fixed_boxes.append(
                    ["Width", i, image_id, category_id, center_x, center_y])
        elif np.isclose(height, 0):
            height = 1
            if diagnostics is not None:
                diagnostics.fixed_boxes.append(
                    ["Height", i, image_id, category_id, center_x, center_y])
        area = round(width * height, 1)

        annotations_dict.setdefault(image_id, []).append(
            [category_id, center_x, center_y, height, width, area])

        # The reference warns on negative top-left coordinates
        # (vtu.py:182-186); kept, but through logging instead of print.
        if top_left_x < 0 or top_left_y < 0:
            logger.warning(
                "Bbox error! Annotation index: %d, image_id: %s, "
                "category_id: %s: bbox coordinates are smaller than 0 "
                "(bbox[0]=%s, bbox[1]=%s)",
                i, image_id, category_id, top_left_x, top_left_y)
            if diagnostics is not None:
                diagnostics.negative_coordinates.append(
                    [i, image_id, category_id, top_left_x, top_left_y])

    reverse = bool(area_descending)
    for key in annotations_dict:
        annotations_dict[key].sort(key=lambda a: a[-1], reverse=reverse)
    return annotations_dict


def load_annotations_dict(path: str) -> AnnotationsDict:
    """Load a pre-extracted {train,val}_annotations_dict.json (the format
    shipped with the reference; see SURVEY.md §0)."""
    with open(path) as f:
        return json.load(f)


def build_annotations_from_instances(path: str,
                                     area_descending: bool = True,
                                     diagnostics: Optional[
                                         AnnotationDiagnostics] = None,
                                     use_native: Optional[bool] = None
                                     ) -> AnnotationsDict:
    """Parse instances_{train,val}2017.json from disk.

    ``use_native=None`` picks the native single-pass C++ parser
    (native/coco_json.cc) when built — it extracts only the annotation
    fields and skips the segmentation bulk, replacing the reference's
    minutes-scale import-time json.load (vtu.py:214-220; measured in
    tools/bench_annotations.py). Output is identical to the pure-Python
    path (tests/test_torch_native_coco_json.py asserts bit-equality).
    """
    if use_native is None:
        use_native = native_parser_available()
    if use_native:
        if not native_parser_available():
            raise RuntimeError(
                "native COCO parser requested but not built; `vtd-torch "
                "doctor` says why")
        with open(path, "rb") as f:
            data = f.read()
        ids_b, cats_b, boxes_b, n = _native_coco_json.parse_instances(data)
        image_ids = np.frombuffer(ids_b, np.int64, n)
        category_ids = np.frombuffer(cats_b, np.int64, n)
        bboxes = np.frombuffer(boxes_b, np.float64, n * 4).reshape(n, 4)
        return _group_annotations(image_ids, category_ids, bboxes,
                                  area_descending, diagnostics)
    with open(path) as f:
        raw = json.load(f)
    return build_annotations_dict(raw, area_descending, diagnostics)


def _group_annotations(image_ids: np.ndarray, category_ids: np.ndarray,
                       bboxes: np.ndarray, area_descending: bool,
                       diagnostics: Optional[AnnotationDiagnostics]
                       ) -> AnnotationsDict:
    """Flat parsed arrays -> annotation dict, replicating
    build_annotations_dict's transforms EXACTLY.

    isclose checks are vectorised; the per-row rounding keeps Python's
    ``round`` (np.round's scaled algorithm diverges from Python's
    correctly-rounded decimals on ties, e.g. round(x, 1) off by 0.1 —
    caught by tests/test_native_coco_json.py). The heavy lifting (the
    JSON parse) already happened natively; this loop is seconds on the
    full train set.
    """
    w_fixed = np.isclose(bboxes[:, 2], 0)
    h_fixed = ~w_fixed & np.isclose(bboxes[:, 3], 0)

    image_id_list = image_ids.tolist()
    category_list = category_ids.tolist()
    bbox_list = bboxes.tolist()
    annotations_dict: AnnotationsDict = {}
    for i, (image_id_int, category_id, bbox) in enumerate(
            zip(image_id_list, category_list, bbox_list)):
        image_id = str(image_id_int)
        top_left_x, top_left_y, width, height = bbox
        center_x = round(top_left_x + width / 2, 3)
        center_y = round(top_left_y + height / 2, 3)
        if w_fixed[i]:
            width = 1
            if diagnostics is not None:
                diagnostics.fixed_boxes.append(
                    ["Width", i, image_id, category_id, center_x, center_y])
        elif h_fixed[i]:
            height = 1
            if diagnostics is not None:
                diagnostics.fixed_boxes.append(
                    ["Height", i, image_id, category_id, center_x, center_y])
        area = round(width * height, 1)
        annotations_dict.setdefault(image_id, []).append(
            [category_id, center_x, center_y, height, width, area])
        if top_left_x < 0 or top_left_y < 0:
            logger.warning(
                "Bbox error! Annotation index: %d, image_id: %s, "
                "category_id: %s: bbox coordinates are smaller than 0 "
                "(bbox[0]=%s, bbox[1]=%s)",
                i, image_id, category_id, top_left_x, top_left_y)
            if diagnostics is not None:
                diagnostics.negative_coordinates.append(
                    [i, image_id, category_id, top_left_x, top_left_y])

    reverse = bool(area_descending)
    for key in annotations_dict:
        annotations_dict[key].sort(key=lambda a: a[-1], reverse=reverse)
    return annotations_dict


def save_annotations_dict(annotations: AnnotationsDict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(annotations, f)


# ---------------------------------------------------------------------------
# Letterbox geometry (vtu.py:305-368)
# ---------------------------------------------------------------------------

def letterbox_params(original_size: Tuple[int, int],
                     model_size: Tuple[int, int]
                     ) -> Tuple[float, float, float]:
    """Resize-with-pad parameters.

    Returns ``(resize_scale, blank_in_height, blank_in_width)`` such that a
    source coordinate maps to ``coord / resize_scale + blank`` in the padded
    model frame. Matches vtu.py:305-323 including the equal-scale branch.
    """
    oh, ow = original_size
    mh, mw = model_size
    width_scale = ow / mw
    height_scale = oh / mh
    blank_h = 0.0
    blank_w = 0.0
    if width_scale > height_scale:
        scale = width_scale
        blank_h = (mh - oh / scale) / 2
    elif width_scale == height_scale:
        scale = width_scale
    else:
        scale = height_scale
        blank_w = (mw - ow / scale) / 2
    return scale, blank_h, blank_w


def letterbox_boxes(boxes: np.ndarray, original_size: Tuple[int, int],
                    model_size: Tuple[int, int]) -> np.ndarray:
    """Map ``(N, 4)`` cxcyhw boxes from source pixels into the letterboxed
    model frame (vectorised vtu.py:352-368)."""
    scale, blank_h, blank_w = letterbox_params(original_size, model_size)
    out = np.asarray(boxes, np.float32) / np.float32(scale)
    # The reference adds the vertical blank when width_scale >= height_scale
    # and the horizontal blank otherwise (vtu.py:363-368); with the other
    # blank being exactly 0 an unconditional add is identical.
    out[:, 0] += np.float32(blank_w)
    out[:, 1] += np.float32(blank_h)
    return out


# ---------------------------------------------------------------------------
# Fixed-slot labels (vtu.py:452-507)
# ---------------------------------------------------------------------------

def labels_from_annotations(
        image_annotations: Optional[Sequence[Sequence[float]]],
        original_size: Tuple[int, int],
        config: DetectorConfig,
        coco_id_to_model_id: Optional[Dict[int, int]] = None) -> np.ndarray:
    """Per-image annotations -> ``(max_objects, 6)`` float32 label tensor.

    Keeps the reference's conventions: annotations arrive area-sorted, only
    detected categories are kept (COCO id -> model id via the embedded
    table), coordinates are letterboxed to the model frame, the first
    ``max_objects`` boxes fill slots in order, empty slots have objectness 0
    and -8 elsewhere (vtu.py:497-505).
    """
    if coco_id_to_model_id is None:
        coco_id_to_model_id = COCO_ID_TO_MODEL_ID

    labels = np.full((config.max_objects, 6), -8.0, np.float32)
    labels[:, 0] = 0.0
    if not image_annotations:
        return labels

    rows = np.asarray(
        [a[:5] for a in image_annotations], np.float32)  # (N, 5)
    if not np.all(rows[:, 0] == np.round(rows[:, 0])):
        # Loud failure at the data boundary (round-4 advisor): a
        # non-integral category would otherwise truncate silently here,
        # while a raw float category reaching the metric deflates that
        # class's AP without erroring (fast_map matches categories by
        # exact value but floors them for the shown-class set).
        bad = rows[rows[:, 0] != np.round(rows[:, 0]), 0][:3]
        raise ValueError(
            f"non-integral category ids in annotations: {bad.tolist()} "
            "— the annotation source is corrupt (COCO category ids are "
            "integers)")
    coco_ids = rows[:, 0].astype(np.int64)
    model_ids = np.asarray(
        [coco_id_to_model_id.get(int(c), -1) for c in coco_ids], np.int64)
    keep = model_ids >= 0
    if not keep.any():
        return labels
    rows, model_ids = rows[keep], model_ids[keep]

    # rows columns: [coco_id, cx, cy, h, w] -> boxes in cxcyhw order.
    boxes = np.stack([rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]], axis=1)
    boxes = letterbox_boxes(boxes, original_size, config.image_size)

    n = min(len(boxes), config.max_objects)
    labels[:n, 0] = 1.0
    labels[:n, 1] = model_ids[:n].astype(np.float32)
    labels[:n, 2] = boxes[:n, 0]  # center_x
    labels[:n, 3] = boxes[:n, 1]  # center_y
    labels[:n, 4] = boxes[:n, 2]  # height
    labels[:n, 5] = boxes[:n, 3]  # width
    return labels
