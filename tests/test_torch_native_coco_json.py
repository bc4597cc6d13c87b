"""The port's native COCO cores (native/coco_json.cc and native/coco_eval.cc
of vision_transformer_detector_tpu_torch) against their Python paths and
against the JAX package's built cores, on the same seeded inputs.

The counterpart of tests/test_native_coco_json.py and of the native
matcher cases of tests/test_coco_eval.py: the parser gives the annotation
dict of the pure-Python path bit for bit, and the same flat arrays (or the
same error) as the JAX package's parser; the matcher gives the NumPy
matcher's precision and recall exactly, and the JAX package's matcher's
masks byte for byte. The cores build on this host at their first use.
"""

import json
import locale

import numpy as np
import pytest

from vision_transformer_detector_tpu._native import (
    _native_coco_eval as jax_match, _native_coco_json as jax_json)
from vision_transformer_detector_tpu_torch._native import (
    _native_coco_eval as port_match, _native_coco_json as port_json)
from vision_transformer_detector_tpu_torch.data import annotations as ann
from vision_transformer_detector_tpu_torch.metrics.coco_eval import (
    AREA_RANGES, CocoEvaluator, native_matcher_available)


def synthetic_instances():
    """A seeded instances file with escapes, nested segmentation arrays,
    scientific notation and the degenerate / negative-coordinate boxes."""
    rng = np.random.default_rng(7)
    annotations = []
    for i in range(500):
        image_id = int(rng.integers(1, 40))
        w = float(np.round(rng.uniform(0, 120), 2))
        h = float(np.round(rng.uniform(0, 120), 2))
        if i % 37 == 0:
            w = 0.0          # degenerate width branch
        elif i % 41 == 0:
            h = 0.0          # degenerate height branch
        x = float(np.round(rng.uniform(-2, 500), 2))  # some negative coords
        y = float(np.round(rng.uniform(0, 500), 2))
        annotations.append({
            "segmentation": [[float(v) for v in rng.uniform(0, 600, 8)]],
            "area": w * h,
            "iscrowd": int(i % 19 == 0),
            "image_id": image_id,
            "bbox": [x, y, w, h],
            "category_id": int(rng.integers(1, 91)),
            "id": 10_000 + i,
        })
    return {
        "info": {"description": "synthetic \"escaped\" \\ test\n set",
                 "version": 1.0e0, "year": 2026, "nested": {"a": [1, [2]]}},
        "licenses": [{"url": "http://example.com/?a=b&c=d", "id": 1}],
        "images": [{"id": i, "file_name": f"{i:012d}.jpg",
                    "height": 480, "width": 640} for i in range(1, 41)],
        "annotations": annotations,
        "categories": [{"supercategory": "thing", "id": c,
                        "name": f"cat-{c}"} for c in range(1, 91)],
    }


@pytest.fixture
def instances_path(tmp_path):
    path = tmp_path / "instances_synthetic.json"
    path.write_text(json.dumps(synthetic_instances()))
    return str(path)


def _both(doc: bytes):
    """(port, JAX) parse of ``doc``: the flat arrays, or the ValueError's
    message."""
    out = []
    for core in (port_json, jax_json):
        try:
            ids, cats, boxes, n = core.parse_instances(doc)
        except ValueError as exc:
            out.append(("error", str(exc)))
            continue
        out.append(("ok", np.frombuffer(ids, np.int64, n).tolist(),
                    np.frombuffer(cats, np.int64, n).tolist(),
                    np.frombuffer(boxes, np.float64, 4 * n).tobytes()))
    return out


def test_native_matches_python(instances_path):
    assert ann.native_parser_available()
    d_py = ann.build_annotations_from_instances(
        instances_path, use_native=False)
    d_nat = ann.build_annotations_from_instances(
        instances_path, use_native=True)
    assert d_py.keys() == d_nat.keys()
    for key in d_py:
        assert len(d_py[key]) == len(d_nat[key])
        np.testing.assert_array_equal(
            np.asarray(d_py[key], np.float64),
            np.asarray(d_nat[key], np.float64), err_msg=f"image {key}")


def test_native_arrays_equal_the_jax_core(instances_path):
    with open(instances_path, "rb") as f:
        doc = f.read()
    port, ref = _both(doc)
    assert port[0] == "ok" and len(port[1]) == 500
    assert port == ref


def test_native_diagnostics_match(instances_path):
    diag_py = ann.AnnotationDiagnostics()
    diag_nat = ann.AnnotationDiagnostics()
    ann.build_annotations_from_instances(
        instances_path, use_native=False, diagnostics=diag_py)
    ann.build_annotations_from_instances(
        instances_path, use_native=True, diagnostics=diag_nat)
    assert diag_py.summary() == diag_nat.summary()
    assert diag_py.summary()["fixed_boxes"] > 0
    assert diag_py.summary()["negative_coordinates"] > 0
    assert diag_py.fixed_boxes == diag_nat.fixed_boxes
    assert diag_py.negative_coordinates == diag_nat.negative_coordinates


def test_native_area_sort_descending_and_ascending(instances_path):
    for descending in (True, False):
        d = ann.build_annotations_from_instances(
            instances_path, use_native=True, area_descending=descending)
        for rows in d.values():
            areas = [r[-1] for r in rows]
            assert areas == sorted(areas, reverse=descending)


def test_use_native_true_without_the_core_raises(instances_path,
                                                 monkeypatch):
    monkeypatch.setattr(port_json, "available", lambda: False)
    assert not ann.native_parser_available()
    with pytest.raises(RuntimeError, match="not built"):
        ann.build_annotations_from_instances(instances_path,
                                             use_native=True)
    # None takes the Python path, with the same dict.
    assert ann.build_annotations_from_instances(instances_path) == (
        ann.build_annotations_from_instances(instances_path,
                                             use_native=False))


# Documents the parser must take or refuse as the JAX core does: the
# malformed, the short or long bbox, the missing keys, ids outside int64,
# and Python's json literals in skipped fields.
_ANN = b'{"image_id": 1, "category_id": 2, "bbox": [1.0, 2.0, 3.0, 4.0]}'
EDGE_DOCS = {
    "malformed": b'{"annotations": [{"bbox": }]}',
    "bbox_short": b'{"annotations": [{"image_id": 1, "category_id": 2, '
                  b'"bbox": [1.0, 2.0]}]}',
    "bbox_empty": b'{"annotations": [{"image_id": 1, "category_id": 2, '
                  b'"bbox": []}]}',
    "bbox_long": b'{"annotations": [{"image_id": 1, "category_id": 2, '
                 b'"bbox": [1, 2, 3, 4, 5]}]}',
    "no_image_id": b'{"annotations": [{"category_id": 2, '
                   b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "no_category_id": b'{"annotations": [{"image_id": 1, '
                      b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "no_bbox": b'{"annotations": [{"image_id": 1, "category_id": 2}]}',
    "id_1e30": b'{"annotations": [{"image_id": 1e30, "category_id": 2, '
               b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "id_minus_1e30": b'{"annotations": [{"image_id": -1e30, '
                     b'"category_id": 2, "bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "id_nan": b'{"annotations": [{"image_id": NaN, "category_id": 2, '
              b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "overflowing_literal": b'{"annotations": [{"image_id": 1, '
                           b'"category_id": 2, "area": 1e400, '
                           b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "python_literals": b'{"info": {"x": Infinity, "y": -Infinity, '
                       b'"z": NaN}, "annotations": [{"image_id": 1, '
                       b'"category_id": 2, "score": NaN, '
                       b'"bbox": [1.0, 2.0, 3.0, 4.0]}]}',
    "empty_list": b'{"annotations": []}',
    "empty_object": b'{}',
    "escaped_key": b'{"annot\\"ations": [1], "annotations": [' + _ANN
                   + b']}',
    "unterminated": b'{"annotations": [' + _ANN,
    "not_json": b'not json',
    "empty": b'',
}
REFUSED = {"malformed", "bbox_short", "bbox_empty", "bbox_long",
           "no_image_id", "no_category_id", "no_bbox", "id_1e30",
           "id_minus_1e30", "id_nan", "unterminated", "not_json", "empty"}


@pytest.mark.parametrize("name", sorted(EDGE_DOCS))
def test_native_edge_documents_as_the_jax_core(name):
    port, ref = _both(EDGE_DOCS[name])
    assert port == ref
    assert (port[0] == "error") == (name in REFUSED)
    if name in ("overflowing_literal", "python_literals", "escaped_key"):
        assert len(port[1]) == 1
    if name in ("empty_list", "empty_object"):
        assert port[1] == []


def test_native_takes_bytes_only():
    with pytest.raises(TypeError):
        port_json.parse_instances('{"annotations": []}')


def test_native_locale_independent_numbers(instances_path):
    baseline = ann.build_annotations_from_instances(
        instances_path, use_native=True)
    for loc in ("de_DE.UTF-8", "fr_FR.UTF-8", "C.UTF-8"):
        try:
            locale.setlocale(locale.LC_NUMERIC, loc)
        except locale.Error:
            continue
        try:
            again = ann.build_annotations_from_instances(
                instances_path, use_native=True)
        finally:
            locale.setlocale(locale.LC_NUMERIC, "C")
        assert again == baseline


# ---------------------------------------------------------------------------
# The matcher core

def _random_scene(rng):
    n_gt = int(rng.integers(0, 8))
    n_dt = int(rng.integers(0, 25))
    gt_boxes = rng.uniform(0, 500, (n_gt, 4))
    gt_boxes[:, 2:] = rng.uniform(0, 120, (n_gt, 2))  # some 0-area
    dt_boxes = rng.uniform(0, 500, (n_dt, 4))
    dt_boxes[:, 2:] = rng.uniform(0, 120, (n_dt, 2))
    return dict(
        gt_boxes=gt_boxes, gt_categories=rng.integers(1, 12, n_gt),
        det_boxes=dt_boxes, det_categories=rng.integers(1, 12, n_dt),
        # Two-decimal scores force ranking ties.
        det_scores=np.round(rng.uniform(0, 1, n_dt), 2),
        gt_iscrowd=rng.uniform(size=n_gt) < 0.2)


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_native_matcher_bit_equal_randomized(seed):
    """The port's matcher core against the NumPy matcher: EXACT precision
    and recall, on scenes with crowds, tied scores, tied IoUs, zero-area
    boxes, empty images and det-only / gt-only categories."""
    assert native_matcher_available()
    evs = {flag: CocoEvaluator(use_native=flag) for flag in (True, False)}
    rng = np.random.default_rng(seed)
    for _ in range(120):
        scene = _random_scene(rng)
        for ev in evs.values():
            ev.add_image(**scene)
    got, want = evs[True].evaluate(), evs[False].evaluate()
    np.testing.assert_array_equal(got.precision, want.precision)
    np.testing.assert_array_equal(got.recall, want.recall)


def test_native_matcher_duplicate_boxes_and_identical_ious():
    """Identical boxes and scores against identical ground truths: the
    greedy matcher's last-max-wins / first-det-first order agrees."""
    gt = np.array([[10.0, 10, 20, 20], [10, 10, 20, 20]])
    det = np.array([[10.0, 10, 20, 20]] * 3)
    results = []
    for flag in (True, False):
        ev = CocoEvaluator(use_native=flag)
        ev.add_image(gt_boxes=gt, gt_categories=[1, 1],
                     det_boxes=det, det_categories=[1, 1, 1],
                     det_scores=[0.5, 0.5, 0.5])
        results.append(ev.evaluate())
    np.testing.assert_array_equal(results[0].precision,
                                  results[1].precision)
    np.testing.assert_array_equal(results[0].recall, results[1].recall)
    assert results[0].ap(iou=0.5) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matcher_masks_equal_the_jax_core(seed):
    """match_image of the two packages' cores on the same seeded boxes:
    the same match and ignore masks and positive counts, byte for byte."""
    rng = np.random.default_rng(seed)
    ranges = np.ascontiguousarray(list(AREA_RANGES.values()), np.float64)
    thresholds = np.linspace(0.5, 0.95, 10)
    for _ in range(50):
        scene = _random_scene(rng)
        n_gt = len(scene["gt_boxes"])
        args = (np.ascontiguousarray(scene["det_boxes"], np.float64),
                np.ascontiguousarray(scene["gt_boxes"], np.float64),
                np.ascontiguousarray(scene["gt_iscrowd"]),
                rng.uniform(0, 12000, n_gt), ranges, thresholds)
        got = port_match.match_image(*args)
        want = jax_match.match_image(*args)
        for a, b, dtype in zip(got, want, (np.uint8, np.uint8, np.int64)):
            assert np.array_equal(np.asarray(a), np.frombuffer(b, dtype))


def test_native_matcher_refuses_what_the_jax_core_refuses():
    """The buffer checks of the JAX extension's glue, kept in the port's
    wrapper: sizes that are not whole boxes or rows, and ground-truth
    buffers of different lengths."""
    box = np.zeros((1, 4))
    ranges = np.zeros((1, 2))
    thr = np.array([0.5])
    for args in ((np.zeros(3), box, np.zeros(1, np.uint8), np.zeros(1),
                  ranges, thr),
                 (box, box, np.zeros(2, np.uint8), np.zeros(1), ranges,
                  thr),
                 (box, box, np.zeros(1, np.uint8), np.zeros(1),
                  np.zeros(3), thr)):
        messages = []
        for core in (port_match, jax_match):
            with pytest.raises(ValueError) as exc:
                core.match_image(*args)
            messages.append(str(exc.value))
        assert messages[0] == messages[1]


def test_use_native_flag_validation(monkeypatch):
    assert CocoEvaluator().use_native is True
    assert CocoEvaluator(use_native=False).use_native is False
    monkeypatch.setattr(port_match, "available", lambda: False)
    assert CocoEvaluator().use_native is False
    with pytest.raises(RuntimeError):
        CocoEvaluator(use_native=True)
