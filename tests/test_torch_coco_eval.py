"""The port's copy of the official COCO-protocol evaluator
(vision_transformer_detector_tpu_torch/metrics/coco_eval.py) against the
JAX package's: the hand-derived oracles of tests/test_coco_eval.py run
through both, seeded random scenes give bit-equal summaries, and the two
model-driven evaluators give the JAX package's summary on the same
weights (bridged through params.npz) and the same images. Also the two
repairs of the port's copy: an unevaluated AP50/AP75 is -1.0, and the
evaluators hand a custom eval step uint8 canvases and check what it
returns."""

import json

import jax
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu import config as jax_config
from vision_transformer_detector_tpu.metrics import coco_eval as jax_ce
from vision_transformer_detector_tpu_torch.metrics import coco_eval as port_ce

# Keys the port reports as -1.0 where the JAX copy reports None.
REPAIRED = ("AP50", "AP75")


def _evaluate(module, images, **evaluator_kwargs):
    ev = module.CocoEvaluator(**evaluator_kwargs)
    for image in images:
        ev.add_image(**image)
    return ev.evaluate()


def _one(gt, dets, scores, gt_cats=None, det_cats=None, **kwargs):
    gt = np.asarray(gt, float).reshape(-1, 4)
    dets = np.asarray(dets, float).reshape(-1, 4)
    return [dict(gt_boxes=gt, det_boxes=dets, det_scores=scores,
                 gt_categories=(np.zeros(len(gt), int) if gt_cats is None
                                else gt_cats),
                 det_categories=(np.zeros(len(dets), int) if det_cats is None
                                 else det_cats), **kwargs)]


# (scene, expected summary values), worked out in tests/test_coco_eval.py.
ORACLES = {
    "perfect_match": (
        _one([[10, 10, 50, 40]], [[10, 10, 50, 40]], [0.9]),
        {"AP": 1.0, "AP50": 1.0, "AP75": 1.0, "AR@1": 1.0}),
    "iou_0.6_passes_three_thresholds": (
        _one([[0, 0, 10, 10]], [[0, 0, 10, 6]], [0.9]),
        {"AP": 0.3, "AP50": 1.0, "AP75": 0.0}),
    "low_iou_is_zero": (
        _one([[0, 0, 10, 10]], [[0, 5, 10, 10]], [0.9]), {"AP": 0.0}),
    "trailing_false_positive_is_free": (
        _one([[0, 0, 10, 10]], [[0, 0, 10, 10], [50, 50, 10, 10]],
             [0.9, 0.1]), {"AP": 1.0}),
    "leading_false_positive_halves_ap": (
        _one([[0, 0, 10, 10]], [[0, 0, 10, 10], [50, 50, 10, 10]],
             [0.1, 0.9]), {"AP": 0.5}),
    "missed_gt_truncates_recall": (
        _one([[0, 0, 10, 10], [50, 50, 10, 10]], [[0, 0, 10, 10]], [0.9]),
        {"AP": 51 / 101}),
    "max_dets_caps_recall": (
        _one([[0, 0, 10, 10], [50, 50, 10, 10]],
             [[0, 0, 10, 10], [50, 50, 10, 10]], [0.9, 0.8]),
        {"AR@1": 0.5, "AR@10": 1.0, "AR@100": 1.0, "AP": 1.0}),
    "area_buckets_and_ignore": (
        _one([[0, 0, 10, 10]], [[0, 0, 10, 10]], [0.9]),
        {"AP_small": 1.0, "AP_medium": -1.0, "AP_large": -1.0,
         "AR_small": 1.0}),
    "small_fp_outside_large_bucket": (
        _one([[0, 0, 100, 100]], [[0, 0, 100, 100], [300, 300, 8, 8]],
             [0.9, 0.5]),
        {"AP_large": 1.0, "AP_small": -1.0, "AP": 1.0}),
    "crowd_absorbs_detections": (
        _one([[0, 0, 10, 10], [100, 100, 50, 50]],
             [[0, 0, 10, 10], [110, 110, 10, 10]], [0.9, 0.8],
             gt_iscrowd=[False, True]), {"AP": 1.0}),
    "crowd_matches_many": (
        _one([[100, 100, 50, 50]], [[110, 110, 10, 10], [120, 120, 10, 10]],
             [0.9, 0.8], gt_iscrowd=[True]), {"AP": -1.0}),
    "prefers_higher_iou_gt": (
        _one([[0, 0, 10, 10], [0, 3, 10, 10]],
             [[0, 0, 10, 10], [0, 0, 10, 10]], [0.9, 0.8]),
        {"AP": (1.0 + 9 * (51 / 101)) / 10}),
    "tied_scores_keep_input_order": (
        _one([[0, 0, 10, 10], [50, 50, 10, 10]],
             [[50, 50, 10, 10], [200, 200, 10, 10], [0, 0, 10, 10]],
             [0.5, 0.5, 0.5]), {"AR@1": 0.5, "AR@10": 1.0}),
    "categories_averaged": (
        [dict(gt_boxes=[[0, 0, 10, 10], [50, 50, 10, 10]],
              gt_categories=[0, 1],
              det_boxes=[[0, 0, 10, 10], [80, 80, 10, 10], [0, 0, 5, 5]],
              det_scores=[0.9, 0.9, 0.9], det_categories=[0, 1, 2])],
        {"AP": 0.5}),
    "streaming_over_images": (
        _one([[0, 0, 10, 10]], [[0, 0, 10, 6]], [0.9])
        + _one([[20, 20, 8, 8]], [[20, 20, 8, 8]], [0.8]),
        {"AP": (3 * 1.0 + 7 * (51 * 0.5 / 101)) / 10}),
}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_oracle_scenes_score_the_same_in_both_packages(name):
    images, expected = ORACLES[name]
    port = _evaluate(port_ce, images).summarize()
    ref = _evaluate(jax_ce, images).summarize()
    for key, value in expected.items():
        assert port[key] == pytest.approx(value), key
    assert port == ref


def _random_scene(rng, num_images=12, num_classes=4, ties=False):
    images = []
    for _ in range(num_images):
        n_gt = int(rng.integers(0, 6))
        gt = np.column_stack([rng.uniform(0, 300, (n_gt, 2)),
                              rng.uniform(4, 150, (n_gt, 2))])
        jitter = gt + rng.normal(0, 6, gt.shape)
        extra = np.column_stack([rng.uniform(0, 300, (3, 2)),
                                 rng.uniform(4, 150, (3, 2))])
        dets = np.concatenate([jitter, extra])
        dets[:, 2:] = np.abs(dets[:, 2:]) + 1
        scores = (rng.integers(1, 4, len(dets)) / 4.0 if ties
                  else rng.uniform(0.05, 1.0, len(dets)))
        images.append(dict(
            gt_boxes=gt, gt_categories=rng.integers(0, num_classes, n_gt),
            gt_iscrowd=rng.uniform(size=n_gt) < 0.15,
            det_boxes=dets, det_scores=scores,
            det_categories=rng.integers(0, num_classes, len(dets))))
    return images


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_random_scenes_give_bit_equal_summaries(seed, ties):
    images = _random_scene(np.random.default_rng(seed), ties=ties)
    port, ref = (_evaluate(m, images) for m in (port_ce, jax_ce))
    np.testing.assert_array_equal(port.precision, ref.precision)
    np.testing.assert_array_equal(port.recall, ref.recall)
    assert port.summarize() == ref.summarize()
    assert port.per_category() == ref.per_category()


def test_unevaluated_ap50_ap75_are_minus_one_as_in_pycocotools():
    """The repair of the JAX copy's None (metrics/coco_eval.py:249): with
    thresholds that leave out 0.5 and 0.75, the port reports -1.0 and
    every other key as the JAX package does."""
    images = _random_scene(np.random.default_rng(5))
    thresholds = (0.6, 0.7, 0.8)
    port = _evaluate(port_ce, images, iou_thresholds=thresholds).summarize()
    ref = _evaluate(jax_ce, images, iou_thresholds=thresholds).summarize()
    for key in REPAIRED:
        assert ref[key] is None and port[key] == -1.0
    assert {k: v for k, v in port.items() if k not in REPAIRED} == {
        k: v for k, v in ref.items() if k not in REPAIRED}


def test_native_matcher_is_not_ported(monkeypatch):
    """(The name predates the port's own matcher core.) ``use_native``
    follows the JAX semantics: None takes the core when it is built (it
    builds on this host), False the NumPy matcher, and True without a
    built core raises."""
    assert port_ce.native_matcher_available()
    assert port_ce.CocoEvaluator().use_native is True
    assert port_ce.CocoEvaluator(use_native=False).use_native is False
    monkeypatch.setattr(port_ce._native_coco_eval, "available",
                        lambda: False)
    assert port_ce.CocoEvaluator().use_native is False
    with pytest.raises(RuntimeError, match="native matcher"):
        port_ce.CocoEvaluator(use_native=True)


@pytest.mark.parametrize("fmt", ["instances", "dict"])
def test_score_coco_results_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    images = _random_scene(rng, num_images=6)
    results, gt = [], {"images": [], "annotations": []}
    ann_dict = {}
    for i, image in enumerate(images):
        gt["images"].append({"id": i})
        ann_dict[str(i)] = []
        for box, cat in zip(image["gt_boxes"], image["gt_categories"]):
            x, y, w, h = (float(v) for v in box)
            gt["annotations"].append({"image_id": i, "category_id": int(cat),
                                      "bbox": [x, y, w, h], "area": w * h,
                                      "iscrowd": 0})
            ann_dict[str(i)].append([int(cat), x + w / 2, y + h / 2, h, w,
                                     w * h])
        for box, score, cat in zip(image["det_boxes"], image["det_scores"],
                                   image["det_categories"]):
            results.append({"image_id": i, "category_id": int(cat),
                            "bbox": [float(v) for v in box],
                            "score": float(score)})
    ann_path = tmp_path / "gt.json"
    ann_path.write_text(json.dumps(gt if fmt == "instances" else ann_dict))
    res_path = tmp_path / "dt.json"
    res_path.write_text(json.dumps(results))
    port = port_ce.score_coco_results(str(ann_path), str(res_path),
                                      per_category=True)
    ref = jax_ce.score_coco_results(str(ann_path), str(res_path),
                                    per_category=True)
    assert port == ref and 0.0 < port["AP"] < 1.0


def test_perfect_detector_scores_ap_one(tmp_path):
    """Ground truth rewritten as results (tools/make_sanity_detections.py
    --mode perfect) scores AP 1.0 through the port's scorer."""
    annotations = {"1": [[1, 50.0, 40.0, 30.0, 20.0, 600.0],
                         [3, 120.0, 90.0, 60.0, 80.0, 4800.0]],
                   "2": [[18, 200.0, 150.0, 120.0, 140.0, 16800.0]]}
    results = [{"image_id": int(i), "category_id": cat,
                "bbox": [cx - w / 2, cy - h / 2, w, h], "score": 1.0}
               for i, rows in annotations.items()
               for cat, cx, cy, h, w, _ in rows]
    (tmp_path / "gt.json").write_text(json.dumps(annotations))
    (tmp_path / "dt.json").write_text(json.dumps(results))
    summary = port_ce.score_coco_results(str(tmp_path / "gt.json"),
                                         str(tmp_path / "dt.json"))
    assert summary["AP"] == 1.0 and summary["AP50"] == 1.0


# ---------------------------------------------------------------------------
# The model-driven evaluators, on weights bridged from the JAX package


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """tiny_96 weights made by the JAX package, loaded into the port."""
    from vision_transformer_detector_tpu.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu.utils.checkpoint import (
        save_params_npz)
    from vision_transformer_detector_tpu_torch.utils.checkpoint import (
        load_params_npz)

    config = jax_config.get_config("tiny_96")
    jax_params = init_params(jax.random.PRNGKey(0), config)
    path = str(tmp_path_factory.mktemp("bridge") / "params.npz")
    save_params_npz(path, jax_params)
    from vision_transformer_detector_tpu_torch import config as port_config
    port_config_ = port_config.get_config("tiny_96")
    return config, jax_params, port_config_, load_params_npz(path,
                                                             port_config_)


def test_evaluate_coco_protocol_matches_jax(bridged):
    """Letterboxed-frame protocol over uint8 batches: the ground truth is
    the JAX model's own confident predictions, so the summary is far from
    0, and the port's model reproduces it."""
    from vision_transformer_detector_tpu.train.trainer import (
        make_eval_step as jax_eval_step)

    config, jax_params, port_config_, port_params = bridged
    rng = np.random.default_rng(0)
    h, w = config.image_size
    dataset = []
    for _ in range(2):
        images = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
        decoded = np.asarray(jax_eval_step(config)(jax_params,
                                                   jax.numpy.asarray(images)))
        labels = np.full(decoded.shape, -8.0, np.float32)
        labels[..., 0] = 0.0
        top = np.argsort(-decoded[..., 0], axis=1)[:, :3]
        for i in range(len(images)):
            labels[i, :3] = decoded[i, top[i]]
            labels[i, :3, 0] = 1.0
            labels[i, :3, 1] = np.round(labels[i, :3, 1])
        dataset.append((images, labels))
    ref = jax_ce.evaluate_coco_protocol(jax_params, dataset, config,
                                        per_category=True)
    port = port_ce.evaluate_coco_protocol(port_params, dataset, port_config_,
                                          per_category=True)
    assert ref["AP50"] > 0.2
    assert port.keys() == ref.keys()
    for key in ref:
        if key == "AP_per_category":
            for cat in ref[key]:
                assert port[key][cat] == pytest.approx(ref[key][cat],
                                                       abs=1e-6)
        else:
            assert port[key] == pytest.approx(ref[key], abs=1e-6), key


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("coco_original")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(4)
    annotations = {}
    for i, (hh, ww) in enumerate(((80, 120), (100, 60), (96, 96))):
        img = Image.new("RGB", (ww, hh), (20, 30, 40))
        draw = ImageDraw.Draw(img)
        x0, y0 = int(rng.integers(2, ww // 3)), int(rng.integers(2, hh // 3))
        draw.rectangle((x0, y0, x0 + ww // 3, y0 + hh // 3),
                       fill=(250, 220, 30))
        img.save(images / f"{i + 1:012d}.jpg")
        annotations[str(i + 1)] = [
            [1, x0 + ww / 6, y0 + hh / 6, hh / 3, ww / 3, ww * hh / 9]]
    return str(images), annotations


def test_original_frame_protocol_matches_jax(bridged, jpeg_dir, tmp_path,
                                            monkeypatch):
    """Original-frame protocol through the default eval steps: the same
    summary within 1e-6 and the same dumped detections, up to the dump's
    rounding (0.01 px, 1e-5 in score) and the two fp32 forwards' agreement
    (decoded classes within ~2.3e-5, which the class confidence in the
    score doubles). Both packages are held to the PIL decode core."""
    from vision_transformer_detector_tpu.data import pipeline as jax_pipeline
    from vision_transformer_detector_tpu_torch.data import (
        pipeline as port_pipeline)

    monkeypatch.setattr(jax_pipeline, "_native_pipeline", None)
    monkeypatch.setattr(port_pipeline, "native_available", lambda: False)
    config, jax_params, port_config_, port_params = bridged
    image_dir, annotations = jpeg_dir
    dumps = {name: str(tmp_path / f"{name}.json") for name in ("jax", "port")}
    ref = jax_ce.evaluate_coco_protocol_original_frame(
        jax_params, image_dir, annotations, config, batch_size=2,
        dump_detections=dumps["jax"])
    port = port_ce.evaluate_coco_protocol_original_frame(
        port_params, image_dir, annotations, port_config_, batch_size=2,
        dump_detections=dumps["port"])
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key] == pytest.approx(ref[key], abs=1e-6), key
    got, want = (json.load(open(dumps[n])) for n in ("port", "jax"))
    assert len(got) == len(want) == 3 * config.max_objects
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                     w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=0.011)
        assert g["score"] == pytest.approx(w["score"], abs=1e-4)


def test_evaluators_hand_a_custom_step_uint8_canvases(bridged, jpeg_dir):
    """The repair of metrics/coco_eval.py:626: a custom eval step gets the
    uint8 canvases on the model's device; one that normalizes them as the
    default step does gives the default summary, and one that returns the
    wrong shape is refused."""
    from vision_transformer_detector_tpu_torch.train.trainer import (
        make_eval_step)

    _, _, port_config_, port_params = bridged
    image_dir, annotations = jpeg_dir
    default = make_eval_step(port_config_)
    seen = []

    def custom(params, images):
        seen.append((images.dtype, images.device))
        return default(params, images.float() / 127.5 - 1.0)

    want = port_ce.evaluate_coco_protocol_original_frame(
        port_params, image_dir, annotations, port_config_, batch_size=2)
    got = port_ce.evaluate_coco_protocol_original_frame(
        port_params, image_dir, annotations, port_config_, batch_size=2,
        eval_step=custom)
    assert seen and all(s == (torch.uint8, torch.device("cpu"))
                        for s in seen)
    assert got == want
    with pytest.raises(ValueError, match="eval_step must return"):
        port_ce.evaluate_coco_protocol_original_frame(
            port_params, image_dir, annotations, port_config_, batch_size=2,
            eval_step=lambda params, images: default(params, images)[:, 0])
