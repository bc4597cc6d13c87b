"""The port's deployment lifecycle in one test, the twin of
tests/test_lifecycle.py through ``vtd-torch ... --device cpu``: CLI train
-> checkpoint -> CLI evaluate under the COCO protocol with a dump, and
score-coco of the dump -> CLI export (a torch.export bundle with a baked
postprocess, traced on the CPU) -> HTTP serving from the artifact ->
official-protocol scoring of the served responses."""

import json
import urllib.request

import numpy as np
import pytest

from vision_transformer_detector_tpu_torch.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("coco_lifecycle")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(7)
    annotations = {}
    for i in range(4):
        img = Image.new("RGB", (96, 80), (20, 30, 40))
        draw = ImageDraw.Draw(img)
        x0, y0 = int(rng.integers(5, 40)), int(rng.integers(5, 30))
        w, h = 30, 28
        draw.rectangle((x0, y0, x0 + w, y0 + h), fill=(250, 220, 30))
        img.save(images / f"{i:012d}.jpg")
        annotations[str(i)] = [
            [1, x0 + w / 2, y0 + h / 2, float(h), float(w), float(w * h)]]
    (root / "ann.json").write_text(json.dumps(annotations))
    return {"images": images, "annotations": annotations, "root": root}


def _valid(summary):
    for key in ("AP", "AP50", "AR@1", "AR@100"):
        assert summary[key] == -1.0 or 0.0 <= summary[key] <= 1.0, key
    assert summary["AP"] <= summary["AP50"] or summary["AP50"] == -1.0


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_evaluate_export_serve_score(dataset, tmp_path, capsys):
    from vision_transformer_detector_tpu_torch.data.categories import (
        COCO_ID_TO_MODEL_ID)
    from vision_transformer_detector_tpu_torch.metrics.coco_eval import (
        CocoEvaluator)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionServer, ExportedDetectionService)

    ckpt = str(tmp_path / "ckpt")
    artifact = str(tmp_path / "artifact")
    ann = str(dataset["root"] / "ann.json")
    common = ["--preset", "tiny_96", "--checkpoint-dir", ckpt]

    # 1. Train a couple of epochs through the CLI.
    main(["train", *common, "--batch-size", "4", "--device", "cpu",
          "--train-images", str(dataset["images"]),
          "--train-annotations", ann, "--epochs", "2",
          "--learning-rate", "1e-4", "--metrics",
          str(tmp_path / "metrics.jsonl")])
    assert np.isfinite(_last_json(capsys)["final_loss"])

    # 2. Evaluate the checkpoint under the COCO protocol in source pixels,
    #    dump the detections, and score the dump on its own.
    dump = str(tmp_path / "dets.json")
    main(["evaluate", *common, "--restore", "final", "--device", "cpu",
          "--batch-size", "4", "--val-images", str(dataset["images"]),
          "--val-annotations", ann, "--protocol", "coco-original",
          "--dump-detections", dump])
    evaluated = _last_json(capsys)
    assert evaluated["protocol"] == "coco-original"
    assert evaluated["dumped_detections"] == dump
    main(["score-coco", "--annotations", ann, "--results", dump])
    scored = _last_json(capsys)
    for summary in (evaluated, scored):
        _valid(summary)
    # The dump rounds boxes to 0.01 px and scores to 1e-5.
    assert abs(scored["AP"] - evaluated["AP"]) <= 0.02
    assert abs(scored["AP50"] - evaluated["AP50"]) <= 0.02

    # 3. Export the trained checkpoint as a multi-batch bundle with
    #    NMS/top-k baked into the graphs, traced on the CPU.
    main(["export", *common, "--restore", "final", "--output-dir", artifact,
          "--batch-sizes", "1", "2", "--bake-postprocess",
          "--score-threshold", "-1.0", "--platforms", "cpu"])
    result = _last_json(capsys)
    assert result["exported"] == artifact
    assert result["platforms"] == ["cpu"]
    assert result["postprocess"]["score_threshold"] == -1.0

    # 4. Serve the artifact over real HTTP and post every image.
    service = ExportedDetectionService(artifact, score_threshold=-1.0)
    server = DetectionServer(service, port=0, batching=True, max_batch=2)
    responses = {}
    try:
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        for path in sorted(dataset["images"].iterdir()):
            req = urllib.request.Request(
                f"{base}/predict", data=path.read_bytes(),
                headers={"Content-Type": "image/jpeg"})
            with urllib.request.urlopen(req, timeout=120) as r:
                responses[path.stem.lstrip("0") or "0"] = json.loads(
                    r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.stop()
    assert stats["requests"]["ok"] == 4
    assert stats["batching"]["images_served"] == 4

    # 5. Score the served detections (original-frame pixels) against the
    #    dataset's ground truth with the official-protocol evaluator.
    evaluator = CocoEvaluator()
    for image_id, annotation_rows in dataset["annotations"].items():
        body = responses[image_id]
        assert body["image_size"] == {"height": 80, "width": 96}
        det_boxes = [(d["box"]["cx"] - d["box"]["w"] / 2.0,
                      d["box"]["cy"] - d["box"]["h"] / 2.0,
                      d["box"]["w"], d["box"]["h"])
                     for d in body["detections"]]
        evaluator.add_image(
            gt_boxes=np.asarray([(cx - w / 2.0, cy - h / 2.0, w, h)
                                 for _, cx, cy, h, w, _ in annotation_rows],
                                np.float64).reshape(-1, 4),
            gt_categories=[COCO_ID_TO_MODEL_ID[int(row[0])]
                           for row in annotation_rows],
            gt_areas=[row[5] for row in annotation_rows],
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=[d["score"] for d in body["detections"]],
            det_categories=[d["class_id"] for d in body["detections"]])
    # A 2-epoch model has no accuracy to assert; the claim is that the
    # whole chain produces protocol-valid numbers.
    _valid(evaluator.evaluate().summarize())
