"""Worked end-to-end walkthrough on the PyTorch port: dataset -> train ->
evaluate (COCO protocol) -> plot -> visualize -> export -> serve from the
artifact.

The port's counterpart of examples/end_to_end.py, which walks the
reference notebook's arc (vision_transformer_detector.ipynb cells 3-18:
build the annotation dict, train with the AP callback, plot the curves,
visualize detections, run predict) through the JAX package. Here every
stage goes through the port's own surface: the `vtd-torch` command line
(``vision_transformer_detector_tpu_torch.cli``) for training, COCO
evaluation, plots, visualization, export and serving, and the
reference-compatible ``api.py`` (``Detector``) to hold the exported
artifact against the live model. The served artifact runs in a `vtd-torch
serve --from-export` process of its own on 127.0.0.1, which the script
stops when it is done.

It runs on the card unless ``--device cpu`` is given, at the tiny_96
preset with flash attention (the kernels on the card, their plain
versions on the CPU), 16 synthetic images and a few epochs: enough to see
every artifact produced, not to converge.

    python examples/end_to_end_torch.py [--workdir DIR] [--epochs 8]
        [--device cuda|cpu]

Prints one JSON line per stage and a final summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PRESET = "tiny_96"
BATCH = 4
SERVE_TIMEOUT_S = 300


def stage(name, **info):
    print(json.dumps({"stage": name, **info}), flush=True)


def flash_launches() -> dict:
    """The flash kernels' launch counts in this process (0 on the CPU,
    where the wrapper takes the plain versions)."""
    from vision_transformer_detector_tpu_torch.kernels.flash_attention import (
        flash_attention)

    return {"forward": flash_attention.launches,
            "forward_lse": flash_attention.lse_launches,
            "backward": flash_attention.backward_launches}


def vtd_torch(*argv) -> dict:
    """One `vtd-torch` subcommand, in this process; its last JSON line."""
    from vision_transformer_detector_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main([str(a) for a in argv])
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("{")]
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# Stage 1 — a small detection dataset on disk.
#
# The reference starts from COCO instances JSON + image files and builds its
# "annotation dict" {image_id: [[category, cx, cy, h, w, area], ...]}
# (vision_transformer_utilities.py:82-220). Here 16 images are synthesised,
# each a textured background with 1-3 solid rectangles, written as JPEGs,
# with matching annotations in the same dict format.
# ---------------------------------------------------------------------------
def build_dataset(image_dir: str, count: int = 16, seed: int = 3):
    from PIL import Image

    # Real COCO category ids (person=1, car=3, dog=18): labels_from_
    # annotations maps them through the embedded 80-category table.
    categories = [1, 3, 18]
    rng = np.random.default_rng(seed)
    os.makedirs(image_dir, exist_ok=True)
    annotations = {}
    for i in range(count):
        h, w = int(rng.integers(80, 160)), int(rng.integers(80, 160))
        img = rng.integers(20, 90, (h, w, 3)).astype(np.uint8)
        records = []
        for _ in range(int(rng.integers(1, 4))):
            bh = float(rng.uniform(h * 0.25, h * 0.6))
            bw = float(rng.uniform(w * 0.25, w * 0.6))
            cy = float(rng.uniform(bh / 2 + 1, h - bh / 2 - 1))
            cx = float(rng.uniform(bw / 2 + 1, w - bw / 2 - 1))
            cat = int(rng.choice(categories))
            y0, y1 = int(cy - bh / 2), int(cy + bh / 2)
            x0, x1 = int(cx - bw / 2), int(cx + bw / 2)
            img[y0:y1, x0:x1] = (40 * cat % 200 + 30, 90 * cat % 200 + 30,
                                 150 * cat % 200 + 30)
            # [category, cx, cy, h, w, area] in original-image pixels,
            # area-sorted like the reference's.
            records.append([cat, cx, cy, bh, bw, bh * bw])
        records.sort(key=lambda r: -r[5])
        image_id = 1000 + i
        Image.fromarray(img).save(
            os.path.join(image_dir, f"{image_id:012d}.jpg"), quality=92)
        annotations[str(image_id)] = records
    return annotations


def _serve_artifact(artifact: str, device: str, jpeg: str) -> dict:
    """`vtd-torch serve --from-export` in a process of its own on an
    ephemeral port of 127.0.0.1; one POST of ``jpeg``; the process is then
    stopped (SIGTERM, its graceful stop) and waited for."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vision_transformer_detector_tpu_torch.cli",
         "serve", "--from-export", artifact, "--device", device,
         "--host", "127.0.0.1", "--port", "0", "--score-threshold", "-1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("the artifact server exited before serving: "
                               + proc.stderr.read()[-3000:])
        base = json.loads(line)["serving"]
        if not base.startswith("http://127.0.0.1:"):
            raise RuntimeError(f"the artifact server listens on {base}")
        with open(jpeg, "rb") as f:
            request = urllib.request.Request(
                f"{base}/predict", data=f.read(),
                headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(request, timeout=SERVE_TIMEOUT_S) as r:
            response = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"response": response, "stats": stats,
            "exit_code": proc.returncode}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=None,
                        help="output directory (default: a temp dir)")
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--images", type=int, default=16)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="vtd_torch_e2e_")
    image_dir = os.path.join(workdir, "images")
    ckpt = os.path.join(workdir, "ckpt")
    metrics = os.path.join(workdir, "metrics.jsonl")
    model = ["--preset", PRESET, "--flash-attention",
             "--checkpoint-dir", ckpt]

    from vision_transformer_detector_tpu_torch import api
    from vision_transformer_detector_tpu_torch.config import get_config
    from vision_transformer_detector_tpu_torch.data.annotations import (
        load_annotations_dict, save_annotations_dict)
    from vision_transformer_detector_tpu_torch.data.pipeline import (
        list_image_paths, load_and_letterbox_image)
    from vision_transformer_detector_tpu_torch.export import load_exported

    annotations = build_dataset(image_dir, args.images)
    ann_path = os.path.join(workdir, "annotations.json")
    save_annotations_dict(annotations, ann_path)     # ships as plain JSON
    annotations = load_annotations_dict(ann_path)    # ... and loads back
    stage("dataset", images=len(annotations), dir=image_dir,
          annotations=ann_path)

    # Stage 2 — train with an eval cadence and best-AP checkpoints (the
    # reference notebook's cell 7: fit with SaveModelHighestAP).
    warm_up = max(1, args.epochs // 2)
    trained = vtd_torch(
        "train", *model, "--device", args.device, "--batch-size", BATCH,
        "--epochs", args.epochs, "--learning-rate", 3e-4,
        "--epochs-warm-up", warm_up, "--skip-epochs", warm_up,
        "--train-images", image_dir, "--train-annotations", ann_path,
        "--val-images", image_dir, "--val-annotations", ann_path,
        "--metrics", metrics)
    stage("train", epochs=args.epochs, device=args.device,
          best_ap=trained["best_ap"], final_loss=trained["final_loss"],
          checkpoints=sorted(os.listdir(ckpt)), launches=flash_launches())

    # Stage 3 — standalone evaluation under the COCO protocol (notebook
    # cell 15's evaluate, scored as pycocotools scores).
    evaluated = vtd_torch(
        "evaluate", *model, "--device", args.device, "--restore", "final",
        "--batch-size", BATCH, "--val-images", image_dir,
        "--val-annotations", ann_path, "--protocol", "coco-original",
        "--dump-detections", os.path.join(workdir, "detections.json"))
    stage("evaluate", protocol=evaluated["protocol"],
          **{k: evaluated[k] for k in ("AP", "AP50", "AP75", "AR@100")},
          detections=os.path.join(workdir, "detections.json"))

    # Stage 4 — the training curves (notebook cells 10-13's loss / AP
    # charts).
    curves = vtd_torch("plot", "--metrics", metrics, "--output",
                       os.path.join(workdir, "curves.html"))
    stage("plot", written=curves["written"])

    # Stage 5 — detections drawn on the images, and a contact sheet (the
    # reference's cv2 viewer, vtd.py:2187-2456, as files).
    viz = os.path.join(workdir, "viz")
    drawn = vtd_torch(
        "visualize", *model, "--device", args.device, "--restore", "final",
        "--batch-size", BATCH, "--images", image_dir, "--output-dir", viz,
        "--objectness-threshold", 0.0, "--classification-threshold", 0.0,
        "--contact-sheet", os.path.join(viz, "sheet.html"))
    stage("visualize", pngs=len(drawn["written"]),
          contact_sheet=drawn["contact_sheet"])

    # Stage 6 — a torch.export artifact of the final weights, traced on
    # this device, held against the live model loaded through api.py from
    # the artifact's own params.npz.
    artifact = os.path.join(workdir, "artifact")
    exported = vtd_torch(
        "export", *model, "--restore", "final", "--output-dir", artifact,
        "--batch-sizes", 1, BATCH, "--platforms", args.device)
    config = get_config(PRESET).replace(use_flash_attention=True)
    paths = list_image_paths(image_dir)
    batch = np.stack([load_and_letterbox_image(p, config)[0]
                      for p in paths[:BATCH]])
    frozen = np.asarray(load_exported(artifact)(batch).float().cpu())
    live = api.Detector.load(os.path.join(artifact, "params.npz"), config,
                             device=args.device).predict_decoded(batch)
    diff = float(np.max(np.abs(frozen - live)))
    if frozen.shape != (BATCH, config.max_objects, 6) or not diff <= 2e-4:
        raise SystemExit(f"export: artifact {frozen.shape} differs from the "
                         f"live model by {diff}")
    stage("export", dir=exported["exported"],
          batch_sizes=exported["batch_size"],
          platforms=exported["platforms"], max_abs_diff=diff)

    # Stage 7 — serve the artifact over HTTP and post one image; the
    # answer is kept as served.json.
    served = _serve_artifact(artifact, args.device, paths[0])
    response = served["response"]
    with open(os.path.join(workdir, "served.json"), "w") as f:
        json.dump(response, f)
    stage("serve", detections=len(response["detections"]),
          image_size=response["image_size"],
          requests_ok=served["stats"]["requests"]["ok"],
          server_exit_code=served["exit_code"], launches=flash_launches())

    summary = {
        "workdir": workdir, "device": args.device,
        "best_ap": trained["best_ap"], "coco_AP": evaluated["AP"],
        "artifacts": ["images/", "annotations.json", "ckpt/",
                      "metrics.jsonl", "detections.json", "curves.html",
                      "viz/", "artifact/", "served.json"],
        "ok": True,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
