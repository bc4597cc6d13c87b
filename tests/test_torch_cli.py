"""The port's ``train`` subcommand end to end on a tiny on-disk dataset
(the fixture of tests/test_cli.py: 4 JPEGs with one box each), on the
CPU, then a resumed run from its checkpoints; ``--fused-ffn``; and the
refused flags."""

import json
import os

import numpy as np
import pytest

from vision_transformer_detector_tpu_torch.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("coco")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
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
    ann_path = root / "ann.json"
    ann_path.write_text(json.dumps(annotations))
    return {"images": str(images), "annotations": str(ann_path)}


def _args(dataset, tmp_path, *extra):
    return ["train", "--preset", "tiny_96", "--batch-size", "2",
            "--device", "cpu",
            "--train-images", dataset["images"],
            "--train-annotations", dataset["annotations"],
            "--val-images", dataset["images"],
            "--val-annotations", dataset["annotations"],
            "--learning-rate", "1e-4", "--epochs-warm-up", "0",
            "--skip-epochs", "1", "--keep-checkpoints", "1",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--metrics", str(tmp_path / "metrics.jsonl"), *extra]


def test_train_two_epochs_then_restore(dataset, tmp_path, capsys):
    main(_args(dataset, tmp_path, "--epochs", "2"))
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["best_ap"] <= 1.0
    assert np.isfinite(result["final_loss"])
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(0.0 <= r["ap"] <= 1.0 for r in records)
    names = sorted(os.listdir(tmp_path / "ckpt"))
    # 2 steps per epoch: rolling step_4 kept, step_2 pruned.
    assert {"config.json", "final.pt", "ongoing.pt",
            "step_0000000004.pt"} <= set(names)
    assert "step_0000000002.pt" not in names

    main(_args(dataset, tmp_path, "--epochs", "1", "--restore", "latest"))
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(resumed["final_loss"])
    assert "step_0000000006.pt" in os.listdir(tmp_path / "ckpt")


def test_train_with_fused_ffn(dataset, tmp_path, capsys, monkeypatch):
    """``--fused-ffn`` trains through the fused dense+mish route (its
    plain version on the CPU) of every mish pyramid layer."""
    from vision_transformer_detector_tpu_torch.kernels import fused_ffn

    calls = []
    original = fused_ffn.FusedDenseMishFunction.apply
    monkeypatch.setattr(fused_ffn.FusedDenseMishFunction, "apply",
                        lambda *args: calls.append(1) or original(*args))
    main(_args(dataset, tmp_path, "--epochs", "1", "--fused-ffn"))
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["final_loss"])
    # tiny_96: 2 blocks x 3 encoder layers + 2 head layers per forward.
    assert calls and len(calls) % 8 == 0


@pytest.mark.parametrize("flag", [
    ["--resumable"], ["--distributed"],
    ["--data-parallel", "2"], ["--epochs-per-call", "4"],
    ["--flash-attention", "--no-flash-attention"],
])
def test_train_refuses_unported_flags(dataset, tmp_path, flag):
    with pytest.raises(SystemExit):
        main(_args(dataset, tmp_path, "--epochs", "1", *flag))


def test_train_highres_1024_preset(dataset, tmp_path, capsys, monkeypatch):
    """``train --preset highres_1024`` runs as shipped: bf16, flash,
    windowed attention, the (1, 2, 4) multi-scale head and "alternate"
    remat. A narrow 2-block copy of the preset at 128 px (an 8x8 grid, so
    window 4) keeps it a CPU test."""
    from vision_transformer_detector_tpu_torch import config as port_config

    narrow = port_config.highres_1024().replace(
        embedding_dim=64, num_heads=1, encoder_blocks=2, head_last_units=16,
        head_layers=2, attention_window=4)
    assert narrow.remat_policy == "alternate" and narrow.key_dim == 64
    monkeypatch.setitem(port_config.PRESETS, "highres_1024", lambda: narrow)
    args = _args(dataset, tmp_path, "--epochs", "1", "--image-size", "128")
    args[args.index("tiny_96")] = "highres_1024"
    main(args)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["final_loss"]) and 0 <= result["best_ap"] <= 1
    saved = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    assert saved["detector"]["head_scales"] == [1, 2, 4]
    assert saved["detector"]["attention_window"] == 4
