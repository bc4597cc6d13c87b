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
    ["--distributed"], ["--model-parallel", "2", "--device", "cuda"],
    ["--flash-attention", "--no-flash-attention"],
])
def test_train_refuses_unported_flags(dataset, tmp_path, flag):
    """``--distributed`` without a coordinator (or torchrun's
    environment), a CUDA mesh larger than the visible cards (as JAX
    refuses a mesh larger than its devices; a model axis trains tensor
    parallel, tests/test_torch_tp.py) and contradictory attention flags
    are refused; the mesh runs are in tests/test_torch_parallel_cli.py."""
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


# ---------------------------------------------------------------------------
# The lifecycle subcommands: evaluate, score-coco, predict, visualize,
# export, serve --from-export, plot, stats


@pytest.fixture(scope="module")
def bridged_npz(tmp_path_factory):
    """tiny_96 weights made by the JAX package, as a params.npz file."""
    import jax

    from vision_transformer_detector_tpu.config import get_config
    from vision_transformer_detector_tpu.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu.utils.checkpoint import (
        save_params_npz)

    path = str(tmp_path_factory.mktemp("npz") / "params.npz")
    save_params_npz(path, init_params(jax.random.PRNGKey(0),
                                      get_config("tiny_96")))
    return path


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _model(npz, *extra):
    return ["--preset", "tiny_96", "--params-npz", npz, "--device", "cpu",
            "--batch-size", "2", *extra]


def test_evaluate_custom_and_coco_protocols(dataset, bridged_npz, capsys):
    data = ["--val-images", dataset["images"],
            "--val-annotations", dataset["annotations"]]
    main(["evaluate", *_model(bridged_npz), *data])
    assert 0.0 <= _last(capsys)["mAP"] <= 1.0
    main(["evaluate", *_model(bridged_npz), *data, "--protocol", "coco",
          "--per-category"])
    result = _last(capsys)
    assert result["protocol"] == "coco"
    assert set(result["AP_per_category"]) >= {"0"}
    for key in ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100"):
        assert result[key] == -1.0 or 0.0 <= result[key] <= 1.0
    with pytest.raises(SystemExit):
        main(["evaluate", *_model(bridged_npz), *data,
              "--dump-detections", "x.json"])
    with pytest.raises(SystemExit):
        main(["evaluate", *_model(bridged_npz), *data, "--distributed"])


def test_evaluate_coco_original_dump_rescored_by_score_coco(
        dataset, bridged_npz, tmp_path, capsys):
    dump = str(tmp_path / "dets.json")
    main(["evaluate", *_model(bridged_npz), "--val-images",
          dataset["images"], "--val-annotations", dataset["annotations"],
          "--protocol", "coco-original", "--dump-detections", dump])
    evaluated = _last(capsys)
    assert len(json.load(open(dump))) == 4 * 17
    main(["score-coco", "--annotations", dataset["annotations"],
          "--results", dump, "--per-category"])
    scored = _last(capsys)
    assert scored["protocol"] == "coco" and "AP_per_category" in scored
    assert abs(scored["AP"] - evaluated["AP"]) <= 0.02


def test_predict_matches_the_jax_cli(dataset, bridged_npz, capsys,
                                     monkeypatch):
    """The same weights and images through both CLIs' ``predict``: the
    decoded detections agree within 1e-4 (relative for the pixel-valued
    columns). Both packages are held to the PIL decode core."""
    from vision_transformer_detector_tpu.cli import main as jax_main
    from vision_transformer_detector_tpu.data import pipeline as jax_pipeline
    from vision_transformer_detector_tpu_torch.data import (
        pipeline as port_pipeline)

    monkeypatch.setattr(jax_pipeline, "_native_pipeline", None)
    monkeypatch.setattr(port_pipeline, "native_available", lambda: False)
    args = ["predict", "--images", dataset["images"], "--images-range", "0",
            "3", "--preset", "tiny_96", "--params-npz", bridged_npz,
            "--batch-size", "2"]
    jax_main(args)
    want = json.loads(capsys.readouterr().out.strip())
    main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip())
    assert [g["image"] for g in got] == [w["image"] for w in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g["detections"]),
                                   np.asarray(w["detections"]),
                                   rtol=1e-4, atol=1e-4)


def test_visualize_writes_pngs_and_a_contact_sheet(dataset, bridged_npz,
                                                   tmp_path, capsys):
    main(["visualize", *_model(bridged_npz), "--images", dataset["images"],
          "--images-range", "0", "2", "--output-dir", str(tmp_path / "viz"),
          "--objectness-threshold", "0.0",
          "--classification-threshold", "0.0",
          "--contact-sheet", str(tmp_path / "viz" / "sheet.html")])
    result = _last(capsys)
    assert len(result["written"]) == 2
    assert all(os.path.exists(p) for p in result["written"])
    sheet = open(result["contact_sheet"]).read()
    assert sheet.count("<figure>") == 2 and "keydown" in sheet


def test_plot_and_stats(dataset, tmp_path, capsys):
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(
        json.dumps({"epoch": e, "loss": 10.0 - e, "ap": e / 10}) + "\n"
        for e in range(4)))
    main(["plot", "--metrics", str(metrics),
          "--output", str(tmp_path / "curves.html")])
    assert os.path.exists(_last(capsys)["written"])
    main(["stats", "--annotations", dataset["annotations"]])
    out = capsys.readouterr().out
    from vision_transformer_detector_tpu.data.annotations import (
        load_annotations_dict)
    from vision_transformer_detector_tpu.data.statistics import (
        coco_statistics)
    annotations = load_annotations_dict(dataset["annotations"])
    want = coco_statistics(list(annotations), annotations)
    got = json.loads(out)
    got.pop("seconds", None), want.pop("seconds", None)
    assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize("platforms", [["tpu"], ["cuda", "cpu"], ["meta"]])
def test_export_takes_one_platform_of_cuda_or_cpu(bridged_npz, tmp_path,
                                                  platforms):
    with pytest.raises(SystemExit):
        main(["export", "--preset", "tiny_96", "--params-npz", bridged_npz,
              "--output-dir", str(tmp_path / "a"), "--platforms",
              *platforms])


def test_export_then_serve_from_export(bridged_npz, tmp_path, capsys,
                                       monkeypatch):
    from vision_transformer_detector_tpu_torch import cli
    from vision_transformer_detector_tpu_torch.serving import (
        ExportedDetectionService)

    artifact = str(tmp_path / "artifact")
    main(["export", "--preset", "tiny_96", "--params-npz", bridged_npz,
          "--output-dir", artifact, "--batch-sizes", "1", "2",
          "--platforms", "cpu"])
    result = _last(capsys)
    assert result == {"exported": artifact, "batch_size": [1, 2],
                      "platforms": ["cpu"], "postprocess": None}
    served = []
    monkeypatch.setattr(cli, "_serve", lambda args, service:
                        served.append(service))
    main(["serve", "--from-export", artifact, "--device", "cpu",
          "--score-threshold", "-1.0"])
    (service,) = served
    assert isinstance(service, ExportedDetectionService)
    assert service.max_batch_size == 2 and service.score_threshold == -1.0
    assert len(service.detect_array(
        np.zeros((2, 96, 96, 3), np.uint8))) == 2
    for flags in (["--int8"], ["--params-npz", bridged_npz]):
        with pytest.raises(SystemExit, match="--from-export"):
            main(["serve", "--from-export", artifact, "--device", "cpu",
                  *flags])
    # The artifact holds the CPU route and refuses another device type.
    with pytest.raises(ValueError, match="exported on cpu"):
        main(["serve", "--from-export", artifact, "--device", "cuda"])


# ---------------------------------------------------------------------------
# train --resumable / --epochs-per-call, sweep, benchmark, doctor (the twins
# of tests/test_cli.py's tests of these subcommands)


def test_train_resumable_resumes_the_stream(dataset, tmp_path, capsys):
    """--resumable: the input position is saved beside every checkpoint,
    and --restore picks the stream up where it stopped: a run stopped
    after epoch 1 and resumed for 1 more ends at the step and position of
    a 2-epoch run."""
    base = _args(dataset, tmp_path, "--resumable")
    main([*base, "--epochs", "2", "--checkpoint-dir",
          str(tmp_path / "whole")])
    whole = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main([*base, "--epochs", "1"])
    capsys.readouterr()
    ckpt = tmp_path / "ckpt"
    saved = json.loads((ckpt / "ongoing.dataset.json").read_text())
    assert saved == {"epoch": 0, "batch": 2, "seed": 0}
    main([*base, "--epochs", "1", "--restore", "ongoing"])
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resumed["step"] == whole["step"] == 4
    assert json.loads((ckpt / "ongoing.dataset.json").read_text()) == \
        json.loads((tmp_path / "whole" / "ongoing.dataset.json").read_text())
    assert np.isfinite(resumed["final_loss"])


def test_train_epochs_per_call(dataset, tmp_path, capsys, monkeypatch):
    """--epochs-per-call K: one metrics record per epoch and the eval
    cadence intact (eval at warm-up 1, then every 2: epochs 1 and 3)
    through windows of 3; stream-changing flags are refused, and so is a
    dataset larger than the stacked-data limit."""
    metrics = tmp_path / "window.jsonl"
    args = _args(dataset, tmp_path, "--epochs", "5", "--epochs-per-call",
                 "3", "--epochs-warm-up", "1", "--skip-epochs", "2")
    args[args.index(str(tmp_path / "metrics.jsonl"))] = str(metrics)
    main(args)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["final_loss"]) and result["step"] == 10
    assert 0.0 <= result["best_ap"] <= 1.0
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in records] == list(range(5))
    assert [r["epoch"] for r in records if "ap" in r] == [1, 3]
    for bad in ("--shuffle", "--resumable"):
        with pytest.raises(SystemExit, match="incompatible"):
            main(_args(dataset, tmp_path, "--epochs", "2",
                       "--epochs-per-call", "2", bad))
    from vision_transformer_detector_tpu_torch import cli

    monkeypatch.setattr(cli, "STACKED_DATA_LIMIT", 1 << 10)
    with pytest.raises(SystemExit, match="stacking 2 batches"):
        main(_args(dataset, tmp_path, "--epochs", "2",
                   "--epochs-per-call", "2"))


def test_sweep_synthetic_two_learning_rates(tmp_path, capsys):
    out_dir = tmp_path / "sweep"
    main(["sweep", "--preset", "tiny_96", "--batch-size", "2",
          "--synthetic", "--epochs", "2", "--device", "cpu",
          "--sweep", "learning_rate=8e-5,4e-5", "--out-dir", str(out_dir)])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["records"] == 2 and 0.0 <= summary["best_AP"] <= 1.0
    assert "learning_rate" in out[0] and "lowest_loss" in out[0]
    records = [json.loads(line) for line in
               (out_dir / "records.jsonl").read_text().splitlines()]
    assert [r["learning_rate"] for r in records] == [8e-5, 4e-5]
    assert all(np.isfinite(r["final_loss"]) for r in records)
    assert all(os.path.exists(r["metrics_path"]) for r in records)


def test_sweep_batch_size_reaches_the_datasets(dataset, tmp_path, capsys):
    """A swept batch_size builds the datasets (4 images: 2 steps an epoch
    at 2, 1 at 4), and a swept epochs axis is not overridden."""
    out_dir = tmp_path / "sweep_bs"
    main(["sweep", "--preset", "tiny_96", "--device", "cpu",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--sweep", "batch_size=2,4", "--sweep", "epochs=1",
          "--out-dir", str(out_dir)])
    assert json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["records"] == 2
    records = [json.loads(line) for line in
               (out_dir / "records.jsonl").read_text().splitlines()]
    assert [r["batch_size"] for r in records] == [2, 4]
    assert all("plot_path" in r for r in records)
    lengths = [len((out_dir / f"run_{i:03d}" / "metrics.jsonl")
                   .read_text().splitlines()) for i in range(2)]
    assert lengths == [1, 1]


def test_sweep_refusals():
    with pytest.raises(SystemExit, match="--synthetic"):
        main(["sweep", "--preset", "tiny_96", "--device", "cpu",
              "--sweep", "learning_rate=1e-4"])
    with pytest.raises(SystemExit, match="PARAM=V1"):
        main(["sweep", "--preset", "tiny_96", "--device", "cpu",
              "--synthetic", "--sweep", "learning_rate"])
    with pytest.raises(SystemExit, match="CUDA device"):
        main(["sweep", "--preset", "tiny_96", "--device", "cuda",
              "--synthetic", "--sweep", "learning_rate=1e-4",
              "--model-parallel", "2"])


@pytest.mark.parametrize("mode", ["inference", "train"])
def test_benchmark(mode, capsys):
    main(["benchmark", "--preset", "tiny_96", "--batch-size", "2",
          "--device", "cpu", "--iterations", "2", "--mode", mode])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"preset", "mode", "device", "image_size",
                           "batch", "compute_dtype", "iterations",
                           "ms_per_step", "img_per_s"}
    assert result["mode"] == mode and result["device"] == "cpu"
    assert result["batch"] == 2 and result["image_size"] == [96, 96]
    assert result["ms_per_step"] > 0 and result["img_per_s"] > 0


@pytest.mark.parametrize("flags", [["--iterations", "0"],
                                   ["--iterations", "-3"],
                                   ["--data-parallel", "3"],
                                   ["--model-parallel", "2", "--device",
                                    "cuda"]])
def test_benchmark_refusals(flags):
    """A data axis that does not divide the batch (8), and a CUDA mesh
    larger than the visible cards, are refused before any process
    starts."""
    with pytest.raises(SystemExit):
        main(["benchmark", "--preset", "tiny_96", "--device", "cpu",
              *flags])


def test_doctor_without_a_card_exits_1(capsys):
    """doctor: no card here, so the device probe fails, the exit code is 1
    and the report still lists nvcc, every kernel library and the three
    host cores, which build on this host."""
    with pytest.raises(SystemExit) as exc:
        main(["doctor", "--probe-timeout", "120"])
    assert exc.value.code == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"]["ok"] is False
    assert {"coco_json", "pipeline", "coco_eval", "host_cores", "nvcc",
            "kernels"} == set(report["native"])
    assert set(report["native"]["kernels"]) == {
        "flash_attention_fwd.cu", "flash_attention_fwd_sm90.cu",
        "flash_attention_fwd_wide.cu",
        "flash_attention_bwd.cu", "flash_attention_bwd_wide.cu",
        "flash_attention_bwd_sm90.cu", "layer_norm.cu", "dense_mish.cu",
        "int8_dense.cu", "dropout.cu"}
    assert all(report["native"][k] is True for k in ("coco_json", "pipeline",
                                                      "coco_eval"))
    assert report["native"]["host_cores"] == {
        core: {"built": True, "error": None}
        for core in ("coco_json", "coco_eval", "pipeline")}


def test_doctor_reports_a_hung_probe(capsys):
    with pytest.raises(SystemExit):
        main(["doctor", "--probe-timeout", "0.05"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == {
        "ok": False, "error": "the device did not answer within 0.05s"}
