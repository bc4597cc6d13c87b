"""The CLI's mesh runs on the CPU, in gloo groups: ``train`` and
``evaluate`` as ``--distributed`` processes started here, ``train``,
``benchmark`` and ``sweep`` over a data axis of local processes that the
CLI starts itself. Every command runs in its own process with a time
limit (the CLI's processes import no JAX)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "vision_transformer_detector_tpu_torch.cli"]
TIMEOUT = 240


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 JPEGs with one box each (the fixture of tests/test_torch_cli.py)."""
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


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _run(args) -> dict:
    out = subprocess.run(CLI + args, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return _last_json(out.stdout)


def _run_distributed(args, world=2) -> list:
    """``args`` as ``world`` --distributed processes; their last lines.
    The group's store is held here (``local_store``), on a port no other
    process can take between its choice and the rendezvous."""
    from vision_transformer_detector_tpu_torch.parallel.data import (
        local_store)

    with local_store() as (port, store_env):
        procs = [subprocess.Popen(
            CLI + args + ["--distributed", "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes", str(world),
                          "--process-id", str(rank)],
            env=dict(_env(), **store_env), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(world)]
        results = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=TIMEOUT)
                assert p.returncode == 0, stderr[-3000:]
                results.append(_last_json(stdout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


def _data(dataset, *names):
    out = []
    for name in names:
        out += [f"--{name}-images", dataset["images"],
                f"--{name}-annotations", dataset["annotations"]]
    return out


def test_train_then_evaluate_distributed(dataset, tmp_path):
    """Two --distributed processes train one model over a data axis of 2
    (global batch 2, one image each), rank 0 writing the checkpoints and
    metrics; then evaluate it as two processes: the mAP every rank prints
    is the one a single process computes over the same images."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--preset", "tiny_96", "--batch-size", "2", "--device", "cpu",
              "--checkpoint-dir", ckpt, "--data-parallel", "2"]
    trained = _run_distributed(
        ["train", *common, *_data(dataset, "train", "val"), "--epochs", "2",
         "--learning-rate", "1e-4", "--epochs-warm-up", "0",
         "--skip-epochs", "1", "--metrics", str(tmp_path / "m.jsonl")])
    assert trained[0] == trained[1]
    assert trained[0]["step"] == 4 and np.isfinite(trained[0]["final_loss"])
    records = [json.loads(line) for line in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert {"config.json", "final.pt", "ongoing.pt"} <= set(os.listdir(ckpt))

    evaluated = _run_distributed(["evaluate", *common, "--restore", "final",
                                  *_data(dataset, "val")])
    single = _run(["evaluate", "--preset", "tiny_96", "--batch-size", "2",
                   "--device", "cpu", "--checkpoint-dir", ckpt, "--restore",
                   "final", *_data(dataset, "val")])
    for result in evaluated:
        assert abs(result["mAP"] - single["mAP"]) <= 1e-3


def test_train_data_parallel_starts_local_processes(dataset, tmp_path):
    """Without --distributed or torchrun's environment, ``train
    --data-parallel 2 --device cpu`` starts two gloo processes of itself
    and prints rank 0's result."""
    result = _run(["train", "--preset", "tiny_96", "--batch-size", "2",
                   "--device", "cpu", "--data-parallel", "2",
                   *_data(dataset, "train"), "--epochs", "1",
                   "--checkpoint-dir", str(tmp_path / "ckpt"),
                   "--metrics", str(tmp_path / "m.jsonl")])
    assert result["step"] == 2 and np.isfinite(result["final_loss"])
    assert os.path.exists(tmp_path / "ckpt" / "final.pt")


def test_benchmark_data_parallel_reports_the_global_batch():
    result = _run(["benchmark", "--preset", "tiny_96", "--batch-size", "2",
                   "--device", "cpu", "--iterations", "2", "--mode",
                   "train", "--data-parallel", "2"])
    assert result["mesh"] == [2, 1] and result["batch"] == 2
    assert result["img_per_s"] == pytest.approx(
        2e3 / result["ms_per_step"], rel=0.01)


def test_sweep_passes_the_mesh(tmp_path):
    result = _run(["sweep", "--preset", "tiny_96", "--batch-size", "2",
                   "--device", "cpu", "--synthetic", "--epochs", "1",
                   "--sweep", "learning_rate=1e-4", "--data-parallel", "2",
                   "--out-dir", str(tmp_path / "sweep")])
    assert result["records"] == 1
    assert os.path.exists(tmp_path / "sweep" / "records.jsonl")
