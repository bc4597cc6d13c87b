"""The result line, and what ``run.py`` does without a card or with JAX
loaded."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, manifest, report, run as run_module
from conftest import ROOT, tiny_cell


@pytest.fixture
def named_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "a CPU standing in for the card")


# The serving mix's metrics, which BENCHMARK.json does not hold yet (its
# cell is an open question); the harness and the readers carry them.
SERVE_METRICS = (
    [{"name": "serve_p95_ms", "unit": "ms"}, {"name": "serve_p50_ms",
                                              "unit": "ms"},
     {"name": "setup_s", "unit": "s"}],
    [{"name": n, "unit": u} for n, u in (
        ("serve_batch_mean", "img/call"), ("predict_host_ms.serve", "ms"),
        ("idle_pct.serve", "%"))])


@pytest.mark.parametrize("kind,real", [
    ("infer", "vit_b16_384.infer_b64"), ("train", "vit_l16_640.train_b32"),
    ("serve", None)])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(named_card, kind, real, traced):
    if real is None:
        cell = tiny_cell(kind, *SERVE_METRICS)
    else:
        cell = manifest.cell(real, ROOT)
        cell = tiny_cell(kind, cell.end_to_end, cell.per_layer)
    run = harness.run_cell(cell, 2 ** 33 + 1, 0.3, traced, "cpu",
                           time.perf_counter())
    result = report.result(run, cell, traced)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    names = set(result["metrics"])
    if traced:
        # No device here: the trace's readers find nothing and are left
        # out; the host readers report.
        assert names <= {m["name"] for m in cell.per_layer}
        assert "busy_s" in device and "breakdown" in result
    else:
        assert names == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == set(cell.traffic["limits"])
    for line, (name, c) in zip(report.check_lines(result["checks"]),
                               result["checks"].items()):
        assert line == f"check {name}: {c['value']} (limit {c['limit']})"
    json.dumps(result)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "vit_b16_384.infer_b64", "--seed", str(2 ** 32 + 7),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "vision_transformer_detector_tpu",
                        raising=False)
    import vision_transformer_detector_tpu_torch  # noqa: F401  the port

    assert run_module.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run_module.forbidden_modules() == ["jax"]
