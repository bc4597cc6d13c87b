"""The manifest and the files it names, held to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from perfbench import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_check_fits_the_day(bench):
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to
    # compile, 1200 s spare, for the full 24 cells.
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 180 + 1200)
    assert total <= 43200


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("name", [
    "vit_l16_640.infer_b64", "vit_l16_640.train_b32",
    "vit_b16_384.infer_b64"])
def test_cells_found_by_name(bench, name):
    cell = manifest.cell(name, ROOT, bench)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert cell.config["detector"]["compute_dtype"] == "bfloat16"
    assert callable(manifest.driver(cell.traffic["kind"], ROOT))
    assert cell.traffic["limits"]
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(manifest.reader(m["name"], ROOT))


def test_every_metric_has_a_reader_and_every_listed_cell_exists(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_later_cell_is_data_only(tmp_path, bench):
    """A configuration, a cell, a per-layer metric and a traffic kind are
    added by adding files and entries: no file that is there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench")
    added = json.loads(json.dumps(bench))
    added["configs"].append(dict(added["configs"][1], name="vit_b16_448",
                                 file="perfbench/configs/vit_b16_448.json"))
    config = json.loads((root / "perfbench/configs/vit_b16_384.json")
                        .read_text())
    config["name"] = "vit_b16_448"
    config["detector"]["image_size"] = [448, 448]
    (root / "perfbench/configs/vit_b16_448.json").write_text(
        json.dumps(config))
    added["workloads"].append({"name": "vit_b16_448.infer_b64",
                               "config": "vit_b16_448",
                               "traffic": "infer_b64", "chips": 1,
                               "why": "test"})
    (root / "perfbench/workloads/vit_b16_448.infer_b64.json").write_text(
        (root / "perfbench/workloads/vit_b16_384.infer_b64.json")
        .read_text())
    added["end_to_end"][0]["workloads"].append("vit_b16_448.infer_b64")
    added["per_layer"].append({"name": "calls_per_s.infer", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "service call",
                               "moves": "infer_img_per_s",
                               "workloads": ["vit_b16_448.infer_b64"]})
    (root / "perfbench/metrics/calls_per_s.infer.py").write_text(
        "def read(run):\n    return run.units / run.window_s\n")
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    cell = manifest.cell("vit_b16_448.infer_b64", str(root))
    assert cell.config["detector"]["image_size"] == [448, 448]
    assert "calls_per_s.infer" in [m["name"] for m in cell.per_layer]

    class Run:
        units, window_s = 10, 2.0
    assert manifest.reader("calls_per_s.infer", str(root))(Run()) == 5.0
    (root / "perfbench/drivers/replay.py").write_text(
        "class Driver:\n    def __init__(self, run):\n"
        "        self.run = run\n")
    assert manifest.driver("replay", str(root))(Run()).run.units == 10
