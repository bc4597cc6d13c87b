"""The manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:
  * a configuration: the ``file`` its entry names (``configs/<name>.json``);
  * a cell's traffic mix: ``workloads/<cell name>.json``;
  * a per-layer metric's reader: ``metrics/<metric name>.py``, a module
    with ``read(run) -> float | None``;
  * a traffic kind's driver: ``drivers/<kind>.py``, a module with a class
    ``Driver(run)`` (``harness.py`` says what it does).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's file
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root, configs[entry["config"]]["file"])
    traffic = read_json(root, os.path.join("perfbench", "workloads",
                                           name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer)


def _module(folder: str, name: str, root: str):
    path = os.path.join(root, "perfbench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric_name: str, root: str = ROOT) -> Callable:
    """``read(run)`` of ``metrics/<metric_name>.py``."""
    return _module("metrics", metric_name, root).read


def driver(kind: str, root: str = ROOT) -> type:
    """``Driver`` of ``drivers/<kind>.py``."""
    return _module("drivers", kind, root).Driver
