"""The benchmark's own tests: run from the repository root with
``python -m pytest perfbench/tests -q``. Tests that need a CUDA card carry
the ``cuda`` marker and skip without one."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(kind: str, end_to_end=(), per_layer=()):
    """A CPU-sized cell: the vit_b16_384 architecture narrowed
    (``data/tiny.json``) under ``data/tiny.<kind>.json``'s traffic."""
    from perfbench import manifest

    with open(os.path.join(DATA, "tiny.json")) as f:
        config = json.load(f)
    with open(os.path.join(DATA, f"tiny.{kind}.json")) as f:
        traffic = json.load(f)
    return manifest.Cell(f"tiny.{kind}", 1, config, traffic,
                         list(end_to_end), list(per_layer))


@pytest.fixture
def cell_of():
    return tiny_cell
