"""What the benchmark's modules import, read from their sources."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "vision_transformer_detector_tpu"}
PORT = "vision_transformer_detector_tpu_torch"


def _sources(top):
    for dirpath, _, files in os.walk(top):
        if os.sep + "out" in dirpath[len(BENCH):]:
            continue
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH,
                                                              "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert PORT not in names and "perfbench" not in names
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch"}


def test_whole_names_compared():
    # The port's name begins with the JAX package's: a prefix test would
    # refuse the port itself.
    assert PORT.startswith("vision_transformer_detector_tpu")
    assert PORT not in FORBIDDEN
