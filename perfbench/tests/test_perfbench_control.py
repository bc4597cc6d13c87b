"""The comparison fails what it must, at a size a test run holds: the
control (the reference computed in float8 e4m3 in the program's place)
and each fault a cell can have, planted underneath the timed path while
the rest of a run goes on as ``run.py`` makes it (the look for a card
skipped). The limits are the test cells' own (``data/tiny.*.json``),
set between the two readings at this size as the cells' are at theirs."""

import time

import pytest

from perfbench import compare, faults, harness, manifest
from conftest import tiny_cell

SEEDS = [2 ** 31 + 17, 2 ** 35 + 3, 12345]


def _run(kind, seed, fault=None):
    cell = tiny_cell(kind)
    if fault is None:
        return cell, harness.run_cell(cell, seed, 0.3, False, "cpu",
                                      time.perf_counter())
    with faults.planted(fault):
        return cell, harness.run_cell(cell, seed, 0.3, False, "cpu",
                                      time.perf_counter())


def _correct(cell, run):
    return (compare.verdict(run.numbers, cell.traffic["limits"])
            and run.failed == 0 and run.answered_all)


@pytest.mark.parametrize("kind", ["infer", "train", "serve"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(kind, seed):
    assert _correct(*_run(kind, seed))


@pytest.mark.parametrize("kind", ["infer", "train", "serve"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(kind, seed):
    cell = tiny_cell(kind)
    run = harness.Run(cell, seed, 0.3, "cpu")
    driver = manifest.driver(cell.traffic["kind"])(run)
    driver.make_inputs()
    assert not compare.verdict(driver.control(), cell.traffic["limits"])


@pytest.mark.parametrize("kind,fault", [
    ("train", "unchanged"), ("train", "half_batch"),
    ("infer", "half_answers"), ("infer", "altered"),
    ("serve", "half_answers"), ("serve", "altered")])
@pytest.mark.parametrize("seed", SEEDS)
def test_faults_are_not_correct(kind, fault, seed):
    assert not _correct(*_run(kind, seed, fault))


def test_nms_breaks_counts_rule_breaks():
    import numpy as np

    row = np.zeros((1, 3, 7))
    row[0, 0] = [0.9, 1, 50, 50, 20, 20, 1]
    row[0, 1] = [0.8, 2, 50, 50, 20, 20, 1]     # another class: kept
    row[0, 2] = [0.0, 1, 51, 50, 20, 20, 0]     # dropped under row 0
    assert compare.nms_breaks([row]) == 0
    kept_twice = row.copy()
    kept_twice[0, 2] = [0.7, 1, 51, 50, 20, 20, 1]
    assert compare.nms_breaks([kept_twice]) == 1
    dropped_alone = row.copy()
    dropped_alone[0, 2, 2] = 200.0
    assert compare.nms_breaks([dropped_alone]) == 1
    out_of_order = row.copy()
    out_of_order[0, [0, 1]] = out_of_order[0, [1, 0]]
    assert compare.nms_breaks([out_of_order]) == 1
