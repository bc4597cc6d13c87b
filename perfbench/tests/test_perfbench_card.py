"""Each cell run on the card for a short window, as the check runs it."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["vit_l16_640.infer_b64", "vit_l16_640.train_b32",
         "vit_b16_384.infer_b64"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", cell, "--seed", str(2 ** 31 + 101), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
