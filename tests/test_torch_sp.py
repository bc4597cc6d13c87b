"""Sequence sharding of the port against the JAX package, on the CPU.

The port's ranks are gloo processes (tests/torch_parallel_worker.py,
which imports no JAX); the JAX side runs here on the 8-device virtual CPU
mesh of tests/conftest.py, with JAX's ``TINY`` (tests/test_torch_tp.py),
JAX's Trainer's initial weights and tests/multiprocess_worker.py's batch.

Tolerances:
  * the sharded forward (windows of one token, as JAX's test has it;
    global attention on the einsum route, the flash blocks over gathered
    keys, and the ring) against JAX's unsharded forward: 1e-4 absolute,
    JAX's own ``test_sequence_sharding_compiles_and_matches``;
  * train steps of sequence sharding and of the ring over (1, 2) and (2,
    2) meshes against JAX's Trainer on the same mesh (which also shards
    the parameters: the function is the same) and JAX's single-device
    steps: each loss within 1e-5 relative.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector_tpu.models.vit_detector import (
    forward as jax_forward)

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import test_torch_parallel as parallel  # noqa: E402
import test_torch_tp as tp  # noqa: E402
import torch_parallel_worker as worker  # noqa: E402

TOKEN_CASES = tuple(f"{run}_train_{data}" for run in worker.TOKEN_RUNS
                    for data in (1, 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("sp")
    params = tp.write_inputs(outdir)
    parallel._run_group(4, outdir, ("sp_forward",) + tuple(
        c for c in TOKEN_CASES if c.endswith("_2")))
    parallel._run_group(2, outdir, tuple(
        c for c in TOKEN_CASES if c.endswith("_1")))
    return outdir, params


@pytest.mark.parametrize("variant", [v for v, _ in worker.SP_VARIANTS])
def test_sequence_sharding_forward_matches_jax(runs, variant):
    """The forward over a (2, 2) mesh (batch over 'data', tokens over
    'model') equals JAX's unsharded forward of the same weights on every
    rank's rows."""
    outdir, params = runs
    overrides = dict(worker.SP_VARIANTS)[variant]
    base = tp.TINY.replace(**{k: v for k, v in overrides.items()
                              if k == "attention_window"})
    images, _ = tp.mesh_batch()
    want = np.asarray(jax_forward(params, jnp.asarray(images), base))
    for rank in range(4):
        got = parallel._load(outdir, "sp_forward", rank)
        first = int(got["first"])
        rows = got[variant].shape[0]
        np.testing.assert_allclose(got[variant], want[first:first + rows],
                                   atol=1e-4)


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("run", list(worker.TOKEN_RUNS))
def test_token_axis_train_steps_match_jax_trainer(runs, run, data):
    """Sequence sharding (windows of one token, and global attention) and
    the ring, trained over a (data, 2) mesh: each loss equals JAX's
    Trainer on the same mesh and JAX's single-device steps."""
    outdir, params = runs
    config = tp.TINY.replace(**worker.TOKEN_RUNS[run])
    on_mesh, _ = tp.jax_mesh_losses(config, data, 2, params)
    single = tp.jax_single_losses(config.replace(
        sequence_sharding=False, ring_attention=False), params)
    for rank in range(2 * data):
        got = parallel._load(outdir, f"{run}_train_{data}", rank)["losses"]
        np.testing.assert_allclose(got, on_mesh, rtol=1e-5)
        np.testing.assert_allclose(got, single, rtol=1e-5)
