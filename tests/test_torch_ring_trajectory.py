"""A narrow member of the ``highres_1024_ring`` family in bf16, trained on
a ring of two gloo processes, against JAX's ring over several steps on
the CPU.

tests/test_torch_train.py's
``test_highres_family_loss_trajectory_matches_jax_over_steps`` holds the
windowed ``highres_1024`` family to JAX over six steps on one device;
this is its twin for the ring: ``highres_1024_ring`` (ring attention over
the 'model' axis, full remat, the (1, 2, 4) multi-scale head, bf16)
narrowed to 64 px, two blocks and two heads of 64, without dropout (the
port's MLP/head masks are its own counter hash, not JAX's threefry), at
the preset's learning rate. The port's ranks are
tests/torch_parallel_worker.py processes (no JAX); JAX's Trainer runs
over a (1, 2) mesh of tests/conftest.py's virtual CPU devices from the
same weights on the same batch.

Tolerance: test_torch_train.py's ``MULTI_STEP_TOL`` for bf16, one bf16
rounding (2^-7) relative per step taken.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector_tpu.config import (
    LossConfig, TrainConfig, get_config, save_configs)
from vision_transformer_detector_tpu.parallel import mesh as jax_mesh
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import test_torch_parallel as parallel  # noqa: E402
import torch_parallel_worker as worker  # noqa: E402
from test_torch_train import MULTI_STEP_TOL  # noqa: E402

RING = 2
NARROW = dict(image_size=(64, 64), embedding_dim=32, num_heads=2,
              key_dim=64, encoder_blocks=2, head_last_units=16,
              head_layers=2)
TRAIN = TrainConfig(learning_rate=8e-5)
SPAWN_TIMEOUT_S = 240


def _config():
    shipped = get_config("highres_1024_ring")
    assert (shipped.ring_attention and shipped.remat_encoder
            and shipped.compute_dtype == "bfloat16"
            and tuple(shipped.head_scales) == (1, 2, 4)
            and shipped.dropout is None), "highres_1024_ring changed"
    return shipped.replace(**NARROW)


def _batch(config):
    """Batch 2 of the narrow config: seeded images, one box each."""
    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (2, *config.image_size, 3)).astype(
        np.float32)
    labels = np.full((2, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 20.0, 24.0, 18.0, 22.0)
    labels[1, 0] = (1, 17, 40.0, 36.0, 26.0, 20.0)
    return images, labels


def _jax_ring_losses(config, images, labels):
    """(losses, initial params) of JAX's Trainer over a (1, RING) mesh."""
    mesh = jax_mesh.create_mesh(data=1, model=RING,
                                devices=jax.devices()[:RING])
    trainer = jax_trainer.Trainer(config, LossConfig(), TRAIN, mesh=mesh)
    state = trainer.init_state()
    initial = jax.device_get(state["params"])
    images_s, labels_s = trainer._put_batch(jnp.asarray(images),
                                            jnp.asarray(labels))
    losses = []
    for i in range(worker.RING_TRAJECTORY_STEPS):
        with mesh:
            state, loss = trainer.train_step(state, images_s, labels_s,
                                             jax.random.PRNGKey(20 + i))
        losses.append(float(loss))
    return losses, initial


def test_bf16_ring_loss_trajectory_matches_jax_ring_over_steps(tmp_path):
    """Six bf16 train steps of the narrow ring member: the port's two-rank
    ring (both ranks) stays within one bf16 rounding per step of JAX's
    ring, and both trajectories move alike."""
    config = _config()
    images, labels = _batch(config)
    want, params = _jax_ring_losses(config, images, labels)
    save_params_npz(str(tmp_path / "ring_trajectory.npz"), params)
    save_configs(str(tmp_path / "ring_trajectory.json"), config,
                 LossConfig(), TRAIN)
    np.savez(tmp_path / "ring_trajectory_batch.npz", images=images,
             labels=labels)
    parallel._run_group(RING, tmp_path, ("ring_trajectory",),
                        timeout=SPAWN_TIMEOUT_S)
    assert np.all(np.isfinite(want))
    for rank in range(RING):
        got = parallel._load(tmp_path, "ring_trajectory", rank)["losses"]
        assert len(got) == worker.RING_TRAJECTORY_STEPS
        for i, (mine, ref) in enumerate(zip(got, want)):
            assert mine == pytest.approx(
                ref, rel=MULTI_STEP_TOL["bfloat16"] * (i + 1)), (
                    rank, i, list(got), want)
        assert (got[-1] < got[0]) == (want[-1] < want[0])
        assert got[0] != got[-1]
