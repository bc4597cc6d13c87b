"""Port twin of tests/test_config_combinations.py: the same six knob
combinations (multi-scale head, windows, bf16, remat policies, dropout,
flash routing) through the port's train step on the CPU.

Each combination trains one step from the JAX package's initial weights
(through ``params_from_numpy``) on the same batch: the loss is finite and
the parameters move and stay finite. Without dropout the step's loss is
the JAX step's (the loss is read before the update): fp32 to 1e-5, bf16
to 2e-2 relative (the two sides round bf16 matmuls at other points). With
dropout the masks differ by construction (tests/test_torch_highres.py
holds them to JAX's with shared masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_config_combinations import BASE, COMBOS
from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.train.optimizer import make_optimizer
from vision_transformer_detector_tpu_torch.train import trainer
from vision_transformer_detector_tpu_torch.train.optimizer import Adam
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy)

LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _batch(cfg):
    """The batch of tests/test_config_combinations.py."""
    rng = np.random.default_rng(3)
    h, w = cfg.image_size
    images = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    labels = np.full((2, cfg.max_objects, 6), -8.0, np.float32)
    labels[:, :, 0] = 0.0
    labels[0, 0] = (1, 5, h / 2, w / 2, 16.0, 16.0)
    labels[1, 0] = (1, 9, h / 4, w / 4, 12.0, 20.0)
    return images, labels


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_combo_trains_one_step(name):
    cfg = DetectorConfig(**{**BASE, **COMBOS[name]})
    images, labels = _batch(cfg)
    optimizer = make_optimizer(TrainConfig(), steps_per_epoch=1)
    jax_state = jax_trainer.create_train_state(jax.random.PRNGKey(0), cfg,
                                               optimizer)
    step = jax_trainer.make_train_step(cfg, LossConfig(), optimizer,
                                       donate=False)
    _, jax_loss = step(jax_state, jnp.asarray(images), jnp.asarray(labels),
                       jax.random.PRNGKey(7))

    port_opt = Adam(TrainConfig(), steps_per_epoch=1)
    model = params_from_numpy(_flat(jax_state["params"]), cfg)
    before = {n: a.copy() for n, a in params_to_numpy(model).items()}
    state = {"params": model,
             "opt_state": port_opt.init(dict(model.named_parameters())),
             "step": 0, "dropout_rng": torch.Generator().manual_seed(8)}
    state, loss = trainer.make_train_step(cfg, LossConfig(), port_opt)(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    assert np.isfinite(float(loss)), (name, float(loss))
    after = params_to_numpy(model)
    assert any(not np.allclose(before[n], after[n]) for n in before), name
    assert all(np.isfinite(a).all() for a in after.values()), name
    if cfg.dropout is None:
        assert float(loss) == pytest.approx(
            float(jax_loss), rel=LOSS_TOL[cfg.compute_dtype]), name


def test_combo_eval_matches_between_attention_routings():
    """train_use_flash_attention must not leak into eval: the port's eval
    step of a train-flash config and of a pure-einsum config give
    identical predictions for identical params."""
    cfg_split = DetectorConfig(**{**BASE, "train_use_flash_attention": True,
                                  "use_flash_attention": False})
    cfg_plain = DetectorConfig(**{**BASE, "use_flash_attention": False})
    params = trainer.init_params(cfg_plain, torch.Generator().manual_seed(1))
    images = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    out_split = trainer.make_eval_step(cfg_split)(params, images)
    out_plain = trainer.make_eval_step(cfg_plain)(params, images)
    assert torch.equal(out_split, out_plain)
