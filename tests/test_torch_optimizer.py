"""The port's optimizer stack vs the JAX package's optax chain.

Seeded numpy gradients drive both sides from the same parameters: the
schedule must give optax's value at every step count, the parameter
trajectory must follow optax's over 30 steps that cross two LR
boundaries and hit the gradient clip, ``clip_weights`` must treat NaNs
as the JAX version does, and the bf16-moment state must be bit-equal to
``scale_by_adam_compact``'s, stochastic rounding included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig, TrainConfig
from vision_transformer_detector_tpu.models.vit_detector import (
    init_params as jax_init_params)
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu_torch.train import optimizer as opt

# Boundaries at steps 10 and 15 (the third decay coincides with the second
# and is deduplicated, as in the reference).
CONFIG = TrainConfig(learning_rate=1e-2, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=5, epochs_third_lr_decay=0)
SMALL = DetectorConfig(image_size=(34, 34), embedding_dim=8, num_heads=2,
                       key_dim=4, encoder_blocks=2, encoder_mlp_layers=2,
                       head_last_units=8, head_layers=1)


def _flat(tree):
    """Slash-joined name -> numpy array (the weight bridge's naming)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = np.asarray(leaf)
    return out


def _unflat(template, flat):
    paths = jax.tree_util.tree_flatten_with_path(template)[0]
    leaves = [jnp.asarray(flat[".".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)])
        for path, _ in paths]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def _grads(params, step, scale):
    rng = np.random.default_rng(1000 + step)
    return {n: (rng.standard_normal(p.shape) * scale).astype(np.float32)
            for n, p in params.items()}


def _run_both(train_config, steps, scale):
    """Parameters after each step on both sides (numpy dicts)."""
    jax_params = jax_init_params(jax.random.PRNGKey(0), SMALL)
    start = _flat(jax_params)
    optimizer = jax_opt.make_optimizer(train_config)
    jax_state = optimizer.init(jax_params)
    update = jax.jit(optimizer.update)

    torch_params = {n: torch.from_numpy(a.copy()) for n, a in start.items()}
    port = opt.Adam(train_config)
    port_state = port.init(torch_params)
    trajectory = []
    for step in range(steps):
        grads = _grads(start, step, scale)
        updates, jax_state = update(_unflat(jax_params, grads), jax_state,
                                    jax_params)
        jax_params = jax.tree_util.tree_map(lambda p, u: p + u, jax_params,
                                            updates)
        port.step(torch_params, {n: torch.from_numpy(g)
                                 for n, g in grads.items()}, port_state)
        trajectory.append((_flat(jax_params),
                           {n: t.numpy().copy()
                            for n, t in torch_params.items()}))
    return trajectory, jax_state, port_state


def test_schedule_matches_optax_at_every_count():
    """Exact fp32 values, at and around each boundary (steps_per_epoch 3:
    boundaries at steps 30 and 45)."""
    port = opt.make_lr_schedule(CONFIG, steps_per_epoch=3)
    ref = jax_opt.make_lr_schedule(CONFIG, steps_per_epoch=3)
    for count in range(0, 60):
        assert port(count) == float(np.float32(ref(count))), count
    assert port(29) == pytest.approx(1e-2) and port(30) == pytest.approx(1e-3)
    assert port(45) == pytest.approx(1e-4)


def test_trajectory_matches_optax_over_lr_boundaries_and_clip():
    """30 steps, gradients of scale 8 (a share of them beyond the clip at
    10). Both sides do the same fp32 operations; they may differ by an ulp
    in b**count, so the tolerance is a few fp32 ulps of the parameters."""
    trajectory, _, _ = _run_both(CONFIG, steps=30, scale=8.0)
    grads = _grads(trajectory[0][0], 0, 8.0)
    assert any(np.abs(g).max() > CONFIG.clip_gradient_value
               for g in grads.values())
    for step, (expected, got) in enumerate(trajectory):
        for name in expected:
            np.testing.assert_allclose(got[name], expected[name], rtol=2e-6,
                                       atol=2e-7, err_msg=f"{step} {name}")


def test_bf16_moments_bit_equal_to_scale_by_adam_compact():
    """--bf16-moments: mu rounds to nearest, nu stochastically with the
    counter hash over the JAX flatten order; the stored moments must be
    the same bits after every one of 5 steps."""
    config = dataclasses.replace(CONFIG, adam_mu_dtype="bfloat16",
                                 adam_nu_dtype="bfloat16")
    trajectory, jax_state, port_state = _run_both(config, steps=5,
                                                  scale=0.01)
    adam_state = jax_state[1][0]   # chain(clip, chain(compact, lr))
    assert int(adam_state.count) == port_state["count"] == 5
    for moment in ("mu", "nu"):
        expected = _flat(getattr(adam_state, moment))
        for name, value in expected.items():
            got = port_state[moment][name]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(value).view(np.int16), err_msg=name)
    expected, got = trajectory[-1]
    for name in expected:
        np.testing.assert_allclose(got[name], expected[name], rtol=2e-6,
                                   atol=2e-7)


def test_rounding_bits_match_the_jax_hash():
    """The int64 emulation of uint32 arithmetic, at a count and indices
    whose products wrap 2**32 many times."""
    count, leaf, shape = 2 ** 31 + 12345, 7, (3, 1000)
    idx = jnp.arange(3000, dtype=jnp.uint32).reshape(shape)
    expected = jax_opt._mix_u32(
        jnp.uint32(count) * jnp.uint32(0x9E3779B1)
        + jnp.uint32((leaf * 0x85EBCA6B) & 0xFFFFFFFF)
        + idx * jnp.uint32(0xC2B2AE35))
    got = opt.rounding_bits(count, leaf, shape, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(expected))


def test_clip_weights_with_nans():
    values = np.array([[np.nan, -12.0, 3.5], [11.0, np.inf, -np.inf]],
                      np.float32)
    expected = np.asarray(jax_opt.clip_weights({"w": jnp.asarray(values)},
                                               10.0)["w"])
    params = {"w": torch.from_numpy(values.copy())}
    opt.clip_weights(params, 10.0)
    np.testing.assert_array_equal(params["w"].numpy(), expected)
    np.testing.assert_array_equal(expected, [[1, -10, 3.5], [10, 10, -10]])



def test_bf16_first_moment_alone_matches_optax_adam_mu_dtype():
    """adam_mu_dtype="bfloat16" without adam_nu_dtype is optax.adam(
    mu_dtype=bfloat16): mu stored in bf16 (b1 * mu with b1 rounded to
    bf16, kept in fp32 as XLA computes it), nu in fp32. The stored mu is
    bit-equal after each of 6 steps, nu and the parameters within the
    trajectory test's few fp32 ulps."""
    config = dataclasses.replace(CONFIG, adam_mu_dtype="bfloat16")
    trajectory, jax_state, port_state = _run_both(config, steps=6,
                                                  scale=0.5)
    adam_state = jax_state[1][0]   # chain(clip, adam)
    assert int(adam_state.count) == int(port_state["count"]) == 6
    mu, nu = _flat(adam_state.mu), _flat(adam_state.nu)
    for name, value in mu.items():
        got = port_state["mu"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(value).view(np.int16),
                                      err_msg=name)
    for name, value in nu.items():
        assert port_state["nu"][name].dtype == torch.float32
        np.testing.assert_allclose(port_state["nu"][name].numpy(), value,
                                   rtol=2e-6, atol=1e-12, err_msg=name)
    for step, (expected, got) in enumerate(trajectory):
        for name in expected:
            np.testing.assert_allclose(got[name], expected[name], rtol=2e-6,
                                       atol=2e-7, err_msg=f"{step} {name}")


def test_step_keeps_its_state_tensors_and_counts_on_the_device():
    """The state a captured graph writes: step() updates the moments and
    the count in place (the same tensors before and after), the count is
    an int64 tensor, and the learning rate is computed from it."""
    params = {"w": torch.ones(3, 4), "b": torch.zeros(4)}
    adam = opt.Adam(CONFIG)
    state = adam.init(params)
    before = {m: {n: t for n, t in state[m].items()} for m in ("mu", "nu")}
    count = state["count"]
    for _ in range(12):
        adam.step(params, {n: torch.full_like(p, 0.5)
                           for n, p in params.items()}, state)
    assert state["count"] is count and count.dtype == torch.int64
    assert int(count) == 12
    for m in ("mu", "nu"):
        for name, tensor in state[m].items():
            assert tensor is before[m][name]
    assert adam.learning_rate(count).item() == adam.schedule(12)
    assert adam.learning_rate(torch.tensor(9)).item() == adam.schedule(9)


def test_accumulation_needs_the_update_flag():
    adam = opt.Adam(dataclasses.replace(CONFIG, accumulate_steps=2))
    params = {"w": torch.ones(2)}
    state = adam.init(params)
    assert [adam.is_update_step(s) for s in range(4)] == [False, True,
                                                           False, True]
    with pytest.raises(ValueError, match="update="):
        adam.step(params, {"w": torch.ones(2)}, state)
