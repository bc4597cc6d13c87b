"""Windowed attention, the multi-scale head, training dropout and remat of
the port's forward against the JAX package, on the CPU.

Weights cross through the weight bridge (``save_params_npz`` ->
``load_params_npz``), images and cotangents are made with numpy from a
seed, and both forwards run on the CPU (the JAX Pallas kernels in
interpret mode, the port's plain versions). With dropout on:

  * attention dropout on the flash route uses the JAX attention seeds
    (``jax.random.bits`` of each block's attention rng) as the port's seed
    table, so the counter-hash masks are the same masks, provided the port
    folds the windows into the batch*head axis as JAX does;
  * the MLP, head and einsum-route masks come from different generators on
    the two sides (threefry; a torch.Generator), so both packages'
    ``_dropout`` are patched to one numpy mask, keyed by the tensor's size
    (the two sides' tensors hold their elements in the same order).

Tolerances (fp32): logits 1e-4 absolute (the two sides differ in the
order of their sums); gradients 1e-4 of each tensor's largest value, the
attention key bias (zero in exact arithmetic) 1e-4 of the largest
gradient overall.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig, get_config
from vision_transformer_detector_tpu.models import vit_detector as jax_model
from vision_transformer_detector_tpu.ops.loss import (
    detection_loss as jax_detection_loss)
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz, params_to_numpy)

LOGITS_TOL = 1e-4
GRAD_TOL = 1e-4
RATE = 0.25

# tests/test_config_combinations.py's BASE: 64 px / p16, a 4x4 grid.
BASE = dict(image_size=(64, 64), patch_size=16, embedding_dim=16,
            num_heads=2, key_dim=8, encoder_blocks=2, encoder_mlp_layers=2,
            head_last_units=16, head_layers=2)
# key_dim 8: tokens-major, windows fold into the batch axis; key_dim 64:
# heads-major, windows fold into the head axis.
ROUTES = {"tokens_major_k8": {},
          "heads_major_k64": {"embedding_dim": 32, "key_dim": 64}}


def _config(**overrides) -> DetectorConfig:
    return DetectorConfig(**{**BASE, **overrides})


def _images(config, batch=2, seed=0):
    h, w = config.image_size
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (batch, h, w, 3)).astype(np.float32)


def _bridge(tmp_path, params, config):
    path = os.path.join(str(tmp_path), "params.npz")
    save_params_npz(path, params)
    return load_params_npz(path, config)


def _mask(size: int, keep: float) -> np.ndarray:
    return np.random.default_rng(size).random(size) < keep


@pytest.fixture
def shared_masks(monkeypatch):
    """Both packages' ``_dropout`` draw one numpy mask per tensor size."""

    def jax_dropout(x, rate, rng, train):
        if not train or rate is None or rate == 0.0 or rng is None:
            return x
        keep = 1.0 - rate
        mask = jnp.asarray(_mask(x.size, keep).reshape(x.shape))
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)

    def port_dropout(x, rate, seed, train, *placement):
        if not train or rate is None or rate == 0.0 or seed is None:
            return x
        keep = 1.0 - rate
        mask = torch.from_numpy(_mask(x.numel(), keep).reshape(x.shape))
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    monkeypatch.setattr(jax_model, "_dropout", jax_dropout)
    monkeypatch.setattr(model, "_dropout", port_dropout)


def _jax_seed_table(rng, config) -> model.DropoutSeeds:
    """The JAX forward's attention seeds (per block: split the dropout rng
    over the blocks, split the block's over 2 + MLP layers, bits of the
    first) as the port's seed table; MLP and head seeds only switch the
    patched masks on."""
    attention = []
    for block_rng in jax.random.split(rng, config.encoder_blocks):
        rngs = jax.random.split(block_rng, 2 + config.encoder_mlp_layers)
        attention.append(int(jax.random.bits(rngs[0], (), jnp.uint32)))
    mlp = ((1,) * config.encoder_mlp_layers,) * config.encoder_blocks
    head = (1,) * (len(config.head_units) * config.head_block_repeats)
    return model.DropoutSeeds(tuple(attention), mlp, head)


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf, np.float32)
    return out


def _jax_logits_and_grads(params, images, config, cotangent, rng=None):
    train = rng is not None

    def loss(p):
        logits = jax_model.forward(p, images, config, train=train,
                                   dropout_rng=rng)
        return jnp.sum(logits * cotangent), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return np.asarray(logits), _flat(grads)


def _port_logits_and_grads(port, images, config, cotangent, seed=None):
    named = dict(port.named_parameters())
    logits = model.forward(port, torch.from_numpy(images), config,
                           train=seed is not None, dropout_seed=seed)
    grads = torch.autograd.grad(
        (logits * torch.from_numpy(cotangent)).sum(), list(named.values()))
    return logits.detach().numpy(), {
        name.replace(".", "/"): g.numpy() for name, g in zip(named, grads)}


def _assert_grads_close(got: dict, want: dict, tol=GRAD_TOL):
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for name, ref in want.items():
        scale = top if name.endswith("mha/key/bias") else np.abs(ref).max()
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=tol * max(scale, 1e-12),
                                   err_msg=name)


def _cotangent(config, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (2, config.max_objects, 6)).astype(np.float32)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_windowed_attention_matches_jax(tmp_path, shared_masks, route,
                                        flash, dropout):
    """Logits and gradients of a windowed model (window 2 on the 4x4 grid)
    on both fold routes, flash and einsum, with and without dropout. With
    dropout on the flash route, a wrong fold order gives other masks."""
    config = _config(attention_window=2, use_flash_attention=flash,
                     dropout=RATE if dropout else None, **ROUTES[route])
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    port = _bridge(tmp_path, params, config)
    images, cot = _images(config), _cotangent(config)
    rng = jax.random.PRNGKey(7) if dropout else None
    want_logits, want_grads = _jax_logits_and_grads(params, images, config,
                                                    cot, rng)
    seed = _jax_seed_table(rng, config) if dropout else None
    logits, grads = _port_logits_and_grads(port, images, config, cot, seed)
    np.testing.assert_allclose(logits, want_logits, atol=LOGITS_TOL, rtol=0)
    _assert_grads_close(grads, want_grads)
    if dropout:
        # The masks did act: the same weights without dropout differ.
        plain, _ = _port_logits_and_grads(port, images, config, cot)
        assert np.abs(plain - logits).max() > 100 * LOGITS_TOL


@pytest.mark.parametrize("scales", [(1, 2), (1, 2, 4)])
def test_multi_scale_head_matches_jax(tmp_path, scales):
    """Logits, detection loss and its gradients of the multi-scale head;
    its per-scale token denses cross the bridge as head_token_dense/<i>."""
    from vision_transformer_detector_tpu.data.pipeline import (
        synthetic_batches)
    from vision_transformer_detector_tpu_torch.config import LossConfig

    config = _config(head_scales=scales, use_flash_attention=True)
    params = jax_model.init_params(jax.random.PRNGKey(1), config)
    port = _bridge(tmp_path, params, config)
    assert isinstance(port.head_token_dense, torch.nn.ModuleList)
    names = params_to_numpy(port)
    for i in range(len(scales)):
        np.testing.assert_array_equal(
            names[f"head_token_dense/{i}/kernel"],
            np.asarray(params["head_token_dense"][i]["kernel"]))
    gh, gw = config.grid_size
    assert port.head_mlp[0].kernel.shape[0] == sum(
        (gh // s) * (gw // s) for s in scales)
    images, labels = next(synthetic_batches(config, 2, 1, seed=2))

    def jax_loss(p):
        logits = jax_model.forward(p, images, config)
        return jax_detection_loss(jnp.asarray(labels), logits, config), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)
    named = dict(port.named_parameters())
    logits = model.forward(port, torch.from_numpy(images), config)
    loss = detection_loss(torch.from_numpy(labels), logits, config,
                          LossConfig())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL,
                               rtol=0)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    _assert_grads_close({n.replace(".", "/"): g.numpy()
                         for n, g in zip(named, grads)}, _flat(want_grads))


@pytest.mark.parametrize("override", [
    {"attention_window": 3}, {"attention_window": 0},
    {"head_scales": (1, 3)}, {"head_scales": (1, 8)}])
def test_invalid_geometry_raises_the_jax_message(override):
    config = _config(**override)
    with pytest.raises(ValueError) as jax_error:
        jax_model.init_params(jax.random.PRNGKey(0), config)
    with pytest.raises(ValueError) as port_error:
        model.init_params(config, torch.Generator().manual_seed(0))
    assert str(port_error.value) == str(jax_error.value)
    good = model.init_params(_config(), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as forward_error:
        model.forward(good, torch.from_numpy(_images(config)), config)
    assert str(forward_error.value) == str(jax_error.value)


def test_unknown_remat_policy_raises_the_jax_message():
    config = _config(remat_encoder=True, remat_policy="everything")
    params = model.init_params(config, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown remat_policy 'everything'"):
        model.forward(params, torch.from_numpy(_images(config)), config)


REMAT = dict(attention_window=2, head_scales=(1, 2),
             use_flash_attention=True, dropout=RATE, remat_encoder=True)


@pytest.mark.parametrize("policy", [None, "dots", "alternate"])
def test_remat_matches_no_remat(policy):
    """With dropout on and one seed, each remat policy gives the loss and
    gradients of no remat: the recompute replays every mask (the attention
    mask is a function of position; the MLP masks come from generators
    seeded inside the block). Exact on the CPU, where the recompute does
    the same sums in the same order."""
    config = _config(remat_policy=policy, **REMAT)
    port = model.init_params(config, torch.Generator().manual_seed(3))
    images, cot = _images(config, seed=4), _cotangent(config)
    got = _port_logits_and_grads(port, images, config, cot, seed=77)
    want = _port_logits_and_grads(
        port, images, config.replace(remat_encoder=False), cot, seed=77)
    np.testing.assert_array_equal(got[0], want[0])
    for name, ref in want[1].items():
        np.testing.assert_allclose(got[1][name], ref, rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    other = _port_logits_and_grads(port, images, config, cot, seed=78)
    assert not np.allclose(other[0], got[0])


@pytest.mark.parametrize("policy", [None, "dots", "alternate"])
def test_remat_grads_match_jax(tmp_path, shared_masks, policy):
    """Each remat policy's logits and gradients against jax.grad of the JAX
    forward with the same policy, dropout on, the JAX attention seeds and
    the shared MLP masks."""
    config = _config(remat_policy=policy, **REMAT)
    params = jax_model.init_params(jax.random.PRNGKey(5), config)
    port = _bridge(tmp_path, params, config)
    images, cot = _images(config, seed=6), _cotangent(config)
    rng = jax.random.PRNGKey(11)
    want_logits, want_grads = _jax_logits_and_grads(params, images, config,
                                                    cot, rng)
    logits, grads = _port_logits_and_grads(
        port, images, config, cot, _jax_seed_table(rng, config))
    np.testing.assert_allclose(logits, want_logits, atol=LOGITS_TOL, rtol=0)
    _assert_grads_close(grads, want_grads)


def test_highres_1024_preset_eval_matches_jax(tmp_path):
    """The highres_1024 preset at its widths (D 1024, 16 heads x 64, MLP
    2048, head 2048-1024-512) cut to 2 blocks and 128 px (an 8x8 grid,
    window 4, scales (1, 2, 4)): the eval forward in the preset's bf16
    matches JAX's to a few bf16 roundings (PyTorch rounds each bf16
    matmul before the fp32 bias add, XLA once after it)."""
    config = get_config("highres_1024").replace(
        image_size=(128, 128), attention_window=4, encoder_blocks=2)
    assert config.embedding_dim == 1024 and config.key_dim == 64
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    port = _bridge(tmp_path, params, config)
    images = _images(config, batch=1)
    want = np.asarray(jax.jit(
        lambda p, x: jax_model.forward(p, x, config))(params, images))
    with torch.inference_mode():
        got = model.forward(port, torch.from_numpy(images), config).numpy()
    assert got.shape == (1, config.max_objects, 6)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=8 * 2 ** -7 * scale, rtol=0)
