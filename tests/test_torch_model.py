"""PyTorch ViT detector forward vs the JAX forward on the same weights.

Weights go JAX params -> ``save_params_npz`` -> the port's
``load_params_npz`` (the weight bridge), images are made with numpy from
a seed, and both forwards run on the CPU: the JAX one with the Pallas
flash kernel in interpret mode where the config asks for it, the port
with its plain attention version.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu.models import vit_detector as jax_model
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz, params_from_numpy, params_to_numpy)

# fp32 logits through a few blocks: the two sides differ only in the
# order of their sums (XLA vs PyTorch matmuls, blocked vs materialised
# softmax).
LOGITS_TOL = 1e-4

_SMALL = dict(embedding_dim=32, num_heads=2, encoder_blocks=2,
              encoder_mlp_layers=2, head_last_units=16, head_layers=2)
CONFIGS = {
    # key_dim 64: heads-major flash path, native kernel head dim
    "flash_k64": DetectorConfig(image_size=(48, 48), patch_size=16,
                                key_dim=64, use_flash_attention=True,
                                **_SMALL),
    # key_dim 8: tokens-major flash path, K padded by the kernel routes
    "flash_k8": DetectorConfig(image_size=(48, 64), patch_size=16,
                               key_dim=8, use_flash_attention=True,
                               **_SMALL),
    # plain (einsum) attention, gelu pyramid
    "einsum": DetectorConfig(image_size=(48, 48), patch_size=16,
                             key_dim=8, use_mish=False, **_SMALL),
    # non-multiple image size: SAME padding of 75 px into 17 px patches,
    # doubled head pyramid
    "75px_p17": DetectorConfig(image_size=(75, 75), patch_size=17,
                               key_dim=8, use_flash_attention=True,
                               head_block_repeats=2, **_SMALL),
}


def _images(config, batch=2, seed=0):
    h, w = config.image_size
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (batch, h, w, 3)).astype(np.float32)


def _bridge(tmp_path, params, config):
    path = os.path.join(str(tmp_path), "params.npz")
    save_params_npz(path, params)
    return path, load_params_npz(path, config)


def _port_logits(params, images, config):
    with torch.inference_mode():
        return model.forward(params, torch.from_numpy(images),
                             config).numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(tmp_path, name):
    config = CONFIGS[name]
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    _, port = _bridge(tmp_path, params, config)
    images = _images(config)
    expected = jax.jit(lambda p, x: jax_model.forward(p, x, config))(
        params, images)
    logits = _port_logits(port, images, config)
    assert logits.shape == (2, config.max_objects, 6)
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, np.asarray(expected),
                               atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("name", ["flash_k64", "einsum"])
def test_bf16_forward_matches_jax(tmp_path, name):
    """bf16 compute: same cast points, so the logits agree to a few bf16
    ulps (0.0078 at |logit| in [1, 2)); PyTorch rounds each bf16 matmul
    before the fp32 bias add where XLA rounds once after it."""
    config = CONFIGS[name].replace(compute_dtype="bfloat16")
    params = jax_model.init_params(jax.random.PRNGKey(3), config)
    _, port = _bridge(tmp_path, params, config)
    images = _images(config, seed=3)
    expected = np.asarray(jax.jit(
        lambda p, x: jax_model.forward(p, x, config))(params, images))
    logits = _port_logits(port, images, config)
    assert logits.dtype == np.float32
    assert np.abs(expected).max() < 2.0
    np.testing.assert_allclose(logits, expected, atol=4 * 0.0078125,
                               rtol=0)


def test_padded_key_dim_weights_match_jax(tmp_path):
    """Weights widened by pad_attention_key_dim (K 8 -> 64) load with the
    physical head dim from the arrays and take the heads-major path."""
    config = CONFIGS["flash_k8"]
    params = jax_model.pad_attention_key_dim(
        jax_model.init_params(jax.random.PRNGKey(1), config), to=64)
    _, port = _bridge(tmp_path, params, config)
    assert tuple(port.encoder[0].mha.query.kernel.shape) == (32, 2, 64)
    images = _images(config, seed=1)
    expected = jax.jit(lambda p, x: jax_model.forward(p, x, config))(
        params, images)
    np.testing.assert_allclose(_port_logits(port, images, config),
                               np.asarray(expected), atol=LOGITS_TOL,
                               rtol=0)


@pytest.mark.parametrize("shape,patch", [
    ((2, 75, 75, 3), 17), ((1, 64, 48, 3), 16), ((1, 70, 90, 3), 16)])
def test_extract_patches_exact(shape, patch):
    images = np.random.default_rng(2).uniform(-1, 1, shape).astype(
        np.float32)
    expected = np.asarray(jax_model.extract_patches(images, patch))
    out = model.extract_patches(torch.from_numpy(images), patch).numpy()
    np.testing.assert_array_equal(out, expected)


def test_weight_bridge_round_trip_exact(tmp_path):
    config = CONFIGS["75px_p17"]
    params = jax_model.init_params(jax.random.PRNGKey(2), config)
    path, port = _bridge(tmp_path, params, config)
    back = params_to_numpy(port)
    with np.load(path) as saved:
        assert sorted(back) == sorted(saved.files)
        for name in saved.files:
            assert back[name].dtype == saved[name].dtype
            np.testing.assert_array_equal(back[name], saved[name])
    again = params_to_numpy(params_from_numpy(back, config))
    for name, value in back.items():
        np.testing.assert_array_equal(again[name], value)


def test_init_params_layout_and_ranges(tmp_path):
    """init_params builds the JAX parameter tree (names, shapes, count)
    with keras-default ranges."""
    config = CONFIGS["flash_k64"]
    jax_params = jax_model.init_params(jax.random.PRNGKey(0), config)
    path = os.path.join(str(tmp_path), "jax.npz")
    save_params_npz(path, jax_params)
    port = model.init_params(config, torch.Generator().manual_seed(0))
    flat = params_to_numpy(port)
    with np.load(path) as saved:
        assert {n: saved[n].shape for n in saved.files} == {
            n: a.shape for n, a in flat.items()}
    assert model.count_params(port) == jax_model.count_params(jax_params)
    for name, value in flat.items():
        if name.endswith("kernel"):
            fan_in, fan_out = model._keras_fans(value.shape)
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(value).max() <= limit and value.std() > 0
        elif name.endswith(("bias", "beta")):
            assert not value.any()
        elif name.endswith("gamma"):
            assert (value == 1).all()
    assert np.abs(flat["position_embedding"]).max() <= 0.05
    same_seed = model.init_params(config, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        params_to_numpy(same_seed)["encoder/1/mha/out/kernel"],
        flat["encoder/1/mha/out/kernel"])


@pytest.mark.parametrize("override", [
    {"attention_window": 1}, {"ring_attention": True},
    {"head_scales": (1, 3)}, {"remat_encoder": True},
    {"sequence_sharding": True}])
def test_unported_features_are_refused(override):
    """Windowed attention, the multi-scale head, remat, ring attention and
    sequence sharding are ported: the model builds and forwards
    (tests/test_torch_highres.py holds them to the JAX package;
    tests/test_torch_parallel.py the ring over a mesh,
    tests/test_torch_sp.py sequence sharding). Without a mesh a ring or a
    sequence-sharded config runs the plain forward, as the JAX forward
    does."""
    config = CONFIGS["flash_k8"].replace(image_size=(48, 48), **override)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    images = torch.from_numpy(_images(config))
    logits = model.forward(params, images, config)
    assert logits.shape == (2, 17, 6) and torch.isfinite(logits).all()
    for name in ("ring_attention", "sequence_sharding"):
        if name in override:
            plain = model.forward(params, images,
                                  config.replace(**{name: False}))
            torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    assert logits.grad_fn is not None


@pytest.mark.parametrize("override", [{"use_fused_ffn": True},
                                      {"use_fused_layer_norm": True}])
def test_kernel_flags_build_and_forward(override):
    """The fused dense+mish and fused LayerNorm flags are ported: a model
    builds and runs its forward (tests/test_torch_fused_kernels.py holds
    the numbers to the JAX package's)."""
    config = CONFIGS["flash_k8"].replace(**override)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        logits = model.forward(params, torch.from_numpy(_images(config)),
                               config)
    assert logits.shape == (2, 17, 6) and torch.isfinite(logits).all()


def test_training_dropout_is_refused():
    """Dropout acts only in training, with a seed (the twin of
    tests/test_model.py::test_dropout_only_active_in_training): eval and
    seedless training are deterministic and equal, two seeds give two
    outputs, one seed gives one."""
    config = CONFIGS["flash_k8"].replace(dropout=0.5)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    images = torch.from_numpy(_images(config))
    with torch.inference_mode():
        eval_1 = model.forward(params, images, config)
        eval_2 = model.forward(params, images, config)
        seedless = model.forward(params, images, config, train=True)
        train_1 = model.forward(params, images, config, train=True,
                                dropout_seed=2)
        train_2 = model.forward(params, images, config, train=True,
                                dropout_seed=3)
        again = model.forward(params, images, config, train=True,
                              dropout_seed=2)
    assert torch.equal(eval_1, eval_2) and torch.equal(eval_1, seedless)
    assert not torch.allclose(train_1, train_2)
    assert torch.equal(train_1, again)


def test_bridge_refuses_mismatched_arrays():
    config = CONFIGS["flash_k8"]
    flat = params_to_numpy(
        model.init_params(config, torch.Generator().manual_seed(0)))
    missing = dict(flat)
    del missing["head_output/bias"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, config)
    misshapen = dict(flat, **{"head_output/bias": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(misshapen, config)
    # One int8 array among float ones matches neither layout (int8
    # models load whole: tests/test_torch_quantization.py).
    quantized = dict(flat, **{"head_mlp/0/kernel_q": np.zeros(1, np.int8)})
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(quantized, config)


def test_tf_carryover_golden_variant(tmp_path):
    """The port's forward on the VARIANT_CFG carry-over weights (converted
    from the reference-named .keras fixture) reproduces the committed
    golden logits that the JAX forward is pinned to."""
    pytest.importorskip("h5py")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(os.path.dirname(here), "tools"))
    from convert_tf_checkpoint import convert, read_keras_weights
    from test_convert import _write_fake_keras
    from test_tf_carryover import VARIANT_CFG, VARIANT_GOLDEN_PATH

    fake = _write_fake_keras(tmp_path, VARIANT_CFG, glorot=True)
    params = convert(read_keras_weights(fake["path"]), VARIANT_CFG)
    _, port = _bridge(tmp_path, params, VARIANT_CFG)
    h, w = VARIANT_CFG.image_size
    images = np.random.default_rng(42).uniform(
        -1.0, 1.0, (1, h, w, 3)).astype(np.float32)
    logits = _port_logits(port, images, VARIANT_CFG)
    golden = np.load(VARIANT_GOLDEN_PATH)["logits"]
    # The JAX forward's own tolerance against this golden.
    np.testing.assert_allclose(logits, golden, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_pad_attention_key_dim_exact_outputs_and_zero_padding_grads(
        tmp_path, flash):
    """The twin of tests/test_model.py's test: key_dim 8 padded to 64 gives
    the same logits (tokens-major and heads-major), the same gradients on
    the real columns and exactly zero on the padding; the padded weights
    equal the JAX package's padded weights, and the padded port forward
    equals the padded JAX forward. fp32, the order of sums only."""
    config = CONFIGS["einsum"].replace(use_flash_attention=flash)
    jax_params = jax_model.init_params(jax.random.PRNGKey(0), config)
    _, params = _bridge(tmp_path, jax_params, config)
    padded = model.pad_attention_key_dim(params, to=64)
    assert padded.encoder[0].mha.query.kernel.shape[-1] == 64
    assert padded.encoder[0].mha.out.kernel.shape[1] == 64
    assert model.pad_attention_key_dim(padded, to=64) is padded
    jax_padded = jax_model.pad_attention_key_dim(jax_params, to=64)
    want_flat = {n: np.asarray(v) for n, v in _jax_flat(jax_padded).items()}
    got_flat = params_to_numpy(padded)
    assert set(got_flat) == set(want_flat)
    for name, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[name], value, err_msg=name)

    images = torch.from_numpy(_images(config))
    want = model.forward(params, images, config)
    for cfg in (config, config.replace(attention_heads_major=True)):
        got = model.forward(padded, images, cfg)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    jax_logits = np.asarray(jax_model.forward(
        jax_padded, images.numpy(), config))
    np.testing.assert_allclose(model.forward(padded, images, config)
                               .detach().numpy(), jax_logits,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)

    def grads(m):
        named = dict(m.named_parameters())
        loss = (model.forward(m, images, config) ** 2).sum()
        return dict(zip(named, torch.autograd.grad(loss,
                                                   list(named.values()))))

    plain, wide = grads(params), grads(padded)
    for b in range(config.encoder_blocks):
        for proj in ("query", "key", "value"):
            name = f"encoder.{b}.mha.{proj}.kernel"
            k = plain[name].shape[-1]
            torch.testing.assert_close(wide[name][..., :k], plain[name],
                                       atol=1e-4, rtol=1e-4)
            assert not wide[name][..., k:].any()
            assert not wide[f"encoder.{b}.mha.{proj}.bias"][..., k:].any()
        name = f"encoder.{b}.mha.out.kernel"
        k = plain[name].shape[1]
        torch.testing.assert_close(wide[name][:, :k], plain[name],
                                   atol=1e-4, rtol=1e-4)
        assert not wide[name][:, k:].any()


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def test_pad_attention_key_dim_refuses_an_int8_model():
    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)

    config = CONFIGS["einsum"]
    params = model.init_params(config, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="before quantize_params"):
        model.pad_attention_key_dim(quantize_params(params))
