"""The port's int8 serving path (kernels/quantization.py) against the JAX
package's on the CPU: the weight codes, both int8 dense routes, the
quantized forward, its mAP and the AP retention after an overfit.

Inputs are made with numpy from seeds. The JAX side's Pallas kernel
(``fused_int8_dense``) runs in interpret mode, as tests/test_quantization.py
runs it; the port's CPU route is the plain version, whose integer product
is an exact int32 matmul.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector_tpu.kernels import quantization as jax_q
from vision_transformer_detector_tpu.models import vit_detector as jax_model
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch.kernels import quantization as q
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.train import trainer
from vision_transformer_detector_tpu_torch.train.optimizer import Adam
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz, params_from_numpy, params_to_numpy)

# tests/test_quantization.py's TINY, and a D = 32 flash variant.
TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)
CONFIGS = {
    "tiny": TINY,
    "flash_k64": DetectorConfig(
        image_size=(48, 48), patch_size=16, embedding_dim=32, num_heads=2,
        key_dim=64, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=16, head_layers=2, use_flash_attention=True),
    "flash_k8_bf16": DetectorConfig(
        image_size=(48, 64), patch_size=16, embedding_dim=32, num_heads=2,
        key_dim=8, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=16, head_layers=2, use_flash_attention=True,
        compute_dtype="bfloat16"),
}


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _port(tmp_path, params, config):
    path = os.path.join(str(tmp_path), "params.npz")
    save_params_npz(path, params)
    return load_params_npz(path, config)


def _images(config, batch=2, seed=0):
    h, w = config.image_size
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (batch, h, w, 3)).astype(np.float32)


def _layer(in_dim, out_shape, seed, mha_out=False):
    """A JAX int8 layer dict and the port's QuantDense with its arrays."""
    rng = np.random.default_rng(seed)
    shape = (in_dim,) + tuple(out_shape)
    if mha_out:
        shape = tuple(out_shape) + (in_dim,)
    kernel = rng.normal(0, 0.3, shape).astype(np.float32)
    bias_shape = (in_dim,) if mha_out else tuple(out_shape)
    bias = rng.normal(0, 0.1, bias_shape).astype(np.float32)
    jax_layer = jax_q._quantize_dense_layer(
        {"kernel": kernel, "bias": bias}, mha_out=mha_out)
    layer = q.QuantDense(jax_layer["kernel_q"].shape[0], bias_shape)
    layer.kernel_q.copy_(torch.from_numpy(np.asarray(jax_layer["kernel_q"])))
    layer.scale.copy_(torch.from_numpy(np.asarray(jax_layer["scale"])))
    layer.bias.copy_(torch.from_numpy(bias))
    return jax_layer, layer


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantize_params_codes_are_bit_equal_to_jax(tmp_path, name):
    config = CONFIGS[name]
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    port = q.quantize_params(_port(tmp_path, params, config))
    expected = _jax_flat(jax_q.quantize_params(params))
    got = params_to_numpy(port)
    # State-dict names are the JAX paths with "." for "/".
    assert set(got) == set(expected)
    for key, want in expected.items():
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert isinstance(port.encoder[0].mha.out, q.QuantDense)
    assert not any(p.requires_grad for p in port.parameters())


def test_quantized_weights_carry_over_through_the_bridge(tmp_path):
    """A JAX quantize_params tree saved with save_params_npz loads into
    the port's int8 model, codes as they are."""
    params = jax_model.init_params(jax.random.PRNGKey(1), TINY)
    qparams = jax_q.quantize_params(params)
    path = str(tmp_path / "int8.npz")
    save_params_npz(path, qparams)
    loaded = load_params_npz(path, TINY)
    assert q.is_quantized(loaded.head_output)
    for key, want in _jax_flat(qparams).items():
        np.testing.assert_array_equal(params_to_numpy(loaded)[key], want)


@pytest.mark.parametrize("in_dim,out_shape,mha_out,lead", [
    (64, (32,), False, (5,)),         # tests/test_quantization.py's layer
    (32, (2, 8), False, (2, 9)),      # q/k/v projection: (H, K) out
    (32, (2, 8), True, (2, 9)),       # out projection: contracts (H, K)
])
def test_int8_dense_matches_jax(in_dim, out_shape, mha_out, lead):
    jax_layer, layer = _layer(in_dim, out_shape, seed=in_dim, mha_out=mha_out)
    width = int(np.prod(out_shape)) if mha_out else in_dim
    x = np.random.default_rng(2).normal(0, 1.0, lead + (width,)).astype(
        np.float32)
    want = np.asarray(jax_q.int8_dense(jnp.asarray(x), jax_layer))
    with torch.no_grad():
        got = q.int8_dense(torch.from_numpy(x), layer).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # The same codes and int32 sums on both sides; the fp32 rescale and
    # bias add may differ by an ulp (XLA can contract them into an FMA).
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert q.int8_dense.launches == 0      # CPU: the plain version


@pytest.mark.parametrize("apply_mish", [False, True])
@pytest.mark.parametrize("lead,k,n", [((3, 7), 200, 96), ((17,), 40, 6)])
def test_fused_int8_dense_matches_jax(apply_mish, lead, k, n):
    """The JAX Pallas kernel in interpret mode against the port's plain
    version: ragged (3, 7, 200) -> 96 as tests/test_quantization.py, and
    the head output's N = 6."""
    jax_layer, layer = _layer(k, (n,), seed=k + n)
    x = np.random.default_rng(1).normal(0, 1.0, lead + (k,)).astype(
        np.float32)
    want = np.asarray(jax_q.fused_int8_dense(
        jnp.asarray(x), jax_layer, apply_mish=apply_mish)).astype(np.float32)
    with torch.no_grad():
        got = q.fused_int8_dense(torch.from_numpy(x), layer,
                                 apply_mish=apply_mish)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == lead + (n,)
    # Identical int math and fp32 epilogue; the bf16 output may round
    # differently where the two fp32 values straddle a rounding point:
    # one bf16 ulp (2^-7 relative).
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    # And the fused route agrees with int8_dense (+ mish) up to the bf16
    # output rounding, as in the JAX package's own test.
    with torch.no_grad():
        x_bf16 = torch.from_numpy(x).to(torch.bfloat16)
        plain = q.int8_dense(x_bf16, layer)
        if apply_mish:
            plain = plain * torch.tanh(torch.nn.functional.softplus(plain))
    np.testing.assert_allclose(got.float().numpy(), plain.numpy(),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantized_forward_matches_jax(tmp_path, name):
    config = CONFIGS[name]
    params = jax_model.init_params(jax.random.PRNGKey(3), config)
    port = q.quantize_params(_port(tmp_path, params, config))
    images = _images(config, seed=3)
    want = np.asarray(jax.jit(lambda p, x: jax_model.forward(p, x, config))(
        jax_q.quantize_params(params), images))
    with torch.inference_mode():
        got = model.forward(port, torch.from_numpy(images), config).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() < 4.0
    # The same int8 codes and sums, and the head's output comes out of the
    # fused kernel in bf16 on both sides. An activation that lands an ulp
    # apart (summation order in softmax and LayerNorm; in bf16 also the
    # rounding points of the attention probabilities) can move one code by
    # 1 at a .5 boundary. fp32 compute: one bf16 ulp at |logit| in [2, 4);
    # bf16 compute: 4 of them. Most logits agree to one bf16 ulp.
    atol = {"float32": 2 ** -6, "bfloat16": 2 ** -4}[config.compute_dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert np.median(np.abs(got - want)) <= 2 ** -7


def test_quantized_model_is_serving_only():
    port = q.quantize_params(
        model.init_params(TINY, torch.Generator().manual_seed(0)))
    images = torch.from_numpy(_images(TINY))
    with pytest.raises(NotImplementedError, match="serving only"):
        model.forward(port, images, TINY, train=True)
    x = torch.ones(2, TINY.head_last_units, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        q.fused_int8_dense(x, port.head_output)
    # A frozen model needs no no_grad: nothing in it requires grad.
    assert model.forward(port, images, TINY).shape == (2, 17, 6)


def test_quantized_evaluate_map_equals_jax(tmp_path):
    """evaluate_map on the same carried weights, quantized on each side,
    over seeded data whose labels the model's own decoded output nearly
    matches (so AP is above 0)."""
    params = jax_model.init_params(jax.random.PRNGKey(4), TINY)
    qparams = jax_q.quantize_params(params)
    port = q.quantize_params(_port(tmp_path, params, TINY))
    images = _images(TINY, batch=4, seed=4)
    decoded = np.asarray(jax_trainer.make_eval_step(TINY)(qparams, images))
    labels = decoded.copy()
    labels[..., 0] = (decoded[..., 0] > 0.5).astype(np.float32)
    labels[..., 1] = np.round(decoded[..., 1])
    labels[labels[..., 0] == 0, 1:] = -8.0
    data = [(images, labels)]
    want = jax_trainer.evaluate_map(qparams, data, TINY)
    got = trainer.evaluate_map(port, data, TINY, device="cpu")
    assert got == pytest.approx(float(want), abs=1e-6)


@pytest.mark.slow
def test_quantized_ap_retention(tmp_path):
    """The port's twin of tests/test_quantization.py::
    test_quantized_ap_retention, from the JAX test's initial weights:
    overfit a tiny detector for 5,000 steps, quantize it, and the
    streaming mAP must hold. About 50 s on one CPU core, hence ``slow``."""
    h, w = TINY.image_size
    rng_np = np.random.default_rng(0)
    images = torch.from_numpy(
        rng_np.uniform(-1, 1, (2, h, w, 3)).astype(np.float32))
    labels = np.full((2, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    labels[1, 0] = (1, 40, 10.0, 20.0, 8.0, 12.0)

    params = _port(tmp_path, jax_model.init_params(jax.random.PRNGKey(0),
                                                   TINY), TINY)
    optimizer = Adam(TrainConfig(learning_rate=2e-4))
    state = {"params": params,
             "opt_state": optimizer.init(dict(params.named_parameters())),
             "step": 0}
    step = trainer.make_train_step(TINY, LossConfig(), optimizer)
    for _ in range(5000):  # AP 0.5 on this pair (as the JAX test measures)
        state, _ = step(state, images, torch.from_numpy(labels))

    data = [(images, labels)]
    ap_fp32 = trainer.evaluate_map(state["params"], data, TINY)
    ap_int8 = trainer.evaluate_map(q.quantize_params(state["params"]), data,
                                   TINY)
    assert ap_fp32 >= 0.4, "fp32 overfit did not learn; test is vacuous"
    assert ap_int8 >= ap_fp32 - 0.1


def test_params_from_numpy_round_trips_the_int8_model():
    port = q.quantize_params(
        model.init_params(TINY, torch.Generator().manual_seed(5)))
    flat = params_to_numpy(port)
    again = params_to_numpy(params_from_numpy(flat, TINY))
    assert set(again) == set(flat)
    for key, value in flat.items():
        assert again[key].dtype == value.dtype
        np.testing.assert_array_equal(again[key], value)
