"""The port's fused LayerNorm (kernels/fused_ln.py) and fused dense+mish
(kernels/fused_ffn.py) against the JAX package's on the CPU, alone and in
the model: values, gradients, routing and a use_fused_ffn train step.

Inputs are made with numpy from seeds. The JAX side's Pallas kernels run
in interpret mode, as tests/test_kernels.py runs them; the port's CPU
route is the plain version of each kernel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector_tpu.kernels import fused_ffn as jax_ffn
from vision_transformer_detector_tpu.kernels import fused_ln as jax_ln
from vision_transformer_detector_tpu.models import vit_detector as jax_model
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch.kernels import fused_ffn, fused_ln
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.train import trainer
from vision_transformer_detector_tpu_torch.train.optimizer import Adam
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz, params_to_numpy)

# tests/test_kernels.py's tolerances: fp32 1e-5, bf16 2e-2.
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) * scale
            + shift).astype(np.float32)


def _to_port(array, dtype):
    return torch.from_numpy(np.asarray(array, np.float32)).to(_DTYPES[dtype])


def _port(tmp_path, params, config):
    path = os.path.join(str(tmp_path), "params.npz")
    save_params_npz(path, params)
    return load_params_npz(path, config)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 7, 256), (1, 1, 128),
                                   (2, 4224), (3, 6144), (2, 8192)])
def test_fused_layer_norm_matches_jax(dtype, shape):
    """The wrapper on CPU tensors (the plain version) against JAX's Pallas
    kernel, at the widths of the kernel's warp route and past D 4096,
    where the card runs a block a row (ViT-22B's 6144 among them)."""
    x = _np(shape, 0, scale=3.0, shift=1.0)
    gamma, beta = _np(shape[-1:], 1), _np(shape[-1:], 2)
    x_jax = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_ln.fused_layer_norm(
        x_jax, jnp.asarray(gamma), jnp.asarray(beta)), np.float32)
    got = fused_ln.fused_layer_norm(_to_port(np.asarray(
        x_jax, np.float32), dtype), torch.from_numpy(gamma),
        torch.from_numpy(beta))
    assert got.dtype == _DTYPES[dtype] and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    assert fused_ln.fused_layer_norm.launches == 0     # CPU: plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4224, 6144, 8192])
def test_layer_norm_reference_past_4096_matches_jax(dtype, d):
    """The plain version itself, the kernel's yardstick on the card, at
    widths past the warp route: JAX's kernel in interpret mode, a few
    rows."""
    x = _np((4, d), 3, scale=2.0, shift=-1.0)
    gamma, beta = _np((d,), 4), _np((d,), 5)
    x_jax = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_ln.fused_layer_norm(
        x_jax, jnp.asarray(gamma), jnp.asarray(beta)), np.float32)
    got = fused_ln.layer_norm_reference(
        _to_port(np.asarray(x_jax, np.float32), dtype),
        torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == _DTYPES[dtype] and tuple(got.shape) == (4, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOLS[dtype],
                               rtol=TOLS[dtype])


def test_fused_layer_norm_sets_no_upper_width():
    """Any D % 128 == 0 is taken, as JAX's kernel takes it: the wrapper
    returns the plain version on CPU tensors, and its kernel launch checks
    no largest D (the kernel's warp route ends at 4096, its block route
    has no limit), so a CPU tensor passes every check and reaches the
    operator, which has no CPU kernel."""
    for d in (4224, 6144, 65536):
        x = torch.randn(2, d)
        got = fused_ln.fused_layer_norm(x, torch.ones(d), torch.zeros(d))
        torch.testing.assert_close(got, fused_ln.layer_norm_reference(
            x, torch.ones(d), torch.zeros(d)), atol=0, rtol=0)
        with pytest.raises(NotImplementedError, match="CPU"):
            fused_ln._launch(x, torch.ones(d), torch.zeros(d), 1e-3)


def test_fused_layer_norm_empty_batch_and_unaligned_dim():
    x = torch.zeros(0, 7, 128)
    assert fused_ln.fused_layer_norm(x, torch.ones(128), torch.zeros(128)) \
        is x
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_ln.fused_layer_norm(torch.ones(2, 5, 28), torch.ones(28),
                                  torch.zeros(28))


def test_fused_layer_norm_is_inference_only():
    gamma = torch.ones(128, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_ln.fused_layer_norm(torch.ones(2, 128), gamma,
                                  torch.zeros(128))
    with torch.no_grad():
        assert fused_ln.fused_layer_norm(torch.ones(2, 128), gamma,
                                         torch.zeros(128)).shape == (2, 128)


# ---------------------------------------------------------------------------
# Dense + mish
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,k,n,apply_mish", [
    ((3, 40), 96, 176, True), ((17,), 200, 300, True), ((5, 2), 64, 6,
                                                           False)])
def test_fused_dense_mish_matches_jax(dtype, lead, k, n, apply_mish):
    x, w, b = _np(lead + (k,), 0), _np((k, n), 1, 0.1), _np((n,), 2, 0.1)
    args = [jnp.asarray(a).astype(dtype) for a in (x, w, b)]
    want = np.asarray(jax_ffn.fused_dense_mish(*args, apply_mish=apply_mish),
                      np.float32)
    got = fused_ffn.fused_dense_mish(
        *(_to_port(np.asarray(a, np.float32), dtype) for a in args),
        apply_mish=apply_mish)
    assert got.dtype == _DTYPES[dtype] and tuple(got.shape) == lead + (n,)
    # The same fp32 products (bf16 x bf16 is exact in fp32) summed in
    # another order; in bf16 one output rounding apart.
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    assert fused_ffn.fused_dense_mish.launches == 0   # CPU: plain version


@pytest.mark.parametrize("apply_mish", [True, False])
def test_fused_dense_mish_grads_match_jax(apply_mish):
    """The Function's recompute backward against jax.grad of the JAX
    fused_dense_mish (its custom VJP), for x, w and b; tolerances of
    tests/test_kernels.py's gradient test."""
    x, w = _np((3, 40, 96), 0), _np((96, 176), 1, 0.1)
    b, cot = _np((176,), 2, 0.1), _np((3, 40, 176), 3)

    def jax_loss(x, w, b):
        return jnp.sum(jax_ffn.fused_dense_mish(
            x, w, b, apply_mish=apply_mish) * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = fused_ffn.fused_dense_mish(*leaves, apply_mish=apply_mish)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# In the model
# ---------------------------------------------------------------------------

_SMALL = dict(image_size=(48, 48), patch_size=16, num_heads=2,
              encoder_blocks=2, encoder_mlp_layers=2, head_last_units=16,
              head_layers=2)
CONFIGS = {
    # D = 128: the fused LayerNorm routes at inference.
    "fused_ln_d128": DetectorConfig(embedding_dim=128, key_dim=64,
                                    use_flash_attention=True,
                                    use_fused_layer_norm=True, **_SMALL),
    "fused_ffn_k8": DetectorConfig(embedding_dim=32, key_dim=8,
                                   use_fused_ffn=True, **_SMALL),
    "fused_ffn_ln_bf16": DetectorConfig(
        embedding_dim=128, key_dim=64, use_flash_attention=True,
        use_fused_ffn=True, use_fused_layer_norm=True,
        compute_dtype="bfloat16", **_SMALL),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_with_fused_kernels_matches_jax(tmp_path, name):
    config = CONFIGS[name]
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    port = _port(tmp_path, params, config)
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 48, 48, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_model.forward(p, x, config))(
        params, images))
    with torch.inference_mode():
        got = model.forward(port, torch.from_numpy(images), config).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # fp32: summation order only (tests/test_torch_model.py's 1e-4); bf16:
    # 4 bf16 ulps at |logit| < 4 (PyTorch rounds the plain layers' bf16
    # matmuls before the bias add, as tests/test_torch_model.py's bf16
    # forward test allows).
    assert np.abs(want).max() < 4.0
    atol = 1e-4 if config.compute_dtype == "float32" else 4 * 2 ** -6
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fused_layer_norm_routes_inference_only():
    """The flag routes inference only, and only for D % 128 == 0;
    training output is bit-identical to flag-off (the twin of
    tests/test_kernels.py::test_fused_ln_model_routing)."""
    config = CONFIGS["fused_ln_d128"].replace(use_fused_layer_norm=False)
    fused = config.replace(use_fused_layer_norm=True)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 48, 48, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.forward(params, images, fused),
                                   model.forward(params, images, config),
                                   atol=1e-4, rtol=1e-4)
    # train=True keeps the differentiable LayerNorm: no refusal, and
    # bit-identical to the flag off.
    torch.testing.assert_close(
        model.forward(params, images, fused, train=True),
        model.forward(params, images, config, train=True), atol=0, rtol=0)
    # D = 32 is not a multiple of 128: the flag changes nothing.
    narrow = CONFIGS["fused_ffn_k8"].replace(use_fused_ffn=False)
    narrow_params = model.init_params(narrow,
                                      torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(
            model.forward(narrow_params, images,
                          narrow.replace(use_fused_layer_norm=True)),
            model.forward(narrow_params, images, narrow), atol=0, rtol=0)


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def test_fused_ffn_train_step_matches_jax(tmp_path):
    """One train step with use_fused_ffn, the port against the JAX step
    (the twin of tests/test_kernels.py::test_fused_ffn_trains_end_to_end,
    held to the JAX step's numbers as tests/test_torch_train.py holds the
    plain step)."""
    config = DetectorConfig(
        image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
        encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8,
        head_layers=1, use_fused_ffn=True)
    train = TrainConfig(learning_rate=1e-4)
    images = np.random.default_rng(1).uniform(
        -1, 1, (2, 34, 34, 3)).astype(np.float32)
    labels = np.full((2, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)

    jax_params = jax_model.init_params(jax.random.PRNGKey(0), config)
    optimizer = jax_opt.make_optimizer(train)
    step = jax_trainer.make_train_step(config, LossConfig(), optimizer,
                                       donate=False)
    jax_state = {"params": jax_params, "opt_state": optimizer.init(jax_params),
                 "step": jnp.zeros((), jnp.int32)}
    jax_state, jax_loss = step(jax_state, jnp.asarray(images),
                               jnp.asarray(labels), jax.random.PRNGKey(2))

    port = _port(tmp_path, jax_params, config)
    port_opt = Adam(train)
    state = {"params": port,
             "opt_state": port_opt.init(dict(port.named_parameters())),
             "step": 0}
    state, loss = trainer.make_train_step(config, LossConfig(), port_opt)(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    lr = train.learning_rate
    for name, want in _jax_flat(jax_state["params"]).items():
        diff = np.abs(params_to_numpy(port)[name] - want)
        # Adam moves each weight by at most ~lr; a gradient that is noise
        # on both sides (the attention key bias) may move it the other way.
        assert diff.max() <= 2 * lr + 1e-6, name
        if not name.endswith("mha/key/bias"):
            assert np.mean(diff > 1e-6) <= 0.01, name


# ---------------------------------------------------------------------------
# Dispatch by shape
# ---------------------------------------------------------------------------

# The pyramid layers (encoder MLP, head MLP: what use_fused_ffn hands the
# wrapper) of each preset whose K or N is not a multiple of 8: in bf16 they
# take the kernel's guarded instance on the card. In fp32 (multiples of 4)
# every pyramid layer of every preset takes the tensor cores.
GUARDED_BF16 = {
    "tiny_96": {"head_mlp.0"},
    "reference_608": {"encoder.mlp.0", "encoder.mlp.7"},
    "reference_224": {"encoder.mlp.0", "encoder.mlp.7", "head_mlp.0"},
    "vit_s16_224": {"head_mlp.0"},
    "vit_b16_384": set(),
    "vit_l16_640": set(),
    "highres_1024": set(),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", sorted(GUARDED_BF16))
def test_tensor_core_dispatch_on_every_pyramid_layer_of_a_preset(preset,
                                                                 dtype):
    from vision_transformer_detector_tpu_torch import get_config

    with torch.device("meta"):
        net = model.ViTDetector(get_config(preset))
    guarded, seen = set(), 0
    for name, module in net.named_modules():
        parts = name.split(".")
        if not isinstance(module, model.Dense) or "mlp" not in name:
            continue
        seen += 1
        k, n = module.kernel.shape
        if not fused_ffn.tensor_core_shape(k, n, _DTYPES[dtype]):
            if parts[0] == "encoder":
                del parts[1]
            guarded.add(".".join(parts))
    assert seen >= 3
    assert guarded == (GUARDED_BF16[preset] if dtype == "bfloat16" else set())


@pytest.mark.parametrize("k,n,dtype,takes", [
    (768, 1536, "bfloat16", True), (768, 17, "bfloat16", False),
    (28, 3584, "bfloat16", False), (28, 3584, "float32", True),
    (512, 6, "float32", False), (40, 64, "bfloat16", True),
    (30, 64, "float32", False), (64, 0, "float32", False)])
def test_tensor_core_shape_is_whole_16_byte_rows_of_x_and_w(k, n, dtype,
                                                            takes):
    assert fused_ffn.tensor_core_shape(k, n, _DTYPES[dtype]) is takes
