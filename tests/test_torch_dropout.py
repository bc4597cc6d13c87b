"""Attention dropout of the port (the plain versions, on the CPU) against
the JAX package.

The keep mask and threshold are held bit-equal to JAX's
``dropout_keep_mask`` and ``_keep_threshold``; the plain attention with
dropout, forward and grads, against the JAX ``flash_attention`` with the
same rate and seed (its Pallas forward in interpret mode, its chunked
backward, which replays the mask). The port's own MLP masks (a
``torch.Generator`` stream, not JAX's threefry) are held statistically.
The CUDA kernels' masks are read back and compared bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.kernels import (
    flash_attention as jax_fa)
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.models import vit_detector as model

# The JAX package's kernel contract (flash_attention.py:12-14): fp32 to
# summation order, bf16 ~1e-2 (p rounds to bf16 at other points). Grads
# relative to the largest one.
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}

_BH = np.array([0, 1, 2, 3, 255, 256, 1023, 2047, 4095])
_POS_Q = np.arange(0, 4096, 31)
_POS_K = np.arange(0, 4096, 37)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_keep_mask_and_threshold_bit_equal_to_jax(seed):
    bh, q, k = _BH[:, None, None], _POS_Q[None, :, None], _POS_K[None, None, :]
    for rate in (0.1, 0.25, 0.5):
        threshold = fa._keep_threshold(rate)
        assert threshold == jax_fa._keep_threshold(rate)
        want = np.asarray(jax_fa.dropout_keep_mask(
            jnp.uint32(seed), jnp.asarray(bh, jnp.uint32),
            jnp.asarray(q, jnp.uint32), jnp.asarray(k, jnp.uint32),
            threshold))
        got = fa.dropout_keep_mask(seed, torch.from_numpy(bh),
                                   torch.from_numpy(q), torch.from_numpy(k),
                                   threshold)
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(t, jnp.dtype(dtype))
                      for t in (q / np.float32(np.sqrt(shape[-1])), k, v, g))
    to_torch = lambda t: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(t, jnp.float32))).to(getattr(torch, dtype))
    return (jq, jk, jv, jg), tuple(to_torch(t) for t in (jq, jk, jv, jg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,shape", [
    ("bnhk", (2, 100, 3, 40)),    # ragged N, K = 40 padded to 64 (JAX)
    ("bhnk", (1, 2, 130, 64)),    # ragged N, K = 64
])
def test_dropout_attention_matches_jax(layout, shape, dtype):
    """Forward and dq/dk/dv of the port's flash_attention (plain versions)
    with dropout, against the JAX flash attention (interpret-mode kernel,
    chunked backward with the replayed mask) at rate 0.25, seed 1234."""
    rate, seed = 0.25, 1234
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype, seed=5)
    out, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, block_q=128, block_kv=128, layout=layout, interpret=True,
        dropout_rate=rate, dropout_seed=jnp.uint32(seed)), jq, jk, jv)
    expected = vjp(jg)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = fa.flash_attention(*leaves, layout=layout, dropout_rate=rate,
                             dropout_seed=seed)
    tol = TOLS[dtype]
    assert got.dtype == tq.dtype and tuple(got.shape) == shape
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out, np.float32), atol=tol,
                               rtol=tol)
    grads = torch.autograd.grad(got, leaves, tg)
    for name, mine, ref in zip("qkv", grads, expected):
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(mine.float().numpy(), ref, rtol=0,
                                   atol=tol * scale, err_msg=f"d{name}")


def test_plain_dropout_is_the_masked_oracle():
    """reference_attention with dropout is softmax * keep / (1 - rate)
    with the mask of the kernels' batch*head numbering (b * H + h), in both
    layouts; the lse does not change."""
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (2, 3, 40, 16)).astype(np.float32)) for i in range(3))
    rate, seed = 0.5, 7
    got = fa.reference_attention(q, k, v, "bhnk", (seed, rate))
    pos = torch.arange(40)
    keep = fa.dropout_keep_mask(seed, torch.arange(6).reshape(2, 3, 1, 1),
                                pos[:, None], pos[None, :],
                                fa._keep_threshold(rate))
    probs = torch.softmax(torch.einsum("bhnk,bhmk->bhnm", q, k), -1)
    want = torch.einsum("bhnm,bhmk->bhnk", probs * keep / (1 - rate), v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    tokens_major = fa.reference_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), "bnhk", (seed, rate))
    torch.testing.assert_close(tokens_major.transpose(1, 2), got, atol=0,
                               rtol=0)


@pytest.mark.parametrize("kwargs,match", [
    ({"dropout_rate": 1.0, "dropout_seed": 1}, "must be in"),
    ({"dropout_rate": -0.1, "dropout_seed": 1}, "must be in"),
    ({"dropout_rate": 0.1}, "needs a dropout_seed"),
])
def test_dropout_arguments_are_checked(kwargs, match):
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, q, q, **kwargs)


def test_rate_zero_or_none_is_no_dropout():
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (1, 20, 2, 8)).astype(np.float32)) for i in range(3))
    plain = fa.flash_attention(q, k, v)
    for rate in (None, 0.0, 0):
        torch.testing.assert_close(
            fa.flash_attention(q, k, v, dropout_rate=rate, dropout_seed=3),
            plain, atol=0, rtol=0)


def test_seed_wraps_to_uint32():
    """A seed is taken mod 2**32, as the JAX wrapper's uint32 cast."""
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (1, 30, 2, 8)).astype(np.float32)) for i in range(3))
    kw = {"dropout_rate": 0.3}
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, dropout_seed=-1, **kw),
        fa.flash_attention(q, k, v, dropout_seed=2 ** 32 - 1, **kw),
        atol=0, rtol=0)


def test_attention_dropout_is_unbiased():
    """Averaged over many seeds, attention with dropout approaches the
    output without it (inverted scaling)."""
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (1, 64, 1, 16)).astype(np.float32)) for i in range(3))
    base = fa.flash_attention(q, k, v)
    mean = torch.stack([fa.flash_attention(q, k, v, dropout_rate=0.5,
                                           dropout_seed=s)
                        for s in range(256)]).mean(0)
    err = (mean - base).abs().mean() / base.abs().mean()
    assert err < 0.1, err


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mlp_dropout_masks_keep_rate_and_mean(rate):
    """The MLP/head dropout's masks (a torch.Generator stream of
    Bernoulli(1 - rate)): keep rate within 0.5 % of 1 - rate, mean
    unbiased, a pure function of the seed, other seeds uncorrelated."""
    x = torch.ones(512, 1024)
    out = model._dropout(x, rate, 11, train=True)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    assert abs(out.mean().item() - 1.0) < 0.01
    assert torch.equal(out, model._dropout(x, rate, 11, train=True))
    other = model._dropout(x, rate, 12, train=True) != 0
    agree = (kept == other).float().mean().item()
    assert abs(agree - ((1 - rate) ** 2 + rate ** 2)) < 0.005
    assert model._dropout(x, rate, 11, train=False) is x
    assert model._dropout(x, rate, None, train=True) is x


def test_dropout_seed_table_is_pure():
    """dropout_seeds derives one seed per attention, MLP and head layer
    from one integer: the same integer, the same table; distinct seeds
    across layers; uint32 attention seeds."""
    from vision_transformer_detector_tpu_torch import get_config

    config = get_config("highres_1024")
    table = model.dropout_seeds(5, config)
    assert table == model.dropout_seeds(5, config)
    assert table != model.dropout_seeds(6, config)
    assert len(table.attention) == len(table.mlp) == config.encoder_blocks
    assert all(len(m) == config.encoder_mlp_layers for m in table.mlp)
    assert len(table.head) == len(config.head_units)
    flat = [*table.attention, *(s for m in table.mlp for s in m),
            *table.head]
    assert len(set(flat)) == len(flat)
    assert all(0 <= s < 2 ** 32 for s in flat)
