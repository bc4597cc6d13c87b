"""PyTorch flash attention (plain version on the CPU) vs the JAX kernel.

The same numpy inputs go through the JAX package's ``flash_attention``
(the Pallas kernel in interpret mode on the CPU, as tests/test_kernels.py
runs it) and the port's ``flash_attention`` on CPU tensors, which takes
the plain ``reference_attention``. The CUDA kernel itself is checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from vision_transformer_detector_tpu_torch.kernels import _build
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)

# fp32: both sides compute fp32 softmax(q k^T) v and differ only in
# summation order (the JAX package's own kernel-vs-oracle tolerance).
FP32_TOL = 2e-5
# bf16: probabilities round to bf16 at different running maxima (blocked
# vs materialised softmax); the JAX package's bf16 contract is ~1e-2.
BF16_TOL = 2e-2


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    return (q / np.float32(np.sqrt(shape[-1]))), k, v


@pytest.mark.parametrize("layout,n,kdim", [
    ("bnhk", 196, 64),     # aligned K, one 128-multiple short of 256
    ("bhnk", 196, 64),
    ("bnhk", 100, 8),      # ragged N, K padded to 64 by the JAX wrapper
    ("bhnk", 130, 8),
])
def test_matches_jax_flash_fp32(layout, n, kdim):
    shape = (2, n, 3, kdim) if layout == "bnhk" else (2, 3, n, kdim)
    q, k, v = _qkv(shape)
    expected = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=128,
                                   block_kv=128, layout=layout)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), layout=layout)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               atol=FP32_TOL, rtol=FP32_TOL)


def test_matches_jax_flash_bf16():
    q, k, v = _qkv((1, 2, 128, 64), seed=3)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    expected = jax_flash_attention(jq, jk, jv, block_q=128, block_kv=128,
                                   layout="bhnk")
    tq, tk, tv = (torch.tensor(np.asarray(t.astype(jnp.float32)))
                  .to(torch.bfloat16) for t in (jq, jk, jv))
    out = fa.flash_attention(tq, tk, tv, layout="bhnk")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain version, also with ``with_lse``, which
    the CUDA kernel does not offer yet: no build, no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was requested on the CPU")

    monkeypatch.setattr(_build, "load_library", refuse)
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 50, 16), seed=1))
    before = fa.flash_attention.launches
    for layout, args in (("bhnk", (q, k, v)),
                         ("bnhk", tuple(t.transpose(1, 2)
                                        for t in (q, k, v)))):
        out, lse = fa.flash_attention(*args, layout=layout, with_lse=True)
        np.testing.assert_array_equal(
            out.numpy(), fa.reference_attention(*args, layout=layout).numpy())
        scores = torch.einsum("bhnk,bhmk->bhnm", q, k)
        np.testing.assert_allclose(lse.numpy(),
                                   torch.logsumexp(scores, -1).numpy(),
                                   atol=1e-5, rtol=1e-6)
    assert fa.flash_attention.launches == before


def test_non_cpu_tensors_do_not_take_the_plain_path():
    """A tensor that is not on the CPU reaches the kernel or raises; here
    (no CUDA) it can only raise."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        fa.flash_attention(q, q, q)
    cpu = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        fa.flash_attention(cpu, cpu, q)


@pytest.mark.parametrize("kwargs,error", [
    ({"layout": "nbhk"}, ValueError),
    ({"dropout_rate": 0.1, "dropout_seed": 3}, NotImplementedError),
])
def test_rejected_arguments(kwargs, error):
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(error):
        fa.flash_attention(q, q, q, **kwargs)


def test_reference_attention_layouts_agree():
    q, k, v = (torch.from_numpy(t) for t in _qkv((2, 3, 40, 16), seed=2))
    heads_major = fa.reference_attention(q, k, v, layout="bhnk")
    tokens_major = fa.reference_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), layout="bnhk")
    np.testing.assert_array_equal(heads_major.numpy(),
                                  tokens_major.transpose(1, 2).numpy())
