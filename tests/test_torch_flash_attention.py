"""PyTorch flash attention (plain versions on the CPU) vs the JAX kernels.

The same numpy inputs go through the JAX package's ``flash_attention``
(the Pallas kernels in interpret mode on the CPU, as tests/test_kernels.py
runs them) and the port's ``flash_attention`` on CPU tensors, which takes
the plain versions: the forward, its logsumexp, and the backward against
``jax.vjp`` with both JAX backwards (the chunked recomputation and the
Pallas kernel B2). The autograd wiring of the kernel route is checked
here with the two launch functions replaced by plain stand-ins; the CUDA
kernels themselves are checked on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.kernels.flash_attention import (
    _flash_forward as jax_flash_forward)
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


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


@pytest.mark.parametrize("layout,shape", [
    ("bnhk", (2, 100, 2, 40)),    # ragged N, K = 40 padded to 64 (JAX)
    ("bhnk", (1, 2, 70, 64)),
])
def test_plain_lse_matches_jax_with_lse_kernel(layout, shape):
    q, k, v = _qkv(shape, seed=4)
    _, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 128, 128, True, with_lse=True,
                               layout=layout)
    b, h = shape[0], (shape[2] if layout == "bnhk" else shape[1])
    n = shape[1] if layout == "bnhk" else shape[2]
    expected = np.asarray(lse)[:, 0, :n].reshape(b, h, n)
    got = fa.reference_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                     layout)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, n)
    np.testing.assert_allclose(got.numpy(), expected, atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("pallas_backward", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,shape", [
    ("bnhk", (1, 100, 2, 40)),    # ragged N, K = 40 padded to 64 (JAX)
    ("bhnk", (1, 2, 70, 64)),
])
def test_plain_backward_matches_jax_grad(layout, shape, dtype,
                                         pallas_backward):
    """dq/dk/dv of the port's plain backward vs ``jax.vjp`` of the JAX
    flash attention, with its chunked backward or its Pallas backward
    kernel (interpret mode). Tolerance relative to the largest gradient:
    fp32 2e-5; bf16 2e-2 (p and ds round to bf16 at other points)."""
    q, k, v = _qkv(shape, seed=5)
    g = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jdtype = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(t, jdtype) for t in (q, k, v, g))
    out, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(
        a, b_, c, block_q=128, block_kv=128, layout=layout,
        use_pallas_backward=pallas_backward), jq, jk, jv)
    expected = vjp(jg)
    tdtype = getattr(torch, dtype)
    tq, tk, tv, tg = (_to_torch(t, tdtype) for t in (jq, jk, jv, jg))
    got = fa.reference_attention_backward(tq, tk, tv, tg, layout)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for name, mine, ref in zip("qkv", got, expected):
        assert mine.dtype == tdtype and tuple(mine.shape) == shape
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(mine.float().numpy(), ref, rtol=0,
                                   atol=tol * scale, err_msg=f"d{name}")


def _plain_launch_forward(q, k, v, layout, with_lse=False):
    out = fa.reference_attention(q, k, v, layout)
    return (out, fa.reference_attention_lse(q, k, layout)) if with_lse else out


def _plain_launch_backward(q, k, v, g, lse, delta, layout):
    """What the backward kernel computes, from lse and delta (fp32)."""
    qh, kh, vh, gh = (fa._heads_major(t, layout).float() for t in (q, k, v, g))
    p = torch.exp(torch.einsum("bhnk,bhmk->bhnm", qh, kh) - lse[..., None])
    ds = p * (torch.einsum("bhnk,bhmk->bhnm", gh, vh) - delta[..., None])
    grads = (torch.einsum("bhnm,bhmk->bhnk", ds, kh),
             torch.einsum("bhnm,bhnk->bhmk", ds, qh),
             torch.einsum("bhnm,bhnk->bhmk", p, gh))
    return tuple(fa._heads_major(t.to(q.dtype), layout) for t in grads)


@pytest.mark.parametrize("layout,shape", [("bnhk", (2, 37, 3, 40)),
                                          ("bhnk", (2, 3, 37, 64))])
def test_kernel_route_is_differentiable(monkeypatch, layout, shape):
    """The kernel route's autograd wiring, on the CPU: with the two launch
    functions standing in as plain versions, the output has a grad_fn and
    its grads equal autograd through reference_attention. (Before the
    Function existed, the kernel route returned a tensor filled through
    ctypes, with no grad_fn: q/k/v got no gradient from attention.)"""
    calls = []

    def forward(*args, **kwargs):
        calls.append("forward")
        return _plain_launch_forward(*args, **kwargs)

    def backward(*args):
        calls.append("backward")
        return _plain_launch_backward(*args)

    monkeypatch.setattr(fa, "_launch_forward", forward)
    monkeypatch.setattr(fa, "_launch_backward", backward)
    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv(shape, seed=7))
    g = torch.from_numpy(
        np.random.default_rng(8).standard_normal(shape).astype(np.float32))
    out = fa.FlashAttentionFunction.apply(q, k, v, layout, True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    assert calls == ["forward", "backward"]
    expected = torch.autograd.grad(fa.reference_attention(q, k, v, layout),
                                   (q, k, v), g)
    for mine, ref in zip(got, expected):
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=FP32_TOL,
                                   rtol=FP32_TOL)


def test_cpu_grads_take_the_plain_backward(monkeypatch):
    """Inputs that require grad on the CPU go through the Function with
    the plain versions: a grad_fn, the same grads as autograd through
    reference_attention, no kernel build, no launch count."""
    monkeypatch.setattr(_build, "load_library", lambda *a: pytest.fail(
        "the CUDA library was requested on the CPU"))
    counts = (fa.flash_attention.launches, fa.flash_attention.lse_launches,
              fa.flash_attention.backward_launches)
    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv((1, 20, 2, 8), seed=9))
    out = fa.flash_attention(q, k, v, layout="bnhk")
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.sum(), (q, k, v))
    expected = torch.autograd.grad(
        fa.reference_attention(q, k, v).sum(), (q, k, v))
    for mine, ref in zip(got, expected):
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=FP32_TOL)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert counts == (fa.flash_attention.launches,
                      fa.flash_attention.lse_launches,
                      fa.flash_attention.backward_launches)
