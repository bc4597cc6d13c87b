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
    ({"dropout_rate": 1.0, "dropout_seed": 3}, ValueError),
])
def test_rejected_arguments(kwargs, error):
    """An unknown layout, and a dropout rate outside (0, 1), raise the JAX
    wrapper's errors."""
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


def _plain_launch_forward(q, k, v, layout, with_lse=False, dropout=None,
                          offsets=(0, 0, 0)):
    out = fa.reference_attention(q, k, v, layout, dropout, offsets)
    return (out, fa.reference_attention_lse(q, k, layout)) if with_lse else out


def _plain_launch_backward(q, k, v, g, lse, delta, layout, dropout=None,
                           offsets=(0, 0, 0)):
    """What the backward kernel computes, from lse and delta (fp32), with
    the dropout replay: scale = keep / (1 - rate) on p for dv and on g v^T
    for ds."""
    qh, kh, vh, gh = (fa._heads_major(t, layout).float() for t in (q, k, v, g))
    p = torch.exp(torch.einsum("bhnk,bhmk->bhnm", qh, kh) - lse[..., None])
    scale = 1.0
    if dropout is not None:
        b, h, n, _ = p.shape
        scale = fa._dropout_scale(dropout, b, h, n, p.device, offsets)
    dp = scale * torch.einsum("bhnk,bhmk->bhnm", gh, vh)
    ds = p * (dp - delta[..., None])
    grads = (torch.einsum("bhnm,bhmk->bhnk", ds, kh),
             torch.einsum("bhnm,bhnk->bhmk", ds, qh),
             torch.einsum("bhnm,bhnk->bhmk", scale * p, gh))
    return tuple(fa._heads_major(t.to(q.dtype), layout) for t in grads)


@pytest.mark.parametrize("dropout", [None, (2 ** 32 - 1, 0.25)])
@pytest.mark.parametrize("layout,shape", [("bnhk", (2, 37, 3, 40)),
                                          ("bhnk", (2, 3, 37, 64))])
def test_kernel_route_is_differentiable(monkeypatch, layout, shape,
                                        dropout):
    """The kernel route's autograd wiring, on the CPU: with the two launch
    functions standing in as plain versions, the output has a grad_fn and
    its grads equal autograd through reference_attention. (Before the
    Function existed, the kernel route returned a tensor filled through
    ctypes, with no grad_fn: q/k/v got no gradient from attention.)"""
    calls = []

    def forward(*args, **kwargs):
        calls.append("forward")
        return _plain_launch_forward(*args, **kwargs)

    def backward(*args, **kwargs):
        calls.append("backward")
        return _plain_launch_backward(*args, **kwargs)

    monkeypatch.setattr(fa, "_launch_forward", forward)
    monkeypatch.setattr(fa, "_launch_backward", backward)
    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv(shape, seed=7))
    g = torch.from_numpy(
        np.random.default_rng(8).standard_normal(shape).astype(np.float32))
    out = fa.FlashAttentionFunction.apply(q, k, v, layout, True, dropout)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    assert calls == ["forward", "backward"]
    # With dropout, the kernels' delta = rowsum(g * dropped out) gives
    # autograd's gradient through dropout-after-softmax.
    expected = torch.autograd.grad(
        fa.reference_attention(q, k, v, layout, dropout), (q, k, v), g)
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


# ---------------------------------------------------------------------------
# What the kernels are handed: head dims padded to 48, 64 or 128, 16-byte
# rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kdim,width", [(8, 48), (40, 48), (48, 48),
                                        (56, 64), (64, 64), (65, 128),
                                        (80, 128), (128, 128)])
def test_pad_head_dim_gives_the_kernels_widths(kdim, width):
    t = torch.randn(2, 5, 3, kdim)
    padded = fa._pad_head_dim(t)
    assert padded.shape == (2, 5, 3, width)
    assert torch.equal(padded[..., :kdim], t)
    assert not padded[..., kdim:].any()


@pytest.mark.parametrize("layout,shape", [("bnhk", (2, 37, 3, 40)),
                                          ("bhnk", (1, 2, 70, 8))])
def test_padding_to_48_is_exact_through_the_plain_versions(layout, shape):
    """Zero columns up to 48 change nothing: the plain forward, its lse
    and its backward on padded tensors, sliced back, give the unpadded
    call's values (fp32; the same products plus exact zeros)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(shape, seed=10))
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(
        shape).astype(np.float32))
    padded = [fa._pad_head_dim(t) for t in (q, k, v, g)]
    assert padded[0].shape[-1] == 48
    kdim = shape[-1]
    np.testing.assert_allclose(
        fa.reference_attention(*padded[:3], layout)[..., :kdim].numpy(),
        fa.reference_attention(q, k, v, layout).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        fa.reference_attention_lse(padded[0], padded[1], layout).numpy(),
        fa.reference_attention_lse(q, k, layout).numpy(), atol=1e-6, rtol=0)
    for mine, ref in zip(
            fa.reference_attention_backward(*padded, layout),
            fa.reference_attention_backward(q, k, v, g, layout)):
        np.testing.assert_allclose(mine[..., :kdim].numpy(), ref.numpy(),
                                   atol=1e-6, rtol=0)
        assert not mine[..., kdim:].any()


def _model_attention_operands(monkeypatch, **overrides):
    """The (q, k, v) the model hands the flash wrapper in one forward of a
    small model on the CPU, with their layout."""
    from vision_transformer_detector_tpu_torch import DetectorConfig
    from vision_transformer_detector_tpu_torch.models import vit_detector

    seen = []

    def capture(q, k, v, layout="bnhk", **kwargs):
        seen.append((layout, q, k, v))
        return fa.flash_attention(q, k, v, layout=layout, **kwargs)

    monkeypatch.setattr(vit_detector, "flash_attention", capture)
    config = DetectorConfig(**{
        "image_size": (64, 64), "patch_size": 16, "embedding_dim": 32,
        "num_heads": 2, "key_dim": 8, "encoder_blocks": 1,
        "encoder_mlp_layers": 2, "head_last_units": 16, "head_layers": 2,
        "use_flash_attention": True, **overrides})
    params = vit_detector.init_params(config, torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        vit_detector.forward(params, images, config)
    assert seen
    return seen


@pytest.mark.parametrize("overrides", [
    {"key_dim": 40},                                      # tokens-major, F.pad
    {"key_dim": 64},                                      # heads-major view
    {"key_dim": 64, "attention_window": 2},               # heads-major fold
    {"key_dim": 8, "attention_window": 2, "compute_dtype": "bfloat16"},
    {"key_dim": 64, "compute_dtype": "bfloat16"},
], ids=["tokens_major_k40", "heads_major_k64", "window_fold_k64",
        "window_tokens_major_k8_bf16", "heads_major_k64_bf16"])
def test_alignment_check_accepts_the_models_views(monkeypatch, overrides):
    """Every q/k/v view the model hands the wrapper (tokens-major
    projections, heads-major views and window folds, F.pad copies) passes
    the kernels' 16-byte row check once padded, as the launch pads it."""
    for layout, q, k, v in _model_attention_operands(monkeypatch,
                                                     **overrides):
        padded = fa._kernel_operands(layout, q=q, k=k, v=v)
        assert all(t.shape[-1] in (48, 64) for t in padded)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_check_rejects_a_view_offset_by_one_element(dtype):
    """A K = 64 view that starts one element into its storage cannot be
    copied 16 bytes at a time: the wrapper raises, it does not copy."""
    base = torch.zeros(2, 10, 3, 72, dtype=dtype)
    good = base[..., :64]
    fa._kernel_operands("bnhk", q=good, k=good, v=good)
    shifted = base[..., 1:65]
    with pytest.raises(ValueError, match=r"k starts \d+ bytes past a "
                       r"16-byte boundary; the flash kernels read"):
        fa._kernel_operands("bnhk", q=good, k=shifted, v=good)


def test_alignment_check_rejects_an_unaligned_token_stride():
    """fp32 rows 66 elements (264 bytes) apart leave every other row off
    a 16-byte boundary and are refused; 68 elements (272 bytes) apart
    they are accepted."""
    storage = torch.zeros(10 * 68)
    ok = storage.as_strided((1, 10, 1, 64), (680, 68, 64, 1))
    fa._kernel_operands("bnhk", q=ok)
    bad = storage.as_strided((1, 10, 1, 64), (660, 66, 64, 1))
    with pytest.raises(ValueError, match="strides .* not multiples of 16"):
        fa._kernel_operands("bnhk", q=bad)


@pytest.mark.parametrize("dtype, route, want", [
    (torch.float32, None, "partials"),
    (torch.float32, "split", "split"),
    (torch.float32, "partials", "partials"),
    (torch.bfloat16, None, "split"),
    (torch.bfloat16, "split", "split"),
])
def test_dq_route_by_dtype_and_by_request(dtype, route, want):
    """The backward's dq route: fp32 stores per-key-tile partials, bf16
    runs the dq kernel; a request names either where it is built."""
    workspace = fa.partials_bytes(8, 8, 1296, 48)    # reference_608 b8
    assert workspace == 21 * 8 * 8 * 1296 * 48 * 4
    assert fa.dq_route(dtype, fa.DQ_ROUTES[route], workspace) == want


def test_dq_route_caps_the_partials_workspace():
    """fp32 past PARTIALS_MAX_BYTES of workspace takes the split route
    unless the partials route is asked for."""
    big = fa.partials_bytes(8, 16, 4096, 64)
    assert big > fa.PARTIALS_MAX_BYTES
    assert fa.dq_route(torch.float32, 0, big) == "split"
    assert fa.dq_route(torch.float32, fa.DQ_ROUTES["partials"],
                       big) == "partials"


@pytest.mark.parametrize("dtype, code", [(torch.bfloat16, 2),
                                         (torch.float32, 7)])
def test_dq_route_refuses_what_is_not_built(dtype, code):
    with pytest.raises(ValueError, match="dq route"):
        fa.dq_route(dtype, code)
