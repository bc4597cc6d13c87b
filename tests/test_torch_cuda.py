"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
a GPU). Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host
need not have; nothing here imports JAX.)
"""

import copy
import itertools
import os
import sys
import threading

import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu_torch import (
    DetectorConfig, LossConfig, synthetic_batches)
from vision_transformer_detector_tpu_torch.kernels import (
    dropout as dropout_kernel, flash_attention as fa, fused_ffn, fused_ln,
    quantization as qz)
from vision_transformer_detector_tpu_torch.metrics import (
    DeviceMeanAveragePrecision, MeanAveragePrecision)
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.ops.loss import detection_loss

pytestmark = pytest.mark.cuda

# Tolerances of the JAX package's kernel contract: bf16 ~1e-2 (p rounds
# to bf16 at other running maxima), fp32 summation order only.
TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, shape, dtype, scale):
    q, k, v = (torch.randn(shape, device="cuda", generator=gen)
               for _ in range(3))
    return q.mul(scale).to(dtype), k.to(dtype), v.to(dtype)


# The kernels' tile edges (64 queries or keys per tile) and head dims
# (padded to 48, 64 or 128; 80 is ViT-H/14's), each in both layouts:
# (layout, shape) pairs of one batch and two heads.
EDGE_N = (1, 17, 63, 64, 65, 127, 256, 577, 1296)
EDGE_K = (8, 40, 48, 64, 80, 128)
EDGES = [("bhnk", (1, 2, n, kk)) if (i + j) % 2 else ("bnhk", (1, n, 2, kk))
         for (i, n), (j, kk) in itertools.product(enumerate(EDGE_N),
                                                  enumerate(EDGE_K))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,shape", [
    ("bhnk", (2, 12, 576, 64)),      # ViT-B/16 384px
    ("bhnk", (1, 8, 1296, 40)),      # reference arch, K padded to 48
    ("bnhk", (2, 77, 3, 64)),        # tokens-major, ragged N
    ("bnhk", (1, 200, 2, 8)),
    *EDGES,
])
def test_kernel_matches_reference(gen, dtype, layout, shape):
    q, k, v = _qkv(gen, shape, dtype, shape[-1] ** -0.5)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, layout=layout)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = fa.reference_attention(q, k, v, layout=layout)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOLS[dtype]


def test_kernel_reads_transposed_views(gen):
    """A heads-major view of tokens-major memory (what the model passes)
    gives the same numbers as a contiguous copy."""
    q, k, v = _qkv(gen, (2, 100, 4, 64), torch.bfloat16, 0.125)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    copies = [t.contiguous() for t in views]
    torch.testing.assert_close(fa.flash_attention(*views, layout="bhnk"),
                               fa.flash_attention(*copies, layout="bhnk"),
                               atol=0, rtol=0)


def test_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, (1, 2, 64, 64), torch.float32, 0.125)
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="lse must be"):
        fa._launch_backward(q, k, v, q, lse[:, :1], lse, "bhnk")
    with pytest.raises(ValueError, match="delta must be"):
        fa._launch_backward(q, k, v, q, lse, lse.double(), "bhnk")
    with pytest.raises(ValueError, match="must be in"):
        fa.flash_attention(q, k, v, layout="bhnk", dropout_rate=1.0,
                           dropout_seed=1)
    with pytest.raises(ValueError, match="needs a dropout_seed"):
        fa.flash_attention(q, k, v, layout="bhnk", dropout_rate=0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), layout="bhnk")
    # The first head dim past the widest instance (128): refused, never
    # padded into another instance nor sent to the plain version.
    wide = torch.zeros(1, 2, 64, 129, device="cuda")
    with pytest.raises(NotImplementedError, match="head dim 129"):
        fa.flash_attention(wide, wide, wide, layout="bhnk")
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        fa.flash_attention(q, k.cpu(), v, layout="bhnk")
    # A view one element into its storage: refused, not launched or copied.
    shifted = torch.zeros(1, 2, 64, 72, device="cuda")[..., 1:65]
    launches = fa.flash_attention.launches
    with pytest.raises(ValueError, match="bytes past a 16-byte boundary"):
        fa.flash_attention(q, shifted, v, layout="bhnk")
    assert fa.flash_attention.launches == launches


def test_backward_copies_a_cotangent_it_cannot_read(gen):
    """The cotangent is whatever view autograd hands over: one the kernel
    cannot read (offset by an element) is copied, and gives the grads of
    its aligned copy, bit for bit (the backward sums dq over the key tiles
    in order)."""
    q, k, v = _qkv(gen, (1, 2, 100, 64), torch.bfloat16, 0.125)
    out, lse = fa.flash_attention(q, k, v, layout="bhnk", with_lse=True)
    wide = torch.randn(1, 2, 100, 72, device="cuda", generator=gen).to(
        torch.bfloat16)
    g = wide[..., 1:65]
    delta = (g.float() * out.float()).sum(-1)
    got = fa._launch_backward(q, k, v, g, lse, delta, "bhnk")
    want = fa._launch_backward(q, k, v, g.contiguous(), lse, delta, "bhnk")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_launch_count_survives_concurrent_callers(gen):
    """Serving calls the wrapper from many handler threads; the counter
    must not lose an increment."""
    q, k, v = _qkv(gen, (1, 2, 64, 64), torch.bfloat16, 0.125)
    before = fa.flash_attention.launches
    threads_n, calls = 16, 50
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            fa.flash_attention(q, k, v, layout="bhnk")
            for _ in range(calls)]) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + threads_n * calls


@pytest.mark.parametrize("layout, shape, dtype, rate, route", [
    ("bnhk", (8, 1296, 8, 40), torch.float32, 0.0, None),  # reference_608
    ("bnhk", (8, 1296, 8, 40), torch.float32, 0.0, "split"),
    ("bnhk", (8, 1296, 8, 40), torch.float32, 0.0, "partials"),
    ("bhnk", (8, 256, 256, 64), torch.bfloat16, 0.0, None),  # highres_1024
    ("bhnk", (8, 256, 256, 64), torch.bfloat16, 0.1, None),  # the replay
    # The 128-wide instance at ViT-H/14's K = 80 (batch 8, 16 heads).
    ("bnhk", (8, 256, 16, 80), torch.bfloat16, 0.0, None),
    ("bnhk", (8, 256, 16, 80), torch.bfloat16, 0.1, None),
    ("bnhk", (8, 256, 16, 80), torch.float32, 0.0, "split"),
    ("bnhk", (8, 256, 16, 80), torch.float32, 0.0, "partials"),
])
def test_backward_is_bit_reproducible(gen, layout, shape, dtype, rate,
                                      route):
    """Two launches of the backward kernels on the same inputs give
    bit-equal dq (fp32, as the kernels sum it over the key tiles in order),
    dk and dv, for each instance of the training paths and each dq route
    of fp32."""
    q, k, v = _qkv(gen, shape, dtype, shape[-1] ** -0.5)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    seed = fa.seed_tensor(7, "cuda") if rate else None
    kw = {"dropout_rate": rate, "dropout_seed": seed} if rate else {}
    out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True,
                                  **kw)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    padded = [fa._pad_head_dim(t) for t in (q, k, v, g)]
    first, second = (torch.ops.vtd_torch.flash_attention_bwd(
        *padded, lse, delta, layout, seed, rate, fa.DQ_ROUTES[route])
        for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    if route is not None:
        plain = fa.reference_attention_backward(q, k, v, g, layout)
        grads = fa._launch_backward(q, k, v, g, lse, delta, layout,
                                    route=route)
        assert max(_grad_rels(grads, plain)) <= GRAD_TOLS[dtype]


@pytest.mark.parametrize("flash,key_dim", [(True, 64), (True, 40),
                                           (False, 40), (True, 80),
                                           (True, 128)])
def test_model_on_card_matches_cpu(gen, flash, key_dim):
    config = DetectorConfig(
        image_size=(96, 96), patch_size=16, embedding_dim=64, num_heads=2,
        key_dim=key_dim, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=32, head_layers=2, use_flash_attention=flash)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 96, 96, 3)).astype(np.float32))
    before = fa.flash_attention.launches
    with torch.inference_mode():
        cpu = model.forward(params, images, config)
        gpu = model.forward(copy.deepcopy(params).to("cuda"),
                            images.to("cuda"), config).cpu()
    launched = config.encoder_blocks if flash else 0
    assert fa.flash_attention.launches == before + launched
    torch.testing.assert_close(gpu, cpu, atol=1e-4, rtol=0)


# Backward: grads relative to the largest; fp32 summation order, bf16
# rounding of p and ds.
GRAD_TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _rel(got, ref, fallback=1.0):
    """Max error relative to the reference's largest value; against
    ``fallback`` where the reference is all zeros (N = 1: dq and dk are
    zero in exact arithmetic; an output whose one key was dropped)."""
    ref = ref.float()
    scale = ref.abs().max().item() or fallback
    return (got.float() - ref).abs().max().item() / scale


def _grad_rels(grads, refs):
    """_rel of each gradient, an all-zero one against the largest."""
    top = max(r.float().abs().max().item() for r in refs)
    return [_rel(a, r, top) for a, r in zip(grads, refs)]


@pytest.mark.parametrize("layout,shape,dtype", [
    ("bnhk", (8, 1296, 8, 40), torch.float32),   # reference_608, batch 8
    ("bhnk", (1, 12, 576, 64), torch.bfloat16),
    ("bhnk", (1, 12, 576, 64), torch.float32),
    ("bnhk", (3, 77, 4, 40), torch.bfloat16),    # ragged N
    ("bnhk", (2, 200, 2, 8), torch.float32),
    *((layout, shape, dtype) for layout, shape in EDGES
      for dtype in (torch.bfloat16, torch.float32)),
])
def test_backward_kernel_matches_plain_and_autograd(gen, layout, shape,
                                                    dtype):
    q, k, v = _qkv(gen, shape, dtype, shape[-1] ** -0.5)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True)
    torch.testing.assert_close(lse, fa.reference_attention_lse(q, k, layout),
                               atol=1e-4, rtol=0)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    before = fa.flash_attention.backward_launches
    grads = fa._launch_backward(q, k, v, g, lse, delta, layout)
    torch.cuda.synchronize()
    assert fa.flash_attention.backward_launches == before + 1
    plain = fa.reference_attention_backward(q, k, v, g, layout)
    for got, ref in zip(grads, plain):
        assert got.shape == ref.shape and got.dtype == ref.dtype
    assert max(_grad_rels(grads, plain)) <= GRAD_TOLS[dtype]

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fn = torch.autograd.grad(fa.flash_attention(*leaves, layout=layout),
                             leaves, g)
    auto = torch.autograd.grad(fa.reference_attention(*leaves, layout=layout),
                               leaves, g)
    assert max(_grad_rels(fn, auto)) <= GRAD_TOLS[dtype]


def test_requires_grad_inputs_get_a_grad_fn_on_the_card(gen):
    """The kernel route is differentiable: forward with lse and the
    backward kernel launch once each; without grad, the lse-free forward
    runs alone."""
    q, k, v = (t.requires_grad_() for t in _qkv(gen, (2, 50, 3, 40),
                                                torch.float32, 40 ** -0.5))
    counts = (fa.flash_attention.launches, fa.flash_attention.lse_launches,
              fa.flash_attention.backward_launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0
               for t in (q, k, v))
    with torch.inference_mode():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert (fa.flash_attention.launches, fa.flash_attention.lse_launches,
            fa.flash_attention.backward_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)


def test_train_grads_on_card_match_cpu(gen):
    """Loss and every parameter's gradient of a small flash-route model,
    the card (kernels) against the CPU (plain versions)."""
    config = DetectorConfig(
        image_size=(96, 96), patch_size=16, embedding_dim=32, num_heads=2,
        key_dim=40, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=32, head_layers=2, use_flash_attention=True)
    params = model.init_params(config, torch.Generator().manual_seed(0))
    images, labels = next(synthetic_batches(config, 2, 1, seed=0))

    def loss_and_grads(m, device):
        named = dict(m.named_parameters())
        logits = model.forward(m, torch.from_numpy(images).to(device),
                               config, train=True)
        loss = detection_loss(torch.from_numpy(labels).to(device), logits,
                              config, LossConfig())
        return loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, list(named.values()))], list(named)

    cpu_loss, cpu_grads, names = loss_and_grads(params, "cpu")
    gpu_loss, gpu_grads, _ = loss_and_grads(copy.deepcopy(params).to("cuda"),
                                            "cuda")
    assert gpu_loss == pytest.approx(cpu_loss, rel=1e-5)
    top = max(g.abs().max().item() for g in cpu_grads)
    for name, got, ref in zip(names, gpu_grads, cpu_grads):
        # The key bias's gradient is zero in exact arithmetic: noise on
        # both sides, held to the largest gradient.
        scale = top if name.endswith("mha.key.bias") else ref.abs().max()
        assert (got - ref).abs().max().item() <= 1e-3 * float(scale), name


# ---------------------------------------------------------------------------
# Attention dropout: B1-drop and the B2 replay
# ---------------------------------------------------------------------------

DROP = (2 ** 32 - 5, 0.1)   # (seed near 2^32, rate)


def _kernel_drop():
    """DROP in the kernels' form: the seed as a one-element uint32 tensor
    on the card."""
    return fa.seed_tensor(DROP[0], "cuda"), DROP[1]


# The tile edges with dropout, except N = 1 in bf16: there dq and dk are
# zero in exact arithmetic, but delta = rowsum(g * out) is taken from the
# bf16-rounded output (as the JAX package's kernel takes it), whose
# rounding of keep / (1 - rate) * v leaves ds at about 2^-9 of g.v, which
# can exceed 2e-2 of the largest gradient. That case is held to the plain
# backward fed the same delta (the next test); fp32 covers N = 1 here.
@pytest.mark.parametrize("layout,shape,dtype", [
    *((layout, shape, dtype)
      for layout, shape in (("bhnk", (2, 64, 256, 64)),   # highres_1024 fold
                            ("bnhk", (2, 1296, 4, 40)),   # K padded to 48
                            ("bnhk", (3, 77, 4, 40)))     # ragged N
      for dtype in (torch.bfloat16, torch.float32)),
    *((layout, shape, dtype) for layout, shape in EDGES
      for dtype in (torch.bfloat16, torch.float32)
      if dtype == torch.float32
      or (shape[2] if layout == "bhnk" else shape[1]) > 1),
])
def test_dropout_kernels_match_plain(gen, layout, shape, dtype):
    """The forward with dropout and lse, and the backward with the mask
    replayed, against the plain versions with the same mask; the
    Function's grads against autograd through the plain version."""
    q, k, v = _qkv(gen, shape, dtype, shape[-1] ** -0.5)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    seed, rate = DROP
    before = (fa.flash_attention.drop_launches,
              fa.flash_attention.backward_drop_launches)
    out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True,
                                  dropout_rate=rate, dropout_seed=seed)
    assert _rel(out, fa.reference_attention(q, k, v, layout, DROP)) <= \
        GRAD_TOLS[dtype]
    torch.testing.assert_close(lse, fa.reference_attention_lse(q, k, layout),
                               atol=1e-4, rtol=0)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    grads = fa._launch_backward(q, k, v, g, lse, delta, layout,
                                _kernel_drop())
    torch.cuda.synchronize()
    assert (fa.flash_attention.drop_launches,
            fa.flash_attention.backward_drop_launches) == (
        before[0] + 1, before[1] + 1)
    plain = fa.reference_attention_backward(q, k, v, g, layout, DROP)
    for got, ref in zip(grads, plain):
        assert got.shape == ref.shape and got.dtype == ref.dtype
    assert max(_grad_rels(grads, plain)) <= GRAD_TOLS[dtype]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fn = torch.autograd.grad(fa.flash_attention(
        *leaves, layout=layout, dropout_rate=rate, dropout_seed=seed),
        leaves, g)
    auto = torch.autograd.grad(
        fa.reference_attention(*leaves, layout=layout, dropout=DROP),
        leaves, g)
    assert max(_grad_rels(fn, auto)) <= GRAD_TOLS[dtype]


def _plain_backward_given_delta(q, k, v, g, delta, layout, dropout):
    """reference_attention_backward with ds = p * (scale * g v^T - delta)
    for a given (B, H, N) fp32 delta, as the backward kernel forms it."""
    qh, kh, vh, gh = (fa._heads_major(t, layout) for t in (q, k, v, g))
    dtype = q.dtype
    p = torch.softmax(torch.einsum("bhnk,bhmk->bhnm", qh.float(),
                                   kh.float()), dim=-1)
    b, h, n, _ = p.shape
    scale = fa._dropout_scale(dropout, b, h, n, p.device)
    dp = torch.einsum("bhnk,bhmk->bhnm", gh.float(), vh.float()) * scale
    dv = torch.einsum("bhnm,bhnk->bhmk", (p * scale).to(dtype).float(),
                      gh.float())
    ds = (p * (dp - delta[..., None])).to(dtype).float()
    dq = torch.einsum("bhnm,bhmk->bhnk", ds, kh.float())
    dk = torch.einsum("bhnm,bhnk->bhmk", ds, qh.float())
    return tuple(fa._heads_major(t.to(dtype), layout) for t in (dq, dk, dv))


@pytest.mark.parametrize("layout,shape", [
    (layout, shape) for layout, shape in EDGES
    if (shape[2] if layout == "bhnk" else shape[1]) == 1])
def test_dropout_backward_at_one_key_matches_plain_given_delta(gen, layout,
                                                               shape):
    """N = 1 in bf16 with dropout: the forward against the plain version,
    and the replayed backward against the plain backward fed the same
    delta, rowsum(g * out) of the kernel's bf16 output."""
    dtype = torch.bfloat16
    q, k, v = _qkv(gen, shape, dtype, shape[-1] ** -0.5)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True,
                                  dropout_rate=DROP[1], dropout_seed=DROP[0])
    assert _rel(out, fa.reference_attention(q, k, v, layout, DROP)) <= \
        GRAD_TOLS[dtype]
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    grads = fa._launch_backward(q, k, v, g, lse, delta, layout,
                                _kernel_drop())
    plain = _plain_backward_given_delta(q, k, v, g, delta, layout, DROP)
    for got, ref in zip(grads, plain):
        assert got.shape == ref.shape and got.dtype == ref.dtype
    assert max(_grad_rels(grads, plain)) <= GRAD_TOLS[dtype]


def test_dropout_kernel_mask_reads_back_exactly(gen):
    """q = k = 0 makes every probability 1/N: with v one-hot on a 64-key
    slice, out * N / inv_keep is the kernel's mask of those keys, bit-equal
    to dropout_keep_mask (batch*heads up to 2,047, a seed near 2^32)."""
    seed, rate = DROP
    bh, n = 2048, 128
    zeros = torch.zeros(1, bh, n, 64, device="cuda")
    pos = torch.arange(n, device="cuda")
    want = fa.dropout_keep_mask(seed, torch.arange(bh, device="cuda")[
        :, None, None], pos[:, None], pos[None, :], fa._keep_threshold(rate))
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    for slice0 in range(0, n, 64):
        v = torch.zeros(1, bh, n, 64, device="cuda")
        v[0, :, slice0:slice0 + 64, :] = torch.eye(64, device="cuda")
        out = fa.flash_attention(zeros, zeros, v, layout="bhnk",
                                 dropout_rate=rate, dropout_seed=seed)
        # A CUDA division by a scalar may multiply by its reciprocal: the
        # read-back is 0 or 1 to an ulp, then exact once rounded.
        read = out[0] * n / inv_keep
        assert bool(((read - read.round()).abs() <= 1e-5).all())
        assert torch.equal(read.round().bool(),
                           want[:, :, slice0:slice0 + 64])


def _windowed_config(**overrides):
    """A small highres_1024-like model: windows (heads-major, K 64), the
    (1, 2, 4) multi-scale head, full remat, flash attention."""
    return DetectorConfig(
        image_size=(128, 128), patch_size=16, embedding_dim=64, num_heads=2,
        key_dim=64, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=32, head_layers=2, use_flash_attention=True,
        attention_window=4, head_scales=(1, 2, 4), remat_encoder=True,
        **overrides)


def _loss_and_grads(m, config, device, seed=None):
    images, labels = next(synthetic_batches(config, 2, 1, seed=0))
    named = dict(m.named_parameters())
    logits = model.forward(m, torch.from_numpy(images).to(device), config,
                           train=True, dropout_seed=seed)
    loss = detection_loss(torch.from_numpy(labels).to(device), logits,
                          config, LossConfig())
    return loss.item(), {n: g.cpu() for n, g in zip(
        named, torch.autograd.grad(loss, list(named.values())))}


def _assert_grads_within(got, ref, tol):
    top = max(g.abs().max().item() for g in ref.values())
    for name, want in ref.items():
        # The key bias's gradient is zero in exact arithmetic: noise on
        # both sides, held to the largest gradient.
        scale = top if name.endswith("mha.key.bias") else want.abs().max()
        assert (got[name] - want).abs().max().item() <= tol * float(scale), \
            name


def test_windowed_multi_scale_remat_model_on_card_matches_cpu(gen):
    """Loss and gradients of the windowed multi-scale model with remat,
    dropout off: the card's kernels against the CPU's plain versions
    (fp32; summation order)."""
    config = _windowed_config()
    params = model.init_params(config, torch.Generator().manual_seed(0))
    cpu_loss, cpu_grads = _loss_and_grads(params, config, "cpu")
    counts = (fa.flash_attention.lse_launches,
              fa.flash_attention.backward_launches)
    gpu_loss, gpu_grads = _loss_and_grads(copy.deepcopy(params).to("cuda"),
                                          config, "cuda")
    # Each block's forward, again in the recompute, and its backward.
    assert (fa.flash_attention.lse_launches - counts[0],
            fa.flash_attention.backward_launches - counts[1]) == (4, 2)
    assert gpu_loss == pytest.approx(cpu_loss, rel=1e-5)
    _assert_grads_within(gpu_grads, cpu_grads, 1e-3)


@pytest.mark.parametrize("policy", [None, "dots", "alternate"])
def test_remat_matches_no_remat_on_card_with_dropout(gen, policy):
    """With dropout on and one seed, each remat policy gives no remat's
    loss and gradients bit for bit: the recompute runs the same kernels on
    the same inputs, and each gives the same bits on every run."""
    config = _windowed_config(dropout=0.1, remat_policy=policy)
    params = model.init_params(config, torch.Generator().manual_seed(1))
    card = params.to("cuda")
    loss, grads = _loss_and_grads(card, config, "cuda", seed=123)
    ref_loss, ref_grads = _loss_and_grads(
        card, config.replace(remat_encoder=False), "cuda", seed=123)
    assert loss == ref_loss
    for name, want in ref_grads.items():
        assert torch.equal(grads[name], want), name
    other, _ = _loss_and_grads(card, config, "cuda", seed=124)
    assert other != loss


def test_device_metric_on_card_matches_numpy_oracle(gen):
    """The device mAP metric on CUDA against the NumPy oracle, on decoded
    predictions that score well above 0: seeded labels with random
    confidences, jittered boxes and some classes wrong. Tolerance 1e-5
    (fp32 on the card, float64 sums in parts of the oracle)."""
    config = DetectorConfig()
    rng = np.random.default_rng(0)
    metric = DeviceMeanAveragePrecision(config, "cuda")
    oracle = MeanAveragePrecision(config)
    for _, labels in synthetic_batches(config, 4, 3, seed=1):
        preds, real = labels.copy(), labels[..., 0] > 0
        preds[real, 0] = rng.uniform(0.3, 1.0, real.sum())
        preds[real, 2:4] += rng.uniform(-4, 4, (real.sum(), 2))
        preds[real, 4:] *= rng.uniform(0.85, 1.15, (real.sum(), 2))
        wrong = real & (rng.uniform(size=real.shape) < 0.3)
        preds[wrong, 1] = (preds[wrong, 1] + 1) % config.num_classes
        for m in (metric, oracle):
            m.update_state(labels, preds, use_transform_predictions=False)
    assert metric.state.latest_positive_bboxes.is_cuda
    expected = float(oracle.result())
    assert expected > 0.1
    assert metric.result() == pytest.approx(expected, abs=1e-5)


# ---------------------------------------------------------------------------
# Serving kernels: int8 dense (both routes), LayerNorm, dense + mish
# ---------------------------------------------------------------------------

def _quant_layer(gen, k, out_shape):
    n = int(np.prod(out_shape))
    layer = qz.QuantDense(k, out_shape, device="cuda")
    layer.kernel_q.copy_(torch.randint(-127, 128, (k, n), device="cuda",
                                       generator=gen).to(torch.int8))
    layer.scale.copy_(torch.rand(n, device="cuda", generator=gen) * 4e-4
                      + 1e-4)
    layer.bias.copy_(0.1 * torch.randn(out_shape, device="cuda",
                                       generator=gen))
    return layer


def _assert_within(got, ref, rel_tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel_tol * ref.float().abs().max().item()


# The dense kernels' tile edges: rows and columns around the 64- and
# 128-wide tiles, K on and off whole 16-byte rows (K = 28 and 40 take the
# guarded instances), as (rows, k, n).
DENSE_EDGES = ([(m, k, n) for m in (1, 65, 129) for n in (17, 64, 129)
                for k in (28, 40, 512, 576, 1536)]
               + [(m, 512, 64) for m in (1, 17, 63, 64, 65, 127, 129)]
               + [(64, 576, n) for n in (1, 17, 63, 64, 65, 127, 129)])


def _took_tensor_cores(fn, call):
    """call()'s result and whether its one launch took a tensor-core
    instance."""
    before = (fn.launches, fn.tensor_core_launches)
    got = call()
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    return got, fn.tensor_core_launches == before[1] + 1


@pytest.mark.parametrize("rows,k,n,mish", [
    (576, 768, 1536, True), (1152, 1536, 768, True), (17, 512, 6, False),
    (34, 576, 2048, True), (5, 200, 96, False),
    (34, 5376, 2048, True),          # highres_1024's head: codes streamed
    *[(m, k, n, (m + n) % 2 == 0) for m, k, n in DENSE_EDGES]])
def test_fused_int8_dense_kernel_matches_plain(gen, rows, k, n, mish):
    """Same codes, exact int32 sums, same fp32 rescale order: one bf16
    rounding (2^-7 of the largest value) at most. K in whole 16-byte rows
    takes a tensor-core instance, any other K the guarded one."""
    layer = _quant_layer(gen, k, (n,))
    x = torch.randn(rows, k, device="cuda", generator=gen)
    got, on_tc = _took_tensor_cores(
        qz.fused_int8_dense,
        lambda: qz.fused_int8_dense(x, layer, apply_mish=mish))
    assert on_tc == qz.tensor_core_shape(k) == (k % 16 == 0)
    ref = qz.int8_dense_reference(x.to(torch.bfloat16), layer.kernel_q,
                                  layer.scale, layer.bias, mish,
                                  torch.bfloat16)
    _assert_within(got, ref, 2 ** -7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lead,k,out_shape", [
    ((2, 77), 768, (12, 64)),
    *[((m,), k, (n,)) for m, k, n in DENSE_EDGES[::2]]])
def test_int8_dense_route_matches_plain(gen, dtype, lead, k, out_shape):
    """The fp32-out route of the q/k/v projections: (B, N, D) -> (B, N,
    H, K), equal to the plain version to fp32 rounding (1e-6)."""
    layer = _quant_layer(gen, k, out_shape)
    x = torch.randn(*lead, k, device="cuda", generator=gen).to(dtype)
    got, on_tc = _took_tensor_cores(qz.int8_dense,
                                    lambda: qz.int8_dense(x, layer))
    assert on_tc == qz.tensor_core_shape(k)
    ref = qz.int8_dense_reference(x.reshape(-1, k), layer.kernel_q,
                                  layer.scale, layer.bias.reshape(-1))
    _assert_within(got, ref.reshape(*lead, *out_shape), 1e-6)


@pytest.mark.parametrize("instance", ["guarded", "resident", "streamed"])
@pytest.mark.parametrize("rows,k,n", [(576, 768, 1536), (65, 576, 129),
                                      (129, 1536, 17), (64, 2048, 64)])
def test_int8_dense_instances_agree_bit_for_bit(gen, instance, rows, k, n):
    """Every instance forms the same codes and the same exact int32 sums
    and rescales in the same order: on the fp32-out route (no mish) each
    equals the guarded CUDA-core instance bit for bit."""
    layer = _quant_layer(gen, k, (n,))
    x = torch.randn(rows, k, device="cuda", generator=gen).to(torch.bfloat16)
    want = qz._launch(x, layer, False, torch.float32, qz.int8_dense,
                      "guarded")
    got, on_tc = _took_tensor_cores(
        qz.int8_dense, lambda: qz._launch(x, layer, False, torch.float32,
                                          qz.int8_dense, instance))
    assert on_tc == (instance != "guarded")
    assert torch.equal(got, want)


def test_int8_dense_unaligned_rows_take_the_guarded_instance(gen):
    """A view of x whose rows start off a 16-byte boundary (the wrapper
    makes it contiguous, which realigns it) and a K off 16 bytes: both
    match the plain version; a tensor-core instance asked for by name on a
    shape it cannot take raises."""
    layer = _quant_layer(gen, 40, (24,))
    x = torch.randn(9, 40, device="cuda", generator=gen).to(torch.bfloat16)
    got, on_tc = _took_tensor_cores(qz.int8_dense,
                                    lambda: qz.int8_dense(x, layer))
    assert not on_tc
    _assert_within(got, qz.int8_dense_reference(
        x, layer.kernel_q, layer.scale, layer.bias), 1e-6)
    with pytest.raises(RuntimeError, match="invalid"):
        qz._launch(x, layer, False, torch.float32, qz.int8_dense, "resident")
    wide = _quant_layer(gen, 64, (24,))
    flat = torch.randn(9 * 64 + 1, device="cuda",
                       generator=gen).to(torch.bfloat16)
    shifted = flat[1:].reshape(9, 64)                 # 2 bytes off
    assert shifted.data_ptr() % 16 != 0
    got, on_tc = _took_tensor_cores(qz.int8_dense,
                                    lambda: qz.int8_dense(shifted, wide))
    assert not on_tc
    _assert_within(got, qz.int8_dense_reference(
        shifted, wide.kernel_q, wide.scale, wide.bias), 1e-6)


def test_transposed_codes_follow_the_layer_onto_the_card(gen):
    """.to(device), copy_ and load_state_dict on the card: the kernel reads
    the (N, K) copy of the codes that are there now."""
    cpu_layer = qz.QuantDense(64, (32,))
    cpu_layer.kernel_q.copy_(torch.randint(-127, 128, (64, 32)).to(torch.int8))
    cpu_layer.scale.fill_(0.01)
    x = torch.randn(5, 64, device="cuda", generator=gen)
    layer = copy.deepcopy(cpu_layer).to("cuda")

    def check():
        got = qz.int8_dense(x, layer)
        torch.cuda.synchronize()
        _assert_within(got, qz.int8_dense_reference(
            x, layer.kernel_q, layer.scale, layer.bias), 1e-6)
        assert torch.equal(qz.transposed_codes(layer), layer.kernel_q.t())
        assert qz.transposed_codes(layer).device.type == "cuda"

    check()
    layer.kernel_q.copy_(torch.randint(-127, 128, (64, 32)).to(torch.int8))
    check()
    layer.load_state_dict(cpu_layer.state_dict())
    check()
    assert set(layer.state_dict()) == {"kernel_q", "scale", "bias"}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2 ** -7),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(2, 576, 768), (17, 768), (3, 5, 128),
                                   (9, 2048)])
def test_layer_norm_kernel_matches_plain(gen, dtype, tol, shape):
    """rsqrtf and the sums' order: 1e-5 of the largest value in fp32, one
    bf16 rounding in bf16."""
    x = (3 * torch.randn(shape, device="cuda", generator=gen) + 1).to(dtype)
    gamma = torch.randn(shape[-1], device="cuda", generator=gen)
    beta = torch.randn(shape[-1], device="cuda", generator=gen)
    before = fused_ln.fused_layer_norm.launches
    got = fused_ln.fused_layer_norm(x, gamma, beta)
    torch.cuda.synchronize()
    assert fused_ln.fused_layer_norm.launches == before + 1
    _assert_within(got, fused_ln.layer_norm_reference(x, gamma, beta), tol)
    # A strided view of the same values gives the same numbers.
    wide = torch.cat([x, x], dim=-1)[..., :shape[-1]]
    torch.testing.assert_close(fused_ln.fused_layer_norm(wide, gamma, beta),
                               got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2 ** -7),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("rows,k,n,mish", [
    (576, 768, 1536, True), (34, 576, 2048, True), (17, 512, 6, False),
    (7, 100, 33, True), (18432, 768, 1536, True),     # the wgmma instance
    *[(m, k, n, (m + n) % 2 == 0) for m, k, n in DENSE_EDGES]])
def test_dense_mish_kernel_matches_plain(gen, dtype, tol, rows, k, n, mish):
    x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(k, n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    got, on_tc = _took_tensor_cores(
        fused_ffn.fused_dense_mish,
        lambda: fused_ffn.fused_dense_mish(x, w, b, apply_mish=mish))
    per_chunk = 8 if dtype == torch.bfloat16 else 4
    assert on_tc == fused_ffn.tensor_core_shape(k, n, dtype) == (
        k % per_chunk == 0 and n % per_chunk == 0)
    _assert_within(got, fused_ffn.dense_mish_reference(x, w, b, mish), tol)


@pytest.mark.parametrize("dtype,instance,tol", [
    (torch.bfloat16, "guarded", 2 ** -7), (torch.bfloat16, "mma_sync", 2 ** -7),
    (torch.bfloat16, "wgmma", 2 ** -7), (torch.float32, "guarded", 1e-5),
    (torch.float32, "mma_sync", 1e-5)])
@pytest.mark.parametrize("rows,k,n", [(576, 768, 1536), (65, 576, 136),
                                      (129, 1536, 64), (1, 40, 8)])
def test_dense_mish_instances_match_plain(gen, dtype, instance, tol, rows, k,
                                          n):
    """Each instance by name, at shapes every instance takes (ragged M, a K
    tail, one row)."""
    x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(k, n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    got, on_tc = _took_tensor_cores(
        fused_ffn.fused_dense_mish,
        lambda: fused_ffn._launch(x, w, b, True, instance))
    assert on_tc == (instance != "guarded")
    _assert_within(got, fused_ffn.dense_mish_reference(x, w, b, True), tol)


def test_dense_mish_unaligned_rows_take_the_guarded_instance(gen):
    """Rows of w off a 16-byte boundary (N = 17) and a view of x that starts
    2 bytes off: the guarded instance, matching the plain version; a
    tensor-core instance asked for by name raises."""
    x = torch.randn(9, 64, device="cuda", generator=gen).to(torch.bfloat16)
    w = (0.1 * torch.randn(64, 17, device="cuda",
                           generator=gen)).to(torch.bfloat16)
    b = torch.zeros(17, device="cuda", dtype=torch.bfloat16)
    got, on_tc = _took_tensor_cores(
        fused_ffn.fused_dense_mish,
        lambda: fused_ffn.fused_dense_mish(x, w, b))
    assert not on_tc
    _assert_within(got, fused_ffn.dense_mish_reference(x, w, b), 2 ** -7)
    with pytest.raises(RuntimeError, match="invalid"):
        fused_ffn._launch(x, w, b, True, "wgmma")
    with pytest.raises(RuntimeError, match="invalid"):          # fp32 wgmma
        fused_ffn._launch(x.float(), w.float()[:, :16].contiguous(),
                          b.float()[:16].contiguous(), True, "wgmma")
    flat = torch.randn(9 * 64 + 1, device="cuda",
                       generator=gen).to(torch.bfloat16)
    shifted = flat[1:].reshape(9, 64)
    w16 = w[:, :16].contiguous()
    assert shifted.data_ptr() % 16 != 0
    got, on_tc = _took_tensor_cores(
        fused_ffn.fused_dense_mish,
        lambda: fused_ffn.fused_dense_mish(shifted, w16, b[:16].contiguous()))
    assert not on_tc
    _assert_within(got, fused_ffn.dense_mish_reference(
        shifted, w16, b[:16].contiguous()), 2 ** -7)


def test_dense_mish_kernel_is_differentiable(gen):
    """The kernel route carries a grad_fn, and its recompute backward on
    the card gives the CPU route's gradients."""
    x, w, b, g = (torch.randn(shape, device="cuda", generator=gen)
                  for shape in ((3, 40, 96), (96, 176), (176,),
                                (3, 40, 176)))
    w, b = 0.1 * w, 0.1 * b
    grads = []
    for device in ("cuda", "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in (x, w, b)]
        out = fused_ffn.fused_dense_mish(*leaves)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out, leaves, g.to(device)))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


def test_serving_kernels_refuse_what_they_do_not_take(gen):
    x = torch.randn(4, 256, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="D <= 4096"):
        fused_ln.fused_layer_norm(torch.zeros(2, 4224, device="cuda"),
                                  torch.ones(4224, device="cuda"),
                                  torch.zeros(4224, device="cuda"))
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        fused_ln.fused_layer_norm(x, torch.ones(256), torch.zeros(256))
    with pytest.raises(ValueError, match="one dtype"):
        fused_ffn.fused_dense_mish(x, torch.zeros(256, 8, device="cuda",
                                                  dtype=torch.bfloat16),
                                   torch.zeros(8, device="cuda"))
    layer = _quant_layer(gen, 256, (2, 4))
    with pytest.raises(ValueError, match="2-D weights"):
        qz.fused_int8_dense(x, layer)
    with pytest.raises(ValueError, match="one device"):
        qz.int8_dense(x.cpu(), layer)


@pytest.mark.parametrize("path", ["int8", "fused_ffn"])
def test_serving_models_on_card_match_cpu(gen, path):
    """A small D = 128 model in fp32 with the fused LayerNorm, int8 or
    with the fused dense+mish: every kernel launches once per layer, and
    the logits match the CPU plain path (fp32 summation order; for int8
    also an activation code flipped at a .5 boundary)."""
    config = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=128, num_heads=2,
        key_dim=64, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=32, head_layers=2, use_flash_attention=True,
        use_fused_layer_norm=True, use_fused_ffn=path == "fused_ffn")
    params = model.init_params(config, torch.Generator().manual_seed(0))
    if path == "int8":
        params = qz.quantize_params(params)
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    counts = (qz.fused_int8_dense.launches, qz.int8_dense.launches,
              fused_ln.fused_layer_norm.launches,
              fused_ffn.fused_dense_mish.launches)
    with torch.inference_mode():
        cpu = model.forward(params, images, config)
        gpu = model.forward(copy.deepcopy(params).to("cuda"),
                            images.to("cuda"), config).cpu()
    launched = tuple(after - before for after, before in zip(
        (qz.fused_int8_dense.launches, qz.int8_dense.launches,
         fused_ln.fused_layer_norm.launches,
         fused_ffn.fused_dense_mish.launches), counts))
    # int8: projection + 4 MLP + token dense + 2 head MLP + output; 8
    # q/k/v/out; 4 LayerNorms. dense+mish: 4 MLP + 2 head MLP.
    assert launched == ((9, 8, 4, 0) if path == "int8" else (0, 0, 4, 6))
    tol = 2e-2 if path == "int8" else 1e-4
    assert (gpu - cpu).abs().max().item() <= tol * cpu.abs().max().item()


# ---------------------------------------------------------------------------
# The custom operators (kernels/ops.py) and torch.export on the card

def _op_samples(gen):
    """(operator, args, test_utils) at small shapes, each dtype."""
    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    every = ("test_schema", "test_autograd_registration", "test_faketensor",
             "test_aot_dispatch_dynamic")
    ops = torch.ops.vtd_torch
    samples = []
    # The dropout seed is a one-element uint32 tensor on the card, which
    # the kernels read.
    seed = fa.seed_tensor(12345, "cuda")
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = (rnd(1, 2, 65, 64, dtype=dtype) for _ in range(4))
        samples += [
            (ops.flash_attention_fwd, (q, k, v, "bhnk", False, None, 0.0),
             every),
            (ops.flash_attention_fwd, (q, k, v, "bhnk", True, None, 0.0),
             every),
            (ops.flash_attention_fwd, (q, k, v, "bhnk", True, seed, 0.1),
             every)]
        out, lse = fa._launch_forward(q, k, v, "bhnk", with_lse=True)
        delta = (g.float() * out.float()).sum(-1).contiguous()
        # A ring attention block: fp32 output, the online softmax's state
        # resumed and suspended, the batch*head map; fp32 dk and dv.
        acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        l_part = torch.ones((*lse.shape, 4), device="cuda")
        samples += [
            (ops.flash_attention_fwd, (q, k, v, "bhnk", True, seed, 0.1, 0,
                                       0, 0, 1, 2, 1, True, acc, lse, l_part,
                                       True), every),
            (ops.flash_attention_fwd, (q, k, v, "bhnk", True, None, 0.0, 0,
                                       0, 0, 1, 1, 0, True, acc, lse, l_part,
                                       False), every),
            (ops.flash_attention_bwd, (q, k, v, g, lse, delta, "bhnk", seed,
                                       0.1, 0, 0, 0, 0, 1, 2, 1,
                                       dtype == torch.bfloat16), every)]
        samples += [
            (ops.flash_attention_bwd, (q, k, v, g, lse, delta, "bhnk", None,
                                       0.0), every),
            (ops.flash_attention_bwd, (q, k, v, g, lse, delta, "bhnk", seed,
                                       0.1), every),
            (ops.layer_norm, (rnd(40, 256, dtype=dtype), rnd(256),
                              rnd(256), 1e-3), every),
            (ops.dense_mish, (rnd(70, 64, dtype=dtype),
                              rnd(64, 72, dtype=dtype), rnd(72, dtype=dtype),
                              True, 0), every),
            (ops.dropout, (rnd(70, 72, dtype=dtype), seed, 0.1), every)]
    layer = _quant_test_layer(gen)
    x = rnd(70, 64, dtype=torch.bfloat16)
    for op in (ops.fused_int8_dense, ops.int8_dense):
        samples.append((op, (x, layer.kernel_q, qz.transposed_codes(layer),
                             layer.scale, layer.bias, False, 0), every))
    return samples


def _quant_test_layer(gen):
    kernel = torch.randn(64, 48, device="cuda", generator=gen)
    dense = model.Dense(64, 48).to("cuda")
    with torch.no_grad():
        dense.kernel.copy_(kernel)
    return qz._quantize_dense(dense)


def test_custom_operators_pass_opcheck(gen):
    """torch.library.opcheck: each operator's schema (no mutation, no
    aliasing), its fake implementation against the kernel's outputs
    (shapes, dtypes, strides) and its trace under AOT dispatch."""
    samples = _op_samples(gen)
    assert {op._qualified_op_name for op, _, _ in samples} == {
        "vtd_torch::flash_attention_fwd", "vtd_torch::flash_attention_bwd",
        "vtd_torch::layer_norm", "vtd_torch::dense_mish",
        "vtd_torch::fused_int8_dense", "vtd_torch::int8_dense",
        "vtd_torch::dropout"}
    for op, args, utils in samples:
        torch.library.opcheck(op, args, test_utils=utils)


def test_cuda_export_calls_the_kernels_as_custom_operators(gen, tmp_path):
    """A program traced on the card holds one flash-forward node per block
    and a dense+mish / LayerNorm node per fused layer, none of the plain
    versions, launches them per call, and gives the live model's
    detections."""
    import collections

    from vision_transformer_detector_tpu_torch import export
    from vision_transformer_detector_tpu_torch.ops.decode import (
        transform_predictions)

    config = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=128, num_heads=2,
        key_dim=64, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=32, head_layers=2, use_flash_attention=True,
        use_fused_layer_norm=True, use_fused_ffn=True,
        compute_dtype="bfloat16")
    params = model.init_params(config, torch.Generator().manual_seed(0),
                               "cuda")
    path = str(tmp_path / "artifact")
    export.save_exported(path, params, config, batch_size=2, device="cuda")
    program = torch.export.load(os.path.join(path, "model.pt2"))
    ops = collections.Counter(
        node.target.name().split(".")[0] for node in program.graph.nodes
        if node.op == "call_function" and hasattr(node.target, "name"))
    assert {op: n for op, n in ops.items() if op.startswith("vtd_torch")} \
        == {"vtd_torch::flash_attention_fwd": 2,
            "vtd_torch::dense_mish": 6, "vtd_torch::layer_norm": 4}
    assert not {op for op in ops
                if op.split("::")[-1] in ("softmax", "log1p", "tanh",
                                          "rsqrt")}
    detector = export.load_exported(path)
    images = torch.rand(2, 64, 64, 3, device="cuda", generator=gen) * 2 - 1
    before = (fa.flash_attention.launches,
              fused_ffn.fused_dense_mish.launches,
              fused_ln.fused_layer_norm.launches)
    got = detector(images)
    assert (fa.flash_attention.launches - before[0],
            fused_ffn.fused_dense_mish.launches - before[1],
            fused_ln.fused_layer_norm.launches - before[2]) == (2, 6, 4)
    with torch.inference_mode():
        want = transform_predictions(model.forward(params, images, config),
                                     config)
    # The same kernels in the same order: equal up to one bf16 rounding.
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=2 ** -7)
    with pytest.raises(ValueError, match="exported on cuda"):
        export.load_exported(path, device="cpu")


# ---------------------------------------------------------------------------
# The train step as a CUDA graph (train/trainer.py:make_multi_step)

def _graph_pair(config, train_config, steps, data_seed=0):
    """Per-step losses and final states of the eager loop and the graph
    loop from one seed, on the card."""
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    data = list(synthetic_batches(config, 2, 1, seed=data_seed))
    out = {}
    for name, per_call in (("loop", 1), ("graph", steps)):
        trainer = Trainer(config, LossConfig(), train_config, device="cuda")
        state = trainer.fit(trainer.init_state(), data, epochs=steps,
                            epochs_per_call=per_call)
        out[name] = (trainer, state)
    return out


@pytest.mark.parametrize("policy", [None, "dots", "alternate"])
def test_graph_loop_matches_the_loop_with_dropout(gen, policy):
    """The captured step replays each step with that step's seed row (the
    kernels read it from device memory, the MLP masks hash it): losses and
    parameters bit-equal to the loop's under every remat policy, since
    every kernel of the step gives the same bits on every run."""
    from vision_transformer_detector_tpu_torch import TrainConfig

    config = _windowed_config(dropout=0.1, remat_policy=policy)
    runs = _graph_pair(config, TrainConfig(learning_rate=1e-4,
                                           skip_epochs=0), 4)
    loop, graph = runs["loop"][0], runs["graph"][0]
    assert graph.loss_record == loop.loss_record
    assert len(set(loop.loss_record)) == 4     # the masks change per step
    assert len(graph.multi_step.graphs) == 1
    for name, value in runs["loop"][1]["params"].state_dict().items():
        assert torch.equal(runs["graph"][1]["params"].state_dict()[name],
                           value), name


def test_graph_loop_with_accumulation_and_bf16_moments(gen):
    """accumulate_steps=2 replays a micro-step and an update-step graph;
    bf16 moments (stochastic nu rounding keyed on the device count)."""
    from vision_transformer_detector_tpu_torch import TrainConfig

    config = _windowed_config()
    train_config = TrainConfig(learning_rate=1e-4, skip_epochs=0,
                               accumulate_steps=2, adam_mu_dtype="bfloat16",
                               adam_nu_dtype="bfloat16")
    runs = _graph_pair(config, train_config, 4)
    loop, graph = runs["loop"][0], runs["graph"][0]
    np.testing.assert_allclose(graph.loss_record, loop.loss_record,
                               rtol=2e-5, atol=1e-6)
    assert sorted(key[-1] for key in graph.multi_step.graphs) == [False,
                                                                   True]
    assert int(runs["graph"][1]["opt_state"]["count"]) == 2


@pytest.mark.parametrize("shape, dtype, offset", [
    ((2, 96, 2048), torch.bfloat16, 0),   # 16-byte chunks
    ((2, 96, 1024), torch.float32, 0),
    ((3, 77, 517), torch.bfloat16, 0),    # ragged row: one at a time
    ((5, 130), torch.float32, 1),         # misaligned view: one at a time
    ((1, 1), torch.bfloat16, 0),
])
def test_dropout_kernel_matches_plain(gen, shape, dtype, offset):
    """csrc/dropout.cu against dropout_reference on the card, bit for bit,
    forward and backward (the same mask applied to the cotangent), one
    launch each, from a seed in device memory."""
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device="cuda", generator=gen).to(dtype)
    x = x[offset:].reshape(shape).requires_grad_()
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    seed = fa.seed_tensor(2 ** 32 - 9, "cuda")
    before = dropout_kernel.dropout.launches
    out = dropout_kernel.dropout(x, seed, 0.1)
    (grad,) = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert dropout_kernel.dropout.launches == before + 2
    want = dropout_kernel.dropout_reference(x, seed, 0.1)
    (want_grad,) = torch.autograd.grad(want, x, g)
    assert out.dtype == dtype and torch.equal(out, want)
    assert torch.equal(grad, want_grad)


def test_dropout_kernel_reads_its_seed_at_replay(gen):
    """Captured once in a CUDA graph, the kernel draws each replay's mask
    from the seed written into its buffer before the replay."""
    x = torch.randn(64, 256, device="cuda", generator=gen)
    seed = torch.zeros(1, dtype=torch.uint32, device="cuda")
    dropout_kernel.dropout(x, seed, 0.25)   # builds the library first
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dropout_kernel.dropout(x, seed, 0.25)
    for value in (7, 2 ** 32 - 1):
        seed.copy_(fa.seed_tensor(value, "cuda"))
        graph.replay()
        assert torch.equal(
            out, dropout_kernel.dropout_reference(x, value, 0.25))


def test_mlp_dropout_mask_on_card_equals_cpu(gen):
    """The MLP/head dropout mask is the same counter hash on both devices,
    bit for bit, from a seed in device memory."""
    shape = (3, 129, 517)
    seed = fa.seed_tensor(2 ** 32 - 7, "cuda")
    card = dropout_kernel.dropout_mask(seed, shape, 0.1, "cuda")
    cpu = dropout_kernel.dropout_mask(2 ** 32 - 7, shape, 0.1, "cpu")
    assert torch.equal(card.cpu(), cpu)
    assert abs(cpu.float().mean().item() - 0.9) < 0.005


def test_failed_capture_raises_and_does_not_fall_back(gen):
    """A step that reads a value back to the host cannot be captured: the
    trainer raises with the reason instead of running eagerly."""
    from vision_transformer_detector_tpu_torch.train import trainer as tr

    state = {"params": model.init_params(_windowed_config(),
                                         torch.Generator().manual_seed(0),
                                         "cuda"),
             "opt_state": {"order": [], "mu": {}, "nu": {},
                           "count": torch.zeros((), dtype=torch.int64,
                                                device="cuda")},
             "step": 0}

    def host_read(state, images, labels, seeds, update):
        return images.sum() * float(images.sum())

    images = torch.ones(2, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA graph failed"):
        tr._StepGraph(host_read, state, images, images, 0, True,
                      torch.cuda.graph_pool_handle())


# ---------------------------------------------------------------------------
# Global-coordinate offsets (data parallelism, ring attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_offsets_halves_equal_the_whole_batch(gen, dtype):
    """B1-drop with lse and B2-replay over a batch equal, bit for bit, two
    half batches launched with their batch*head offset; a half launched
    without it draws another mask."""
    q, k, v = _qkv(gen, (4, 3, 130, 64), dtype, 0.125)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    drop = (fa.seed_tensor(2 ** 32 - 7, "cuda"), 0.25)

    def run(rows, base):
        out, lse = fa._launch_forward(q[rows], k[rows], v[rows], "bhnk",
                                      with_lse=True, dropout=drop,
                                      offsets=(base, 0, 0))
        delta = (g[rows].float() * out.float()).sum(-1).contiguous()
        return (out, lse) + fa._launch_backward(
            q[rows], k[rows], v[rows], g[rows], lse, delta, "bhnk", drop,
            offsets=(base, 0, 0))

    whole = run(slice(0, 4), 0)
    halves = [run(slice(0, 2), 0), run(slice(2, 4), 2 * 3)]
    for i, tensor in enumerate(whole):
        assert torch.equal(tensor, torch.cat([h[i] for h in halves]))
    assert not torch.equal(run(slice(2, 4), 0)[0], whole[0][2:])


def test_flash_query_key_offsets_match_plain(gen):
    """A block of queries against a block of keys at their global offsets
    (a ring step) draws the mask of those coordinates: kernel against the
    plain version with the same offsets."""
    q, k, v = _qkv(gen, (2, 70, 2, 64), torch.float32, 0.125)
    drop = (fa.seed_tensor(123, "cuda"), 0.3)
    offsets = (4, 70, 140)
    got = fa._launch_forward(q, k, v, "bnhk", dropout=drop, offsets=offsets)
    want = fa.reference_attention(q, k, v, "bnhk", drop, offsets)
    assert (got - want).abs().max() <= TOLS[torch.float32]
    plain = fa.reference_attention(q, k, v, "bnhk", drop)
    assert (got - plain).abs().max() > 1e-3


def test_dropout_row_base_halves_equal_the_whole(gen):
    x = torch.randn(6, 33, 80, device="cuda", generator=gen).to(
        torch.bfloat16)
    seed = fa.seed_tensor(99, "cuda")
    whole = dropout_kernel._launch(x, seed, 0.1)
    halves = torch.cat([dropout_kernel._launch(x[:2], seed, 0.1),
                        dropout_kernel._launch(x[2:], seed, 0.1, 2 * 33)])
    assert torch.equal(whole, halves)
    assert torch.equal(dropout_kernel.dropout_reference(x[2:], seed, 0.1,
                                                        2 * 33), whole[2:])


# ---------------------------------------------------------------------------
# The fp32-output instance (ring blocks) and the sharded coordinate maps
# (tensor parallelism, sequence sharding)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd", [64, 80, 128])
@pytest.mark.parametrize("rate", [None, 0.1])
def test_flash_fp32_output_instance_matches_plain(gen, rate, kd):
    """B1-lse / B1-drop with bf16 inputs and an fp32 output (the 64- and
    128-wide instances): within the bf16 tolerance of the plain version's
    fp32 output, and rounded to bf16 bit-equal to the bf16 instance (both
    round the same O / l once)."""
    q, k, v = _qkv(gen, (2, 300, 4, kd), torch.bfloat16, kd ** -0.5)
    drop = None if rate is None else (fa.seed_tensor(77, "cuda"), rate)
    out, lse = fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                  dropout=drop, out_fp32=True)
    assert out.dtype == torch.float32
    want = fa.reference_attention(q, k, v, "bnhk", drop,
                                  out_dtype=torch.float32)
    assert _rel(out, want) <= TOLS[torch.bfloat16]
    rounded, lse16 = fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                        dropout=drop)
    assert torch.equal(out.to(torch.bfloat16), rounded)
    assert torch.equal(lse, lse16)


def _flash_all(q, k, v, g, layout, drop, offsets):
    out, lse = fa._launch_forward(q, k, v, layout, with_lse=True,
                                  dropout=drop, offsets=offsets)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    return (out, lse) + fa._launch_backward(q, k, v, g, lse, delta, layout,
                                            drop, offsets=offsets)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_head_and_window_maps_equal_the_whole(gen, dtype):
    """B1-drop (out, lse) and B2-replay (dq, dk, dv) over all heads equal,
    bit for bit, each half of the heads launched with the batch*head map
    (H_l, H, h0) (tensor parallelism); over all windows of a tokens-major
    fold, each half of the windows with (W_l H, W H, w0 H) (sequence
    sharding); a half without its map draws another mask, and the map
    matches the plain version."""
    b, w, t, h, kd = 2, 4, 64, 4, 64
    drop = (fa.seed_tensor(2 ** 32 - 3, "cuda"), 0.2)
    q, k, v = _qkv(gen, (b, h, w * t, kd), dtype, 0.125)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    whole = _flash_all(q, k, v, g, "bhnk", drop, (0, 0, 0))
    for h0 in (0, 2):
        part = [x[:, h0:h0 + 2] for x in (q, k, v, g)]
        got = _flash_all(*part, "bhnk", drop, (0, 0, 0, 2, h, h0))
        for a, want in zip(got, whole):
            assert torch.equal(a, want[:, h0:h0 + 2])
    plain = fa.reference_attention(q[:, 2:], k[:, 2:], v[:, 2:], "bhnk",
                                   drop, (0, 0, 0, 2, h, 2))
    assert _rel(got[0], plain) <= TOLS[dtype]
    unmapped = _flash_all(*[x[:, 2:] for x in (q, k, v, g)], "bhnk", drop,
                          (0, 0, 0))
    assert not torch.equal(unmapped[0], whole[0][:, 2:])

    # Windows fold into the batch axis: (B * W, T, H, K), rows
    # (b * W + w) * H + h.
    def windows(x, w0=0, count=w):
        return x.reshape(b, w, t, h, kd)[:, w0:w0 + count].reshape(
            b * count, t, h, kd)

    tq, tk, tv, tg = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    whole = _flash_all(*[windows(x) for x in (tq, tk, tv, tg)], "bnhk",
                       drop, (0, 0, 0))
    for w0 in (0, 2):
        got = _flash_all(*[windows(x, w0, 2) for x in (tq, tk, tv, tg)],
                         "bnhk", drop, (0, 0, 0, 2 * h, w * h, w0 * h))
        for a, want in zip(got, whole):
            want = want.reshape(b, w, *want.shape[1:])[:, w0:w0 + 2]
            assert torch.equal(a, want.reshape(a.shape))


def test_dropout_token_map_and_column_base_equal_the_whole(gen):
    """The MLP/head dropout kernel over a token shard of every image (row
    map (n_l, N, n0)) and over a column slice (``col_base``) equals the
    whole array's slices bit for bit, and the plain version with the same
    coordinates."""
    x = torch.randn(4, 96, 80, device="cuda", generator=gen).to(
        torch.bfloat16)
    seed = fa.seed_tensor(2 ** 32 - 11, "cuda")
    whole = dropout_kernel._launch(x, seed, 0.1)
    for n0 in (0, 48):
        part = x[:, n0:n0 + 48]
        got = dropout_kernel._launch(part, seed, 0.1, 0, 48, 96, n0)
        assert torch.equal(got, whole[:, n0:n0 + 48])
        assert torch.equal(got, dropout_kernel.dropout_reference(
            part, seed, 0.1, 0, (48, 96, n0)))
    for c0 in (0, 40):
        part = x[..., c0:c0 + 40]
        got = dropout_kernel._launch(part, seed, 0.1, col_base=c0)
        assert torch.equal(got, whole[..., c0:c0 + 40])
        assert torch.equal(got, dropout_kernel.dropout_reference(
            part, seed, 0.1, col_base=c0))
    assert not torch.equal(dropout_kernel._launch(x[:, 48:], seed, 0.1),
                           whole[:, 48:])


@pytest.mark.parametrize("kd", [64, 80])
@pytest.mark.parametrize("rate", [None, 0.1])
def test_ring_blocks_in_key_order_round_as_the_whole_sequence(gen, rate, kd):
    """Ring attention's blocks taken in key order, each launch resuming
    the online softmax's state where the one before suspended it (B1's
    state in and out, fp32 output): out and lse bit-equal to one launch
    over the whole sequence. The backward's blocks with fp32 dq, dk and
    dv, summed and rounded once, differ from the whole sequence's only by
    fp32 summation order (under 1 % of dq's elements)."""
    from vision_transformer_detector_tpu_torch.kernels import (
        ring_attention as ra)

    b, n, h, parts = 2, 1024, 4, 4
    q, k, v = _qkv(gen, (b, n, h, kd), torch.bfloat16, kd ** -0.5)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    drop = None if rate is None else (fa.seed_tensor(2 ** 32 - 9, "cuda"),
                                      rate)
    whole, lse = fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                    dropout=drop)
    delta = fa._heads_major((g.float() * whole.float()).sum(-1),
                            "bnhk").contiguous()
    grads = fa._launch_backward(q, k, v, g, lse, delta, "bnhk", drop)
    m = n // parts
    blocks = [(k[:, i * m:(i + 1) * m], v[:, i * m:(i + 1) * m], i)
              for i in range(parts)]
    for first in range(0, n, m):
        rows = slice(first, first + m)
        out, ring_lse = ra._attend_blocks(q[:, rows], iter(blocks), parts,
                                          True, drop, 0, first)
        assert out.dtype == torch.float32
        assert torch.equal(out.to(torch.bfloat16), whole[:, rows])
        assert torch.equal(ring_lse, lse[:, :, rows])
        parts_grads = [ra._block_backward(
            q[:, rows], kb, vb, g[:, rows], lse[:, :, rows].contiguous(),
            delta[:, :, rows].contiguous(), True, drop, (0, first, i * m))
            for kb, vb, i in blocks]
        assert all(p[1].dtype == torch.float32 for p in parts_grads)
        dq = sum(p[0] for p in parts_grads).to(torch.bfloat16)
        assert (dq != grads[0][:, rows]).float().mean() < 1e-2
