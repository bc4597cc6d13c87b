"""Head dims above 64 (the flash kernels' 128-wide instance and, past 128,
their wide route): the port's plain versions against the JAX package at
K = 80 (ViT-H/14's), 96 and 128, and at 192 and 256.

The JAX wrapper pads K to a multiple of 64 with no upper limit, so these
widths run its Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them); the port pads them to its 128-wide
instance on the card and takes the plain versions on CPU tensors, which
are held here against JAX: the forward and its logsumexp, the dropout
forward (its keep mask read back bit for bit), the backward (JAX's chunked
recomputation and its Pallas B2) and the backward with the mask replayed,
in both layouts; and a narrow model with key_dim 80 on the flash route,
its logits and one train step's gradients; at K = 192 and 256 (the wide
route) and 448 in fp32 and 576 in bf16 (the forward's thread-block
clusters on the card), the forward, its logsumexp, the backward by JAX's
Pallas B2 and the dropout forward with its replayed grads. The CUDA
instances and the wide route are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py's ``wide_heads`` phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig as JaxDetectorConfig)
from vision_transformer_detector_tpu.config import LossConfig as JaxLossConfig
from vision_transformer_detector_tpu.kernels import flash_attention as jax_fa
from vision_transformer_detector_tpu.models.vit_detector import (
    forward as jax_forward, init_params as jax_init_params)
from vision_transformer_detector_tpu.ops.loss import (
    detection_loss as jax_detection_loss)
from vision_transformer_detector_tpu_torch import (
    DetectorConfig, LossConfig, synthetic_batches)
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.models.vit_detector import forward
from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    params_from_numpy)

# tests/test_torch_flash_attention.py's tolerances: fp32 to summation
# order, bf16 ~1e-2 (p rounds to bf16 at other running maxima); grads
# relative to the largest one (at least 1).
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
WIDE = (80, 96, 128)
N = 70            # ragged: JAX pads it to one 128-row block
RATE, SEED = 0.25, 2 ** 32 - 7


def _shape(layout, kdim, n=N):
    return (1, n, 2, kdim) if layout == "bnhk" else (1, 2, n, kdim)


def _inputs(shape, dtype, seed):
    """(jax q, k, v, g), (torch q, k, v, g): the same numpy draws, q
    scaled by 1/sqrt(K), rounded to ``dtype`` once on the JAX side."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    jax_side = tuple(jnp.asarray(t, jnp.dtype(dtype)) for t in (
        q / np.float32(np.sqrt(shape[-1])), k, v, g))
    torch_side = tuple(torch.from_numpy(np.array(jnp.asarray(
        t, jnp.float32))).to(getattr(torch, dtype)) for t in jax_side)
    return jax_side, torch_side


def _close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("kdim", WIDE)
def test_kernel_width_of_the_wide_dims_is_128(kdim):
    """K 65..128 runs the 128-wide instance: zero-padded, exactly."""
    t = torch.randn(1, 3, 2, kdim)
    assert fa.kernel_width(kdim) == 128
    padded = fa._pad_head_dim(t)
    assert padded.shape[-1] == 128 and torch.equal(padded[..., :kdim], t)
    assert not padded[..., kdim:].any()


@pytest.mark.parametrize("kdim,dtype,forward,windows,cluster", [
    (132, torch.float32, "wide", 1, 1), (384, torch.float32, "wide", 1, 1),
    (448, torch.float32, "cluster", 1, 2),
    (512, torch.float32, "cluster", 1, 2),
    (3072, torch.float32, "cluster", 1, 8),
    (3104, torch.float32, "windowed", 25, 1),
    (264, torch.bfloat16, "wide", 1, 1), (512, torch.bfloat16, "wide", 1, 1),
    (576, torch.bfloat16, "cluster", 1, 2),
    (640, torch.bfloat16, "cluster", 1, 2),
    (1024, torch.bfloat16, "cluster", 1, 2),
    (4096, torch.bfloat16, "cluster", 1, 8),
    (4160, torch.bfloat16, "windowed", 33, 1)])
def test_the_forward_plan_names_the_wide_or_the_windowed_kernel(
        kdim, dtype, forward, windows, cluster):
    """The wide forward takes fp32 to K 384 and bf16 to K 512 in one CTA,
    past that in one window as a thread-block cluster of ceil(K / 384) or
    ceil(K / 512) CTAs, to 8 (K 3072 and 4096); past that the windowed
    route's output windows of 128 columns (a grid axis that reads S back
    from the scores workspace: every route forms a tile pair's S once,
    ``chunks`` 1). The backward past 128 (fp32) and 256 (bf16) is the wide
    library's whatever the forward: its cluster of ceil(K / 128) or
    ceil(K / 256) CTAs to 1024 and 2048, its windowed route past them."""
    plan = fa.head_dim_plan(kdim, dtype)
    assert plan.chunks == 1
    share = fa.BWD_CLUSTER_SHARE[dtype]
    backward = "cluster" if kdim <= 8 * share else "windowed"
    assert (plan.forward, plan.windows, plan.backward, plan.cluster) == (
        forward, windows, backward, cluster)
    assert plan.grad_cluster == (-(-kdim // share) if backward == "cluster"
                                 else 1)
    assert fa.forward_kernel(kdim, dtype) == forward
    assert fa.cluster_size(kdim, dtype) == cluster


@pytest.mark.parametrize("kdim", [65, 80, 96, 112, 128])
def test_fp32_65_to_128_runs_the_128_instance_both_ways(kdim):
    """fp32 K 65-128: the 128-wide plan both ways, on column halves: the
    wide forward's (``forward_kernel`` "halves", counted in
    ``halves_launches``) and the backward's (``backward_kernel``
    "mma_sync", counted in ``halves_backward_launches``), S whole in one
    chunk and window, no cluster."""
    assert fa.head_dim_plan(kdim) == fa.HeadDimPlan(128, 1, 1, 1, "halves",
                                                     "mma_sync", 1)


@pytest.mark.parametrize(
    "kdim,grad_windows,forward,backward,cluster,grad_cluster",
    [(129, 1, "wide", "cluster", 1, 2),
     (192, 1, "wide", "cluster", 1, 2),
     (256, 1, "wide", "cluster", 1, 2),
     (384, 1, "wide", "cluster", 1, 3),
     (1024, 1, "cluster", "cluster", 3, 8),
     (1028, 17, "cluster", "windowed", 3, 1)])
def test_wider_than_128_takes_the_wide_route(kdim, grad_windows, forward,
                                             backward, cluster,
                                             grad_cluster):
    """K past the widest mma.sync instance runs the wide kernels (fp32 at
    any such K, bf16 past 256, where the wgmma 256 instance stops), as
    JAX runs any K: the forward in one window (the wide forward forms S
    once a tile, to K 384 in fp32, its cluster past that), the backward
    as a cluster of ceil(K / 128) CTAs that forms S once a tile (to K
    1024 in fp32), past that S and dP once a tile pair into a workspace
    and its output in windows of 64 that read them; nothing raises. A K whose rows cannot be addressed in
    place pads to a multiple of 64, exactly; the plain version on the CPU
    computes any K."""
    plan = fa.head_dim_plan(kdim)
    assert plan == fa.HeadDimPlan("wide", 1, 1, grad_windows, forward,
                                  backward, cluster, grad_cluster)
    assert fa.forward_kernel(kdim, torch.float32) == forward
    assert fa.forward_kernel(kdim, torch.bfloat16) == (
        "wgmma" if kdim <= 256 else "wide" if kdim <= 512 else "cluster")
    t = torch.randn(1, 2, 8, kdim)
    fa._check_inputs(t, t, t)
    padded = fa._pad_head_dim(t)
    assert padded.shape[-1] == 64 * -(-kdim // 64) == fa.kernel_width(kdim)
    assert torch.equal(padded[..., :kdim], t)
    assert not padded[..., kdim:].any()
    out = fa.flash_attention(t, t, t, layout="bhnk")
    assert out.shape == t.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bnhk", "bhnk"])
@pytest.mark.parametrize("kdim", WIDE)
def test_forward_and_lse_match_jax(kdim, layout, dtype):
    """The port's forward and logsumexp against JAX's Pallas forward with
    lse (interpret mode), which pads K to 128."""
    shape = _shape(layout, kdim)
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(shape, dtype, seed=kdim)
    out, lse = jax_fa._flash_forward(jq, jk, jv, 128, 128, True,
                                     with_lse=True, layout=layout)
    got, got_lse = fa.flash_attention(tq, tk, tv, layout=layout,
                                      with_lse=True)
    assert got.dtype == tq.dtype and tuple(got.shape) == shape
    _close(got, out, TOLS[dtype], "out")
    b, h = 1, 2
    want_lse = np.asarray(lse)[:, 0, :N].reshape(b, h, N)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), want_lse,
                               atol=TOLS["float32"], rtol=TOLS["float32"])


@pytest.mark.parametrize("layout,kdim", [("bnhk", 80), ("bhnk", 96),
                                         ("bnhk", 128)])
def test_dropout_mask_read_back_bit_equal_to_jax(layout, kdim):
    """With q = k = 0 every probability is 1/N, and with v the identity
    (N = K keys, one column each) the output's (query, key) entry is
    keep / (N (1 - rate)): the whole mask, read back from JAX's dropout
    forward and from the port's, bit for bit."""
    n = kdim
    shape = _shape(layout, kdim, n)
    zeros = np.zeros(shape, np.float32)
    eye = np.eye(n, kdim, dtype=np.float32)
    v = (np.broadcast_to(eye[None, :, None, :], shape) if layout == "bnhk"
         else np.broadcast_to(eye[None, None], shape)).copy()
    out = jax_fa.flash_attention(
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(v),
        block_q=128, block_kv=128, layout=layout, interpret=True,
        dropout_rate=RATE, dropout_seed=jnp.uint32(SEED))
    got = fa.flash_attention(torch.from_numpy(zeros),
                             torch.from_numpy(zeros), torch.from_numpy(v),
                             layout=layout, dropout_rate=RATE,
                             dropout_seed=SEED)
    to_mask = lambda o: np.rint(  # noqa: E731
        np.asarray(o, np.float64) * n * (1 - RATE)).astype(np.int64)
    want_mask, got_mask = to_mask(out), to_mask(got.numpy())
    assert set(np.unique(want_mask)) == {0, 1}
    np.testing.assert_array_equal(got_mask, want_mask)
    # ... and both are dropout_keep_mask over the kernels' numbering.
    bh = torch.arange(2).reshape(2, 1, 1)
    idx = torch.arange(n)
    keep = fa.dropout_keep_mask(SEED, bh, idx[:, None], idx[None, :],
                                fa._keep_threshold(RATE)).numpy()
    heads_major = got_mask[0] if layout == "bhnk" else got_mask[0].transpose(
        1, 0, 2)
    np.testing.assert_array_equal(heads_major, keep.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bnhk", "bhnk"])
@pytest.mark.parametrize("kdim", WIDE)
def test_dropout_forward_and_replayed_grads_match_jax(kdim, layout, dtype):
    """Forward and dq/dk/dv with dropout: JAX's interpret-mode forward and
    its chunked backward (which replays the mask) against the port's
    plain versions, at rate 0.25 and a seed near 2**32."""
    shape = _shape(layout, kdim)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype, seed=kdim + 1)
    out, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, block_q=128, block_kv=128, layout=layout, interpret=True,
        dropout_rate=RATE, dropout_seed=jnp.uint32(SEED)), jq, jk, jv)
    expected = vjp(jg)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = fa.flash_attention(*leaves, layout=layout, dropout_rate=RATE,
                             dropout_seed=SEED)
    _close(got, out, TOLS[dtype], "out")
    for name, mine, ref in zip("qkv", torch.autograd.grad(got, leaves, tg),
                               expected):
        assert mine.dtype == tq.dtype and tuple(mine.shape) == shape
        _close(mine, ref, TOLS[dtype], f"d{name}")


@pytest.mark.parametrize("pallas_backward", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,kdim", [("bnhk", 80), ("bhnk", 80),
                                         ("bnhk", 96), ("bhnk", 128)])
def test_backward_matches_jax(layout, kdim, dtype, pallas_backward):
    """dq/dk/dv of the port's flash_attention (the plain backward on the
    CPU) against ``jax.vjp`` of JAX's with its chunked backward or its
    Pallas backward kernel B2 (interpret mode), at the wide dims."""
    shape = _shape(layout, kdim)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype, seed=kdim + 2)
    _, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, block_q=128, block_kv=128, layout=layout, interpret=True,
        use_pallas_backward=pallas_backward), jq, jk, jv)
    expected = vjp(jg)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, layout=layout),
                              leaves, tg)
    for name, mine, ref in zip("qkv", got, expected):
        assert mine.dtype == tq.dtype and tuple(mine.shape) == shape
        _close(mine, ref, TOLS[dtype], f"d{name}")


# Past 128 (K, dtype): the kernels' wide route on the card, one CTA of the
# wide forward at fp32 192 and 256, its thread-block clusters at fp32 448
# (two CTAs of 7 and 6 32-column pairs) and bf16 576 (two of 5 and 4
# 64-column boxes).
WIDER = ((192, "float32"), (256, "float32"), (448, "float32"),
         (576, "bfloat16"))
# lse: fp32 logsumexps of the same rounded q and k, summed in other orders.
LSE_TOLS = {"float32": 2e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("layout", ["bnhk", "bhnk"])
@pytest.mark.parametrize("kdim,dtype", WIDER)
def test_wide_forward_lse_and_backward_match_jax(kdim, dtype, layout):
    """K = 192, 256, 448 (fp32) and 576 (bf16) (JAX pads them to multiples
    of 64 and runs its Pallas kernels): the port's forward and lse against
    JAX's forward with lse, and dq/dk/dv against ``jax.vjp`` through JAX's
    Pallas backward B2, all in interpret mode."""
    shape = _shape(layout, kdim)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype,
                                                 seed=kdim + 3)
    out, lse = jax_fa._flash_forward(jq, jk, jv, 128, 128, True,
                                     with_lse=True, layout=layout)
    got, got_lse = fa.flash_attention(tq, tk, tv, layout=layout,
                                      with_lse=True)
    _close(got, out, TOLS[dtype], "out")
    want_lse = np.asarray(lse)[:, 0, :N].reshape(1, 2, N)
    np.testing.assert_allclose(got_lse.numpy(), want_lse,
                               atol=LSE_TOLS[dtype], rtol=LSE_TOLS[dtype])
    _, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, block_q=128, block_kv=128, layout=layout, interpret=True,
        use_pallas_backward=True), jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, layout=layout),
                                leaves, tg)
    for name, mine, ref in zip("qkv", grads, vjp(jg)):
        assert tuple(mine.shape) == shape
        _close(mine, ref, TOLS[dtype], f"d{name}")


@pytest.mark.parametrize("layout", ["bnhk", "bhnk"])
@pytest.mark.parametrize("kdim,dtype", WIDER)
def test_wide_dropout_forward_and_grads_match_jax(kdim, dtype, layout):
    """K = 192, 256, 448 (fp32) and 576 (bf16) with dropout (rate 0.25, a
    seed near 2**32): JAX's interpret-mode forward and its backward, which
    replays the mask, against the port's."""
    shape = _shape(layout, kdim)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype,
                                                 seed=kdim + 4)
    out, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, block_q=128, block_kv=128, layout=layout, interpret=True,
        dropout_rate=RATE, dropout_seed=jnp.uint32(SEED)), jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = fa.flash_attention(*leaves, layout=layout, dropout_rate=RATE,
                             dropout_seed=SEED)
    _close(got, out, TOLS[dtype], "out")
    for name, mine, ref in zip("qkv", torch.autograd.grad(got, leaves, tg),
                               vjp(jg)):
        _close(mine, ref, TOLS[dtype], f"d{name}")


# A narrow detector with ViT-H/14's head dim: 2 heads of 80 (padded to the
# 128-wide instance on the card), 16 tokens, 2 blocks, on the flash route
# for inference and training.
NARROW = dict(image_size=(64, 64), patch_size=16, embedding_dim=32,
              num_heads=2, key_dim=80, encoder_blocks=2, encoder_mlp_layers=2,
              head_last_units=16, head_layers=2, use_flash_attention=True,
              train_use_flash_attention=True)


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def test_narrow_key_dim_80_model_matches_jax():
    """The key_dim 80 model from JAX's weights: logits of the flash route
    (JAX: interpret-mode kernels; port: plain versions) and one train
    step's gradients of the detection loss, each leaf against JAX's
    relative to its largest value (fp32)."""
    jax_config = JaxDetectorConfig(**NARROW)
    config = DetectorConfig(**NARROW)
    jax_params = jax_init_params(jax.random.PRNGKey(0), jax_config)
    images, labels = next(synthetic_batches(config, 2, 1, seed=4))

    def jax_loss(params):
        logits = jax_forward(params, jnp.asarray(images), jax_config)
        return jax_detection_loss(jnp.asarray(labels), logits, jax_config,
                                  JaxLossConfig()), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(jax_params)
    model = params_from_numpy(_jax_flat(jax_params), config)
    before = fa.flash_attention.launches
    logits = forward(model, torch.from_numpy(images), config)
    assert fa.flash_attention.launches == before      # CPU: no kernel
    _close(logits, want_logits, 1e-4, "logits")
    loss = detection_loss(torch.from_numpy(labels), logits, config,
                          LossConfig())
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = _jax_flat(want_grads)
    by_name = {name.replace(".", "/"): g for name, g in grads.items()}
    assert set(by_name) == set(want)
    for name, ref in want.items():
        mine = by_name[name].numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        if name.endswith("mha/key/bias"):   # 0 in exact arithmetic
            scale = max(np.abs(r).max() for r in want.values())
        assert np.abs(mine - ref).max() <= 1e-4 * scale, name
