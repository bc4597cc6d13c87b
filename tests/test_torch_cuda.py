"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
a GPU). Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host
need not have; nothing here imports JAX.)
"""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu_torch import (
    DetectorConfig, LossConfig, synthetic_batches)
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa, fused_ffn, fused_ln, quantization as qz)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,shape", [
    ("bhnk", (2, 12, 576, 64)),      # ViT-B/16 384px
    ("bhnk", (1, 8, 1296, 40)),      # reference arch, K padded to 64
    ("bnhk", (2, 77, 3, 64)),        # tokens-major, ragged N
    ("bnhk", (1, 200, 2, 8)),
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
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, layout="bhnk", dropout_rate=0.1,
                           dropout_seed=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), layout="bhnk")
    wide = torch.zeros(1, 2, 64, 128, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide, layout="bhnk")
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        fa.flash_attention(q, k.cpu(), v, layout="bhnk")


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


@pytest.mark.parametrize("flash,key_dim", [(True, 64), (True, 40),
                                           (False, 40)])
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


# Backward: grads relative to the largest; fp32 summation order (and dq's
# atomic adds in run-dependent order), bf16 rounding of p and ds.
GRAD_TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("layout,shape,dtype", [
    ("bnhk", (8, 1296, 8, 40), torch.float32),   # reference_608, batch 8
    ("bhnk", (1, 12, 576, 64), torch.bfloat16),
    ("bhnk", (1, 12, 576, 64), torch.float32),
    ("bnhk", (3, 77, 4, 40), torch.bfloat16),    # ragged N
    ("bnhk", (2, 200, 2, 8), torch.float32),
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
    for got, ref in zip(grads, fa.reference_attention_backward(q, k, v, g,
                                                               layout)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel(got, ref) <= GRAD_TOLS[dtype]

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fn = torch.autograd.grad(fa.flash_attention(*leaves, layout=layout),
                             leaves, g)
    auto = torch.autograd.grad(fa.reference_attention(*leaves, layout=layout),
                               leaves, g)
    for got, ref in zip(fn, auto):
        assert _rel(got, ref) <= GRAD_TOLS[dtype]


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


@pytest.mark.parametrize("rows,k,n,mish", [
    (576, 768, 1536, True), (1152, 1536, 768, True), (17, 512, 6, False),
    (34, 576, 2048, True), (5, 200, 96, False)])
def test_fused_int8_dense_kernel_matches_plain(gen, rows, k, n, mish):
    """Same codes, exact int32 sums, same fp32 rescale order: one bf16
    rounding (2^-7 of the largest value) at most."""
    layer = _quant_layer(gen, k, (n,))
    x = torch.randn(rows, k, device="cuda", generator=gen)
    before = qz.fused_int8_dense.launches
    got = qz.fused_int8_dense(x, layer, apply_mish=mish)
    torch.cuda.synchronize()
    assert qz.fused_int8_dense.launches == before + 1
    ref = qz.int8_dense_reference(x.to(torch.bfloat16), layer.kernel_q,
                                  layer.scale, layer.bias, mish,
                                  torch.bfloat16)
    _assert_within(got, ref, 2 ** -7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_dense_route_matches_plain(gen, dtype):
    """The fp32-out route of the q/k/v projections: (B, N, D) -> (B, N,
    H, K), exact to fp32 rounding."""
    layer = _quant_layer(gen, 768, (12, 64))
    x = torch.randn(2, 77, 768, device="cuda", generator=gen).to(dtype)
    before = qz.int8_dense.launches
    got = qz.int8_dense(x, layer)
    torch.cuda.synchronize()
    assert qz.int8_dense.launches == before + 1
    ref = qz.int8_dense_reference(x.reshape(-1, 768), layer.kernel_q,
                                  layer.scale, layer.bias.reshape(-1))
    _assert_within(got, ref.reshape(2, 77, 12, 64), 1e-6)


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
    (7, 100, 33, True)])
def test_dense_mish_kernel_matches_plain(gen, dtype, tol, rows, k, n, mish):
    x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(k, n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    before = fused_ffn.fused_dense_mish.launches
    got = fused_ffn.fused_dense_mish(x, w, b, apply_mish=mish)
    torch.cuda.synchronize()
    assert fused_ffn.fused_dense_mish.launches == before + 1
    _assert_within(got, fused_ffn.dense_mish_reference(x, w, b, mish), tol)


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
