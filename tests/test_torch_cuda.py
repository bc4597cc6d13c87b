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

from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.models import vit_detector as model

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
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, layout="bhnk", with_lse=True)
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
