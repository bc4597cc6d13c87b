"""The benchmark's own arithmetic: the frozen FLOP count, the flash
kernels' operations and bytes, and the kernel-name table."""

import pytest

from perfbench import flops, kernel_groups

PORT_PRESETS = ["reference_608", "reference_224", "vit_s16_224",
                "vit_b16_384", "vit_l16_640", "highres_1024", "tiny_96"]


def _cfg(name):
    from vision_transformer_detector_tpu_torch.config import (
        PRESETS, configs_to_dict)

    return PRESETS[name](), configs_to_dict(PRESETS[name]())["detector"]


@pytest.mark.parametrize("name,gflops", [("vit_l16_640", 898.7),
                                         ("vit_b16_384", 78.3)])
def test_forward_flops_per_image(name, gflops):
    _, cfg = _cfg(name)
    assert round(flops.forward_flops(cfg) / 1e9, 1) == gflops


@pytest.mark.parametrize("name", PORT_PRESETS)
def test_frozen_copy_matches_the_port(name):
    from vision_transformer_detector_tpu_torch.utils.profiling import (
        flops_estimate)

    config, cfg = _cfg(name)
    assert flops.forward_flops(cfg, 3) == flops_estimate(config, 3)


def test_flash_counts_by_hand():
    bh, n, k = 1024, 1600, 64
    ops, nbytes = flops.flash_forward(bh, n, k)
    assert ops == 2 * (2 * bh * n * n * k)          # QK^T and PV
    assert nbytes == 4 * bh * n * k * 2             # q, k, v in; o out
    _, with_lse = flops.flash_forward(bh, n, k, with_lse=True)
    assert with_lse - nbytes == bh * n * 4
    ops, nbytes = flops.flash_backward(bh, n, k)
    assert ops == 5 * (2 * bh * n * n * k)
    assert nbytes == 7 * bh * n * k * 2 + 2 * bh * n * 4
    # (1024, 1600, 64) bf16 is bound by its operations: 0.679 ms.
    fwd = flops.bound_seconds(*flops.flash_forward(bh, n, k))
    assert fwd == pytest.approx(4 * bh * n * n * k / 989e12)
    assert round(fwd * 1e3, 3) == 0.679
    # (2048, 256, 64) backward is bound by its bytes (PERF.md: 0.1415 ms).
    bwd = flops.bound_seconds(*flops.flash_backward(2048, 256, 64))
    assert round(bwd * 1e3, 4) == 0.1415


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_fwd_sm90_kernel<64, false, "
     "__nv_bfloat16>(CUtensorMap_st)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_sm90_kernel<64, false>", "flash_bwd"),
    ("void (anonymous namespace)::flash_bwd_dq_sm90_kernel<64>", "flash_bwd"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "at::native::bfloat16_copy_kernel_cuda>", "elementwise"),
    ("layer_norm_kernel", "elementwise"),
])
def test_kernel_groups(name, group):
    assert kernel_groups.group_of(name) == group
