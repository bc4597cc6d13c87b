"""Head dims 129-256 in bf16 on the wgmma kernels' 256 instance, and the
mma.sync wide route that keeps fp32 past 128 and bf16 past 256.

On the CPU the port takes its plain versions, which are held here against
the JAX package (its Pallas kernels in interpret mode, as
tests/test_kernels.py runs them): a narrow detector with key_dim 256, its
logits and one train step's gradients, in fp32. The routing (which kernel
a call on the card would launch, which operands it would copy) is checked
without a card, and the operators' launch plans for it in
tests/test_torch_flash_launch.py; the kernels themselves on the card by
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

# The width a K whose rows are off 16 bytes is padded to (in both
# dtypes): 129 to 192, a whole TMA box of the 256 instance; 257 to 320,
# past it.
PADDED = {129: 192, 257: 320}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kdim", [129, 192, 256, 257])
def test_wide_head_dims_route_by_dtype(dtype, kdim):
    """bf16 up to K 256 runs both directions on wgmma (the 256 instance);
    fp32 past 128 and bf16 past 256 on the wide forward and the backward's
    cluster route (ceil(K / 128) or ceil(K / 256) CTAs), which
    ``head_dim_plan`` plans and ``kernel_width`` pads for."""
    (read,), _ = fa._addressable([torch.zeros(1, 3, 2, kdim, dtype=dtype)])
    width = read.shape[-1]
    assert width == PADDED.get(kdim, kdim)
    wgmma = dtype == torch.bfloat16 and width <= 256
    assert fa.forward_kernel(width, dtype) == ("wgmma" if wgmma
                                               else "wide")
    assert fa.backward_kernel(width, dtype) == ("wgmma" if wgmma
                                                else "cluster")
    assert fa.head_dim_plan(width).instance == "wide"
    assert fa.head_dim_plan(width, dtype).grad_cluster == (
        1 if wgmma else -(-width // fa.BWD_CLUSTER_SHARE[dtype]))


# A narrow detector with 256-wide heads (the ViT-H/14-width detector of
# chip_smoke.py's wide_heads phase has 5 heads of 256): 2 heads of 256,
# 16 tokens, 2 blocks, on the flash route for inference and training.
NARROW = dict(image_size=(64, 64), patch_size=16, embedding_dim=32,
              num_heads=2, key_dim=256, encoder_blocks=2,
              encoder_mlp_layers=2, head_last_units=16, head_layers=2,
              use_flash_attention=True, train_use_flash_attention=True)


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def test_narrow_key_dim_256_model_matches_jax():
    """The key_dim 256 model from JAX's weights: logits of the flash route
    (JAX: interpret-mode kernels; port: plain versions), 1e-4 of the
    largest logit (at least 1), and one train step's loss (1e-5 relative)
    and gradients of the detection loss, each leaf within 1e-4 of its
    largest value (fp32: summation order only)."""
    jax_config = JaxDetectorConfig(**NARROW)
    config = DetectorConfig(**NARROW)
    jax_params = jax_init_params(jax.random.PRNGKey(1), jax_config)
    images, labels = next(synthetic_batches(config, 2, 1, seed=6))

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
    want_logits = np.asarray(want_logits, np.float32)
    scale = max(1.0, np.abs(want_logits).max())
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=1e-4 * scale)
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
