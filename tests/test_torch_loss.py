"""The port's detection loss and box geometry vs the JAX package.

The reference loss oracles (tests/test_loss.py) run through the port;
then the same seeded numpy labels and logits go through the JAX
``detection_loss`` under ``jax.value_and_grad`` and through the port's
under autograd. fp32 on both sides: the loss to 1e-5 relative, the
gradients to 1e-5 of their largest magnitude (summation order and
transcendental rounding differ between XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig, LossConfig
from vision_transformer_detector_tpu.ops import geometry as jax_geometry
from vision_transformer_detector_tpu.ops.loss import (
    detection_loss as jax_detection_loss)
from vision_transformer_detector_tpu_torch.ops import geometry
from vision_transformer_detector_tpu_torch.ops.loss import detection_loss

CONFIG = DetectorConfig()
SMALL = DetectorConfig(image_size=(68, 68), embedding_dim=16, num_heads=2,
                       key_dim=8, encoder_blocks=2, encoder_mlp_layers=3,
                       head_last_units=16, head_layers=2)
SHAPE = (10, 6)


def make_labels() -> np.ndarray:
    y_true = np.ones((2, *SHAPE), np.float32) * -8.0
    y_true[..., 0] = 0.0
    y_true[0, 0] = (1, 79, 9, 9, 10, 10)
    return y_true


def port_loss(y_true, y_pred, config=CONFIG, loss_config=LossConfig(),
              decoded=True) -> float:
    return float(detection_loss(torch.from_numpy(y_true),
                                torch.from_numpy(y_pred), config, loss_config,
                                use_transform_predictions=not decoded))


# ---- the reference oracles -------------------------------------------------

def test_zero_loss():
    y_true = make_labels()
    assert port_loss(y_true, y_true.copy()) == pytest.approx(0.0, abs=1e-5)


@pytest.mark.parametrize("slot,value", [
    (0, 0.98),                      # objectness
    (1, 79.2),                      # classification
    (slice(-4, None), (9, 9, 9.8, 9.8)),   # CIoU
])
def test_perturbed_term_gives_positive_loss(slot, value):
    y_true = make_labels()
    y_pred = y_true.copy()
    y_pred[0, 0, slot] = value
    assert port_loss(y_true, y_pred) > 0.0


def test_loss_weights_scale_terms():
    y_true = make_labels()
    y_pred = y_true.copy()
    y_pred[0, 0, 1] = 79.2
    l1 = port_loss(y_true, y_pred, loss_config=LossConfig(
        weight_classification=1.0, weight_ciou=0.0))
    l2 = port_loss(y_true, y_pred, loss_config=LossConfig(
        weight_classification=2.0, weight_ciou=0.0))
    assert l2 == pytest.approx(2 * l1, rel=1e-6)


# ---- loss and grads against jax.grad ---------------------------------------

def _labels(seed, positives, config=SMALL, degenerate=False):
    rng = np.random.default_rng(seed)
    h, w = config.image_size
    y_true = np.full((3, config.max_objects, 6), -8.0, np.float32)
    y_true[..., 0] = 0.0
    for i in range(positives):
        b, s = i % 3, i // 3
        bh, bw = rng.uniform(4, h / 2, 2)
        if degenerate and i % 2 == 0:
            bh = 0.0                            # zero-height label box
        y_true[b, s] = (1, float(rng.integers(0, config.num_classes)),
                        rng.uniform(bw / 2, w - bw / 2),
                        rng.uniform(bh / 2, h - bh / 2), bh, bw)
    return y_true


def _both(y_true, y_pred, loss_config=LossConfig(), config=SMALL):
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jax_detection_loss(
        jnp.asarray(y_true), p, config, loss_config)))(jnp.asarray(y_pred))
    logits = torch.from_numpy(y_pred).requires_grad_()
    loss = detection_loss(torch.from_numpy(y_true), logits, config,
                          loss_config)
    (grad,) = torch.autograd.grad(loss, logits)
    return ((float(jloss), np.asarray(jgrad)),
            (float(loss.detach()), grad.numpy()))


@pytest.mark.parametrize("case", ["positives", "zero_positives",
                                  "exponent_0.5", "degenerate_boxes",
                                  "plain_bce"])
def test_loss_and_grads_match_jax(case):
    loss_config = LossConfig()
    y_true = _labels(0, 5, degenerate=case == "degenerate_boxes")
    if case == "zero_positives":
        y_true = _labels(0, 0)
    if case == "exponent_0.5":
        loss_config = dataclasses.replace(loss_config, exponent=0.5)
    if case == "plain_bce":
        loss_config = dataclasses.replace(loss_config,
                                          focal_binary_loss=False)
    y_pred = np.random.default_rng(1).normal(
        0, 1.5, y_true.shape).astype(np.float32)
    if case == "degenerate_boxes":
        # A decoded box of exactly the label's: rho = 0 and a tied sort.
        y_pred[0, 0, 2:] = 0.0
    (jloss, jgrad), (loss, grad) = _both(y_true, y_pred, loss_config)
    assert np.isfinite(loss) and np.all(np.isfinite(grad))
    assert np.all(np.isfinite(jgrad))
    assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jgrad).max()))
    if case == "zero_positives":
        # Only the objectness term is left: class and box grads are 0.
        assert not grad[..., 1:].any()


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 100, n), rng.uniform(0, 100, n),
                      rng.uniform(0, 40, n), rng.uniform(0, 40, n)], -1)
    return boxes.astype(np.float32)


def test_ciou_and_enclosing_diagonal_match_jax():
    """Random pairs plus identical pairs (rho = 0, tied edges) and
    zero-size pairs (c = 0): values and grads of the sum."""
    label, pred = _boxes(2), _boxes(3)
    pred[:8] = label[:8]
    label[8:12] = pred[8:12] = (50.0, 50.0, 0.0, 0.0)
    for name in ("ciou", "enclosing_diagonal", "iou"):
        jfn, tfn = getattr(jax_geometry, name), getattr(geometry, name)
        jval, jgrads = jax.value_and_grad(
            lambda a, b: jnp.sum(jfn(a, b)), argnums=(0, 1))(
            jnp.asarray(label), jnp.asarray(pred))
        a, b = (torch.from_numpy(x).requires_grad_() for x in (label, pred))
        values = tfn(a, b)
        grads = torch.autograd.grad(values.sum(), (a, b))
        np.testing.assert_allclose(
            values.detach().numpy(), np.asarray(jfn(label, pred)),
            rtol=1e-5, atol=1e-5, err_msg=name)
        for got, want in zip(grads, jgrads):
            assert np.all(np.isfinite(got.numpy())), name
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
