"""The plain reference against the port's CPU path at ``tiny_96``
(float32): forward, decode, NMS + top-k, loss, gradients, one optimiser
step."""

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import vit_detector as ref


@pytest.fixture(scope="module")
def tiny():
    from vision_transformer_detector_tpu_torch.config import (
        configs_to_dict, tiny_96)

    cfg = configs_to_dict(tiny_96())["detector"]
    config = harness.port_config(cfg)
    weights = inputs.make_weights(cfg, 2 ** 31 + 9, "cpu")
    images = inputs.make_images(3, cfg, 5, "images", "cpu")
    labels = inputs.make_labels(3, cfg, 5, "labels", "cpu")
    return cfg, config, weights, images, labels


def _model(config, weights):
    return harness.port_model(config, {n: v.clone() for n, v in
                                       weights.items()})


def test_forward_and_decode(tiny):
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        forward)
    from vision_transformer_detector_tpu_torch.ops.decode import (
        transform_predictions)

    cfg, config, weights, images, _ = tiny
    with torch.no_grad():
        got = forward(_model(config, weights), images.float() / 127.5 - 1,
                      config)
        want = ref.forward(weights, images, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(transform_predictions(got, config),
                               ref.decode(want, cfg), rtol=1e-5, atol=1e-4)


def test_nms_and_top_k_match_the_port(tiny):
    from vision_transformer_detector_tpu_torch.ops.nms import (
        postprocess_detections)
    from vision_transformer_detector_tpu_torch.serving import _pack_raw

    cfg = tiny[0]
    # Crowded boxes of few classes, so NMS has work to do.
    g = torch.Generator().manual_seed(4)
    decoded = torch.rand((16, 17, 6), generator=g, dtype=torch.float64)
    decoded[..., 1] = torch.randint(0, 3, (16, 17), generator=g) + 0.2
    decoded[..., 2:4] = 40 + 10 * decoded[..., 2:4]
    decoded[..., 4:6] = 20 + 30 * decoded[..., 4:6]
    port = _pack_raw(*postprocess_detections(decoded.float())).numpy()
    mine = ref.packed(decoded.float())
    assert np.array_equal(port[..., 6], mine[..., 6])
    np.testing.assert_allclose(port, mine, rtol=1e-5, atol=1e-4)
    assert port[..., 6].sum() < port[..., 6].size     # something suppressed


def test_loss_gradients_and_step(tiny):
    from vision_transformer_detector_tpu_torch.config import (
        LossConfig, TrainConfig)
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    cfg, config, weights, images, labels = tiny
    loss_cfg = {"focal_binary_loss": True, "focal_gamma": 2.0,
                "coefficient": 9.0, "exponent": 2.0,
                "weight_classification": 0.0074, "weight_ciou": 4.5}
    train_cfg = {"learning_rate": 8e-5, "clip_gradient_value": 10.0}
    trainer = Trainer(config, LossConfig(**loss_cfg), TrainConfig(**train_cfg),
                      device="cpu")
    model = _model(config, weights)
    state = {"params": model, "step": 0,
             "opt_state": trainer.optimizer.init(
                 dict(model.named_parameters()))}
    losses = []
    for _ in range(2):
        _, loss = trainer.train_step(state, images, labels)
        losses.append(float(loss))
    w = {n: v.clone() for n, v in weights.items()}
    norms = {}

    def on_step(step, _, grads, __):
        if step == 0:
            norms.update({n: float(g.norm()) for n, g in grads.items()})

    want = ref.train_steps(w, [(images, labels)] * 2, cfg, loss_cfg,
                           train_cfg, 2, chunk=2, on_step=on_step)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    # A leaf whose gradient is nought to rounding (a key's bias under
    # softmax) moves by round-off alone under Adam: the check's rule
    # leaves it out, and so does this test.
    median = np.median(list(norms.values()))
    moving = {n for n, v in norms.items() if v >= 1e-3 * median}
    assert {n for n in norms if n not in moving} == {
        n for n in norms if n.endswith("mha.key.bias")}
    for name, p in model.named_parameters():
        if name in moving:
            torch.testing.assert_close(p.detach(), w[name], rtol=1e-5,
                                       atol=1e-6)


def test_control_is_another_precision(tiny):
    cfg, _, weights, images, _ = tiny
    with torch.no_grad():
        exact = ref.forward(weights, images, cfg)
        low = ref.forward(weights, images, cfg, ref.fp8_e4m3())
    gap = (exact - low).abs().max()
    assert 1e-3 < gap < 10 * exact.abs().max()
