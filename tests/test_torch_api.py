"""The port's reference-compatible API (vision_transformer_detector_tpu_torch/
api.py): the twins of tests/test_api.py on the CPU, and the same weights
giving the JAX package's outputs through Detector.save / Detector.load."""

import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu import api as jax_api
from vision_transformer_detector_tpu_torch import api
from vision_transformer_detector_tpu_torch.config import DetectorConfig

FACTORY = dict(input_shape=(68, 68, 3), patch_size=17, embedding_dim=12,
               encoder_num_heads=2, encoder_key_dim=6,
               encoder_mlp_quantities=2, encoder_repeat_times=1,
               mlp_head_last_units=8, mlp_head_dense_layers_quantity=1)


@pytest.fixture(scope="module")
def detector():
    return api.create_vision_transformer_detector(device="cpu", **FACTORY)


def test_factory_signature_and_predict(detector):
    images = np.zeros((2, 68, 68, 3), np.float32)
    raw = detector.predict(images)
    assert raw.shape == (2, 17, 6)
    decoded = detector.predict_decoded(images)
    assert decoded[..., 0].min() >= 0 and decoded[..., 0].max() <= 1
    assert detector.count_params() > 0
    assert detector.device == torch.device("cpu")
    # uint8 pixels are normalized as the steps do.
    np.testing.assert_allclose(
        detector.predict(np.full((1, 68, 68, 3), 255, np.uint8)),
        detector.predict(np.ones((1, 68, 68, 3), np.float32)), atol=1e-6)


def test_call_like_keras_model(detector):
    out = detector(np.zeros((1, 68, 68, 3), np.float32), training=False)
    assert isinstance(out, torch.Tensor) and out.shape == (1, 17, 6)


def test_evaluate_returns_map(detector):
    images = np.zeros((2, 68, 68, 3), np.float32)
    labels = np.full((2, 17, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 3, 34, 34, 20, 20)
    ap = detector.evaluate([(images, labels)])
    assert 0.0 <= ap <= 1.0


def test_save_load_roundtrip_and_the_jax_detector(detector, tmp_path):
    """params.npz round trip, and the JAX Detector loads the same file and
    predicts the same logits."""
    path = str(tmp_path / "weights.npz")
    detector.save(path)
    loaded = api.Detector.load(path, detector.config, device="cpu")
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 68, 68, 3)).astype(np.float32)
    np.testing.assert_array_equal(detector.predict(images),
                                  loaded.predict(images))
    from vision_transformer_detector_tpu.config import (
        DetectorConfig as JaxConfig)

    jax_detector = jax_api.Detector.load(
        path, JaxConfig(**{f: getattr(detector.config, f)
                           for f in detector.config.__dataclass_fields__}))
    np.testing.assert_allclose(loaded.predict(images),
                               jax_detector.predict(images), atol=1e-4,
                               rtol=1e-4)


def test_my_custom_loss_reference_defaults():
    cfg = DetectorConfig()
    y_true = np.full((1, 17, 6), -8.0, np.float32)
    y_true[..., 0] = 0.0
    y_true[0, 0] = (1, 79, 100, 100, 50, 50)
    loss = api.my_custom_loss(y_true, y_true.copy(),
                              use_transform_predictions=False, config=cfg)
    assert float(loss) == pytest.approx(0.0, abs=1e-5)
    y_pred = np.random.default_rng(1).normal(0, 1, (1, 17, 6)).astype(
        np.float32)
    assert float(api.my_custom_loss(y_true, y_pred)) == pytest.approx(
        float(jax_api.my_custom_loss(y_true, y_pred)), rel=1e-5)


def test_transform_predictions_default_config():
    decoded = api.transform_predictions(np.zeros((1, 17, 6), np.float32))
    assert float(decoded[0, 0, 2]) == pytest.approx(304.0)
    assert float(decoded[0, 0, 1]) == pytest.approx(0.5 * 79)


def test_learning_rate_step_decay_pure():
    kwargs = dict(epochs_first_lr_decay=10, epochs_second_lr_decay=20,
                  epochs_third_lr_decay=30, rate_lr_decay=0.1)
    assert api.learning_rate_step_decay(5, 1.0, **kwargs) == 1.0
    assert api.learning_rate_step_decay(10, 1.0, **kwargs) == pytest.approx(
        0.1)
    assert api.learning_rate_step_decay(11, 0.1, **kwargs) == pytest.approx(
        0.1)
    assert api.learning_rate_step_decay(30, 0.1, **kwargs) == pytest.approx(
        0.01)
    assert api.learning_rate_step_decay(
        60, 1.0, allowed_decay_times=1, **kwargs) == 1.0
    lr, trajectory = 1.0, {}
    for epoch in range(70):
        lr = api.learning_rate_step_decay(epoch, lr, **kwargs)
        trajectory[epoch] = lr
        assert lr == jax_api.learning_rate_step_decay(
            epoch, trajectory.get(epoch - 1, 1.0), **kwargs)
    assert trajectory[9] == 1.0
    assert trajectory[10] == pytest.approx(0.1)
    assert trajectory[30] == pytest.approx(0.01)
    assert trajectory[69] == pytest.approx(1e-3)
    # The schedule the port trains with gives the same trajectory.
    from vision_transformer_detector_tpu_torch.config import TrainConfig
    from vision_transformer_detector_tpu_torch.train.optimizer import (
        make_lr_schedule)
    schedule = make_lr_schedule(TrainConfig(
        learning_rate=1.0, epochs_first_lr_decay=10,
        epochs_second_lr_decay=20, epochs_third_lr_decay=30,
        rate_lr_decay=0.1))
    for epoch in (9, 10, 29, 30, 59, 69):
        assert schedule(epoch) == pytest.approx(trajectory[epoch]), epoch


def test_check_weights(detector):
    assert np.isfinite(api.check_weights(detector))
    assert api.check_weights(detector) == api.check_weights(detector.params)


def test_metric_alias_is_reference_metric():
    from vision_transformer_detector_tpu_torch.metrics.mean_average_precision \
        import MeanAveragePrecision
    assert api.MeanAveragePrecision is MeanAveragePrecision


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        api.Detector(DetectorConfig(**{"image_size": (68, 68),
                                       "patch_size": 17}))


def test_debugging_helpers_match_the_jax_ones(tmp_path, capsys):
    """utils/debugging.py on the same weights as the JAX package's: the
    same extrema, the same per-parameter norms under the same names, and
    the same inf/NaN reports."""
    import jax

    from vision_transformer_detector_tpu.config import get_config
    from vision_transformer_detector_tpu.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu.utils import debugging as jax_dbg
    from vision_transformer_detector_tpu.utils.checkpoint import (
        save_params_npz)
    from vision_transformer_detector_tpu_torch import config as port_config
    from vision_transformer_detector_tpu_torch.utils import debugging
    from vision_transformer_detector_tpu_torch.utils.checkpoint import (
        load_params_npz)

    params = init_params(jax.random.PRNGKey(0), get_config("tiny_96"))
    path = str(tmp_path / "p.npz")
    save_params_npz(path, params)
    model = load_params_npz(path, port_config.get_config("tiny_96"))
    assert debugging.param_extrema(model) == jax_dbg.param_extrema(params)
    assert debugging.check_params(model) == jax_dbg.check_params(params)
    want = jax_dbg.param_norms(params)
    got = debugging.param_norms(model)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-6), name

    x = np.array([1.0, np.nan, np.inf, 6e4], np.float32)
    capsys.readouterr()
    fixed = debugging.check_inf_nan(torch.from_numpy(x), "x",
                                    replace_nan=0.0)
    port_report = capsys.readouterr().out
    jax_fixed = jax_dbg.check_inf_nan(x, "x", replace_nan=0.0)
    assert port_report == capsys.readouterr().out
    np.testing.assert_array_equal(fixed, np.asarray(jax_fixed))
    assert "Inf! Found in x" in port_report and "NaN!" in port_report
    assert debugging.check_inf_nan(3.0, "s") == 3.0
    y = torch.tensor([1.0, float("nan")])
    assert debugging.debug_check(y, "y") is y
    assert "non-finite values in y" in capsys.readouterr().out
    debugging.debug_check(torch.ones(2), "ok")
    assert capsys.readouterr().out == ""
