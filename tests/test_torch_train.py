"""The port's train step and Trainer vs the JAX package, on the CPU.

One train step of each side starts from the same weights (JAX params ->
``params_from_numpy``) on the same seeded numpy batch, with the flash
route (the JAX Pallas forward in interpret mode and its chunked backward;
the port's autograd Function over the plain versions) and the matmul
route. fp32: the loss to 1e-5 relative; the parameters after the step to
1e-6 absolute, except for the few elements whose gradient is within
rounding of zero, where Adam's first step (about lr * sign(g)) may go
either way: at most 1 % of a tensor, by at most 2 * lr. The attention key
bias is all such elements (a shift of every score of a query row, which
the softmax cancels), so only the 2 * lr bound holds for it.

The Trainer smoke run checks the reference cadence, the checkpoints
(best-AP, ongoing, rolling keep-last-k), ``restore_latest`` and the
refused options.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector_tpu.data.pipeline import synthetic_batches
from vision_transformer_detector_tpu.metrics.mean_average_precision import (
    MeanAveragePrecision)
from vision_transformer_detector_tpu.models.vit_detector import (
    init_params as jax_init_params)
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.train import trainer
from vision_transformer_detector_tpu_torch.train.optimizer import Adam
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy)

# The 68 px, 2-block shape of the verify recipe, with the reference's
# key_dim 40 (padded on the flash kernel routes) and 16 tokens.
SMALL = DetectorConfig(image_size=(68, 68), embedding_dim=16, num_heads=2,
                       key_dim=40, encoder_blocks=2, encoder_mlp_layers=3,
                       head_last_units=16, head_layers=2)
TRAIN = TrainConfig(learning_rate=1e-3)
LR = TRAIN.learning_rate


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _batch(config, seed=0, batch=2):
    return next(synthetic_batches(config, batch, 1, seed=seed))


@pytest.mark.parametrize("flash", [True, False])
def test_train_step_matches_jax(flash):
    config = SMALL.replace(train_use_flash_attention=flash)
    images, labels = _batch(config)
    jax_params = jax_init_params(jax.random.PRNGKey(0), config)
    optimizer = jax_opt.make_optimizer(TRAIN)
    step = jax_trainer.make_train_step(config, LossConfig(), optimizer,
                                       donate=False)
    jax_state = {"params": jax_params,
                 "opt_state": optimizer.init(jax_params),
                 "step": jnp.zeros((), jnp.int32)}
    jax_state, jax_loss = step(jax_state, jnp.asarray(images),
                               jnp.asarray(labels), jax.random.PRNGKey(1))

    port_opt = Adam(TRAIN)
    model = params_from_numpy(_flat(jax_params), config)
    state = {"params": model,
             "opt_state": port_opt.init(dict(model.named_parameters())),
             "step": 0}
    before = fa.flash_attention.launches
    state, loss = trainer.make_train_step(config, LossConfig(), port_opt)(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    assert fa.flash_attention.launches == before   # CPU: no kernel
    assert state["step"] == 1
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)

    expected = _flat(jax_state["params"])
    got = params_to_numpy(model)
    assert set(got) == set(expected)
    for name, want in expected.items():
        diff = np.abs(got[name] - want)
        assert diff.max() <= 2 * LR + 1e-6, name
        if not name.endswith("mha/key/bias"):
            assert np.mean(diff > 1e-6) <= 0.01, name


def test_train_step_gradients_flow_through_flash_attention():
    """With the flash route every q/k/v projection gets a gradient (the
    fault this slice fixed on the kernel route: the CUDA forward returned
    a tensor with no grad_fn, so these grads were silently missing)."""
    config = SMALL.replace(train_use_flash_attention=True)
    images, labels = _batch(config, seed=1)
    model = trainer.init_params(config, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    logits = trainer.forward(model, torch.from_numpy(images),
                             trainer.train_config_view(config), train=False)
    loss = trainer.detection_loss(torch.from_numpy(labels), logits, config,
                                  LossConfig())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for block in range(config.encoder_blocks):
        for proj in ("query", "key", "value"):
            g = grads[f"encoder.{block}.mha.{proj}.kernel"]
            assert torch.isfinite(g).all() and g.abs().max() > 0


def test_maybe_normalize_uint8():
    pixels = torch.tensor([0, 127, 255], dtype=torch.uint8)
    np.testing.assert_allclose(trainer._maybe_normalize(pixels).numpy(),
                               [-1.0, 127 / 127.5 - 1.0, 1.0], atol=1e-7)
    floats = torch.zeros(3)
    assert trainer._maybe_normalize(floats) is floats


def test_eval_and_predict_steps_and_padded_rows():
    config = SMALL
    images, labels = _batch(config, seed=2, batch=3)
    model = trainer.init_params(config, torch.Generator().manual_seed(1))
    logits = trainer.make_predict_step(config)(model, torch.from_numpy(images))
    decoded = trainer.make_eval_step(config)(model, torch.from_numpy(images))
    assert logits.shape == decoded.shape == (3, config.max_objects, 6)
    np.testing.assert_array_equal(
        decoded.numpy(),
        trainer.transform_predictions(logits, config).numpy())
    zeroed = trainer.zero_padded_rows(decoded, torch.tensor([True, False,
                                                             True]))
    assert not zeroed[1].any() and torch.equal(zeroed[0], decoded[0])
    # A padded row is a metric no-op.
    plain = trainer.evaluate_map(model, [(images[:1], labels[:1])], config)
    padded = trainer.evaluate_map(
        model, [(images[:2], labels[:2], np.array([True, False]))], config)
    assert padded == pytest.approx(plain, abs=1e-7)
    # The NumPy oracle (Trainer(fast_metric=False)) gives the same AP.
    oracle = MeanAveragePrecision(config)
    assert trainer.evaluate_map(model, [(images, labels)], config,
                                metric=oracle) == pytest.approx(
        trainer.evaluate_map(model, [(images, labels)], config), abs=1e-5)


def _trainer(tmp_path, **kwargs):
    train_config = TrainConfig(learning_rate=1e-3, epochs_warm_up=1,
                               skip_epochs=2)
    return trainer.Trainer(SMALL, LossConfig(), train_config,
                           checkpoint_dir=str(tmp_path / "ckpt"),
                           metrics_path=str(tmp_path / "metrics.jsonl"),
                           device="cpu", **kwargs)


def test_fit_cadence_checkpoints_and_restore_latest(tmp_path):
    data = list(synthetic_batches(SMALL, 2, 2, seed=3))
    run = _trainer(tmp_path, keep_checkpoints=2, check_weights_every=2)
    state = run.init_state()
    state = run.fit(state, data, epochs=6, eval_data=data[:1])
    assert state["step"] == 12
    run.metrics.close()
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == list(range(6))
    # Warm-up 1, then every 2: eval at epochs 1, 3, 5.
    assert [r["epoch"] for r in records if "ap" in r] == [1, 3, 5]
    assert all(0.0 <= r["ap"] <= 1.0 for r in records if "ap" in r)
    assert [r["epoch"] for r in records if "max_weight" in r] == [0, 2, 4]
    assert all(np.isfinite(r["loss"]) for r in records)
    names = sorted(os.listdir(tmp_path / "ckpt"))
    # Periodic saves at epochs 0, 2, 4 and the final epoch 5 (steps 2, 6,
    # 10, 12); the rolling history keeps the newest two.
    assert "ongoing.pt" in names and "config.json" in names
    assert [n for n in names if n.startswith("step_")] == [
        "step_0000000010.pt", "step_0000000012.pt"]

    again = _trainer(tmp_path)
    fresh = again.init_state(seed=5)
    restored = again.restore_latest(fresh)
    assert restored["step"] == 12 and again.best_ap == run.best_ap
    for name, value in state["params"].state_dict().items():
        assert torch.equal(restored["params"].state_dict()[name], value)
    assert restored["opt_state"]["count"] == 12
    assert restored["opt_state"]["order"] == state["opt_state"]["order"]
    for moment in ("mu", "nu"):
        for name, value in state["opt_state"][moment].items():
            assert torch.equal(restored["opt_state"][moment][name], value)
    # One more step from each side lands on the same parameters (the CPU
    # step is deterministic), so nothing the update reads was lost.
    images, labels = (torch.from_numpy(a) for a in data[0])
    run.train_step(state, images, labels)
    again.train_step(restored, images, labels)
    for name, value in state["params"].state_dict().items():
        assert torch.equal(restored["params"].state_dict()[name], value)

    # A corrupt newest checkpoint falls back to the next one.
    (tmp_path / "ckpt" / "step_0000000012.pt").write_bytes(b"partial")
    assert again.restore_latest(again.init_state())["step"] == 10


def test_restore_explains_a_config_mismatch(tmp_path):
    run = _trainer(tmp_path)
    run.save(run.init_state(), name="ongoing")
    other = trainer.Trainer(SMALL.replace(embedding_dim=8), LossConfig(),
                            run.train_config,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            device="cpu")
    with pytest.raises(ValueError, match="embedding_dim"):
        other.restore(other.init_state())


class _ModelAxisMesh:
    """The shape of a (1, 2) mesh, all that the mesh check reads."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 2)[dim]


def test_refused_options(tmp_path):
    """A model axis above 1 without ring_attention is refused (tensor
    parallelism is not ported; data parallelism and ring attention are,
    tests/test_torch_parallel.py); async checkpointing, gradient
    accumulation and epochs_per_call > 1 are ported and have tests of
    their own (test_torch_train_window.py)."""
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        _trainer(tmp_path, mesh=_ModelAxisMesh())
    run = _trainer(tmp_path)
    data = list(synthetic_batches(SMALL, 2, 1))
    # Training dropout is ported: a dropout fit runs and moves the
    # parameters.
    dropout = trainer.Trainer(SMALL.replace(dropout=0.1), device="cpu")
    state = dropout.init_state()
    before = state["params"].head_output.kernel.detach().clone()
    state = dropout.fit(state, data, epochs=1)
    assert state["step"] == 1 and np.isfinite(dropout.loss_record[0])
    assert not torch.equal(state["params"].head_output.kernel, before)
    with pytest.raises(ValueError, match="empty"):
        run.fit(run.init_state(), [], epochs=1)


def test_fit_streams_a_dataset_object(tmp_path):
    """A re-iterable dataset (not a list) is moved batch by batch."""

    class Stream:
        def __iter__(self):
            return synthetic_batches(SMALL, 2, 2, seed=4)

    run = _trainer(tmp_path)
    state = run.fit(run.init_state(), Stream(), epochs=2)
    assert state["step"] == 4 and len(run.loss_record) == 2
    assert run.fit(state, iter(()), epochs=0) is state
    with pytest.raises(ValueError, match="no batches"):
        run.fit(state, iter(()), epochs=1)


def test_dataclass_configs_round_trip_in_checkpoints(tmp_path):
    run = _trainer(tmp_path)
    run.save(run.init_state(), name="final")
    payload = torch.load(tmp_path / "ckpt" / "final.pt", weights_only=True)
    assert payload["config"]["detector"] == dataclasses.asdict(SMALL)
    assert payload["step"] == 0 and payload["best_ap"] == 0.0


DROPOUT = SMALL.replace(dropout=0.1, attention_window=2, head_scales=(1, 2),
                        remat_encoder=True, train_use_flash_attention=True)


def _dropout_run(tmp_path, seed, epochs, name="run"):
    run = trainer.Trainer(
        DROPOUT, LossConfig(), TrainConfig(learning_rate=1e-3, seed=seed,
                                           skip_epochs=0),
        checkpoint_dir=str(tmp_path / name), device="cpu")
    data = list(synthetic_batches(DROPOUT, 2, 1, seed=3))
    state = run.fit(run.init_state(seed=0), data, epochs=epochs)
    return run, state, data


def test_dropout_training_is_seeded_and_falls(tmp_path):
    """Training with dropout (windowed, multi-scale, full remat, flash
    route): the same TrainConfig seed gives the same losses, another seed
    (the same weights, another dropout seed chain) other losses, and the
    loss falls over a few steps on one batch."""
    run_a, _, _ = _dropout_run(tmp_path, seed=0, epochs=6)
    run_b, _, _ = _dropout_run(tmp_path, seed=0, epochs=6)
    run_c, _, _ = _dropout_run(tmp_path, seed=1, epochs=6)
    assert run_a.loss_record == run_b.loss_record
    assert run_a.loss_record != run_c.loss_record
    assert run_a.loss_record[-1] < run_a.loss_record[0]


def test_dropout_restore_draws_the_same_masks(tmp_path):
    """The dropout seed generator is saved with the train state: a save ->
    restore -> step gives the loss of the step the uninterrupted run took
    after the save, and the step after that draws another seed."""
    run, state, data = _dropout_run(tmp_path, seed=0, epochs=2)
    images, labels = (torch.from_numpy(a) for a in data[0])
    run.save(state, name="mid")
    _, loss_a = run.train_step(state, images, labels)
    _, loss_next = run.train_step(state, images, labels)
    state = run.restore(state, name="mid")
    _, loss_b = run.train_step(state, images, labels)
    assert loss_b.item() == loss_a.item()
    fresh = trainer.Trainer(DROPOUT, LossConfig(), run.train_config,
                            checkpoint_dir=run.checkpoint_dir, device="cpu")
    restored = fresh.restore(fresh.init_state(seed=5), name="mid")
    _, loss_c = fresh.train_step(restored, images, labels)
    assert loss_c.item() == loss_a.item() != loss_next.item()


# A narrow member of the highres_1024 family: windowed attention (2 x 2
# windows on a 4 x 4 grid, heads-major at key_dim 64), the (1, 2, 4)
# multi-scale head, flash attention, no dropout.
HIGHRES_SMALL = DetectorConfig(
    image_size=(64, 64), patch_size=16, embedding_dim=32, num_heads=2,
    key_dim=64, encoder_blocks=2, encoder_mlp_layers=2, head_last_units=16,
    head_layers=2, use_flash_attention=True, attention_window=2,
    head_scales=(1, 2, 4))
MULTI_STEPS = 6
# One step's loss tolerance (fp32: test_train_step_matches_jax's 1e-5; bf16:
# one bf16 rounding, 2^-7, the frameworks rounding a matmul's bias add at
# different points), allowed to grow linearly with the steps taken: after
# step i the weights differ by at most what i such steps moved them apart.
# Measured over 12 steps: fp32 within 2.5e-6 at every step, bf16 3.4e-3
# after one step and at most 2.6e-2 (step 6); the loss falls from 154 to 21
# in both packages.
MULTI_STEP_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_highres_family_loss_trajectory_matches_jax_over_steps(dtype):
    """Six train steps at the preset's learning rate, 8e-5, from the same
    weights on the same batch: the two packages' loss trajectories stay
    together, so a fault that only shows after several steps (optimizer
    state, weight update, step count) would show here, where one step
    matches. Whether the loss falls at this rate is the preset's business:
    both packages must do the same."""
    config = HIGHRES_SMALL.replace(compute_dtype=dtype)
    train = TrainConfig(learning_rate=8e-5)
    images, labels = _batch(config, seed=3)
    jax_params = jax_init_params(jax.random.PRNGKey(0), config)
    optimizer = jax_opt.make_optimizer(train)
    step = jax_trainer.make_train_step(config, LossConfig(), optimizer,
                                       donate=False)
    jax_state = {"params": jax_params,
                 "opt_state": optimizer.init(jax_params),
                 "step": jnp.zeros((), jnp.int32)}
    port_opt = Adam(train)
    model = params_from_numpy(_flat(jax_params), config)
    state = {"params": model,
             "opt_state": port_opt.init(dict(model.named_parameters())),
             "step": 0}
    port_step = trainer.make_train_step(config, LossConfig(), port_opt)

    jax_losses, losses = [], []
    for i in range(MULTI_STEPS):
        jax_state, jax_loss = step(jax_state, jnp.asarray(images),
                                   jnp.asarray(labels),
                                   jax.random.PRNGKey(10 + i))
        state, loss = port_step(state, torch.from_numpy(images),
                                torch.from_numpy(labels))
        jax_losses.append(float(jax_loss))
        losses.append(float(loss))
    assert state["step"] == MULTI_STEPS == int(jax_state["step"])
    assert np.all(np.isfinite(losses))
    for i, (got, want) in enumerate(zip(losses, jax_losses)):
        assert got == pytest.approx(
            want, rel=MULTI_STEP_TOL[dtype] * (i + 1)), (i, losses,
                                                         jax_losses)
    # The trajectories move (the steps are not no-ops) and move alike.
    assert losses[0] != losses[-1]
    assert (losses[-1] < losses[0]) == (jax_losses[-1] < jax_losses[0])
