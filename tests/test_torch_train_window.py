"""The port's windowed train loop, gradient accumulation, async
checkpoints and input-position sidecars, on the CPU, against the port's
own per-epoch loop and against the JAX package (twins of
tests/test_train.py's tests of the same names).

Tolerances: the windowed fit runs the same step body as the per-epoch
loop, so its losses match the loop's to the JAX test's rtol 2e-5 (atol 1e-6) and
its parameters to rtol 1e-4 (atol 1e-5); on the CPU they are in fact
equal. Against the JAX package, fp32 losses agree to 1e-5 relative per
step taken (test_torch_train.py's one-step tolerance, allowed to grow
linearly with the steps, as its multi-step trajectory test does).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector_tpu.models import vit_detector as jax_model
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.train import optimizer as opt
from vision_transformer_detector_tpu_torch.train import trainer
from vision_transformer_detector_tpu_torch.utils import checkpoint as ckpt_lib
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy)

# tests/test_train.py's TINY: 34 px, one block, einsum attention.
TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)
LOSS = LossConfig()
TC = TrainConfig(learning_rate=1e-3)
STEP_RTOL = 1e-5   # one fp32 step, port against JAX


def _batch(batch_size=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w = TINY.image_size
    images = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    labels = np.full((batch_size, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    labels[1, 0] = (1, 40, 10.0, 20.0, 8.0, 12.0)
    return images, labels


def _two_batches():
    images1, labels1 = _batch()
    images2, labels2 = _batch(seed=3)
    labels2[1, 0] = (0,) * 6
    return [(images1, labels1), (images2, labels2)]


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _mask(size: int, keep: float) -> np.ndarray:
    return np.random.default_rng(size).random(size) < keep


@pytest.fixture
def shared_masks(monkeypatch):
    """Both packages' ``_dropout`` draw one numpy mask per tensor size
    (the MLP masks were never JAX's threefry bits; this makes dropout runs
    comparable across the packages)."""

    def jax_dropout(x, rate, rng, train):
        if not train or rate is None or rate == 0.0 or rng is None:
            return x
        keep = 1.0 - rate
        mask = jnp.asarray(_mask(x.size, keep).reshape(x.shape))
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)

    def port_dropout(x, rate, seed, train, *placement):
        if not train or rate is None or rate == 0.0 or seed is None:
            return x
        keep = 1.0 - rate
        mask = torch.from_numpy(_mask(x.numel(), keep).reshape(x.shape))
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    monkeypatch.setattr(jax_model, "_dropout", jax_dropout)
    monkeypatch.setattr(model, "_dropout", port_dropout)


def _port_trainer(config, tmp_path, tag, **kwargs):
    return trainer.Trainer(
        config, LOSS,
        TrainConfig(learning_rate=1e-3, epochs_warm_up=2, skip_epochs=3),
        checkpoint_dir=str(tmp_path / tag),
        metrics_path=str(tmp_path / f"{tag}.jsonl"), device="cpu", **kwargs)


@pytest.mark.parametrize("dropout", [None, 0.25])
def test_fit_windowed_matches_loop(tmp_path, dropout, shared_masks):
    """epochs_per_call=4 against the per-epoch loop (the twin of
    test_fit_scanned_matches_loop): the same per-epoch losses, AP records
    at epochs 2 and 5 of 7, parameters, step count, 7 metrics lines and an
    "ongoing" checkpoint; windows cut at the eval epochs 2, 5 and the
    checkpoint epochs 0, 3, 6. Both match the JAX package's
    _fit_scanned trajectory from the same weights."""
    config = TINY.replace(dropout=dropout) if dropout else TINY
    data = _two_batches()
    eval_data = [data[0]]

    jax_run = jax_trainer.Trainer(
        config, LOSS, TrainConfig(learning_rate=1e-3, epochs_warm_up=2,
                                  skip_epochs=3))
    jax_state = jax_run.init_state()
    start = params_from_numpy(_flat(jax_state["params"]), config)
    jax_run.fit(jax_state, data, epochs=7, eval_data=eval_data,
                epochs_per_call=4)

    def run(epochs_per_call, tag):
        run = _port_trainer(config, tmp_path, tag)
        state = run.init_state()
        state["params"].load_state_dict(start.state_dict())
        state = run.fit(state, data, epochs=7, eval_data=eval_data,
                        epochs_per_call=epochs_per_call)
        run.metrics.close()
        return run, state

    loop, s_loop = run(1, "loop")
    window, s_window = run(4, "window")
    np.testing.assert_allclose(window.loss_record, loop.loss_record,
                               rtol=2e-5, atol=1e-6)
    assert len(window.loss_record) == 7
    assert window.ap_record == pytest.approx(loop.ap_record)
    assert len(window.ap_record) == 2
    assert window.window_record == [(0, 1), (1, 2), (3, 1), (4, 2), (6, 1)]
    assert loop.window_record == []
    for name, value in s_loop["params"].state_dict().items():
        np.testing.assert_allclose(
            s_window["params"].state_dict()[name].numpy(), value.numpy(),
            rtol=1e-4, atol=1e-5, err_msg=name)
    assert s_window["step"] == 7 * len(data)
    assert int(s_window["opt_state"]["count"]) == 7 * len(data)
    assert sum(1 for _ in open(tmp_path / "window.jsonl")) == 7
    assert (tmp_path / "window" / "ongoing.pt").is_file()

    for i, (got, want) in enumerate(zip(window.loss_record,
                                        jax_run.loss_record)):
        steps = (i + 1) * len(data)
        assert got == pytest.approx(want, rel=STEP_RTOL * steps), (
            i, window.loss_record, jax_run.loss_record)


def test_windowed_seed_rows_are_the_loops_draws():
    """With dropout the window draws its seed rows ahead from
    state["dropout_rng"]: the same rows the per-step loop derives, and
    training on them gives the loop's losses exactly (CPU)."""
    config = TINY.replace(dropout=0.1)
    data = _two_batches()
    runs = [trainer.Trainer(config, LOSS, TC, device="cpu")
            for _ in range(2)]
    states = [run.init_state() for run in runs]
    rows = [trainer.draw_seed_row(
        {"dropout_rng": torch.Generator().manual_seed(TC.seed + 1)}, config)
        for _ in range(1)]
    multi = trainer.make_multi_step(config, LOSS, runs[1].optimizer)
    images = torch.stack([torch.from_numpy(b[0]) for b in data])
    labels = torch.stack([torch.from_numpy(b[1]) for b in data])
    states[1], losses = multi(states[1], images, labels, 2)
    assert multi.seed_rows.shape == (4, model.seed_table_size(config))
    assert multi.seed_rows.dtype == np.uint32
    np.testing.assert_array_equal(multi.seed_rows[0], rows[0])
    loop_losses = []
    for _ in range(2):
        for images_i, labels_i in data:
            states[0], loss = runs[0].train_step(
                states[0], torch.from_numpy(images_i),
                torch.from_numpy(labels_i))
            loop_losses.append(float(loss))
    assert losses.tolist() == pytest.approx(
        np.asarray(loop_losses).reshape(2, 2).mean(1).tolist(), rel=1e-6)
    assert states[0]["step"] == states[1]["step"] == 4
    for name, value in states[0]["params"].state_dict().items():
        assert torch.equal(states[1]["params"].state_dict()[name], value)


def test_fit_windowed_rejects_streaming_dataset():
    run = trainer.Trainer(TINY, LOSS, TC, device="cpu")

    def gen():
        yield _batch()

    with pytest.raises(ValueError, match="materialized"):
        run.fit(run.init_state(), gen(), epochs=2, epochs_per_call=2)


def test_fit_windowed_ragged_batches_diagnosed():
    run = trainer.Trainer(TINY, LOSS, TC, device="cpu")
    images, labels = _batch()
    data = [(images, labels), (images[:1], labels[:1])]
    with pytest.raises(ValueError, match="uniform batch shapes"):
        run.fit(run.init_state(), data, epochs=4, epochs_per_call=2)
    with pytest.raises(ValueError, match="empty"):
        run.fit(run.init_state(), [], epochs=1, epochs_per_call=2)


def test_async_checkpointing_roundtrip(tmp_path):
    """Async saves resume exactly: train with async_checkpointing=True,
    save, restore into a fresh state, and every tensor is bit-equal."""
    run = trainer.Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path / "ck"),
                          async_checkpointing=True, device="cpu")
    state = run.init_state()
    run.best_ap = 0.25
    state = run.fit(state, [_batch()], epochs=2)
    run.save(state, name="ongoing")
    run.wait_for_checkpoints()

    again = trainer.Trainer(TINY, LOSS, TC,
                            checkpoint_dir=str(tmp_path / "ck"),
                            async_checkpointing=True, device="cpu")
    fresh = again.init_state(seed=7)
    count = fresh["opt_state"]["count"]
    restored = again.restore(fresh, name="ongoing")
    assert restored["step"] == state["step"] == 2
    assert again.best_ap == pytest.approx(0.25)
    # In place: the optimizer's tensors are the ones the state had.
    assert restored["opt_state"]["count"] is count
    assert int(count) == 2
    for name, value in state["params"].state_dict().items():
        assert torch.equal(restored["params"].state_dict()[name], value)
    for moment in ("mu", "nu"):
        for name, value in state["opt_state"][moment].items():
            assert torch.equal(restored["opt_state"][moment][name], value)


def test_async_save_does_not_block_and_restore_waits(tmp_path, monkeypatch):
    """A write in flight is joined by restore (and by wait), and its
    snapshot is the state at save time, not after later in-place steps."""
    import threading

    gate = threading.Event()
    write = ckpt_lib.write_payload

    def slow_write(path, payload):
        gate.wait(10)
        write(path, payload)

    monkeypatch.setattr(ckpt_lib, "write_payload", slow_write)
    run = trainer.Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path),
                          async_checkpointing=True, device="cpu")
    state = run.init_state()
    images, labels = (torch.from_numpy(a) for a in _batch())
    before = {k: v.clone() for k, v in state["params"].state_dict().items()}
    run.save(state, name="snap")
    assert not (tmp_path / "snap.pt").exists()   # still in flight
    run.train_step(state, images, labels)        # moves the params
    gate.set()
    restored = run.restore(run.init_state(seed=3), name="snap")
    for name, value in before.items():
        assert torch.equal(restored["params"].state_dict()[name], value)
    assert restored["step"] == 0


class _StatefulBatches:
    """Duck-typed ResumableDataset (tests/test_train.py's): synthetic
    batches with get/set_state."""

    def __init__(self, n_batches=3):
        self.n = n_batches
        self.epoch = 0
        self.batch = 0

    def get_state(self):
        return {"epoch": self.epoch, "batch": self.batch, "seed": 0}

    def set_state(self, state):
        self.epoch = int(state["epoch"])
        self.batch = int(state["batch"])

    def __len__(self):
        return self.n

    def __iter__(self):
        if self.batch >= self.n:
            self.epoch += 1
            self.batch = 0
        while self.batch < self.n:
            self.batch += 1
            yield _batch()
        self.epoch += 1
        self.batch = 0


def test_dataset_state_persists_with_checkpoint(tmp_path):
    """The stream position (as of the batch consumed, not the one
    prefetched) is saved beside the checkpoint and restore() reads it."""
    tc = dataclasses.replace(TC, skip_epochs=1, epochs_warm_up=0)
    run = trainer.Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path),
                          device="cpu")
    run.fit(run.init_state(), _StatefulBatches(n_batches=3), epochs=1)
    saved = json.loads((tmp_path / "ongoing.dataset.json").read_text())
    assert saved == {"epoch": 0, "batch": 3, "seed": 0}
    fresh = trainer.Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path),
                            device="cpu")
    assert fresh.dataset_resume_state is None
    fresh.restore(fresh.init_state(seed=9), name="ongoing")
    assert fresh.dataset_resume_state == saved


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_dataset_sidecar_gc_and_staleness(tmp_path, async_ckpt):
    """Rolling GC removes pruned checkpoints' sidecars; a save with no
    dataset state clears a stale same-name sidecar; the same with async
    checkpointing."""
    run = trainer.Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path),
                          keep_checkpoints=2, async_checkpointing=async_ckpt,
                          device="cpu")
    state = run.init_state()
    for step in (3, 7, 11):
        state["step"] = step
        run.dataset_resume_state = {"epoch": 0, "batch": step, "seed": 0}
        run.save_rolling(state)
        run.wait_for_checkpoints()
    names = {p.name for p in tmp_path.iterdir()}
    kept = {ckpt_lib.step_checkpoint_name(s) for s in (7, 11)}
    assert {n + ".pt" for n in kept} <= names
    assert {n + ".dataset.json" for n in kept} <= names
    doomed = ckpt_lib.step_checkpoint_name(3)
    assert doomed + ".pt" not in names
    assert doomed + ".dataset.json" not in names

    run.save(state, name="ongoing")
    run.wait_for_checkpoints()
    assert (tmp_path / "ongoing.dataset.json").exists()
    run.dataset_resume_state = None
    run.save(state, name="ongoing")
    assert not (tmp_path / "ongoing.dataset.json").exists()


def test_prune_counts_a_pending_write(tmp_path):
    """pending_step (an async write not yet renamed into place) holds one
    of the keep slots, as in the JAX package."""
    for step in (1, 2, 3):
        (tmp_path / (ckpt_lib.step_checkpoint_name(step) + ".pt")).write_bytes(
            b"x")
    removed = ckpt_lib.prune_checkpoints(str(tmp_path), 2, pending_step=4)
    assert [p.split("/")[-1] for p in removed] == [
        "step_0000000001.pt", "step_0000000002.pt"]
    assert [s for s, _ in ckpt_lib.list_step_checkpoints(str(tmp_path))] \
        == [3]


def test_restore_latest_skips_a_torn_write(tmp_path):
    run = trainer.Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path),
                          keep_checkpoints=3, device="cpu")
    state = run.init_state()
    for step in (2, 4):
        state["step"] = step
        run.save_rolling(state)
    (tmp_path / "step_0000000004.pt").write_bytes(b"torn")
    (tmp_path / "step_0000000006.pt.tmp-1-2").write_bytes(b"partial")
    assert run.restore_latest(run.init_state())["step"] == 2


def _jax_state(config, train_config):
    optimizer = jax_opt.make_optimizer(train_config)
    params = jax_model.init_params(jax.random.PRNGKey(0), config)
    return optimizer, {"params": params, "opt_state": optimizer.init(params),
                       "step": jnp.zeros((), jnp.int32)}


def _grad_batches():
    """Four images with one positive each (the loss's means over
    positives then decompose over micro batches)."""
    rng = np.random.default_rng(0)
    h, w = TINY.image_size
    images = rng.uniform(-1, 1, (4, h, w, 3)).astype(np.float32)
    labels = np.full((4, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for i in range(4):
        labels[i, 0] = (1, 5 + i, 17.0, 17.0, 10.0, 10.0)
    return images, labels


def test_gradient_accumulation():
    """accumulate_steps=2 (optax.MultiSteps): the first micro step leaves
    the parameters as they were, the second applies one update, and that
    update equals the JAX package's from the same weights and batches
    (test_torch_train.py's one-step parameter tolerance: 1e-6 except the
    few elements whose gradient is within rounding of zero, where Adam's
    first step may go either way, by at most 2 * lr)."""
    train_config = TrainConfig(learning_rate=1e-3, accumulate_steps=2)
    images, labels = _grad_batches()
    optimizer, jax_state = _jax_state(TINY, train_config)
    jax_step = jax_trainer.make_train_step(TINY, LOSS, optimizer,
                                           donate=False)
    port_opt = opt.Adam(train_config)
    port_model = params_from_numpy(_flat(jax_state["params"]), TINY)
    state = {"params": port_model,
             "opt_state": port_opt.init(dict(port_model.named_parameters())),
             "step": 0}
    step = trainer.make_train_step(TINY, LOSS, port_opt)
    before = {k: v.clone() for k, v in port_model.state_dict().items()}
    for i, half in enumerate((slice(0, 2), slice(2, 4))):
        jax_state, jax_loss = jax_step(
            jax_state, jnp.asarray(images[half]), jnp.asarray(labels[half]),
            jax.random.PRNGKey(1))
        state, loss = step(state, torch.from_numpy(images[half]),
                           torch.from_numpy(labels[half]))
        assert float(loss) == pytest.approx(float(jax_loss), rel=STEP_RTOL)
        if i == 0:
            for name, value in before.items():
                assert torch.equal(port_model.state_dict()[name], value)
            assert int(state["opt_state"]["count"]) == 0
            assert int(state["opt_state"]["mini_step"]) == 1
    assert state["step"] == 2 and int(state["opt_state"]["count"]) == 1
    assert int(state["opt_state"]["mini_step"]) == 0
    assert all(not a.any() for a in state["opt_state"]["acc"].values())
    expected = _flat(jax_state["params"])
    got = params_to_numpy(port_model)
    moved = 0
    for name, want in expected.items():
        diff = np.abs(got[name] - want)
        assert diff.max() <= 2 * train_config.learning_rate + 1e-6, name
        if not name.endswith("mha/key/bias"):
            assert np.mean(diff > 1e-6) <= 0.01, name
        moved += int(not np.array_equal(got[name],
                                        before[name.replace("/", ".")]
                                        .numpy()))
    assert moved > 0


@pytest.mark.parametrize("every_k", [2, 3])
def test_accumulation_windowed_matches_the_loop(every_k):
    """The windowed loop replays the micro and update steps in the
    pattern the loop takes (CPU: the same step body, equal results)."""
    train_config = TrainConfig(learning_rate=1e-3, accumulate_steps=every_k)
    images, labels = _grad_batches()
    data = [(images[:2], labels[:2]), (images[2:], labels[2:])]
    runs = [trainer.Trainer(TINY, LOSS, train_config, device="cpu")
            for _ in range(2)]
    states = [run.init_state() for run in runs]
    states[0] = runs[0].fit(states[0], data, epochs=3)
    states[1] = runs[1].fit(states[1], data, epochs=3, epochs_per_call=3)
    assert runs[0].loss_record == pytest.approx(runs[1].loss_record,
                                                rel=1e-6)
    for name, value in states[0]["params"].state_dict().items():
        assert torch.equal(states[1]["params"].state_dict()[name], value)
    assert int(states[1]["opt_state"]["count"]) == 6 // every_k


def test_lr_schedule_accumulation_counts_optimizer_steps():
    """With accumulate_steps=k the schedule counts optimizer steps:
    boundaries at epochs * steps_per_epoch // k, as the JAX package's;
    Adam's device learning rate gives the same fp32 values."""
    tc = TrainConfig(learning_rate=1e-3, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=20, epochs_third_lr_decay=30,
                     rate_lr_decay=0.1, accumulate_steps=4)
    schedule = opt.make_lr_schedule(tc, steps_per_epoch=100, every_k=4)
    ref = jax_opt.make_lr_schedule(tc, steps_per_epoch=100, every_k=4)
    adam = opt.Adam(tc, steps_per_epoch=100)
    for count in (0, 249, 250, 251, 749, 750, 1499, 1500, 4000):
        assert schedule(count) == float(np.float32(ref(count))), count
        assert adam.learning_rate(torch.tensor(count)).item() == \
            schedule(count), count
    assert schedule(10 * 25 - 1) == pytest.approx(1e-3)
    assert schedule(10 * 25) == pytest.approx(1e-4)
    assert schedule(30 * 25) == pytest.approx(1e-5)
