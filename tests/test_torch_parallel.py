"""Data parallelism and ring attention of the port across processes, on
the CPU, against the JAX package.

The port's ranks are real processes in gloo groups
(tests/torch_parallel_worker.py, which imports no JAX); the JAX side runs
here, in the test process, on the 8-device virtual CPU mesh of
tests/conftest.py. Two groups run per module: four ranks for the ring
cases and two for the data-parallel ones, plus a second pair of two that
resumes the first pair's checkpoint. Each worker spawn has a time limit,
and a gloo rendezvous timeout is retried once.

Tolerances, fp32 throughout:
  * ring attention against JAX's ring (with dropout also against JAX's
    flash attention with dropout), outputs and gradients: 2e-5 absolute
    and relative, JAX's own ring tolerance;
  * DP train steps against JAX's single-device steps on the same
    weights and the same global batch: the loss to 1e-5 relative at each
    step (the ranks hold different numbers of positives, which a per-rank
    loss average would get wrong);
  * DP with dropout against one process on the global batch: losses to
    1e-5 relative, parameters within Adam's step of rounding (2 * lr);
  * evaluation AP against JAX's metric on the same images in the same
    order: 1e-3;
  * the ring model's every parameter gradient against the plain model's:
    1e-5 of the tensor's largest magnitude (fp32 sums in another order);
    a resumed run: the loss it would have had.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig, get_config, save_configs)
from vision_transformer_detector_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from vision_transformer_detector_tpu.kernels.ring_attention import (
    ring_attention as jax_ring_attention, ring_attention_in_jit)
from vision_transformer_detector_tpu.metrics.fast_map import (
    JitMeanAveragePrecision)
from vision_transformer_detector_tpu.models.vit_detector import (
    forward as jax_forward, init_params as jax_init_params)
from vision_transformer_detector_tpu.ops.decode import transform_predictions
from vision_transformer_detector_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh)
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch.kernels import ring_attention
from vision_transformer_detector_tpu_torch.parallel import data as pdata
from vision_transformer_detector_tpu_torch.parallel import mesh as pmesh

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_parallel_worker as worker  # noqa: E402

SMALL = DetectorConfig(image_size=(68, 68), embedding_dim=16, num_heads=2,
                       key_dim=8, encoder_blocks=2, encoder_mlp_layers=3,
                       head_last_units=16, head_layers=2)
TRAIN = TrainConfig(learning_rate=1e-3)
RING_MODEL = DetectorConfig(
    image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
    key_dim=8, encoder_blocks=2, encoder_mlp_layers=2, head_last_units=16,
    head_layers=1, ring_attention=True, use_flash_attention=True,
    dropout=0.1, remat_encoder=True)
RING_CASES = ("ring1", "ring2", "ring4", "ring2_dropout", "ring4_dropout")
DP_CASES = ("dp_train", "dp_dropout", "dp_eval", "dp_eval_empty",
            "ring_model", "resume_first", "cli_ring")
# highres_1024_ring as JAX's test_highres_ring_preset_trains_on_mesh
# narrows it: ring attention, remat and the multi-scale head.
CLI_RING = dict(image_size=(64, 64), embedding_dim=8, num_heads=2,
                key_dim=4, encoder_blocks=2, head_last_units=8,
                head_layers=2, compute_dtype="float32", head_scales=(1, 2))
# gloo's rendezvous has a fixed deadline; a loaded host can miss it.
_GLOO_FLAKE = "Gloo context initialization failed"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(world, outdir, cases, attempts=2, timeout=240):
    """Run ``cases`` in a gloo group of ``world`` worker processes; fail
    with the logs of a worker that fails or outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for attempt in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_parallel_worker.py"),
             str(rank), str(world), str(port), str(outdir), *cases],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                pytest.fail(f"a worker of {cases} outlived {timeout} s")
        if all(p.returncode == 0 for p in procs):
            return
        if attempt + 1 < attempts and any(_GLOO_FLAKE in log
                                          for log in logs):
            continue
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _dp_batch():
    """Batch 4 of SMALL's images; the shards of two ranks (rows 0-1 and
    2-3) hold 3 and 1 positives."""
    rng = np.random.default_rng(3)
    h, w = SMALL.image_size
    images = rng.uniform(-1, 1, (4, h, w, 3)).astype(np.float32)
    labels = np.full((4, SMALL.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for row, slot, box in ((0, 0, (1, 3, 30.0, 30.0, 20.0, 18.0)),
                           (0, 1, (1, 7, 50.0, 20.0, 12.0, 14.0)),
                           (1, 0, (1, 1, 20.0, 40.0, 16.0, 22.0)),
                           (2, 0, (1, 5, 34.0, 34.0, 30.0, 24.0))):
        labels[row, slot] = box
    return images, labels


def _eval_batch(params):
    """5 images whose labels are the JAX model's own decoded detections
    (its two most confident slots, boxes scaled by 0.8-1.2), so that the
    AP is neither 0 nor 1 and depends on every row."""
    rng = np.random.default_rng(4)
    h, w = SMALL.image_size
    images = rng.uniform(-1, 1, (5, h, w, 3)).astype(np.float32)
    decoded = np.asarray(transform_predictions(
        jax_forward(params, jnp.asarray(images), SMALL), SMALL))
    labels = np.full((5, SMALL.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for row in range(5):
        for slot in np.argsort(-decoded[row, :, 0])[:2]:
            cx, cy, bh, bw = decoded[row, slot, 2:]
            scale = rng.uniform(0.8, 1.2)
            labels[row, slot] = (1, np.round(decoded[row, slot, 1]), cx, cy,
                                 bh * scale, bw * scale)
    return images, labels


def _write_jpegs(root):
    """4 JPEGs with one box each and their annotations."""
    from PIL import Image, ImageDraw

    (root / "images").mkdir(parents=True)
    annotations = {}
    for i in range(4):
        img = Image.new("RGB", (96, 80), (20, 30, 40))
        ImageDraw.Draw(img).rectangle((10 + 5 * i, 12, 40 + 5 * i, 40),
                                      fill=(250, 220, 30))
        img.save(root / "images" / f"{i:012d}.jpg")
        annotations[str(i)] = [[1, 25.0 + 5 * i, 26.0, 28.0, 30.0, 840.0]]
    (root / "ann.json").write_text(json.dumps(annotations))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the inputs, runs both groups, and returns the output
    directory and the JAX params the DP cases start from."""
    outdir = tmp_path_factory.mktemp("parallel")
    params = jax_init_params(jax.random.PRNGKey(0), SMALL)
    save_params_npz(str(outdir / "dp_train.npz"), params)
    save_configs(str(outdir / "dp_train.json"), SMALL, LossConfig(), TRAIN)
    save_configs(str(outdir / "dp_dropout.json"),
                 SMALL.replace(dropout=0.1, use_flash_attention=True),
                 LossConfig(), TRAIN)
    save_configs(str(outdir / "ring_model.json"), RING_MODEL, LossConfig(),
                 TRAIN)
    save_params_npz(str(outdir / "ring_model.npz"),
                    jax_init_params(jax.random.PRNGKey(2), RING_MODEL))
    images, labels = _dp_batch()
    np.savez(outdir / "dp_train_batch.npz", images=images, labels=labels)
    # The DP batch's labels, in RING_MODEL's 64 px frame.
    np.savez(outdir / "ring_model_batch.npz",
             images=np.random.default_rng(5).uniform(
                 -1, 1, (2, 64, 64, 3)).astype(np.float32),
             labels=labels[:2])
    eval_images, eval_labels = _eval_batch(params)
    np.savez(outdir / "dp_eval_batch.npz", images=eval_images,
             labels=eval_labels)
    save_configs(str(outdir / "cli_ring.json"),
                 get_config("highres_1024_ring").replace(**CLI_RING),
                 LossConfig(), TRAIN)
    _write_jpegs(outdir / "cli_data")
    _run_group(4, outdir, RING_CASES)
    _run_group(2, outdir, DP_CASES)
    _run_group(2, outdir, ("resume_second",))
    return outdir, params


def _load(outdir, case, rank):
    return np.load(outdir / f"{case}-{rank}.npz")


def _assemble(outdir, case, world=4):
    """The global (B, N, H, K) arrays from the ranks' shards."""
    got = {name: np.zeros(worker.RING_SHAPE, np.float32)
           for name in ("out", "dq", "dk", "dv")}
    for rank in range(world):
        shard = _load(outdir, case, rank)
        d, m, b, n = (int(shard[k]) for k in ("d", "m", "b", "n"))
        for name in got:
            got[name][d * b:(d + 1) * b, m * n:(m + 1) * n] = shard[name]
    return got


def _jax_ring(ring, dropout):
    """JAX's ring attention over a (8 / ring, ring) mesh and its grads."""
    q, k, v, g = (jnp.asarray(t) for t in worker.ring_inputs())
    mesh = jax_create_mesh(data=8 // ring, model=ring)
    if dropout:
        rate, seed = worker.RING_DROPOUT

        def fn(q, k, v):
            return ring_attention_in_jit(q, k, v, mesh, dropout_rate=rate,
                                         dropout_seed=jnp.uint32(seed))
        with mesh:
            out, vjp = jax.vjp(jax.jit(fn), q, k, v)
            grads = vjp(g)
    else:
        out, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(q, k, v, mesh),
                           q, k, v)
        grads = vjp(g)
    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(t) for t in (out, *grads))))


@pytest.mark.parametrize("ring", [1, 2, 4])
def test_ring_matches_jax_ring(runs, ring):
    """The ring's output and q/k/v gradients at R = 1, 2, 4 over a (4 /
    R, R) mesh (R = 2: the batch sharded over a 2 x 2 mesh) equal JAX's
    ring attention."""
    outdir, _ = runs
    got, want = _assemble(outdir, f"ring{ring}"), _jax_ring(ring, False)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("ring", [2, 4])
def test_ring_dropout_matches_jax(runs, ring):
    """With dropout 0.3 and seed 4242 the masks are keyed on global
    coordinates: the port's ring equals JAX's ring with dropout (outputs
    and gradients) and JAX's flash attention with dropout over the whole
    sequence and batch."""
    outdir, _ = runs
    got = _assemble(outdir, f"ring{ring}_dropout")
    want = _jax_ring(ring, True)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   rtol=2e-5, err_msg=name)
    q, k, v, _ = (jnp.asarray(t) for t in worker.ring_inputs())
    rate, seed = worker.RING_DROPOUT
    flash = np.asarray(jax_flash_attention(q, k, v, dropout_rate=rate,
                                           dropout_seed=jnp.uint32(seed)))
    np.testing.assert_allclose(got["out"], flash, atol=3e-5, rtol=3e-5)


def test_ring_rejects_indivisible_tokens():
    """JAX's message for a token axis the ring does not divide."""

    class Ring4:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (2, 4)[dim]

    with pytest.raises(ValueError, match="token axis 30 must divide ring "
                                         "size 4"):
        ring_attention.check_ring_tokens(30, Ring4())


def test_dp_train_steps_match_jax_single_device(runs):
    """Two ranks, batch 4 (2 + 2, with 3 and 1 positives): each step's
    global loss equals JAX's single-device step on the global batch."""
    outdir, params = runs
    images, labels = _dp_batch()
    optimizer = jax_opt.make_optimizer(TRAIN)
    step = jax_trainer.make_train_step(SMALL, LossConfig(), optimizer,
                                       donate=False)
    state = {"params": params, "opt_state": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    want = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels),
                           jax.random.PRNGKey(1))
        want.append(float(loss))
    for rank in range(2):
        got = _load(outdir, "dp_train", rank)
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        expected = _flat(state["params"])
        for name, value in expected.items():
            # Adam's first steps move elements whose gradient is within
            # rounding of zero by up to lr either way.
            assert np.abs(got[name] - value).max() <= 6 * TRAIN.learning_rate
    np.testing.assert_array_equal(_load(outdir, "dp_train", 0)["losses"],
                                  _load(outdir, "dp_train", 1)["losses"])


def test_dp_loss_needs_the_global_positive_count():
    """The batch of the DP test is one where the naive loss (the mean of
    the ranks' own losses) differs from the global batch's loss, so the
    DP test above would catch it."""
    from vision_transformer_detector_tpu.ops.loss import detection_loss

    images, labels = _dp_batch()
    params = jax_init_params(jax.random.PRNGKey(0), SMALL)
    logits = jax_forward(params, jnp.asarray(images), SMALL)
    whole = float(detection_loss(jnp.asarray(labels), logits, SMALL))
    naive = np.mean([float(detection_loss(jnp.asarray(labels[i:i + 2]),
                                          logits[i:i + 2], SMALL))
                     for i in (0, 2)])
    assert abs(naive - whole) > 1e-3 * abs(whole)


def test_dp_dropout_matches_one_process(runs):
    """Dropout (flash attention and the MLP/head masks) keyed on global
    rows: two ranks train as one process does on the global batch."""
    outdir, _ = runs
    got = _load(outdir, "dp_dropout", 0)
    np.testing.assert_allclose(got["losses"], got["single_losses"],
                               rtol=1e-5)
    assert float(got["max_param_diff"]) <= 2 * TRAIN.learning_rate + 1e-6


@pytest.mark.parametrize("case,order", [
    ("dp_eval", [[0, 1, 3, 4], [2]]),
    ("dp_eval_empty", [[0, 1], [2, 3], [4]])])
def test_dp_eval_matches_jax(runs, case, order):
    """evaluate_map over uneven shards (3 + 2 images) and over an empty
    shard: the lockstep rounds gather each round's rows in global order;
    the AP equals JAX's metric over the same images in that order."""
    outdir, params = runs
    images, labels = _eval_batch(params)
    metric = JitMeanAveragePrecision(SMALL)
    want = jax_trainer.evaluate_map(
        params, [(images[rows], labels[rows]) for rows in order], SMALL,
        metric=metric)
    assert 0.0 < want < 1.0
    for rank in range(2):
        assert abs(float(_load(outdir, case, rank)["ap"]) - want) <= 1e-3


def test_ring_model_gradients_match_plain_model(runs):
    """A ring model over a (1, 2) mesh (dropout 0.1, full remat) against
    the plain model: the loss and every parameter's gradient, on both
    ranks (the token split's autograd pairs and the projections' summed
    gradients)."""
    outdir, _ = runs
    for rank in range(2):
        got = _load(outdir, "ring_model", rank)
        names = [k[len("plain/"):] for k in got.files
                 if k.startswith("plain/")]
        assert len(names) > 20
        for name in names:
            want = got[f"plain/{name}"]
            np.testing.assert_allclose(
                got[f"ring/{name}"], want,
                atol=1e-5 * max(1.0, float(np.abs(want).max())),
                rtol=1e-5, err_msg=name)


def test_highres_ring_preset_trains_through_the_cli(runs):
    """``train --preset highres_1024_ring --model-parallel 2`` (narrowed as
    JAX's ring preset test narrows it) trains as two --distributed
    processes: 4 images at global batch 2 is 2 steps; both ranks report
    the same finite loss."""
    outdir, _ = runs
    results = [_load(outdir, "cli_ring", rank) for rank in range(2)]
    assert all(int(r["step"]) == 2 for r in results)
    assert np.isfinite(float(results[0]["final_loss"]))
    assert float(results[0]["final_loss"]) == float(
        results[1]["final_loss"])


def test_resume_in_a_new_process_group(runs):
    """A checkpoint written by one two-rank group and restored by a new
    one continues the trajectory: the third step's loss."""
    outdir, _ = runs
    first = _load(outdir, "resume_first", 0)["losses"]
    for rank in range(2):
        second = _load(outdir, "resume_second", rank)
        assert int(second["step"]) == 3
        np.testing.assert_allclose(second["losses"], first[2:], rtol=1e-6)


class _Mesh:
    """A mesh position without a process group (what the data helpers
    read of a mesh)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


@pytest.mark.parametrize("shape,coords,rows,spec", [
    ((1, 1), (0, 0), range(0, 8), (0, 1, 8)),
    ((2, 1), (1, 0), range(4, 8), (1, 2, 4)),
    ((2, 2), (1, 1), range(4, 8), (1, 2, 4)),
    ((4, 2), (2, 0), range(4, 6), (2, 4, 2)),
    ((1, 4), (0, 3), range(0, 8), (0, 1, 8))])
def test_process_batch_indices_and_shard_spec(shape, coords, rows, spec):
    """A rank loads the rows of its 'data' coordinate; the 'model'
    replicas load the same ones."""
    mesh = _Mesh(shape, coords)
    assert pdata.process_batch_indices(mesh, 8) == rows
    assert pdata.process_shard_spec(mesh, 8) == spec


def test_process_shard_spec_errors(monkeypatch):
    mesh = _Mesh((2, 1), (0, 0))
    with pytest.raises(ValueError, match="not divisible"):
        pdata.process_shard_spec(mesh, 7)
    monkeypatch.setattr(pdata, "process_batch_indices",
                        lambda m, g: range(4, 16))
    with pytest.raises(NotImplementedError, match="aligned"):
        pdata.process_shard_spec(mesh, 16)


def test_create_mesh_validation_and_partial_configuration():
    """JAX's messages, in a gloo group of one process; a partial explicit
    group configuration is refused; the group call is a no-op once
    formed."""
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.create_mesh()
    with pytest.raises(ValueError, match="without coordinator_address"):
        pdata.initialize_distributed(num_processes=2, device="cpu")
    pdata.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device="cpu")
    try:
        pdata.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                                     device="cpu")     # already formed
        mesh = pmesh.create_mesh()
        assert (pmesh.axis_size(mesh, "data"),
                pmesh.axis_size(mesh, "model")) == (1, 1)
        with pytest.raises(ValueError, match="3 devices|1 devices not "
                                             "divisible by model=3"):
            pmesh.create_mesh(model=3)
        with pytest.raises(ValueError, match=r"mesh 2x1 != 1 available"):
            pmesh.create_mesh(data=2)
    finally:
        torch.distributed.destroy_process_group()


def test_worker_imports_no_jax():
    """The workers of these tests import torch and the port, never JAX."""
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import torch_parallel_worker; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith("
            "'vision_transformer_detector_tpu.')))").format(TESTS)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
