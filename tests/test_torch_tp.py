"""Tensor parallelism of the port against the JAX package, on the CPU.

The port's ranks are gloo processes (tests/torch_parallel_worker.py,
which imports no JAX); the JAX side runs here on the 8-device virtual CPU
mesh of tests/conftest.py. The model is JAX's ``TINY`` of
tests/test_sharding.py and tests/multiprocess_worker.py (D 8, 2 heads, a
2-layer pyramid, one head layer), its weights JAX's Trainer's
initialisation, its batch that of tests/multiprocess_worker.py.

Tolerances:
  * every parameter's placement equals JAX's ``param_shardings`` (exact);
  * ``tp`` over (1, 2) and ``dp_tp`` over (2, 2) processes: each step's
    loss within 1e-5 relative of JAX's single-device step and of JAX's
    Trainer on the same mesh (fp32 sums in another order); a checkpoint
    gathered and restored: squared difference 0; a fresh init of another
    seed differs; checkpoints cross between one process and the mesh
    exactly;
  * dropout (tensor-parallel and sequence-sharded, every mask on global
    coordinates) against one process: losses within 1e-5 relative,
    parameters within Adam's step of rounding (2 * lr), but the attention
    key bias, whose exact gradient is zero, within 2 * lr a step;
  * the masks of a rank's heads (the flash mask's batch*head map) and of
    a column slice (the MLP mask's column base) equal the one-process
    masks' slices bit for bit; the bf16 moments' rounding bits of a
    slice equal the whole leaf's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import (
    DetectorConfig, LossConfig, TrainConfig, get_config, save_configs)
from vision_transformer_detector_tpu.models.vit_detector import (
    init_params as jax_init_params)
from vision_transformer_detector_tpu.parallel import mesh as jax_mesh
from vision_transformer_detector_tpu.train import optimizer as jax_opt
from vision_transformer_detector_tpu.train import trainer as jax_trainer
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch import config as port_config
from vision_transformer_detector_tpu_torch.kernels import dropout as dk
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.models.vit_detector import (
    full_shapes)
from vision_transformer_detector_tpu_torch.parallel import mesh as pmesh
from vision_transformer_detector_tpu_torch.train import optimizer as popt

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import test_torch_parallel as parallel  # noqa: E402
import torch_parallel_worker as worker  # noqa: E402

TINY = DetectorConfig(
    image_size=(32, 32), patch_size=16, embedding_dim=8, num_heads=2,
    key_dim=4, encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8,
    head_layers=1)
TRAIN = TrainConfig(learning_rate=1e-3)


def mesh_batch():
    """tests/multiprocess_worker.py's batch 4 of TINY."""
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = np.full((4, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for i in range(4):
        labels[i, 0] = (1, i % 80, 16.0, 16.0, 10.0, 10.0)
    return images, labels


def jax_sub_mesh(data, model):
    return jax_mesh.create_mesh(data=data, model=model,
                                devices=jax.devices()[:data * model])


def jax_mesh_losses(config, data, model, params=None):
    """(losses, initial params) of JAX's Trainer over a (data, model) mesh
    of the virtual devices, MESH_STEPS steps on ``mesh_batch``."""
    mesh = jax_sub_mesh(data, model)
    trainer = jax_trainer.Trainer(config, LossConfig(), TRAIN, mesh=mesh)
    state = trainer.init_state()
    if params is not None:
        state["params"] = jax.device_put(
            params, jax_mesh.param_shardings(params, mesh))
    initial = jax.device_get(state["params"])
    images, labels = (jnp.asarray(a) for a in mesh_batch())
    losses = []
    for _ in range(worker.MESH_STEPS):
        images_s, labels_s = trainer._put_batch(images, labels)
        with mesh:
            state, loss = trainer.train_step(state, images_s, labels_s,
                                             jax.random.PRNGKey(7))
        losses.append(float(loss))
    return losses, initial


def jax_single_losses(config, params):
    optimizer = jax_opt.make_optimizer(TRAIN)
    step = jax_trainer.make_train_step(config, LossConfig(), optimizer,
                                       donate=False)
    state = {"params": params, "opt_state": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    images, labels = (jnp.asarray(a) for a in mesh_batch())
    losses = []
    for _ in range(worker.MESH_STEPS):
        state, loss = step(state, images, labels, jax.random.PRNGKey(7))
        losses.append(float(loss))
    return losses


def write_inputs(outdir):
    """The mesh cases' config, weights (JAX's Trainer's initialisation)
    and batch; returns the weights."""
    _, params = jax_mesh_losses(TINY, 1, 1)
    save_params_npz(str(outdir / "mesh.npz"), params)
    save_configs(str(outdir / "mesh.json"), TINY, LossConfig(), TRAIN)
    images, labels = mesh_batch()
    np.savez(outdir / "mesh_batch.npz", images=images, labels=labels)
    return params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("tp")
    params = write_inputs(outdir)
    parallel._write_jpegs(outdir / "cli_data")
    parallel._run_group(2, outdir, ("tp", "tp_dropout", "cli_tp"))
    parallel._run_group(4, outdir, ("dp_tp", "dp_mesh_dropout"))
    return outdir, params


def _spec_axis(spec) -> int | None:
    spec = tuple(spec)
    return spec.index(jax_mesh.MODEL_AXIS) if jax_mesh.MODEL_AXIS in spec \
        else None


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("preset", ["tiny", "reference_608", "vit_l16_640",
                                    "highres_1024"])
def test_placements_match_jax_param_shardings(preset, model):
    """Every parameter's tensor-parallel axis (None: replicated), the
    fallbacks of dimensions the model axis does not divide included,
    equals JAX's ``param_shardings`` on the full-size preset (shapes
    only: ``jax.eval_shape``)."""
    jax_config = TINY if preset == "tiny" else get_config(preset)
    config = (port_config.DetectorConfig(**{
        f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
        if preset == "tiny" else port_config.get_config(preset))
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jax_config))
    shardings = jax_mesh.param_shardings(shapes, jax_sub_mesh(8 // model,
                                                              model))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _spec_axis(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                shardings)[0]}
    got = pmesh.param_placements(full_shapes(config), model)
    assert {k.replace(".", "/"): v for k, v in got.items()} == want
    assert any(v is not None for v in want.values())


@pytest.mark.parametrize("case,mesh", [("tp", (1, 2)), ("dp_tp", (2, 2))])
def test_tp_train_steps_match_jax(runs, case, mesh):
    """tp over (1, 2) and dp_tp over (2, 2) processes: the losses equal
    JAX's single-device steps and JAX's Trainer on the same mesh; the
    checkpoint round trip is exact, a fresh init differs, and checkpoints
    cross between one process and the mesh; the ranks hold their slices
    (the q/k/v kernels' heads halved)."""
    outdir, params = runs
    single = jax_single_losses(TINY, params)
    on_mesh, _ = jax_mesh_losses(TINY, *mesh, params)
    for rank in range(mesh[0] * mesh[1]):
        got = parallel._load(outdir, case, rank)
        np.testing.assert_allclose(got["losses"], single, rtol=1e-5)
        np.testing.assert_allclose(got["losses"], on_mesh, rtol=1e-5)
        assert float(got["ckpt_sq_diff"]) == 0.0
        assert float(got["fresh_sq_diff"]) > 1.0
        assert float(got["from_single_sq_diff"]) == 0.0
        assert list(got["shape/encoder.0.mha.query.kernel"]) == [8, 1, 4]
        assert list(got["shape/encoder.0.mha.out.kernel"]) == [1, 4, 8]
    assert float(parallel._load(outdir, case, 0)[
        "single_restore_sq_diff"]) == 0.0


@pytest.mark.parametrize("case", ["tp_dropout", "dp_mesh_dropout"])
@pytest.mark.parametrize("variant", [v for v, _ in worker.DROPOUT_VARIANTS])
def test_mesh_dropout_matches_one_process(runs, case, variant):
    """With dropout 0.1 (flash or einsum attention; sequence sharding with
    and without windows) over (1, 2) and (2, 2) meshes, the run trains as
    one process on the global batch: every mask is the one the whole
    array draws."""
    outdir, _ = runs
    got = parallel._load(outdir, case, 0)
    np.testing.assert_allclose(got[f"{variant}/losses"],
                               got[f"{variant}/single_losses"], rtol=1e-5)
    assert float(got[f"{variant}/max_param_diff"]) <= \
        2 * TRAIN.learning_rate + 1e-6
    # The key bias (exact gradient zero) moves by Adam's normalised
    # rounding noise, up to lr a step either way in each run.
    assert float(got[f"{variant}/key_bias_diff"]) <= \
        2 * TRAIN.learning_rate * worker.MESH_STEPS + 1e-6


def test_cli_trains_tensor_parallel(runs):
    """``train --preset tiny_96 --model-parallel 2`` (tensor parallelism)
    as two --distributed processes: 4 images at batch 2 are 2 steps; both
    ranks report the same finite loss."""
    outdir, _ = runs
    results = [parallel._load(outdir, "cli_tp", rank) for rank in range(2)]
    assert all(int(r["step"]) == 2 for r in results)
    assert np.isfinite(float(results[0]["final_loss"]))
    assert float(results[0]["final_loss"]) == float(
        results[1]["final_loss"])


@pytest.mark.parametrize("fold", ["heads_major", "tokens_major"])
def test_head_map_masks_match_one_process(fold):
    """The flash mask of a rank's heads [h0, h0 + H_l) of every image,
    through the batch*head map (H_l, H, h0) (heads-major windows: (H_l W,
    H W, h0 W)), equals the slice of one process's mask, bit for bit; so
    does a sequence-sharded rank's windows (W_l, W, w0)."""
    seed, rate = 2 ** 32 - 5, 0.3
    b, h, w, t = 2, 4, 4, 3            # images, heads, windows, tokens
    if fold == "heads_major":          # rows (b * H + h) * W + w
        whole = fa._dropout_scale((seed, rate), b, h * w, t, "cpu")
        whole = whole.reshape(b, h, w, t, t)
        for rank in range(2):
            heads = fa._dropout_scale(
                (seed, rate), b, 2 * w, t, "cpu",
                (0, 0, 0, 2 * w, h * w, rank * 2 * w))
            assert torch.equal(heads.reshape(b, 2, w, t, t),
                               whole[:, rank * 2:(rank + 1) * 2])
            windows = fa._dropout_scale(
                (seed, rate), b, h * 2, t, "cpu",
                (0, 0, 0, 2, w, rank * 2))
            assert torch.equal(windows.reshape(b, h, 2, t, t),
                               whole[:, :, rank * 2:(rank + 1) * 2])
    else:                              # rows (b * W + w) * H + h
        whole = fa._dropout_scale((seed, rate), b * w, h, t, "cpu")
        whole = whole.reshape(b, w, h, t, t)
        for rank in range(2):
            heads = fa._dropout_scale(
                (seed, rate), b * w, 2, t, "cpu",
                (0, 0, 0, 2, h, rank * 2))
            assert torch.equal(heads.reshape(b, w, 2, t, t),
                               whole[:, :, rank * 2:(rank + 1) * 2])
            windows = fa._dropout_scale(
                (seed, rate), b * 2, h, t, "cpu",
                (0, 0, 0, 2 * h, w * h, rank * 2 * h))
            assert torch.equal(windows.reshape(b, 2, h, t, t),
                               whole[:, rank * 2:(rank + 1) * 2])


def test_token_and_column_masks_match_one_process():
    """The MLP/head mask of a sequence-sharded rank's tokens (row map
    (n_l, N, n0), with a data-parallel row base) and of a tensor-parallel
    column slice (``col_base``) equal one process's slices, bit for
    bit."""
    seed, rate = 2 ** 32 - 9, 0.2
    whole = dk.dropout_mask(seed, (4, 16, 12), rate, "cpu")
    for rank in range(2):
        tokens = dk.dropout_mask(seed, (2, 8, 12), rate, "cpu",
                                 row_base=2 * 16,
                                 row_map=(8, 16, rank * 8))
        assert torch.equal(tokens, whole[2:, rank * 8:(rank + 1) * 8])
        columns = dk.dropout_mask(seed, (4, 16, 6), rate, "cpu",
                                  col_base=rank * 6)
        assert torch.equal(columns, whole[..., rank * 6:(rank + 1) * 6])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sharded_rounding_bits_match_the_whole_leaf(axis):
    """The bf16 moments' stochastic rounding bits of a slice (keyed on its
    elements' flat indices in the whole leaf, not contiguous for a column
    slice) equal the whole leaf's bits there."""
    full = (6, 4, 8)
    whole = popt.rounding_bits(torch.tensor(3), 5, full, "cpu")
    part = full[axis] // 2
    shape = tuple(part if d == axis else n for d, n in enumerate(full))
    for rank in range(2):
        got = popt.rounding_bits(torch.tensor(3), 5, shape, "cpu",
                                 (full, axis, rank * part))
        assert torch.equal(got, whole.narrow(axis, rank * part, part))


class _FakeMesh:
    """A (1, 2) mesh position without a process group (what the model and
    the placements read of a mesh)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 2)[dim]

    def get_local_rank(self, axis):
        return self.mesh_dim_names.index(axis)


def test_int8_model_stays_whole_under_tensor_parallelism():
    """JAX's placements replicate an int8-quantized tree's codes
    (``kernel_q`` is not a ``kernel``): the port's quantized model keeps
    its layers whole on a tensor-parallel mesh and forwards as one
    process, while its float model's layers are split."""
    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector_tpu_torch.models import (
        vit_detector as vit)

    config = port_config.DetectorConfig(**{
        f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    model = vit.init_params(config, torch.Generator().manual_seed(0))
    mesh = _FakeMesh()
    assert pmesh.shard_layout(model, mesh)
    shard = vit._shard_of(mesh, config, model, 2)
    assert shard.heads and shard.mlp == (1, 0)
    quantized = quantize_params(model)
    assert pmesh.shard_layout(quantized, mesh) == {}
    shard = vit._shard_of(mesh, config, quantized, 2)
    assert not shard.heads and shard.mlp == ()
    images = torch.from_numpy(mesh_batch()[0][:2])
    with torch.no_grad():
        torch.testing.assert_close(
            vit.forward(quantized, images, config, mesh=mesh),
            vit.forward(quantized, images, config), rtol=0, atol=0)
