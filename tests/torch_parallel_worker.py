"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py).

Usage: ``python torch_parallel_worker.py RANK WORLD PORT OUTDIR CASE...``.
The process joins a gloo group of WORLD processes at 127.0.0.1:PORT, runs
each CASE in order, and writes what it computed to
``OUTDIR/<case>-<rank>.npz``. It imports torch and the port, never JAX:
the JAX side of each comparison runs in the test process. Inputs come
from numpy seeds or from files the test wrote into OUTDIR.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from vision_transformer_detector_tpu_torch.config import load_configs
from vision_transformer_detector_tpu_torch.kernels.ring_attention import (
    ring_attention)
from vision_transformer_detector_tpu_torch.models.vit_detector import (
    forward)
from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
from vision_transformer_detector_tpu_torch.parallel.data import (
    initialize_distributed, process_batch_indices)
from vision_transformer_detector_tpu_torch.parallel import collectives
from vision_transformer_detector_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_index, create_mesh, gather_params)
from vision_transformer_detector_tpu_torch.train.trainer import (
    Trainer, evaluate_map, train_config_view)
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz, params_to_numpy)

RING_SHAPE = (4, 64, 2, 16)     # (B, N, H, K) of the ring cases
RING_DROPOUT = (0.3, 4242)      # rate, seed
BF16_WORLD = 8                  # the group of the bf16 ring cases


def bf16_ring_shape(ring: int):
    """(B, N, H, K) of a bf16 ring case over a (8 / R, R) mesh: 2 images
    a data rank, 64 tokens a ring rank."""
    return (2 * (BF16_WORLD // ring), 64 * ring, 2, 16)


def ring_inputs(shape=RING_SHAPE):
    """q (scaled by 1/sqrt(K), as the caller does), k, v and the output
    cotangent g, fp32, seed 0."""
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    return q / np.float32(np.sqrt(shape[-1])), k, v, g


def case_ring(out, ring, dropout=False, dtype=torch.float32):
    """This rank's shards of ring attention's output and gradients over a
    (world / ring, ring) mesh: the batch over 'data', tokens over the
    ring; bf16 cases (inputs rounded from the fp32 ones) at
    ``bf16_ring_shape``. Saved in fp32."""
    shape = RING_SHAPE if dtype == torch.float32 else bf16_ring_shape(ring)
    mesh = create_mesh(model=ring)
    d, m = axis_index(mesh, DATA_AXIS), axis_index(mesh, MODEL_AXIS)
    b = shape[0] // (dist.get_world_size() // ring)
    n = shape[1] // ring
    q, k, v, g = (torch.from_numpy(t[d * b:(d + 1) * b, m * n:(m + 1) * n]
                                   .copy()).to(dtype)
                  for t in ring_inputs(shape))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    rate, seed = RING_DROPOUT if dropout else (None, None)
    result = ring_attention(q, k, v, mesh, dropout_rate=rate,
                            dropout_seed=seed)
    grads = torch.autograd.grad(result, (q, k, v), g)
    np.savez(out, out=result.detach().float().numpy(),
             **{name: t.float().numpy()
                for name, t in zip(("dq", "dk", "dv"), grads)},
             d=d, m=m, b=b, n=n)


def _shard(arrays, mesh, global_batch):
    rows = process_batch_indices(mesh, global_batch)
    return [torch.from_numpy(a[rows.start:rows.stop].copy()) for a in arrays]


def _train(trainer, state, images, labels, steps):
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, images, labels)
        losses.append(float(loss))
    return losses


def case_dp_train(out, outdir):
    """Three DP train steps from the test's weights on its global batch
    (the shards hold different numbers of positives)."""
    config, loss_config, train_config = load_configs(
        os.path.join(outdir, "dp_train.json"))
    batch = np.load(os.path.join(outdir, "dp_train_batch.npz"))
    mesh = create_mesh()
    trainer = Trainer(config, loss_config, train_config, mesh=mesh,
                      device="cpu")
    state = trainer.init_state()
    state["params"].load_state_dict(load_params_npz(
        os.path.join(outdir, "dp_train.npz"), config).state_dict())
    images, labels = _shard([batch["images"], batch["labels"]], mesh,
                            len(batch["images"]))
    losses = _train(trainer, state, images, labels, 3)
    np.savez(out, losses=np.asarray(losses),
             **params_to_numpy(state["params"]))


def case_dp_dropout(out, outdir):
    """DP steps with dropout (flash attention and MLP/head masks) against
    one process training the same state on the global batch."""
    config, loss_config, train_config = load_configs(
        os.path.join(outdir, "dp_dropout.json"))
    batch = np.load(os.path.join(outdir, "dp_train_batch.npz"))
    mesh = create_mesh()
    trainer = Trainer(config, loss_config, train_config, mesh=mesh,
                      device="cpu")
    state = trainer.init_state()
    images, labels = _shard([batch["images"], batch["labels"]], mesh,
                            len(batch["images"]))
    losses = _train(trainer, state, images, labels, 2)
    single = Trainer(config, loss_config, train_config, device="cpu")
    single_state = single.init_state()
    single_losses = _train(single, single_state,
                           torch.from_numpy(batch["images"]),
                           torch.from_numpy(batch["labels"]), 2)
    got, want = (params_to_numpy(s["params"]) for s in (state,
                                                         single_state))
    np.savez(out, losses=np.asarray(losses),
             single_losses=np.asarray(single_losses),
             max_param_diff=max(float(np.abs(got[k] - want[k]).max())
                                for k in got))


def case_dp_eval(out, outdir, empty=False):
    """evaluate_map over this rank's shard of the test's eval images:
    rank 0 rows 0-2 and rank 1 rows 3-4 in batches of 2, or (``empty``)
    rank 0 every row and rank 1 none."""
    config, _, _ = load_configs(os.path.join(outdir, "dp_train.json"))
    data = np.load(os.path.join(outdir, "dp_eval_batch.npz"))
    mesh = create_mesh()
    params = load_params_npz(os.path.join(outdir, "dp_train.npz"), config)
    rank = dist.get_rank()
    mine = ((range(0, 5) if rank == 0 else range(0)) if empty
            else (range(0, 3) if rank == 0 else range(3, 5)))
    batches = [(data["images"][i:min(i + 2, mine.stop)],
                data["labels"][i:min(i + 2, mine.stop)])
               for i in range(mine.start, mine.stop, 2)]
    ap = evaluate_map(params, batches, config, device="cpu", mesh=mesh)
    np.savez(out, ap=ap)


def case_ring_model(out, outdir):
    """The loss and every parameter's gradient of a ring model over a
    (1, world) mesh against the meshless model on the same batch."""
    config, loss_config, _ = load_configs(
        os.path.join(outdir, "ring_model.json"))
    config = train_config_view(config)
    batch = np.load(os.path.join(outdir, "ring_model_batch.npz"))
    images = torch.from_numpy(batch["images"])
    labels = torch.from_numpy(batch["labels"])
    mesh = create_mesh(data=1, model=dist.get_world_size())
    params = load_params_npz(os.path.join(outdir, "ring_model.npz"), config)
    named = dict(params.named_parameters())
    results = {}
    for tag, run_mesh in (("ring", mesh), ("plain", None)):
        logits = forward(params, images, config, train=True,
                         dropout_seed=1234, mesh=run_mesh)
        loss = detection_loss(labels, logits, config, loss_config)
        grads = torch.autograd.grad(loss, list(named.values()))
        results[f"{tag}/loss"] = loss.detach().numpy()
        results.update({f"{tag}/{name}": g.numpy()
                        for name, g in zip(named, grads)})
    np.savez(out, **results)


def _resume_trainer(outdir):
    config, loss_config, train_config = load_configs(
        os.path.join(outdir, "dp_dropout.json"))
    mesh = create_mesh()
    trainer = Trainer(config, loss_config, train_config, mesh=mesh,
                      checkpoint_dir=os.path.join(outdir, "resume"),
                      device="cpu")
    batch = np.load(os.path.join(outdir, "dp_train_batch.npz"))
    return trainer, _shard([batch["images"], batch["labels"]], mesh,
                           len(batch["images"]))


def case_resume_first(out, outdir):
    """Three DP steps with dropout, checkpointing after the second."""
    trainer, (images, labels) = _resume_trainer(outdir)
    state = trainer.init_state()
    losses = _train(trainer, state, images, labels, 2)
    trainer.save(state, "ongoing")
    losses += _train(trainer, state, images, labels, 1)
    np.savez(out, losses=np.asarray(losses))


def case_resume_second(out, outdir):
    """A new process group restores the checkpoint and takes the third
    step."""
    trainer, (images, labels) = _resume_trainer(outdir)
    state = trainer.restore(trainer.init_state(), "ongoing")
    np.savez(out, losses=np.asarray(_train(trainer, state, images, labels,
                                           1)), step=state["step"])


def case_cli_ring(out, outdir):
    """``vtd-torch train --preset highres_1024_ring --model-parallel 2``
    as two --distributed processes (in this group; the preset narrowed to
    the test's config) on the test's JPEGs."""
    import contextlib
    import io
    import json

    from vision_transformer_detector_tpu_torch import cli

    narrowed = load_configs(os.path.join(outdir, "cli_ring.json"))[0]
    preset = cli.get_config
    cli.get_config = (lambda name: narrowed if name == "highres_1024_ring"
                      else preset(name))
    data = os.path.join(outdir, "cli_data")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        cli.main(["train", "--preset", "highres_1024_ring",
                  "--model-parallel", "2", "--distributed",
                  "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                  "--process-id", str(dist.get_rank()), "--device", "cpu",
                  "--batch-size", "2", "--epochs", "1",
                  "--train-images", os.path.join(data, "images"),
                  "--train-annotations", os.path.join(data, "ann.json"),
                  "--checkpoint-dir", os.path.join(data, "ckpt"),
                  "--metrics", os.path.join(data, "metrics.jsonl")])
    result = json.loads(stdout.getvalue().strip().splitlines()[-1])
    np.savez(out, final_loss=result["final_loss"], step=result["step"])


# ----- tensor parallelism and sequence sharding (tests/test_torch_tp.py,
# tests/test_torch_sp.py): JAX's TINY, its weights and batch from the test.

MESH_STEPS = 2
# Sequence sharding's forward variants: (name, overrides of TINY).
SP_VARIANTS = (
    ("window1", dict(attention_window=1)),
    ("global", dict()),
    ("global_flash", dict(use_flash_attention=True)),
    ("global_ring", dict(ring_attention=True)),
)
# Dropout runs against one process: (name, config overrides).
DROPOUT_VARIANTS = (
    ("tp_flash", dict(use_flash_attention=True)),
    ("tp_einsum", dict()),
    ("sp_window_flash", dict(sequence_sharding=True, image_size=(64, 64),
                             attention_window=2, use_flash_attention=True)),
    ("sp_window_einsum", dict(sequence_sharding=True, image_size=(64, 64),
                              attention_window=2)),
    ("sp_global_flash", dict(sequence_sharding=True,
                             use_flash_attention=True)),
    ("sp_global_einsum", dict(sequence_sharding=True)),
)


def _mesh_setup(outdir, data):
    config, loss_config, train_config = load_configs(
        os.path.join(outdir, "mesh.json"))
    batch = np.load(os.path.join(outdir, "mesh_batch.npz"))
    mesh = create_mesh(data=data, model=dist.get_world_size() // data)
    return config, loss_config, train_config, batch, mesh


def _sq_diff(a, b) -> float:
    return float(sum(((a[k] - b[k]).double() ** 2).sum() for k in a))


def case_tp(out, outdir, data=1):
    """Tensor parallelism over a (data, world / data) mesh from the test's
    weights on its global batch: each step's loss; the state saved
    (gathered) and restored into a fresh init of another seed (squared
    difference of the parameters 0; the fresh init's > 0); the local
    shapes; a checkpoint of one process restored into the sharded state,
    and the sharded one restored in one process (both exact)."""
    config, loss_config, train_config, batch, mesh = _mesh_setup(outdir,
                                                                 data)
    ckpt = os.path.join(outdir, f"ckpt-tp{data}")
    trainer = Trainer(config, loss_config, train_config, mesh=mesh,
                      checkpoint_dir=ckpt, device="cpu")
    state = trainer.init_state()
    weights = load_params_npz(os.path.join(outdir, "mesh.npz"), config)
    trainer.load_params(state, weights)
    images, labels = _shard([batch["images"], batch["labels"]], mesh,
                            len(batch["images"]))
    losses = _train(trainer, state, images, labels, MESH_STEPS)
    trainer.save(state, "ongoing")
    full = gather_params(state["params"], mesh)
    fresh = trainer.init_state(seed=99)
    fresh_full = gather_params(fresh["params"], mesh)
    restored = gather_params(trainer.restore(fresh, "ongoing")["params"],
                             mesh)
    result = {"losses": np.asarray(losses),
              "ckpt_sq_diff": _sq_diff(full, restored),
              "fresh_sq_diff": _sq_diff(full, fresh_full),
              **{f"shape/{k}": np.asarray(v.shape)
                 for k, v in state["params"].state_dict().items()}}
    # One process: the sharded run's checkpoint, and one of its own that
    # the sharded state restores.
    if dist.get_rank() == 0:
        single = Trainer(config, loss_config, train_config,
                         checkpoint_dir=ckpt, device="cpu")
        one = single.restore(single.init_state(), "ongoing")
        result["single_restore_sq_diff"] = _sq_diff(
            full, one["params"].state_dict())
        single.load_params(one, weights)
        single.save(one, "single")
    collectives.barrier()
    back = gather_params(trainer.restore(trainer.init_state(seed=7),
                                         "single")["params"], mesh)
    result["from_single_sq_diff"] = _sq_diff(back, {
        k: v for k, v in weights.state_dict().items()})
    np.savez(out, **result)


def case_sp_forward(out, outdir):
    """Sequence sharding's forward over a (2, world / 2) mesh for each of
    SP_VARIANTS: this rank's logits of its batch shard."""
    config, _, _, batch, mesh = _mesh_setup(outdir, 2)
    weights = load_params_npz(os.path.join(outdir, "mesh.npz"), config)
    (images,) = _shard([batch["images"]], mesh, len(batch["images"]))
    result = {}
    with torch.no_grad():
        for name, overrides in SP_VARIANTS:
            variant = config.replace(sequence_sharding=True, **overrides)
            result[name] = forward(weights, images, variant,
                                   mesh=mesh).numpy()
    rows = process_batch_indices(mesh, len(batch["images"]))
    np.savez(out, first=rows.start, **result)


# The trained runs of the model axis's token roles: (overrides of TINY).
TOKEN_RUNS = {"sp": dict(sequence_sharding=True, attention_window=1),
              "sp_global": dict(sequence_sharding=True),
              "ring": dict(ring_attention=True)}


def case_token_train(out, outdir, run, data):
    """A TOKEN_RUNS config (sequence sharding, or the ring) trained over a
    (data, world / data) mesh from the test's weights: each step's
    loss."""
    config, loss_config, train_config, batch, mesh = _mesh_setup(outdir,
                                                                 data)
    config = config.replace(**TOKEN_RUNS[run])
    trainer = Trainer(config, loss_config, train_config, mesh=mesh,
                      device="cpu")
    state = trainer.init_state()
    trainer.load_params(state, load_params_npz(
        os.path.join(outdir, "mesh.npz"), config))
    images, labels = _shard([batch["images"], batch["labels"]], mesh,
                            len(batch["images"]))
    np.savez(out, losses=np.asarray(_train(trainer, state, images, labels,
                                           MESH_STEPS)))


def case_mesh_dropout(out, outdir, data=1):
    """Each of DROPOUT_VARIANTS (dropout 0.1: the attention masks in the
    flash plain version or on the einsum probabilities, the MLP/head
    masks) trained over a (data, world / data) mesh against one process
    on the global batch from the same state: the losses and the largest
    parameter difference (the attention key bias's apart)."""
    config, loss_config, train_config, batch, mesh = _mesh_setup(outdir,
                                                                 data)
    result = {}
    for name, overrides in DROPOUT_VARIANTS:
        variant = config.replace(dropout=0.1, **overrides)
        rng = np.random.default_rng(11)
        h, w = variant.image_size
        images = rng.uniform(-1, 1, (4, h, w, 3)).astype(np.float32)
        labels = batch["labels"].copy()
        labels[labels[..., 0] > 0, 2:] *= h / config.image_size[0]
        trainer = Trainer(variant, loss_config, train_config, mesh=mesh,
                          device="cpu")
        state = trainer.init_state()
        local = _shard([images, labels], mesh, 4)
        losses = _train(trainer, state, *local, MESH_STEPS)
        single = Trainer(variant, loss_config, train_config, device="cpu")
        single_state = single.init_state()
        single_losses = _train(single, single_state,
                               torch.from_numpy(images),
                               torch.from_numpy(labels), MESH_STEPS)
        got = gather_params(state["params"], mesh)
        want = single_state["params"].state_dict()
        result[f"{name}/losses"] = np.asarray(losses)
        result[f"{name}/single_losses"] = np.asarray(single_losses)
        # The attention key bias's exact gradient is zero (it shifts every
        # score of a query row alike), so Adam moves it by its rounding
        # noise, up to lr a step either way: reported apart.
        diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
        result[f"{name}/key_bias_diff"] = max(
            v for k, v in diffs.items() if k.endswith("mha.key.bias"))
        result[f"{name}/max_param_diff"] = max(
            v for k, v in diffs.items() if not k.endswith("mha.key.bias"))
    np.savez(out, **result)


def case_cli_tp(out, outdir):
    """``vtd-torch train --preset tiny_96 --model-parallel 2`` as two
    --distributed processes (in this group) on the test's JPEGs:
    tensor parallelism through the CLI."""
    import contextlib
    import io
    import json

    from vision_transformer_detector_tpu_torch import cli

    data = os.path.join(outdir, "cli_data")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        cli.main(["train", "--preset", "tiny_96", "--model-parallel", "2",
                  "--distributed", "--coordinator", "127.0.0.1:1",
                  "--num-processes", "2", "--process-id",
                  str(dist.get_rank()), "--device", "cpu",
                  "--batch-size", "2", "--epochs", "1",
                  "--train-images", os.path.join(data, "images"),
                  "--train-annotations", os.path.join(data, "ann.json"),
                  "--checkpoint-dir", os.path.join(outdir, "cli_tp_ckpt")])
    result = json.loads(stdout.getvalue().strip().splitlines()[-1])
    np.savez(out, final_loss=result["final_loss"], step=result["step"])


CASES = {
    "ring1": lambda out, outdir: case_ring(out, 1),
    "ring2": lambda out, outdir: case_ring(out, 2),
    "ring4": lambda out, outdir: case_ring(out, 4),
    "ring2_dropout": lambda out, outdir: case_ring(out, 2, dropout=True),
    "ring4_dropout": lambda out, outdir: case_ring(out, 4, dropout=True),
    **{f"ring{r}_bf16{'_dropout' * drop}":
       (lambda r, drop: lambda out, outdir: case_ring(
           out, r, drop, torch.bfloat16))(r, drop)
       for r in (2, 4, 8) for drop in (False, True)},
    "dp_train": case_dp_train,
    "dp_dropout": case_dp_dropout,
    "dp_eval": case_dp_eval,
    "dp_eval_empty": lambda out, outdir: case_dp_eval(out, outdir, True),
    "ring_model": case_ring_model,
    "resume_first": case_resume_first,
    "resume_second": case_resume_second,
    "cli_ring": case_cli_ring,
    "tp": case_tp,
    "dp_tp": lambda out, outdir: case_tp(out, outdir, data=2),
    "sp_forward": case_sp_forward,
    **{f"{run}_train_{data}":
       (lambda run, data: lambda out, outdir: case_token_train(
           out, outdir, run, data))(run, data)
       for run in TOKEN_RUNS for data in (1, 2)},
    "tp_dropout": case_mesh_dropout,
    "dp_mesh_dropout": lambda out, outdir: case_mesh_dropout(out, outdir, 2),
    "cli_tp": case_cli_tp,
}


def main():
    rank, world, port = map(int, sys.argv[1:4])
    outdir, cases = sys.argv[4], sys.argv[5:]
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        for case in cases:
            CASES[case](os.path.join(outdir, f"{case}-{rank}.npz"), outdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
