"""Training loop: train/eval/predict steps, the epoch loop with the
reference's eval cadence, best-AP checkpoints and jsonl metrics, and the
windowed loop that runs several epochs per call as a CUDA graph.

Counterpart of vision_transformer_detector_tpu/train/trainer.py, on one
device per process (``device``, explicit; under a mesh ``"cuda"`` is the
card of the process's ``LOCAL_RANK``). PyTorch runs eagerly, so the steps are
plain functions, and the train step updates the parameters and the
optimizer state in place (the JAX step returns new ones). The train state
is ``{"params": ViTDetector, "opt_state": dict, "step": int}``, and
``Trainer.init_state`` adds ``"dropout_rng"``: a CPU ``torch.Generator``
seeded with ``TrainConfig.seed + 1`` (the JAX ``fit``'s rng chain seed)
from which each step with dropout draws its uint32 seed; the step's seed
table (``models/vit_detector.py:seed_table``) is derived from it on the
host and copied to the device once per step. The generator is saved and
restored with the checkpoints, so a restored run draws the masks an
uninterrupted one would.

``make_multi_step`` is the counterpart of the JAX ``lax.scan`` window: on
CUDA it captures the train step once as a ``torch.cuda.CUDAGraph`` (two,
a micro step and an update step, with gradient accumulation) and replays
it, copying each step's batch and seed row into the graph's static
buffers; on the CPU it runs the same step eagerly. ``fit(epochs_per_call
> 1)`` drives it over windows that end at every event epoch, as JAX's
``_fit_scanned``. Checkpoints can be written asynchronously
(``async_checkpointing``), and a streaming dataset is prefetched to the
device one batch ahead, with its resume position saved beside every
checkpoint.

Data parallelism and ring attention (``mesh``, parallel/mesh.py): one
process per mesh position, each with the same parameters (every rank
initialises from the seed, rank 0 broadcasts them, fresh or restored, and
a checksum compares them), training on its shard of the global batch.
The loss is the global batch's (ops/loss.py sums its counts over the
'data' group), the dropout masks are keyed on global coordinates, and the
gradients are summed over 'data' as one flat all-reduce (the step's loss
share rides in the same bucket) after the backward and before the clip
and Adam: the clip is elementwise, so clipping local gradients would be
another function. Under NCCL the windowed loop captures the step with its
collectives as the CUDA graph; gloo's collectives cannot be captured, so
under gloo the same body runs eagerly. ``evaluate_map`` gathers each
round's decoded predictions, labels and valid mask over 'data' in global
row order and every rank updates the metric alike. Rank 0 writes the
checkpoints (and metrics), the others wait for it; every rank restores.
A model axis above 1 is the ring of ``ring_attention`` only (tensor
parallelism is not ported).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import (
    DetectorConfig, LossConfig, TrainConfig, load_configs, save_configs)
from ..metrics.mean_average_precision import (
    MeanAveragePrecision)

from ..metrics.fast_map import DeviceMeanAveragePrecision
from ..models.vit_detector import (
    dropout_seeds, forward, init_params, seed_table, seed_table_size)
from ..ops.decode import transform_predictions
from ..ops.loss import detection_loss
from ..parallel import collectives
from ..parallel.data import rank_device, synced_global_eval_batches
from ..parallel.mesh import (
    DATA_AXIS, axis_group, gather_tensors, model_axis_role, shard_layout,
    shard_params, slice_tensors)
from ..utils import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from .optimizer import Adam, clip_weights

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}


def create_train_state(config: DetectorConfig, optimizer: Adam,
                       generator: torch.Generator,
                       device="cpu") -> TrainState:
    params = init_params(config, generator, device)
    return {"params": params,
            "opt_state": optimizer.init(dict(params.named_parameters())),
            "step": 0}


def _maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 pixels to [-1, 1] on the device, as the JAX step fuses it."""
    if images.dtype == torch.uint8:
        return images.float() / 127.5 - 1.0
    return images


def train_config_view(config: DetectorConfig) -> DetectorConfig:
    """The config the train step traces: ``train_use_flash_attention``
    overrides the attention route for training only."""
    if config.train_use_flash_attention is not None:
        return config.replace(
            use_flash_attention=config.train_use_flash_attention)
    return config


def _draw_dropout_seed(state: TrainState) -> int:
    generator = state.get("dropout_rng")
    if generator is None:
        raise ValueError(
            "training with dropout draws its masks' seeds from "
            "state['dropout_rng'] (Trainer.init_state makes it); add a "
            "torch.Generator there")
    return int(torch.randint(0, 2 ** 32, (), generator=generator))


def draw_seed_row(state: TrainState, config: DetectorConfig) -> np.ndarray:
    """The next step's dropout seed table (uint32, host): the next draw of
    ``state["dropout_rng"]`` through ``dropout_seeds``."""
    return seed_table(dropout_seeds(_draw_dropout_seed(state), config))


def _to_device_async(array: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to CUDA from pinned memory without a
    host sync (the caching host allocator keeps the pinned block until
    the copy has run)."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def _sum_over_data(loss, grads, group):
    """The step's loss share and gradients summed over the 'data' group as
    one flat bucket (one all-reduce): the global batch's loss and its
    gradient."""
    flat = collectives.all_reduce_(
        torch.cat([loss.detach().reshape(1)]
                  + [g.reshape(-1) for g in grads]), group)
    parts = flat[1:].split([g.numel() for g in grads])
    return flat[0], [p.view_as(g) for p, g in zip(parts, grads)]


def make_step_body(config: DetectorConfig, loss_config: LossConfig,
                   optimizer: Adam, mesh=None) -> Callable:
    """``body(state, images, labels, seeds, update) -> loss``: forward,
    loss, grads, the optimizer's (micro) step and ClipWeight on device
    tensors, with no host read, so a CUDA graph can capture it. ``seeds``
    is the step's seed table on the device (None: no dropout); ``update``
    says whether an accumulating optimizer applies its update. Under
    ``mesh`` the images and labels are this rank's shard, and the loss and
    gradients are summed over 'data' before the update (module
    docstring); the returned loss is the global batch's. Shared by the
    eager step and ``make_multi_step``."""
    config = train_config_view(config)
    group = axis_group(mesh, DATA_AXIS)

    def body(state: TrainState, images, labels, seeds,
             update: bool = True) -> torch.Tensor:
        model = state["params"]
        params = dict(model.named_parameters())
        with torch.enable_grad():
            logits = forward(model, _maybe_normalize(images), config,
                             train=config.dropout is not None,
                             dropout_seed=seeds, mesh=mesh)
            loss = detection_loss(labels, logits, config, loss_config,
                                  group=group)
            grads = torch.autograd.grad(loss, list(params.values()))
        if mesh is not None:
            loss, grads = _sum_over_data(loss, grads, group)
        optimizer.step(params, dict(zip(params, grads)), state["opt_state"],
                       update=update if optimizer.every_k > 1 else None)
        if config.clip_weight:
            clip_weights(params, config.max_weight)
        return loss.detach()

    return body


def make_train_step(config: DetectorConfig, loss_config: LossConfig,
                    optimizer: Adam, mesh=None):
    """``train_step(state, images, labels) -> (state, loss)``: forward,
    loss, grads, clip + Adam (or one micro step of the accumulation),
    ClipWeight. Updates ``state`` in place. With ``config.dropout``, the
    masks' seed table comes from the next draw of
    ``state["dropout_rng"]``, copied to the device once. ``mesh`` as in
    ``make_step_body``."""
    body = make_step_body(config, loss_config, optimizer, mesh)

    def train_step(state: TrainState, images, labels):
        seeds = None
        if config.dropout:
            seeds = _to_device_async(draw_seed_row(state, config),
                                     images.device)
        loss = body(state, images, labels, seeds,
                    optimizer.is_update_step(state["step"]))
        state["step"] += 1
        return state, loss

    return train_step


def _state_tensors(state: TrainState) -> list:
    """Every tensor of the train state a step reads or writes."""
    opt = state["opt_state"]
    tensors = list(state["params"].parameters())
    for key in ("mu", "nu", "acc"):
        if key in opt:
            tensors += [opt[key][name] for name in opt["order"]]
    return tensors + [opt[key] for key in ("count", "mini_step")
                      if key in opt]


class _StepGraph:
    """One train step captured as a CUDA graph.

    The graph reads static buffers (images, labels, the seed row) and
    writes the model's parameters and the optimizer's state in place.
    Before capture the step runs once on a side stream (cuBLAS, the
    autograd engine and the kernels' one-time attributes initialise
    there), and the state is put back as it was, so the warm-up takes no
    step of the trajectory. A capture that fails raises with its reason.
    ``replays`` counts the replays, so that a graph's kernel nodes times
    its replays are the launches it made."""

    def __init__(self, body, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor, seed_len: int, update: bool, pool,
                 debug: bool = False):
        device = images.device
        self.images = images.clone()
        self.labels = labels.clone()
        self.seeds = (torch.zeros(seed_len, dtype=torch.uint32,
                                  device=device) if seed_len else None)
        saved = [t.detach().clone() for t in _state_tensors(state)]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(state, self.images, self.labels, self.seeds, update)
            with torch.no_grad():
                for tensor, value in zip(_state_tensors(state), saved):
                    tensor.copy_(value)
        torch.cuda.current_stream(device).wait_stream(side)
        del saved
        # Debug mode keeps the captured cudaGraph_t beside the executable
        # one, so that graph.debug_dump(path) can print its nodes.
        self.graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            self.graph.enable_debug_mode()
        try:
            # thread_local: a checkpoint writer thread waiting on its event
            # meanwhile does not invalidate the capture.
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.loss = body(state, self.images, self.labels,
                                 self.seeds, update)
        except Exception as exc:
            raise RuntimeError(
                f"capturing the train step as a CUDA graph failed: {exc}"
            ) from exc
        if debug:
            self.graph.instantiate()
        self.replays = 0

    def replay(self, images, labels, seeds, loss_out) -> None:
        """Copy the step's inputs into the static buffers (device copies on
        the current stream), replay, and copy the loss to ``loss_out``."""
        self.images.copy_(images)
        self.labels.copy_(labels)
        if self.seeds is not None:
            self.seeds.copy_(seeds)
        self.graph.replay()
        self.replays += 1
        loss_out.copy_(self.loss)


def make_multi_step(config: DetectorConfig, loss_config: LossConfig,
                    optimizer: Adam, debug_graphs: bool = False, mesh=None):
    """``multi_step(state, images_stack, labels_stack, n_epochs) -> (state,
    epoch_losses)``: ``n_epochs * batches`` train steps over the stacked
    batches (step i takes batch ``i % batches``), the counterpart of the
    JAX ``make_multi_step`` scan. ``epoch_losses`` is an ``(n_epochs,)``
    fp32 tensor on the device, the mean of each epoch's step losses.

    With dropout, the window's seed rows are drawn ahead from
    ``state["dropout_rng"]``, the same draws the per-step loop makes, and
    copied to the device once per window; ``multi_step.seed_rows`` keeps
    the last window's rows (host).

    On CUDA the step is captured once per (state, batch shape, update
    flag) as a CUDA graph and replayed: per step, device copies of batch
    and seed row into its static buffers, one launch, and the loss copied
    into a device buffer; the host syncs once, when the caller reads the
    losses. With ``accumulate_steps > 1`` a micro-step graph and an
    update-step graph replay in the pattern the host knows from the step
    count. A graph is captured anew when the state's tensors are other
    tensors than at its capture (a restore that rebinds them).
    ``multi_step.graphs`` holds the live ones (``_StepGraph``, by key);
    ``debug_graphs`` captures them in debug mode, so that
    ``graph.debug_dump(path)`` can list their kernel nodes. On the CPU the
    same step body runs eagerly.

    Under ``mesh`` the body's collectives (the loss's counts, the flat
    gradient all-reduce, the ring's exchanges) are captured with it when
    the mesh's groups run on NCCL, on the capture stream; gloo's
    collectives cannot be captured, so under gloo the body runs eagerly
    on CUDA too."""
    body = make_step_body(config, loss_config, optimizer, mesh)
    capture = mesh is None or collectives.uses_nccl(
        axis_group(mesh, DATA_AXIS))
    seed_len = seed_table_size(config) if config.dropout else 0
    graphs: Dict[Any, _StepGraph] = {}
    pool = []   # one memory pool for all of them, made at first capture

    def multi_step(state: TrainState, images_stack: torch.Tensor,
                   labels_stack: torch.Tensor, n_epochs: int):
        batches = images_stack.shape[0]
        steps = n_epochs * batches
        device = images_stack.device
        rows = (np.stack([draw_seed_row(state, config)
                          for _ in range(steps)]) if seed_len else None)
        multi_step.seed_rows = rows
        seeds = None if rows is None else _to_device_async(rows, device)
        losses = torch.empty(steps, dtype=torch.float32, device=device)
        graphed = device.type == "cuda" and capture
        if graphed:
            fingerprint = tuple(t.data_ptr() for t in _state_tensors(state))
            for key in [k for k in graphs if k[0] != fingerprint]:
                del graphs[key]
            if not pool:
                pool.append(torch.cuda.graph_pool_handle())
            shapes = (tuple(images_stack.shape[1:]), images_stack.dtype,
                      tuple(labels_stack.shape[1:]), labels_stack.dtype)
        for i in range(steps):
            images = images_stack[i % batches]
            labels = labels_stack[i % batches]
            row = None if seeds is None else seeds[i]
            update = optimizer.is_update_step(state["step"])
            if graphed:
                key = (fingerprint, shapes, update)
                if key not in graphs:
                    graphs[key] = _StepGraph(body, state, images, labels,
                                             seed_len, update, pool[0],
                                             debug_graphs)
                graphs[key].replay(images, labels, row, losses[i])
            else:
                losses[i] = body(state, images, labels, row, update)
            state["step"] += 1
        return state, losses.reshape(n_epochs, batches).mean(dim=1)

    multi_step.seed_rows = None
    multi_step.graphs = graphs
    return multi_step


def make_eval_step(config: DetectorConfig, mesh=None):
    """Forward + decode -> ``(B, max_objects, 6)`` decoded predictions
    (under ``mesh``, of this rank's shard)."""

    @torch.inference_mode()
    def eval_step(params, images):
        logits = forward(params, _maybe_normalize(images), config,
                         mesh=mesh)
        return transform_predictions(logits, config)

    return eval_step


def make_predict_step(config: DetectorConfig):
    """Forward returning raw logits (the reference's model.predict)."""

    @torch.inference_mode()
    def predict_step(params, images):
        return forward(params, _maybe_normalize(images), config)

    return predict_step


def zero_padded_rows(decoded: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Decoded predictions of padded eval rows set to 0: objectness 0 is
    below every positivity threshold, so the metric ignores them."""
    return torch.where(valid[:, None, None], decoded, 0.0)


def _to_device(array, device) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return torch.from_numpy(np.asarray(array)).to(device)


def evaluate_map(params, dataset: Iterable, config: DetectorConfig,
                 eval_step=None, metric=None, device=None,
                 mesh=None) -> float:
    """The streaming mAP over ``dataset``: batches of ``(images, labels)``,
    or ``(images, labels, valid)`` whose rows with ``valid`` False are
    padding and leave the metric unchanged.

    Under ``mesh`` the dataset is this rank's shard: the rounds are kept
    in lockstep and padded across ranks
    (parallel/data.py:synced_global_eval_batches), and each round's
    decoded predictions, labels and valid mask are gathered over 'data'
    in global row order, so every rank updates the metric with the global
    batch, alike (the metric's state depends on the order of the
    images)."""
    device = (next(params.parameters()).device if device is None
              else resolve_device(device))
    if eval_step is None:
        eval_step = make_eval_step(config, mesh)
    if metric is None:
        metric = DeviceMeanAveragePrecision(config, device)
    # The NumPy oracle (Trainer(fast_metric=False)) takes host arrays.
    host_metric = not isinstance(metric, DeviceMeanAveragePrecision)
    metric.reset_state()
    group = axis_group(mesh, DATA_AXIS)
    if mesh is not None:
        dataset = synced_global_eval_batches(mesh, dataset, device)
    for batch in dataset:
        images, labels = batch[0], batch[1]
        decoded = eval_step(params, _to_device(images, device))
        if len(batch) > 2 and batch[2] is not None:
            decoded = zero_padded_rows(
                decoded, _to_device(batch[2], device).bool())
        if mesh is not None:
            decoded = collectives.all_gather_cat(decoded, 0, group)
            labels = collectives.all_gather_cat(
                _to_device(labels, device).float(), 0, group)
            if host_metric:
                labels = labels.cpu().numpy()
        metric.update_state(labels,
                            decoded.cpu().numpy() if host_metric else decoded,
                            use_transform_predictions=False)
    return float(metric.result())


class MetricsWriter:
    """Structured jsonl metrics, one record per epoch."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def write(self, **record):
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


class Trainer:
    """End-to-end training loop (the reference notebook's fit loop and
    its SaveModelHighestAP callback)."""

    def __init__(self,
                 config: DetectorConfig,
                 loss_config: LossConfig = LossConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 steps_per_epoch: int = 1,
                 mesh=None,
                 checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 fast_metric: bool = True,
                 async_checkpointing: bool = False,
                 keep_checkpoints: Optional[int] = None,
                 check_weights_every: Optional[int] = None,
                 check_weights_start: int = 0,
                 weight_threshold: float = 1.0,
                 device="cuda"):
        self.config = config
        self.loss_config = loss_config
        self.train_config = train_config
        self.mesh = mesh
        # One card per process under a mesh: "cuda" is LOCAL_RANK's.
        self.device = (resolve_device(device) if mesh is None
                       else resolve_device(rank_device(device)))
        # Rank 0 writes checkpoints and metrics (every rank computes the
        # same replicated values).
        self.primary = mesh is None or torch.distributed.get_rank() == 0
        self.checkpoint_dir = checkpoint_dir
        self.optimizer = Adam(train_config, steps_per_epoch)
        self.train_step = make_train_step(config, loss_config,
                                          self.optimizer, mesh)
        self.eval_step = make_eval_step(config, mesh)
        if fast_metric:
            self.metric = DeviceMeanAveragePrecision(config, self.device)
        else:
            self.metric = MeanAveragePrecision(config)
        self.metrics = MetricsWriter(metrics_path if self.primary else None)
        # Async checkpointing: saves overlap training (the loop pays only
        # the device->host snapshot); fit() joins pending writes on exit.
        self._async_ckpt = (ckpt_lib.AsyncCheckpointManager()
                            if async_checkpointing else None)
        # The windowed loop of fit(epochs_per_call > 1): make_multi_step,
        # built at first use (a caller may set its own); it keeps its
        # captured graphs between fit calls.
        self.multi_step = None
        # Rolling history: each periodic save also writes a step-stamped
        # checkpoint, pruned to the newest ``keep_checkpoints``.
        self.keep_checkpoints = keep_checkpoints
        # CheckModelWeight twin: on a cadence, report new parameter
        # extrema beyond +-weight_threshold.
        self.check_weights_every = check_weights_every
        self.check_weights_start = check_weights_start
        self._weight_watermarks = [-weight_threshold, weight_threshold]
        self.best_ap = 0.0
        self.ap_record = []
        self.loss_record = []
        # The windowed loop's windows, as (first epoch, epochs).
        self.window_record = []
        # Resume position of a stateful dataset (ResumableDataset) as of
        # the batch the trainer last consumed (kept by _device_prefetch,
        # saved beside every checkpoint, read back by restore; the caller
        # applies it with dataset.set_state).
        self.dataset_resume_state = None

    # ------------------------------------------------------------------
    @property
    def tensor_parallel(self) -> bool:
        """Whether the mesh's 'model' axis carries tensor parallelism (the
        parameters and moments then live as each rank's slices)."""
        return model_axis_role(self.mesh, self.config) == "tensor"

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Parameters from ``seed`` (default ``TrainConfig.seed``), fresh
        Adam state, and the dropout seed chain (``TrainConfig.seed + 1``).
        Under a mesh the full parameters are synchronised from rank 0 and
        then, under tensor parallelism, cut to this rank's slices, on
        which the Adam state is made."""
        generator = torch.Generator().manual_seed(
            self.train_config.seed if seed is None else seed)
        params = init_params(self.config, generator, self.device)
        self._sync_tensors(list(params.parameters()))
        if self.tensor_parallel:
            shard_params(params, self.mesh)
            self.optimizer.shards = shard_layout(params, self.mesh)
        return {"params": params,
                "opt_state": self.optimizer.init(
                    dict(params.named_parameters())),
                "step": 0,
                "dropout_rng": torch.Generator().manual_seed(
                    self.train_config.seed + 1)}

    def load_params(self, state: TrainState, params) -> None:
        """Copy a full-shape model's (or state dict's) parameters into the
        live ones, each rank taking its slices under tensor parallelism."""
        full = params.state_dict() if isinstance(params, torch.nn.Module) \
            else params
        if self.tensor_parallel:
            full = slice_tensors(full, state["params"], self.mesh)
        state["params"].load_state_dict(full)

    @torch.no_grad()
    def _sync_tensors(self, tensors) -> None:
        """Under a mesh: rank 0's full parameters to every rank (one flat
        broadcast), then a checksum of them compared across the ranks,
        which raises if any rank holds others."""
        if self.mesh is None:
            return
        flat = collectives.broadcast_(
            torch.cat([t.reshape(-1) for t in tensors]), src=0)
        for tensor, part in zip(tensors, flat.split(
                [t.numel() for t in tensors])):
            tensor.copy_(part.view_as(tensor))
        positions = torch.arange(1, flat.numel() + 1, device=flat.device,
                                 dtype=torch.float64)
        checksum = torch.stack([flat.double().sum(),
                                (flat.double() * positions).sum()])
        sums = torch.stack(collectives.all_gather(checksum))
        if not bool((sums == sums[0]).all()):
            raise RuntimeError(
                "the ranks hold different parameters after the broadcast "
                f"from rank 0 (checksums {sums.tolist()})")

    def _put_batch(self, images, labels):
        return (_to_device(images, self.device),
                _to_device(labels, self.device))

    def _device_prefetch(self, iterator):
        """Yield device batches one step ahead: the copy of batch i + 1
        (from pinned memory, on a side stream) overlaps the train step on
        batch i. The lookahead advances a ResumableDataset past the batch
        being trained, so the dataset's state as of each yielded batch
        goes to ``self.dataset_resume_state``."""
        get_state = getattr(iterator, "get_state", None)
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put(images, labels):
            if not cuda:
                return self._put_batch(images, labels), None
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                batch = tuple(_to_device_async(np.asarray(a), self.device)
                              for a in (images, labels))
                event = torch.cuda.Event()
                event.record(stream)
            return batch, event

        def ready(entry):
            (batch, event), snapshot = entry
            if event is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(event)
                for t in batch:
                    t.record_stream(main)
            if snapshot is not None:
                self.dataset_resume_state = snapshot
            return batch

        previous = None
        for images, labels in iterator:
            current = (put(images, labels),
                       get_state() if callable(get_state) else None)
            if previous is not None:
                yield ready(previous)
            previous = current
        if previous is not None:
            yield ready(previous)

    def fit(self, state: TrainState, train_data, epochs: int,
            eval_data=None, epochs_per_call: int = 1) -> TrainState:
        """Epoch loop with warm-up-gated periodic eval and best-AP
        checkpoint. A list of batches is moved to the device once; another
        dataset streams through ``_device_prefetch``.

        ``epochs_per_call > 1`` (materialized datasets only) runs up to
        that many epochs per call of ``make_multi_step`` (a CUDA graph
        replayed step after step on the card), with one host sync per
        window. The eval, checkpoint and weight-check cadences are exact:
        a window ends at every epoch one of them fires on. Pending async
        checkpoint writes are joined on exit."""
        tic = time.time()
        self.window_record = []
        materialized = isinstance(train_data, (list, tuple))
        try:
            if epochs_per_call > 1:
                if not materialized:
                    raise ValueError(
                        "epochs_per_call > 1 requires a materialized "
                        "dataset (a list of (images, labels) batches): a "
                        "streaming dataset cannot be stacked on the device "
                        "for the window")
                return self._fit_windowed(state, train_data, epochs,
                                          eval_data, epochs_per_call, tic)
            if materialized:
                train_data = [self._put_batch(*batch) for batch in train_data]
            return self._fit_loop(state, train_data, epochs, eval_data,
                                  materialized, tic)
        finally:
            self.wait_for_checkpoints()

    def _fit_loop(self, state, train_data, epochs, eval_data, materialized,
                  tic) -> TrainState:
        for epoch in range(epochs):
            epoch_losses = []
            epoch_data = (train_data if materialized
                          else self._device_prefetch(train_data))
            for images, labels in epoch_data:
                state, loss = self.train_step(state, images, labels)
                epoch_losses.append(loss)
            if not epoch_losses:
                try:
                    n = len(train_data)
                except TypeError:
                    n = None
                if n == 0:
                    raise ValueError(
                        "train_data is empty: no image paths matched, or "
                        "batch_size exceeds the dataset size (an "
                        "incomplete final batch is dropped)")
                raise ValueError(
                    f"train_data yielded no batches in epoch {epoch}; pass "
                    "a re-iterable dataset (a list of batches or a dataset "
                    "object), not a one-shot generator that is already "
                    "exhausted")
            epoch_loss = float(torch.stack(epoch_losses).mean())
            self._epoch_tail(state, epoch, epochs, eval_data, epoch_loss,
                             tic)
        return state

    def _fit_windowed(self, state, train_data, epochs, eval_data,
                      epochs_per_call, tic) -> TrainState:
        """fit()'s windowed loop (the JAX ``_fit_scanned``): stack the
        batches on the device once, then run each window of epochs as one
        ``make_multi_step`` call. Windows end exactly at event epochs, so
        what ``_epoch_tail`` sees matches the per-epoch loop; the dropout
        seeds are the draws the loop would make."""
        if not train_data:
            raise ValueError(
                "train_data is empty: no image paths matched, or "
                "batch_size exceeds the dataset size (an incomplete "
                "final batch is dropped)")
        shapes = {(tuple(b[0].shape), tuple(b[1].shape)) for b in train_data}
        if len(shapes) > 1:
            raise ValueError(
                "epochs_per_call > 1 requires uniform batch shapes to "
                f"stack the dataset for the window; got {sorted(shapes)}. "
                "Drop or pad the ragged final batch, or use "
                "epochs_per_call=1 (the per-epoch loop handles ragged "
                "batches).")
        def stack(i):
            # Stacked where the batches lie, then moved once: the device
            # holds one copy of the data.
            parts = [b[i] if isinstance(b[i], torch.Tensor)
                     else torch.from_numpy(np.asarray(b[i]))
                     for b in train_data]
            return torch.stack(parts).to(self.device)

        images_stack, labels_stack = stack(0), stack(1)
        if self.multi_step is None:
            self.multi_step = make_multi_step(self.config, self.loss_config,
                                              self.optimizer, mesh=self.mesh)
        has_eval = eval_data is not None
        epoch = 0
        while epoch < epochs:
            window = min(epochs_per_call, epochs - epoch)
            for j in range(window):
                if self._is_event_epoch(epoch + j, epochs, has_eval):
                    window = j + 1
                    break
            state, losses = self.multi_step(state, images_stack,
                                            labels_stack, window)
            losses = losses.tolist()   # one host sync per window
            self.window_record.append((epoch, window))
            for j in range(window):
                self._epoch_tail(state, epoch + j, epochs, eval_data,
                                 float(losses[j]), tic)
            epoch += window
        return state

    def _weight_check_due(self, epoch: int) -> bool:
        return bool(self.check_weights_every
                    and epoch >= self.check_weights_start
                    and (epoch - self.check_weights_start)
                    % self.check_weights_every == 0)

    def _eval_due(self, epoch: int) -> bool:
        # skip_epochs <= 0 disables the periodic cadence.
        tc = self.train_config
        return (tc.skip_epochs > 0
                and epoch >= tc.epochs_warm_up
                and (epoch - tc.epochs_warm_up) % tc.skip_epochs == 0)

    def _ckpt_due(self, epoch: int, epochs: int) -> bool:
        # The final-epoch checkpoint always fires; skip_epochs <= 0
        # disables only the periodic ones.
        tc = self.train_config
        return bool(self.checkpoint_dir
                    and ((tc.skip_epochs > 0
                          and epoch % tc.skip_epochs == 0)
                         or epoch == epochs - 1))

    def _is_event_epoch(self, epoch: int, epochs: int,
                        has_eval: bool) -> bool:
        """True when _epoch_tail does more than record the loss at this
        epoch: the windowed loop must end a window there. It shares the
        three predicates with _epoch_tail, so the two cannot drift."""
        return (self._weight_check_due(epoch)
                or (has_eval and self._eval_due(epoch))
                or self._ckpt_due(epoch, epochs))

    def _epoch_tail(self, state: TrainState, epoch: int, epochs: int,
                    eval_data, epoch_loss: float, tic: float) -> None:
        """After an epoch's steps: loss record, weight watchdog, warm-up-
        gated eval + best-AP save, periodic "ongoing"/rolling checkpoints,
        metrics record."""
        self.loss_record.append(epoch_loss)
        record = {"epoch": epoch, "loss": epoch_loss,
                  "wall_s": time.time() - tic}
        if self._weight_check_due(epoch):
            record.update(self._check_weights(state["params"], epoch))
        if eval_data is not None and self._eval_due(epoch):
            ap = evaluate_map(state["params"], eval_data, self.config,
                              self.eval_step, self.metric, self.device,
                              self.mesh)
            self.ap_record.append(ap)
            record["ap"] = ap
            if ap > self.best_ap:
                self.best_ap = ap
                if self.checkpoint_dir:
                    self.save(state, name="highest_ap")
        # Crash-resumability does not wait for eval or the warm-up: the
        # periodic checkpoints run on their own cadence from epoch 0.
        if self._ckpt_due(epoch, epochs):
            self.save(state, name="ongoing")
            if self.keep_checkpoints:
                self.save_rolling(state)
        self.metrics.write(**record)

    # ------------------------------------------------------------------
    def _full_state(self, state: TrainState) -> Optional[Dict]:
        """Under tensor parallelism: the full parameters and Adam moments
        (gathered over 'model' on every rank, a collective), else None."""
        if not self.tensor_parallel:
            return None
        model = state["params"]
        opt_state = dict(state["opt_state"])
        for key in ("mu", "nu", "acc"):
            if key in opt_state:
                opt_state[key] = gather_tensors(opt_state[key], model,
                                                self.mesh)
        return {"params": gather_tensors(dict(model.state_dict()), model,
                                         self.mesh),
                "opt_state": opt_state}

    def save(self, state: TrainState, name: str = "ongoing") -> None:
        """Checkpoint ``name`` (with config.json and the dataset sidecar).
        Under a mesh rank 0 writes and the other ranks wait for a
        synchronous write here, for an asynchronous one in
        ``wait_for_checkpoints``; under tensor parallelism every rank
        first takes part in gathering the full state."""
        full = self._full_state(state)
        if not self.primary:
            if self._async_ckpt is None:
                collectives.barrier()
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        config_path = os.path.join(self.checkpoint_dir, "config.json")
        if not os.path.exists(config_path):
            # The run is reproducible from its checkpoint dir alone.
            save_configs(config_path, self.config, self.loss_config,
                         self.train_config)
        path = ckpt_lib.checkpoint_path(self.checkpoint_dir, name)
        payload = ckpt_lib.train_state_payload(
            state, self.best_ap, self.config, self.loss_config,
            self.train_config)
        if full is not None:
            payload.update(full)
        if self._async_ckpt is not None:
            self._async_ckpt.save(path, payload)
        else:
            ckpt_lib.write_payload(path, payload)
        self._save_dataset_state(name)
        if self.mesh is not None and self._async_ckpt is None:
            collectives.barrier()

    def _save_dataset_state(self, name: str) -> None:
        """The input-stream position beside checkpoint ``name``
        (``<name>.dataset.json``, written at once: a few bytes). Without a
        position, a stale sidecar of an earlier run under that name is
        removed, so it cannot pose as this run's."""
        sidecar = ckpt_lib.dataset_sidecar_path(self.checkpoint_dir, name)
        if self.dataset_resume_state is None:
            if os.path.exists(sidecar):
                os.remove(sidecar)
            return
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.dataset_resume_state, f)
        os.replace(tmp, sidecar)

    def save_rolling(self, state: TrainState) -> str:
        """Step-stamped checkpoint, then prune to the newest
        ``keep_checkpoints`` (an async write still in flight holds one of
        the slots)."""
        step = int(state["step"])
        name = ckpt_lib.step_checkpoint_name(step)
        self.save(state, name=name)
        if self.keep_checkpoints and self.primary:
            ckpt_lib.prune_checkpoints(
                self.checkpoint_dir, self.keep_checkpoints,
                pending_step=step if self._async_ckpt is not None else None)
        return ckpt_lib.checkpoint_path(self.checkpoint_dir, name)

    def wait_for_checkpoints(self) -> None:
        """Join pending async checkpoint writes (fit() does this on exit;
        call it after explicit save() calls before reading the files)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
            if self.mesh is not None:
                collectives.barrier()

    def _config_mismatch_hint(self) -> Optional[str]:
        """Why a restore failed, when the checkpoint directory's own
        config.json disagrees with the live DetectorConfig."""
        config_path = os.path.join(self.checkpoint_dir, "config.json")
        if not os.path.exists(config_path):
            return None
        try:
            saved, _, _ = load_configs(config_path)
        except (OSError, ValueError, TypeError, KeyError):
            return None
        if saved == self.config:
            return None
        diffs = [
            f"{f.name}: checkpoint={getattr(saved, f.name)!r} "
            f"current={getattr(self.config, f.name)!r}"
            for f in dataclasses.fields(self.config)
            if getattr(saved, f.name) != getattr(self.config, f.name)]
        return ("The checkpoint directory's config.json does not match "
                "the current DetectorConfig — differing fields: "
                + "; ".join(diffs)
                + ". Load the run's own config (config.load_configs) or "
                "pass the matching preset/overrides.")

    def restore(self, state: TrainState, name: str = "ongoing") -> TrainState:
        """Load checkpoint ``name`` into ``state`` and return it; ``best_ap``
        comes back too, and the input position of a sidecar, if there is
        one. Parameters and optimizer tensors are overwritten in place, so
        a captured train-step graph stays valid. Pending async writes are
        joined first."""
        self.wait_for_checkpoints()
        path = ckpt_lib.checkpoint_path(self.checkpoint_dir, name)
        try:
            payload = ckpt_lib.load_train_state(path, self.device)
            opt_state = payload["opt_state"]
            live = state["opt_state"]
            if opt_state["order"] != live["order"]:
                raise ValueError(
                    f"{path}: optimizer state is for other parameters")
            if set(opt_state) != set(live):
                raise ValueError(
                    f"{path}: optimizer state holds {sorted(opt_state)}, "
                    f"this optimizer {sorted(live)} (another "
                    "accumulate_steps?)")
            # The file holds full shapes (gathered under tensor
            # parallelism): rank 0's are every rank's, and each keeps its
            # slices.
            self._sync_tensors(list(payload["params"].values()))
            self.load_params(state, payload["params"])
        except Exception as exc:
            hint = self._config_mismatch_hint()
            if hint:
                raise ValueError(f"{exc}\n{hint}") from exc
            raise
        with torch.no_grad():
            for key in ("mu", "nu", "acc"):
                moments = opt_state.get(key, {})
                if self.tensor_parallel:
                    moments = slice_tensors(moments, state["params"],
                                            self.mesh)
                for name_, value in moments.items():
                    live[key][name_].copy_(value)
            for key in ("count", "mini_step"):
                if key in opt_state:
                    live[key].copy_(torch.as_tensor(opt_state[key]))
        state["step"] = int(payload["step"])
        if "dropout_rng" in payload:
            state["dropout_rng"] = torch.Generator()
            state["dropout_rng"].set_state(payload["dropout_rng"].cpu())
        self.best_ap = float(payload["best_ap"])
        # Read only once the state restore succeeded: restore_latest probes
        # torn checkpoints, whose sidecar must not leak in.
        sidecar = ckpt_lib.dataset_sidecar_path(self.checkpoint_dir, name)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                self.dataset_resume_state = json.load(f)
        return state

    def restore_latest(self, state: TrainState) -> TrainState:
        """Resume from the newest readable step-stamped checkpoint, then
        older ones, then "ongoing" (a crash mid-write can leave the
        newest unreadable)."""
        candidates = [os.path.basename(path)[:-len(ckpt_lib.CHECKPOINT_SUFFIX)]
                      for _, path in reversed(
                          ckpt_lib.list_step_checkpoints(
                              self.checkpoint_dir))]
        candidates.append("ongoing")
        last_error: Optional[Exception] = None
        for name in candidates:
            try:
                return self.restore(state, name=name)
            except Exception as exc:  # partial/corrupt write: try older
                last_error = exc
                # logger, not print: CLI consumers parse stdout as JSON.
                logging.getLogger(__name__).warning(
                    "restore_latest: checkpoint %r unreadable (%s); "
                    "trying an older one.", name, exc)
        raise last_error

    @torch.no_grad()
    def _check_weights(self, params, epoch: int) -> Dict[str, float]:
        """CheckModelWeight: report when the max/min weight passes the
        previous watermark."""
        tensors = list(params.parameters())
        maxima = max(float(t.max()) for t in tensors)
        minima = min(float(t.min()) for t in tensors)
        logger = logging.getLogger(__name__)
        if maxima > self._weight_watermarks[1]:
            self._weight_watermarks[1] = maxima
            logger.info("Largest_weight changed to: %.3f, at epoch %d.",
                        maxima, epoch)
        elif minima < self._weight_watermarks[0]:
            self._weight_watermarks[0] = minima
            logger.info("Smallest_weight changed to: %.3f, at epoch %d.",
                        minima, epoch)
        return {"min_weight": minima, "max_weight": maxima}
