"""Training loop: train/eval/predict steps, the epoch loop with the
reference's eval cadence, best-AP checkpoints and jsonl metrics.

Counterpart of vision_transformer_detector_tpu/train/trainer.py, on one
device (``device``, explicit). PyTorch runs eagerly, so the steps are
plain functions, and the train step updates the parameters and the
optimizer state in place (the JAX step returns new ones). The train state
is ``{"params": ViTDetector, "opt_state": dict, "step": int}``.

Not ported, and refused with NotImplementedError: ``epochs_per_call > 1``
(the device-resident scan), async checkpointing, gradient accumulation,
meshes and multi-process runs, and training-time dropout (the model
refuses it). Streaming datasets are consumed batch by batch; their
resume position is not checkpointed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import (
    DetectorConfig, LossConfig, TrainConfig, load_configs, save_configs)
from ..metrics.mean_average_precision import (
    MeanAveragePrecision)

from ..metrics.fast_map import DeviceMeanAveragePrecision
from ..models.vit_detector import forward, init_params
from ..ops.decode import transform_predictions
from ..ops.loss import detection_loss
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


def make_train_step(config: DetectorConfig, loss_config: LossConfig,
                    optimizer: Adam):
    """``train_step(state, images, labels) -> (state, loss)``: forward,
    loss, grads, clip + Adam, ClipWeight. Updates ``state`` in place."""
    config = train_config_view(config)

    def train_step(state: TrainState, images, labels):
        model = state["params"]
        params = dict(model.named_parameters())
        with torch.enable_grad():
            logits = forward(model, _maybe_normalize(images), config,
                             train=config.dropout is not None)
            loss = detection_loss(labels, logits, config, loss_config)
            grads = torch.autograd.grad(loss, list(params.values()))
        optimizer.step(params, dict(zip(params, grads)), state["opt_state"])
        if config.clip_weight:
            clip_weights(params, config.max_weight)
        state["step"] += 1
        return state, loss.detach()

    return train_step


def make_eval_step(config: DetectorConfig):
    """Forward + decode -> ``(B, max_objects, 6)`` decoded predictions."""

    @torch.inference_mode()
    def eval_step(params, images):
        logits = forward(params, _maybe_normalize(images), config)
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
                 eval_step=None, metric=None, device=None) -> float:
    """The streaming mAP over ``dataset``: batches of ``(images, labels)``,
    or ``(images, labels, valid)`` whose rows with ``valid`` False are
    padding and leave the metric unchanged."""
    if device is None:
        device = next(params.parameters()).device
    if eval_step is None:
        eval_step = make_eval_step(config)
    if metric is None:
        metric = DeviceMeanAveragePrecision(config, device)
    # The NumPy oracle (Trainer(fast_metric=False)) takes host arrays.
    host_metric = not isinstance(metric, DeviceMeanAveragePrecision)
    metric.reset_state()
    for batch in dataset:
        images, labels = batch[0], batch[1]
        decoded = eval_step(params, _to_device(images, device))
        if len(batch) > 2 and batch[2] is not None:
            decoded = zero_padded_rows(
                decoded, _to_device(batch[2], device).bool())
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
        for name, used in (("mesh", mesh is not None),
                           ("async_checkpointing", async_checkpointing)):
            if used:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported to PyTorch yet")
        self.config = config
        self.loss_config = loss_config
        self.train_config = train_config
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir
        self.optimizer = Adam(train_config, steps_per_epoch)
        self.train_step = make_train_step(config, loss_config,
                                          self.optimizer)
        self.eval_step = make_eval_step(config)
        if fast_metric:
            self.metric = DeviceMeanAveragePrecision(config, self.device)
        else:
            self.metric = MeanAveragePrecision(config)
        self.metrics = MetricsWriter(metrics_path)
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

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        generator = torch.Generator().manual_seed(
            self.train_config.seed if seed is None else seed)
        return create_train_state(self.config, self.optimizer, generator,
                                  self.device)

    def _put_batch(self, images, labels):
        return (_to_device(images, self.device),
                _to_device(labels, self.device))

    def fit(self, state: TrainState, train_data, epochs: int,
            eval_data=None, epochs_per_call: int = 1) -> TrainState:
        """Epoch loop with warm-up-gated periodic eval and best-AP
        checkpoint. A list of batches is moved to the device once."""
        if epochs_per_call > 1:
            raise NotImplementedError(
                "epochs_per_call > 1 (the device-resident multi-epoch "
                "window) is not ported to PyTorch yet")
        tic = time.time()
        materialized = isinstance(train_data, (list, tuple))
        if materialized:
            train_data = [self._put_batch(*batch) for batch in train_data]
        for epoch in range(epochs):
            epoch_losses = []
            for images, labels in train_data:
                if not materialized:
                    images, labels = self._put_batch(images, labels)
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
                              self.eval_step, self.metric, self.device)
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
    def save(self, state: TrainState, name: str = "ongoing") -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        config_path = os.path.join(self.checkpoint_dir, "config.json")
        if not os.path.exists(config_path):
            # The run is reproducible from its checkpoint dir alone.
            save_configs(config_path, self.config, self.loss_config,
                         self.train_config)
        ckpt_lib.save_train_state(
            ckpt_lib.checkpoint_path(self.checkpoint_dir, name), state,
            self.best_ap, self.config, self.loss_config, self.train_config)

    def save_rolling(self, state: TrainState) -> str:
        """Step-stamped checkpoint, then prune to the newest
        ``keep_checkpoints``."""
        name = ckpt_lib.step_checkpoint_name(state["step"])
        self.save(state, name=name)
        if self.keep_checkpoints:
            ckpt_lib.prune_checkpoints(self.checkpoint_dir,
                                       self.keep_checkpoints)
        return ckpt_lib.checkpoint_path(self.checkpoint_dir, name)

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
        """Load checkpoint ``name`` into ``state`` (parameters in place)
        and return it; ``best_ap`` comes back too."""
        path = ckpt_lib.checkpoint_path(self.checkpoint_dir, name)
        try:
            payload = ckpt_lib.load_train_state(path, self.device)
            state["params"].load_state_dict(payload["params"])
            opt_state = payload["opt_state"]
            if opt_state["order"] != state["opt_state"]["order"]:
                raise ValueError(
                    f"{path}: optimizer state is for other parameters")
        except Exception as exc:
            hint = self._config_mismatch_hint()
            if hint:
                raise ValueError(f"{exc}\n{hint}") from exc
            raise
        state["opt_state"] = opt_state
        state["step"] = int(payload["step"])
        self.best_ap = float(payload["best_ap"])
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
