"""Optimiser stack: per-element gradient clip by value, Adam (eps 1e-7),
piecewise-constant LR decay, gradient accumulation, and the post-update
weight constraint.

Counterpart of vision_transformer_detector_tpu/train/optimizer.py, whose
optax chain ``clip(10) -> adam(schedule, eps=1e-7)`` (wrapped in
``optax.MultiSteps`` when ``accumulate_steps > 1``) this module
reproduces step for step on plain tensors:
  * ``make_lr_schedule`` gives optax ``piecewise_constant_schedule``'s
    value (computed in fp32, as optax does) for every step count; a decay
    applies from its boundary step on;
  * ``Adam`` keeps optax's update order and bias correction
    (``mu_hat / (sqrt(nu_hat) + eps)``); its state is a plain dict of
    tensors on the parameters' device, updated in place. The step count
    is a device tensor, and the learning rate and the bias corrections
    are computed from it on the device, so ``step`` has no host read and
    no host value baked in: a CUDA graph captured over it replays with
    each step's count;
  * with ``adam_nu_dtype="bfloat16"`` the moments are stored in bf16 as
    ``scale_by_adam_compact`` stores them, with the same counter-hash
    stochastic rounding of nu, bit for bit; ``adam_mu_dtype`` alone is
    ``optax.adam(mu_dtype=...)``: nu stays fp32, b1 * mu is taken with b1
    rounded to the storage dtype, in fp32, as XLA computes it;
  * ``accumulate_steps = k > 1`` is ``optax.MultiSteps``: the running mean
    of the micro-batch gradients in an fp32 buffer, the parameters frozen
    for k - 1 micro steps, then clip + Adam on the mean, with the schedule
    counting optimizer steps;
  * ``clip_weights``: NaN -> 1, then clip to +-max_weight, on every
    parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import TrainConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MASK32 = 0xFFFFFFFF


def _boundaries(config: TrainConfig, steps_per_epoch: int,
                every_k: int) -> list:
    """The schedule's sorted ``(threshold step, scale)`` pairs: the
    reference's cumulative epoch boundaries, deduplicated and truncated to
    ``allowed_decay_times``, in optimizer steps."""
    epochs = [config.epochs_first_lr_decay]
    epochs.append(epochs[-1] + config.epochs_second_lr_decay)
    epochs.append(epochs[-1] + config.epochs_third_lr_decay)
    epochs = sorted(set(epochs))[: max(0, config.allowed_decay_times)]
    boundaries: dict = {}
    for e in epochs:
        step = (e * steps_per_epoch) // max(1, every_k)
        boundaries[step] = boundaries.get(step, 1.0) * config.rate_lr_decay
    return sorted(boundaries.items())


def make_lr_schedule(config: TrainConfig, steps_per_epoch: int = 1,
                     every_k: int = 1) -> Callable[[int], float]:
    """Step count -> learning rate, with the reference's cumulative epoch
    boundaries and optax's arithmetic: the value is init * scale * ... in
    fp32, and a boundary's scale applies from that step count on."""
    thresholds = _boundaries(config, steps_per_epoch, every_k)
    init = np.float32(config.learning_rate)

    def schedule(count: int) -> float:
        value = init
        for threshold, scale in thresholds:
            if count >= threshold:
                value = np.float32(np.float32(scale) * value)
        return float(value)

    return schedule


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split c into 16-bit
    halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64, as the JAX
    package's ``_mix_u32``."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stochastic_round_bf16(x32: torch.Tensor,
                          bits: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 by adding the low 16 of ``bits`` to the fp32 bit
    pattern and truncating: unbiased, so sub-ulp updates accumulate."""
    u = x32.float().contiguous().view(torch.int32).to(torch.int64) & _MASK32
    u = ((u + (bits & 0xFFFF)) & _MASK32) & 0xFFFF0000
    # Back to a signed int32 bit pattern, then to the fp32 it encodes.
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32).to(torch.bfloat16)


def _flat_indices(shape, device, shard=None) -> torch.Tensor:
    """Each element's row-major flat index in its whole leaf: the leaf
    itself, or with ``shard = (full shape, axis, first)`` a slice of the
    full leaf along ``axis`` from ``first`` (a tensor-parallel rank's
    part, whose indices are not contiguous for a column slice)."""
    full, axis, first = shard if shard is not None else (shape, 0, 0)
    strides = np.cumprod((1,) + tuple(full[:0:-1]))[::-1]
    idx = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    for dim, (n, stride) in enumerate(zip(shape, strides)):
        r = torch.arange(n, dtype=torch.int64, device=device)
        if dim == axis:
            r = r + first
        idx += (r * int(stride)).reshape(
            [n if d == dim else 1 for d in range(len(shape))])
    return idx


def rounding_bits(count, leaf_index: int, shape, device,
                  shard=None) -> torch.Tensor:
    """The JAX package's counter hash for one moment leaf: a pure function
    of (step count, leaf index, element index), so replays and restores
    round identically. ``count`` is an integer or an int64 tensor (the
    optimizer's device count). ``shard`` (``_flat_indices``) hashes a
    slice of the leaf by its elements' indices in the whole leaf, so a
    tensor-parallel rank rounds its part as one process rounds it."""
    idx = _flat_indices(shape, device, shard)
    x = (_mul_u32(count & _MASK32, 0x9E3779B1)
         + ((leaf_index * 0x85EBCA6B) & _MASK32))
    x = (_mul_u32(idx, 0xC2B2AE35) + x) & _MASK32
    return _mix_u32(x)


def jax_leaf_order(names: Iterable[str]) -> List[str]:
    """Parameter names in the JAX package's pytree flatten order: dict
    keys sorted, list indices in order. The bf16 rounding hash keys off
    that order."""
    def key(name: str):
        return tuple(int(part) if part.isdigit() else part
                     for part in name.split("."))
    return sorted(names, key=key)


class Adam:
    """clip-by-value + Adam + schedule, optax's ``chain(clip(c),
    adam(schedule, eps))`` (or ``scale_by_adam_compact`` with bf16 nu), in
    ``MultiSteps`` with ``accumulate_steps > 1``, on a dict of named
    parameters.

    Functional like optax: ``init(params)`` returns the state (a dict:
    ``count``, ``order``, ``mu``, ``nu``, and with accumulation ``acc`` and
    ``mini_step``), which the caller keeps; ``step`` updates the
    parameters and that state in place, on their device, without reading
    anything back to the host.
    """

    def __init__(self, config: TrainConfig, steps_per_epoch: int = 1):
        self.every_k = max(1, int(config.accumulate_steps))
        self.schedule = make_lr_schedule(config, steps_per_epoch,
                                         every_k=self.every_k)
        self._thresholds = _boundaries(config, steps_per_epoch,
                                       self.every_k)
        self._init_lr = float(np.float32(config.learning_rate))
        self.clip_value = float(config.clip_gradient_value)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-7
        self.mu_dtype = _DTYPES[config.adam_mu_dtype or "float32"]
        self.nu_dtype = _DTYPES[config.adam_nu_dtype or "float32"]
        # bf16 nu: scale_by_adam_compact's stochastic rounding.
        self.stochastic_nu = self.nu_dtype == torch.bfloat16
        # Tensor parallelism's slices (trainer.py sets it): per parameter
        # name, (full shape, split axis, first index of this rank's slice).
        self.shards: Dict[str, tuple] = {}
        # A reduced-precision mu without nu is optax.adam(mu_dtype=...):
        # b1 * mu in the storage dtype's b1 (XLA keeps the product fp32).
        self._mu_b1 = (float(torch.tensor(self.b1, dtype=self.mu_dtype))
                       if config.adam_mu_dtype and not config.adam_nu_dtype
                       else self.b1)

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        order = jax_leaf_order(params)
        device = params[order[0]].device if order else torch.device("cpu")
        state = {
            "count": torch.zeros((), dtype=torch.int64, device=device),
            "order": order,
            "mu": {n: torch.zeros_like(params[n], dtype=self.mu_dtype)
                   for n in order},
            "nu": {n: torch.zeros_like(params[n], dtype=self.nu_dtype)
                   for n in order},
        }
        if self.every_k > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int64,
                                             device=device)
            state["acc"] = {n: torch.zeros_like(params[n],
                                                dtype=torch.float32)
                            for n in order}
        return state

    def is_update_step(self, step: int) -> bool:
        """Whether micro step ``step`` (the train state's step count, which
        advances once per micro batch) applies the accumulated update."""
        return step % self.every_k == self.every_k - 1

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at the device ``count``, in fp32 with optax's
        roundings: init, times each boundary's fp32 scale from its step
        on."""
        value = torch.full((), self._init_lr, dtype=torch.float32,
                           device=count.device)
        for threshold, scale in self._thresholds:
            value = torch.where(count >= threshold,
                                value * float(np.float32(scale)), value)
        return value

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict,
             update: Optional[bool] = None) -> None:
        """One (micro) step. Without accumulation every call updates. With
        it, ``grads`` join the running mean, and ``update`` (which the
        caller knows from its step count, ``is_update_step``) applies clip
        + Adam to the mean, clears it and leaves the parameters as they are
        otherwise: two code paths, never an update multiplied by 0."""
        if self.every_k == 1:
            self._apply(params, grads, state)
            return
        if update is None:
            raise ValueError("with accumulate_steps > 1, step() needs "
                             "update=optimizer.is_update_step(step)")
        # optax.MultiSteps' mean: acc + (g - acc) / (mini_step + 1).
        divisor = (state["mini_step"] + 1).float()
        for name in state["order"]:
            acc = state["acc"][name]
            acc.add_((grads[name].float() - acc) / divisor)
        if update:
            self._apply(params, state["acc"], state)
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"].zero_()
        else:
            state["mini_step"].add_(1)

    def _apply(self, params, grads, state) -> None:
        # Both optax counters start at 0: the schedule reads the count
        # before this step, the bias correction the count after it.
        count = state["count"]
        lr = self.learning_rate(count)
        count.add_(1)
        steps = count.float()
        # fp32 b ** count, made on the device (no host copy to capture).
        c1, c2 = (1.0 - torch.pow(torch.full((), float(np.float32(b)),
                                             device=count.device), steps)
                  for b in (self.b1, self.b2))
        for index, name in enumerate(state["order"]):
            g = grads[name].float().clamp(-self.clip_value, self.clip_value)
            mu = state["mu"][name].float() * self._mu_b1 + (1.0 - self.b1) * g
            nu = (state["nu"][name].float() * self.b2
                  + (1.0 - self.b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            # Scale, then add: two roundings, as optax's updates and
            # apply_updates (add_'s alpha could fuse them into one).
            params[name].add_(update.mul_(-lr))
            # In place: the moments keep their storage (a captured graph
            # writes to fixed addresses).
            state["mu"][name].copy_(mu)
            if self.stochastic_nu:
                bits = rounding_bits(count, index, nu.shape, nu.device,
                                     self.shards.get(name))
                state["nu"][name].copy_(stochastic_round_bf16(nu, bits))
            else:
                state["nu"][name].copy_(nu)


@torch.no_grad()
def clip_weights(params: Dict[str, torch.Tensor], max_weight: float) -> None:
    """ClipWeight on every parameter, in place: NaN -> 1, then clip to
    [-max_weight, max_weight]."""
    for p in params.values():
        torch.nan_to_num_(p, nan=1.0, posinf=float("inf"),
                          neginf=float("-inf"))
        p.clamp_(-max_weight, max_weight)

