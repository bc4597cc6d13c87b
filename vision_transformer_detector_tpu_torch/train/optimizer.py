"""Optimiser stack: per-element gradient clip by value, Adam (eps 1e-7),
piecewise-constant LR decay, and the post-update weight constraint.

Counterpart of vision_transformer_detector_tpu/train/optimizer.py, whose
optax chain ``clip(10) -> adam(schedule, eps=1e-7)`` this module
reproduces step for step on plain tensors:
  * ``make_lr_schedule`` gives optax ``piecewise_constant_schedule``'s
    value (computed in fp32, as optax does) for every step count; a decay
    applies from its boundary step on;
  * ``Adam`` keeps optax's update order and bias correction
    (``mu_hat / (sqrt(nu_hat) + eps)``); its state is a plain dict of
    tensors, updated in place to save memory;
  * with ``adam_nu_dtype="bfloat16"`` the moments are stored in bf16 as
    ``scale_by_adam_compact`` stores them, with the same counter-hash
    stochastic rounding of nu, bit for bit;
  * ``clip_weights``: NaN -> 1, then clip to +-max_weight, on every
    parameter.
Gradient accumulation (optax.MultiSteps) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from ..config import TrainConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MASK32 = 0xFFFFFFFF


def make_lr_schedule(config: TrainConfig, steps_per_epoch: int = 1,
                     every_k: int = 1) -> Callable[[int], float]:
    """Step count -> learning rate, with the reference's cumulative epoch
    boundaries (deduplicated, truncated to ``allowed_decay_times``) and
    optax's arithmetic: the value is init * scale * ... in fp32, and a
    boundary's scale applies from that step count on."""
    epochs = [config.epochs_first_lr_decay]
    epochs.append(epochs[-1] + config.epochs_second_lr_decay)
    epochs.append(epochs[-1] + config.epochs_third_lr_decay)
    epochs = sorted(set(epochs))[: max(0, config.allowed_decay_times)]
    boundaries: dict = {}
    for e in epochs:
        step = (e * steps_per_epoch) // max(1, every_k)
        boundaries[step] = boundaries.get(step, 1.0) * config.rate_lr_decay
    thresholds = sorted(boundaries.items())
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


def rounding_bits(count: int, leaf_index: int, shape,
                  device) -> torch.Tensor:
    """The JAX package's counter hash for one moment leaf: a pure function
    of (step count, leaf index, element index), so replays and restores
    round identically."""
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)),
                       dtype=torch.int64, device=device).reshape(shape)
    x = (((count * 0x9E3779B1) & _MASK32)
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
    adam(schedule, eps))`` (or ``scale_by_adam_compact`` with reduced
    precision moments) on a dict of named parameters.

    Functional like optax: ``init(params)`` returns the state (a dict:
    ``count``, ``order``, ``mu``, ``nu``), which the caller keeps; ``step``
    updates the parameters and that state in place.
    """

    def __init__(self, config: TrainConfig, steps_per_epoch: int = 1):
        if config.accumulate_steps > 1:
            raise NotImplementedError(
                "gradient accumulation (accumulate_steps > 1) is not ported "
                "to PyTorch yet")
        if config.adam_mu_dtype and not config.adam_nu_dtype:
            # optax.adam(mu_dtype=...) rounds b1 * mu in the storage dtype
            # before the fp32 add; that path is not ported.
            raise NotImplementedError(
                "adam_mu_dtype without adam_nu_dtype is not ported to "
                "PyTorch yet; set both (--bf16-moments) or neither")
        self.schedule = make_lr_schedule(config, steps_per_epoch)
        self.clip_value = float(config.clip_gradient_value)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-7
        self.mu_dtype = _DTYPES[config.adam_mu_dtype or "float32"]
        self.nu_dtype = _DTYPES[config.adam_nu_dtype or "float32"]
        # bf16 nu: scale_by_adam_compact's stochastic rounding.
        self.stochastic_nu = self.nu_dtype == torch.bfloat16

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        order = jax_leaf_order(params)
        return {
            "count": 0,
            "order": order,
            "mu": {n: torch.zeros_like(params[n], dtype=self.mu_dtype)
                   for n in order},
            "nu": {n: torch.zeros_like(params[n], dtype=self.nu_dtype)
                   for n in order},
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict) -> None:
        # Both optax counters start at 0: the schedule reads the count
        # before this step, the bias correction the count after it.
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = state["count"]
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        c1 = float(np.float32(1.0) - b1 ** np.float32(count))
        c2 = float(np.float32(1.0) - b2 ** np.float32(count))
        for index, name in enumerate(state["order"]):
            g = grads[name].float().clamp(-self.clip_value, self.clip_value)
            mu = state["mu"][name].float() * self.b1 + (1.0 - self.b1) * g
            nu = (state["nu"][name].float() * self.b2
                  + (1.0 - self.b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            # Scale, then add: two roundings, as optax's updates and
            # apply_updates (add_'s alpha could fuse them into one).
            params[name].add_(update.mul_(-lr))
            state["mu"][name] = mu.to(self.mu_dtype)
            if self.stochastic_nu:
                bits = rounding_bits(count, index, nu.shape, nu.device)
                state["nu"][name] = stochastic_round_bf16(nu, bits)
            else:
                state["nu"][name] = nu.to(self.nu_dtype)


@torch.no_grad()
def clip_weights(params: Dict[str, torch.Tensor], max_weight: float) -> None:
    """ClipWeight on every parameter, in place: NaN -> 1, then clip to
    [-max_weight, max_weight]."""
    for p in params.values():
        torch.nan_to_num_(p, nan=1.0, posinf=float("inf"),
                          neginf=float("-inf"))
        p.clamp_(-max_weight, max_weight)

