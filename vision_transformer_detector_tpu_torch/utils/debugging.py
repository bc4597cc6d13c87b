"""Numeric sanitizers and parameter watchdogs.

Counterpart of vision_transformer_detector_tpu/utils/debugging.py:
  * ``check_inf_nan`` (vision_transformer_detector.py:46-116) -> a
    host-side scan with optional NaN replacement, the JAX module's;
  * ``debug_check`` -> an eager check: PyTorch runs eagerly, so the
    report needs no in-graph print, only a read of one flag from the
    device;
  * ``param_extrema`` / ``check_params`` / ``param_norms`` over a model's
    parameters (the reference's ``CheckModelWeight`` / ``check_weights``,
    vtd.py:650-758), keyed by the JAX package's slash-joined names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

RED_LINE_WEIGHT = 500.0  # check_weights alert threshold (vtd.py:735)


def check_inf_nan(inputs, name: str, max_value: float = 50_000.0,
                  replace_nan=None):
    """Host-side inf/NaN scan with optional NaN replacement (vtd.py:46-116).

    Returns possibly-replaced inputs (a NumPy array where NaNs were
    replaced). Works on arrays, tensors or tuples of them."""
    if isinstance(inputs, tuple):
        return tuple(
            check_inf_nan(x, f"{name}_{i}", max_value, replace_nan)
            for i, x in enumerate(inputs))
    if isinstance(inputs, (int, float)):
        return inputs
    x = (inputs.detach().float().cpu().numpy() if torch.is_tensor(inputs)
         else np.asarray(inputs))
    if np.isinf(x).any():
        print(f"\nInf! Found in {name}, its shape: {x.shape}")
    nan_mask = np.isnan(x)
    if nan_mask.any():
        print(f"\nNaN! Found in {name}, its shape: {x.shape}")
        if replace_nan is not None:
            x = np.where(nan_mask, replace_nan, x)
            inputs = x
    finite = x[np.isfinite(x)]
    if finite.size and finite.max() > max_value:
        print(f"\nIn {name}, its shape: {x.shape}")
        print(f"max_value: {finite.max()}")
    return inputs


def debug_check(x: torch.Tensor, name: str) -> torch.Tensor:
    """Prints ``non-finite values in <name>`` when ``x`` holds an inf or a
    NaN, and returns ``x``. Reads one flag from x's device (a sync)."""
    if not bool(torch.isfinite(x).all()):
        print("non-finite values in " + name)
    return x


def _named_tensors(params):
    """(slash-joined name, tensor) for every parameter and buffer of a
    module, or every entry of a name -> tensor dict."""
    items = (params.state_dict().items()
             if isinstance(params, torch.nn.Module) else params.items())
    return [(name.replace(".", "/"), t) for name, t in items]


@torch.no_grad()
def param_extrema(params) -> Tuple[float, float]:
    """(min, max) over all the parameters (CheckModelWeight core,
    vtd.py:670-687)."""
    tensors = [t for _, t in _named_tensors(params)]
    maxima = max(float(t.max()) for t in tensors)
    minima = min(float(t.min()) for t in tensors)
    return minima, maxima


def check_params(params, red_line: float = RED_LINE_WEIGHT
                 ) -> Dict[str, float]:
    """Post-training weight check (check_weights, vtd.py:731-758)."""
    minima, maxima = param_extrema(params)
    report = {"min_weight": minima, "max_weight": maxima}
    if maxima > red_line:
        print(f"\nAlert! max_weight is: {maxima:.1f}\n"
              "Very high weight could lead to a big model output value, "
              "then cause the NaN loss. Please consider:\n"
              "1. use a smaller learning_rate;\n2. reduce the loss value.\n")
    return report


@torch.no_grad()
def param_norms(params) -> Dict[str, float]:
    """L2 norm of each parameter in fp32, keyed by its JAX path — the
    metrics-hook form of the watchdog (SURVEY.md §2.1 M18)."""
    return {name: float(torch.linalg.vector_norm(t.float()))
            for name, t in _named_tensors(params)}
