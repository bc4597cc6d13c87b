"""Operation and byte counts from shapes: the benchmark's own arithmetic.

``forward_flops`` is a frozen copy of the port's
``utils/profiling.py:flops_estimate`` (matrix products only, 2*M*N*K),
read from a configuration file's dict, so that a change to the program
cannot move the yardstick. The flash counts take each input read once and
each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

# Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _grid(cfg: dict):
    h, w = cfg["image_size"]
    p = cfg["patch_size"]
    return -(-h // p), -(-w // p)


def forward_flops(cfg: dict, batch_size: int = 1) -> float:
    """Analytic forward FLOPs of the detector (matrix products only)."""
    gh, gw = _grid(cfg)
    tokens = gh * gw
    d = cfg["embedding_dim"]
    h, k = cfg["num_heads"], cfg["key_dim"]
    patch_dim = cfg["patch_size"] ** 2 * 3

    flops = 2.0 * tokens * patch_dim * d

    per_block = 3 * 2.0 * tokens * d * h * k
    window = cfg.get("attention_window")
    if window:
        per_block += 2 * 2.0 * tokens * window ** 2 * h * k
    else:
        per_block += 2 * 2.0 * tokens * tokens * h * k
    per_block += 2.0 * tokens * h * k * d
    in_dim = d
    for units in [d * 2 ** i for i in range(cfg["encoder_mlp_layers"] - 1,
                                            -1, -1)]:
        per_block += 2.0 * tokens * in_dim * units
        in_dim = units
    flops += cfg["encoder_blocks"] * per_block

    m = cfg["max_objects"]
    scales = tuple(cfg.get("head_scales", (1,)))
    if scales == (1,):
        flops += 2.0 * tokens * d * m
        in_dim = tokens
    else:
        in_dim = 0
        for s in scales:
            pooled = (gh // s) * (gw // s)
            flops += 2.0 * pooled * d * m
            in_dim += pooled
    last = cfg["head_last_units"]
    for units in [last * 2 ** i for i in range(cfg["head_layers"] - 1, -1, -1)]:
        for _ in range(cfg["head_block_repeats"]):
            flops += 2.0 * m * in_dim * units
            in_dim = units
    flops += 2.0 * m * in_dim * 6
    return flops * batch_size


def flash_forward(bh: int, n: int, k: int, itemsize: int = 2,
                  with_lse: bool = False):
    """(ops, bytes) of one flash forward over (bh, n, k) q, k, v: S = QK^T
    and O = PV; q, k, v read, o (and the fp32 lse) written."""
    ops = 4.0 * bh * n * n * k
    nbytes = 4.0 * bh * n * k * itemsize + (4.0 * bh * n if with_lse else 0.0)
    return ops, nbytes


def flash_backward(bh: int, n: int, k: int, itemsize: int = 2):
    """(ops, bytes) of one flash backward: S again, dP, dV, dQ, dK (five
    products); q, k, v, dO, lse and delta read, dq, dk, dv written."""
    ops = 10.0 * bh * n * n * k
    nbytes = 7.0 * bh * n * k * itemsize + 2 * 4.0 * bh * n
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
