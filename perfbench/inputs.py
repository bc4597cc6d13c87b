"""Seeded inputs and weights, made on the run's device in a few large draws.

Each stream (weights, images, labels, schedules) takes its own generator
seed, derived from ``--seed`` and the stream's name, so the same seed gives
the same inputs and one stream never shifts another.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from perfbench.reference import vit_detector as ref


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for ``stream`` under ``--seed``."""
    state = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), zlib.crc32(stream.encode())])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights: glorot-uniform kernels, uniform(-0.05, 0.05)
    position embedding, zero biases, unit / zero LayerNorms (keras'
    defaults), drawn as one uniform block and cut into leaves."""
    shapes = ref.param_shapes(cfg)
    drawn = [(n, s) for n, s in shapes
             if n.endswith(".kernel") or n == "position_embedding"]
    total = sum(int(np.prod(s)) for _, s in drawn)
    block = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=generator(seed, "weights", device))
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in shapes:
        if name.endswith(".kernel") or name == "position_embedding":
            size = int(np.prod(shape))
            limit = 0.05 if name == "position_embedding" \
                else ref.glorot_limit(shape)
            out[name] = block[offset:offset + size].view(shape) * limit
            offset += size
        elif name.endswith(".gamma"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def make_images(count: int, cfg: dict, seed: int, stream: str,
                device) -> torch.Tensor:
    """(count, H, W, 3) uint8 canvases."""
    h, w = cfg["image_size"]
    return torch.randint(0, 256, (count, h, w, 3), dtype=torch.uint8,
                         device=device,
                         generator=generator(seed, stream, device))


def make_labels(count: int, cfg: dict, seed: int, stream: str,
                device) -> torch.Tensor:
    """(count, max_objects, 6) labels as the data pipeline writes them:
    1 to max_objects objects an image in the first slots (objectness 1,
    class id, cx, cy, h, w in pixels), the other slots objectness 0 and
    -8 elsewhere."""
    g = generator(seed, stream, device)
    m = cfg["max_objects"]
    h, w = cfg["image_size"]
    n = torch.randint(1, m + 1, (count, 1), device=device, generator=g)
    positive = torch.arange(m, device=device)[None] < n
    u = torch.rand((count, m, 5), device=device, generator=g)
    box_h = 8.0 + u[..., 2] * (h / 2 - 8.0)
    box_w = 8.0 + u[..., 3] * (w / 2 - 8.0)
    cx = box_w / 2 + u[..., 0] * (w - box_w)
    cy = box_h / 2 + u[..., 1] * (h - box_h)
    cls = torch.floor(u[..., 4] * cfg["num_classes"]).clamp(
        max=cfg["num_classes"] - 1)
    labels = torch.stack([positive.float(), cls, cx, cy, box_h, box_w], -1)
    empty = torch.tensor([0.0, -8.0, -8.0, -8.0, -8.0, -8.0], device=device)
    return torch.where(positive[..., None], labels, empty)


def arrivals(rate: float, seconds: float, seed: int,
             stream: str = "serve") -> np.ndarray:
    """Due times (s from the window's start) of an open-loop schedule:
    round(rate * seconds) arrivals with exponential gaps, scaled so that
    the last gap ends at ``seconds``. Every seed offers the same count at
    the same mean rate, in another spacing."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(stream_seed(seed, stream + ".arrivals"))
    gaps = rng.exponential(1.0, n + 1)
    return (np.cumsum(gaps)[:n] / gaps.sum()) * seconds


def choice(count: int, population: int, seed: int, stream: str
           ) -> np.ndarray:
    """``count`` distinct indices of ``population`` (all when fewer),
    sorted."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    count = min(count, population)
    return np.sort(rng.choice(population, size=count, replace=False))


def pick(count: int, population: int, seed: int, stream: str) -> np.ndarray:
    """``count`` indices of ``population``, with repeats."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    return rng.integers(0, population, size=count)
