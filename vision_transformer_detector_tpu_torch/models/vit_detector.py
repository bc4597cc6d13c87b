"""ViT detector forward in PyTorch: patchify -> encoder -> detection head.

Counterpart of vision_transformer_detector_tpu/models/vit_detector.py,
for inference and training. Parameters live in ``nn.Module``s whose attribute names
and tensor layouts are the JAX package's: dense kernels are ``(in, out)``,
attention q/k/v kernels ``(D, H, K)``, the attention output kernel
``(H, K, D)`` and the position embedding ``(P, 1)``. A state-dict name is
therefore the JAX parameter path with ``.`` for ``/``
(``encoder.0.mha.query.kernel``), which is all the weight bridge
(utils/checkpoint.py) needs.

Numerics follow the JAX forward cast for cast: matmuls take
``config.compute_dtype`` operands, bias adds, layer norms and softmax
statistics run in fp32, and each op's output is cast back to the compute
dtype where the JAX forward casts it. One difference is inherent: with
bf16 operands, ``torch.matmul`` rounds its fp32 accumulator to bf16
before the fp32 bias add, where XLA rounds once after it. In fp32 the two
agree to summation order.

Attention routes through kernels/flash_attention.py when
``config.use_flash_attention`` is set (the Hopper kernels for CUDA
tensors; differentiable, with a backward kernel), and through an
explicit matmul + softmax otherwise — the JAX einsum path. Both routes
train; the trainer applies ``train_use_flash_attention`` to the config
it trains with, so eval keeps the preset's route.

The opt-in kernels route as in the JAX forward: ``use_fused_ffn`` sends
the mish pyramid layers through kernels/fused_ffn.py (differentiable),
``use_fused_layer_norm`` sends inference LayerNorms with D % 128 == 0
through kernels/fused_ln.py, and a model from
kernels/quantization.py:quantize_params runs its dense layers through the
int8 kernels (serving only: ``train=True`` raises), with attention on the
tokens-major route.

Windowed attention (``attention_window``) orders the tokens window-major
once at the encoder's entry and back at its exit, as the JAX forward
does; heads-major attention folds the windows into the head axis
``(B, H * windows, tokens, K)`` (a copy: heads and windows have other
strides), tokens-major attention into the batch axis. The fold decides
the batch*head index that keys the attention dropout mask, so each route
folds as its JAX counterpart. ``head_scales`` other than ``(1,)`` is the
multi-scale head. ``remat_encoder`` checkpoints encoder blocks with
``torch.utils.checkpoint`` (non-reentrant) under the JAX policies.

Training dropout (``train=True`` with ``config.dropout``) needs a
``dropout_seed``: an integer, from which ``dropout_seeds`` derives one
seed per attention, MLP and head layer, that table (``DropoutSeeds``), or
the table as a uint32 tensor on the device (``seed_table``), which is the
form a CUDA graph over the train step reads. The forward hands each layer
a view of that tensor: attention dropout runs in the flash kernel, which
reads its seed from device memory (the JAX counter-hash mask, bit-equal to
JAX's for the same seed), or on the einsum route's probabilities; the MLP
and head masks are the same counter hash of the layer's seed and each
element's (row, column) index (kernels/dropout.py: one kernel pass on the
card that reads the seed from device memory, tensor ops on the CPU), so a
recomputed block, an eager step and a replayed graph draw the same masks.
They are another stream than JAX's threefry masks, of the same
Bernoulli(1 - rate).

``pad_attention_key_dim`` widens the attention head dim with zero columns,
as the JAX package's does; ``forward`` reads the physical head dim from
the weights and keeps ``config.key_dim`` for the softmax scale.

Under a mesh (``forward(..., mesh=...)``, parallel/mesh.py) this process
runs its shard of the global batch: the shards are the global batch's
rows in 'data' rank order, so every dropout mask (attention, MLP, head)
is keyed on the rows' GLOBAL batch coordinates and a data-parallel run
draws the masks one process draws over the whole batch. With
``ring_attention`` the attention of each block runs as ring attention
over the mesh's 'model' axis (kernels/ring_attention.py): the block's
input is sliced to this rank's tokens, projected, attended around the
ring, projected out and gathered back; everything outside attention is
replicated over 'model'. Without a mesh a ring config runs plain global
attention, as the JAX forward does.

Not ported, and rejected with NotImplementedError rather than run
differently: sequence sharding, and a model axis above 1 without
ring_attention (tensor parallelism; parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ..config import DetectorConfig
from ..kernels.dropout import dropout
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ffn import fused_dense_mish
from ..kernels.fused_ln import fused_layer_norm, layer_norm_reference
from ..kernels.quantization import fused_int8_dense, int8_dense, is_quantized
from ..kernels.ring_attention import (
    gather_tokens, ring_attention, shard_tokens, sum_grads_over)
from ..parallel.mesh import DATA_AXIS, axis_index, check_mesh_config
from ..utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"use one of {sorted(_DTYPES)}") from None


def check_supported(config: DetectorConfig) -> None:
    """Raise NotImplementedError for config features this port lacks."""
    unported = {
        "sequence_sharding": config.sequence_sharding,
    }
    missing = [name for name, used in unported.items() if used]
    if missing:
        raise NotImplementedError(
            f"config features not ported to PyTorch yet: {missing}")


def _validate_grid_config(config: DetectorConfig) -> None:
    """The JAX forward's grid-geometry checks, with its messages: a window
    or head scale must evenly divide the patch grid."""
    gh, gw = config.grid_size
    w = config.attention_window
    if config.ring_attention and w is not None:
        raise ValueError(
            "ring_attention and attention_window are mutually exclusive: "
            "with a mesh the ring path runs exact GLOBAL attention "
            "(window ignored) while meshless calls would run WINDOWED "
            "attention — the same weights would silently execute two "
            "different architectures. Set attention_window=None for the "
            "ring variant (see highres_1024_ring) or drop ring_attention "
            "for the windowed one.")
    if w is not None and (w <= 0 or gh % w or gw % w):
        raise ValueError(
            f"attention_window={w} must evenly divide the patch grid "
            f"{gh}x{gw} (image_size {config.image_size} / patch_size "
            f"{config.patch_size})")
    for s in config.head_scales:
        if s <= 0 or gh % s or gw % s:
            raise ValueError(
                f"head_scales entry {s} must evenly divide the patch "
                f"grid {gh}x{gw}; a non-divisor silently drops edge "
                "cells from the detection head")



# ---------------------------------------------------------------------------
# Modules (JAX parameter names and layouts)
# ---------------------------------------------------------------------------

def _as_shape(dims) -> tuple:
    return tuple(dims) if isinstance(dims, tuple) else (dims,)


class Dense(nn.Module):
    """kernel ``(*in_shape, *out_shape)``, bias ``out_shape``."""

    def __init__(self, in_shape, out_shape, dtype=torch.float32):
        super().__init__()
        in_shape, out_shape = _as_shape(in_shape), _as_shape(out_shape)
        self.kernel = nn.Parameter(torch.empty(in_shape + out_shape,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_shape, dtype=dtype))


class LayerNorm(nn.Module):
    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(dim, dtype=dtype))


class MultiHeadAttention(nn.Module):
    """keras MultiHeadAttention layout: q/k/v kernels (D, H, K) with (H, K)
    biases, output kernel (H, K, D) with a (D,) bias."""

    def __init__(self, dim, heads, head_dim, dtype=torch.float32):
        super().__init__()
        self.query = Dense(dim, (heads, head_dim), dtype)
        self.key = Dense(dim, (heads, head_dim), dtype)
        self.value = Dense(dim, (heads, head_dim), dtype)
        self.out = Dense((heads, head_dim), dim, dtype)


class EncoderBlock(nn.Module):
    def __init__(self, config: DetectorConfig, head_dim, dtype):
        super().__init__()
        d = config.embedding_dim
        self.ln1 = LayerNorm(d, dtype)
        self.mha = MultiHeadAttention(d, config.num_heads, head_dim, dtype)
        self.ln2 = LayerNorm(d, dtype)
        dims = (d,) + tuple(config.encoder_mlp_units)
        self.mlp = nn.ModuleList(
            Dense(i, o, dtype) for i, o in zip(dims[:-1], dims[1:]))


class ViTDetector(nn.Module):
    """The detector's parameters; ``forward`` runs the module function.

    ``head_dim`` is the PHYSICAL attention head dim; it defaults to
    ``config.key_dim`` and differs only for weights widened by the JAX
    package's ``pad_attention_key_dim``.
    """

    def __init__(self, config: DetectorConfig, head_dim: int | None = None):
        super().__init__()
        check_supported(config)
        _validate_grid_config(config)
        dtype = _dtype(config.param_dtype)
        head_dim = config.key_dim if head_dim is None else head_dim
        d = config.embedding_dim
        self.config = config
        self.linear_projection = Dense(config.patch_dim, d, dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(config.num_patches, 1, dtype=dtype))
        self.encoder = nn.ModuleList(
            EncoderBlock(config, head_dim, dtype)
            for _ in range(config.encoder_blocks))
        if tuple(config.head_scales) == (1,):
            self.head_token_dense = Dense(d, config.max_objects, dtype)
            head_in = config.num_patches
        else:
            # One token dense per pooling scale (JAX: head_token_dense/<i>).
            gh, gw = config.grid_size
            self.head_token_dense = nn.ModuleList(
                Dense(d, config.max_objects, dtype)
                for _ in config.head_scales)
            head_in = sum((gh // s) * (gw // s) for s in config.head_scales)
        dims = (head_in,) + tuple(
            u for u in config.head_units
            for _ in range(config.head_block_repeats))
        self.head_mlp = nn.ModuleList(
            Dense(i, o, dtype) for i, o in zip(dims[:-1], dims[1:]))
        self.head_output = Dense(dims[-1], 6, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self, images, self.config)


# ---------------------------------------------------------------------------
# Init (keras defaults, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _keras_fans(shape):
    """keras ``compute_fans``: leading dims are receptive field."""
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return shape[-2] * receptive, shape[-1] * receptive


def _glorot_(tensor: torch.Tensor, generator) -> None:
    fan_in, fan_out = _keras_fans(tuple(tensor.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        tensor.uniform_(-limit, limit, generator=generator)


def init_params(config: DetectorConfig, generator: torch.Generator,
                device="cpu") -> ViTDetector:
    """A ViTDetector with keras-default initialisation.

    Glorot-uniform kernels (keras fans for the rank-3 attention kernels),
    zero biases, unit/zero layer norms, uniform(-0.05, 0.05) position
    embedding. Draws on the CPU from ``generator``, so a seed gives the
    same weights on every device, then moves to ``device``. The numbers
    differ from the JAX package's for the same seed (a different
    generator); carry JAX weights over with utils/checkpoint.py instead.
    """
    device = resolve_device(device)
    model = ViTDetector(config)
    for module in model.modules():
        if isinstance(module, Dense):
            _glorot_(module.kernel, generator)
    with torch.no_grad():
        model.position_embedding.uniform_(-0.05, 0.05, generator=generator)
    return model.to(device)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def pad_attention_key_dim(params: ViTDetector, to: int = 64) -> ViTDetector:
    """Widen every attention projection's head dim with zero columns (the
    JAX package's ``pad_attention_key_dim``): q/k/v kernels ``(D, H, K) ->
    (D, H, to)`` with ``(H, K) -> (H, to)`` biases, the out kernel ``(H, K,
    D) -> (H, to, D)``. Exact: padded q/k columns add 0 to the scores,
    padded v columns give zero outputs that the zero out rows consume, and
    every gradient onto the padding is zero. Returns a new model on the
    same device (``params`` itself when its head dim is already ``to`` or
    wider)."""
    if is_quantized(params.linear_projection):
        raise ValueError("pad_attention_key_dim widens float weights; pad "
                         "before quantize_params")
    key_dim = params.encoder[0].mha.query.kernel.shape[-1]
    if key_dim >= to:
        return params
    extra = to - key_dim
    padded = {}
    for name, value in params.state_dict().items():
        if ".mha." in name and not name.endswith("out.bias"):
            # q/k/v kernels and biases: the last axis; the out kernel: (H,
            # K, D)'s middle axis.
            pad = ((0, 0, 0, extra) if name.endswith("out.kernel")
                   else (0, extra))
            value = F.pad(value, pad)
        padded[name] = value
    device = next(params.parameters()).device
    wide = ViTDetector(params.config, head_dim=to).to(device)
    wide.load_state_dict(padded)
    return wide


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """SAME-padded non-overlapping patchify.

    ``(B, H, W, 3) -> (B, ceil(H/p)*ceil(W/p), p*p*3)``, each patch
    flattened row-major over (row, col, channel). SAME padding puts the
    smaller half of the remainder first (TF convention).
    """
    if images.dim() != 4:
        raise ValueError(
            f"expected batched images (B, H, W, 3), got shape "
            f"{tuple(images.shape)}; add a leading batch axis")
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = -(-h // p), -(-w // p)
    pad_h, pad_w = gh * p - h, gw * p - w
    if pad_h or pad_w:
        # F.pad lists the LAST axis first: (C), (W), (H).
        images = F.pad(images, (0, 0,
                                pad_w // 2, pad_w - pad_w // 2,
                                pad_h // 2, pad_h - pad_h // 2))
    patches = images.reshape(b, gh, p, gw, p, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5)
    return patches.reshape(b, gh * gw, p * p * c)


def _linear(x, kernel, bias, compute_dtype) -> torch.Tensor:
    """x @ kernel in the compute dtype, + bias in fp32; returns fp32."""
    y = torch.matmul(x.to(compute_dtype), kernel.to(compute_dtype))
    return y.float() + bias.float()


def _dense(x, layer: Dense, compute_dtype) -> torch.Tensor:
    if is_quantized(layer):
        # int8 serving layers: 2-D weights through the fused kernel, the
        # others (none in this model's _dense calls) through int8_dense.
        if layer.bias.dim() == 1:
            return fused_int8_dense(x, layer).to(compute_dtype)
        return int8_dense(x, layer).to(compute_dtype)
    return _linear(x, layer.kernel, layer.bias,
                   compute_dtype).to(compute_dtype)


def _layer_norm(x, layer: LayerNorm, eps: float = 1e-3,
                config: DetectorConfig | None = None,
                train: bool = True) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (keras default eps 1e-3),
    two-pass variance as jnp.var. ``config.use_fused_layer_norm`` routes
    inference (``not train``) through the fused kernel when D is a
    multiple of 128, as the JAX forward does."""
    if (config is not None and config.use_fused_layer_norm and not train
            and x.shape[-1] % 128 == 0):
        return fused_layer_norm(x, layer.gamma, layer.beta, eps=eps)
    return layer_norm_reference(x, layer.gamma, layer.beta, eps)


def _dropout(x, rate, seed, train: bool, batch_base: int = 0,
             batch: int = 1) -> torch.Tensor:
    """keras Dropout (the JAX package's ``_dropout``): x / keep where a
    Bernoulli(keep) mask is set, else 0, in x's dtype, through
    kernels/dropout.py. The mask is ``dropout_mask`` of ``seed``, so a
    block recomputed under remat draws the same mask. ``x`` holds
    ``batch`` images starting at global image ``batch_base``: its rows
    are numbered from that image's first row."""
    if not train or rate is None or rate == 0.0 or seed is None:
        return x
    return dropout(x, seed, rate,
                   batch_base * _rows_per_image(x.shape[:-1], batch))


def _rows_per_image(leading, batch: int) -> int:
    """Rows (or batch*head rows) of one image in an array whose leading
    axes ``leading`` hold ``batch`` images."""
    return math.prod(leading) // batch


@dataclasses.dataclass(frozen=True)
class DropoutSeeds:
    """Training dropout's seeds: per encoder block its attention seed (a
    uint32, the flash kernel's mask seed) and one per pyramid layer, and
    one per head MLP layer."""

    attention: Tuple[int, ...]
    mlp: Tuple[Tuple[int, ...], ...]
    head: Tuple[int, ...]


def dropout_seeds(seed: int, config: DetectorConfig) -> DropoutSeeds:
    """The seed table that ``forward`` derives from one integer: a pure
    function of ``seed`` and the config's layer counts (numpy's
    SeedSequence, one spawn key per layer)."""
    entropy = int(seed) & (2 ** 64 - 1)

    def draw(*path) -> int:
        return int(np.random.SeedSequence(
            entropy, spawn_key=path).generate_state(1)[0])

    blocks, layers = config.encoder_blocks, config.encoder_mlp_layers
    head = len(config.head_units) * config.head_block_repeats
    return DropoutSeeds(
        attention=tuple(draw(0, i) for i in range(blocks)),
        mlp=tuple(tuple(draw(1, i, j) for j in range(layers))
                  for i in range(blocks)),
        head=tuple(draw(2, j) for j in range(head)))


def seed_table_size(config: DetectorConfig) -> int:
    """Entries of a seed table: one per block (attention), per block and
    pyramid layer, and per head MLP layer."""
    return (config.encoder_blocks * (1 + config.encoder_mlp_layers)
            + len(config.head_units) * config.head_block_repeats)


def seed_table(seeds: DropoutSeeds) -> np.ndarray:
    """A ``DropoutSeeds`` as the flat uint32 vector ``forward`` reads:
    the attention seeds, then the MLP seeds block by block, then the head
    seeds."""
    flat = [*seeds.attention, *(s for layer in seeds.mlp for s in layer),
            *seeds.head]
    return np.asarray(flat, dtype=np.uint32)


def _device_seed_table(dropout_seed, config: DetectorConfig,
                       device) -> torch.Tensor:
    """``forward``'s dropout seeds as a uint32 tensor on ``device``: an
    integer or a ``DropoutSeeds`` is derived and copied there; a tensor is
    checked and used as it is (moved, if it lies elsewhere)."""
    if isinstance(dropout_seed, torch.Tensor):
        table = dropout_seed
    else:
        seeds = (dropout_seed if isinstance(dropout_seed, DropoutSeeds)
                 else dropout_seeds(dropout_seed, config))
        table = torch.from_numpy(seed_table(seeds))
    size = seed_table_size(config)
    if table.shape != (size,) or table.dtype != torch.uint32:
        raise ValueError(
            f"a dropout seed table is a ({size},) uint32 tensor for this "
            f"config, got {tuple(table.shape)} {table.dtype}")
    return table.to(device)


def _seed_views(table: torch.Tensor, config: DetectorConfig):
    """One-element views of ``table``: (per block (attention, per-layer
    MLP seeds), head seeds)."""
    blocks, layers = config.encoder_blocks, config.encoder_mlp_layers
    views = list(table.split(1))
    mlp = views[blocks:blocks * (1 + layers)]
    return ([(views[i], tuple(mlp[i * layers:(i + 1) * layers]))
             for i in range(blocks)],
            tuple(views[blocks * (1 + layers):]))


def _dense_activation(x, layer: Dense, config: DetectorConfig,
                      compute_dtype, train: bool = False,
                      seed: Optional[int] = None,
                      batch_base: int = 0) -> torch.Tensor:
    """Dense + activation (+ dropout) of the pyramid layers: the fused
    dense+mish kernel first (not under training dropout), then the int8
    kernel with mish at inference, then the plain route with dropout (the
    JAX forward's order)."""
    if (config.use_fused_ffn and config.use_mish
            and not is_quantized(layer)
            and (config.dropout is None or not train)):
        # The bias in the compute dtype too, as the JAX fused route casts
        # it; mish runs in fp32 before the cast.
        return fused_dense_mish(x.to(compute_dtype),
                                layer.kernel.to(compute_dtype),
                                layer.bias.to(compute_dtype))
    if is_quantized(layer) and config.use_mish and not train:
        return fused_int8_dense(x, layer,
                                apply_mish=True).to(compute_dtype)
    x = _dense(x, layer, compute_dtype)
    x = mish(x) if config.use_mish else F.gelu(x)
    return _dropout(x, config.dropout, seed, train, batch_base, x.shape[0])


def _attend(q, k, v, config: DetectorConfig, compute_dtype, rate, seed,
            train: bool, batch_base: int = 0, batch: int = 1) -> torch.Tensor:
    """Attention over heads-major ``(B', G, T, K)`` views of ``batch``
    images from global image ``batch_base`` on: the flash wrapper
    (dropout in the kernel; its batch*head index is b' * G + g, counted
    from the first image's global row), or the einsum route with dropout
    on the probabilities (JAX's einsum routes' order: scores of shape
    (B', G, T, T)). The flash route returns the compute dtype, the einsum
    route fp32."""
    if config.use_flash_attention:
        bh_base = batch_base * _rows_per_image(q.shape[:2], batch)
        return flash_attention(q, k, v, layout="bhnk", dropout_rate=rate,
                               dropout_seed=seed, offsets=(bh_base, 0, 0))
    # Compute-dtype values, fp32 products and sums (exact upcast, as
    # preferred_element_type=float32 in the JAX einsums).
    scores = torch.einsum("bgnk,bgmk->bgnm", q.float(), k.float())
    probs = _dropout(torch.softmax(scores, dim=-1), rate, seed, train,
                     batch_base, batch)
    return torch.einsum("bgnm,bgmk->bgnk", probs.to(compute_dtype).float(),
                        v.float())


def _attention(x, mha: MultiHeadAttention, config: DetectorConfig,
               compute_dtype, train: bool = False,
               seed: Optional[int] = None, mesh=None,
               batch_base: int = 0) -> torch.Tensor:
    """keras MHA semantics, with windows when ``config.attention_window``
    is set (the tokens arrive window-major). Projections come out
    tokens-major ``(B, N, H, K)``. Head dims that are multiples of 64 take
    the heads-major route (``config.attention_heads_major`` overrides), as
    the JAX forward routes them: windows fold into the head axis, so the
    dropout mask's batch*head index is b * (H * W) + h * W + w. The others,
    and the int8 serving layers, take the tokens-major route: windows fold
    into the batch axis, index (b * W + w) * H + h. With ``ring_attention``
    and a mesh, ``_ring_attention`` instead."""
    if config.ring_attention and mesh is not None:
        return _ring_attention(x, mha, config, compute_dtype, train, seed,
                               mesh)
    b, n, d = x.shape
    xc = x.to(compute_dtype)
    quantized = is_quantized(mha.query)
    if quantized:
        h, k = mha.query.bias.shape          # physical head dim

        def proj(layer):
            return int8_dense(xc, layer)     # fp32 (B, N, H, K)
    else:
        h, k = mha.query.kernel.shape[1:]    # physical head dim, as in JAX

        def proj(layer):
            y = _linear(xc, layer.kernel.reshape(d, h * k),
                        layer.bias.reshape(h * k), compute_dtype)
            return y.reshape(b, n, h, k)     # fp32

    q = (proj(mha.query) / math.sqrt(config.key_dim)).to(compute_dtype)
    key = proj(mha.key).to(compute_dtype)
    v = proj(mha.value).to(compute_dtype)
    rate = (config.dropout if train and config.dropout not in (None, 0.0)
            and seed is not None else None)
    window = config.attention_window
    tokens = n if window is None else window * window
    heads_major = not quantized and (
        config.attention_heads_major
        if config.attention_heads_major is not None else k % 64 == 0)
    if heads_major:
        # (B, H, N, K) views; windows fold into the head axis (a copy).
        qh, kh, vh = (t.transpose(1, 2).reshape(b, h * (n // tokens),
                                                tokens, k)
                      for t in (q, key, v))
        attn = _attend(qh, kh, vh, config, compute_dtype, rate, seed, train,
                       batch_base, b)
        attn = attn.reshape(b, h, n, k).transpose(1, 2)
    else:
        # Windows fold into the batch axis: (B * W, T, H, K), free.
        qt, kt, vt = (t.reshape(b * (n // tokens), tokens, h, k)
                      .transpose(1, 2) for t in (q, key, v))
        attn = _attend(qt, kt, vt, config, compute_dtype, rate, seed, train,
                       batch_base, b)
        attn = attn.transpose(1, 2).reshape(b, n, h, k)
    if quantized:
        # The out projection quantizes the attention output as it comes:
        # the compute dtype from flash, fp32 from the einsum route.
        return int8_dense(attn.reshape(b, n, h * k),
                          mha.out).to(compute_dtype)
    attn = attn.to(compute_dtype).reshape(b, n, h * k)
    out = _linear(attn, mha.out.kernel.reshape(h * k, d), mha.out.bias,
                  compute_dtype)
    return out.to(compute_dtype)


def _ring_attention(x, mha: MultiHeadAttention, config: DetectorConfig,
                    compute_dtype, train: bool, seed, mesh) -> torch.Tensor:
    """keras MHA as ring attention over the mesh's 'model' axis (the JAX
    forward's ring route, tokens-major): this rank's slice of the tokens
    is projected, attended around the ring (global coordinates key the
    dropout mask), projected out, and the slices are gathered back. The
    projections' parameters see only this rank's tokens, so their
    gradients are summed over the ring."""
    b, n, d = x.shape
    h, k = mha.query.kernel.shape[1:]
    (qw, qb, kw, kb, vw, vb, ow, ob) = sum_grads_over(mesh, (
        mha.query.kernel, mha.query.bias, mha.key.kernel, mha.key.bias,
        mha.value.kernel, mha.value.bias, mha.out.kernel, mha.out.bias))
    xs = shard_tokens(x.to(compute_dtype), mesh)
    n_local = xs.shape[1]

    def proj(kernel, bias):
        y = _linear(xs, kernel.reshape(d, h * k), bias.reshape(h * k),
                    compute_dtype)
        return y.reshape(b, n_local, h, k)      # fp32

    q = (proj(qw, qb) / math.sqrt(config.key_dim)).to(compute_dtype)
    key = proj(kw, kb).to(compute_dtype)
    v = proj(vw, vb).to(compute_dtype)
    dropping = (train and config.dropout not in (None, 0.0)
                and seed is not None)
    attn = ring_attention(q, key, v, mesh,
                          dropout_rate=config.dropout if dropping else None,
                          dropout_seed=seed if dropping else None)
    out = _linear(attn.reshape(b, n_local, h * k), ow.reshape(h * k, d), ob,
                  compute_dtype)
    return gather_tokens(out.to(compute_dtype), mesh)


def _encoder_block(x, block: EncoderBlock, config: DetectorConfig,
                   compute_dtype, train: bool, seeds=None, mesh=None,
                   batch_base: int = 0) -> torch.Tensor:
    """Pre-LN MHA + descending mish pyramid, both residual. ``seeds`` is
    ``(attention seed, per-layer MLP seeds)`` under training dropout;
    ``mesh`` and ``batch_base`` (the first image's global index) as in
    ``forward``."""
    attention_seed, mlp_seeds = (
        seeds if seeds is not None else (None, (None,) * len(block.mlp)))
    side = x
    x = _layer_norm(x, block.ln1, config=config, train=train)
    x = _attention(x, block.mha, config, compute_dtype, train,
                   attention_seed, mesh, batch_base)
    x = x + side

    side = x
    x = _layer_norm(x, block.ln2, config=config, train=train)
    for layer, seed in zip(block.mlp, mlp_seeds):
        x = _dense_activation(x, layer, config, compute_dtype, train, seed,
                              batch_base)
    return x + side


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    2-D matrix products, recompute everything else (batched products, the
    attention kernels, elementwise work)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_encoder(x, params, config: DetectorConfig, compute_dtype,
                 train: bool, seeds, mesh=None,
                 batch_base: int = 0) -> torch.Tensor:
    """The encoder blocks, checkpointed as ``config.remat_encoder`` and
    ``remat_policy`` say: None recomputes every block in the backward,
    "dots" saves the 2-D matrix products' outputs and recomputes the rest,
    "alternate" checkpoints the even blocks and runs the odd ones plain.
    Checkpointing applies only where autograd records. ``seeds`` is
    ``_seed_views``' per-block list; the blocks' dropout masks are pure
    functions of those seeds, so no RNG state needs preserving across the
    recompute."""
    if config.remat_encoder and config.remat_policy not in (None, "dots",
                                                            "alternate"):
        raise ValueError(
            f"unknown remat_policy {config.remat_policy!r}; "
            "use None, 'dots' or 'alternate'")
    remat = config.remat_encoder and torch.is_grad_enabled()
    extra = {}
    if config.remat_policy == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    for i, block in enumerate(params.encoder):
        block_seeds = None if seeds is None else seeds[i]
        args = (x, block, config, compute_dtype, train, block_seeds, mesh,
                batch_base)
        if remat and not (config.remat_policy == "alternate" and i % 2):
            x = checkpoint(_encoder_block, *args, use_reentrant=False,
                           preserve_rng_state=False, **extra)
        else:
            x = _encoder_block(*args)
    return x


def _window_major(x, config: DetectorConfig, inverse: bool = False):
    """Reorder the tokens of ``(B, P, D)`` from row-major grid order to
    window-major (or back): a transpose of (rows/w, w, cols/w, w)."""
    gh, gw = config.grid_size
    w = config.attention_window
    b, _, d = x.shape
    if inverse:
        x = x.reshape(b, gh // w, gw // w, w, w, d)
    else:
        x = x.reshape(b, gh // w, w, gw // w, w, d)
    return x.transpose(2, 3).reshape(b, gh * gw, d)


def _multi_scale_head_tokens(x, layers, config: DetectorConfig,
                             compute_dtype) -> torch.Tensor:
    """Per-slot features from the token grid average-pooled at each scale
    (in fp32, cast back), projected to the slot axis per scale and
    transposed, concatenated: ``(B, max_objects, sum_s P_s)``."""
    b, _, d = x.shape
    gh, gw = config.grid_size
    grid = x.reshape(b, gh, gw, d)
    feats = []
    for scale, layer in zip(config.head_scales, layers):
        if scale == 1:
            pooled = grid
        else:
            pooled = (grid.float().reshape(b, gh // scale, scale,
                                           gw // scale, scale, d)
                      .sum(dim=(2, 4)) / float(scale * scale)).to(grid.dtype)
        tokens = pooled.reshape(b, -1, d)
        feats.append(_dense(tokens, layer, compute_dtype).transpose(1, 2))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: ViTDetector, images: torch.Tensor,
            config: DetectorConfig, train: bool = False,
            dropout_seed=None, mesh=None) -> torch.Tensor:
    """``(B, H, W, 3) -> (B, max_objects, 6)`` raw fp32 logits (the sigmoid
    stays outside, in ops/decode.py). ``dropout_seed`` (an integer, a
    ``DropoutSeeds`` table, or that table as a uint32 tensor, see
    ``seed_table``) turns on training dropout when ``train`` and
    ``config.dropout`` are set; without it nothing is dropped, as the JAX
    forward without a dropout rng. Under ``mesh`` the images are this
    rank's shard of the global batch (module docstring)."""
    check_supported(config)
    _validate_grid_config(config)
    check_mesh_config(mesh, config)
    batch_base = axis_index(mesh, DATA_AXIS) * images.shape[0]
    if train and is_quantized(params.linear_projection):
        raise NotImplementedError(
            "an int8-quantized model is for serving only; train the float "
            "model and quantize it afterwards")
    compute_dtype = _dtype(config.compute_dtype)
    block_seeds = head_seeds = None
    if dropout_seed is not None:
        block_seeds, head_seeds = _seed_views(
            _device_seed_table(dropout_seed, config, images.device), config)

    patches = extract_patches(images.to(compute_dtype), config.patch_size)
    x = _dense(patches, params.linear_projection, compute_dtype)
    # The (P, 1) position embedding broadcasts over the channel axis.
    x = x + params.position_embedding.to(compute_dtype)[None]

    # Windowed attention: the tokens go window-major once here and back
    # after the encoder (the MLP, LayerNorm and residuals do not see the
    # order), so every block's window fold is a reshape.
    windowed = config.attention_window is not None
    if windowed:
        x = _window_major(x, config)
    x = _run_encoder(x, params, config, compute_dtype, train, block_seeds,
                     mesh, batch_base)
    if windowed:
        x = _window_major(x, config, inverse=True)

    b = x.shape[0]
    if tuple(config.head_scales) == (1,):
        x = _dense(x, params.head_token_dense, compute_dtype)     # (B, P, M)
        # A plain reshape (B, P, M) -> (B, M, P), NOT a transpose, as the
        # reference's keras Reshape.
        x = x.reshape(b, config.max_objects, config.num_patches)
    else:
        x = _multi_scale_head_tokens(x, params.head_token_dense, config,
                                     compute_dtype)
    if head_seeds is None:
        head_seeds = (None,) * len(params.head_mlp)
    for layer, seed in zip(params.head_mlp, head_seeds):
        x = _dense_activation(x, layer, config, compute_dtype, train, seed,
                              batch_base)
    return _dense(x, params.head_output, compute_dtype).float()
