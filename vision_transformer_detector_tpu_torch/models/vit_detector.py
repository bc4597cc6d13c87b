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
seed per attention, MLP and head layer, or that table itself. Attention
dropout runs in the flash kernel (the JAX counter-hash mask, bit-equal to
JAX's for the same seed) or on the einsum route's probabilities; the MLP
and head masks are drawn from a ``torch.Generator`` seeded with the
layer's seed, so a recomputed block draws the same masks. They are another
stream than JAX's threefry masks, of the same Bernoulli(1 - rate).

Not ported, and rejected with NotImplementedError rather than run
differently: ring attention and sequence sharding (both need a mesh).
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
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ffn import fused_dense_mish
from ..kernels.fused_ln import fused_layer_norm, layer_norm_reference
from ..kernels.quantization import fused_int8_dense, int8_dense, is_quantized
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
        "ring_attention": config.ring_attention,
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


def _dropout(x, rate, seed, train: bool) -> torch.Tensor:
    """keras Dropout (the JAX package's ``_dropout``): x / keep where a
    Bernoulli(keep) mask is set, else 0, in x's dtype. The mask is drawn
    from a ``torch.Generator`` on x's device seeded with ``seed``, so a
    block recomputed under remat draws the same mask."""
    if not train or rate is None or rate == 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    generator = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


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


def _dense_activation(x, layer: Dense, config: DetectorConfig,
                      compute_dtype, train: bool = False,
                      seed: Optional[int] = None) -> torch.Tensor:
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
    return _dropout(x, config.dropout, seed, train)


def _attend(q, k, v, config: DetectorConfig, compute_dtype, rate, seed,
            train: bool) -> torch.Tensor:
    """Attention over heads-major ``(B', G, T, K)`` views: the flash
    wrapper (dropout in the kernel; its batch*head index is b' * G + g),
    or the einsum route with dropout on the probabilities (JAX's einsum
    routes' order: scores of shape (B', G, T, T)). The flash route returns
    the compute dtype, the einsum route fp32."""
    if config.use_flash_attention:
        return flash_attention(q, k, v, layout="bhnk", dropout_rate=rate,
                               dropout_seed=seed)
    # Compute-dtype values, fp32 products and sums (exact upcast, as
    # preferred_element_type=float32 in the JAX einsums).
    scores = torch.einsum("bgnk,bgmk->bgnm", q.float(), k.float())
    probs = _dropout(torch.softmax(scores, dim=-1), rate, seed, train)
    return torch.einsum("bgnm,bgmk->bgnk", probs.to(compute_dtype).float(),
                        v.float())


def _attention(x, mha: MultiHeadAttention, config: DetectorConfig,
               compute_dtype, train: bool = False,
               seed: Optional[int] = None) -> torch.Tensor:
    """keras MHA semantics, with windows when ``config.attention_window``
    is set (the tokens arrive window-major). Projections come out
    tokens-major ``(B, N, H, K)``. Head dims that are multiples of 64 take
    the heads-major route (``config.attention_heads_major`` overrides), as
    the JAX forward routes them: windows fold into the head axis, so the
    dropout mask's batch*head index is b * (H * W) + h * W + w. The others,
    and the int8 serving layers, take the tokens-major route: windows fold
    into the batch axis, index (b * W + w) * H + h."""
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
        attn = _attend(qh, kh, vh, config, compute_dtype, rate, seed, train)
        attn = attn.reshape(b, h, n, k).transpose(1, 2)
    else:
        # Windows fold into the batch axis: (B * W, T, H, K), free.
        qt, kt, vt = (t.reshape(b * (n // tokens), tokens, h, k)
                      .transpose(1, 2) for t in (q, key, v))
        attn = _attend(qt, kt, vt, config, compute_dtype, rate, seed, train)
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


def _encoder_block(x, block: EncoderBlock, config: DetectorConfig,
                   compute_dtype, train: bool, seeds=None) -> torch.Tensor:
    """Pre-LN MHA + descending mish pyramid, both residual. ``seeds`` is
    ``(attention seed, per-layer MLP seeds)`` under training dropout."""
    attention_seed, mlp_seeds = (
        seeds if seeds is not None else (None, (None,) * len(block.mlp)))
    side = x
    x = _layer_norm(x, block.ln1, config=config, train=train)
    x = _attention(x, block.mha, config, compute_dtype, train,
                   attention_seed)
    x = x + side

    side = x
    x = _layer_norm(x, block.ln2, config=config, train=train)
    for layer, seed in zip(block.mlp, mlp_seeds):
        x = _dense_activation(x, layer, config, compute_dtype, train, seed)
    return x + side


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    2-D matrix products, recompute everything else (batched products, the
    attention kernels, elementwise work)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_encoder(x, params, config: DetectorConfig, compute_dtype,
                 train: bool, seeds: Optional[DropoutSeeds]) -> torch.Tensor:
    """The encoder blocks, checkpointed as ``config.remat_encoder`` and
    ``remat_policy`` say: None recomputes every block in the backward,
    "dots" saves the 2-D matrix products' outputs and recomputes the rest,
    "alternate" checkpoints the even blocks and runs the odd ones plain.
    Checkpointing applies only where autograd records. The blocks draw
    their dropout masks from seeded generators of their own, so no RNG
    state needs preserving across the recompute."""
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
        block_seeds = (None if seeds is None
                       else (seeds.attention[i], seeds.mlp[i]))
        args = (x, block, config, compute_dtype, train, block_seeds)
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
            dropout_seed=None) -> torch.Tensor:
    """``(B, H, W, 3) -> (B, max_objects, 6)`` raw fp32 logits (the sigmoid
    stays outside, in ops/decode.py). ``dropout_seed`` (an integer, or a
    ``DropoutSeeds`` table) turns on training dropout when ``train`` and
    ``config.dropout`` are set; without it nothing is dropped, as the JAX
    forward without a dropout rng."""
    check_supported(config)
    _validate_grid_config(config)
    if train and is_quantized(params.linear_projection):
        raise NotImplementedError(
            "an int8-quantized model is for serving only; train the float "
            "model and quantize it afterwards")
    compute_dtype = _dtype(config.compute_dtype)
    seeds = dropout_seed
    if dropout_seed is not None and not isinstance(dropout_seed,
                                                   DropoutSeeds):
        seeds = dropout_seeds(dropout_seed, config)

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
    x = _run_encoder(x, params, config, compute_dtype, train, seeds)
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
    head_seeds = (seeds.head if seeds is not None
                  else (None,) * len(params.head_mlp))
    for layer, seed in zip(params.head_mlp, head_seeds):
        x = _dense_activation(x, layer, config, compute_dtype, train, seed)
    return _dense(x, params.head_output, compute_dtype).float()
