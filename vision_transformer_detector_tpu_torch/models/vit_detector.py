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

Not ported yet, and rejected with NotImplementedError rather than run
differently: windowed and ring attention, the multi-scale head,
rematerialisation, sequence sharding and training-time dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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
        "attention_window": config.attention_window is not None,
        "ring_attention": config.ring_attention,
        "head_scales": tuple(config.head_scales) != (1,),
        "remat_encoder": config.remat_encoder,
        "sequence_sharding": config.sequence_sharding,
    }
    missing = [name for name, used in unported.items() if used]
    if missing:
        raise NotImplementedError(
            f"config features not ported to PyTorch yet: {missing}")


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
        self.head_token_dense = Dense(d, config.max_objects, dtype)
        dims = (config.num_patches,) + tuple(
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


def _dense_activation(x, layer: Dense, config: DetectorConfig,
                      compute_dtype, train: bool = False) -> torch.Tensor:
    """Dense + activation of the pyramid layers: the fused dense+mish
    kernel first, then the int8 kernel with mish at inference, then the
    plain route (the JAX forward's order)."""
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
    return mish(x) if config.use_mish else F.gelu(x)


def _attention_int8(xc, mha: MultiHeadAttention, config: DetectorConfig,
                    compute_dtype) -> torch.Tensor:
    """The int8 serving layers' attention, tokens-major as in the JAX
    forward: q/k/v through int8_dense in fp32 (B, N, H, K), q / sqrt(key
    dim) in fp32, flash (bnhk) in the compute dtype or the einsum route
    with an fp32 result, and the out projection through int8_dense on
    (B, N, H * K)."""
    b, n, _ = xc.shape
    h, k = mha.query.bias.shape          # physical head dim
    q = int8_dense(xc, mha.query) / math.sqrt(config.key_dim)
    key = int8_dense(xc, mha.key)
    v = int8_dense(xc, mha.value)
    if config.use_flash_attention:
        attn = flash_attention(q.to(compute_dtype), key.to(compute_dtype),
                               v.to(compute_dtype), layout="bnhk")
    else:
        scores = torch.einsum("bnhk,bmhk->bhnm",
                              q.to(compute_dtype).float(),
                              key.to(compute_dtype).float())
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhnm,bmhk->bnhk",
                            probs.to(compute_dtype).float(),
                            v.to(compute_dtype).float())
    return int8_dense(attn.reshape(b, n, h * k),
                      mha.out).to(compute_dtype)


def _attention(x, mha: MultiHeadAttention, config: DetectorConfig,
               compute_dtype) -> torch.Tensor:
    """keras MHA semantics. Projections come out tokens-major
    ``(B, N, H, K)``; head dims that are multiples of 64 hand the flash
    wrapper a heads-major ``(B, H, N, K)`` view, as the JAX forward routes
    them (``config.attention_heads_major`` overrides), and the kernel reads
    either through strides."""
    b, n, d = x.shape
    xc = x.to(compute_dtype)
    if is_quantized(mha.query):
        return _attention_int8(xc, mha, config, compute_dtype)
    h, k = mha.query.kernel.shape[1:]    # physical head dim, as in JAX

    def proj(layer):
        y = _linear(xc, layer.kernel.reshape(d, h * k),
                    layer.bias.reshape(h * k), compute_dtype)
        return y.reshape(b, n, h, k)     # fp32

    q = (proj(mha.query) / math.sqrt(config.key_dim)).to(compute_dtype)
    key = proj(mha.key).to(compute_dtype)
    v = proj(mha.value).to(compute_dtype)

    if config.use_flash_attention:
        heads_major = (config.attention_heads_major
                       if config.attention_heads_major is not None
                       else k % 64 == 0)
        if heads_major:
            attn = flash_attention(q.transpose(1, 2), key.transpose(1, 2),
                                   v.transpose(1, 2),
                                   layout="bhnk").transpose(1, 2)
        else:
            attn = flash_attention(q, key, v, layout="bnhk")
    else:
        # Compute-dtype values, fp32 products and sums (exact upcast, as
        # preferred_element_type=float32 in the JAX einsums).
        scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), key.float())
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhnm,bmhk->bnhk",
                            probs.to(compute_dtype).float(), v.float())
    attn = attn.to(compute_dtype).reshape(b, n, h * k)
    out = _linear(attn, mha.out.kernel.reshape(h * k, d), mha.out.bias,
                  compute_dtype)
    return out.to(compute_dtype)


def _encoder_block(x, block: EncoderBlock, config: DetectorConfig,
                   compute_dtype, train: bool) -> torch.Tensor:
    """Pre-LN MHA + descending mish pyramid, both residual."""
    side = x
    x = _layer_norm(x, block.ln1, config=config, train=train)
    x = _attention(x, block.mha, config, compute_dtype)
    x = x + side

    side = x
    x = _layer_norm(x, block.ln2, config=config, train=train)
    for layer in block.mlp:
        x = _dense_activation(x, layer, config, compute_dtype, train)
    return x + side


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: ViTDetector, images: torch.Tensor,
            config: DetectorConfig, train: bool = False) -> torch.Tensor:
    """``(B, H, W, 3) -> (B, max_objects, 6)`` raw fp32 logits (the sigmoid
    stays outside, in ops/decode.py)."""
    check_supported(config)
    if train and config.dropout not in (None, 0.0):
        raise NotImplementedError(
            "training-time dropout is not ported to PyTorch yet")
    if train and is_quantized(params.linear_projection):
        raise NotImplementedError(
            "an int8-quantized model is for serving only; train the float "
            "model and quantize it afterwards")
    compute_dtype = _dtype(config.compute_dtype)

    patches = extract_patches(images.to(compute_dtype), config.patch_size)
    x = _dense(patches, params.linear_projection, compute_dtype)
    # The (P, 1) position embedding broadcasts over the channel axis.
    x = x + params.position_embedding.to(compute_dtype)[None]

    for block in params.encoder:
        x = _encoder_block(x, block, config, compute_dtype, train)

    b = x.shape[0]
    x = _dense(x, params.head_token_dense, compute_dtype)     # (B, P, M)
    # A plain reshape (B, P, M) -> (B, M, P), NOT a transpose, as the
    # reference's keras Reshape.
    x = x.reshape(b, config.max_objects, config.num_patches)
    for layer in params.head_mlp:
        x = _dense_activation(x, layer, config, compute_dtype, train)
    return _dense(x, params.head_output, compute_dtype).float()
