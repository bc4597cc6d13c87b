"""Int8 weight quantization for the serving path: the fused int8 dense
kernel and its plain PyTorch versions.

Counterpart of vision_transformer_detector_tpu/kernels/quantization.py,
serving only:

  * ``quantize_params(model)`` — a copy of a ViTDetector whose dense
    layers are ``QuantDense`` modules: symmetric per-output-channel int8
    ``kernel_q`` (in, out_flat), fp32 ``scale`` (out_flat,) and the fp32
    ``bias`` in its block shape, all buffers; the state-dict names are the
    JAX paths (``encoder.0.mha.query.kernel_q``). Layer norms and the
    position embedding stay as they are, frozen. The codes and scales come
    from the port's own copies of the JAX package's NumPy functions, so
    they are bit-equal to the JAX ones.
  * ``fused_int8_dense(x, layer, apply_mish)`` — per-row dynamic int8
    quantization of x (cast to bf16 first), int8 x int8 -> int32 dot,
    fp32 rescale + bias (+ mish), bf16 out: the Pallas kernel
    ``_fused_int8_kernel``. 2-D weights only.
  * ``int8_dense(x, layer)`` — the same arithmetic with x read in its own
    dtype and an fp32 output in the bias's block shape (the JAX package's
    XLA ``dot_general`` route, which serves the attention projections).

Routing is by the device of x, never by a fallback: CPU tensors take the
plain versions (``int8_dense_reference``), which compute the integer
product in int32; CUDA tensors launch ``csrc/int8_dense.cu`` (both routes,
each with its own launch count, through ``torch.ops.vtd_torch.
{fused_int8_dense,int8_dense}``, kernels/ops.py) or raise. Neither route has a gradient: a
call that would need one raises.

On the card the product runs on the int8 tensor cores (``wgmma``, s8 x s8
-> s32) wherever the rows can be moved in 16-byte pieces
(``tensor_core_shape``: K a multiple of 16); other shapes take the
kernel's guarded CUDA-core instance. That is dispatch by shape, decided
before the launch; each route counts the launches of the tensor-core
instances apart (``<fn>.tensor_core_launches``). 8-bit ``wgmma`` reads both
operands with k contiguous, so the kernel reads an (N, K) copy of
``kernel_q``: ``transposed_codes(layer)`` makes it at the first launch and
keeps it on the layer, outside the state dict, and makes it anew when
``kernel_q`` was written (``copy_``, ``load_state_dict``) or moved
(``.to(device)``). The alternative, staging [k][n] tiles and transposing
4 x 4 bytes in registers, would keep no state but costs the kernel's inner
loop shuffles and bank conflicts at every use of a weight that is written
once; the copy costs one transpose per layer and K * N bytes.
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import torch
from torch import nn

from .fused_ffn import mish_f32

SOURCE = "int8_dense.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# The kernel's instances and the request that holds the C entry point to
# each (None: by shape). "resident" keeps the codes of a block's rows in
# shared memory, "streamed" quantizes each k tile as the products need it.
REQUESTS = {None: 0, "guarded": 1, "resident": 2, "streamed": 3}


# ---------------------------------------------------------------------------
# Weight quantization (NumPy, copied from the JAX package)
# ---------------------------------------------------------------------------

def _quantize_kernel(kernel: np.ndarray):
    """(in..., out...) kernel -> 2-D int8 + per-output-channel scales."""
    arr = np.asarray(kernel, np.float32)
    if arr.ndim == 3:        # MHA projection (D, H, K) or (H, K, D)
        # Flatten so the CONTRACTED side is first: q/k/v kernels contract
        # dim 0 (D); the output projection contracts (H, K) = dims 0-1.
        # Both flatten to (in_flat, out_flat) with row-major reshape when
        # the contracted dims lead; callers pass kernels contracted-first.
        in_dim = arr.shape[0]
        arr2 = arr.reshape(in_dim, -1)
        out_shape = arr.shape[1:]
    elif arr.ndim == 2:
        arr2 = arr
        out_shape = (arr.shape[1],)
    else:
        raise ValueError(f"cannot quantize kernel of rank {arr.ndim}")
    amax = np.max(np.abs(arr2), axis=0)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(arr2 / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32), out_shape


def _quantize_mha_out_kernel(kernel: np.ndarray):
    """Output projection (H, K, D): contracted dims are (H, K)."""
    arr = np.asarray(kernel, np.float32)
    h, k, d = arr.shape
    q, scale, _ = _quantize_kernel(arr.reshape(h * k, d))
    return q, scale, (d,)


class QuantDense(nn.Module):
    """An int8 dense layer: ``kernel_q`` int8 (in, out_flat), ``scale``
    fp32 (out_flat,), ``bias`` fp32 in the output block shape (which sets
    the output's trailing shape, as in the JAX layer dict)."""

    def __init__(self, in_dim: int, out_shape, device=None):
        super().__init__()
        out_shape = tuple(out_shape)
        out_flat = int(np.prod(out_shape))
        self.register_buffer("kernel_q", torch.zeros(
            (in_dim, out_flat), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_flat, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_shape, dtype=torch.float32, device=device))


def _quantize_dense(layer, mha_out: bool = False) -> QuantDense:
    kernel = layer.kernel.detach().float().cpu().numpy()
    if mha_out:
        q, scale, out_shape = _quantize_mha_out_kernel(kernel)
    else:
        q, scale, out_shape = _quantize_kernel(kernel)
    bias = layer.bias.detach().float().cpu()
    assert tuple(bias.shape) == tuple(out_shape), (bias.shape, out_shape)
    device = layer.kernel.device
    out = QuantDense(q.shape[0], out_shape, device=device)
    out.kernel_q.copy_(torch.from_numpy(q))
    out.scale.copy_(torch.from_numpy(scale))
    out.bias.copy_(bias)
    return out


def quantize_params(model: nn.Module) -> nn.Module:
    """A serving copy of ``model`` with every dense layer (the linear
    projection, the q/k/v/out attention projections, the encoder MLPs,
    the head's token dense, MLP and output) as a ``QuantDense``; the other
    parameters are kept and frozen. ``model`` itself is left as it is."""
    from ..models.vit_detector import Dense

    out = copy.deepcopy(model)
    targets = [(name, module) for name, module in out.named_modules()
               if isinstance(module, Dense)]
    for name, module in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = out.get_submodule(parent_name) if parent_name else out
        quantized = _quantize_dense(module, mha_out=name.endswith("mha.out"))
        if isinstance(parent, nn.ModuleList):
            parent[int(attr)] = quantized
        else:
            setattr(parent, attr, quantized)
    return out.requires_grad_(False)


def is_quantized(layer) -> bool:
    return isinstance(layer, QuantDense)


def tensor_core_shape(k: int) -> bool:
    """Whether a product over ``k`` input features takes a tensor-core
    instance on the card: rows of x and of the (N, K) codes are moved in
    16-byte pieces, so K must be a multiple of 16 (any M, any N). The
    other shapes take the guarded instance."""
    return k > 0 and k % 16 == 0


def _version(tensor: torch.Tensor):
    """The tensor's write counter, or None for an inference tensor, which
    keeps none."""
    try:
        return tensor._version
    except RuntimeError:
        return None


def transposed_codes(layer: QuantDense) -> torch.Tensor:
    """``layer.kernel_q`` as a contiguous (N, K) tensor, for the tensor-core
    instances. Derived state: a plain attribute of the layer, never in
    ``state_dict()``. It is kept with the ``kernel_q`` storage address and
    write counter it was made from, and made anew when either differs, so
    it follows ``kernel_q.copy_``, ``load_state_dict`` and ``.to(device)``.
    An inference tensor has no write counter; its copy is made per call."""
    kernel_q = layer.kernel_q
    version = _version(kernel_q)
    key = (kernel_q.data_ptr(), version, kernel_q.device, tuple(kernel_q.shape))
    cached = layer.__dict__.get("_transposed_codes")
    if version is not None and cached is not None and cached[0] == key:
        return cached[1]
    transposed = kernel_q.detach().t().contiguous()
    layer.__dict__["_transposed_codes"] = (key, transposed)
    return transposed


# ---------------------------------------------------------------------------
# The int8 dense, plain and kernel
# ---------------------------------------------------------------------------

def int8_dense_reference(x: torch.Tensor, kernel_q: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         apply_mish: bool = False,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version of the kernel on 2-D ``x`` (M, K), ``kernel_q``
    (K, N), fp32 ``scale`` and ``bias`` (N,): the JAX arithmetic step for
    step. The integer product is exact: int32 on the CPU; on the card, where
    torch has no int32 matmul, float64, exact while |acc| <= 127^2 K < 2^53."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient.
    x_scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(x32 / x_scale), -127, 127)
    if x.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), kernel_q.to(torch.int32))
    else:
        acc = torch.matmul(xq.double(), kernel_q.double())
    y = acc.float() * x_scale * scale.float()
    y = y + bias.float()
    if apply_mish:
        y = mish_f32(y)
    return y.to(out_dtype)


def _refuse_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "int8 dense layers are serving-only and have no gradient; call "
            "them under torch.no_grad() or torch.inference_mode()")


def _route(x: torch.Tensor, layer: QuantDense) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    devices = {t.device for t in (x, layer.kernel_q, layer.scale, layer.bias)}
    if len(devices) != 1:
        raise ValueError(
            f"x and the layer's buffers must be on one device, got "
            f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 dense runs on the CPU or CUDA, not {device}")
    return device.type == "cuda"


def int8_dense(x: torch.Tensor, layer: QuantDense) -> torch.Tensor:
    """``x @ kernel`` with dynamic per-row int8 activation quantization;
    fp32 ``(..., *bias.shape)`` with the bias added."""
    _refuse_grad(x)
    out_shape = tuple(layer.bias.shape)
    x2 = x.reshape(-1, x.shape[-1])
    if _route(x, layer):
        y = _launch(x2, layer, False, torch.float32, int8_dense)
    else:
        y = int8_dense_reference(x2, layer.kernel_q, layer.scale,
                                 layer.bias.reshape(-1))
    return y.reshape(tuple(x.shape[:-1]) + out_shape)


def fused_int8_dense(x: torch.Tensor, layer: QuantDense,
                     apply_mish: bool = False) -> torch.Tensor:
    """``(..., K) -> (..., N)`` bf16 through the fused quantize + int8
    matmul (+ mish) kernel; x is cast to bf16 first, as in the JAX
    package. 2-D weights only."""
    _refuse_grad(x)
    if layer.bias.dim() != 1:
        raise ValueError("fused_int8_dense handles 2-D weights only, got a "
                         f"bias of shape {tuple(layer.bias.shape)}")
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    if _route(x, layer):
        y = _launch(x2, layer, apply_mish, torch.bfloat16, fused_int8_dense)
    else:
        y = int8_dense_reference(x2, layer.kernel_q, layer.scale, layer.bias,
                                 apply_mish, torch.bfloat16)
    return y.reshape(tuple(x.shape[:-1]) + (layer.bias.shape[0],))


# Kernel launches, one count per route, and those of them that took a
# tensor-core instance; the plain versions add none.
int8_dense.launches = 0
fused_int8_dense.launches = 0
int8_dense.tensor_core_launches = 0
fused_int8_dense.tensor_core_launches = 0


def _launch(x2, layer: QuantDense, apply_mish: bool, out_dtype,
            route, instance: str | None = None) -> torch.Tensor:
    """One kernel launch through ``torch.ops.vtd_torch.<route>``
    (kernels/ops.py), counted on ``route`` (the public function).
    ``instance`` names one of ``REQUESTS`` to take instead of the one the
    shape selects (the tests and the timings use it); a shape that the
    named instance cannot take raises."""
    k = x2.shape[1]
    kernel_q = layer.kernel_q
    if kernel_q.dtype != torch.int8 or kernel_q.shape[0] != k:
        raise ValueError(
            f"kernel_q must be int8 ({k}, N), got {kernel_q.dtype} "
            f"{tuple(kernel_q.shape)}")
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x2.dtype}")
    op, route_dtype = ((torch.ops.vtd_torch.int8_dense, torch.float32)
                       if route is int8_dense else
                       (torch.ops.vtd_torch.fused_int8_dense, torch.bfloat16))
    if out_dtype != route_dtype:
        raise ValueError(f"{route.__name__} writes {route_dtype}, not "
                         f"{out_dtype}")
    # The (N, K) codes only where a tensor-core instance may take the call.
    transposed = (transposed_codes(layer)
                  if tensor_core_shape(k) and instance != "guarded" else None)
    return op(x2, kernel_q, transposed, layer.scale, layer.bias, apply_mish,
              REQUESTS[instance])
