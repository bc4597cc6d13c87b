"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

Counterpart of vision_transformer_detector_tpu/kernels/flash_attention.py.
``flash_attention`` keeps that module's contract: inputs are
``(B, N, H, K)`` (``layout="bnhk"``) or ``(B, H, N, K)``
(``layout="bhnk"``) with any 1/sqrt(K) scaling already applied by the
caller, and the output is ``softmax(q k^T) v`` in the input dtype, to
~1e-2 in bf16 and ~1e-5 in fp32. It is differentiable.

Routing is by the device of the tensors, never by a fallback:
  * CPU tensors take the plain versions (``reference_attention``,
    ``reference_attention_lse``, ``reference_attention_backward``), which
    the tests compare with the JAX package;
  * CUDA tensors launch the kernels in ``csrc/flash_attention_fwd.cu`` and
    ``csrc/flash_attention_bwd.cu`` (built at first use by
    ``kernels/_build.py``), or raise;
  * any other device raises.

When q, k or v requires grad, the call goes through
``FlashAttentionFunction``: its forward also writes the fp32 logsumexp and
saves it with the unpadded q, k, v and the output; its backward forms
delta = rowsum(g * out) in fp32 and launches the backward kernel, as the
JAX package's Pallas backward does. Calls that need no grad (serving,
``torch.inference_mode``) launch the forward alone, without the logsumexp.

The TPU kernel's in-kernel dropout is not ported yet: asking for it
raises NotImplementedError on every device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import _build

FWD_SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
_HEAD_DIM = 64          # the kernels' native head dim; smaller K is padded
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _heads_major(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A (B, H, N, K) view of a layout-ordered tensor (and back: the
    transpose is its own inverse)."""
    return t if layout == "bhnk" else t.transpose(1, 2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhk") -> torch.Tensor:
    """Materialised-softmax version: fp32 scores and softmax, probabilities
    cast to v's dtype before P@V with fp32 accumulation, output in q's
    dtype (as the JAX package's ``reference_attention``)."""
    if layout == "bhnk":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1)
    # bf16 x bf16 products are exact in fp32, so upcasting the rounded
    # probabilities reproduces a bf16 matmul with fp32 accumulation.
    out = torch.einsum("bhnm,bmhk->bnhk", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return out.transpose(1, 2) if layout == "bhnk" else out


def reference_attention_lse(q: torch.Tensor, k: torch.Tensor,
                            layout: str = "bnhk") -> torch.Tensor:
    """(B, H, N) fp32 logsumexp of the scores of each query row."""
    q, k = _heads_major(q, layout), _heads_major(k, layout)
    scores = torch.einsum("bhnk,bhmk->bhnm", q.float(), k.float())
    return torch.logsumexp(scores, dim=-1)


def reference_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor,
                                 layout: str = "bnhk"):
    """(dq, dk, dv) of ``reference_attention`` for the output cotangent g,
    as the JAX package's ``_flash_bwd_chunked`` (fp32 variant, no dropout)
    computes them: fp32 scores, softmax and g v^T; p cast to the input
    dtype before dv = p^T g; ds = p * (dp - rowsum(dp * p)) cast to the
    input dtype before dq = ds k and dk = ds^T q; fp32 accumulation, grads
    in the inputs' dtypes and layout."""
    qh, kh, vh, gh = (_heads_major(t, layout) for t in (q, k, v, g))
    dtype = q.dtype
    scores = torch.einsum("bhnk,bhmk->bhnm", qh.float(), kh.float())
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum("bhnk,bhmk->bhnm", gh.float(), vh.float())
    dv = torch.einsum("bhnm,bhnk->bhmk", p.to(dtype).float(), gh.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.to(dtype).float()
    dq = torch.einsum("bhnm,bhmk->bhnk", ds, kh.float())
    dk = torch.einsum("bhnm,bhnk->bhmk", ds, qh.float())
    return tuple(_heads_major(t.to(ref.dtype), layout)
                 for t, ref in ((dq, q), (dk, k), (dv, v)))


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over the kernels (``use_kernel``) or the
    plain versions. The kernel route saves the forward's fp32 logsumexp
    for the backward kernel; the plain route recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, layout: str, use_kernel: bool):
        if use_kernel:
            out, lse = _launch_forward(q, k, v, layout, with_lse=True)
        else:
            out, lse = reference_attention(q, k, v, layout), None
        # Unpadded q/k/v: the backward re-pads them, so a K < 64 call does
        # not hold a padded copy between the passes.
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout = layout
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.use_kernel:
            # delta = rowsum(g * out) in fp32, outside the kernel, as the
            # JAX package's _flash_bwd_pallas computes it.
            delta = _heads_major((g.float() * out.float()).sum(dim=-1),
                                 ctx.layout).contiguous()
            dq, dk, dv = _launch_backward(q, k, v, g, lse, delta, ctx.layout)
        else:
            dq, dk, dv = reference_attention_backward(q, k, v, g, ctx.layout)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    layout: str = "bnhk", dropout_rate: float | None = None,
                    dropout_seed=None, with_lse: bool = False):
    """Attention over ``layout``-ordered q/k/v; see the module docstring.

    Returns the output, or ``(output, lse)`` with ``with_lse`` (lse is
    ``(B, H, N)`` fp32; that form is not differentiable).
    """
    if layout not in ("bnhk", "bhnk"):
        raise ValueError(f"unknown layout {layout!r}")
    if dropout_rate not in (None, 0.0):
        raise NotImplementedError(
            "attention dropout is training-only and not ported yet")
    devices = {t.device.type for t in (q, k, v)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"flash_attention takes q/k/v all on the CPU or all on CUDA, "
            f"got devices {sorted(devices)}")
    use_kernel = devices == {"cuda"}
    if with_lse:
        if use_kernel:
            return _launch_forward(q, k, v, layout, with_lse=True)
        return (reference_attention(q, k, v, layout),
                reference_attention_lse(q, k, layout))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, layout, use_kernel)
    if use_kernel:
        return _launch_forward(q, k, v, layout)
    return reference_attention(q, k, v, layout)


# Kernel launches, one count per kernel wrapper; the plain path adds none.
flash_attention.launches = 0            # forward without the logsumexp
flash_attention.lse_launches = 0        # forward with the logsumexp
flash_attention.backward_launches = 0   # backward


def _count(name: str) -> None:
    with _count_lock:
        setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def _check_inputs(*tensors) -> None:
    shape, dtype = tensors[0].shape, tensors[0].dtype
    if any(t.shape != shape for t in tensors) or len(shape) != 4:
        raise ValueError(
            "q/k/v (and g) must share one 4-D shape, got "
            + ", ".join(str(tuple(t.shape)) for t in tensors))
    if any(t.dtype != dtype for t in tensors) or dtype not in _DTYPE_CODES:
        raise ValueError(
            "the kernels take float32 or bfloat16 tensors of one dtype, got "
            + ", ".join(str(t.dtype) for t in tensors))
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("q/k/v must be on one CUDA device")
    if shape[-1] > _HEAD_DIM:
        raise ValueError(
            f"head dim {shape[-1]} > {_HEAD_DIM} is not supported")
    if tensors[0].numel() == 0:
        raise ValueError("empty q/k/v")


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero head-dim padding to 64 is exact: padded columns add 0 to q.k
    and to g.v and give 0 outputs and grads, sliced off afterwards."""
    if t.shape[-1] < _HEAD_DIM:
        return F.pad(t, (0, _HEAD_DIM - t.shape[-1]))
    return t


def _axes(t: torch.Tensor, layout: str):
    """(batch, heads, tokens) sizes and strides of a layout-ordered tensor."""
    if layout == "bhnk":
        return t.shape[:3], t.stride()[:3]
    return ((t.shape[0], t.shape[2], t.shape[1]),
            (t.stride(0), t.stride(2), t.stride(1)))


def _launch_forward(q, k, v, layout: str, with_lse: bool = False):
    _check_inputs(q, k, v)
    kdim = q.shape[-1]
    q, k, v = (_pad_head_dim(t) for t in (q, k, v))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v must be contiguous in the head dim")
    lib = _library(FWD_SOURCE)
    # empty_like keeps q's memory order, so a transposed view in gives a
    # tensor that transposes back to contiguous.
    out = torch.empty_like(q)
    (b, h, n), sq = _axes(q, layout)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [s for t in (q, k, v, out) for s in _axes(t, layout)[1]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODES[q.dtype],
            b, h, n, *strides, stream)
    _build.raise_on_error(lib, err, "flash attention forward")
    _count("lse_launches" if with_lse else "launches")
    out = out[..., :kdim] if kdim < _HEAD_DIM else out
    return (out, lse) if with_lse else out


def _launch_backward(q, k, v, g, lse, delta, layout: str):
    """dq, dk, dv from the backward kernel. lse and delta are (B, H, N)
    fp32; dq accumulates in a zeroed fp32 buffer and is cast to q's dtype
    here, dk and dv come out of the kernel in the input dtype."""
    _check_inputs(q, k, v, g)
    kdim = q.shape[-1]
    q, k, v, g = (_pad_head_dim(t) for t in (q, k, v, g))
    # The incoming cotangent may be any view; the kernel needs a unit
    # stride in the head dim only.
    q, k, v, g = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q, k, v, g))
    (b, h, n), _ = _axes(q, layout)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, n) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous float32 {(b, h, n)} tensor on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    lib = _library(BWD_SOURCE)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = [s for t in (q, k, v, g, dq, dk, dv)
               for s in _axes(t, layout)[1]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtd_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODES[q.dtype], b, h, n, *strides, stream)
    _build.raise_on_error(lib, err, "flash attention backward")
    _count("backward_launches")
    return dq[..., :kdim].to(q.dtype), dk[..., :kdim], dv[..., :kdim]


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load_library(source)
    if source == FWD_SOURCE:
        fn = lib.vtd_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    else:
        fn = lib.vtd_flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 21 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.vtd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vtd_cuda_error_string.restype = ctypes.c_char_p
    return lib
