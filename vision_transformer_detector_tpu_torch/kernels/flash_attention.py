"""Flash attention (forward): a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of vision_transformer_detector_tpu/kernels/flash_attention.py.
``flash_attention`` keeps that module's contract: inputs are
``(B, N, H, K)`` (``layout="bnhk"``) or ``(B, H, N, K)``
(``layout="bhnk"``) with any 1/sqrt(K) scaling already applied by the
caller, and the output is ``softmax(q k^T) v`` in the input dtype, to
~1e-2 in bf16 and ~1e-5 in fp32.

Routing is by the device of the tensors, never by a fallback:
  * CPU tensors take ``reference_attention``, the plain version (a
    materialised fp32 softmax) that the tests compare with the JAX package;
  * CUDA tensors launch the kernel in ``csrc/flash_attention_fwd.cu``
    (built at first use by ``kernels/_build.py``), or raise;
  * any other device raises.

The in-kernel dropout and the logsumexp (``with_lse``) output of the TPU
kernel serve training only and are not ported to the GPU yet: a CUDA call
that asks for them raises NotImplementedError. The plain version returns
the logsumexp; it has no dropout either.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

_SOURCE = "flash_attention_fwd.cu"
_HEAD_DIM = 64          # the kernel's native head dim; smaller K is padded
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


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


def _reference_lse(q: torch.Tensor, k: torch.Tensor,
                   layout: str) -> torch.Tensor:
    """(B, H, N) fp32 logsumexp of the scores of each query row."""
    if layout == "bhnk":
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
    return torch.logsumexp(scores, dim=-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    layout: str = "bnhk", dropout_rate: float | None = None,
                    dropout_seed=None, with_lse: bool = False):
    """Attention over ``layout``-ordered q/k/v; see the module docstring.

    Returns the output, or ``(output, lse)`` with ``with_lse`` (plain
    version only; lse is ``(B, H, N)`` fp32).
    """
    if layout not in ("bnhk", "bhnk"):
        raise ValueError(f"unknown layout {layout!r}")
    if dropout_rate not in (None, 0.0):
        raise NotImplementedError(
            "attention dropout is training-only and not ported yet")
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        out = reference_attention(q, k, v, layout)
        return (out, _reference_lse(q, k, layout)) if with_lse else out
    if devices != {"cuda"}:
        raise ValueError(
            f"flash_attention takes q/k/v all on the CPU or all on CUDA, "
            f"got devices {sorted(devices)}")
    if with_lse:
        raise NotImplementedError(
            "the logsumexp output is training-only and not ported to the "
            "CUDA kernel yet")
    return _launch(q, k, v, layout)


flash_attention.launches = 0   # kernel launches; the plain path adds none


def _check_inputs(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q/k/v must share one 4-D shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one CUDA device")
    if q.shape[-1] > _HEAD_DIM:
        raise ValueError(
            f"head dim {q.shape[-1]} > {_HEAD_DIM} is not supported")
    if any(t.numel() == 0 for t in (q, k, v)):
        raise ValueError("empty q/k/v")


def _axes(t: torch.Tensor, layout: str):
    """(batch, heads, tokens) sizes and strides of a layout-ordered tensor."""
    if layout == "bhnk":
        return t.shape[:3], t.stride()[:3]
    return ((t.shape[0], t.shape[2], t.shape[1]),
            (t.stride(0), t.stride(2), t.stride(1)))


def _launch(q, k, v, layout: str) -> torch.Tensor:
    _check_inputs(q, k, v)
    kdim = q.shape[-1]
    if kdim < _HEAD_DIM:
        # Zero head-dim padding is exact: padded columns add 0 to q.k and
        # give 0 outputs, sliced off below.
        pad = (0, _HEAD_DIM - kdim)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v must be contiguous in the head dim")
    lib = _library()
    # empty_like keeps q's memory order, so a transposed view in gives a
    # tensor that transposes back to contiguous.
    out = torch.empty_like(q)
    (b, h, n), sq = _axes(q, layout)
    _, sk = _axes(k, layout)
    _, sv = _axes(v, layout)
    _, so = _axes(out, layout)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, n, *sq, *sk, *sv, *so, stream)
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            f"{lib.vtd_cuda_error_string(err).decode()} (cudaError {err})")
    with _count_lock:
        flash_attention.launches += 1
    return out[..., :kdim] if kdim < _HEAD_DIM else out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library(_SOURCE)
    fn = lib.vtd_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.vtd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vtd_cuda_error_string.restype = ctypes.c_char_p
    return lib
