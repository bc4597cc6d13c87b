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
    ``kernels/_build.py``) through the custom operators
    ``torch.ops.vtd_torch.flash_attention_{fwd,bwd}`` (kernels/ops.py), or
    raise;
  * any other device raises.

The kernels run on the tensor cores (bf16, and fp32 as 3xTF32) with head
dims of 48, 64 or 128: a smaller K is zero-padded to the next of the
three, which is exact (ViT-H/14's K = 80 runs the 128-wide instance). A
CUDA call with K > 128 raises NotImplementedError: the port has no wider
instance, and it sends no such call to the plain version. They copy q/k/v
rows 16 bytes at a time, so a view whose rows do not start on 16-byte
boundaries (or whose head dim is strided) is refused with ValueError,
never copied; the model's views all qualify.

When q, k or v requires grad, the call goes through
``FlashAttentionFunction``: its forward also writes the fp32 logsumexp and
saves it with the unpadded q, k, v and the output; its backward forms
delta = rowsum(g * out) in fp32 and launches the backward, as the JAX
package's Pallas backward does. The backward sums dq over the key tiles
in order, so the gradients are the same on every run (``DQ_ROUTES``:
fp32 stores each key tile's contribution and adds them in a second
kernel, bf16 runs a dq kernel after the dk/dv kernel). Calls that need
no grad (serving, ``torch.inference_mode``) launch the forward alone,
without the logsumexp.

``dropout_rate``/``dropout_seed`` turn on the JAX kernel's in-kernel
probability dropout (training; keras-MHA semantics). The seed is an
integer (taken mod 2**32) or a one-element uint32 tensor on the inputs'
device; the kernels read it from device memory, so a CUDA graph captured
over a train step replays each step with the seed its caller wrote there,
and the model passes a view of its seed table (no host copy per launch).
``flash_attention`` copies an integer seed to the device once per call on
the kernel route. The normaliser sums
the undropped probabilities, and each probability is multiplied by
keep / (1 - rate) before P@V. The keep mask is ``dropout_keep_mask``, the
JAX package's counter hash of the seed and the global (batch*head, query,
key) indices, so the masks are bit-equal to JAX's on every device, and
the backward replays them. ``offsets = (bh_base, q_base, k_base)`` are
the global coordinates of the call's first batch*head row, query and key:
a call over a shard of the batch (data parallelism) or a ring attention
block (kernels/ring_attention.py) passes its own, so it draws the mask
that the whole array draws there; they default to 0 and change nothing
but the mask. Three more entries, ``(inner_local, inner_global,
inner_base)``, map a local batch*head row i to the global row ``(i //
inner_local) * inner_global + inner_base + i % inner_local`` before
``bh_base`` is added: a rank of tensor parallelism holds heads [h0, h0 +
H_l) of every image, (H_l, H, h0), and a rank of sequence sharding whole
windows of every image (``mask_coords``); the default (1, 1, 0) is the
identity. The JAX package forces its chunked XLA
backward (and a forward without lse) under dropout; the port keeps the
Function's design, one forward launch that writes out and lse with the
mask applied and then the backward kernel with the mask replayed, which
gives the same gradients: dv = (scale p)^T g, ds = p (scale g v^T - delta)
with scale = keep / (1 - rate) and delta = rowsum(g * out) of the dropped
output.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

FWD_SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
_HEAD_DIMS = (48, 64, 128)   # the kernels' head dims; smaller K is padded
_ALIGN = 16                  # bytes: cp.async copies move 16 at once
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64           # keys per tile of the backward kernels
# The backward's two ways of summing dq over the key tiles in order, and
# the request that holds the C entry point to each (None: by dtype):
# "split", a dq kernel per query tile after the dk/dv kernel, which
# recomputes S and dP; "partials" (fp32 only), the dk/dv kernel stores
# each key tile's dq contribution and a sum kernel adds them.
DQ_ROUTES = {None: 0, "split": 1, "partials": 2}
# The largest workspace the partials route takes unasked: tiles times dq's
# bytes (334 MB for reference_608 at batch 8); past it fp32 takes "split".
PARTIALS_MAX_BYTES = 1 << 30
_count_lock = threading.Lock()
_M32 = 0xFFFFFFFF


def _keep_threshold(rate: float) -> int:
    """uint32 threshold: hash < threshold <=> keep (the JAX package's)."""
    return min(2 ** 32 - 1, int(round((1.0 - rate) * 4294967296.0)))


def _u32(x):
    """A Python int or an int64 tensor holding x mod 2**32."""
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) and a uint32 constant c. A c
    of 2**31 or more is taken as c - 2**32, the same residue, so |x * c| <
    2**63 and no int64 product overflows; ``& 0xFFFFFFFF`` of the (two's
    complement) product is the residue."""
    if c >= 2 ** 31:
        c -= 2 ** 32
    return (x * c) & _M32


def dropout_keep_mask(seed, bh_idx, q_idx, k_idx, threshold: int):
    """Counter-based dropout mask: keep iff hash(seed, bh, qi, kj) < t.

    The JAX package's murmur3-finalizer hash over the global (batch*head,
    query, key) coordinates, bit for bit: uint32 arithmetic, here in int64
    reduced mod 2**32 after every add and multiply (shifts act on the
    reduced, non-negative values, so they are logical). The indices
    broadcast against each other, on any device."""
    x = (_u32(seed) + _mul32(_u32(bh_idx), 0x9E3779B1)
         + _mul32(_u32(q_idx), 0x85EBCA6B)
         + _mul32(_u32(k_idx), 0xC2B2AE35)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x < threshold


def _dropout_args(rate, seed):
    """``(seed, rate)``, or None without dropout, with the JAX wrapper's
    checks and messages; an integer seed is reduced mod 2**32, a tensor
    seed must be a one-element uint32 tensor."""
    if rate in (None, 0.0):
        return None
    rate = float(rate)
    if not 0.0 < rate < 1.0:
        raise ValueError(
            f"dropout_rate must be in (0, 1), got {rate} (1.0 would "
            "drop everything; larger values wrap the keep threshold)")
    if seed is None:
        raise ValueError("dropout_rate needs a dropout_seed")
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.uint32:
            raise ValueError(
                f"a tensor dropout_seed is a one-element uint32 tensor, got "
                f"{tuple(seed.shape)} {seed.dtype}")
        return seed, rate
    return int(seed) & _M32, rate


def seed_tensor(seed: int, device) -> torch.Tensor:
    """The kernels' form of an integer seed: a one-element uint32 tensor on
    ``device`` holding ``seed`` mod 2**32 (one host-to-device copy)."""
    return torch.tensor([int(seed) & _M32], dtype=torch.int64).to(
        torch.uint32).to(device)


IDENTITY_MAP = (1, 1, 0)


def mask_coords(offsets) -> tuple:
    """``(bh_base, q_base, k_base, inner_local, inner_global, inner_base)``
    of ``offsets``, which gives the first three (the row map then defaults
    to the identity) or all six (module docstring); the bases reduced mod
    2**32. Raises ValueError for another length or an ``inner_local``
    below 1."""
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) == 3:
        offsets += IDENTITY_MAP
    if len(offsets) != 6 or offsets[3] < 1:
        raise ValueError(
            "offsets are (bh_base, q_base, k_base[, inner_local, "
            f"inner_global, inner_base]) with inner_local >= 1, got {offsets}")
    return tuple(o & _M32 for o in offsets[:3]) + offsets[3:]


def map_rows(rows: torch.Tensor, base: int, row_map=IDENTITY_MAP):
    """Global rows of the local ``rows`` (int64): ``base + (rows //
    inner_local) * inner_global + inner_base + rows % inner_local``."""
    inner_local, inner_global, inner_base = row_map
    return (base + (rows // inner_local) * inner_global + inner_base
            + rows % inner_local)


def _dropout_scale(dropout, b: int, h: int, n: int, device,
                   offsets=(0, 0, 0), m: int | None = None) -> torch.Tensor:
    """(b, h, n, m) fp32 keep / (1 - rate) of the mask over heads-major
    scores (m = n by default), batch*head index b * h + head (the kernels'
    numbering) mapped and counted as ``offsets`` say (``mask_coords``),
    query and key indices counted from theirs."""
    seed, rate = dropout
    m = n if m is None else m
    bh_base, q_base, k_base, *row_map = mask_coords(offsets)
    bh = map_rows(torch.arange(b * h, device=device), bh_base,
                  row_map).reshape(b, h, 1, 1)
    keep = dropout_keep_mask(
        seed, bh, (torch.arange(n, device=device) + q_base)[:, None],
        (torch.arange(m, device=device) + k_base)[None, :],
        _keep_threshold(rate))
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).float()


def _heads_major(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A (B, H, N, K) view of a layout-ordered tensor (and back: the
    transpose is its own inverse)."""
    return t if layout == "bhnk" else t.transpose(1, 2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhk", dropout=None,
                        offsets=(0, 0, 0), out_dtype=None) -> torch.Tensor:
    """Materialised-softmax version: fp32 scores and softmax, probabilities
    cast to v's dtype before P@V with fp32 accumulation, output in q's
    dtype (as the JAX package's ``reference_attention``), or in
    ``out_dtype`` (fp32 for a ring block). ``dropout`` (``(seed, rate)``)
    multiplies the probabilities by keep / (1 - rate) before the cast, the
    JAX package's masked oracle; ``offsets`` place the mask (module
    docstring)."""
    if layout == "bhnk":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        b, h, n, m = probs.shape
        probs = probs * _dropout_scale(dropout, b, h, n, probs.device,
                                       offsets, m)
    # bf16 x bf16 products are exact in fp32, so upcasting the rounded
    # probabilities reproduces a bf16 matmul with fp32 accumulation.
    out = torch.einsum("bhnm,bmhk->bnhk", probs.to(v.dtype).float(),
                       v.float()).to(out_dtype or q.dtype)
    return out.transpose(1, 2) if layout == "bhnk" else out


def reference_attention_lse(q: torch.Tensor, k: torch.Tensor,
                            layout: str = "bnhk") -> torch.Tensor:
    """(B, H, N) fp32 logsumexp of the scores of each query row; dropout
    leaves it unchanged (the normaliser sums undropped probabilities)."""
    q, k = _heads_major(q, layout), _heads_major(k, layout)
    scores = torch.einsum("bhnk,bhmk->bhnm", q.float(), k.float())
    return torch.logsumexp(scores, dim=-1)


def reference_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor,
                                 layout: str = "bnhk", dropout=None,
                                 offsets=(0, 0, 0), lse=None, delta=None,
                                 out_dtype=None):
    """(dq, dk, dv) of ``reference_attention`` for the output cotangent g,
    as the JAX package's ``_flash_bwd_chunked`` (fp32 variant) computes
    them: fp32 scores, softmax and g v^T; with ``dropout`` (``(seed,
    rate)``) the replayed mask's scale = keep / (1 - rate) multiplies g v^T
    and p (pd = scale * p); pd cast to the input dtype before dv = pd^T g;
    ds = p * (dp - rowsum(dp * p)) cast to the input dtype before dq = ds k
    and dk = ds^T q; fp32 accumulation, grads in the inputs' dtypes and
    layout; ``offsets`` place the mask.

    With ``lse`` and ``delta`` (``(B, H, N)`` fp32, what the backward
    kernel takes) it is the kernel's plain version: p = exp(s - lse) and
    ds = p * (dp - delta), so k and v may be one block of a longer
    sequence whose statistics these are (a ring attention step), and
    ``out_dtype`` (fp32) returns the grads unrounded."""
    qh, kh, vh, gh = (_heads_major(t, layout) for t in (q, k, v, g))
    dtype = q.dtype
    scores = torch.einsum("bhnk,bhmk->bhnm", qh.float(), kh.float())
    p = (torch.softmax(scores, dim=-1) if lse is None
         else torch.exp(scores - lse[..., None]))
    dp = torch.einsum("bhnk,bhmk->bhnm", gh.float(), vh.float())
    pd = p
    if dropout is not None:
        b, h, n, m = p.shape
        scale = _dropout_scale(dropout, b, h, n, p.device, offsets, m)
        dp, pd = dp * scale, p * scale
    dv = torch.einsum("bhnm,bhnk->bhmk", pd.to(dtype).float(), gh.float())
    if delta is None:
        delta = (dp * p).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    ds = ds.to(dtype).float()
    dq = torch.einsum("bhnm,bhmk->bhnk", ds, kh.float())
    dk = torch.einsum("bhnm,bhnk->bhmk", ds, qh.float())
    return tuple(_heads_major(t.to(out_dtype or ref.dtype), layout)
                 for t, ref in ((dq, q), (dk, k), (dv, v)))


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over the kernels (``use_kernel``) or the
    plain versions, with optional dropout (``(seed, rate)``, replayed in
    the backward). The kernel route saves the forward's fp32 logsumexp for
    the backward kernel; the plain route recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, layout: str, use_kernel: bool, dropout=None,
                offsets=(0, 0, 0)):
        if use_kernel:
            out, lse = _launch_forward(q, k, v, layout, with_lse=True,
                                       dropout=dropout, offsets=offsets)
        else:
            out = reference_attention(q, k, v, layout, dropout, offsets)
            lse = None
        # Unpadded q/k/v: the backward re-pads them, so a call with a padded
        # head dim does not hold a padded copy between the passes.
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout = layout
        ctx.use_kernel = use_kernel
        ctx.dropout = dropout
        ctx.offsets = offsets
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.use_kernel:
            # delta = rowsum(g * out) in fp32, outside the kernel, as the
            # JAX package's _flash_bwd_pallas computes it; with dropout it
            # is the dropped output's, which the replay needs.
            delta = _heads_major((g.float() * out.float()).sum(dim=-1),
                                 ctx.layout).contiguous()
            dq, dk, dv = _launch_backward(q, k, v, g, lse, delta, ctx.layout,
                                          ctx.dropout, offsets=ctx.offsets)
        else:
            dq, dk, dv = reference_attention_backward(
                q, k, v, g, ctx.layout, ctx.dropout, ctx.offsets)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    layout: str = "bnhk", dropout_rate: float | None = None,
                    dropout_seed=None, with_lse: bool = False,
                    offsets=(0, 0, 0)):
    """Attention over ``layout``-ordered q/k/v; see the module docstring.

    ``dropout_rate`` 0 or None means no dropout; a rate outside (0, 1), or
    a rate without ``dropout_seed`` (an integer, taken mod 2**32, or a
    one-element integer tensor), raises ValueError. ``offsets`` are the
    global (batch*head, query, key) coordinates of the first row, query and
    key, and optionally the batch*head row map, which place the dropout
    mask (module docstring, ``mask_coords``). Returns the output,
    or ``(output, lse)`` with ``with_lse`` (lse is ``(B, H, N)`` fp32;
    that form is not differentiable).
    """
    if layout not in ("bnhk", "bhnk"):
        raise ValueError(f"unknown layout {layout!r}")
    dropout = _dropout_args(dropout_rate, dropout_seed)
    devices = {t.device.type for t in (q, k, v)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"flash_attention takes q/k/v all on the CPU or all on CUDA, "
            f"got devices {sorted(devices)}")
    use_kernel = devices == {"cuda"}
    if use_kernel and dropout is not None:
        seed, rate = dropout
        if not isinstance(seed, torch.Tensor):
            seed = seed_tensor(seed, q.device)
        elif seed.device != q.device:
            raise ValueError(f"the dropout seed lies on {seed.device}, "
                             f"q/k/v on {q.device}")
        dropout = seed, rate
    offsets = mask_coords(offsets)
    if with_lse:
        if use_kernel:
            return _launch_forward(q, k, v, layout, with_lse=True,
                                   dropout=dropout, offsets=offsets)
        return (reference_attention(q, k, v, layout, dropout, offsets),
                reference_attention_lse(q, k, layout))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, layout, use_kernel,
                                            dropout, offsets)
    if use_kernel:
        return _launch_forward(q, k, v, layout, dropout=dropout,
                               offsets=offsets)
    return reference_attention(q, k, v, layout, dropout, offsets)


# Kernel launches, one count per kernel wrapper; the plain path adds none.
flash_attention.launches = 0                # forward, no lse, no dropout
flash_attention.lse_launches = 0            # forward with lse, no dropout
flash_attention.drop_launches = 0           # forward with dropout
flash_attention.backward_launches = 0       # backward, no dropout
flash_attention.backward_drop_launches = 0  # backward with dropout replay


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
    kernel_width(shape[-1])
    if tensors[0].numel() == 0:
        raise ValueError("empty q/k/v")


def kernel_width(kdim: int) -> int:
    """The head dim of the kernel instance that runs K = ``kdim``: the
    narrowest of ``_HEAD_DIMS`` that holds it. Raises NotImplementedError
    past the widest (the port has no instance for K > 128)."""
    for width in _HEAD_DIMS:
        if kdim <= width:
            return width
    raise NotImplementedError(
        f"head dim {kdim}: the flash kernels have instances of head dims "
        f"{_HEAD_DIMS} and none wider than {_HEAD_DIMS[-1]}")


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the head dim to the kernels' width: K <= 48 to 48, 48 < K
    <= 64 to 64, 64 < K <= 128 to 128. Exact: padded columns add 0 to q.k
    and to g.v and give 0 outputs and grads, sliced off afterwards."""
    width = kernel_width(t.shape[-1])
    if t.shape[-1] < width:
        return F.pad(t, (0, width - t.shape[-1]))
    return t


def _misalignment(t: torch.Tensor, layout: str):
    """Why the kernels cannot read t's rows, or None. They copy each
    (batch, head, token) row into shared memory 16 bytes at a time, so the
    head dim must be contiguous, and the data pointer and the batch, head
    and token strides (of axes longer than 1) must be multiples of 16
    bytes."""
    if t.stride(-1) != 1:
        return "is not contiguous in the head dim"
    if t.data_ptr() % _ALIGN:
        return (f"starts {t.data_ptr() % _ALIGN} bytes past a {_ALIGN}-byte "
                "boundary")
    sizes, strides = _axes(t, layout)
    if any(n > 1 and (s * t.element_size()) % _ALIGN
           for n, s in zip(sizes, strides)):
        return (f"has batch/head/token strides {tuple(strides)} (elements of "
                f"{t.element_size()} bytes) that are not multiples of "
                f"{_ALIGN} bytes")
    return None


def _kernel_operands(layout: str, **tensors) -> list:
    """The tensors padded to the kernels' head dim; raises ValueError for
    one whose rows the kernels cannot read (never copies it)."""
    padded = []
    for name, t in tensors.items():
        t = _pad_head_dim(t)
        why = _misalignment(t, layout)
        if why is not None:
            raise ValueError(
                f"{name} {why}; the flash kernels read 16-byte-aligned rows "
                "with a unit head-dim stride")
        padded.append(t)
    return padded


def _axes(t: torch.Tensor, layout: str):
    """(batch, heads, tokens) sizes and strides of a layout-ordered tensor."""
    if layout == "bhnk":
        return t.shape[:3], t.stride()[:3]
    return ((t.shape[0], t.shape[2], t.shape[1]),
            (t.stride(0), t.stride(2), t.stride(1)))


def _dropout_c_args(dropout, offsets=(0, 0, 0)) -> tuple:
    """The kernels' (flag, seed address, threshold, inv_keep, bh_base,
    q_base, k_base, inner_local, inner_global, inner_base) arguments for
    ``(seed tensor, rate)`` and the mask's offsets (``mask_coords``)."""
    offsets = mask_coords(offsets)
    if dropout is None:
        return (0, None, 0, 0.0) + offsets
    seed, rate = dropout
    return (1, seed.data_ptr(), _keep_threshold(rate),
            1.0 / (1.0 - rate)) + offsets


def _launch_forward(q, k, v, layout: str, with_lse: bool = False,
                    dropout=None, offsets=(0, 0, 0), out_fp32: bool = False,
                    state=None, suspend: bool = False):
    """One forward launch through ``torch.ops.vtd_torch.flash_attention_fwd``
    (kernels/ops.py): ``out``, or ``(out, lse)`` with ``with_lse``;
    ``offsets`` place the dropout mask (``mask_coords``); ``out_fp32``
    takes the kernel's fp32-output instance (out unrounded, whatever the
    input dtype). A ring attention block resumes the online softmax's
    ``state`` (``(acc, m, l)``, as a suspended launch returns it) and,
    with ``suspend``, returns its own state in place of ``(out, lse)``:
    blocks chained so in key order compute what one launch over all the
    keys computes."""
    _check_inputs(q, k, v)
    kdim = q.shape[-1]
    q, k, v = (_pad_head_dim(t) for t in (q, k, v))
    seed, rate = dropout or (None, 0.0)
    acc_in, m_in, l_in = state if state is not None else (None, None, None)
    out, lse, m, l = torch.ops.vtd_torch.flash_attention_fwd(
        q, k, v, layout, with_lse, seed, rate, *mask_coords(offsets),
        out_fp32=out_fp32, acc_in=acc_in, m_in=m_in, l_in=l_in,
        suspend=suspend)
    if suspend:
        return out, m, l          # at the padded width, as the next reads it
    out = out[..., :kdim] if kdim < out.shape[-1] else out
    return (out, lse) if with_lse else out


def partials_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the partials route's fp32 workspace for (b, h, n) rows of
    head dim d: one dq per key tile."""
    return -(-n // KEY_TILE) * b * h * n * d * 4


def dq_route(dtype: torch.dtype, request: int = 0,
             workspace_bytes: int = 0) -> str:
    """The name of the dq route that ``request`` (a ``DQ_ROUTES`` value)
    takes for ``dtype``: when 0, fp32 takes "partials" (its 3xTF32
    products make recomputing S and dP the dearer way) unless its
    ``workspace_bytes`` pass PARTIALS_MAX_BYTES, and bf16 "split";
    "partials" in bf16 raises."""
    names = {code: name for name, code in DQ_ROUTES.items()}
    if request not in names:
        raise ValueError(f"dq route request {request} is not one of "
                         f"{sorted(names)}")
    name = names[request] or (
        "partials" if dtype == torch.float32
        and workspace_bytes <= PARTIALS_MAX_BYTES else "split")
    if name == "partials" and dtype != torch.float32:
        raise ValueError("the partials dq route is built for float32 only")
    return name


def _launch_backward(q, k, v, g, lse, delta, layout: str, dropout=None,
                     route: str | None = None, offsets=(0, 0, 0),
                     fp32_dq: bool = False, fp32_dkv: bool = False):
    """dq, dk, dv from the backward kernels, through
    ``torch.ops.vtd_torch.flash_attention_bwd`` (kernels/ops.py). lse and
    delta are (B, H, N) fp32; dq accumulates in fp32 and is cast to q's
    dtype here, dk and dv come out of the kernel in the input dtype.
    ``dropout`` is the forward's ``(seed, rate)``, whose mask the kernel
    replays, reading the seed from device memory, placed by ``offsets``.
    ``route`` names one of ``DQ_ROUTES`` to take instead of the one the
    dtype selects (the tests and the timings use it). ``fp32_dq`` returns
    dq as the kernel summed it, in fp32, and ``fp32_dkv`` dk and dv (a ring
    attention step adds them to its accumulators before any rounding)."""
    _check_inputs(q, k, v, g)
    kdim = q.shape[-1]
    # The incoming cotangent is whatever view autograd hands over (an
    # expanded tensor, a transpose): it is made contiguous when the kernel
    # could not read it. q, k and v are the caller's and must already fit.
    g = _pad_head_dim(g)
    if _misalignment(g, layout) is not None:
        g = g.contiguous()
    q, k, v = (_pad_head_dim(t) for t in (q, k, v))
    (b, h, n), _ = _axes(q, layout)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, n) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous float32 {(b, h, n)} tensor on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    seed, rate = dropout or (None, 0.0)
    dq, dk, dv = torch.ops.vtd_torch.flash_attention_bwd(
        q, k, v, g, lse, delta, layout, seed, rate, DQ_ROUTES[route],
        *mask_coords(offsets), dkv_fp32=fp32_dkv)
    dq = dq[..., :kdim]
    return (dq if fp32_dq else dq.to(q.dtype)), dk[..., :kdim], dv[..., :kdim]
