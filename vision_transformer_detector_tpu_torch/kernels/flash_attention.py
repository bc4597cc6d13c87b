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
  * CUDA tensors launch the kernels (built at first use by
    ``kernels/_build.py``) through the custom operators of kernels/ops.py,
    or raise: the forward operator ``torch.ops.vtd_torch.flash_attention_fwd``
    runs ``csrc/flash_attention_fwd_sm90.cu`` (wgmma fed by TMA) for bf16
    at K <= 256, ``csrc/flash_attention_fwd_wide.cu`` for fp32 at 64 < K
    <= 3072 and bf16 at 256 < K <= 4096 (past 384 and 512 as a
    thread-block cluster) and ``csrc/flash_attention_fwd.cu`` (mma.sync)
    for the rest (``forward_kernel``), and
    ``flash_attention_bwd`` runs
    ``csrc/flash_attention_bwd_sm90.cu`` (wgmma fed by TMA) for bf16 at
    K <= 256, ``csrc/flash_attention_bwd.cu`` (mma.sync) for fp32 at
    K <= 128 and ``csrc/flash_attention_bwd_wide.cu`` for the rest: fp32
    past 128 and bf16 past 256 as a thread-block cluster (to fp32 1024 and
    bf16 2048), the windowed route past that (``backward_kernel``);
  * any other device raises.

The kernels run on the tensor cores (bf16, and fp32 as 3xTF32) at every
head dim K, as the JAX package does. The wgmma kernels (bf16) have
instances of width 64, 128 and 256 and form the scores over the whole of
K once per tile. The mma.sync kernels (``head_dim_plan``) take K <= 128 on
instances of width 48, 64 or 128 (the fp32 forward past 64 on the wide
forward's column halves). Past that the wide forward forms the scores once
a tile too, its two halves of a CTA each owning half of O's columns (fp32
on mma.sync to K 384, bf16 on wgmma to K 512), and a thread-block cluster
of ceil(K / 384) or ceil(K / 512) such CTAs (at most 8) past that, each
owning a share of the columns, the partial scores summed across the
cluster. The backward past fp32 K 128 and bf16 K 256 is a thread-block
cluster too: ceil(K / 128) CTAs in fp32 (mma.sync) or ceil(K / 256) in
bf16 (wgmma fed by TMA), at most 8, each owning a share of dk's, dv's and
dq's columns, the partial S and dP summed across the cluster once a step
(``backward_cluster_size``). Past the clusters' reach (the forward past
fp32 3072 and bf16 4096, the backward past 1024 and 2048) the windowed
routes form each (query tile, key tile) pair's S (and in the backward dP)
over the whole of K once, in a scores kernel (fp32 mma.sync 3xTF32, bf16
wgmma fed by TMA), park it in a device workspace (``scores_workspace``)
and write the outputs in column windows that read it back. They read
q, k, v (and the
cotangent) at their own K: the loads zero-fill the columns past K and the
stores stop at K. Rows must start on 16-byte boundaries; a K whose rows
cannot (K * itemsize not a multiple of 16 bytes: bf16 K % 8, fp32 K % 4)
is zero-padded to the instance's width, which is exact, and each such
copy is counted in ``flash_attention.operand_copies``. Any other view
whose rows do not start on 16-byte boundaries (or whose head dim is
strided) is refused with ValueError, never copied; the model's views all
qualify.

When q, k or v requires grad, the call goes through
``FlashAttentionFunction``: its forward also writes the fp32 logsumexp and
saves it with the unpadded q, k, v and the output; its backward forms
delta = rowsum(g * out) in fp32 and launches the backward, as the JAX
package's Pallas backward does. The backward sums dq over the key tiles
in order, so the gradients are the same on every run (``DQ_ROUTES``:
fp32 stores each key tile's contribution and adds them in a second
kernel; bf16 runs a dq kernel after the dk/dv kernel, which at K <= 256 with dropout also
writes the keep bits it drew, packed (``pack_keep_bits``), for the dq
kernel to read instead of hashing each score again; the bf16 dq kernels
of every route round dq to bf16 themselves: no cast follows). Calls that
need no grad
(serving, ``torch.inference_mode``) launch the forward alone, without the
logsumexp.

The operators validate once per call signature: kernels/ops.py keeps a
launch plan (the checks passed, the kernel, the C arguments but the data
pointers) for each combination of shapes, strides, dtypes, pointers mod
16, flags and mask coordinates, so a call that repeats one only
allocates its outputs and launches.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

FWD_SOURCE = "flash_attention_fwd.cu"
SM90_SOURCE = "flash_attention_fwd_sm90.cu"
FWD_WIDE_SOURCE = "flash_attention_fwd_wide.cu"     # B1 past 128 / 256
BWD_SOURCE = "flash_attention_bwd.cu"
BWD_WIDE_SOURCE = "flash_attention_bwd_wide.cu"     # B2 past 128 / 256
BWD_SM90_SOURCE = "flash_attention_bwd_sm90.cu"     # bf16 B2 at K <= 256
_HEAD_DIMS = (48, 64, 128)   # the mma.sync instances' widths up to K = 128
_WGMMA_DIMS = (64, 128, 256)   # the wgmma kernels' (bf16, K <= 256)
KEEP_WORD_KEYS = 32          # keys per word of the packed keep bits
CHUNK = 64                   # a padded wide K's unit (columns)
FWD_WINDOW = 128             # the windowed forward's output window
# The widest K one CTA of the wide forward (csrc/flash_attention_fwd_wide.cu)
# holds in each dtype; past it a cluster of ceil(K / WIDE_FWD_MAX) CTAs, up
# to CLUSTER_MAX (the portable cluster size), so to FWD_CLUSTER_REACH; the
# windowed forward takes every K past that.
WIDE_FWD_MAX = {torch.float32: 384, torch.bfloat16: 512}
CLUSTER_MAX = 8
FWD_CLUSTER_REACH = {dtype: CLUSTER_MAX * width
                     for dtype, width in WIDE_FWD_MAX.items()}
# The columns one CTA of the backward's cluster route owns in each dtype;
# a cluster holds ceil(K / BWD_CLUSTER_SHARE) CTAs, to CLUSTER_MAX, so to
# BWD_CLUSTER_REACH; the windowed backward takes every K past that.
BWD_CLUSTER_SHARE = {torch.float32: 128, torch.bfloat16: 256}
BWD_CLUSTER_REACH = {dtype: CLUSTER_MAX * width
                     for dtype, width in BWD_CLUSTER_SHARE.items()}
BWD_WINDOW = 64              # the windowed backward's output windows
_ALIGN = 16                  # bytes: cp.async copies and TMA rows
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64           # keys per tile of the backward kernels
# The backward's two ways of summing dq over the key tiles in order, and
# the request that holds the C entry point to each (None: by dtype):
# "split", a dq kernel per query tile after the dk/dv kernel, which
# recomputes S and dP; "partials" (fp32 only), the dk/dv kernel stores
# each key tile's dq contribution and a sum kernel adds them. On the
# windowed route both take its one dq kernel, which reads dS from the
# scores workspace and sums the key tiles in order.
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
IDENTITY_COORDS = (0, 0, 0) + IDENTITY_MAP


def mask_coords(offsets) -> tuple:
    """``(bh_base, q_base, k_base, inner_local, inner_global, inner_base)``
    of ``offsets``, which gives the first three (the row map then defaults
    to the identity) or all six (module docstring); the bases reduced mod
    2**32. Raises ValueError for another length or an ``inner_local``
    below 1."""
    if type(offsets) is tuple and (offsets == (0, 0, 0)
                                   or offsets == IDENTITY_COORDS):
        return IDENTITY_COORDS
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


def keep_bits_shape(b: int, h: int, n: int) -> tuple:
    """The shape of the packed keep bits of (b, h) rows of n x n scores:
    ``(b * h, ceil(n / 32), n)`` words."""
    return (b * h, -(-n // KEEP_WORD_KEYS), n)


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """The plain version of the wgmma backward's packed keep mask: a
    ``(B, H, N, M)`` boolean mask (query by key) as int64 words ``(B * H,
    ceil(M / 32), N)``, word w of query q holding keys 32w .. 32w + 31 (bit
    i = key 32w + i, 0 past M). The dk/dv kernel writes these words as
    uint32 and the dq kernel reads them; the tests and chip_smoke.py hold
    the kernel's words to this."""
    b, h, n, m = keep.shape
    words = -(-m // KEEP_WORD_KEYS)
    padded = F.pad(keep.to(torch.int64), (0, words * KEEP_WORD_KEYS - m))
    shifted = (padded.reshape(b * h, n, words, KEEP_WORD_KEYS)
               << torch.arange(KEEP_WORD_KEYS, device=keep.device))
    return shifted.sum(-1).transpose(1, 2).contiguous()


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
        # The caller's q/k/v: where their rows cannot be addressed in place
        # the backward pads them again, so no padded copy is held between
        # the passes.
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
    use_kernel = q.is_cuda and k.is_cuda and v.is_cuda
    if not use_kernel:
        devices = {t.device.type for t in (q, k, v)}
        if devices != {"cpu"}:
            raise ValueError(
                f"flash_attention takes q/k/v all on the CPU or all on "
                f"CUDA, got devices {sorted(devices)}")
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
    if ((q.requires_grad or k.requires_grad or v.requires_grad)
            and torch.is_grad_enabled()):
        return FlashAttentionFunction.apply(q, k, v, layout, use_kernel,
                                            dropout, offsets)
    if use_kernel:
        return _launch_forward(q, k, v, layout, dropout=dropout,
                               offsets=offsets)
    return reference_attention(q, k, v, layout, dropout, offsets)


# Kernel launches, one count per kernel wrapper; the plain path adds none.
# The forward's three route counts cover both forward kernels; the wgmma
# forward's launches are counted again on their own.
flash_attention.launches = 0                # forward, no lse, no dropout
flash_attention.lse_launches = 0            # forward with lse, no dropout
flash_attention.drop_launches = 0           # forward with dropout
flash_attention.wgmma_launches = 0          # forward on wgmma (any route)
flash_attention.wide_launches = 0           # forward on the wide kernel
flash_attention.halves_launches = 0         # on its fp32 column halves
flash_attention.cluster_launches = 0        # on its clusters
flash_attention.windowed_launches = 0       # forward on the windowed route
flash_attention.backward_launches = 0       # backward, no dropout
flash_attention.backward_drop_launches = 0  # backward with dropout replay
# Of the two backward counts, the launches of the wgmma backward (bf16,
# K <= 256; its dk/dv and dq kernels count once together).
flash_attention.wgmma_backward_launches = 0
# And those of the fp32 column halves (64 < K <= 128), of the cluster
# route (fp32 past 128, bf16 past 256) and of the windowed route past it.
flash_attention.halves_backward_launches = 0
flash_attention.cluster_backward_launches = 0
flash_attention.windowed_backward_launches = 0
# Operands copied because their rows cannot be addressed in place (K
# padded, or a cotangent view made contiguous); the model's calls make
# none.
flash_attention.operand_copies = 0


def _count(*names: str, n: int = 1) -> None:
    """Add ``n`` to each named counter of ``flash_attention``, under the
    lock: the server's handler threads launch concurrently, and an
    unlocked ``+=`` can lose a count between its read and its write."""
    with _count_lock:
        for name in names:
            setattr(flash_attention, name, getattr(flash_attention, name) + n)


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
    if tensors[0].numel() == 0:
        raise ValueError("empty q/k/v")


class HeadDimPlan(NamedTuple):
    """How a call of head dim K and dtype runs: ``instance`` is the width
    of the mma.sync instance (48, 64, 128) or "wide" (K > 128); ``chunks``
    how many times a call forms one (query tile, key tile) pair's S (and
    dP), 1 on every route: an instance that holds K whole, the clusters,
    which form S once a tile over the cluster, and the windowed routes,
    whose scores kernels park S in a workspace; ``windows`` the forward's
    output column windows, a grid axis of CTAs that read S back from the
    workspace for their own columns (only on the "windowed" forward, else
    1), and ``grad_windows`` the backward's (dq, dk, dv) on its windowed
    route;
    ``forward`` and ``backward`` the kernels that run
    (``forward_kernel``, ``backward_kernel``); ``cluster`` the CTAs of one
    thread-block cluster of the forward (``cluster_size``: past 1 only on
    its "cluster" route) and ``grad_cluster`` the backward's
    (``backward_cluster_size``)."""
    instance: object
    chunks: int
    windows: int
    grad_windows: int
    forward: str
    backward: str
    cluster: int = 1
    grad_cluster: int = 1


def head_dim_plan(kdim: int,
                  dtype: torch.dtype = torch.float32) -> HeadDimPlan:
    """The plan at K = ``kdim`` (any K >= 1, as the JAX package's Pallas
    kernels take any K) in ``dtype``: K <= 48 the 48 instance, K <= 64 the
    64, K <= 128 the 128 (in fp32 the column halves, forward and
    backward); past that "wide": the backward in one window, a cluster of
    ``backward_cluster_size`` CTAs, to BWD_CLUSTER_REACH, past it S and dP
    formed once a tile pair and the outputs in windows of BWD_WINDOW
    columns; and one forward window (a cluster of ``cluster_size`` CTAs
    past WIDE_FWD_MAX) but on the windowed forward (fp32 past 3072, bf16
    past 4096), whose windows are FWD_WINDOW columns."""
    if kdim < 1:
        raise ValueError(f"head dim {kdim} < 1")
    forward = forward_kernel(kdim, dtype)
    backward = backward_kernel(kdim, dtype)
    for width in _HEAD_DIMS:
        if kdim <= width:
            return HeadDimPlan(width, 1, 1, 1, forward, backward)
    windows = -(-kdim // FWD_WINDOW) if forward == "windowed" else 1
    grad_windows = -(-kdim // BWD_WINDOW) if backward == "windowed" else 1
    return HeadDimPlan("wide", 1, windows, grad_windows, forward, backward,
                       cluster_size(kdim, dtype),
                       backward_cluster_size(kdim, dtype))


def kernel_width(kdim: int) -> int:
    """The width a head dim of ``kdim`` is zero-padded to when its rows
    cannot be addressed in place: the instance's (48, 64 or 128) up to
    K = 128, past that the next multiple of 64 (a whole S chunk, and a
    whole TMA box of the wgmma kernels: bf16 K 129 reads as 192)."""
    instance = head_dim_plan(kdim).instance
    return instance if instance != "wide" else -(-kdim // CHUNK) * CHUNK


def forward_kernel(kdim: int, dtype: torch.dtype) -> str:
    """Which forward kernel runs a call: "wgmma" (bf16 at K <= 256,
    csrc/flash_attention_fwd_sm90.cu, instance 64, 128 or 256),
    "mma_sync" (fp32 at K <= 64, csrc/flash_attention_fwd.cu, instance 48
    or 64), and in csrc/flash_attention_fwd_wide.cu, where S is formed once
    a tile and O's columns are split between the two halves of a CTA:
    "halves" (fp32 at 64 < K <= 128: at most two 32-column pairs a half,
    32-key tiles, two CTAs an SM),
    "wide" (fp32 at 128 < K <= 384 and bf16 at 256 < K <= 512) and
    "cluster" (past those, to FWD_CLUSTER_REACH: a thread-block cluster
    of ``cluster_size`` CTAs, each holding a share of the columns); or
    "windowed" (wider still: the windowed route of
    csrc/flash_attention_fwd.cu, a scores kernel that forms each tile
    pair's S once into a workspace, then a window kernel per 128-column
    window of O that reads it back)."""
    if dtype == torch.bfloat16 and kdim <= _WGMMA_DIMS[-1]:
        return "wgmma"
    if dtype == torch.float32 and kdim <= _HEAD_DIMS[1]:
        return "mma_sync"
    if dtype == torch.float32 and kdim <= _HEAD_DIMS[-1]:
        return "halves"
    if kdim <= WIDE_FWD_MAX[dtype]:
        return "wide"
    return "cluster" if kdim <= FWD_CLUSTER_REACH[dtype] else "windowed"


def cluster_size(kdim: int, dtype: torch.dtype) -> int:
    """The CTAs of one thread-block cluster of the forward at K = ``kdim``:
    ceil(K / WIDE_FWD_MAX) on the "cluster" route (2 to CLUSTER_MAX), else
    1."""
    if forward_kernel(kdim, dtype) != "cluster":
        return 1
    return -(-kdim // WIDE_FWD_MAX[dtype])


def backward_kernel(kdim: int, dtype: torch.dtype) -> str:
    """Which backward kernels run a call: "wgmma" (bf16 at K <= 256,
    csrc/flash_attention_bwd_sm90.cu, instance 64, 128 or 256), "mma_sync"
    (fp32 at K <= 128, csrc/flash_attention_bwd.cu: the 48 and 64
    instances, and the column halves at 64 < K <= 128), and in
    csrc/flash_attention_bwd_wide.cu "cluster" (fp32 past 128 and bf16
    past 256, to BWD_CLUSTER_REACH: a thread-block cluster of
    ``backward_cluster_size`` CTAs, each owning a share of the columns, S
    and dP formed once a tile over the cluster) or "windowed" (wider
    still: a scores kernel that forms each tile pair's S and dP once and
    parks P and dS in a workspace, then a dk/dv kernel and a dq kernel per
    64-column window of the outputs that read them back)."""
    if dtype == torch.bfloat16 and kdim <= _WGMMA_DIMS[-1]:
        return "wgmma"
    if kdim <= _HEAD_DIMS[-1]:
        return "mma_sync"
    return "cluster" if kdim <= BWD_CLUSTER_REACH[dtype] else "windowed"


def backward_cluster_size(kdim: int, dtype: torch.dtype) -> int:
    """The CTAs of one thread-block cluster of the backward at K =
    ``kdim``: ceil(K / BWD_CLUSTER_SHARE) on its "cluster" route (2 to
    CLUSTER_MAX), else 1."""
    if backward_kernel(kdim, dtype) != "cluster":
        return 1
    return -(-kdim // BWD_CLUSTER_SHARE[dtype])


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the head dim to ``kernel_width``: K <= 48 to 48, 48 < K
    <= 64 to 64, 64 < K <= 128 to 128, a wider K to a multiple of 64.
    Exact: padded columns add 0 to q.k and to g.v and give 0 outputs and
    grads, sliced off afterwards. The kernel route takes this copy only
    for rows that cannot be addressed in place (``_needs_copy``)."""
    width = kernel_width(t.shape[-1])
    if t.shape[-1] < width:
        return F.pad(t, (0, width - t.shape[-1]))
    return t


def _needs_copy(t: torch.Tensor) -> bool:
    """Whether t's head dim keeps its rows off 16-byte boundaries (K *
    itemsize not a multiple of 16), so the kernels read a padded copy."""
    return (t.shape[-1] * t.element_size()) % _ALIGN != 0


def _addressable(tensors):
    """The tensors as the kernels read them: each whose rows cannot be
    addressed in place padded (and counted in ``operand_copies``), the
    rest as they are. Returns (tensors, the caller's K)."""
    kdim = tensors[0].shape[-1]
    if not _needs_copy(tensors[0]):
        return list(tensors), kdim
    _count("operand_copies", n=len(tensors))
    return [_pad_head_dim(t) for t in tensors], kdim


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
    """The tensors as they are; raises ValueError for one whose rows the
    kernels cannot read (never copies it: the wrappers copy, and count,
    only what ``_addressable`` names)."""
    for name, t in tensors.items():
        why = _misalignment(t, layout)
        if why is not None:
            raise ValueError(
                f"{name} {why}; the flash kernels read 16-byte-aligned rows "
                "with a unit head-dim stride")
    return list(tensors.values())


def _axes(t: torch.Tensor, layout: str):
    """(batch, heads, tokens) sizes and strides of a layout-ordered tensor."""
    if layout == "bhnk":
        return t.shape[:3], t.stride()[:3]
    return ((t.shape[0], t.shape[2], t.shape[1]),
            (t.stride(0), t.stride(2), t.stride(1)))


def _coords(offsets) -> tuple:
    """The six mask coordinates the operators take: ``offsets`` as given,
    the identity row map appended to three (the operator reduces and
    checks them once per launch plan, kernels/ops.py); another length
    raises ``mask_coords``' ValueError."""
    if len(offsets) == 3:
        return tuple(offsets) + IDENTITY_MAP
    return tuple(offsets) if len(offsets) == 6 else mask_coords(offsets)


def _launch_forward(q, k, v, layout: str, with_lse: bool = False,
                    dropout=None, offsets=(0, 0, 0), out_fp32: bool = False,
                    state=None, suspend: bool = False):
    """One forward launch through the custom operator (kernels/ops.py),
    which runs the kernel that ``forward_kernel`` names: ``out``, or
    ``(out, lse)`` with ``with_lse``;
    ``offsets`` place the dropout mask (``mask_coords``); ``out_fp32``
    takes the kernel's fp32-output instance (out unrounded, whatever the
    input dtype). A ring attention block resumes the online softmax's
    ``state`` (``(acc, m, l)``, as a suspended launch returns it) and,
    with ``suspend``, returns its own state in place of ``(out, lse)``:
    blocks chained so in key order compute what one launch over all the
    keys computes. The checks of ``_check_inputs`` run here only when a
    head dim is padded (before the copy); otherwise the operator runs
    them once per launch plan, on the same tensors."""
    kdim = None
    if _needs_copy(q):
        _check_inputs(q, k, v)
        (q, k, v), kdim = _addressable((q, k, v))
    seed, rate = dropout or (None, 0.0)
    acc_in, m_in, l_in = state if state is not None else (None, None, None)
    out, lse, m, l = _FWD_OP(q, k, v, layout, with_lse, seed, rate,
                             *_coords(offsets), out_fp32, acc_in, m_in, l_in,
                             suspend)
    if suspend:
        return out, m, l          # at the width read, as the next reads it
    if kdim is not None:
        out = out[..., :kdim]
    return (out, lse) if with_lse else out


def scores_workspace(b: int, h: int, n: int, kdim: int, dtype: torch.dtype,
                     backward: bool):
    """The windowed routes' scores workspace for (b, h, n) rows of head dim
    ``kdim``: ``(shape, dtype)``. The forward's holds S in fp32, ``(rows,
    np, np)``; the backward's scale P and dS in ``dtype``, ``(rows, 2, np,
    np)``; np = 64 * ceil(n / 64). ``rows`` is one slab's batch*head rows:
    as many as the larger of q's own bytes and one row's need holds, at
    most b * h, so one launch's workspace never passes that; the route runs
    ``scores_slabs`` slabs in turn."""
    np_ = -(-n // KEY_TILE) * KEY_TILE
    item = torch.empty((), dtype=dtype).element_size()
    per_row = np_ * np_ * (2 * item if backward else 4)
    rows = min(b * h, max(b * h * n * kdim * item, per_row) // per_row)
    if backward:
        return (rows, 2, np_, np_), dtype
    return (rows, np_, np_), torch.float32


def scores_slabs(b: int, h: int, n: int, kdim: int, dtype: torch.dtype,
                 backward: bool) -> int:
    """How many slabs of ``scores_workspace``'s rows a windowed call of
    (b, h, n) rows runs in turn."""
    rows = scores_workspace(b, h, n, kdim, dtype, backward)[0][0]
    return -(-(b * h) // rows)


def partials_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the partials route's fp32 workspace for (b, h, n) rows of
    head dim d: one dq per key tile."""
    return -(-n // KEY_TILE) * b * h * n * d * 4


def dq_route(dtype: torch.dtype, request: int = 0,
             workspace_bytes: int = 0) -> str:
    """The name of the dq route that ``request`` (a ``DQ_ROUTES`` value)
    takes for ``dtype``: when 0, fp32 takes "partials" (its 3xTF32
    products make recomputing S and dP the dearer way) unless its
    ``workspace_bytes`` pass PARTIALS_MAX_BYTES, and bf16 "split" (at
    K <= 256 the wgmma kernels' one route); "partials" in bf16 raises."""
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
    delta are (B, H, N) fp32; dq accumulates in fp32 and comes out in q's
    dtype (the bf16 dq kernels round it themselves), dk and dv in the
    input dtype.
    ``dropout`` is the forward's ``(seed, rate)``, whose mask the kernel
    replays, reading the seed from device memory, placed by ``offsets``.
    ``route`` names one of ``DQ_ROUTES`` to take instead of the one the
    dtype selects (the tests and the timings use it). ``fp32_dq`` returns
    dq as the kernel summed it, in fp32, and ``fp32_dkv`` dk and dv (a ring
    attention step adds them to its accumulators before any rounding)."""
    kdim = None
    if _needs_copy(q):
        _check_inputs(q, k, v, g)
        (q, k, v, g), kdim = _addressable((q, k, v, g))
    # The incoming cotangent is whatever view autograd hands over (an
    # expanded tensor, a transpose): it is made contiguous when the kernel
    # could not read it. q, k and v are the caller's and must already fit.
    if _misalignment(g, layout) is not None:
        g = g.contiguous()
        _count("operand_copies")
    seed, rate = dropout or (None, 0.0)
    dq, dk, dv = _BWD_OP(q, k, v, g, lse, delta, layout, seed, rate,
                         DQ_ROUTES[route], *_coords(offsets), fp32_dkv,
                         fp32_dq)
    if kdim is not None:
        dq, dk, dv = dq[..., :kdim], dk[..., :kdim], dv[..., :kdim]
    return dq, dk, dv


def _check_side_inputs(q, lse, delta, layout: str) -> None:
    """The backward's checks of lse and delta: contiguous float32 ``(B, H,
    N)`` on q's device."""
    (b, h, n), _ = _axes(q, layout)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, n) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous float32 {(b, h, n)} tensor on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


# The two operators' default overloads, bound by kernels/ops.py when it
# defines them (importing the package ``kernels`` does).
_FWD_OP = _BWD_OP = None
