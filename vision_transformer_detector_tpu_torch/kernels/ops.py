"""The port's CUDA kernels as PyTorch custom operators,
``torch.ops.vtd_torch.*``.

No JAX counterpart: this is what lets ``torch.export`` (export.py) trace
a model whose kernels are ``ctypes`` calls. Each launcher of the kernel
modules is one operator, defined through ``torch.library.Library``
(``define`` with its schema, ``impl(..., "CUDA")``, ``register_fake``),
with

  * a CUDA implementation only: the ``ctypes`` launch on the current
    stream, the check of the CUDA error code it returns, and the launch
    counters of the public wrapper, which count at call time (in an
    exported program too);
  * a fake implementation (``register_fake``) that gives the outputs'
    shapes, dtypes and strides and nothing else, for tracing.

Every operator launches from a plan built once per call signature: the
checks, the choice of kernel or instance and the copies the call must make
are settled there, and a call allocates its output, reads the addresses
and the current stream and makes one ctypes call that hands the C entry
point the plan's argument block (csrc/flash_launch.cuh,
csrc/launch_common.cuh). The entry point makes the plan's device current
itself.

There is no CPU implementation: a CPU tensor handed to an operator
raises NotImplementedError. The wrappers (kernels/flash_attention.py,
dropout.py, fused_ln.py, fused_ffn.py, quantization.py) choose the plain
PyTorch version for CPU tensors before they reach an operator, and an
exported program traced on the CPU therefore holds the plain versions and
no operator.

The operators take what the kernels take: the wrappers check shapes and
dtypes, pick the flash forward's kernel and pad a head dim whose rows
cannot be addressed in place, the operators make the copies a kernel
needs (contiguity, 16-byte alignment) and refuse the views the flash
kernels cannot read. Importing this module (the package
``kernels`` does) registers every operator and binds each wrapper module's
``.default`` overloads; it builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import (_build, dropout, flash_attention, fused_ffn, fused_ln,
               quantization)

NAMESPACE = "vtd_torch"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {
    "fwd": flash_attention.FWD_SOURCE,
    "fwd_sm90": flash_attention.SM90_SOURCE,
    "fwd_wide": flash_attention.FWD_WIDE_SOURCE,
    "bwd": flash_attention.BWD_SOURCE,
    "bwd_wide": flash_attention.BWD_WIDE_SOURCE,
    "bwd_sm90": flash_attention.BWD_SM90_SOURCE,
    "ln": fused_ln.SOURCE,
    "ffn": fused_ffn.SOURCE,
    "int8": quantization.SOURCE,
    "drop": dropout.SOURCE,
}


# The C entry point of each library but the flash ones.
_ENTRIES = {"ln": "vtd_layer_norm", "ffn": "vtd_dense_mish",
            "int8": "vtd_int8_dense", "drop": "vtd_dropout"}
# The pointer arguments of each entry point: its argument block, the
# call's device addresses and the stream. The flash forwards: the block,
# eleven device addresses (the last the windowed route's workspace), the
# dropout seed's and the stream; the backwards: the block, ten, the seed's
# and the stream.
_POINTERS = {"ln": 6, "ffn": 6, "int8": 8, "drop": 5, "fwd": 14,
             "fwd_sm90": 14, "fwd_wide": 14}
# The libraries whose plans ask their source which instance runs.
_QUERIED = ("ffn", "int8")
# The flash libraries' occupancy queries of their cluster routes, and what
# each launches.
_CLUSTER_QUERIES = {"fwd_wide": "vtd_flash_attention_fwd_wide_clusters",
                    "bwd_wide": "vtd_flash_attention_bwd_clusters"}
_CLUSTER_WHAT = {"fwd_wide": "forward", "bwd_wide": "backward"}


def _entry(kind: str) -> str:
    """The C entry point of a library: the wide backward shares the narrow
    one's name (flash_bwd_common.cuh)."""
    if kind in _ENTRIES:
        return _ENTRIES[kind]
    return "vtd_flash_attention_" + ("bwd" if kind == "bwd_wide" else kind)


@functools.cache
def _library(kind: str) -> ctypes.CDLL:
    """The built library of one source, with its entry point's C types:
    every argument is an address (the plan's argument block, the call's
    device addresses and the stream)."""
    lib = _build.load_library(_SOURCES[kind])
    fn = getattr(lib, _entry(kind))
    fn.argtypes = [ctypes.c_void_p] * _POINTERS.get(kind, 13)
    fn.restype = ctypes.c_int
    if kind in _CLUSTER_QUERIES:
        query = getattr(lib, _CLUSTER_QUERIES[kind])
        query.argtypes = [ctypes.c_void_p]
        query.restype = ctypes.c_int
    if kind in _QUERIED:
        query = getattr(lib, _entry(kind) + "_plan")
        query.argtypes = [ctypes.c_void_p]
        query.restype = ctypes.c_int
    lib.vtd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vtd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _dropout(seed: Optional[torch.Tensor], rate: float, device):
    """The wrappers' ``(seed, rate)`` form, None for rate 0. The seed is a
    one-element uint32 tensor on the inputs' device, which the kernel
    reads: no host value is baked into the launch."""
    if rate == 0.0:
        return None
    if (seed is None or seed.numel() != 1 or seed.device != device
            or seed.dtype != torch.uint32):
        raise ValueError(
            "dropout needs a one-element uint32 seed tensor on "
            f"{device}, got "
            + ("None" if seed is None else
               f"{tuple(seed.shape)} {seed.dtype} on {seed.device}"))
    return seed, rate


# ---------------------------------------------------------------------------
# B1 and B2: the flash-attention operators and their launch plans
# ---------------------------------------------------------------------------
#
# Every operator is defined through ``torch.library.Library`` (``define``,
# ``impl(..., "CUDA")``, ``register_fake``; at the end of this module): the
# dispatcher calls its CUDA implementation with no Python layer of its own
# in between (``custom_op`` adds one, and an autograd kernel in Python,
# which these operators do not need: the wrappers' autograd Functions call
# them). The flash schemas are the ones ``custom_op`` gave them before,
# plus the backward's trailing ``dq_fp32``, so saved programs keep their
# nodes.
#
# A call looks up its launch plan by everything the checks and the C
# arguments depend on but the data pointers: the operands' shapes, strides,
# dtypes, devices and pointers mod 16, the flags, the dropout rate and the
# mask's coordinates. A plan is built once: it runs every check (each
# ValueError word for word as before), picks the kernel, loads its library
# and fills the scalar block the C entry point reads (FwdArgs, BwdArgs:
# csrc/flash_launch.cuh). A call then allocates its outputs, reads the
# pointers and the current stream, and launches: one ctypes call of a
# dozen arguments.

FLASH_FWD_SCHEMA = (
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, str layout, "
    "bool with_lse, Tensor? dropout_seed, float dropout_rate, "
    "SymInt bh_base=0, SymInt q_base=0, SymInt k_base=0, "
    "SymInt inner_local=1, SymInt inner_global=1, SymInt inner_base=0, "
    "bool out_fp32=False, Tensor? acc_in=None, Tensor? m_in=None, "
    "Tensor? l_in=None, bool suspend=False) "
    "-> (Tensor, Tensor, Tensor, Tensor)")
FLASH_BWD_SCHEMA = (
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor g, "
    "Tensor lse, Tensor delta, str layout, Tensor? dropout_seed, "
    "float dropout_rate, SymInt request=0, SymInt bh_base=0, "
    "SymInt q_base=0, SymInt k_base=0, SymInt inner_local=1, "
    "SymInt inner_global=1, SymInt inner_base=0, bool dkv_fp32=False, "
    "bool dq_fp32=True) -> (Tensor, Tensor, Tensor)")
# At most this many plans are kept; the cache is emptied when full (a
# model has a handful of shapes: one per attention call site and batch).
PLAN_CACHE_SIZE = 256
_F32 = torch.float32
_u32, _f32c, _i32 = ctypes.c_uint32, ctypes.c_float, ctypes.c_int
_MASK_FIELDS = [("threshold", _u32), ("inv_keep", _f32c)] + [
    (name, _u32) for name in ("bh_base", "q_base", "k_base", "inner_local",
                              "inner_global", "inner_base")]


class FwdArgs(ctypes.Structure):
    """csrc/flash_launch.cuh's FlashFwdArgs, field for field."""
    _fields_ = [(name, _i32) for name in (
        "device", "dtype", "out_fp32", "batch", "heads", "seq_len",
        "head_dim", "dropout")] + [("strides", ctypes.c_longlong * 12)] \
        + _MASK_FIELDS + [("ws_rows", _i32)]


class BwdArgs(ctypes.Structure):
    """csrc/flash_launch.cuh's FlashBwdArgs, field for field."""
    _fields_ = [(name, _i32) for name in (
        "device", "dtype", "dkv_fp32", "dq_bf16", "batch", "heads",
        "seq_len", "head_dim", "dropout")] \
        + [("strides", ctypes.c_longlong * 21)] + _MASK_FIELDS \
        + [("ws_rows", _i32)]


class LaunchPlan(NamedTuple):
    """What a flash call of one signature launches (``forward_plan``,
    ``backward_plan``): the library (a ``_SOURCES`` key) and the kernel's
    name, the scalar block and its address, the device, the outputs'
    ``(shape, stride, dtype)``, the workspace's ``(shape, dtype)`` or
    None (the windowed routes' scores workspace, the backward's partials
    or keep bits), the launch counters it adds one to, whether it reads a
    dropout seed, and for the backward whether the operator casts dq to
    q's dtype after the launch; the CTAs of one thread-block cluster
    (``flash_attention.cluster_size`` for the forward,
    ``backward_cluster_size`` for the backward; 1 off the cluster routes).
    ``fn``
    (the C entry point), ``lib`` and ``stream`` (``index -> the current
    stream``) are bound when the operator first uses the plan (``_bound``):
    building a plan needs no card."""
    kind: str
    kernel: str
    args: ctypes.Structure
    args_ptr: int
    device: torch.device
    outputs: tuple
    workspace: object
    counts: tuple
    dropout: bool
    cast_dq: bool = False
    cluster: int = 1
    fn: object = None
    lib: object = None
    stream: object = None


_fwd_plans: dict = {}
_bwd_plans: dict = {}


def _remember(plans: dict, key, plan: LaunchPlan) -> LaunchPlan:
    if len(plans) >= PLAN_CACHE_SIZE:
        plans.clear()
    plans[key] = plan
    return plan


def _signature(t: Optional[torch.Tensor]):
    """What a plan depends on of an optional tensor beside the operands."""
    if t is None:
        return None
    return t.shape, t.stride(), t.dtype, t.get_device()


def _raw_stream():
    """``index -> the current stream's handle`` of a CUDA device (what
    ``torch.cuda.current_stream(index).cuda_stream`` reads, without
    building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream


def _mask_args(args, dropout, coords) -> None:
    """Fill a plan block's dropout flag, threshold, inv_keep and the mask's
    coordinates (``flash_attention.mask_coords`` checks and reduces them)."""
    coords = flash_attention.mask_coords(coords)
    for name, value in zip(("bh_base", "q_base", "k_base", "inner_local",
                            "inner_global", "inner_base"), coords):
        setattr(args, name, value)
    if dropout is not None:
        args.dropout = 1
        args.threshold = flash_attention._keep_threshold(dropout[1])
        args.inv_keep = 1.0 / (1.0 - dropout[1])


def _strides(layout: str, *tensors) -> list:
    return [s for t in tensors for s in flash_attention._axes(t, layout)[1]]


def _like(t: torch.Tensor, dtype) -> torch.Tensor:
    """A meta tensor with the strides ``torch.empty_like(t, dtype=dtype)``
    would give."""
    return torch.empty_like(t, dtype=dtype, device="meta")


def _bound(plan):
    """The plan (a ``LaunchPlan`` or an ``OpPlan``) with its library
    loaded (built at the first use), its C entry point and the stream
    reader; for B3 and B5 the instance asked of the source's plan query
    (which writes it into the block) and whether it runs on the tensor
    cores; for the cluster routes of the forward and the backward the check
    that a cluster of their kernels can be resident on the device
    (``_check_clusters``)."""
    lib = _library(plan.kind)
    if getattr(plan, "kernel", None) == "cluster":
        _check_clusters(lib, plan)
    if plan.kind in _QUERIED:
        err = getattr(lib, _entry(plan.kind) + "_plan")(plan.args_ptr)
        if err:
            _build.raise_on_error(lib, err, _WHAT[plan.kind])
        plan = plan._replace(tensor_core=plan.args.instance > 0)
    return plan._replace(fn=getattr(lib, _entry(plan.kind)), lib=lib,
                         stream=_raw_stream())


def _check_clusters(lib, plan) -> None:
    """Raise RuntimeError unless at least one thread-block cluster of the
    plan's kernels (``plan.cluster`` CTAs, each with the dynamic shared
    memory it takes; for the backward each kernel the route launches) can
    be resident on the plan's device at once, as
    cudaOccupancyMaxActiveClusters answers; asked once per plan. There is
    no other route to give way to: the windowed ones run only past the
    clusters' reach."""
    what = _CLUSTER_WHAT[plan.kind]
    resident = getattr(lib, _CLUSTER_QUERIES[plan.kind])(plan.args_ptr)
    if resident < 0:
        _build.raise_on_error(lib, -resident, f"flash attention {what} "
                              "(cluster occupancy query)")
    if resident == 0:
        raise RuntimeError(
            f"no thread-block cluster of {plan.cluster} CTAs of the flash "
            f"{what} at head dim {plan.args.head_dim} can be resident on "
            f"{plan.device}: the cluster route needs {plan.cluster} SMs of "
            "one GPC free at once")


def forward_plan(q, k, v, layout: str, with_lse: bool, dropout_seed,
                 dropout_rate: float, coords: tuple, out_fp32: bool,
                 acc_in, m_in, l_in, suspend: bool) -> LaunchPlan:
    """The forward's launch plan for these operands and arguments: every
    check of the operator (ValueError for what the kernels cannot take),
    the kernel (``flash_attention.forward_kernel``), the outputs, the
    windowed route's scores workspace (``flash_attention.
    scores_workspace``) and the scalar block. Builds nothing and needs no
    card."""
    fa = flash_attention
    fa._check_inputs(q, k, v)
    fa._kernel_operands(layout, q=q, k=k, v=v)
    dropout = _dropout(dropout_seed, dropout_rate, q.device)
    out = _like(q, _F32 if out_fp32 else q.dtype)
    (b, h, n), _ = fa._axes(q, layout)
    resume = m_in is not None
    if (resume or suspend) and out.dtype != _F32:
        raise ValueError("a ring attention block's state needs an fp32 "
                         "output (out_fp32)")
    if resume:
        for name, t, shape in (("acc_in", acc_in, out.shape),
                               ("m_in", m_in, (b, h, n)),
                               ("l_in", l_in, (b, h, n, 4))):
            if (t is None or t.shape != shape or t.device != q.device
                    or t.dtype != _F32):
                raise ValueError(f"{name} must be a float32 {tuple(shape)} "
                                 f"tensor on {q.device}")
        if (acc_in.stride() != out.stride() or not m_in.is_contiguous()
                or not l_in.is_contiguous()):
            raise ValueError("acc_in must have the output's strides, m_in "
                             "and l_in be contiguous")
    kernel = fa.forward_kernel(q.shape[-1], q.dtype)
    args = FwdArgs(device=q.get_device(), dtype=_DTYPE_CODES[q.dtype],
                   out_fp32=int(out_fp32), batch=b, heads=h, seq_len=n,
                   head_dim=q.shape[-1])
    args.strides[:] = _strides(layout, q, k, v, out)
    _mask_args(args, dropout, coords)
    workspace = None
    if kernel == "windowed":
        workspace = fa.scores_workspace(b, h, n, q.shape[-1], q.dtype,
                                        backward=False)
        args.ws_rows = workspace[0][0]
    # The empty outputs' size as an int: the cheaper argument to parse.
    outputs = ((tuple(out.shape), out.stride(), out.dtype),
               (b, h, n) if with_lse and not suspend else 0,
               (b, h, n) if suspend else 0,
               (b, h, n, 4) if suspend else 0)
    counts = (("drop_launches" if dropout is not None
               else "lse_launches" if with_lse else "launches",)
              + {"wgmma": ("wgmma_launches",),
                 "halves": ("halves_launches",),
                 "wide": ("wide_launches",),
                 "cluster": ("cluster_launches",),
                 "windowed": ("windowed_launches",)}.get(kernel, ()))
    kind = {"wgmma": "fwd_sm90", "halves": "fwd_wide", "wide": "fwd_wide",
            "cluster": "fwd_wide", "mma_sync": "fwd",
            "windowed": "fwd"}[kernel]
    return LaunchPlan(kind, kernel, args, ctypes.addressof(args), q.device,
                      outputs, workspace, counts, dropout is not None,
                      cluster=fa.cluster_size(q.shape[-1], q.dtype))


def _flash_fwd_cuda(q, k, v, layout, with_lse, dropout_seed, dropout_rate,
                    bh_base=0, q_base=0, k_base=0, inner_local=1,
                    inner_global=1, inner_base=0, out_fp32=False,
                    acc_in=None, m_in=None, l_in=None, suspend=False):
    """``torch.ops.vtd_torch.flash_attention_fwd`` on CUDA tensors:
    ``(out, lse, m, l)`` of softmax(q k^T) v over ``layout``-ordered q/k/v
    at their own head dim K (rows 16-byte aligned). lse is ``(B, H, N)``
    fp32 with ``with_lse``, else empty; out is in q's dtype, or fp32 with
    ``out_fp32``. A ring attention block (fp32 out) carries the online
    softmax's state: ``acc_in`` (out's shape and strides), ``m_in`` ``(B,
    H, N)`` and ``l_in`` ``(B, H, N, 4)`` resume it as the block before
    suspended it; with ``suspend`` out is the unnormalised accumulator, m
    and l the state to hand on (else empty), and no lse is written.
    ``dropout_rate`` 0 means no dropout; otherwise ``dropout_seed`` is the
    one-element device tensor the kernel reads the seed from, and
    ``bh_base``/``q_base``/``k_base`` and the batch*head row map
    ``inner_local``/``inner_global``/``inner_base`` place the mask
    (flash_attention.mask_coords). One launch of the kernel
    ``flash_attention.forward_kernel`` names: bf16 at K <= 256
    csrc/flash_attention_fwd_sm90.cu (wgmma fed by TMA), fp32 at 64 < K
    <= 3072 and bf16 at 256 < K <= 4096 csrc/flash_attention_fwd_wide.cu
    (in thread-block clusters past 384 and 512), the rest
    csrc/flash_attention_fwd.cu (mma.sync; past those widths its windowed
    route, which takes a scores workspace from the caching allocator)."""
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    coords = (bh_base, q_base, k_base, inner_local, inner_global, inner_base)
    key = (layout, with_lse, dropout_rate, coords, out_fp32, suspend,
           q.shape, q.stride(), q.dtype, q.get_device(), qp & 15,
           k.shape, k.stride(), k.dtype, k.get_device(), kp & 15,
           v.shape, v.stride(), v.dtype, v.get_device(), vp & 15,
           _signature(dropout_seed),
           None if m_in is None else (_signature(acc_in), _signature(m_in),
                                      _signature(l_in)))
    plan = _fwd_plans.get(key)
    if plan is None:
        plan = _remember(_fwd_plans, key, _bound(forward_plan(
            q, k, v, layout, with_lse, dropout_seed, dropout_rate, coords,
            out_fp32, acc_in, m_in, l_in, suspend)))
    # Allocated as q's (the plan's device): new_empty* parses fewer
    # arguments than torch.empty*.
    (shape, stride, dtype), lse_shape, m_shape, l_shape = plan.outputs
    out = q.new_empty_strided(shape, stride, dtype=dtype)
    lse = q.new_empty(lse_shape, dtype=_F32)
    m_out = q.new_empty(m_shape, dtype=_F32)
    l_out = q.new_empty(l_shape, dtype=_F32)
    workspace = (None if plan.workspace is None
                 else q.new_empty(plan.workspace[0], dtype=plan.workspace[1]))
    resume = m_in is not None
    err = plan.fn(plan.args_ptr, qp, kp, vp, out.data_ptr(),
                  lse.data_ptr() if with_lse and not suspend else None,
                  m_in.data_ptr() if resume else None,
                  l_in.data_ptr() if resume else None,
                  acc_in.data_ptr() if resume else None,
                  m_out.data_ptr() if suspend else None,
                  l_out.data_ptr() if suspend else None,
                  None if workspace is None else workspace.data_ptr(),
                  dropout_seed.data_ptr() if plan.dropout else None,
                  plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, "flash attention forward")
    flash_attention._count(*plan.counts)
    return out, lse, m_out, l_out


def _flash_fwd_fake(q, k, v, layout, with_lse, dropout_seed, dropout_rate,
                    bh_base=0, q_base=0, k_base=0, inner_local=1,
                    inner_global=1, inner_base=0, out_fp32=False,
                    acc_in=None, m_in=None, l_in=None, suspend=False):
    (b, h, n), _ = flash_attention._axes(q, layout)
    return (torch.empty_like(q, dtype=_F32 if out_fp32 else q.dtype),
            q.new_empty((b, h, n) if with_lse and not suspend else (0,),
                        dtype=_F32),
            q.new_empty((b, h, n) if suspend else (0,), dtype=_F32),
            q.new_empty((b, h, n, 4) if suspend else (0,), dtype=_F32))


def backward_plan(q, k, v, g, lse, delta, layout: str, dropout_seed,
                  dropout_rate: float, request: int, coords: tuple,
                  dkv_fp32: bool, dq_fp32: bool) -> LaunchPlan:
    """The backward's launch plan: every check of the operator, the
    kernels (``flash_attention.backward_kernel``), the dq route, the
    outputs, the workspace (the windowed route's scores, the partials
    route's dq contributions or the wgmma route's keep bits) and the
    scalar block. dq comes out in fp32 with ``dq_fp32``, else in q's
    dtype: the bf16 dq kernels of every route round it themselves. The
    cluster route's plan records its cluster size
    (``flash_attention.backward_cluster_size``)."""
    fa = flash_attention
    fa._check_inputs(q, k, v, g)
    fa._kernel_operands(layout, q=q, k=k, v=v, g=g)
    fa._check_side_inputs(q, lse, delta, layout)
    dropout = _dropout(dropout_seed, dropout_rate, q.device)
    (b, h, n), _ = fa._axes(q, layout)
    kdim = q.shape[-1]
    kernel = fa.backward_kernel(kdim, q.dtype)
    workspace = None
    route = fa.dq_route(q.dtype, request, fa.partials_bytes(b, h, n, kdim))
    if kernel == "windowed":
        # Either dq route: the windowed dq kernel reads dS from here.
        workspace = fa.scores_workspace(b, h, n, kdim, q.dtype,
                                        backward=True)
    elif route == "partials":
        workspace = ((-(-n // fa.KEY_TILE), b * h, n, kdim), _F32)
    elif kernel == "wgmma" and dropout is not None:
        # The tenth pointer: the packed keep bits (wgmma, dropout).
        workspace = (fa.keep_bits_shape(b, h, n), torch.int32)
    dq_bf16 = (not dq_fp32 and q.dtype == torch.bfloat16
               and kernel in ("wgmma", "cluster", "windowed"))
    dq = torch.empty(q.shape, dtype=q.dtype if dq_bf16 else _F32,
                     device="meta")
    dk, dv = (_like(t, _F32 if dkv_fp32 else t.dtype) for t in (k, v))
    args = BwdArgs(device=q.get_device(), dtype=_DTYPE_CODES[q.dtype],
                   dkv_fp32=int(dkv_fp32), dq_bf16=int(dq_bf16), batch=b,
                   heads=h, seq_len=n, head_dim=kdim)
    args.strides[:] = _strides(layout, q, k, v, g, dq, dk, dv)
    _mask_args(args, dropout, coords)
    if kernel == "windowed":
        args.ws_rows = workspace[0][0]
    outputs = tuple((tuple(t.shape), t.stride(), t.dtype)
                    for t in (dq, dk, dv))
    halves = kernel == "mma_sync" and kdim > 64
    counts = (("backward_launches" if dropout is None
               else "backward_drop_launches",)
              + {"wgmma": ("wgmma_backward_launches",),
                 "cluster": ("cluster_backward_launches",),
                 "windowed": ("windowed_backward_launches",)}.get(kernel, ())
              + (("halves_backward_launches",) if halves else ()))
    kind = {"wgmma": "bwd_sm90", "mma_sync": "bwd", "cluster": "bwd_wide",
            "windowed": "bwd_wide"}[kernel]
    return LaunchPlan(kind, kernel, args, ctypes.addressof(args), q.device,
                      outputs, workspace, counts, dropout is not None,
                      cast_dq=not dq_fp32 and dq.dtype != q.dtype,
                      cluster=fa.backward_cluster_size(kdim, q.dtype))


def backward_launch(q, k, v, g, lse, delta, layout: str, dropout_seed,
                    dropout_rate: float, request: int = 0, bh_base: int = 0,
                    q_base: int = 0, k_base: int = 0, inner_local: int = 1,
                    inner_global: int = 1, inner_base: int = 0,
                    dkv_fp32: bool = False, dq_fp32: bool = True):
    """What ``flash_attention_bwd`` launches, with its arguments: ``(dq,
    dk, dv, keep_bits)``, keep_bits the wgmma backward's packed keep mask
    (int32 words, ``flash_attention.keep_bits_shape``; compare with
    ``flash_attention.pack_keep_bits``) when it replays dropout, else
    None. The card tests read the words through it; the model goes
    through the operator."""
    qp, kp, vp, gp = q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr()
    coords = (bh_base, q_base, k_base, inner_local, inner_global, inner_base)
    key = (layout, dropout_rate, request, coords, dkv_fp32, dq_fp32,
           q.shape, q.stride(), q.dtype, q.get_device(), qp & 15,
           k.shape, k.stride(), k.dtype, k.get_device(), kp & 15,
           v.shape, v.stride(), v.dtype, v.get_device(), vp & 15,
           g.shape, g.stride(), g.dtype, g.get_device(), gp & 15,
           _signature(lse), _signature(delta), _signature(dropout_seed))
    plan = _bwd_plans.get(key)
    if plan is None:
        plan = _remember(_bwd_plans, key, _bound(backward_plan(
            q, k, v, g, lse, delta, layout, dropout_seed, dropout_rate,
            request, coords, dkv_fp32, dq_fp32)))
    (dq_shape, dq_stride, dq_dtype), (k_shape, k_stride, kv_dtype), \
        (v_shape, v_stride, _) = plan.outputs
    dq = q.new_empty_strided(dq_shape, dq_stride, dtype=dq_dtype)
    dk = k.new_empty_strided(k_shape, k_stride, dtype=kv_dtype)
    dv = v.new_empty_strided(v_shape, v_stride, dtype=kv_dtype)
    workspace = None
    if plan.workspace is not None:
        workspace = q.new_empty(plan.workspace[0], dtype=plan.workspace[1])
    err = plan.fn(plan.args_ptr, qp, kp, vp, gp, lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(),
                  None if workspace is None else workspace.data_ptr(),
                  dropout_seed.data_ptr() if plan.dropout else None,
                  plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, "flash attention backward")
    flash_attention._count(*plan.counts)
    if plan.cast_dq:
        dq = dq.to(q.dtype)
    keep_bits = workspace if plan.kernel == "wgmma" else None
    return dq, dk, dv, keep_bits


def _flash_bwd_cuda(q, k, v, g, lse, delta, layout, dropout_seed,
                    dropout_rate, request=0, bh_base=0, q_base=0, k_base=0,
                    inner_local=1, inner_global=1, inner_base=0,
                    dkv_fp32=False, dq_fp32=True):
    """``torch.ops.vtd_torch.flash_attention_bwd`` on CUDA tensors: ``(dq,
    dk, dv)`` at q's head dim K from the backward kernels that
    ``flash_attention.backward_kernel`` names (bf16 at K <= 256
    csrc/flash_attention_bwd_sm90.cu on wgmma, fp32 at K <= 128
    csrc/flash_attention_bwd.cu, the rest csrc/flash_attention_bwd_wide.cu:
    a thread-block cluster to fp32 K 1024 and bf16 2048, the windowed
    route past that, with a scores workspace from the caching allocator),
    K any width whose rows are 16-byte aligned; lse and delta are contiguous
    ``(B, H, N)`` fp32; dq is summed in fp32 over the key tiles in order
    and written once, so it is the same on every run: in fp32 with
    ``dq_fp32`` (the default), else in q's dtype (the bf16 dq kernels
    round the sum themselves). A nonzero
    ``dropout_rate`` replays the forward's mask, its seed read from
    ``dropout_seed``'s device memory and placed by ``bh_base``/``q_base``/
    ``k_base`` and the row map as in the forward. ``request`` is one of
    ``flash_attention.DQ_ROUTES``' values (0: the route the dtype
    selects). ``dkv_fp32`` writes dk and dv in fp32 (bf16 inputs, the
    split route: a ring attention block)."""
    return backward_launch(q, k, v, g, lse, delta, layout, dropout_seed,
                           dropout_rate, request, bh_base, q_base, k_base,
                           inner_local, inner_global, inner_base, dkv_fp32,
                           dq_fp32)[:3]


def _flash_bwd_fake(q, k, v, g, lse, delta, layout, dropout_seed,
                    dropout_rate, request=0, bh_base=0, q_base=0, k_base=0,
                    inner_local=1, inner_global=1, inner_base=0,
                    dkv_fp32=False, dq_fp32=True):
    return (q.new_empty(q.shape, dtype=_F32 if dq_fp32 else q.dtype),
            *(torch.empty_like(t, dtype=_F32 if dkv_fp32 else t.dtype)
              for t in (k, v)))


# ---------------------------------------------------------------------------
# B3, B4, B5 and the MLP dropout: the other five operators and their plans
# ---------------------------------------------------------------------------
#
# The flash operators' design: ``Library`` definitions with the schemas
# ``custom_op`` inferred for these operators before (saved programs hold
# layer_norm and dense_mish nodes), a launch plan per call signature, one
# argument block per plan (LayerNormArgs, DenseMishArgs, Int8DenseArgs,
# DropoutArgs: csrc/launch_common.cuh) and one ctypes call a launch, whose
# C entry point makes the plan's device current. The key holds the
# operands' shapes, strides, dtypes and devices, the addresses mod 16 that
# a choice reads, and the scalar arguments. A plan names the copies a call
# makes first (contiguity, 16-byte alignment, fp32 scales) and, for B3 and
# B5, the instance the kernel runs: the source's plan query
# (``vtd_dense_mish_plan``, ``vtd_int8_dense_plan``) picks it once from the
# sizes, the dtype, the request and the operands' alignment, so a call
# counts its tensor-core launch from the plan. The dropout's key holds no
# address: its entry point takes the 16-byte path per call where both
# addresses allow, which changes no value.

LAYER_NORM_SCHEMA = ("layer_norm(Tensor x2, Tensor gamma, Tensor beta, "
                     "float eps) -> Tensor")
DENSE_MISH_SCHEMA = ("dense_mish(Tensor x2, Tensor w, Tensor b, "
                     "bool apply_mish, SymInt request) -> Tensor")
_INT8_SIGNATURE = ("(Tensor x2, Tensor kernel_q, Tensor? transposed, "
                   "Tensor scale, Tensor bias, bool apply_mish, "
                   "SymInt request) -> Tensor")
FUSED_INT8_DENSE_SCHEMA = "fused_int8_dense" + _INT8_SIGNATURE
INT8_DENSE_SCHEMA = "int8_dense" + _INT8_SIGNATURE
DROPOUT_SCHEMA = (
    "dropout(Tensor x2, Tensor seed, float rate, SymInt row_base=0, "
    "SymInt inner_local=1, SymInt inner_global=1, SymInt inner_base=0, "
    "SymInt col_base=0) -> Tensor")
# What a failed launch of each library is called in its RuntimeError.
_WHAT = {"ln": "layer norm", "ffn": "dense + mish", "int8": "int8 dense",
         "drop": "dropout"}


class LayerNormArgs(ctypes.Structure):
    """csrc/launch_common.cuh's LayerNormArgs, field for field."""
    _fields_ = [(name, _i32) for name in ("device", "dtype", "rows", "d")] \
        + [("eps", _f32c)]


class DenseMishArgs(ctypes.Structure):
    """csrc/launch_common.cuh's DenseMishArgs, field for field."""
    _fields_ = [(name, _i32) for name in (
        "device", "dtype", "m", "n", "k", "apply_mish", "request",
        "aligned16", "instance")]


class Int8DenseArgs(ctypes.Structure):
    """csrc/launch_common.cuh's Int8DenseArgs, field for field."""
    _fields_ = [(name, _i32) for name in (
        "device", "x_dtype", "out_dtype", "m", "n", "k", "apply_mish",
        "request", "aligned16", "instance")]


class DropoutArgs(ctypes.Structure):
    """csrc/launch_common.cuh's DropoutArgs, field for field."""
    _fields_ = [("device", _i32), ("dtype", _i32),
                ("rows", ctypes.c_longlong), ("cols", _i32),
                ("threshold", _u32), ("inv_keep", _f32c)] + [
        (name, _u32) for name in ("row_base", "inner_local", "inner_global",
                                  "inner_base", "col_base")]


class OpPlan(NamedTuple):
    """What a call of one of the five operators launches for one
    signature: the library (a ``_SOURCES`` key), the scalar block and its
    address, the device, which operands the call copies first (one flag
    each, in the operator's order) and, for B3 and B5, whether the planned
    instance runs on the tensor cores (set by ``_bound`` from the plan
    query). ``fn``, ``lib`` and ``stream`` as in ``LaunchPlan``."""
    kind: str
    args: ctypes.Structure
    args_ptr: int
    device: torch.device
    copies: tuple
    tensor_core: bool = False
    fn: object = None
    lib: object = None
    stream: object = None


_ln_plans: dict = {}
_ffn_plans: dict = {}
# The outputs of the same shape as x2 (``empty_like`` parses fewer
# arguments than ``new_empty`` of a torch.Size).
_CONTIGUOUS = torch.contiguous_format
_int8_plans: dict = {}
_drop_plans: dict = {}


def _aligned(t: torch.Tensor, copied: bool) -> bool:
    """Whether the address a call hands over for ``t`` is on a 16-byte
    boundary: a copy's always is (a new allocation)."""
    return copied or t.data_ptr() % 16 == 0


def _fp32_copy(t: torch.Tensor) -> torch.Tensor:
    return t.to(_F32, memory_format=torch.contiguous_format, copy=True)


def layer_norm_plan(x2, gamma, beta, eps: float) -> OpPlan:
    """B4's plan: x2 copied where it is not contiguous or not on a 16-byte
    boundary (the kernel loads 16 or 8 bytes at a time), gamma and beta
    where they are not contiguous fp32 on a 16-byte boundary (read 16 bytes
    at a time)."""
    copies = (not x2.is_contiguous() or x2.data_ptr() % 16 != 0,
              *(t.dtype != _F32 or not t.is_contiguous()
                or t.data_ptr() % 16 != 0 for t in (gamma, beta)))
    args = LayerNormArgs(device=x2.get_device(),
                         dtype=_DTYPE_CODES[x2.dtype], rows=x2.shape[0],
                         d=x2.shape[1], eps=eps)
    return OpPlan("ln", args, ctypes.addressof(args), x2.device, copies)


def _layer_norm_cuda(x2, gamma, beta, eps):
    """``torch.ops.vtd_torch.layer_norm`` on CUDA tensors: LayerNorm of the
    rows of 2-D ``x2`` (csrc/layer_norm.cu), output in x2's dtype; gamma
    and beta are read in fp32."""
    xp, gp, bp = x2.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    key = (eps, x2.shape, x2.stride(), x2.dtype, x2.get_device(), xp & 15,
           _signature(gamma), gp & 15, _signature(beta), bp & 15)
    plan = _ln_plans.get(key)
    if plan is None:
        plan = _remember(_ln_plans, key, _bound(layer_norm_plan(
            x2, gamma, beta, eps)))
    copy_x, copy_gamma, copy_beta = plan.copies
    # The copies stay bound until the launch is queued.
    if copy_x:
        x2 = x2.clone(memory_format=torch.contiguous_format)
        xp = x2.data_ptr()
    if copy_gamma:
        gamma = _fp32_copy(gamma)
        gp = gamma.data_ptr()
    if copy_beta:
        beta = _fp32_copy(beta)
        bp = beta.data_ptr()
    out = torch.empty_like(x2, memory_format=_CONTIGUOUS)
    err = plan.fn(plan.args_ptr, xp, gp, bp, out.data_ptr(),
                  plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, _WHAT["ln"])
    with fused_ln._count_lock:
        fused_ln.fused_layer_norm.launches += 1
    return out


def _layer_norm_fake(x2, gamma, beta, eps):
    return x2.new_empty(x2.shape)


def dense_mish_plan(x2, w, b, apply_mish: bool, request: int) -> OpPlan:
    """B3's plan: x2, w and b copied where they are not contiguous; the
    block carries ``request`` and whether x2 and w come on 16-byte
    boundaries (the output always does), from which ``_bound``'s query
    picks the instance."""
    copies = tuple(not t.is_contiguous() for t in (x2, w, b))
    aligned = _aligned(x2, copies[0]) and _aligned(w, copies[1])
    args = DenseMishArgs(device=x2.get_device(),
                         dtype=_DTYPE_CODES[x2.dtype], m=x2.shape[0],
                         n=w.shape[1], k=x2.shape[1],
                         apply_mish=int(apply_mish), request=request,
                         aligned16=int(aligned), instance=-1)
    return OpPlan("ffn", args, ctypes.addressof(args), x2.device, copies)


def _dense_mish_cuda(x2, w, b, apply_mish, request):
    """``torch.ops.vtd_torch.dense_mish`` on CUDA tensors: ``mish(x2 @ w +
    b)`` (or without mish) in x2's dtype from csrc/dense_mish.cu;
    ``request`` is one of ``fused_ffn.REQUESTS``' values (0: the instance
    the shape selects)."""
    m = x2.shape[0]
    if m == 0:
        return x2.new_empty((0, w.shape[1]))
    xp, wp = x2.data_ptr(), w.data_ptr()
    key = (apply_mish, request, x2.shape, x2.stride(), x2.dtype,
           x2.get_device(), xp & 15, w.shape, w.stride(), w.dtype,
           w.get_device(), wp & 15, _signature(b))
    plan = _ffn_plans.get(key)
    if plan is None:
        plan = _remember(_ffn_plans, key, _bound(dense_mish_plan(
            x2, w, b, apply_mish, request)))
    copy_x, copy_w, copy_b = plan.copies
    if copy_x:
        x2 = x2.contiguous()
        xp = x2.data_ptr()
    if copy_w:
        w = w.contiguous()
        wp = w.data_ptr()
    if copy_b:
        b = b.contiguous()
    out = x2.new_empty((m, w.shape[1]))
    err = plan.fn(plan.args_ptr, xp, wp, b.data_ptr(), out.data_ptr(),
                  plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, _WHAT["ffn"])
    route = fused_ffn.fused_dense_mish
    with fused_ffn._count_lock:
        route.launches += 1
        route.tensor_core_launches += plan.tensor_core
    return out


def _dense_mish_fake(x2, w, b, apply_mish, request):
    return x2.new_empty((x2.shape[0], w.shape[1]))


def int8_dense_plan(x2, kernel_q, transposed, scale, bias, apply_mish: bool,
                    request: int, out_dtype) -> OpPlan:
    """B5's plan, either route: x2, kernel_q and ``transposed`` copied
    where they are not contiguous, scale and bias where they are not
    contiguous fp32; the block carries ``request`` and whether the (N, K)
    codes are given and they and x2 come on 16-byte boundaries, from which
    ``_bound``'s query picks the instance."""
    copies = (not x2.is_contiguous(), not kernel_q.is_contiguous(),
              transposed is not None and not transposed.is_contiguous(),
              *(t.dtype != _F32 or not t.is_contiguous()
                for t in (scale, bias)))
    aligned = (transposed is not None and _aligned(x2, copies[0])
               and _aligned(transposed, copies[2]))
    args = Int8DenseArgs(device=x2.get_device(),
                         x_dtype=_DTYPE_CODES[x2.dtype],
                         out_dtype=_DTYPE_CODES[out_dtype], m=x2.shape[0],
                         n=kernel_q.shape[1], k=x2.shape[1],
                         apply_mish=int(apply_mish), request=request,
                         aligned16=int(aligned), instance=-1)
    return OpPlan("int8", args, ctypes.addressof(args), x2.device, copies)


def _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish: bool,
                 request: int, out_dtype, route) -> torch.Tensor:
    """One launch of csrc/int8_dense.cu with ``out_dtype`` out, counted on
    ``route`` (the public function of quantization.py)."""
    m = x2.shape[0]
    if m == 0:
        return x2.new_empty((0, kernel_q.shape[1]), dtype=out_dtype)
    xp = x2.data_ptr()
    tp = None if transposed is None else transposed.data_ptr()
    key = (out_dtype, apply_mish, request, x2.shape, x2.stride(), x2.dtype,
           x2.get_device(), xp & 15, _signature(kernel_q),
           None if tp is None else (_signature(transposed), tp & 15),
           _signature(scale), _signature(bias))
    plan = _int8_plans.get(key)
    if plan is None:
        plan = _remember(_int8_plans, key, _bound(int8_dense_plan(
            x2, kernel_q, transposed, scale, bias, apply_mish, request,
            out_dtype)))
    copy_x, copy_codes, copy_transposed, copy_scale, copy_bias = plan.copies
    if copy_x:
        x2 = x2.contiguous()
        xp = x2.data_ptr()
    if copy_codes:
        kernel_q = kernel_q.contiguous()
    if copy_transposed:
        transposed = transposed.contiguous()
        tp = transposed.data_ptr()
    if copy_scale:
        scale = scale.float().contiguous()
    if copy_bias:
        bias = bias.float().reshape(-1).contiguous()
    out = x2.new_empty((m, kernel_q.shape[1]), dtype=out_dtype)
    err = plan.fn(plan.args_ptr, xp, kernel_q.data_ptr(), tp,
                  scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, _WHAT["int8"])
    with quantization._count_lock:
        route.launches += 1
        route.tensor_core_launches += plan.tensor_core
    return out


def _fused_int8_dense_cuda(x2, kernel_q, transposed, scale, bias,
                           apply_mish, request):
    """``torch.ops.vtd_torch.fused_int8_dense`` on CUDA tensors: the fused
    route of csrc/int8_dense.cu, per-row int8 quantization of ``x2`` (M,
    K), the int8 product with ``kernel_q`` (K, N), scale, bias (+ mish),
    bf16 out. ``transposed`` is the (N, K) copy of the codes the
    tensor-core instances read (quantization.transposed_codes), or None
    for the guarded instance.

    Not exportable yet: the wrapper keys its cache of ``transposed`` on
    ``data_ptr()``, which a traced tensor does not have, so an int8 model
    cannot be traced by ``torch.export`` (nor can the JAX package export
    one)."""
    return _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish,
                        request, torch.bfloat16, quantization.fused_int8_dense)


def _int8_dense_cuda(x2, kernel_q, transposed, scale, bias, apply_mish,
                     request):
    """``torch.ops.vtd_torch.int8_dense`` on CUDA tensors: the fp32-out
    route of csrc/int8_dense.cu (the attention projections), arguments as
    ``fused_int8_dense``'s; not exportable either."""
    return _int8_launch(x2, kernel_q, transposed, scale, bias, apply_mish,
                        request, _F32, quantization.int8_dense)


def _fused_int8_dense_fake(x2, kernel_q, transposed, scale, bias,
                           apply_mish, request):
    return x2.new_empty((x2.shape[0], kernel_q.shape[1]),
                        dtype=torch.bfloat16)


def _int8_dense_fake(x2, kernel_q, transposed, scale, bias, apply_mish,
                     request):
    return x2.new_empty((x2.shape[0], kernel_q.shape[1]), dtype=_F32)


def dropout_plan(x2, seed, rate: float, coords: tuple) -> OpPlan:
    """The MLP dropout's plan: the seed's check (ValueError), x2 copied
    where it is not contiguous, the keep threshold, 1 / (1 - rate) in fp32
    and the mask's coordinates ``(row_base, inner_local, inner_global,
    inner_base, col_base)`` mod 2^32 in the block."""
    _dropout(seed, rate, x2.device)
    args = DropoutArgs(device=x2.get_device(), dtype=_DTYPE_CODES[x2.dtype],
                       rows=x2.shape[0], cols=x2.shape[1],
                       threshold=flash_attention._keep_threshold(rate),
                       inv_keep=dropout.inv_keep(rate))
    for name, value in zip(("row_base", "inner_local", "inner_global",
                            "inner_base", "col_base"), coords):
        setattr(args, name, int(value) & flash_attention._M32)
    return OpPlan("drop", args, ctypes.addressof(args), x2.device,
                  (not x2.is_contiguous(),))


def _dropout_cuda(x2, seed, rate, row_base=0, inner_local=1, inner_global=1,
                  inner_base=0, col_base=0):
    """``torch.ops.vtd_torch.dropout`` on CUDA tensors: keras Dropout of
    the rows of 2-D ``x2`` with the counter-hash mask of the uint32 seed in
    ``seed``'s device memory (csrc/dropout.cu), each row mapped by
    ``inner_local``/``inner_global``/``inner_base`` and counted from
    ``row_base``, the columns from ``col_base`` (dropout.dropout_mask),
    output in x2's dtype."""
    coords = (row_base, inner_local, inner_global, inner_base, col_base)
    key = (rate, coords, x2.shape, x2.stride(), x2.dtype, x2.get_device(),
           _signature(seed))
    plan = _drop_plans.get(key)
    if plan is None:
        plan = _remember(_drop_plans, key, _bound(dropout_plan(
            x2, seed, rate, coords)))
    if plan.copies[0]:
        x2 = x2.contiguous()
    out = torch.empty_like(x2, memory_format=_CONTIGUOUS)
    err = plan.fn(plan.args_ptr, x2.data_ptr(), out.data_ptr(),
                  seed.data_ptr(), plan.stream(plan.device.index))
    if err:
        _build.raise_on_error(plan.lib, err, _WHAT["drop"])
    with dropout._count_lock:
        dropout.dropout.launches += 1
    return out


def _dropout_fake(x2, seed, rate, row_base=0, inner_local=1, inner_global=1,
                  inner_base=0, col_base=0):
    return x2.new_empty(x2.shape)


# Every operator of the namespace, defined on one fragment; each wrapper
# module calls its operators' ``.default`` overloads, bound here.
_op_library = torch.library.Library(NAMESPACE, "FRAGMENT")
for _schema, _cuda, _fake in (
        (FLASH_FWD_SCHEMA, _flash_fwd_cuda, _flash_fwd_fake),
        (FLASH_BWD_SCHEMA, _flash_bwd_cuda, _flash_bwd_fake),
        (LAYER_NORM_SCHEMA, _layer_norm_cuda, _layer_norm_fake),
        (DENSE_MISH_SCHEMA, _dense_mish_cuda, _dense_mish_fake),
        (FUSED_INT8_DENSE_SCHEMA, _fused_int8_dense_cuda,
         _fused_int8_dense_fake),
        (INT8_DENSE_SCHEMA, _int8_dense_cuda, _int8_dense_fake),
        (DROPOUT_SCHEMA, _dropout_cuda, _dropout_fake)):
    _name = _schema.split("(", 1)[0]
    _op_library.define(_schema)
    _op_library.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake,
                                lib=_op_library)
flash_attention._FWD_OP = torch.ops.vtd_torch.flash_attention_fwd.default
flash_attention._BWD_OP = torch.ops.vtd_torch.flash_attention_bwd.default
fused_ln._OP = torch.ops.vtd_torch.layer_norm.default
fused_ffn._OP = torch.ops.vtd_torch.dense_mish.default
quantization._FUSED_OP = torch.ops.vtd_torch.fused_int8_dense.default
quantization._INT8_OP = torch.ops.vtd_torch.int8_dense.default
dropout._OP = torch.ops.vtd_torch.dropout.default
