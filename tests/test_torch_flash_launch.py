"""The flash operators' launch path (kernels/ops.py) on the CPU.

No JAX counterpart: the operators, their schemas and their launch plans
are the port's own. A launch plan holds what a call of one signature
launches (checks run, kernel picked, scalar block filled) and is built
without a card, so these tests build plans from CPU tensors. The
operators' CUDA implementations are driven here with a stand-in for the
C entry point that records its arguments and launches nothing, so the
plan cache is exercised as on the card; tests/test_torch_cuda.py and
chip_smoke.py launch the kernels through the same path.
"""

import ctypes
import os
import re

import pytest
import torch

from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa)
from vision_transformer_detector_tpu_torch.kernels import ops

# The schemas the operators had as Python custom_ops: saved programs hold
# nodes of these operators, so the forward's stays as it was and the
# backward's gains only its trailing dq_fp32.
FWD_SCHEMA = (
    "vtd_torch::flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
    "str layout, bool with_lse, Tensor? dropout_seed, float dropout_rate, "
    "SymInt bh_base=0, SymInt q_base=0, SymInt k_base=0, "
    "SymInt inner_local=1, SymInt inner_global=1, SymInt inner_base=0, "
    "bool out_fp32=False, Tensor? acc_in=None, Tensor? m_in=None, "
    "Tensor? l_in=None, bool suspend=False) "
    "-> (Tensor, Tensor, Tensor, Tensor)")
BWD_SCHEMA_BEFORE = (
    "vtd_torch::flash_attention_bwd(Tensor q, Tensor k, Tensor v, "
    "Tensor g, Tensor lse, Tensor delta, str layout, Tensor? dropout_seed, "
    "float dropout_rate, SymInt request=0, SymInt bh_base=0, "
    "SymInt q_base=0, SymInt k_base=0, SymInt inner_local=1, "
    "SymInt inner_global=1, SymInt inner_base=0, bool dkv_fp32=False) "
    "-> (Tensor, Tensor, Tensor)")
COUNTERS = ("launches", "lse_launches", "drop_launches", "wgmma_launches",
            "wide_launches", "halves_launches", "cluster_launches",
            "windowed_launches", "backward_launches", "backward_drop_launches",
            "wgmma_backward_launches", "halves_backward_launches",
            "cluster_backward_launches", "windowed_backward_launches",
            "operand_copies")
# What the stand-in's cluster occupancy queries (the wide forward's
# ``vtd_flash_attention_fwd_wide_clusters``, the wide backward's
# ``vtd_flash_attention_bwd_clusters``) answer, and the head dims of the
# blocks each was asked about.
RESIDENT = {"clusters": 4, "asked": [], "bwd_clusters": 4, "bwd_asked": []}


@pytest.fixture
def launches(monkeypatch):
    """The entry points stood in for: each call's arguments recorded (the
    plan's block first), no launch. Empty plan caches; the launch counters
    put back afterwards."""
    calls = []
    monkeypatch.setitem(RESIDENT, "clusters", 4)
    monkeypatch.setitem(RESIDENT, "asked", [])
    monkeypatch.setitem(RESIDENT, "bwd_clusters", 4)
    monkeypatch.setitem(RESIDENT, "bwd_asked", [])

    class Library:
        def __getattr__(self, name):
            if name == "vtd_flash_attention_fwd_wide_clusters":
                def query(args):
                    RESIDENT["asked"].append(
                        ops.FwdArgs.from_address(args).head_dim)
                    return RESIDENT["clusters"]
                return query
            if name == "vtd_flash_attention_bwd_clusters":
                def bwd_query(args):
                    RESIDENT["bwd_asked"].append(
                        ops.BwdArgs.from_address(args).head_dim)
                    return RESIDENT["bwd_clusters"]
                return bwd_query

            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(ops, "_library", lambda kind: Library())
    monkeypatch.setattr(ops, "_raw_stream", lambda: (lambda index: 0))
    monkeypatch.setattr(ops, "_fwd_plans", {})
    monkeypatch.setattr(ops, "_bwd_plans", {})
    for name in COUNTERS:
        monkeypatch.setattr(fa.flash_attention, name,
                            getattr(fa.flash_attention, name))
    return calls


def _operands(shape=(2, 37, 3, 64), dtype=torch.bfloat16, count=3, width=None,
              shift=0):
    """``count`` tensors of ``shape``, each a view of rows ``width``
    elements wide (default: the head dim) starting ``shift`` elements in."""
    width = width or shape[-1]
    return [torch.randn(*shape[:-1], width + shift).to(dtype)[
        ..., shift:shift + shape[-1]] for _ in range(count)]


def _forward(q, k, v, layout="bnhk", coords=(0, 0, 0, 1, 1, 0), **kw):
    return ops._flash_fwd_cuda(q, k, v, layout, kw.pop("with_lse", False),
                               None, 0.0, *coords, **kw)


def _block(calls, i=-1) -> ops.FwdArgs:
    return ops.FwdArgs.from_address(calls[i][1][0])


def test_forward_schema_is_unchanged():
    assert str(torch.ops.vtd_torch.flash_attention_fwd.default._schema) \
        == FWD_SCHEMA


def test_backward_schema_adds_only_dq_fp32():
    tail = ") -> (Tensor, Tensor, Tensor)"
    assert str(torch.ops.vtd_torch.flash_attention_bwd.default._schema) \
        == BWD_SCHEMA_BEFORE[:-len(tail)] + ", bool dq_fp32=True" + tail


@pytest.mark.parametrize("struct,name", [(ops.FwdArgs, "FlashFwdArgs"),
                                         (ops.BwdArgs, "FlashBwdArgs")])
def test_argument_blocks_match_the_c_structs(struct, name):
    """The ctypes blocks name csrc/flash_launch.cuh's fields in its order,
    with its sizes (int, long long[n], unsigned int, float)."""
    path = os.path.join(os.path.dirname(ops.__file__), "..", "csrc",
                        "flash_launch.cuh")
    with open(path) as f:
        body = re.search(r"struct %s \{(.*?)\};" % name, f.read(),
                         re.S).group(1)
    fields = []
    for line in body.splitlines():
        found = re.match(r"\s*(unsigned int|long long|int|float) ([^;]*);",
                         line)
        for field in found.group(2).split(",") if found else ():
            count = re.search(r"\[(\d+)\]", field)
            fields.append((field.split("[")[0].strip(), found.group(1),
                           int(count.group(1)) if count else None))
    sizes = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint32,
             "float": ctypes.c_float, "long long": ctypes.c_longlong}
    assert [f[0] for f in struct._fields_] == [f[0] for f in fields]
    for (fname, ftype), (_, ctype, count) in zip(struct._fields_, fields):
        want = sizes[ctype] * count if count else sizes[ctype]
        assert ctypes.sizeof(ftype) == ctypes.sizeof(want), fname


def test_one_plan_per_signature(launches):
    """Calls with the same shapes, strides, dtype and pointer residues
    share one plan, whatever their addresses; each launch gets its own
    pointers and the plan's block."""
    for _ in range(3):
        q, k, v = _operands()
        _forward(q, k, v)
        name, args = launches[-1]
        assert name == "vtd_flash_attention_fwd_sm90"
        assert args[1:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert len(ops._fwd_plans) == 1
    block = _block(launches)
    assert (block.batch, block.heads, block.seq_len, block.head_dim,
            block.dtype, block.device) == (2, 3, 37, 64, 1, -1)


@pytest.mark.parametrize("variant", ["stride", "dtype", "layout", "coords",
                                     "with_lse"])
def test_operands_that_differ_get_their_own_plan(launches, variant):
    """A stride, the dtype, the layout, the mask's coordinates or the lse
    flag changes the plan, and the launch reads the new one's block."""
    q, k, v = _operands()
    _forward(q, k, v)
    first = _block(launches)
    kw = {}
    if variant == "stride":
        q, k, v = _operands(width=72)
    elif variant == "dtype":
        q, k, v = _operands(dtype=torch.float32)
    elif variant == "coords":
        kw["coords"] = (5, 7, 9, 2, 4, 1)
    elif variant == "with_lse":
        kw["with_lse"] = True
    out = _forward(q, k, v, layout="bhnk" if variant == "layout" else "bnhk",
                   **kw)
    assert len(ops._fwd_plans) == 2
    second = _block(launches)
    if variant == "stride":
        assert list(second.strides)[:3] == [37 * 3 * 72, 72, 3 * 72]
        assert list(first.strides)[:3] == [37 * 3 * 64, 64, 3 * 64]
    elif variant == "dtype":
        assert (first.dtype, second.dtype) == (1, 0)
        assert launches[-1][0] == "vtd_flash_attention_fwd"
    elif variant == "layout":
        assert (second.heads, second.seq_len) == (37, 3)
    elif variant == "coords":
        assert [getattr(second, f) for f in (
            "bh_base", "q_base", "k_base", "inner_local", "inner_global",
            "inner_base")] == [5, 7, 9, 2, 4, 1]
        assert first.bh_base == 0 and first.inner_local == 1
    else:
        assert out[1].shape == (2, 3, 37) and launches[-1][1][5] is not None
        assert launches[-2][1][5] is None


@pytest.mark.parametrize("dtype,shift", [(torch.bfloat16, 1),
                                         (torch.float32, 2)])
def test_a_pointer_off_16_bytes_is_not_served_the_aligned_plan(
        launches, dtype, shift):
    """The key holds each pointer mod 16: a view of the same shape and
    strides that starts off a 16-byte boundary builds its own plan, which
    raises the check's ValueError, word for word."""
    q, k, v = _operands(dtype=dtype, width=72)
    _forward(q, k, v)
    k_off = _operands(dtype=dtype, width=72 - shift, shift=shift)[0]
    assert k_off.stride() == k.stride()
    message = (f"k starts {shift * k.element_size()} bytes past a 16-byte "
               "boundary; the flash kernels read 16-byte-aligned rows with a "
               "unit head-dim stride")
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        _forward(q, k_off, v)
    assert len(launches) == 1


def test_mixed_dtypes_raise_the_checks_text(launches):
    q, k, v = _operands()
    with pytest.raises(ValueError, match=re.escape(
            "the kernels take float32 or bfloat16 tensors of one dtype, got "
            "torch.bfloat16, torch.float32, torch.bfloat16")):
        _forward(q, k.float(), v)
    with pytest.raises(ValueError, match=re.escape(
            "q/k/v (and g) must share one 4-D shape, got (2, 37, 3, 64), "
            "(2, 36, 3, 64), (2, 37, 3, 64)")):
        _forward(q, k[:, 1:], v)
    assert not launches and not ops._fwd_plans


def test_backward_side_inputs_raise_the_checks_text(launches):
    q, k, v, g = _operands(count=4)
    lse = torch.zeros(2, 3, 37)
    with pytest.raises(ValueError, match=re.escape(
            "delta must be a contiguous float32 (2, 3, 37) tensor on cpu, "
            "got (2, 3, 37) torch.bfloat16 on cpu")):
        ops._flash_bwd_cuda(q, k, v, g, lse, lse.bfloat16(), "bnhk", None,
                            0.0)
    assert not launches


def test_the_plan_cache_stays_bounded(launches):
    """Past PLAN_CACHE_SIZE signatures the cache is emptied and refilled:
    never larger, and every call still launches with its own block."""
    q, k, v = _operands(shape=(1, 8, 1, 64))
    for base in range(ops.PLAN_CACHE_SIZE + 40):
        _forward(q, k, v, coords=(base, 0, 0, 1, 1, 0))
        assert len(ops._fwd_plans) <= ops.PLAN_CACHE_SIZE
        assert _block(launches).bh_base == base
    assert len(ops._fwd_plans) == 40


def test_counts_move_once_per_call(launches):
    """Each call adds one to its route's counter (and to the wgmma count
    where bf16 K <= 128 runs), as the counters read before."""
    f = fa.flash_attention
    q, k, v, g = _operands(count=4)
    before = {name: getattr(f, name) for name in COUNTERS}
    _forward(q, k, v)
    _forward(q, k, v, with_lse=True)
    lse = torch.zeros(2, 3, 37)
    ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    _forward(q32, k32, v32)
    moved = {name: getattr(f, name) - n for name, n in before.items()}
    assert moved == {"launches": 2, "lse_launches": 1, "drop_launches": 0,
                     "wgmma_launches": 2, "wide_launches": 0,
                     "halves_launches": 0, "cluster_launches": 0,
                     "windowed_launches": 0,
                     "backward_launches": 1, "backward_drop_launches": 0,
                     "wgmma_backward_launches": 1,
                     "halves_backward_launches": 0,
                     "cluster_backward_launches": 0,
                     "windowed_backward_launches": 0, "operand_copies": 0}


@pytest.mark.parametrize("dtype,kdim,dq_fp32,kind,dq_dtype,dq_bf16,cast", [
    (torch.bfloat16, 64, False, "bwd_sm90", torch.bfloat16, 1, False),
    (torch.bfloat16, 80, False, "bwd_sm90", torch.bfloat16, 1, False),
    (torch.bfloat16, 64, True, "bwd_sm90", torch.float32, 0, False),
    (torch.bfloat16, 192, False, "bwd_sm90", torch.bfloat16, 1, False),
    (torch.bfloat16, 256, True, "bwd_sm90", torch.float32, 0, False),
    (torch.bfloat16, 320, False, "bwd_wide", torch.bfloat16, 1, False),
    (torch.bfloat16, 2048, False, "bwd_wide", torch.bfloat16, 1, False),
    (torch.bfloat16, 320, True, "bwd_wide", torch.float32, 0, False),
    (torch.bfloat16, 2056, False, "bwd_wide", torch.bfloat16, 1, False),
    (torch.float32, 64, False, "bwd", torch.float32, 0, False),
    (torch.float32, 192, False, "bwd_wide", torch.float32, 0, False),
    (torch.float32, 1028, False, "bwd_wide", torch.float32, 0, False),
])
def test_backward_writes_dq_in_q_dtype_on_the_wgmma_route(
        launches, dtype, kdim, dq_fp32, kind, dq_dtype, dq_bf16, cast):
    """Without dq_fp32 the bf16 dq kernels of the wgmma route (K <= 256)
    and of the wide library's cluster route (K 257-2048) and windowed
    route (past 2048) write dq in bf16 themselves (no cast launch); with
    dq_fp32 dq stays fp32."""
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=dtype, count=4)
    lse = torch.zeros(2, 3, 37)
    plan = ops.backward_plan(q, k, v, g, lse, lse, "bnhk", None, 0.0, 0,
                             (0, 0, 0, 1, 1, 0), False, dq_fp32)
    assert (plan.kind, plan.outputs[0][2], plan.args.dq_bf16,
            plan.cast_dq) == (kind, dq_dtype, dq_bf16, cast)
    dq, dk, dv = ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0,
                                     dq_fp32=dq_fp32)
    assert dq.dtype == (torch.float32 if dq_fp32 else dtype)
    assert dq.shape == q.shape and dk.dtype == dv.dtype == dtype


@pytest.mark.parametrize("kdim,kernel", [(136, "wgmma"), (192, "wgmma"),
                                         (256, "wgmma"), (264, "wide"),
                                         (512, "wide"), (520, "cluster"),
                                         (4160, "windowed")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_up_to_256_launches_the_wgmma_libraries(launches, kdim, kernel,
                                                     rate):
    """The plans at bf16 K 129-256 pick the wgmma libraries (entry points
    ``vtd_flash_attention_{fwd,bwd}_sm90``) and count their launches
    there; with dropout the backward's workspace is the packed keep bits;
    dq comes back in bf16 from the dq kernel. Past 256 the backward's
    cluster route, its dq in bf16 from its dq kernel too (to K 2048; the
    windowed route past that likewise, with the scores workspace); the
    forward the wide kernel
    (``vtd_flash_attention_fwd_wide``, counted in ``wide_launches``) to
    K 512, its clusters past it (``cluster_launches``) to K 4096, the
    windowed route of the mma.sync library past that."""
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), count=4)
    seed = fa.seed_tensor(5, "cpu") if rate else None
    wgmma = kernel == "wgmma"
    before = (fa.flash_attention.wgmma_launches,
              fa.flash_attention.wgmma_backward_launches,
              fa.flash_attention.wide_launches)
    out, lse, _, _ = ops._flash_fwd_cuda(q, k, v, "bnhk", True, seed, rate)
    assert launches[-1][0] == {"wgmma": "vtd_flash_attention_fwd_sm90",
                               "wide": "vtd_flash_attention_fwd_wide",
                               "cluster": "vtd_flash_attention_fwd_wide",
                               "windowed": "vtd_flash_attention_fwd"}[kernel]
    assert (fa.flash_attention.wide_launches - before[2]) == (
        kernel == "wide")
    assert fa.flash_attention.cluster_launches == (kernel == "cluster")
    assert fa.flash_attention.windowed_launches == (kernel == "windowed")
    assert out.shape == q.shape and lse.shape == (2, 3, 37)
    plan = ops.backward_plan(q, k, v, g, lse, lse, "bnhk", seed, rate, 0,
                             (0, 0, 0, 1, 1, 0), False, False)
    assert plan.kind == ("bwd_sm90" if wgmma else "bwd_wide")
    assert plan.workspace == (
        (fa.keep_bits_shape(2, 3, 37), torch.int32) if wgmma and rate
        else fa.scores_workspace(2, 3, 37, kdim, torch.bfloat16, True)
        if kernel == "windowed" else None)
    dq, dk, dv = ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", seed,
                                     rate, dq_fp32=False)
    assert launches[-1][0] == ("vtd_flash_attention_bwd_sm90" if wgmma
                               else "vtd_flash_attention_bwd")
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert ops.BwdArgs.from_address(launches[-1][1][0]).dq_bf16 == 1
    assert (fa.flash_attention.wgmma_launches - before[0],
            fa.flash_attention.wgmma_backward_launches - before[1]) == (
                wgmma, wgmma)


def test_backward_fake_gives_dq_in_q_dtype_without_dq_fp32():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 37, 3, 64, dtype=torch.bfloat16)
        lse = torch.empty(2, 3, 37)
        dq, dk, dv = torch.ops.vtd_torch.flash_attention_bwd(
            q, q, q, q, lse, lse, "bnhk", None, 0.0, dq_fp32=False)
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_the_wrapper_casts_no_dq(launches, monkeypatch):
    """``_launch_backward`` hands dq over as the operator returns it: in
    q's dtype unless fp32_dq, with no cast of its own (the dispatcher has
    no CPU kernel, so the operator's CUDA implementation is called
    directly)."""
    monkeypatch.setattr(fa, "_BWD_OP", ops._flash_bwd_cuda)
    q, k, v, g = _operands(count=4)
    lse = torch.zeros(2, 3, 37)
    dq, _, _ = fa._launch_backward(q, k, v, g, lse, lse, "bnhk")
    assert dq.dtype == torch.bfloat16
    dq, _, _ = fa._launch_backward(q, k, v, g, lse, lse, "bnhk",
                                   fp32_dq=True)
    assert dq.dtype == torch.float32
    assert [ops.BwdArgs.from_address(args[0]).dq_bf16
            for _, args in launches] == [1, 0]


@pytest.mark.parametrize("offsets", [(1, 2), (1, 2, 3, 4), (0, 0, 0, 0, 1, 0)])
def test_malformed_offsets_raise_before_a_launch(launches, offsets):
    """Offsets of another length than 3 or 6, or a row map with
    inner_local 0, raise mask_coords' ValueError from the wrapper or the
    plan, and nothing launches."""
    q, k, v = _operands()
    with pytest.raises(ValueError, match="with inner_local >= 1"):
        ops._flash_fwd_cuda(q, k, v, "bnhk", False, None, 0.0,
                            *fa._coords(offsets))
    assert not launches


@pytest.mark.parametrize("dtype,kdim,entry,counter", [
    (torch.float32, 64, "vtd_flash_attention_fwd", None),
    (torch.float32, 128, "vtd_flash_attention_fwd_wide", "halves_launches"),
    (torch.float32, 132, "vtd_flash_attention_fwd_wide", "wide_launches"),
    (torch.float32, 384, "vtd_flash_attention_fwd_wide", "wide_launches"),
    (torch.float32, 388, "vtd_flash_attention_fwd_wide", "cluster_launches"),
    (torch.float32, 3104, "vtd_flash_attention_fwd", "windowed_launches"),
    (torch.bfloat16, 320, "vtd_flash_attention_fwd_wide", "wide_launches"),
    (torch.bfloat16, 576, "vtd_flash_attention_fwd_wide",
     "cluster_launches")])
@pytest.mark.parametrize("ring", [False, True])
def test_the_wide_forward_plan_names_its_library(launches, dtype, kdim, entry,
                                                 counter, ring):
    """The forward's plan launches the library ``forward_kernel`` names at
    each width, with the block the C entry reads (dtype, K, fp32 output
    for a ring block, its resumed and suspended state), and counts the
    launches of each route of the wide kernel (the fp32 column halves, one
    CTA, a cluster) and of the windowed one apart."""
    q, k, v = _operands(shape=(2, 37, 3, kdim), dtype=dtype)
    routes = ("halves_launches", "wide_launches", "cluster_launches",
              "windowed_launches")
    before = {name: getattr(fa.flash_attention, name) for name in routes}
    if ring:
        acc = torch.zeros(q.shape, dtype=torch.float32)
        m = torch.zeros(2, 3, 37)
        l_in = torch.zeros(2, 3, 37, 4)
        out, _, m_out, l_out = _forward(q, k, v, out_fp32=True, acc_in=acc,
                                        m_in=m, l_in=l_in, suspend=True)
        assert (m_out.shape, l_out.shape) == ((2, 3, 37), (2, 3, 37, 4))
        args = launches[-1][1]
        assert all(a is not None for a in args[6:11])
    else:
        out, _, _, _ = _forward(q, k, v, with_lse=True)
    assert launches[-1][0] == entry
    block = _block(launches)
    assert (block.dtype, block.head_dim, block.out_fp32) == (
        0 if dtype == torch.float32 else 1, kdim, int(ring))
    assert out.dtype == (torch.float32 if ring else dtype)
    assert {name: getattr(fa.flash_attention, name) - n
            for name, n in before.items()} == {
                name: int(name == counter) for name in routes}
    assert ops.forward_plan(q, k, v, "bnhk", False, None, 0.0,
                            (0, 0, 0, 1, 1, 0), False, None, None, None,
                            False).kind == {
        "vtd_flash_attention_fwd": "fwd",
        "vtd_flash_attention_fwd_wide": "fwd_wide"}[entry]


@pytest.mark.parametrize("kdim,halves", [(64, False), (68, True), (80, True),
                                         (128, True)])
@pytest.mark.parametrize("route", ["split", "partials"])
def test_the_fp32_halves_count_their_launches(launches, kdim, halves, route):
    """fp32 B2 at 64 < K <= 128 runs the column halves of the mma.sync
    library (``vtd_flash_attention_bwd``, the caller's K in the block, the
    partials workspace of 64-key tiles on that route) and counts them in
    ``halves_backward_launches``; K <= 64 the 64 instance, not counted."""
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=torch.float32,
                           count=4)
    lse = torch.zeros(2, 3, 37)
    before = fa.flash_attention.halves_backward_launches
    ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0,
                        fa.DQ_ROUTES[route])
    name, args = launches[-1]
    assert name == "vtd_flash_attention_bwd"
    assert ops.BwdArgs.from_address(args[0]).head_dim == kdim
    assert (args[10] is not None) == (route == "partials")
    assert fa.flash_attention.halves_backward_launches - before == halves


@pytest.mark.parametrize("dtype,kdim,cluster", [
    (torch.bfloat16, 576, 2), (torch.bfloat16, 1024, 2),
    (torch.bfloat16, 1032, 3), (torch.bfloat16, 4096, 8),
    (torch.float32, 448, 2), (torch.float32, 512, 2),
    (torch.float32, 1156, 4), (torch.float32, 3072, 8)])
def test_the_cluster_plan_records_its_size_and_asks_once(launches, dtype,
                                                         kdim, cluster):
    """Past one CTA's widest K (fp32 384, bf16 512) the forward's plan
    names the cluster route with ceil(K / 384) or ceil(K / 512) CTAs a
    cluster, asks the library once per plan whether such a cluster can be
    resident (its block, at the caller's K), and launches the wide
    library's entry; a second call of the same signature asks nothing."""
    q, k, v = _operands(shape=(2, 37, 3, kdim), dtype=dtype)
    plan = ops.forward_plan(q, k, v, "bnhk", True, None, 0.0,
                            (0, 0, 0, 1, 1, 0), False, None, None, None,
                            False)
    assert (plan.kernel, plan.kind, plan.cluster) == ("cluster", "fwd_wide",
                                                      cluster)
    assert fa.head_dim_plan(kdim, dtype).cluster == cluster
    assert fa.cluster_size(kdim, dtype) == cluster
    assert RESIDENT["asked"] == []          # building a plan asks nothing
    for _ in range(2):
        _forward(q, k, v, with_lse=True)
    assert RESIDENT["asked"] == [kdim]
    assert [name for name, _ in launches] == [
        "vtd_flash_attention_fwd_wide"] * 2
    assert fa.flash_attention.cluster_launches == 2


@pytest.mark.parametrize("dtype,kdim", [(torch.bfloat16, 40),
                                        (torch.bfloat16, 320),
                                        (torch.bfloat16, 4160),
                                        (torch.float32, 80),
                                        (torch.float32, 384),
                                        (torch.float32, 3104)])
def test_no_other_route_asks_for_clusters(launches, dtype, kdim):
    """Only the cluster route's plan asks the occupancy question; a zero
    answer changes nothing elsewhere (its size there is 1)."""
    RESIDENT["clusters"] = 0
    q, k, v = _operands(shape=(2, 37, 3, kdim), dtype=dtype)
    _forward(q, k, v, with_lse=True)
    assert RESIDENT["asked"] == []
    assert fa.cluster_size(kdim, dtype) == 1
    assert len(launches) == 1


@pytest.mark.parametrize("dtype,kdim", [(torch.bfloat16, 576),
                                        (torch.float32, 512)])
def test_a_cluster_that_cannot_be_resident_raises_at_plan_time(
        launches, dtype, kdim):
    """When the library answers that no cluster of the instance can be
    resident (0), the plan raises RuntimeError, nothing launches, no
    counter moves and no plan is kept: no route gives way (the windowed
    one is the forward past the cluster's reach only)."""
    RESIDENT["clusters"] = 0
    q, k, v = _operands(shape=(2, 37, 3, kdim), dtype=dtype)
    counts = {name: getattr(fa.flash_attention, name) for name in COUNTERS}
    with pytest.raises(RuntimeError, match="no thread-block cluster of 2 "
                       "CTAs"):
        _forward(q, k, v, with_lse=True)
    assert launches == [] and ops._fwd_plans == {}
    assert counts == {name: getattr(fa.flash_attention, name)
                      for name in COUNTERS}
    assert RESIDENT["asked"] == [kdim]


def test_a_failed_cluster_query_raises_its_cuda_error(launches, monkeypatch):
    """A negative answer is a CUDA error code, raised as the launch errors
    are (``_build.raise_on_error``)."""
    RESIDENT["clusters"] = -1
    raised = []

    def raise_on_error(lib, err, what):
        raised.append((err, what))
        raise RuntimeError(what)

    monkeypatch.setattr(ops._build, "raise_on_error", raise_on_error)
    q, k, v = _operands(shape=(2, 37, 3, 1024))
    with pytest.raises(RuntimeError, match="cluster occupancy"):
        _forward(q, k, v)
    assert raised == [(1, "flash attention forward (cluster occupancy "
                          "query)")]
    assert launches == []


@pytest.mark.parametrize("dtype,kdim,cluster,route", [
    *((torch.float32, kdim, cluster, route)
      for kdim, cluster in ((132, 2), (256, 2), (320, 3), (512, 4),
                            (1024, 8))
      for route in ("split", "partials")),
    (torch.bfloat16, 264, 2, "split"), (torch.bfloat16, 512, 2, "split"),
    (torch.bfloat16, 520, 3, "split"), (torch.bfloat16, 2048, 8, "split")])
def test_the_backward_cluster_plan_records_its_size_and_asks_once(
        launches, dtype, kdim, cluster, route):
    """fp32 past K 128 and bf16 past 256, to 1024 and 2048, the backward's
    plan names the cluster route of the wide library with ceil(K / 128) or
    ceil(K / 256) CTAs a cluster (``head_dim_plan``'s ``grad_cluster``),
    asks the library once per plan whether such a cluster of its kernels
    can be resident (its block, at the caller's K), launches the entry
    point and counts ``cluster_backward_launches``; a second call of the
    same signature asks nothing. bf16 takes the split route only."""
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=dtype, count=4)
    lse = torch.zeros(2, 3, 37)
    plan = ops.backward_plan(q, k, v, g, lse, lse, "bnhk", None, 0.0,
                             fa.DQ_ROUTES[route], (0, 0, 0, 1, 1, 0), False,
                             True)
    assert (plan.kernel, plan.kind, plan.cluster) == ("cluster", "bwd_wide",
                                                      cluster)
    assert fa.head_dim_plan(kdim, dtype).grad_cluster == cluster
    assert RESIDENT["bwd_asked"] == []      # building a plan asks nothing
    for _ in range(2):
        ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0,
                            fa.DQ_ROUTES[route])
    assert RESIDENT["bwd_asked"] == [kdim]
    assert [name for name, _ in launches] == ["vtd_flash_attention_bwd"] * 2
    assert (launches[-1][1][10] is not None) == (route == "partials")
    f = fa.flash_attention
    assert (f.cluster_backward_launches, f.windowed_backward_launches,
            f.backward_launches) == (2, 0, 2)


@pytest.mark.parametrize("dtype,kdim,kernel", [
    (torch.bfloat16, 40, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 2056, "windowed"), (torch.bfloat16, 4160, "windowed"),
    (torch.float32, 80, "mma_sync"), (torch.float32, 128, "mma_sync"),
    (torch.float32, 1028, "windowed"), (torch.float32, 3104, "windowed")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_no_other_backward_route_asks_for_clusters(launches, dtype, kdim,
                                                   kernel, rate):
    """Off the backward's cluster route no plan asks the occupancy
    question, a zero answer changes nothing, the cluster size is 1, and
    past the cluster's reach the windowed route counts its launches in
    ``windowed_backward_launches`` (with the replay in
    ``backward_drop_launches``), nothing in ``cluster_backward_launches``."""
    RESIDENT["bwd_clusters"] = 0
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=dtype, count=4)
    lse = torch.zeros(2, 3, 37)
    seed = fa.seed_tensor(5, "cpu") if rate else None
    f = fa.flash_attention
    before = (f.windowed_backward_launches, f.backward_drop_launches)
    ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", seed, rate)
    assert RESIDENT["bwd_asked"] == []
    assert fa.backward_kernel(kdim, dtype) == kernel
    assert fa.backward_cluster_size(kdim, dtype) == 1
    assert len(launches) == 1
    assert f.cluster_backward_launches == 0
    assert (f.windowed_backward_launches - before[0],
            f.backward_drop_launches - before[1]) == (
                kernel == "windowed", rate > 0)


@pytest.mark.parametrize("dtype,kdim,cluster", [(torch.bfloat16, 320, 2),
                                                (torch.float32, 512, 4)])
def test_a_backward_cluster_that_cannot_be_resident_raises(launches, dtype,
                                                           kdim, cluster):
    """When the library answers that no cluster of the backward's kernels
    can be resident (0), the plan raises RuntimeError, nothing launches,
    no counter moves and no plan is kept: the windowed route does not take
    over."""
    RESIDENT["bwd_clusters"] = 0
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=dtype, count=4)
    lse = torch.zeros(2, 3, 37)
    counts = {name: getattr(fa.flash_attention, name) for name in COUNTERS}
    with pytest.raises(RuntimeError, match=f"no thread-block cluster of "
                       f"{cluster} CTAs of the flash backward"):
        ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0)
    assert launches == [] and ops._bwd_plans == {}
    assert counts == {name: getattr(fa.flash_attention, name)
                      for name in COUNTERS}
    assert RESIDENT["bwd_asked"] == [kdim]


def test_a_failed_backward_cluster_query_raises_its_cuda_error(launches,
                                                                monkeypatch):
    """A negative answer of the backward's query is a CUDA error code,
    raised as the launch errors are (``_build.raise_on_error``), and
    nothing launches."""
    RESIDENT["bwd_clusters"] = -2
    raised = []

    def raise_on_error(lib, err, what):
        raised.append((err, what))
        raise RuntimeError(what)

    monkeypatch.setattr(ops._build, "raise_on_error", raise_on_error)
    q, k, v, g = _operands(shape=(2, 37, 3, 640), count=4)
    lse = torch.zeros(2, 3, 37)
    with pytest.raises(RuntimeError, match="cluster occupancy"):
        ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", None, 0.0)
    assert raised == [(2, "flash attention backward (cluster occupancy "
                          "query)")]
    assert launches == []


# (b, h, n, K, dtype, backward) -> the scores workspace's rows and shape
# and the slabs a windowed call runs: one slab while the larger of q's
# bytes and one row's need holds every row, else rows of that budget.
SCORES = [
    ((2, 16, 256, 4160, torch.bfloat16, False), (32, 256, 256), 1),
    ((2, 16, 256, 2112, torch.bfloat16, True), (32, 2, 256, 256), 1),
    ((3, 1, 321, 3104, torch.float32, False), (3, 384, 384), 1),
    ((1, 8, 4096, 3104, torch.float32, False), (6, 4096, 4096), 2),
    ((1, 2, 4200, 4160, torch.bfloat16, False), (1, 4224, 4224), 2),
    ((1, 2, 1100, 2112, torch.bfloat16, True), (1, 2, 1152, 1152), 2),
    ((1, 2, 577, 1056, torch.float32, True), (1, 2, 640, 640), 2),
    ((4, 5, 64, 1028, torch.float32, True), (20, 2, 64, 64), 1)]


@pytest.mark.parametrize("call,shape,slabs", SCORES)
def test_scores_workspace_and_slabs(call, shape, slabs):
    """The windowed routes' workspace: (rows, np, np) fp32 S for the
    forward, (rows, 2, np, np) P and dS in the input type for the
    backward, np = 64 * ceil(N / 64); rows as many as the larger of q's
    bytes and one row's need holds, so no launch's workspace passes it,
    and ceil(B * H / rows) slabs."""
    b, h, n, kdim, dtype, backward = call
    got, ws_dtype = fa.scores_workspace(*call)
    assert got == shape
    assert ws_dtype == (dtype if backward else torch.float32)
    assert fa.scores_slabs(*call) == slabs
    item = torch.empty((), dtype=ws_dtype).element_size()
    row = item
    for size in shape[1:]:
        row *= size
    q_bytes = b * h * n * kdim * torch.empty((), dtype=dtype).element_size()
    assert shape[0] * row <= max(q_bytes, row)
    assert shape[0] == b * h or (shape[0] + 1) * row > max(q_bytes, row)


@pytest.mark.parametrize("dtype,kdim,kernel", [
    (torch.bfloat16, 4160, "windowed"), (torch.float32, 3104, "windowed"),
    (torch.bfloat16, 4096, "cluster"), (torch.float32, 64, "mma_sync")])
def test_the_windowed_forward_hands_its_workspace_over(launches, dtype, kdim,
                                                       kernel):
    """A windowed forward allocates the scores workspace, hands its address
    to the entry point after the state's (the eleventh device address) and
    its rows in the block (``ws_rows``), and counts one launch in
    ``windowed_launches`` a call, whatever the slabs; the other routes
    hand over no workspace and count none there."""
    q, k, v = _operands(shape=(2, 37, 3, kdim), dtype=dtype)
    before = fa.flash_attention.windowed_launches
    for _ in range(2):
        _forward(q, k, v, with_lse=True)
    args = launches[-1][1]
    assert len(args) == 14
    windowed = kernel == "windowed"
    rows = fa.scores_workspace(2, 3, 37, kdim, dtype, False)[0][0]
    assert (args[11] is not None) == windowed
    assert _block(launches).ws_rows == (rows if windowed else 0)
    assert fa.flash_attention.windowed_launches - before == 2 * windowed
    plan = next(iter(ops._fwd_plans.values()))
    assert plan.kernel == kernel
    assert plan.workspace == (fa.scores_workspace(2, 3, 37, kdim, dtype,
                                                  False)
                              if windowed else None)


@pytest.mark.parametrize("dtype,kdim,route", [
    (torch.bfloat16, 2112, "split"), (torch.float32, 1056, "split"),
    (torch.float32, 1056, "partials"), (torch.float32, 1024, "partials")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_the_windowed_backward_takes_the_scores_workspace(launches, dtype,
                                                          kdim, route, rate):
    """A windowed backward takes the scores workspace in place of the
    partials on either fp32 dq route (its one dq kernel sums the key tiles
    in order), with ``ws_rows`` in the block, and counts one launch in
    ``windowed_backward_launches`` (with the replay also in
    ``backward_drop_launches``); the cluster route keeps the partials."""
    q, k, v, g = _operands(shape=(2, 37, 3, kdim), dtype=dtype, count=4)
    lse = torch.zeros(2, 3, 37)
    seed = fa.seed_tensor(5, "cpu") if rate else None
    f = fa.flash_attention
    before = (f.windowed_backward_launches, f.backward_drop_launches,
              f.cluster_backward_launches)
    ops._flash_bwd_cuda(q, k, v, g, lse, lse, "bnhk", seed, rate,
                        fa.DQ_ROUTES[route])
    windowed = fa.backward_kernel(kdim, dtype) == "windowed"
    plan = next(iter(ops._bwd_plans.values()))
    block = ops.BwdArgs.from_address(launches[-1][1][0])
    if windowed:
        want = fa.scores_workspace(2, 3, 37, kdim, dtype, True)
        assert plan.workspace == want and block.ws_rows == want[0][0]
    else:
        assert plan.workspace == ((1, 6, 37, kdim), torch.float32)
        assert block.ws_rows == 0
    assert launches[-1][1][10] is not None
    assert (f.windowed_backward_launches - before[0],
            f.backward_drop_launches - before[1],
            f.cluster_backward_launches - before[2]) == (
                windowed, rate > 0, not windowed)
