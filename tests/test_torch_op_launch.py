"""The launch path of the five operators beside flash attention
(kernels/ops.py) on the CPU: layer_norm (B4), dense_mish (B3),
fused_int8_dense and int8_dense (B5) and the MLP dropout.

No JAX counterpart: the operators, their schemas and their launch plans
are the port's own. A plan holds what a call of one signature launches
(the copies it makes, the argument block, for B3 and B5 the instance the
source's plan query picked) and is built without a card, so these tests
build plans from CPU tensors. The operators' CUDA implementations are
driven here with a stand-in for the C entry points that records their
arguments and launches nothing, so the plan caches are exercised as on
the card; tests/test_torch_cuda.py and chip_smoke.py launch the kernels
through the same path.
"""

import ctypes
import os
import re

import pytest
import torch

from vision_transformer_detector_tpu_torch.kernels import (
    dropout as drop, flash_attention as fa, fused_ffn, fused_ln, ops,
    quantization as qz)

# The schemas ``custom_op`` inferred for these operators before they were
# ``Library`` definitions: saved vit_b16_384 programs hold layer_norm and
# dense_mish nodes, so each stays as it was, character for character.
SCHEMAS = {
    "layer_norm": "vtd_torch::layer_norm(Tensor x2, Tensor gamma, "
                  "Tensor beta, float eps) -> Tensor",
    "dense_mish": "vtd_torch::dense_mish(Tensor x2, Tensor w, Tensor b, "
                  "bool apply_mish, SymInt request) -> Tensor",
    "fused_int8_dense": "vtd_torch::fused_int8_dense(Tensor x2, "
                        "Tensor kernel_q, Tensor? transposed, Tensor scale, "
                        "Tensor bias, bool apply_mish, SymInt request) "
                        "-> Tensor",
    "int8_dense": "vtd_torch::int8_dense(Tensor x2, Tensor kernel_q, "
                  "Tensor? transposed, Tensor scale, Tensor bias, "
                  "bool apply_mish, SymInt request) -> Tensor",
    "dropout": "vtd_torch::dropout(Tensor x2, Tensor seed, float rate, "
               "SymInt row_base=0, SymInt inner_local=1, "
               "SymInt inner_global=1, SymInt inner_base=0, "
               "SymInt col_base=0) -> Tensor",
}
PLANS = ("_ln_plans", "_ffn_plans", "_int8_plans", "_drop_plans")
COUNTERS = ((fused_ln.fused_layer_norm, "launches"),
            (fused_ffn.fused_dense_mish, "launches"),
            (fused_ffn.fused_dense_mish, "tensor_core_launches"),
            (qz.fused_int8_dense, "launches"),
            (qz.fused_int8_dense, "tensor_core_launches"),
            (qz.int8_dense, "launches"),
            (qz.int8_dense, "tensor_core_launches"),
            (drop.dropout, "launches"))


class Stand:
    """The libraries stood in for: each entry point's call recorded (its
    name and arguments, the plan's block first), nothing launched. A plan
    query writes ``instance[name]`` into the block; ``fail`` names an
    entry point that returns CUDA error 1."""

    def __init__(self):
        self.calls = []
        self.instance = {"vtd_dense_mish_plan": 2, "vtd_int8_dense_plan": 1}
        self.fail = None

    def __getattr__(self, name):
        if name == "vtd_cuda_error_string":
            return lambda code: b"invalid argument"

        def entry(*args):
            self.calls.append((name, args))
            if name == self.fail:
                return 1
            if name in self.instance:
                struct = (ops.DenseMishArgs if "mish" in name
                          else ops.Int8DenseArgs)
                struct.from_address(args[0]).instance = self.instance[name]
            return 0
        return entry

    def launches(self, name):
        return [args for called, args in self.calls if called == name]


@pytest.fixture
def stand(monkeypatch):
    """The stand-in libraries, empty plan caches, the launch counters put
    back afterwards, and no ``torch.cuda`` device context or Stream object
    reachable: a call that entered one would raise."""
    lib = Stand()
    monkeypatch.setattr(ops, "_library", lambda kind: lib)
    monkeypatch.setattr(ops, "_raw_stream", lambda: (lambda index: 0))
    for name in PLANS:
        monkeypatch.setattr(ops, name, {})
    for fn, name in COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))

    def refused(*args, **kwargs):
        raise AssertionError("a call entered torch.cuda.device or built a "
                             "Stream")

    monkeypatch.setattr(torch.cuda, "device", refused)
    monkeypatch.setattr(torch.cuda, "current_stream", refused)
    return lib


def _rnd(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _offset(shape, dtype, elements):
    """A contiguous tensor of ``shape`` whose data starts ``elements``
    elements into its storage."""
    n = 1
    for size in shape:
        n *= size
    return _rnd(n + elements, dtype=dtype)[elements:].view(shape)


def _codes(k, n):
    g = torch.Generator().manual_seed(1)
    return torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)


def _ln(x, gamma=None, beta=None, eps=1e-3):
    d = x.shape[1]
    return ops._layer_norm_cuda(x, _rnd(d) if gamma is None else gamma,
                                _rnd(d) if beta is None else beta, eps)


def _int8(x, codes, transposed="make", scale=None, bias=None, fused=True,
          request=0, apply_mish=False):
    n = codes.shape[1]
    if isinstance(transposed, str):
        transposed = codes.t().contiguous()
    fn = ops._fused_int8_dense_cuda if fused else ops._int8_dense_cuda
    return fn(x, codes, transposed, _rnd(n).abs() if scale is None else scale,
              _rnd(n) if bias is None else bias, apply_mish, request)


def _seed():
    return fa.seed_tensor(2 ** 32 - 9, "cpu")


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schemas_are_unchanged(name):
    assert str(getattr(torch.ops.vtd_torch, name).default._schema) \
        == SCHEMAS[name]


def test_custom_op_and_its_helpers_are_gone():
    """Every operator is a ``Library`` definition: ops.py imports no
    ``custom_op`` and keeps no per-call device context or Stream reader."""
    for name in ("custom_op", "_define", "_stream"):
        assert not hasattr(ops, name), name
    with open(ops.__file__) as f:
        assert "custom_op(" not in f.read()


@pytest.mark.parametrize("module,attr,name", [
    (fused_ln, "_OP", "layer_norm"), (fused_ffn, "_OP", "dense_mish"),
    (qz, "_FUSED_OP", "fused_int8_dense"), (qz, "_INT8_OP", "int8_dense"),
    (drop, "_OP", "dropout")])
def test_wrappers_hold_the_default_overloads(module, attr, name):
    assert getattr(module, attr) is getattr(torch.ops.vtd_torch,
                                            name).default


@pytest.mark.parametrize("struct,name", [
    (ops.LayerNormArgs, "LayerNormArgs"), (ops.DenseMishArgs, "DenseMishArgs"),
    (ops.Int8DenseArgs, "Int8DenseArgs"), (ops.DropoutArgs, "DropoutArgs")])
def test_argument_blocks_match_the_c_structs(struct, name):
    """The ctypes blocks name csrc/launch_common.cuh's fields in its order,
    with its sizes (int, long long, unsigned int, float)."""
    path = os.path.join(os.path.dirname(ops.__file__), "..", "csrc",
                        "launch_common.cuh")
    with open(path) as f:
        body = re.search(r"struct %s \{(.*?)\};" % name, f.read(),
                         re.S).group(1)
    fields = []
    for line in body.splitlines():
        found = re.match(r"\s*(unsigned int|long long|int|float) ([^;]*);",
                         line)
        for field in found.group(2).split(",") if found else ():
            fields.append((field.strip(), found.group(1)))
    sizes = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint32,
             "float": ctypes.c_float, "long long": ctypes.c_longlong}
    assert [f[0] for f in struct._fields_] == [f[0] for f in fields]
    for (fname, ftype), (_, ctype) in zip(struct._fields_, fields):
        assert ctypes.sizeof(ftype) == ctypes.sizeof(sizes[ctype]), fname
        assert ctypes.alignment(ftype) == ctypes.alignment(sizes[ctype])


def _call(op, seed_value=0):
    """One call of ``op`` on fresh tensors of one signature."""
    if op == "layer_norm":
        return _ln(_rnd(9, 256, dtype=torch.bfloat16, seed=seed_value))
    if op == "dense_mish":
        return ops._dense_mish_cuda(_rnd(9, 64, seed=seed_value),
                                    _rnd(64, 24), _rnd(24), True, 0)
    if op in ("fused_int8_dense", "int8_dense"):
        return _int8(_rnd(9, 64, dtype=torch.bfloat16, seed=seed_value),
                     _codes(64, 24), fused=op == "fused_int8_dense")
    return ops._dropout_cuda(_rnd(9, 40, seed=seed_value), _seed(), 0.1)


ENTRY = {"layer_norm": ("vtd_layer_norm", "_ln_plans"),
         "dense_mish": ("vtd_dense_mish", "_ffn_plans"),
         "fused_int8_dense": ("vtd_int8_dense", "_int8_plans"),
         "int8_dense": ("vtd_int8_dense", "_int8_plans"),
         "dropout": ("vtd_dropout", "_drop_plans")}


@pytest.mark.parametrize("op", sorted(ENTRY))
def test_one_plan_per_signature(stand, op):
    """Calls with the same shapes, strides, dtypes and address residues
    share one plan and one block, whatever their addresses; each launch
    gets its own addresses, a fresh output, and one ctypes call."""
    outs = [_call(op, seed_value=i) for i in range(3)]
    entry, plans = ENTRY[op]
    launched = stand.launches(entry)
    assert len(launched) == 3 and len(getattr(ops, plans)) == 1
    assert len({args[0] for args in launched}) == 1
    assert all(args[-1] == 0 for args in launched)   # the stream
    # Each output is its own allocation, and the kernel was handed it.
    out_at = {"layer_norm": 4, "dense_mish": 4, "fused_int8_dense": 6,
              "int8_dense": 6, "dropout": 2}[op]
    assert [args[out_at] for args in launched] == [o.data_ptr()
                                                    for o in outs]
    queries = [name for name, _ in stand.calls if name.endswith("_plan")]
    assert len(queries) == (1 if op in ("dense_mish", "fused_int8_dense",
                                        "int8_dense") else 0)


def test_layer_norm_block_and_output(stand):
    x = _rnd(9, 256, dtype=torch.bfloat16)
    out = _ln(x, eps=1e-5)
    block = ops.LayerNormArgs.from_address(stand.calls[-1][1][0])
    assert (block.device, block.dtype, block.rows, block.d) == (-1, 1, 9, 256)
    assert block.eps == pytest.approx(1e-5)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert out.is_contiguous() and out.data_ptr() != x.data_ptr()


def test_dropout_block_holds_the_mask(stand):
    """The threshold and 1 / (1 - rate) are the flash kernels' and the
    plain version's, the coordinates are reduced mod 2^32."""
    x, seed = _rnd(2, 4, 40), _seed()
    ops._dropout_cuda(x.reshape(-1, 40), seed, 0.25, -3, 2, 4, 1,
                      2 ** 33 + 7)
    block = ops.DropoutArgs.from_address(stand.calls[-1][1][0])
    assert (block.rows, block.cols, block.dtype) == (8, 40, 0)
    assert block.threshold == fa._keep_threshold(0.25)
    assert block.inv_keep == drop.inv_keep(0.25)
    assert (block.row_base, block.inner_local, block.inner_global,
            block.inner_base, block.col_base) == (2 ** 32 - 3, 2, 4, 1, 7)
    assert stand.calls[-1][1][1:4] == (x.data_ptr(), stand.calls[-1][1][2],
                                       seed.data_ptr())


@pytest.mark.parametrize("variant", ["rate", "row_base", "row_map",
                                     "col_base", "dtype", "stride"])
def test_dropout_arguments_that_differ_get_their_own_plan(stand, variant):
    x = _rnd(9, 40)
    seed = _seed()
    ops._dropout_cuda(x, seed, 0.1)
    kw = {"rate": 0.1}
    if variant == "rate":
        kw["rate"] = 0.2
    elif variant == "row_base":
        kw["row_base"] = 5
    elif variant == "row_map":
        kw.update(inner_local=3, inner_global=9, inner_base=1)
    elif variant == "col_base":
        kw["col_base"] = 40
    elif variant == "dtype":
        x = x.bfloat16()
    else:
        x = _rnd(9, 48)[:, :40]
    rate = kw.pop("rate")
    ops._dropout_cuda(x, seed, rate, **kw)
    assert len(ops._drop_plans) == 2
    first, second = (ops.DropoutArgs.from_address(args[0])
                     for args in stand.launches("vtd_dropout"))
    if variant == "rate":
        assert second.threshold == fa._keep_threshold(0.2)
    elif variant == "row_map":
        assert (second.inner_local, second.inner_global,
                second.inner_base) == (3, 9, 1)
    elif variant == "col_base":
        assert (first.col_base, second.col_base) == (0, 40)
    elif variant == "dtype":
        assert (first.dtype, second.dtype) == (0, 1)
    elif variant == "stride":
        # A strided view is copied first: the kernel reads the copy.
        assert stand.launches("vtd_dropout")[-1][1] != x.data_ptr()


@pytest.mark.parametrize("dtype,shift", [(torch.bfloat16, 1),
                                         (torch.float32, 2)])
def test_layer_norm_pointer_off_16_bytes_is_copied(stand, dtype, shift):
    """The key holds x's address mod 16: a contiguous x off a 16-byte
    boundary gets its own plan, which copies it (the kernel loads 16 or 8
    bytes at a time); an aligned x of the same shape is read in place."""
    aligned = _offset((9, 256), dtype, 0)
    _ln(aligned)
    assert stand.calls[-1][1][1] == aligned.data_ptr()
    off = _offset((9, 256), dtype, shift)
    assert off.is_contiguous() and off.data_ptr() % 16
    _ln(off)
    assert len(ops._ln_plans) == 2
    read = stand.calls[-1][1][1]
    assert read != off.data_ptr() and read % 16 == 0
    assert ops._ln_plans[next(reversed(ops._ln_plans))].copies \
        == (True, False, False)


@pytest.mark.parametrize("which", ["bf16", "strided", "misaligned"])
def test_layer_norm_gamma_and_beta_read_as_aligned_fp32(stand, which):
    """gamma and beta are copied to contiguous fp32 on a 16-byte boundary
    where they are not (bf16, a strided view, a view off a boundary), and
    read in place where they are."""
    d = 256
    gamma = {"bf16": _rnd(d, dtype=torch.bfloat16),
             "strided": _rnd(2 * d)[::2],
             "misaligned": _offset((d,), torch.float32, 1)}[which]
    beta = _rnd(d)
    _ln(_rnd(9, d), gamma, beta)
    _, gp, bp = stand.calls[-1][1][1:4]
    assert gp != gamma.data_ptr() and gp % 16 == 0
    assert bp == beta.data_ptr()
    plan = next(iter(ops._ln_plans.values()))
    assert plan.copies == (False, True, False)


@pytest.mark.parametrize("request_,instance,tensor_core", [
    (0, 2, 1), (0, 1, 1), (1, 0, 0), (2, 1, 1), (3, 2, 1)])
def test_dense_mish_counts_the_planned_instance(stand, request_, instance,
                                                tensor_core):
    """The plan asks the source once which instance a signature runs; each
    call counts one launch and, where that instance is on the tensor
    cores, one tensor-core launch, and hands over the block it planned."""
    stand.instance["vtd_dense_mish_plan"] = instance
    f = fused_ffn.fused_dense_mish
    before = (f.launches, f.tensor_core_launches)
    x, w, b = _rnd(9, 64, dtype=torch.bfloat16), \
        _rnd(64, 24, dtype=torch.bfloat16), _rnd(24, dtype=torch.bfloat16)
    for _ in range(3):
        out = ops._dense_mish_cuda(x, w, b, False, request_)
    assert out.shape == (9, 24) and out.dtype == torch.bfloat16
    assert (f.launches - before[0], f.tensor_core_launches - before[1]) \
        == (3, 3 * tensor_core)
    query = stand.launches("vtd_dense_mish_plan")
    assert len(query) == 1
    block = ops.DenseMishArgs.from_address(query[0][0])
    assert (block.dtype, block.m, block.n, block.k, block.apply_mish,
            block.request, block.aligned16, block.instance) == (
                1, 9, 24, 64, 0, request_, 1, instance)
    assert all(args[0] == query[0][0]
               for args in stand.launches("vtd_dense_mish"))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("instance,tensor_core", [(0, 0), (1, 1), (2, 1)])
def test_int8_counts_the_planned_instance_on_its_route(stand, fused,
                                                       instance, tensor_core):
    stand.instance["vtd_int8_dense_plan"] = instance
    route, other = ((qz.fused_int8_dense, qz.int8_dense) if fused
                    else (qz.int8_dense, qz.fused_int8_dense))
    before = [(r.launches, r.tensor_core_launches) for r in (route, other)]
    x, codes = _rnd(9, 64, dtype=torch.bfloat16), _codes(64, 24)
    for _ in range(2):
        out = _int8(x, codes, fused=fused)
    assert out.dtype == (torch.bfloat16 if fused else torch.float32)
    assert out.shape == (9, 24)
    moved = [(r.launches - a, r.tensor_core_launches - b)
             for r, (a, b) in zip((route, other), before)]
    assert moved == [(2, 2 * tensor_core), (0, 0)]
    block = ops.Int8DenseArgs.from_address(
        stand.launches("vtd_int8_dense")[-1][0])
    assert (block.x_dtype, block.out_dtype, block.m, block.n, block.k,
            block.aligned16, block.instance) == (1, 1 if fused else 0, 9,
                                                 24, 64, 1, instance)


def test_int8_routes_keep_plans_apart(stand):
    """The fused (bf16 out) and fp32-out routes of one signature are two
    plans, each with its output dtype in its block."""
    x, codes = _rnd(9, 64, dtype=torch.bfloat16), _codes(64, 24)
    _int8(x, codes, fused=True)
    _int8(x, codes, fused=False)
    assert len(ops._int8_plans) == 2
    assert [ops.Int8DenseArgs.from_address(a[0]).out_dtype
            for a in stand.launches("vtd_int8_dense")] == [1, 0]


@pytest.mark.parametrize("case", ["x_off", "codes_off", "no_codes"])
def test_int8_alignment_enters_the_block(stand, case):
    """x off a 16-byte boundary, the (N, K) codes off one, or no codes at
    all (the guarded instance): each gets its own plan whose block tells
    the query that the tensor-core instances cannot read the operands."""
    x, codes = _rnd(9, 64, dtype=torch.bfloat16), _codes(64, 32)
    _int8(x, codes)
    if case == "x_off":
        _int8(_offset((9, 64), torch.bfloat16, 1), codes)
    elif case == "codes_off":
        t = torch.empty(32 * 64 + 1, dtype=torch.int8)[1:].view(32, 64)
        t.copy_(codes.t())
        _int8(x, codes, transposed=t)
    else:
        _int8(x, codes, transposed=None)
    assert len(ops._int8_plans) == 2
    first, second = (ops.Int8DenseArgs.from_address(args[0])
                     for args in stand.launches("vtd_int8_dense_plan"))
    assert (first.aligned16, second.aligned16) == (1, 0)
    if case == "no_codes":
        assert stand.launches("vtd_int8_dense")[-1][3] is None


def test_dense_mish_alignment_enters_the_block(stand):
    w, b = _rnd(64, 24), _rnd(24)
    ops._dense_mish_cuda(_rnd(9, 64), w, b, True, 0)
    ops._dense_mish_cuda(_offset((9, 64), torch.float32, 1), w, b, True, 0)
    assert len(ops._ffn_plans) == 2
    assert [ops.DenseMishArgs.from_address(args[0]).aligned16
            for args in stand.launches("vtd_dense_mish_plan")] == [1, 0]


def test_non_contiguous_operands_are_copied(stand):
    """dense_mish copies strided x, w and b; the int8 routes copy a strided
    x and codes, a strided (N, K) copy, and scale and bias that are not
    contiguous fp32; the kernels read the copies."""
    x = _rnd(9, 128)[:, ::2]
    w = _rnd(24, 64).t()
    b = _rnd(48)[::2]
    ops._dense_mish_cuda(x, w, b, True, 0)
    plan = next(iter(ops._ffn_plans.values()))
    assert plan.copies == (True, True, True)
    xp, wp, bp = stand.launches("vtd_dense_mish")[-1][1:4]
    assert (xp, wp, bp) != (x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert plan.args.aligned16 == 1

    codes = _codes(64, 24)
    xq = _rnd(9, 128, dtype=torch.bfloat16)[:, ::2]
    _int8(xq, _codes(24, 64).t(), transposed=_codes(64, 48).t()[:, ::2],
          scale=_rnd(24, dtype=torch.bfloat16).abs(),
          bias=_rnd(48)[::2])
    plan = next(iter(ops._int8_plans.values()))
    assert plan.copies == (True, True, True, True, True)
    _int8(_rnd(9, 64, dtype=torch.bfloat16), codes)
    assert next(reversed(ops._int8_plans.values())).copies == (
        False, False, False, False, False)


def test_int8_bias_in_block_shape_is_read_in_place(stand):
    """The fp32-out route's bias comes in its block shape (H, K): read in
    place when it is contiguous fp32, as one (N,) row."""
    bias = _rnd(4, 6)
    _int8(_rnd(9, 64, dtype=torch.bfloat16), _codes(64, 24), bias=bias,
          fused=False)
    assert stand.launches("vtd_int8_dense")[-1][5] == bias.data_ptr()


@pytest.mark.parametrize("op", ["dense_mish", "fused_int8_dense",
                                "int8_dense"])
def test_an_empty_batch_launches_nothing(stand, op):
    f = (fused_ffn.fused_dense_mish if op == "dense_mish"
         else getattr(qz, op))
    before = f.launches
    if op == "dense_mish":
        out = ops._dense_mish_cuda(_rnd(0, 64), _rnd(64, 24), _rnd(24), True,
                                   0)
        assert (out.shape, out.dtype) == ((0, 24), torch.float32)
    else:
        out = _int8(_rnd(0, 64, dtype=torch.bfloat16), _codes(64, 24),
                    fused=op == "fused_int8_dense")
        assert out.shape == (0, 24)
    assert not stand.calls and f.launches == before


def test_counts_move_once_per_call(stand):
    """Each call adds one to its wrapper's launch counter and nothing to
    the others'."""
    before = {(id(fn), name): getattr(fn, name) for fn, name in COUNTERS}
    for op in ("layer_norm", "layer_norm", "dense_mish", "fused_int8_dense",
               "int8_dense", "int8_dense", "dropout"):
        _call(op)
    moved = {(fn.__name__, name): getattr(fn, name) - before[(id(fn), name)]
             for fn, name in COUNTERS}
    assert moved == {("fused_layer_norm", "launches"): 2,
                     ("fused_dense_mish", "launches"): 1,
                     ("fused_dense_mish", "tensor_core_launches"): 1,
                     ("fused_int8_dense", "launches"): 1,
                     ("fused_int8_dense", "tensor_core_launches"): 1,
                     ("int8_dense", "launches"): 2,
                     ("int8_dense", "tensor_core_launches"): 2,
                     ("dropout", "launches"): 1}


@pytest.mark.parametrize("seed,message", [
    (None, "dropout needs a one-element uint32 seed tensor on cpu, got "
           "None"),
    (torch.zeros(2, dtype=torch.uint32),
     "dropout needs a one-element uint32 seed tensor on cpu, got (2,) "
     "torch.uint32 on cpu"),
    (torch.zeros(1, dtype=torch.int64),
     "dropout needs a one-element uint32 seed tensor on cpu, got (1,) "
     "torch.int64 on cpu")])
def test_dropout_seed_check_raises_its_text(stand, seed, message):
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        ops.dropout_plan(_rnd(9, 40), seed, 0.1, (0, 1, 1, 0, 0))
    if seed is not None:
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            ops._dropout_cuda(_rnd(9, 40), seed, 0.1)
    assert not stand.calls and not ops._drop_plans


@pytest.mark.parametrize("fail,op,what", [
    ("vtd_dense_mish_plan", "dense_mish", "dense + mish"),
    ("vtd_int8_dense_plan", "int8_dense", "int8 dense"),
    ("vtd_layer_norm", "layer_norm", "layer norm"),
    ("vtd_dense_mish", "dense_mish", "dense + mish"),
    ("vtd_int8_dense", "fused_int8_dense", "int8 dense"),
    ("vtd_dropout", "dropout", "dropout")])
def test_a_refused_query_or_launch_raises_its_text(stand, fail, op, what):
    """A plan query that refuses the request raises before anything is
    cached or counted; a launch that fails raises uncounted, each with the
    text the launch's error gave before."""
    stand.fail = fail
    counters = {(id(fn), name): getattr(fn, name) for fn, name in COUNTERS}
    with pytest.raises(RuntimeError, match=re.escape(
            f"{what} kernel launch failed: invalid argument (cudaError 1)")):
        _call(op)
    assert counters == {(id(fn), name): getattr(fn, name)
                        for fn, name in COUNTERS}
    if fail.endswith("_plan"):
        assert not getattr(ops, ENTRY[op][1])


def test_the_plan_caches_stay_bounded(stand):
    """Past PLAN_CACHE_SIZE signatures a cache is emptied and refilled:
    never larger, and every call still launches with its own block."""
    x, seed = _rnd(3, 16), _seed()
    for base in range(ops.PLAN_CACHE_SIZE + 40):
        ops._dropout_cuda(x, seed, 0.1, base)
        assert len(ops._drop_plans) <= ops.PLAN_CACHE_SIZE
        block = ops.DropoutArgs.from_address(stand.calls[-1][1][0])
        assert block.row_base == base
    assert len(ops._drop_plans) == 40


def test_wrappers_launch_through_the_plans(stand, monkeypatch):
    """The public wrappers reach their operators' CUDA implementations
    (the dispatcher has no CPU kernel, so the bound overloads are pointed
    at them directly): one plan and one launch each."""
    monkeypatch.setattr(fused_ln, "_OP", ops._layer_norm_cuda)
    monkeypatch.setattr(fused_ffn, "_OP", ops._dense_mish_cuda)
    monkeypatch.setattr(qz, "_FUSED_OP", ops._fused_int8_dense_cuda)
    monkeypatch.setattr(qz, "_INT8_OP", ops._int8_dense_cuda)
    monkeypatch.setattr(drop, "_OP", ops._dropout_cuda)
    x = _rnd(2, 5, 128)
    out = fused_ln._launch(x, _rnd(128), _rnd(128), 1e-3)
    assert out.shape == x.shape
    out = fused_ffn._launch(x.reshape(-1, 128), _rnd(128, 24), _rnd(24),
                            True, "guarded")
    assert out.shape == (10, 24)
    layer = qz.QuantDense(128, (4, 6))
    out = qz._launch(x.reshape(-1, 128), layer, False, torch.float32,
                     qz.int8_dense)
    assert out.shape == (10, 24)
    out = qz._launch(x.reshape(-1, 128).bfloat16(), layer, True,
                     torch.bfloat16, qz.fused_int8_dense, "guarded")
    assert out.dtype == torch.bfloat16
    out = drop._launch(x, _seed(), 0.1, 0, 1, 1, 0, 64)
    assert out.shape == x.shape
    assert [name for name, _ in stand.calls] == [
        "vtd_layer_norm", "vtd_dense_mish_plan", "vtd_dense_mish",
        "vtd_int8_dense_plan", "vtd_int8_dense", "vtd_int8_dense_plan",
        "vtd_int8_dense", "vtd_dropout"]
    blocks = [ops.DenseMishArgs.from_address(stand.calls[1][1][0]),
              ops.Int8DenseArgs.from_address(stand.calls[5][1][0])]
    assert [b.request for b in blocks] == [fused_ffn.REQUESTS["guarded"],
                                           qz.REQUESTS["guarded"]]
    assert stand.calls[6][1][3] is None    # no (N, K) codes for "guarded"
