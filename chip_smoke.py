#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port (vision_transformer_detector_tpu_torch) through its main
paths, serving the ViT-B/16 384px detector over HTTP (bf16, int8 with the
fused LayerNorm, and the fused dense+mish with the fused LayerNorm),
training the reference_608 detector, and training highres_1024 with
attention dropout, and checks each hand-written kernel on those paths
against its plain PyTorch version. Phases, one output line each:

  1. build        — compile every kernel source of the paths from csrc/
                    with nvcc, all at once; ptxas lines of each, and the
                    tensor-core instructions in the SASS (cuobjdump): HMMA
                    of each flash template instance, > 0 in both flash
                    libraries and in every bf16 instance; IGMMA / IMMA of
                    the int8 dense's tensor-core kernel and HGMMA / HMMA
                    of the dense+mish's wgmma and mma.sync kernels, > 0;
  2. kernel       — flash attention forward against reference_attention
                    on the card, in bf16 and fp32: the serving shape
                    (B*H, N, K) = (12, 576, 64), (96, 576, 64), and the
                    ragged (8, 1296, 40) that the wrapper pads to K = 48;
                    times both at (B*12, 576, 64) bf16 for B = 1 and 64,
                    beside one scaled_dot_product_attention call;
  3. kernel_train — the forward's logsumexp against
                    reference_attention_lse, the backward kernel's dq/dk/dv
                    against reference_attention_backward, and the autograd
                    Function's grads against autograd through
                    reference_attention: (64, 1296, 40) fp32 tokens-major
                    (reference_608 at batch 8), (12, 576, 64) bf16 and fp32
                    heads-major, and a ragged N; times forward-with-lse,
                    backward and forward+backward, kernel against plain, at
                    the reference_608 shape, beside scaled_dot_product_
                    attention forward and backward;
  3b. kernel_drop — the forward with in-kernel dropout (rate 0.1, a seed
                    near 2^32) and lse, and the backward with the mask
                    replayed, against the plain versions with the same
                    mask, and the Function against autograd: (2048, 256,
                    64) bf16 (highres_1024 at batch 8, heads-major as the
                    model folds its windows), (64, 1296, 40) fp32
                    tokens-major and a ragged N; the kernel's mask read
                    back exactly (q = k = 0, v one-hot) for 2,048
                    batch*heads; times in turns against the plain versions
                    and scaled_dot_product_attention with dropout_p, and
                    highres_1024 as shipped (forward with lse and backward,
                    no dropout) against both without dropout;
  4. kernel_serve — the int8 dense kernel (both routes), the LayerNorm
                    kernel and the dense+mish kernel against their plain
                    versions at the vit_b16_384 shapes for batch 1 and 32,
                    with ragged edges and the tile edges (M, N in {1, 17,
                    63, 64, 65, 127, 129}, K in {28, 40, 512, 576, 1536}),
                    every instance of each kernel, and every vit_b16_384
                    shape on a tensor-core instance; times in turns with
                    the plain version, for the LayerNorm F.layer_norm, and
                    for the dense kernels the bf16 torch.addmm (+ mish in
                    fp32) that the bf16 service runs per layer;
  5. model        — vit_b16_384 in fp32 on one seeded image: the kernel
                    path on the card against the plain path on the CPU;
  6. model_serve  — vit_b16_384 (bf16) on one seeded image, card against
                    the CPU plain path from identical weights: (a) int8
                    with the fused LayerNorm, (b) the fused dense+mish
                    with the fused LayerNorm;
  7. serve        — vit_b16_384 in bf16 with seeded random weights behind
                    DetectionServer on port 0: POSTs seeded JPEGs, checks
                    the answers and GET /stats, and that the flash kernel
                    ran 12 times (once per encoder block) per request;
  8. serve_int8   — the `serve --int8` service with the fused LayerNorm
                    behind DetectionServer: per request 30 fused int8
                    dense, 48 int8_dense-route, 24 LayerNorm and 12 flash
                    launches, all 78 dense ones on tensor-core instances;
                    batch-1 and batch-32 device-path times beside the bf16
                    service's, the batch-32 one below it;
  9. serve_fused_ffn — the `--fused-ffn` service with the fused
                    LayerNorm, device path: per call 27 dense+mish (all on
                    tensor-core instances), 24 LayerNorm and 12 flash
                    launches; the same two times, batch 32 below bf16's;
 10. train        — reference_608 in fp32 at full width with seeded
                    weights and synthetic data: (a) one step's loss and
                    gradients on the card against the CPU plain path at
                    batch 2; (b) 20 steps at batch 8 through Trainer.fit
                    with an eval at the end: the loss falls, the metric is
                    in [0, 1]; (c) the forward-with-lse and backward
                    kernels launch 8 times per step and 0 times in eval;
                    (d) save, restore, and the next step's loss is
                    identical; (e) the median step time;
 11. train_highres — highres_1024 (1024 px, 16 windows of 256 tokens,
                    D 1024, 24 blocks, the (1, 2, 4) multi-scale head)
                    with dropout 0.1 and remat None: (a) one fp32 step at
                    batch 1 and depth 2, card against CPU, dropout off;
                    (b) depth 2, fp32, dropout on: remat None against no
                    remat from one seed; (c) 8 steps at batch 8 through
                    Trainer.fit in bf16 at full depth, with an eval: the
                    loss falls, 48 dropout forward and 24 replay backward
                    launches per step, 24 plain forward launches in the
                    eval; (d) save, restore, the next step's loss is
                    identical (the dropout seed generator is restored);
                    (e) the median step time and peak memory; (f) one step
                    as shipped ("alternate" remat, no dropout): 36
                    forward-with-lse and 24 backward launches.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with each kernel's shape, launches, error, times (its own, its plain
version's and, where one PyTorch call computes the same function, that
call's) and its bound with the peak rate it uses, and as the last line
{"ok": true, "device": {...}}. Any failed check ends the run with a
non-zero exit and no result line; so does a host without a CUDA device, or
a directory without the port's sources. A kernel that does not build or launch raises; nothing
falls back to a plain version. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

REQUESTS = 4            # HTTP requests in the serving phases
TRAIN_STEPS = 20        # Trainer.fit epochs (one batch each) in `train`
SEED = 0
CSRC = "vision_transformer_detector_tpu_torch/csrc/"
TPU_KERNELS = "vision_transformer_detector_tpu/kernels/"

# One H100 SXM (NVIDIA's data sheet, dense rates): the bound of a kernel
# is the larger of its operations over the peak for their type and its
# bytes (each input read once, each output written once) over HBM's rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
                  "fp32": 67e12}
# The fp32 flash kernels multiply on the TF32 tensor cores as 3xTF32: three
# TF32 products per fp32 product, so their bound is 3x the operations at
# the TF32 rate (about 165 TFLOP/s of fp32 work).
TF32_PRODUCTS = 3


def _report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def _time_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(runs: dict, iters: int) -> dict:
    """Mean ms of each run, timed in turns (a, b, b, a) and averaged."""
    names = list(runs)
    order = names + names[::-1]
    sums = {name: 0.0 for name in names}
    for name in order:
        sums[name] += _time_ms(runs[name], iters) / 2
    return sums


def _bound(ops: float, nbytes: float, kind: str):
    """(bound_ms, bound_by) of work of ``ops`` operations of type ``kind``
    on ``nbytes`` bytes of device memory; kind "3xtf32" is fp32 work done as
    three TF32 products."""
    if kind == "3xtf32":
        ops, kind = ops * TF32_PRODUCTS, "tf32"
    t_ops = ops / PEAK_OPS_PER_S[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa(q, k, v, backend, dropout_p=0.0):
    """One scaled_dot_product_attention call on (B, H, N, K) inputs that
    carry their 1/sqrt(K) already, on the given backend: the library
    yardstick for the flash kernels (the port never calls it)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel([backend]):
        return F.scaled_dot_product_attention(q, k, v, scale=1.0,
                                              dropout_p=dropout_p)


def _sdpa_backend(run):
    """The first scaled_dot_product_attention backend, fastest first, for
    which ``run(backend)`` works."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings():
                # A refused backend warns why before it raises.
                warnings.simplefilter("ignore", UserWarning)
                run(backend)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no scaled_dot_product_attention backend ran")


def phase_build():
    from vision_transformer_detector_tpu_torch.kernels import _build
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, fused_ffn, fused_ln, quantization)

    sources = [fa.FWD_SOURCE, fa.BWD_SOURCE, quantization.SOURCE,
               fused_ln.SOURCE, fused_ffn.SOURCE]
    tic = time.monotonic()
    _build.load_libraries(sources)
    seconds = round(time.monotonic() - tic, 3)
    ptxas = {source: [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line]
             for source, log in _build.BUILD_LOGS.items()}
    _require(set(ptxas) == set(sources), f"built {sorted(ptxas)}")
    hmma = {source: _tensor_core_instructions(_build.library_path(source))
            for source in (fa.FWD_SOURCE, fa.BWD_SOURCE)}
    for source, counts in hmma.items():
        _require(len(counts) == 8 and sum(counts.values()) > 0,
                 f"{source}: tensor-core instructions {counts}")
        _require(all(n > 0 for name, n in counts.items()
                     if name.startswith("bf16")),
                 f"{source}: a bf16 instance without HMMA: {counts}")
    # The rebuilt dense kernels: wgmma (IGMMA, HGMMA) and mma.sync (HMMA).
    dense = {
        quantization.SOURCE: _kernel_instructions(
            _build.library_path(quantization.SOURCE), r"I(G)?MMA"),
        fused_ffn.SOURCE: _kernel_instructions(
            _build.library_path(fused_ffn.SOURCE), r"H(G)?MMA")}
    for source, kernels in (
            (quantization.SOURCE, ("int8_dense_wgmma_kernel",)),
            (fused_ffn.SOURCE, ("dense_mish_wgmma_kernel",
                                "dense_mish_mma_kernel"))):
        for kernel in kernels:
            _require(dense[source].get(kernel, 0) > 0,
                     f"{source}: no tensor-core instruction in {kernel}: "
                     f"{dense[source]}")
    hmma.update(dense)
    _report("build", seconds=seconds, ptxas=ptxas,
            tensor_core_instructions=hmma)


def _tensor_core_instructions(library: str) -> dict:
    """HMMA/HGMMA lines of each flash kernel instance in the library's
    SASS (cuobjdump from nvcc's toolkit), by "<type>_d<head dim>[_drop]"."""
    from vision_transformer_detector_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : \S*flash_(?:fwd|bwd)_kernelI"
                          r"(13__nv_bfloat16|f)Li(\d+)ELb([01])E", line)
        if found:
            dtype, dim, drop = found.groups()
            name = (f"{'fp32' if dtype == 'f' else 'bf16'}_d{dim}"
                    f"{'_drop' if drop == '1' else ''}")
            counts[name] = 0
        elif "Function :" in line:
            name = None
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


def _kernel_instructions(library: str, mnemonic: str) -> dict:
    """SASS lines matching ``mnemonic`` in the library, summed over the
    template instances of each ``*_kernel`` function."""
    from vision_transformer_detector_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(
                r"\d\d((?:int8_dense|dense_mish)[a-z_]*_kernel)I", line)
            name = found.group(1) if found else None
            if name:
                counts.setdefault(name, 0)
        elif name and re.search(rf"\b{mnemonic}\b", line):
            counts[name] += 1
    return counts


def phase_kernel():
    import torch

    from vision_transformer_detector_tpu_torch.kernels.flash_attention import (
        flash_attention, reference_attention)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(b, h, n, k, dtype):
        """Heads-major (b, h, n, k) views of tokens-major memory, as the
        model hands them to the wrapper."""
        q, key, v = (torch.randn(b, n, h, k, device="cuda", generator=gen)
                     for _ in range(3))
        # The caller's 1/sqrt(K) scale, as the model applies it.
        return (q.mul(k ** -0.5).to(dtype).transpose(1, 2),
                key.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2))

    # bf16: the kernel and the plain version round p to bf16 at different
    # running maxima and sum in other orders; 2e-2 is the JAX package's
    # bf16 contract (kernels/flash_attention.py). fp32: summation order
    # only.
    tolerances = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    errors = {}
    # The serving shape itself, then (B*H, N, K) = (96, 576, 64) and the
    # ragged (8, 1296, 40) that the wrapper pads to K = 48.
    for (b, h, n, k) in ((1, 12, 576, 64), (8, 12, 576, 64),
                         (1, 8, 1296, 40)):
        for dtype, tol in tolerances.items():
            q, key, v = qkv(b, h, n, k, dtype)
            out = flash_attention(q, key, v, layout="bhnk")
            torch.cuda.synchronize()
            ref = reference_attention(q, key, v, layout="bhnk")
            _require(out.shape == ref.shape and out.dtype == dtype,
                     f"flash output {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            name = f"{b * h}x{n}x{k}_{str(dtype).split('.')[-1]}"
            errors[name] = err
            _require(err <= tol, f"flash {name}: max abs err {err} > {tol}")

    times, backends = {}, {}
    for batch in (1, 64):
        q, key, v = qkv(batch, 12, 576, 64, torch.bfloat16)
        backend = _sdpa_backend(lambda b: _sdpa(q, key, v, b))
        backends[batch] = backend.name
        lib_err = (_sdpa(q, key, v, backend).float() - reference_attention(
            q, key, v, layout="bhnk").float()).abs().max().item()
        _require(lib_err <= tolerances[torch.bfloat16],
                 f"scaled_dot_product_attention differs by {lib_err}")
        times[batch] = _in_turns({
            "plain_ms": lambda: reference_attention(q, key, v,
                                                    layout="bhnk"),
            "kernel_ms": lambda: flash_attention(q, key, v, layout="bhnk"),
            "library_ms": lambda: _sdpa(q, key, v, backend),
        }, 50)
    _report("kernel", max_abs_err=errors,
            times_bf16_576x64={f"B={b}": t for b, t in times.items()},
            sdpa_backend={f"B={b}": name for b, name in backends.items()})
    return errors["12x576x64_bfloat16"], times


def _rel_err(got, ref) -> float:
    """Max abs error relative to the reference's max abs value."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1e-30)).item()


def _grad_errors(got: dict, ref: dict, tol: float, what: str) -> tuple:
    """Max error of each gradient relative to its reference's largest
    value; the attention key bias (zero in exact arithmetic: the softmax
    cancels it) is held to the largest gradient instead. Returns (worst
    name, worst error)."""
    import torch

    global_max = max(g.abs().max().item() for g in ref.values())
    errs = {}
    for name, want in ref.items():
        have = got[name]
        _require(bool(torch.isfinite(have).all()),
                 f"{what}: non-finite grad {name}")
        if name.endswith("mha.key.bias"):
            errs[name] = (have - want).abs().max().item() / global_max
        else:
            errs[name] = _rel_err(have, want)
        _require(errs[name] <= tol,
                 f"{what}: grad {name} rel err {errs[name]} > {tol}")
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def phase_kernel_train():
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(layout, shape, dtype):
        """Scaled q, k, v and a cotangent g; heads-major shapes are views
        of tokens-major memory, as the model hands them over."""
        k_dim = shape[-1]
        if layout == "bhnk":
            b, h, n, _ = shape
            shape = (b, n, h, k_dim)
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      for _ in range(4))
        q = q.mul(k_dim ** -0.5)
        out = [t.to(dtype) for t in (q, k, v, g)]
        return [t.transpose(1, 2) for t in out] if layout == "bhnk" else out

    # lse: fp32 on both sides from the same inputs; summation order only.
    # Grads, relative to the largest: fp32 2e-5 (summation order, and dq's
    # atomic adds in run-dependent order); bf16 2e-2 (p and ds round to
    # bf16 at other points), the JAX package's kernel contract.
    grad_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    lse_tol = 1e-4
    cases = (("bnhk", (8, 1296, 8, 40), torch.float32),   # reference_608 b8
             ("bhnk", (1, 12, 576, 64), torch.bfloat16),
             ("bhnk", (1, 12, 576, 64), torch.float32),
             ("bnhk", (3, 77, 4, 40), torch.bfloat16),    # ragged N
             ("bnhk", (3, 77, 4, 40), torch.float32))
    errors = {}
    for layout, shape, dtype in cases:
        name = (f"{shape[0] * (shape[2] if layout == 'bnhk' else shape[1])}"
                f"x{shape[1] if layout == 'bnhk' else shape[2]}"
                f"x{shape[3]}_{str(dtype).split('.')[-1]}_{layout}")
        q, k, v, g = inputs(layout, shape, dtype)
        out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True)
        delta = fa._heads_major((g.float() * out.float()).sum(-1),
                                layout).contiguous()
        grads = fa._launch_backward(q, k, v, g, lse, delta, layout)
        torch.cuda.synchronize()
        lse_err = (lse - fa.reference_attention_lse(q, k, layout)
                   ).abs().max().item()
        _require(lse_err <= lse_tol, f"lse {name}: {lse_err} > {lse_tol}")
        plain = fa.reference_attention_backward(q, k, v, g, layout)
        abs_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(grads, plain))
        bwd_err = max(_rel_err(a, b) for a, b in zip(grads, plain))
        _require(all(a.shape == b.shape and a.dtype == b.dtype
                     for a, b in zip(grads, plain)), f"grad shapes {name}")
        _require(bwd_err <= grad_tol[dtype],
                 f"backward {name}: rel err {bwd_err} > {grad_tol[dtype]}")
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = fa.flash_attention.backward_launches
        fn_out = fa.flash_attention(*leaves, layout=layout)
        _require(fn_out.grad_fn is not None, "kernel route lost grad_fn")
        fn_grads = torch.autograd.grad(fn_out, leaves, g)
        _require(fa.flash_attention.backward_launches == before + 1,
                 "the Function's backward did not launch the kernel")
        auto = torch.autograd.grad(
            fa.reference_attention(*leaves, layout=layout), leaves, g)
        fn_err = max(_rel_err(a, b) for a, b in zip(fn_grads, auto))
        _require(fn_err <= grad_tol[dtype],
                 f"Function {name}: rel err {fn_err} > {grad_tol[dtype]}")
        errors[name] = {"lse_abs": lse_err, "bwd_rel": bwd_err,
                        "bwd_abs": abs_err, "function_vs_autograd_rel":
                        fn_err}

    # Times at the reference_608 batch-8 shape, kernel against plain.
    q, k, v, g = inputs("bnhk", (8, 1296, 8, 40), torch.float32)
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            "bnhk").contiguous()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def step(use_kernel):
        o = fa.FlashAttentionFunction.apply(*leaves, "bnhk", use_kernel)
        torch.autograd.grad(o, leaves, g)

    # The library yardstick: scaled_dot_product_attention on heads-major
    # views, forward, backward alone (retain_graph) and both.
    heads = [fa._heads_major(t, "bnhk") for t in (q, k, v, g)]
    lib_leaves = [t.detach().clone().requires_grad_() for t in heads[:3]]

    def lib_step(backend):
        out = _sdpa(*lib_leaves, backend)
        torch.autograd.grad(out, lib_leaves, heads[3])
        return out

    backend = _sdpa_backend(lib_step)
    lib_out = _sdpa(*lib_leaves, backend)
    lib_err = (lib_out.detach() - fa._heads_major(
        fa.reference_attention(q, k, v), "bnhk")).abs().max().item()
    _require(lib_err <= 1e-4,
             f"scaled_dot_product_attention differs by {lib_err}")
    times = {
        "fwd_lse": _in_turns({
            "plain_ms": lambda: (fa.reference_attention(q, k, v),
                                 fa.reference_attention_lse(q, k)),
            "kernel_ms": lambda: fa.flash_attention(q, k, v,
                                                    with_lse=True),
            "library_ms": lambda: _sdpa(*heads[:3], backend)}, 10),
        "bwd": _in_turns({
            "plain_ms": lambda: fa.reference_attention_backward(q, k, v, g),
            "kernel_ms": lambda: fa._launch_backward(q, k, v, g, lse, delta,
                                                     "bnhk"),
            "library_ms": lambda: torch.autograd.grad(
                lib_out, lib_leaves, heads[3], retain_graph=True)}, 10),
        "fwd_bwd": _in_turns({"plain_ms": lambda: step(False),
                              "kernel_ms": lambda: step(True),
                              "library_ms": lambda: lib_step(backend)}, 5),
    }
    _report("kernel_train", errors=errors,
            times_fp32_64x1296x40=times, sdpa_backend=backend.name)
    ref = errors["64x1296x40_float32_bnhk"]
    return ref, times


DROP_RATE = 0.1          # highres_1024's documented training dropout
DROP_SEED = 2 ** 32 - 5  # a seed near 2^32: the hash's sums wrap


def phase_kernel_drop():
    """B1-drop (the forward with in-kernel dropout and lse) and B2 with
    the dropout replay against their plain versions; the kernel's mask
    read back exactly; times against the plain versions and SDPA with
    dropout_p."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    drop = (DROP_SEED, DROP_RATE)
    kw = {"dropout_rate": DROP_RATE, "dropout_seed": DROP_SEED}

    def inputs(layout, shape, dtype):
        """Scaled q, k, v and a cotangent g in ``layout`` order, contiguous
        (the model's heads-major window fold is a contiguous copy)."""
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      for _ in range(4))
        return [t.to(dtype) for t in (q.mul(shape[-1] ** -0.5), k, v, g)]

    # Tolerances as in kernel_train: out and grads relative to the largest
    # value, fp32 2e-5 (summation order, dq's atomics), bf16 2e-2 (p and
    # ds round to bf16 at other points); lse fp32 1e-4 absolute.
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    lse_tol = 1e-4
    cases = (("bhnk", (8, 256, 256, 64), torch.bfloat16),   # highres b8
             ("bnhk", (8, 1296, 8, 40), torch.float32),     # tokens-major
             ("bnhk", (3, 77, 4, 40), torch.bfloat16))      # ragged N
    errors = {}
    for layout, shape, dtype in cases:
        b, h, n = ((shape[0], shape[1], shape[2]) if layout == "bhnk"
                   else (shape[0], shape[2], shape[1]))
        name = f"{b * h}x{n}x{shape[3]}_{str(dtype)[6:]}_{layout}"
        q, k, v, g = inputs(layout, shape, dtype)
        out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True,
                                      **kw)
        delta = fa._heads_major((g.float() * out.float()).sum(-1),
                                layout).contiguous()
        grads = fa._launch_backward(q, k, v, g, lse, delta, layout, drop)
        torch.cuda.synchronize()
        ref = fa.reference_attention(q, k, v, layout, drop)
        out_err, out_abs = _rel_err(out, ref), _max_err(out, ref)
        lse_err = (lse - fa.reference_attention_lse(q, k, layout)
                   ).abs().max().item()
        plain = fa.reference_attention_backward(q, k, v, g, layout, drop)
        bwd_err = max(_rel_err(a, r) for a, r in zip(grads, plain))
        bwd_abs = max(_max_err(a, r) for a, r in zip(grads, plain))
        _require(out_err <= tol[dtype], f"B1-drop {name}: out {out_err}")
        _require(lse_err <= lse_tol, f"B1-drop {name}: lse {lse_err}")
        _require(all(a.shape == r.shape and a.dtype == r.dtype
                     for a, r in zip(grads, plain)), f"grad shapes {name}")
        _require(bwd_err <= tol[dtype], f"B2-drop {name}: grads {bwd_err}")
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        counts = (fa.flash_attention.drop_launches,
                  fa.flash_attention.backward_drop_launches)
        fn_grads = torch.autograd.grad(
            fa.flash_attention(*leaves, layout=layout, **kw), leaves, g)
        _require((fa.flash_attention.drop_launches,
                  fa.flash_attention.backward_drop_launches)
                 == (counts[0] + 1, counts[1] + 1),
                 "the Function did not launch the dropout kernels")
        auto = torch.autograd.grad(
            fa.reference_attention(*leaves, layout=layout, dropout=drop),
            leaves, g)
        fn_err = max(_rel_err(a, r) for a, r in zip(fn_grads, auto))
        _require(fn_err <= tol[dtype], f"Function {name}: {fn_err}")
        errors[name] = {"out_rel": out_err, "out_abs": out_abs,
                        "lse_abs": lse_err,
                        "bwd_rel": bwd_err, "bwd_abs": bwd_abs,
                        "function_vs_autograd_rel": fn_err}
        del q, k, v, g, out, ref, lse, delta, grads, plain, leaves
        del fn_grads, auto

    # The kernel's mask, read back exactly: q = k = 0 gives p = 1 for every
    # key, so with v one-hot on one 64-key slice, out * N / inv_keep is
    # the mask of those keys (fp32: inv_keep / N * N / inv_keep == 1).
    bh, n = 2048, 256
    zeros = torch.zeros(1, bh, n, 64, device="cuda")
    inv_keep = torch.tensor(1.0 / (1.0 - DROP_RATE), dtype=torch.float32)
    pos = torch.arange(n, device="cuda")
    want = fa.dropout_keep_mask(
        DROP_SEED, torch.arange(bh, device="cuda")[:, None, None],
        pos[:, None], pos[None, :], fa._keep_threshold(DROP_RATE))
    mismatches = 0
    for slice0 in range(0, n, 64):
        v = torch.zeros(1, bh, n, 64, device="cuda")
        v[0, :, slice0:slice0 + 64, :] = torch.eye(64, device="cuda")
        out = fa.flash_attention(zeros, zeros, v, layout="bhnk", **kw)
        read = out[0] * n / inv_keep.item()
        _require(bool(((read - read.round()).abs() <= 1e-5).all()),
                 "mask read-back is not 0/1")
        mismatches += int((read.round().bool()
                           != want[:, :, slice0:slice0 + 64]).sum())
    _require(mismatches == 0, f"kernel mask differs in {mismatches} places")
    keep_rate = want.float().mean().item()
    del zeros, want

    # Times at the highres_1024 batch-8 fold, kernel against plain against
    # SDPA with dropout_p (another RNG: the same function in distribution).
    q, k, v, g = inputs("bhnk", (8, 256, 256, 64), torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def step(use_kernel):
        o = fa.FlashAttentionFunction.apply(*leaves, "bhnk", use_kernel,
                                            drop)
        torch.autograd.grad(o, leaves, g)

    lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def lib_step(backend):
        out = _sdpa(*lib_leaves, backend, DROP_RATE)
        torch.autograd.grad(out, lib_leaves, g)

    backend = _sdpa_backend(lib_step)
    times = {
        "fwd_drop": _in_turns({
            "plain_ms": lambda: (fa.reference_attention(q, k, v, "bhnk",
                                                        drop),
                                 fa.reference_attention_lse(q, k, "bhnk")),
            "kernel_ms": lambda: fa.flash_attention(q, k, v, layout="bhnk",
                                                    with_lse=True, **kw),
            "library_ms": lambda: _sdpa(q, k, v, backend, DROP_RATE)}, 5),
        "fwd_bwd_drop": _in_turns({
            "plain_ms": lambda: step(False),
            "kernel_ms": lambda: step(True),
            "library_ms": lambda: lib_step(backend)}, 3),
    }
    out, lse = fa.flash_attention(q, k, v, layout="bhnk", with_lse=True, **kw)
    delta = (g.float() * out.float()).sum(-1)
    lib_out = _sdpa(*lib_leaves, backend, DROP_RATE)
    times["bwd_drop"] = _in_turns({
        "plain_ms": lambda: fa.reference_attention_backward(q, k, v, g,
                                                            "bhnk", drop),
        "kernel_ms": lambda: fa._launch_backward(q, k, v, g, lse, delta,
                                                 "bhnk", drop),
        "library_ms": lambda: torch.autograd.grad(
            lib_out, lib_leaves, g, retain_graph=True)}, 3)
    del lib_out, out, lse, delta

    # highres_1024 as shipped (no dropout: 36 forward-with-lse and 24
    # backward launches per step): errors at the batch-8 fold, and times
    # against the plain versions and SDPA without dropout.
    def lib_grad(backend):
        torch.autograd.grad(_sdpa(*lib_leaves, backend), lib_leaves, g)

    shipped_backend = _sdpa_backend(lib_grad)
    out, lse = fa.flash_attention(q, k, v, layout="bhnk", with_lse=True)
    delta = (g.float() * out.float()).sum(-1)
    grads = fa._launch_backward(q, k, v, g, lse, delta, "bhnk")
    torch.cuda.synchronize()
    ref = fa.reference_attention(q, k, v, "bhnk")
    plain = fa.reference_attention_backward(q, k, v, g, "bhnk")
    shipped = {"out_rel": _rel_err(out, ref), "out_abs": _max_err(out, ref),
               "lse_abs": (lse - fa.reference_attention_lse(q, k, "bhnk"))
               .abs().max().item(),
               "bwd_rel": max(_rel_err(a, r) for a, r in zip(grads, plain)),
               "bwd_abs": max(_max_err(a, r) for a, r in zip(grads, plain))}
    _require(shipped["out_rel"] <= tol[torch.bfloat16]
             and shipped["lse_abs"] <= lse_tol
             and shipped["bwd_rel"] <= tol[torch.bfloat16],
             f"as shipped, 2048x256x64 bf16: {shipped}")
    errors["2048x256x64_bfloat16_bhnk_no_dropout"] = shipped
    del ref, plain, grads
    lib_out = _sdpa(*lib_leaves, shipped_backend)
    times["fwd_lse"] = _in_turns({
        "plain_ms": lambda: (fa.reference_attention(q, k, v, "bhnk"),
                             fa.reference_attention_lse(q, k, "bhnk")),
        "kernel_ms": lambda: fa.flash_attention(q, k, v, layout="bhnk",
                                                with_lse=True),
        "library_ms": lambda: _sdpa(q, k, v, shipped_backend)}, 5)
    times["bwd"] = _in_turns({
        "plain_ms": lambda: fa.reference_attention_backward(q, k, v, g,
                                                            "bhnk"),
        "kernel_ms": lambda: fa._launch_backward(q, k, v, g, lse, delta,
                                                 "bhnk"),
        "library_ms": lambda: torch.autograd.grad(
            lib_out, lib_leaves, g, retain_graph=True)}, 3)
    _report("kernel_drop", rate=DROP_RATE, seed=DROP_SEED, errors=errors,
            mask_readback={"bh": bh, "n": n, "mismatches": mismatches,
                           "keep_rate": keep_rate},
            times_bf16_2048x256x64=times, sdpa_backend=backend.name,
            sdpa_backend_no_dropout=shipped_backend.name)
    return errors["2048x256x64_bfloat16_bhnk"], times


def _quant_layer(gen, k: int, out_shape):
    """A QuantDense on the card with seeded codes, glorot-sized scales
    (|w| <= sqrt(6 / (k + n)), as init_params draws them) and bias."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        QuantDense)

    n = 1
    for dim in out_shape:
        n *= dim
    layer = QuantDense(k, out_shape, device="cuda")
    layer.kernel_q.copy_(torch.randint(-127, 128, (k, n), device="cuda",
                                       generator=gen).to(torch.int8))
    limit = (6.0 / (k + n)) ** 0.5
    layer.scale.copy_((0.5 + 0.5 * torch.rand(n, device="cuda",
                                              generator=gen)) * limit / 127)
    layer.bias.copy_(0.1 * torch.randn(out_shape, device="cuda",
                                       generator=gen))
    return layer


def _max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def phase_kernel_serve():
    """The int8 dense (both routes), LayerNorm and dense+mish kernels
    against their plain versions at the vit_b16_384 shapes."""
    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch.kernels import (
        fused_ffn, fused_ln, quantization as qz)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf16, fp32 = torch.bfloat16, torch.float32
    # Tolerances, relative to the largest reference value. int8: the
    # kernel and the plain version form the same codes and exact int32
    # sums and rescale in the same fp32 order, so they differ only where
    # mish's libm calls or the last rounding differ: one bf16 rounding
    # (2^-7) on the fused route, 1e-6 on the fp32 int8_dense route.
    # LayerNorm: rsqrtf (2 ulp) and the sums' order, 1e-5 in fp32; one
    # bf16 rounding in bf16. dense+mish: fp32 sums over K <= 1536 in
    # another order, 1e-5; one bf16 rounding in bf16.
    one_bf16 = 2.0 ** -7
    errors, worst = {}, {"int8_dense": 0.0, "layer_norm": 0.0,
                         "dense_mish": 0.0}

    def check(kernel, name, got, ref, rel_tol):
        _require(got.shape == ref.shape and got.dtype == ref.dtype,
                 f"{name}: {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(ref.shape)} {ref.dtype}")
        _require(bool(torch.isfinite(got).all()), f"{name}: not finite")
        err = _max_err(got, ref)
        tol = rel_tol * ref.float().abs().max().item()
        _require(err <= tol, f"{name}: max abs err {err} > {tol}")
        errors[name] = err
        worst[kernel] = max(worst[kernel], err)

    def took_tensor_cores(fn, call):
        """call()'s result and whether its one launch took a tensor-core
        instance."""
        before = (fn.launches, fn.tensor_core_launches)
        got = call()
        torch.cuda.synchronize()
        _require(fn.launches == before[0] + 1, f"{fn.__name__}: no launch")
        return got, fn.tensor_core_launches == before[1] + 1

    for batch in (1, 32):
        tokens, slots = 576 * batch, 17 * batch
        # B5, fused route: (rows, K, N, mish) of the encoder MLP, the
        # head's token dense (N = 17), MLP and output (N = 6). Every
        # vit_b16_384 shape has K in whole 16-byte rows: tensor cores.
        for rows, k, n, mish in ((tokens, 768, 1536, True),
                                 (tokens, 1536, 768, True),
                                 (tokens, 768, 768, False),
                                 (tokens, 768, 17, False),
                                 (slots, 576, 2048, True),
                                 (slots, 2048, 1024, True),
                                 (slots, 1024, 512, True),
                                 (slots, 512, 6, False)):
            layer = _quant_layer(gen, k, (n,))
            x = torch.randn(rows, k, device="cuda", generator=gen).to(bf16)
            got, on_tc = took_tensor_cores(
                qz.fused_int8_dense,
                lambda: qz.fused_int8_dense(x, layer, apply_mish=mish))
            _require(on_tc, f"int8 fused {rows}x{k}x{n}: guarded instance")
            ref = qz.int8_dense_reference(x, layer.kernel_q, layer.scale,
                                          layer.bias, mish, bf16)
            check("int8_dense", f"int8_fused_{rows}x{k}x{n}"
                  f"{'_mish' if mish else ''}", got, ref, one_bf16)
        # B5, int8_dense route (fp32 out): the q/k/v projection 768 ->
        # (12, 64) and a ragged M = 17 * B.
        for rows in (tokens, slots):
            layer = _quant_layer(gen, 768, (12, 64))
            x = torch.randn(rows, 768, device="cuda", generator=gen).to(bf16)
            got, on_tc = took_tensor_cores(qz.int8_dense,
                                           lambda: qz.int8_dense(x, layer))
            _require(on_tc, f"int8_dense route {rows}x768: guarded instance")
            ref = qz.int8_dense_reference(
                x, layer.kernel_q, layer.scale,
                layer.bias.reshape(-1)).reshape(rows, 12, 64)
            check("int8_dense", f"int8_dense_route_{rows}x768x12x64", got,
                  ref, 1e-6)
        # B4: the encoder's (tokens, 768) in bf16 and fp32, ragged rows.
        for rows, dtype in ((tokens, bf16), (tokens, fp32), (slots, bf16)):
            x = (3 * torch.randn(rows, 768, device="cuda", generator=gen)
                 + 1).to(dtype)
            gamma = torch.randn(768, device="cuda", generator=gen)
            beta = torch.randn(768, device="cuda", generator=gen)
            got = fused_ln.fused_layer_norm(x, gamma, beta)
            torch.cuda.synchronize()
            ref = fused_ln.layer_norm_reference(x, gamma, beta)
            check("layer_norm", f"ln_{rows}x768_{str(dtype)[6:]}", got, ref,
                  one_bf16 if dtype == bf16 else 1e-5)
        # B3: the encoder MLP and the head's MLP layers with mish (the
        # model's shapes: tensor cores), and ragged N = 17 and N = 6
        # without (rows of w off a 16-byte boundary: the guarded instance).
        for dtype in (bf16, fp32):
            for rows, k, n, mish in ((tokens, 768, 1536, True),
                                     (tokens, 1536, 768, True),
                                     (slots, 576, 2048, True),
                                     (slots, 2048, 1024, True),
                                     (slots, 1024, 512, True),
                                     (slots, 768, 17, False),
                                     (slots, 512, 6, False)):
                x = torch.randn(rows, k, device="cuda", generator=gen)
                w = torch.randn(k, n, device="cuda", generator=gen) * (
                    (6.0 / (k + n)) ** 0.5 / 3 ** 0.5)
                b = 0.1 * torch.randn(n, device="cuda", generator=gen)
                x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
                got, on_tc = took_tensor_cores(
                    fused_ffn.fused_dense_mish,
                    lambda: fused_ffn.fused_dense_mish(x, w, b,
                                                       apply_mish=mish))
                on_shape = fused_ffn.tensor_core_shape(k, n, dtype)
                _require(on_tc == on_shape and (on_shape or not mish),
                         f"dense+mish {rows}x{k}x{n} {dtype}: tensor-core "
                         f"instance {on_tc}")
                ref = fused_ffn.dense_mish_reference(x, w, b, mish)
                check("dense_mish", f"ffn_{rows}x{k}x{n}_{str(dtype)[6:]}"
                      f"{'_mish' if mish else ''}", got, ref,
                      one_bf16 if dtype == bf16 else 1e-5)

    # Tile edges: rows and columns around the 64- and 128-wide tiles, K
    # off and on 16-byte rows, through every instance that takes the shape
    # (None: the one the shape selects). Worst error per instance.
    edges = [(m, k, n) for m in (1, 65, 129) for n in (17, 64, 129)
             for k in (28, 40, 512, 576, 1536)]
    edges += [(m, 512, 64) for m in (1, 17, 63, 64, 65, 127, 129)]
    edges += [(64, 576, n) for n in (1, 17, 63, 64, 65, 127, 129)]
    edge_worst = {}

    def edge(kernel, instance, dtype, got, ref, rel_tol, name):
        check(kernel, name, got, ref, rel_tol)
        key = f"{kernel}_{instance}_{str(dtype)[6:]}"
        edge_worst[key] = max(edge_worst.get(key, 0.0), errors.pop(name))

    for rows, k, n in edges:
        layer = _quant_layer(gen, k, (n,))
        x = torch.randn(rows, k, device="cuda", generator=gen).to(bf16)
        instances = [None, "guarded"] + (
            ["resident", "streamed"] if qz.tensor_core_shape(k) else [])
        for out_dtype, mish, route, tol in (
                (bf16, True, qz.fused_int8_dense, one_bf16),
                (fp32, False, qz.int8_dense, 1e-6)):
            ref = qz.int8_dense_reference(x, layer.kernel_q, layer.scale,
                                          layer.bias, mish, out_dtype)
            for instance in instances:
                got, on_tc = took_tensor_cores(
                    route, lambda: qz._launch(x, layer, mish, out_dtype,
                                              route, instance))
                want = (qz.tensor_core_shape(k) if instance is None
                        else instance != "guarded")
                _require(on_tc == want, f"int8 {rows}x{k}x{n} {instance}: "
                         f"tensor-core instance {on_tc}")
                edge("int8_dense", instance, out_dtype, got, ref, tol,
                     f"int8_edge_{rows}x{k}x{n}_{instance}")
        for dtype, tol in ((bf16, one_bf16), (fp32, 1e-5)):
            xd = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(k, n, device="cuda", generator=gen)
                 * (2.0 / (k + n)) ** 0.5).to(dtype)
            b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
            ref = fused_ffn.dense_mish_reference(xd, w, b, True)
            on_shape = fused_ffn.tensor_core_shape(k, n, dtype)
            instances = [None, "guarded"] + (
                ["mma_sync"] + (["wgmma"] if dtype == bf16 else [])
                if on_shape else [])
            for instance in instances:
                got, on_tc = took_tensor_cores(
                    fused_ffn.fused_dense_mish,
                    lambda: fused_ffn._launch(xd, w, b, True, instance))
                want = on_shape if instance is None else instance != "guarded"
                _require(on_tc == want, f"dense+mish {rows}x{k}x{n} {dtype} "
                         f"{instance}: tensor-core instance {on_tc}")
                edge("dense_mish", instance, dtype, got, ref, tol,
                     f"ffn_edge_{rows}x{k}x{n}_{instance}")

    # Times in turns at the batch-32 headline shapes (and batch 1). Beside
    # each dense kernel the nearest unfused yardstick, which the port never
    # calls on these paths: the bf16 torch.addmm (cuBLAS) and, where the
    # kernel applies mish, mish in fp32 after it, as the bf16 service runs
    # each layer. Two library calls, not one: `unfused_library_ms`.
    def addmm_mish(x, w, b):
        return fused_ffn.mish_f32(torch.addmm(b, x, w).float()).to(x.dtype)

    times = {}
    for batch in (1, 32):
        rows, iters = 576 * batch, (50 if batch == 1 else 10)
        layer = _quant_layer(gen, 768, (1536,))
        x = torch.randn(rows, 768, device="cuda", generator=gen).to(bf16)
        w = (0.05 * torch.randn(768, 1536, device="cuda",
                                generator=gen)).to(bf16)
        b = (0.1 * torch.randn(1536, device="cuda", generator=gen)).to(bf16)
        times[f"int8_dense_B={batch}_{rows}x768x1536_mish"] = _in_turns({
            "plain_ms": lambda: qz.int8_dense_reference(
                x, layer.kernel_q, layer.scale, layer.bias, True, bf16),
            "kernel_ms": lambda: qz.fused_int8_dense(x, layer, True),
            "unfused_library_ms": lambda: addmm_mish(x, w, b)}, iters)
        proj = _quant_layer(gen, 768, (12, 64))
        w_proj, b_proj = w[:, :768].contiguous(), b[:768].contiguous()
        times[f"int8_dense_route_B={batch}_{rows}x768x768"] = _in_turns({
            "plain_ms": lambda: qz.int8_dense_reference(
                x, proj.kernel_q, proj.scale, proj.bias.reshape(-1)),
            "kernel_ms": lambda: qz.int8_dense(x, proj),
            "unfused_library_ms": lambda: torch.addmm(b_proj, x,
                                                      w_proj).float()},
            iters)
        gamma = torch.randn(768, device="cuda", generator=gen)
        beta = torch.randn(768, device="cuda", generator=gen)
        gamma16, beta16 = gamma.to(bf16), beta.to(bf16)
        times[f"layer_norm_B={batch}_{rows}x768_bf16"] = _in_turns({
            "plain_ms": lambda: fused_ln.layer_norm_reference(x, gamma, beta),
            "kernel_ms": lambda: fused_ln.fused_layer_norm(x, gamma, beta),
            "library_ms": lambda: F.layer_norm(x, (768,), gamma16, beta16,
                                               eps=1e-3)}, iters)
        # The wgmma instance takes the batch-32 shape; the mma.sync one is
        # timed beside it (at batch 1 the shape selects mma.sync itself).
        times[f"dense_mish_B={batch}_{rows}x768x1536_bf16"] = _in_turns({
            "plain_ms": lambda: fused_ffn.dense_mish_reference(x, w, b),
            "kernel_ms": lambda: fused_ffn.fused_dense_mish(x, w, b),
            "mma_sync_ms": lambda: fused_ffn._launch(x, w, b, True,
                                                     "mma_sync"),
            "unfused_library_ms": lambda: addmm_mish(x, w, b)}, iters)
        x32, w32, b32 = x.float(), w.float(), b.float()
        times[f"dense_mish_B={batch}_{rows}x768x1536_fp32"] = _in_turns({
            "plain_ms": lambda: fused_ffn.dense_mish_reference(x32, w32, b32),
            "kernel_ms": lambda: fused_ffn.fused_dense_mish(x32, w32, b32)},
            iters)
    _report("kernel_serve", max_abs_err=errors, edge_max_abs_err=edge_worst,
            times=times)
    return worst, times


def phase_model():
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import get_config
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        forward, init_params)

    config = get_config("vit_b16_384").replace(compute_dtype="float32")
    _require(config.use_flash_attention, "vit_b16_384 lost its flash flag")
    params = init_params(config, torch.Generator().manual_seed(SEED))
    h, w = config.image_size
    image = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, (1, h, w, 3)).astype(np.float32))
    with torch.inference_mode():
        cpu = forward(params, image, config)
        gpu = forward(copy.deepcopy(params).to("cuda"), image.to("cuda"),
                      config).cpu()
    _require(tuple(gpu.shape) == (1, config.max_objects, 6),
             f"logits shape {tuple(gpu.shape)}")
    _require(bool(torch.isfinite(gpu).all()), "non-finite logits")
    err = (gpu - cpu).abs().max().item()
    # fp32 on both devices (TF32 off): summation order differs between
    # the CPU and cuBLAS/kernel, through 12 blocks of ViT-B.
    _require(err <= 1e-3, f"fp32 logits: card vs CPU max abs err {err}")
    _report("model", preset="vit_b16_384", dtype="float32",
            logits_max_abs_err_vs_cpu=err, tolerance=1e-3)


def _counts():
    """Every kernel wrapper's launch count, by kernel."""
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, fused_ffn, fused_ln, quantization as qz)

    return {"flash": fa.flash_attention.launches,
            "flash_lse": fa.flash_attention.lse_launches,
            "flash_drop": fa.flash_attention.drop_launches,
            "flash_bwd": fa.flash_attention.backward_launches,
            "flash_bwd_drop": fa.flash_attention.backward_drop_launches,
            "int8_fused": qz.fused_int8_dense.launches,
            "int8_dense": qz.int8_dense.launches,
            "layer_norm": fused_ln.fused_layer_norm.launches,
            "dense_mish": fused_ffn.fused_dense_mish.launches,
            # Of the three above, the launches on tensor-core instances.
            "int8_fused_tc": qz.fused_int8_dense.tensor_core_launches,
            "int8_dense_tc": qz.int8_dense.tensor_core_launches,
            "dense_mish_tc": fused_ffn.fused_dense_mish.tensor_core_launches}


def _reset_counts() -> None:
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, fused_ffn, fused_ln, quantization as qz)

    for fn, names in ((fa.flash_attention,
                       ("launches", "lse_launches", "drop_launches",
                        "backward_launches", "backward_drop_launches")),
                      (qz.fused_int8_dense,
                       ("launches", "tensor_core_launches")),
                      (qz.int8_dense, ("launches", "tensor_core_launches")),
                      (fused_ln.fused_layer_norm, ("launches",)),
                      (fused_ffn.fused_dense_mish,
                       ("launches", "tensor_core_launches"))):
        for name in names:
            setattr(fn, name, 0)


# Launches per vit_b16_384 forward (12 blocks, a 2-layer encoder MLP, a
# 3-layer head MLP): the int8 model's 30 fused int8 dense (linear
# projection, 24 MLP, head token dense, 3 head MLP, head output) and 48
# int8_dense-route (q/k/v/out), the fused dense+mish's 27 (24 + 3), the
# fused LayerNorm's 24 and flash attention's 12. Every dense shape of the
# model moves in whole 16-byte rows, so each of those launches takes a
# tensor-core instance (`_tc`).
PER_FORWARD = {
    "int8": {"flash": 12, "int8_fused": 30, "int8_dense": 48,
             "layer_norm": 24, "int8_fused_tc": 30, "int8_dense_tc": 48},
    "fused_ffn": {"flash": 12, "dense_mish": 27, "layer_norm": 24,
                  "dense_mish_tc": 27},
}


def _expect_counts(path: str, calls: int) -> dict:
    counts = _counts()
    want = {name: 0 for name in counts}
    want.update({name: n * calls for name, n in PER_FORWARD[path].items()})
    _require(counts == want, f"{path}: launches {counts}, expected {want} "
             f"for {calls} forward(s)")
    return counts


def _serve_configs():
    """vit_b16_384 (bf16, flash) with the fused LayerNorm, and the same
    with the fused dense+mish."""
    from vision_transformer_detector_tpu_torch import get_config

    config = get_config("vit_b16_384")
    _require(config.compute_dtype == "bfloat16" and config.use_flash_attention
             and config.embedding_dim == 768 and config.encoder_blocks == 12,
             "vit_b16_384 preset changed")
    fused_ln = config.replace(use_fused_layer_norm=True)
    return config, fused_ln, fused_ln.replace(use_fused_ffn=True)


def phase_model_serve():
    """vit_b16_384 on one seeded image, the card's kernels against the CPU
    plain path from identical weights: the int8 model and the fused
    dense+mish, both with the fused LayerNorm, in the preset's bf16 and in
    fp32; the plain bf16 model beside them as the bf16 yardstick."""
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        forward, init_params)

    bf16_config, ln_config, ffn_config = _serve_configs()
    params = init_params(ln_config, torch.Generator().manual_seed(SEED))
    int8_params = quantize_params(params)
    h, w = ln_config.image_size
    image = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, (1, h, w, 3)).astype(np.float32))
    # Limits on (max, median) of |card - CPU|, relative to the largest
    # logit, by (path, dtype):
    #   * fp32 dense+mish: summation order only, as in `model` (1e-3
    #     absolute there; 1e-4 of the largest logit here);
    #   * bf16 (plain and dense+mish): the kernels round at other points
    #     than the plain versions, through 12 blocks: 8 bf16 ulps (2^-7
    #     each) at the max, 1 at the median;
    #   * int8 (both dtypes): any ulp of difference upstream flips an
    #     activation code at a .5 boundary, and the flips propagate, so
    #     card and CPU sit as far apart as the int8 model sits from the
    #     float one (reported beside, `int8_vs_float_cpu`): 10 % at the
    #     max, 2 % at the median. The kernels themselves agree with their
    #     plain versions exactly (`kernel_serve`).
    ulp = 2.0 ** -7
    limits = {"float32": {"fused_ffn": (1e-4, 1e-4), "int8": (0.1, 0.02)},
              "bfloat16": {"fused_ffn": (8 * ulp, ulp),
                           "plain": (8 * ulp, ulp), "int8": (0.1, 0.02)}}
    results = {}
    for dtype, paths in limits.items():
        cases = {"int8": int8_params, "fused_ffn": params, "plain": params}
        configs = {"int8": ln_config, "fused_ffn": ffn_config,
                   "plain": bf16_config}
        cpu_out = {}
        for path, (max_rel, median_rel) in paths.items():
            config = configs[path].replace(compute_dtype=dtype)
            with torch.inference_mode():
                cpu = forward(cases[path], image, config)
                _reset_counts()
                gpu = forward(copy.deepcopy(cases[path]).to("cuda"),
                              image.to("cuda"), config).cpu()
            cpu_out[path] = cpu
            launches = (_expect_counts(path, 1) if path in PER_FORWARD
                        else _counts())
            _require(tuple(gpu.shape) == (1, config.max_objects, 6)
                     and bool(torch.isfinite(gpu).all()),
                     f"{path} {dtype}: logits {tuple(gpu.shape)}")
            scale = cpu.abs().max().item()
            err = (gpu - cpu).abs()
            bounds = (max_rel * scale, median_rel * scale)
            _require(err.max().item() <= bounds[0]
                     and err.median().item() <= bounds[1],
                     f"{path} {dtype}: card vs CPU max {err.max().item()} / "
                     f"median {err.median().item()}, limits {bounds}")
            results[f"{path}_{dtype}"] = {
                "max_abs_err": err.max().item(),
                "median_abs_err": err.median().item(), "limits": bounds,
                "max_abs_logit": scale, "launches": launches}
        # The dense+mish model is the float model to summation order.
        quant = (cpu_out["int8"] - cpu_out["fused_ffn"]).abs()
        results[f"int8_vs_float_cpu_{dtype}"] = {
            "max_abs": quant.max().item(), "median_abs": quant.median().item()}
    _report("model_serve", preset="vit_b16_384", use_fused_layer_norm=True,
            **results)


def _jpegs(count: int):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    sizes = ((480, 640), (384, 384), (427, 640), (300, 500))
    out = []
    for i in range(count):
        h, w = sizes[i % len(sizes)]
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            buf, format="JPEG", quality=90)
        out.append(((h, w), buf.getvalue()))
    return out


def _check_detections(result: dict, size, num_classes: int) -> None:
    import math

    _require(result.get("image_size") == {"height": size[0],
                                          "width": size[1]},
             f"image_size {result.get('image_size')} != {size}")
    dets = result.get("detections")
    _require(isinstance(dets, list), "no detections list")
    for det in dets:
        _require(set(det) == {"score", "class_id", "class_name", "box"},
                 f"detection keys {sorted(det)}")
        _require(0.0 < det["score"] <= 1.0, f"score {det['score']}")
        _require(0 <= det["class_id"] < num_classes,
                 f"class_id {det['class_id']}")
        _require(all(math.isfinite(v) for v in det["box"].values()),
                 f"box {det['box']}")


def phase_serve():
    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import get_config
    from vision_transformer_detector_tpu_torch.kernels.flash_attention import (
        flash_attention)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionServer, DetectionService)

    config = get_config("vit_b16_384")
    _require(config.compute_dtype == "bfloat16"
             and config.use_flash_attention, "vit_b16_384 preset changed")
    params = init_params(config, torch.Generator().manual_seed(SEED))
    service = DetectionService(config, params, device="cuda")
    server = DetectionServer(service, port=0)     # warms up one request
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        jpegs = _jpegs(REQUESTS)
        latencies = []
        flash_attention.launches = 0
        for size, data in jpegs:
            request = urllib.request.Request(
                f"{base}/predict", data=data,
                headers={"Content-Type": "image/jpeg"})
            tic = time.perf_counter()
            with urllib.request.urlopen(request, timeout=120) as response:
                status = response.status
                result = json.loads(response.read())
            latencies.append((time.perf_counter() - tic) * 1e3)
            _require(status == 200, f"HTTP {status}")
            _check_detections(result, size, config.num_classes)
        launches = flash_attention.launches
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as response:
            stats = json.loads(response.read())
    finally:
        server.stop()
    _require(launches == config.encoder_blocks * REQUESTS,
             f"flash kernel launched {launches} times for {REQUESTS} "
             f"requests, expected {config.encoder_blocks} per request")
    _require(stats["requests"]["ok"] == REQUESTS, f"/stats {stats}")

    # Device path alone (no HTTP, no JPEG decode), batch 1, synced.
    canvas = np.zeros((1, *config.image_size, 3), np.uint8)
    for _ in range(3):
        service.raw_to_detections(service.predict_raw(canvas))
    device_ms = []
    for _ in range(20):
        tic = time.perf_counter()
        service.raw_to_detections(service.predict_raw(canvas))
        device_ms.append((time.perf_counter() - tic) * 1e3)
    _report("serve", preset="vit_b16_384", dtype="bfloat16",
            requests=REQUESTS, request_latency_ms=latencies,
            server_latency_ms=stats.get("latency_ms_recent"),
            predict_b1_ms_median=float(np.median(device_ms)),
            predict_b1_ms_min=min(device_ms), flash_launches=launches,
            decode_core=stats.get("decode_core"))
    return launches


def _device_path_ms(services: dict, batches=(1, 32)) -> dict:
    """Median device-path time (predict_raw + the packed result on the
    host, synced) of each service, at each batch, taken in turns (a, b,
    ..., b, a) so that every service sees the same card state."""
    import numpy as np

    times = {}
    for batch in batches:
        some = next(iter(services.values()))
        canvas = np.zeros((batch, *some.config.image_size, 3), np.uint8)
        reps = 20 if batch == 1 else 5
        samples = {name: [] for name in services}
        order = list(services) + list(services)[::-1]
        for name in order:
            service = services[name]
            for _ in range(2):
                service.raw_to_detections(service.predict_raw(canvas))
            for _ in range(reps // 2):
                tic = time.perf_counter()
                service.raw_to_detections(service.predict_raw(canvas))
                samples[name].append((time.perf_counter() - tic) * 1e3)
        for name, values in samples.items():
            times.setdefault(name, {})[f"b{batch}_ms_median"] = float(
                np.median(values))
    return times


def phase_serve_int8():
    """The `serve --int8` service (quantize_params after loading, as the
    CLI does) with the fused LayerNorm, behind DetectionServer, beside the
    bf16 service on the same weights."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionServer, DetectionService)

    config, ln_config, _ = _serve_configs()
    params = init_params(config, torch.Generator().manual_seed(SEED))
    int8 = DetectionService(ln_config, quantize_params(params),
                            device="cuda")
    server = DetectionServer(int8, port=0)     # warms up one request
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        latencies = []
        _reset_counts()
        for size, data in _jpegs(REQUESTS):
            request = urllib.request.Request(
                f"{base}/predict", data=data,
                headers={"Content-Type": "image/jpeg"})
            tic = time.perf_counter()
            with urllib.request.urlopen(request, timeout=120) as response:
                status = response.status
                result = json.loads(response.read())
            latencies.append((time.perf_counter() - tic) * 1e3)
            _require(status == 200, f"HTTP {status}")
            _check_detections(result, size, config.num_classes)
        launches = _expect_counts("int8", REQUESTS)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as response:
            stats = json.loads(response.read())
    finally:
        server.stop()
    _require(stats["requests"]["ok"] == REQUESTS, f"/stats {stats}")
    bf16 = DetectionService(config, params, device="cuda")
    times = _device_path_ms({"bf16": bf16, "int8": int8})
    _require(times["int8"]["b32_ms_median"] < times["bf16"]["b32_ms_median"],
             f"int8 service at batch 32 not below the bf16 service: {times}")
    _report("serve_int8", preset="vit_b16_384", use_fused_layer_norm=True,
            requests=REQUESTS, request_latency_ms=latencies,
            launches=launches, device_path=times)
    return launches, times


def phase_serve_fused_ffn():
    """The `--fused-ffn` service with the fused LayerNorm, device path,
    beside the bf16 service on the same weights."""
    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    config, _, ffn_config = _serve_configs()
    params = init_params(config, torch.Generator().manual_seed(SEED))
    fused = DetectionService(ffn_config, params, device="cuda")
    bf16 = DetectionService(config, params, device="cuda")
    canvas = np.zeros((1, *config.image_size, 3), np.uint8)
    fused.raw_to_detections(fused.predict_raw(canvas))     # warm up
    _reset_counts()
    calls = 3
    for _ in range(calls):
        dets = fused.raw_to_detections(fused.predict_raw(canvas))
        _require(len(dets) == 1, f"detections {dets}")
    launches = _expect_counts("fused_ffn", calls)
    times = _device_path_ms({"bf16": bf16, "fused_ffn": fused})
    _require(times["fused_ffn"]["b32_ms_median"]
             < times["bf16"]["b32_ms_median"],
             f"fused-FFN service at batch 32 not below the bf16 service: "
             f"{times}")
    _report("serve_fused_ffn", preset="vit_b16_384",
            use_fused_layer_norm=True, calls=calls, launches=launches,
            device_path=times)
    return launches, times


def phase_train():
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.kernels.flash_attention import (
        flash_attention)
    from vision_transformer_detector_tpu_torch.metrics import (
        DeviceMeanAveragePrecision, MeanAveragePrecision)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        count_params, forward, init_params)
    from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, train_config_view)

    config = get_config("reference_608")
    _require(config.train_use_flash_attention
             and not config.use_flash_attention and config.dropout is None
             and config.compute_dtype == "float32" and config.key_dim == 40
             and config.num_patches == 1296, "reference_608 preset changed")
    train_view = train_config_view(config)
    loss_config = LossConfig()

    # (a) one step's loss and grads, card against CPU, batch 2.
    params = init_params(config, torch.Generator().manual_seed(SEED))
    images, labels = next(synthetic_batches(config, 2, 1, seed=SEED))

    def loss_and_grads(model, device):
        named = dict(model.named_parameters())
        logits = forward(model, torch.from_numpy(images).to(device),
                         train_view)
        loss = detection_loss(torch.from_numpy(labels).to(device), logits,
                              config, loss_config)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.item(), {n: g.cpu() for n, g in zip(named, grads)}

    cpu_loss, cpu_grads = loss_and_grads(params, "cpu")
    counts = (flash_attention.lse_launches,
              flash_attention.backward_launches)
    gpu_loss, gpu_grads = loss_and_grads(copy.deepcopy(params).to("cuda"),
                                         "cuda")
    _require((flash_attention.lse_launches - counts[0],
              flash_attention.backward_launches - counts[1])
             == (config.encoder_blocks,) * 2,
             "one card step did not launch each kernel once per block")
    # fp32 on both devices (TF32 off); sums run in other orders on the
    # CPU and the card (and dq's atomics in run-dependent order) through
    # 8 blocks. The attention key bias's gradient is zero in exact
    # arithmetic (the softmax cancels it), so both sides hold rounding
    # noise there: it is held to the largest gradient instead.
    loss_tol, grad_tol = 1e-4, 2e-3
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    _require(np.isfinite(gpu_loss) and loss_err <= loss_tol,
             f"loss card {gpu_loss} vs CPU {cpu_loss}")
    worst, worst_err = _grad_errors(gpu_grads, cpu_grads, grad_tol,
                                    "card vs CPU")
    del params, cpu_grads, gpu_grads

    # (b, c) 20 steps at batch 8 through Trainer.fit, eval at the end.
    train_config = TrainConfig(learning_rate=8e-5, seed=SEED,
                               epochs_warm_up=TRAIN_STEPS - 1,
                               skip_epochs=TRAIN_STEPS)
    trainer = Trainer(config, loss_config, train_config, device="cuda")
    state = trainer.init_state()
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 1))
    _reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    state = trainer.fit(state, data, epochs=TRAIN_STEPS, eval_data=data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    launches = {"fwd": flash_attention.launches,
                "fwd_lse": flash_attention.lse_launches,
                "bwd": flash_attention.backward_launches}
    per_step = config.encoder_blocks * TRAIN_STEPS
    _require(launches == {"fwd": 0, "fwd_lse": per_step, "bwd": per_step},
             f"fit launched {launches}; expected {config.encoder_blocks} "
             f"forward-with-lse and backward launches per step and none in "
             f"eval (the matmul route)")
    losses = trainer.loss_record
    _require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
             f"losses {losses}")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _require(len(trainer.ap_record) == 1
             and 0.0 <= trainer.ap_record[0] <= 1.0,
             f"eval AP {trainer.ap_record}")
    # 20 steps from random weights score AP 0, so the device metric is
    # also held to the NumPy oracle on predictions that score above 0:
    # the batch's labels with random confidences, jittered boxes and some
    # classes wrong.
    labels_np = data[0][1]
    preds_np, real = labels_np.copy(), labels_np[..., 0] > 0
    rng = np.random.default_rng(SEED)
    preds_np[real, 0] = rng.uniform(0.3, 1.0, real.sum())
    preds_np[real, 2:4] += rng.uniform(-4, 4, (real.sum(), 2))
    preds_np[real, 4:] *= rng.uniform(0.85, 1.15, (real.sum(), 2))
    wrong = real & (rng.uniform(size=real.shape) < 0.3)
    preds_np[wrong, 1] = (preds_np[wrong, 1] + 1) % config.num_classes
    device_metric = DeviceMeanAveragePrecision(config, "cuda")
    oracle = MeanAveragePrecision(config)
    for metric in (device_metric, oracle):
        metric.update_state(labels_np, preds_np,
                            use_transform_predictions=False)
    metric_ap = (device_metric.result(), float(oracle.result()))
    # 1e-5: fp32 on the card, float64 sums in parts of the oracle.
    _require(metric_ap[1] > 0.1 and abs(metric_ap[0] - metric_ap[1]) <= 1e-5,
             f"device metric AP {metric_ap[0]} vs NumPy oracle {metric_ap[1]}")

    # (d) save and restore: parameters, step and every Adam moment come
    # back bit for bit, and the next step's loss is identical (the loss
    # is read before the update, so it sees the parameters only; the
    # moments are compared directly, since dq's atomic adds make the
    # update itself differ in its last bits from run to run).
    images8, labels8 = (torch.from_numpy(a).to("cuda") for a in data[0])
    saved = {"params": {n: t.clone() for n, t in
                        state["params"].state_dict().items()},
             "count": state["opt_state"]["count"],
             **{m: {n: t.clone() for n, t in state["opt_state"][m].items()}
                for m in ("mu", "nu")}}
    with tempfile.TemporaryDirectory() as tmp:
        trainer.checkpoint_dir = tmp
        trainer.save(state, name="smoke")
        _, loss_a = trainer.train_step(state, images8, labels8)
        state = trainer.restore(state, name="smoke")
    _require(state["step"] == TRAIN_STEPS
             and state["opt_state"]["count"] == saved["count"],
             f"step {state['step']}, count {state['opt_state']['count']}")
    restored = {"params": state["params"].state_dict(),
                "mu": state["opt_state"]["mu"], "nu": state["opt_state"]["nu"]}
    for part in ("params", "mu", "nu"):
        _require(restored[part].keys() == saved[part].keys()
                 and all(torch.equal(restored[part][n], t)
                         for n, t in saved[part].items()),
                 f"restored {part} differ from the saved ones")
    del saved, restored
    _, loss_b = trainer.train_step(state, images8, labels8)
    _require(loss_a.item() == loss_b.item(),
             f"loss after restore {loss_b.item()} != {loss_a.item()}")

    # (e) the median step time at batch 8.
    step_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        trainer.train_step(state, images8, labels8)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - tic) * 1e3)
    _report("train", preset="reference_608", dtype="float32",
            params=count_params(state["params"]),
            step_vs_cpu={"batch": 2, "loss_card": gpu_loss,
                         "loss_cpu": cpu_loss, "loss_rel_err": loss_err,
                         "loss_tol": loss_tol, "grad_rel_err_max":
                         worst_err, "grad_worst": worst,
                         "grad_tol": grad_tol},
            fit={"batch": 8, "steps": TRAIN_STEPS, "seconds": fit_s,
                 "loss_first": losses[0], "loss_last": losses[-1],
                 "eval_ap": trainer.ap_record[0], "launches": launches},
            metric_ap_card_vs_oracle=metric_ap,
            restore_state_and_loss_identical=True,
            step_ms_median=float(np.median(step_ms)),
            step_ms_min=min(step_ms),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


HIGHRES_STEPS = 8       # Trainer.fit epochs (one batch each) in train_highres


def phase_train_highres():
    """highres_1024 (1024 px, 4,096 tokens in 16 windows of 256, D 1024,
    24 blocks, the (1, 2, 4) multi-scale head) trained with dropout 0.1
    and full remat, the configuration its docstring gives for training
    with dropout: (a) card against CPU, one fp32 step at batch 1 and depth
    2 with dropout off; (b) on the card at depth 2 in fp32 with dropout
    on, remat None against no remat from one seed; (c) Trainer.fit at
    batch 8, bf16, all 24 blocks, with an eval; (d) save, restore, and
    the next step's loss; (e) the median step and peak memory; (f) one
    step as shipped ("alternate" remat, no dropout)."""
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        count_params, forward, init_params)
    from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    shipped = get_config("highres_1024")
    _require(shipped.image_size == (1024, 1024) and shipped.patch_size == 16
             and shipped.embedding_dim == 1024 and shipped.num_heads == 16
             and shipped.key_dim == 64 and shipped.encoder_blocks == 24
             and shipped.attention_window == 16
             and tuple(shipped.head_scales) == (1, 2, 4)
             and shipped.remat_encoder and shipped.remat_policy == "alternate"
             and shipped.compute_dtype == "bfloat16"
             and shipped.use_flash_attention and shipped.dropout is None,
             "highres_1024 preset changed")
    config = shipped.replace(dropout=DROP_RATE, remat_policy=None)
    loss_config = LossConfig()
    # fp32 at depth 2 for the card-against-CPU and remat checks.
    small = config.replace(encoder_blocks=2, compute_dtype="float32")

    def loss_and_grads(model, cfg, images, labels, device, seed=None):
        named = dict(model.named_parameters())
        logits = forward(model, torch.from_numpy(images).to(device), cfg,
                         train=True, dropout_seed=seed)
        loss = detection_loss(torch.from_numpy(labels).to(device), logits,
                              cfg, loss_config)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.item(), {n: g.cpu() for n, g in zip(named, grads)}

    # (a) card against CPU, dropout off (no seed), batch 1, fp32: sums in
    # other orders (and dq's atomics) through 2 full-width blocks.
    loss_tol, grad_tol = 1e-4, 2e-3
    params = init_params(small, torch.Generator().manual_seed(SEED))
    images, labels = next(synthetic_batches(small, 1, 1, seed=SEED))
    cpu_loss, cpu_grads = loss_and_grads(params, small, images, labels,
                                         "cpu")
    card = copy.deepcopy(params).to("cuda")
    gpu_loss, gpu_grads = loss_and_grads(card, small, images, labels, "cuda")
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    _require(np.isfinite(gpu_loss) and loss_err <= loss_tol,
             f"highres loss card {gpu_loss} vs CPU {cpu_loss}")
    cpu_worst = _grad_errors(gpu_grads, cpu_grads, grad_tol, "card vs CPU")
    del cpu_grads, gpu_grads

    # (b) remat None against no remat, dropout on, one seed, on the card:
    # the forward is the same computation (equal loss); the grads differ
    # by dq's atomic adds in run-dependent order.
    remat_tol = 1e-4
    seed = 12345
    remat_losses, grads = {}, {}
    for name, cfg in (("none", small),
                      ("no_remat", small.replace(remat_encoder=False))):
        remat_losses[name], grads[name] = loss_and_grads(
            card, cfg, images, labels, "cuda", seed)
    _require(remat_losses["none"] == remat_losses["no_remat"],
             f"remat loss {remat_losses}")
    remat_worst = _grad_errors(grads["none"], grads["no_remat"], remat_tol,
                               "remat vs no remat")
    off_loss = loss_and_grads(card, small, images, labels, "cuda")[0]
    _require(off_loss != remat_losses["none"], "dropout changed nothing")
    del params, card, grads

    # (c) Trainer.fit at batch 8, full depth, bf16, dropout 0.1, remat
    # None, with an eval at the end. lr 1e-5: at the default 8e-5 this
    # model's loss on one synthetic batch oscillates (in fp32 as in bf16)
    # instead of falling within a few steps.
    train_config = TrainConfig(learning_rate=1e-5, seed=SEED,
                               epochs_warm_up=HIGHRES_STEPS - 1,
                               skip_epochs=HIGHRES_STEPS)
    trainer = Trainer(config, loss_config, train_config, device="cuda")
    state = trainer.init_state()
    n_params = count_params(state["params"])
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 1))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    state = trainer.fit(state, data, epochs=HIGHRES_STEPS, eval_data=data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    launches = _counts()
    blocks = config.encoder_blocks
    # Per step: each block's forward with dropout and lse, again in the
    # remat recompute, and the backward with the replay; the eval: one
    # forward without lse or dropout per block.
    want = dict({name: 0 for name in launches},
                flash=blocks, flash_drop=2 * blocks * HIGHRES_STEPS,
                flash_bwd_drop=blocks * HIGHRES_STEPS)
    _require(launches == want, f"fit launched {launches}, expected {want}")
    losses = trainer.loss_record
    _require(len(losses) == HIGHRES_STEPS and all(np.isfinite(losses)),
             f"losses {losses}")
    # Dropout makes single steps noisy: the last loss and the mean of the
    # last half both below the first.
    _require(losses[-1] < losses[0]
             and np.mean(losses[HIGHRES_STEPS // 2:]) < losses[0],
             f"loss did not fall: {losses}")
    _require(len(trainer.ap_record) == 1
             and 0.0 <= trainer.ap_record[0] <= 1.0,
             f"eval AP {trainer.ap_record}")
    eval_ap = trainer.ap_record[0]

    # (d) save, restore: the restored dropout generator draws the seed the
    # uninterrupted run drew, so the next step's loss is identical.
    images8, labels8 = (torch.from_numpy(a).to("cuda") for a in data[0])
    with tempfile.TemporaryDirectory() as tmp:
        trainer.checkpoint_dir = tmp
        trainer.save(state, name="smoke")
        _, loss_a = trainer.train_step(state, images8, labels8)
        state = trainer.restore(state, name="smoke")
    _, loss_b = trainer.train_step(state, images8, labels8)
    _require(loss_a.item() == loss_b.item(),
             f"loss after restore {loss_b.item()} != {loss_a.item()}")

    # (e) the median step at batch 8.
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        trainer.train_step(state, images8, labels8)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - tic) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer, state

    # (f) one step as shipped: "alternate" remat, no dropout.
    plain = Trainer(shipped, loss_config, train_config, device="cuda")
    plain_state = plain.init_state()
    _reset_counts()
    _, shipped_loss = plain.train_step(plain_state, images8, labels8)
    torch.cuda.synchronize()
    shipped_launches = _counts()
    want = dict({name: 0 for name in shipped_launches},
                flash_lse=blocks + blocks // 2, flash_bwd=blocks)
    _require(shipped_launches == want and np.isfinite(shipped_loss.item()),
             f"as shipped: launches {shipped_launches}, expected {want}; "
             f"loss {shipped_loss.item()}")
    del plain, plain_state
    _report("train_highres", preset="highres_1024", dropout=DROP_RATE,
            remat_policy=None, dtype="bfloat16", params=n_params,
            step_vs_cpu={"batch": 1, "blocks": 2, "dtype": "float32",
                         "loss_card": gpu_loss, "loss_cpu": cpu_loss,
                         "loss_rel_err": loss_err, "loss_tol": loss_tol,
                         "grad_worst": cpu_worst, "grad_tol": grad_tol},
            remat_vs_none={"blocks": 2, "dtype": "float32", "seed": seed,
                           "loss": remat_losses,
                           "loss_dropout_off": off_loss,
                           "grad_worst": remat_worst, "grad_tol": remat_tol},
            fit={"batch": 8, "steps": HIGHRES_STEPS, "seconds": fit_s,
                 "losses": losses, "eval_ap": eval_ap,
                 "launches": launches},
            restore_loss_identical=True,
            step_ms_median=float(np.median(step_ms)),
            step_ms_min=min(step_ms), peak_memory_gib=peak_gib,
            shipped={"remat_policy": "alternate", "dropout": None,
                     "loss": shipped_loss.item(),
                     "launches": shipped_launches})
    return launches


PEAK_NAMES = {"bf16": "bf16 989 TFLOP/s", "int8": "int8 1979 TOP/s",
              "3xtf32": "tf32 495 TFLOP/s, 3 products per fp32 product",
              "fp32": "fp32 67 TFLOP/s"}


def _entry(name, source, replaces, shape, launches, err, times, work):
    """One kernel of the kernels line; ``work`` is (operations, bytes,
    kind) for its bound."""
    bound = _bound(*work)
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": TPU_KERNELS + replaces, "shape": shape,
            "launches": launches, "max_abs_err": err,
            "ms": times["kernel_ms"], "plain_ms": times["plain_ms"],
            "library_ms": times.get("library_ms"),
            "bound_ms": bound[0], "bound_by": bound[1],
            "peak": PEAK_NAMES[work[2]]}


def _kernels_line(flash_err, flash_times, train_errors, train_times,
                  drop_errors, drop_times, serve_errors, serve_times,
                  launches) -> dict:
    """The kernels of every path, each with its launches on its main path,
    its error against its plain version, its times and its bound."""
    bh, n, k = 12, 576, 64                     # vit_b16_384, batch 1
    flash_bytes = 4 * bh * n * k * 2
    tbh, tn, tk = 64, 1296, 40                 # reference_608, batch 8
    qkv = tbh * tn * tk * 4
    hbh, hn, hk = 2048, 256, 64                # highres_1024, batch 8
    hqkv = hbh * hn * hk * 2                   # one bf16 operand
    rows, d, wide = 576 * 32, 768, 1536        # vit_b16_384, batch 32
    return {"kernels": [
        _entry("flash_attention_fwd", "flash_attention_fwd.cu",
               "flash_attention.py:64", [bh, n, k, "bfloat16"],
               launches["flash"], flash_err, flash_times[1],
               (4 * bh * n * n * k, flash_bytes, "bf16")),
        _entry("flash_attention_fwd_lse", "flash_attention_fwd.cu",
               "flash_attention.py:653", [tbh, tn, tk, "float32"],
               launches["flash_lse"], train_errors["lse_abs"],
               train_times["fwd_lse"],
               (4 * tbh * tn * tn * tk, 4 * qkv + tbh * tn * 4, "3xtf32")),
        _entry("flash_attention_bwd", "flash_attention_bwd.cu",
               "flash_attention.py:151", [tbh, tn, tk, "float32"],
               launches["flash_bwd"], train_errors["bwd_abs"],
               train_times["bwd"],
               (10 * tbh * tn * tn * tk, 7 * qkv + 2 * tbh * tn * 4,
                "3xtf32")),
        # q, k, v read, out written (bf16), lse written (fp32).
        _entry("flash_attention_fwd_drop", "flash_attention_fwd.cu",
               "flash_attention.py:679", [hbh, hn, hk, "bfloat16", DROP_RATE],
               launches["flash_drop"], drop_errors["out_abs"],
               drop_times["fwd_drop"],
               (4 * hbh * hn * hn * hk, 4 * hqkv + hbh * hn * 4, "bf16")),
        # q, k, v, g read and dk, dv written (bf16), lse and delta read and
        # dq written (fp32).
        _entry("flash_attention_bwd_drop", "flash_attention_bwd.cu",
               "flash_attention.py:151", [hbh, hn, hk, "bfloat16", DROP_RATE],
               launches["flash_bwd_drop"], drop_errors["bwd_abs"],
               drop_times["bwd_drop"],
               (10 * hbh * hn * hn * hk,
                6 * hqkv + 2 * hqkv + 2 * hbh * hn * 4, "bf16")),
        dict(_entry("int8_dense", "int8_dense.cu", "quantization.py:159",
                    [rows, d, wide, "bfloat16", "mish"],
                    launches["int8_fused"], serve_errors["int8_dense"],
                    serve_times[f"int8_dense_B=32_{rows}x768x1536_mish"],
                    (2 * rows * d * wide,
                     rows * d * 2 + d * wide + wide * 8 + rows * wide * 2,
                     "int8")),
             unfused_library_ms=serve_times[
                 f"int8_dense_B=32_{rows}x768x1536_mish"][
                     "unfused_library_ms"],
             route_launches={"fused_int8_dense": launches["int8_fused"],
                             "int8_dense": launches["int8_dense"]},
             tensor_core_launches={
                 "fused_int8_dense": launches["int8_fused_tc"],
                 "int8_dense": launches["int8_dense_tc"]},
             # The fp32-out route at the q/k/v/out shape, 768 -> 768: bf16
             # x and int8 codes read, scale and bias read, fp32 written.
             route_shape=[rows, d, d, "bfloat16", "float32 out"],
             route_ms=serve_times[f"int8_dense_route_B=32_{rows}x768x768"][
                 "kernel_ms"],
             route_plain_ms=serve_times[
                 f"int8_dense_route_B=32_{rows}x768x768"]["plain_ms"],
             route_unfused_library_ms=serve_times[
                 f"int8_dense_route_B=32_{rows}x768x768"][
                     "unfused_library_ms"],
             route_bound_ms=_bound(2 * rows * d * d,
                                   rows * d * 2 + d * d + d * 8
                                   + rows * d * 4, "int8")[0]),
        _entry("layer_norm", "layer_norm.cu", "fused_ln.py:37",
               [rows, d, "bfloat16"], launches["layer_norm"],
               serve_errors["layer_norm"],
               serve_times[f"layer_norm_B=32_{rows}x768_bf16"],
               (7 * rows * d, 2 * rows * d * 2 + 2 * d * 4, "fp32")),
        dict(_entry("dense_mish", "dense_mish.cu", "fused_ffn.py:42",
                    [rows, d, wide, "bfloat16", "mish"],
                    launches["dense_mish"], serve_errors["dense_mish"],
                    serve_times[f"dense_mish_B=32_{rows}x768x1536_bf16"],
                    (2 * rows * d * wide,
                     (rows * d + d * wide + wide + rows * wide) * 2, "bf16")),
             unfused_library_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_bf16"][
                     "unfused_library_ms"],
             tensor_core_launches=launches["dense_mish_tc"],
             # `ms` is the wgmma instance's (the one this shape selects);
             # the mma.sync instance on the same inputs beside it.
             mma_sync_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_bf16"]["mma_sync_ms"],
             # The same shape in fp32, 3xTF32 on mma.sync.
             fp32_ms=serve_times[f"dense_mish_B=32_{rows}x768x1536_fp32"][
                 "kernel_ms"],
             fp32_plain_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_fp32"]["plain_ms"],
             fp32_bound_ms=_bound(2 * rows * d * wide,
                                  (rows * d + d * wide + wide
                                   + rows * wide) * 4, "3xtf32")[0]),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # fp32 references are full fp32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    flash_err, flash_times = phase_kernel()
    train_errors, train_times = phase_kernel_train()
    drop_errors, drop_times = phase_kernel_drop()
    serve_errors, serve_times = phase_kernel_serve()
    phase_model()
    phase_model_serve()
    flash_launches = phase_serve()
    int8_launches, _ = phase_serve_int8()
    ffn_launches, _ = phase_serve_fused_ffn()
    train_launches = phase_train()
    highres_launches = phase_train_highres()
    foreign = sorted(name for name in sys.modules
                     if name == "jax" or name.startswith("jax.")
                     or name == "vision_transformer_detector_tpu"
                     or name.startswith("vision_transformer_detector_tpu."))
    _require(not foreign, f"imported {foreign[:5]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    launches = {"flash": flash_launches,
                "flash_lse": train_launches["fwd_lse"],
                "flash_bwd": train_launches["bwd"],
                "flash_drop": highres_launches["flash_drop"],
                "flash_bwd_drop": highres_launches["flash_bwd_drop"],
                "int8_fused": int8_launches["int8_fused"],
                "int8_dense": int8_launches["int8_dense"],
                "layer_norm": int8_launches["layer_norm"],
                "dense_mish": ffn_launches["dense_mish"],
                "int8_fused_tc": int8_launches["int8_fused_tc"],
                "int8_dense_tc": int8_launches["int8_dense_tc"],
                "dense_mish_tc": ffn_launches["dense_mish_tc"]}
    print(json.dumps(_kernels_line(flash_err, flash_times, train_errors,
                                   train_times, drop_errors, drop_times,
                                   serve_errors, serve_times, launches)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
