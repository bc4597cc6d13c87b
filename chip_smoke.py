#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port (vision_transformer_detector_tpu_torch) through its main
paths, serving the ViT-B/16 384px detector over HTTP (bf16, int8 with the
fused LayerNorm, and the fused dense+mish with the fused LayerNorm),
training the reference_608 detector, training highres_1024 with attention
dropout, training both through the windowed loop that replays the train
step as a CUDA graph, the CLI's tools (benchmark, doctor, sweep, resumable
and windowed training, async checkpoints), and the deployment lifecycle
(train, COCO-protocol evaluation, export as a torch.export artifact whose
graphs call the kernels as custom operators, serving from the artifact),
and checks each hand-written kernel on those paths against its plain
PyTorch version. Phases, one output line each:

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
                    heads-major, and a ragged N; the backward launched 10
                    times at the reference_608 shape, dq, dk and dv
                    bit-equal every time; times forward-with-lse,
                    backward and forward+backward, kernel against plain, at
                    the reference_608 shape, beside scaled_dot_product_
                    attention forward and backward;
  3b. kernel_drop — the forward with in-kernel dropout (rate 0.1, a seed
                    near 2^32) and lse, and the backward with the mask
                    replayed, against the plain versions with the same
                    mask (the seed read from device memory, as the
                    model hands it over), and the Function against
                    autograd: (2048, 256,
                    64) bf16 (highres_1024 at batch 8, heads-major as the
                    model folds its windows), (64, 1296, 40) fp32
                    tokens-major and a ragged N; the kernel's mask read
                    back exactly (q = k = 0, v one-hot) for 2,048
                    batch*heads; the backward with and without the replay
                    launched 10 times at (2048, 256, 64) bf16, dq, dk and
                    dv bit-equal every time; times in turns against the
                    plain versions
                    and scaled_dot_product_attention with dropout_p, and
                    highres_1024 as shipped (forward with lse and backward,
                    no dropout) against both without dropout;
  3c. kernel_mlp_drop — the MLP/head dropout kernel against its plain
                    version, forward and backward, bit for bit, from a seed
                    in device memory: highres_1024's pyramid layers at
                    batch 8, (8, 4096, 2048) and (8, 4096, 1024) bf16, a
                    ragged row and a misaligned fp32 view; times in turns
                    with the plain version and F.dropout;
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
                    launches per step, 126 MLP/head dropout launches per
                    step, 24 plain forward launches in the eval; (d) save, restore, the next step's loss is
                    identical (the dropout seed generator is restored);
                    (e) the median step time and peak memory; (f) one step
                    as shipped ("alternate" remat, no dropout): 36
                    forward-with-lse and 24 backward launches;
 12. train_window — Trainer.fit(epochs_per_call > 1), whose windowed
                    loop captures the train step as a CUDA graph and
                    replays it, against the per-epoch eager loop from one
                    seeded state: (a) reference_608, fp32, batch 8, 12
                    epochs in windows of 4 cut by an eval and checkpoint
                    cadence that does not divide 4: per-epoch losses and
                    the parameters after the fit bit-equal (graph against
                    loop, and a second eager loop against the first), the
                    same AP records, the windows cut at the event epochs;
                    (b) highres_1024, bf16, dropout 0.1, remat None, batch
                    8, lr 1e-5, 8 steps: the graph's seed rows are the
                    loop's draws and its seed buffer holds the last one,
                    every step's loss bit-equal (graph against loop, a
                    second eager loop, a third under torch.use_
                    deterministic_algorithms, whose warnings are listed),
                    and a planted fault (replays that never write the seed
                    buffer) fails that comparison;
                    (c) each graph's kernel nodes (debug dump): 8 + 8 flash
                    per reference_608 step, 48 B1-drop + 24 B2-replay and
                    the loop's MLP dropout launches per highres_1024 step,
                    the launches printed being nodes x replays;
                    (d) accumulate_steps=2 at depth 2 (a micro-step and an
                    update-step graph) against the loop; (e) "alternate"
                    remat with dropout at depth 2; the median ms per step
                    of both loops;
 13. cli_tools    — `vtd-torch benchmark` (inference on vit_b16_384 at batch
                    32, train on reference_608 at batch 8, each JSON line
                    printed), `doctor` (exit 0, device ok, sm_90, every
                    kernel library built), `sweep --synthetic` over two
                    learning rates on tiny_96, `train --resumable` stopped
                    after a checkpoint and resumed against an
                    uninterrupted run (the same step and input position),
                    `train --epochs-per-call`, and an async checkpoint of
                    reference_608 written while two more steps run,
                    bit-equal to the state at save time;
 14. lifecycle    — vit_b16_384 (bf16, flash, the fused dense+mish and the
                    fused LayerNorm) through `vtd-torch`: (a) train 2
                    epochs at batch 4 on 8 seeded JPEGs (finite loss,
                    12 forward-with-lse, 12 backward and 27 dense+mish
                    launches per step; the LayerNorm kernel is for
                    inference only); (b) evaluate --protocol
                    coco-original --dump-detections and score-coco of the
                    dump: protocol-valid, AP and AP50 within 0.02; a
                    perfect detector scores AP 1.0; (c) export the final
                    checkpoint on CUDA (a (1, 8) bundle, baked
                    postprocess): each graph holds 12 flash-forward, 27
                    dense+mish and 24 LayerNorm custom-operator nodes and
                    none of their plain versions' softmax, log1p, tanh or
                    rsqrt; (d) a fresh process
                    that never imports models/ serves the artifact
                    (batcher, max batch 8) and answers 8 POSTs with 12 +
                    27 + 24 launches per request; (e) the answers against
                    the live service on the restored weights: the same
                    classes, scores within 1e-3, boxes within 0.1 px
                    (bit-equal reported); (f) device-path medians of the
                    artifact and the live service at batch 1 and 8;
 15. wide_heads   — a detector at ViT-H/14's attention widths (D 1280, 16
                    heads of 80, 32 blocks, 224 px in 14 px patches: 256
                    tokens; bf16, flash in serving and training), whose
                    K = 80 runs the flash kernels' 128-wide instance:
                    (a) that instance at K 80, 96 and 128, both layouts,
                    bf16 and fp32, against the plain versions (forward,
                    lse, dropout forward, backward by each dq route and
                    with the replay, the fp32-output instance and fp32
                    dk/dv), a ring of two key blocks chained against one
                    launch bit for bit, B2 10 times bit-equal; (b) its
                    times at (B * 16, 256, 80) for B = 1, 8, 32 and at
                    (2048, 256, 128) beside SDPA and the bound; (c)
                    DetectionService at batch 1 and 32, one seeded image
                    card against CPU at model_serve's bf16 limits, 32
                    flash launches a call; (d) 5 steps at batch 8 through
                    Trainer.fit (the loss falls; 32 forward-with-lse and
                    32 backward launches a step), one fp32 step at depth
                    2 against the CPU, step time and peak memory;
 15b. walkthrough — examples/end_to_end_torch.py on the card (tiny_96
                    with flash attention, 4 epochs): dataset, train,
                    COCO-protocol evaluation, plot, visualize, export,
                    and `vtd-torch serve --from-export` answering a POST
                    on 127.0.0.1; every artifact exists, the served
                    detections are well-formed, the flash kernels ran;

 16. parallel     — data, tensor and sequence parallelism and ring
                    attention on the one card:
                    (a) B1-drop (with lse) and B2-replay at (2048, 256,
                    64) bf16 over the whole batch against two half
                    batches launched with their batch*head offset, and
                    the MLP dropout kernel at (8, 4096, 2048) against two
                    halves with their row offset, bit for bit; a half
                    launched with offset 0 (a planted fault) must differ;
                    (f) the sharded coordinate maps: B1-drop and
                    B2-replay at highres_1024's (2, 16 x 16 windows, 256,
                    64) bf16 over all heads and windows against two head
                    halves and two window halves with their batch*head
                    maps, and the MLP dropout kernel at (2, 4096, 2048)
                    against two token halves (row map) and two column
                    halves (column base), bit for bit, each with a
                    planted wrong base that must differ;
                    the ring's R = 2 block launches timed against their
                    plain versions and SDPA; then two worker processes
                    (this script with --parallel-worker) in a gloo group
                    on this card, the ring's exchange staged through host
                    memory: (b) ring attention at R = 2 forward and
                    backward against the plain versions and the
                    whole-sequence kernels, bf16 at highres_1024_ring's
                    (2, 4096, 16, 64) with and without dropout 0.1 and
                    fp32 at (64, 1296, 40), with the times of both, and
                    the whole ring's host-clock times; (c) data
                    parallelism: reference_608 fp32, global batch 8 as
                    2 x 4, 3 steps, each loss within 1e-5 of one process
                    at batch 8; (d) highres_1024_ring at full width and
                    depth, R = 2, batch 2, 3 steps at lr 1e-5 against one
                    process with global flash attention, within
                    HIGHRES_RING_LOSS_LIMITS, the ring's launches per step
                    and each process's peak memory, and the same three
                    steps in fp32 against one process (reported); (g)
                    tensor parallelism and (h) sequence sharding of
                    highres_1024 at full width and depth (bf16, dropout
                    0.1, full remat), M = 2, batch 2, 3 steps at lr 1e-5
                    against one process within HIGHRES_RING_LOSS_LIMITS
                    ((g): the three steps in fp32 within 1e-5, and each
                    bf16 step no farther from fp32 than one process's
                    bf16 step plus the limit), one fp32 step with dropout
                    within 1e-5 (loss) and 1e-4 (gradients),
                    step time, peak memory and collective bytes a
                    process; then in four worker processes (b) again at
                    R = 4 and (i) data x tensor parallelism of
                    reference_608 fp32 over 2 x 2, batch 4, 3 steps within
                    1e-5 of one process, parameters within 2 x lr, and
                    evaluate_map(mesh=...) within 1e-3 of one process's
                    AP; (e) an NCCL group of
                    one: reference_608's fit(epochs_per_call=4) under
                    create_mesh(1, 1), its step captured as a CUDA graph
                    through the NCCL code path (an all-reduce over one
                    rank launches nothing), bit-equal to the meshless
                    graph run, the graph's collective nodes counted, and
                    `vtd-torch train --distributed` for one epoch.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with each kernel's shape, launches, error, times (its own, its plain
version's and, where one PyTorch call computes the same function, that
call's), its bound with the peak rate it uses and, for the three kernels
an exported program calls, its launches per exported call, for the four
flash kernels and the dropout kernel of the train step their launches in
the CUDA-graph fits (``launches_graph``), the ring's blocks (the
fp32-output instance) and a tensor-parallel rank's mapped flash and
dropout launches (``*_sharded``), and as the last line
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
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings

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
        dropout, flash_attention as fa, fused_ffn, fused_ln, quantization)

    sources = [fa.FWD_SOURCE, fa.BWD_SOURCE, quantization.SOURCE,
               fused_ln.SOURCE, fused_ffn.SOURCE, dropout.SOURCE]
    tic = time.monotonic()
    _build.load_libraries(sources)
    seconds = round(time.monotonic() - tic, 3)
    ptxas = {source: [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line]
             for source, log in _build.BUILD_LOGS.items()}
    _require(set(ptxas) == set(sources), f"built {sorted(ptxas)}")
    hmma = {source: _tensor_core_instructions(_build.library_path(source))
            for source in (fa.FWD_SOURCE, fa.BWD_SOURCE)}
    # 12 instances each (type x head dim 48, 64, 128 x dropout); the
    # backward's dq kernel adds its own 12 ("_dq") and the partials route
    # 6 in fp32 ("_partials").
    for source, counts in hmma.items():
        _require(len(counts) == (30 if source == fa.BWD_SOURCE else 12)
                 and sum(counts.values()) > 0,
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
    SASS (cuobjdump from nvcc's toolkit), by "<type>_d<head dim>[_drop]",
    "_dq" after the backward's dq kernel's, "_partials" after the dk/dv
    kernel's that also forms the dq partials (fp32)."""
    from vision_transformer_detector_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : \S*flash_(fwd|bwd)(_dq)?_kernelI"
                          r"(13__nv_bfloat16|f)Li(\d+)ELb([01])E(Lb1E)?",
                          line)
        if found:
            kind, dq, dtype, dim, drop, flag = found.groups()
            partials = kind == "bwd" and flag
            name = (f"{'fp32' if dtype == 'f' else 'bf16'}_d{dim}"
                    f"{'_drop' if drop == '1' else ''}{dq or ''}"
                    f"{'_partials' if partials else ''}")
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


B2_REPEATS = 10   # launches of each B2 instance on the same inputs
# B2's times before its dq adds were ordered, at the same shapes (PERF.md,
# PR 5's chip_smoke.py run, NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's.
B2_UNORDERED_MS = {"fp32_64x1296x40": 1.768, "bf16_2048x256x64": 0.743,
                   "bf16_2048x256x64_drop": 0.7788}


def _b2_repeats(q, k, v, g, lse, delta, layout, drop=None,
                route=None) -> dict:
    """B2_REPEATS launches of the backward operator on the same inputs,
    by the dq route the dtype selects or the named one: dq (fp32, as the
    kernels sum it), dk and dv must be bit-equal to the first launch's."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    padded = [fa._pad_head_dim(t) for t in (q, k, v, g)]
    seed, rate = drop or (None, 0.0)

    def run():
        return torch.ops.vtd_torch.flash_attention_bwd(
            *padded, lse, delta, layout, seed, rate, fa.DQ_ROUTES[route])

    first = run()
    differ = {"dq": 0, "dk": 0, "dv": 0}
    for _ in range(B2_REPEATS - 1):
        for name, a, b in zip(differ, run(), first):
            differ[name] += int(not torch.equal(a, b))
    torch.cuda.synchronize()
    _require(not any(differ.values()),
             f"B2 {tuple(q.shape)} {q.dtype} dropout={drop is not None}: "
             f"launches that differ from the first, per gradient: {differ}")
    (b, h, n), _ = fa._axes(padded[0], layout)
    return {"launches": B2_REPEATS, "bit_equal": True,
            "route": fa.dq_route(q.dtype, fa.DQ_ROUTES[route],
                                 fa.partials_bytes(b, h, n,
                                                   padded[0].shape[-1]))}


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
    # Grads, relative to the largest: fp32 2e-5 (summation order); bf16
    # 2e-2 (p and ds round to bf16 at other points), the JAX package's
    # kernel contract.
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

    # Times at the reference_608 batch-8 shape, kernel against plain; B2
    # bit-equal over repeated launches there first.
    q, k, v, g = inputs("bnhk", (8, 1296, 8, 40), torch.float32)
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            "bnhk").contiguous()
    # Both dq routes in fp32: each bit-equal over its launches, and the
    # one the dtype does not select within the same tolerance of the plain
    # version, timed beside it below.
    repeats = {"selected": _b2_repeats(q, k, v, g, lse, delta, "bnhk")}
    other = ("split" if repeats["selected"]["route"] == "partials"
             else "partials")
    repeats[other] = _b2_repeats(q, k, v, g, lse, delta, "bnhk", route=other)
    plain = fa.reference_attention_backward(q, k, v, g)
    other_err = max(_rel_err(a, b) for a, b in zip(
        fa._launch_backward(q, k, v, g, lse, delta, "bnhk", route=other),
        plain))
    _require(other_err <= grad_tol[torch.float32],
             f"backward by the {other} route: rel err {other_err}")
    errors["64x1296x40_float32_bnhk"][f"{other}_route_bwd_rel"] = other_err
    del plain
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
            f"{other}_ms": lambda: fa._launch_backward(
                q, k, v, g, lse, delta, "bnhk", route=other),
            "library_ms": lambda: torch.autograd.grad(
                lib_out, lib_leaves, heads[3], retain_graph=True)}, 10),
        "fwd_bwd": _in_turns({"plain_ms": lambda: step(False),
                              "kernel_ms": lambda: step(True),
                              "library_ms": lambda: lib_step(backend)}, 5),
    }
    _report("kernel_train", errors=errors,
            b2_repeats_fp32_64x1296x40=repeats,
            times_fp32_64x1296x40=times, b2_unordered_ms=B2_UNORDERED_MS[
                "fp32_64x1296x40"], sdpa_backend=backend.name)
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
    # The seed lies in device memory, where the kernels read it (as in the
    # model, which hands them views of its seed table).
    seed = fa.seed_tensor(DROP_SEED, "cuda")
    drop = (seed, DROP_RATE)
    kw = {"dropout_rate": DROP_RATE, "dropout_seed": seed}

    def inputs(layout, shape, dtype):
        """Scaled q, k, v and a cotangent g in ``layout`` order, contiguous
        (the model's heads-major window fold is a contiguous copy)."""
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      for _ in range(4))
        return [t.to(dtype) for t in (q.mul(shape[-1] ** -0.5), k, v, g)]

    # Tolerances as in kernel_train: out and grads relative to the largest
    # value, fp32 2e-5 (summation order), bf16 2e-2 (p and ds round to
    # bf16 at other points); lse fp32 1e-4 absolute.
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
    repeats = {"bf16_2048x256x64_drop": _b2_repeats(q, k, v, g, lse, delta,
                                                    "bhnk", drop)}
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
    repeats["bf16_2048x256x64"] = _b2_repeats(q, k, v, g, lse, delta, "bhnk")
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
            b2_repeats=repeats, times_bf16_2048x256x64=times,
            b2_unordered_ms={name: B2_UNORDERED_MS[name] for name in (
                "bf16_2048x256x64", "bf16_2048x256x64_drop")},
            sdpa_backend=backend.name,
            sdpa_backend_no_dropout=shipped_backend.name)
    return errors["2048x256x64_bfloat16_bhnk"], times


MLP_DROP_SHAPES = ((8, 4096, 2048), (8, 4096, 1024))   # highres_1024 b8


def phase_kernel_mlp_drop():
    """The MLP/head dropout kernel (csrc/dropout.cu) against its plain
    version on the card, forward and backward through autograd, from a
    seed in device memory: bit for bit at highres_1024's two pyramid
    layers at batch 8 (bf16, 16-byte chunks), a ragged row and a
    misaligned fp32 view (one element at a time); times at the first
    layer in turns with the plain version and F.dropout (another RNG: the
    same function in distribution)."""
    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch.kernels import (
        dropout as dk, flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    seed = fa.seed_tensor(DROP_SEED, "cuda")
    cases = [(shape, torch.bfloat16, 0) for shape in MLP_DROP_SHAPES]
    cases += [((3, 77, 517), torch.bfloat16, 0),
              ((5, 130), torch.float32, 1)]
    errors = {}
    for shape, dtype, offset in cases:
        name = "x".join(map(str, shape)) + f"_{str(dtype)[6:]}" + (
            "_misaligned" if offset else "")
        n = 1
        for size in shape:
            n *= size
        x = torch.randn(n + offset, device="cuda", generator=gen).to(dtype)
        x = x[offset:].reshape(shape).requires_grad_()
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        before = dk.dropout.launches
        out = dk.dropout(x, seed, DROP_RATE)
        (grad,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
        _require(dk.dropout.launches == before + 2,
                 f"dropout {name}: {dk.dropout.launches - before} launches")
        want = dk.dropout_reference(x, seed, DROP_RATE)
        (want_grad,) = torch.autograd.grad(want, x, g)
        kept = dk.dropout_mask(seed, shape, DROP_RATE, "cuda")
        mismatches = int(((out != 0) != (kept & (x != 0))).sum())
        err = max(_max_err(out, want), _max_err(grad, want_grad))
        _require(mismatches == 0 and err == 0.0,
                 f"dropout {name}: {mismatches} mask mismatches, max abs "
                 f"error {err} (bit-equal expected)")
        errors[name] = {"max_abs_err": err, "mask_mismatches": mismatches,
                        "keep_rate": kept.float().mean().item()}
        del x, g, out, grad, want, want_grad, kept

    x = torch.randn(MLP_DROP_SHAPES[0], device="cuda",
                    generator=gen).to(torch.bfloat16)
    times = _in_turns({
        "plain_ms": lambda: dk.dropout_reference(x, seed, DROP_RATE),
        "kernel_ms": lambda: dk.dropout(x, seed, DROP_RATE),
        "library_ms": lambda: F.dropout(x, DROP_RATE, training=True)}, 10)
    del x
    _report("kernel_mlp_drop", rate=DROP_RATE, seed=DROP_SEED, errors=errors,
            tolerance="bit-equal", times=times,
            time_shape=list(MLP_DROP_SHAPES[0]))
    return errors, times


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
            "kernel_ms": lambda: fused_ffn.fused_dense_mish(x32, w32, b32),
            "unfused_library_ms": lambda: addmm_mish(x32, w32, b32)},
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
        dropout as dk, flash_attention as fa, fused_ffn, fused_ln,
        quantization as qz)

    return {"flash": fa.flash_attention.launches,
            "flash_lse": fa.flash_attention.lse_launches,
            "flash_drop": fa.flash_attention.drop_launches,
            "flash_bwd": fa.flash_attention.backward_launches,
            "flash_bwd_drop": fa.flash_attention.backward_drop_launches,
            "int8_fused": qz.fused_int8_dense.launches,
            "int8_dense": qz.int8_dense.launches,
            "layer_norm": fused_ln.fused_layer_norm.launches,
            "dense_mish": fused_ffn.fused_dense_mish.launches,
            "mlp_drop": dk.dropout.launches,
            # Of the three above, the launches on tensor-core instances.
            "int8_fused_tc": qz.fused_int8_dense.tensor_core_launches,
            "int8_dense_tc": qz.int8_dense.tensor_core_launches,
            "dense_mish_tc": fused_ffn.fused_dense_mish.tensor_core_launches}


def _reset_counts() -> None:
    from vision_transformer_detector_tpu_torch.kernels import (
        dropout as dk, flash_attention as fa, fused_ffn, fused_ln,
        quantization as qz)

    for fn, names in ((fa.flash_attention,
                       ("launches", "lse_launches", "drop_launches",
                        "backward_launches", "backward_drop_launches")),
                      (qz.fused_int8_dense,
                       ("launches", "tensor_core_launches")),
                      (qz.int8_dense, ("launches", "tensor_core_launches")),
                      (fused_ln.fused_layer_norm, ("launches",)),
                      (dk.dropout, ("launches",)),
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


def _post_jpegs(base: str, jpegs, num_classes: int) -> list:
    """POST each ``(size, bytes)`` JPEG to ``base``/predict and check the
    answer; the request latencies in ms."""
    latencies = []
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
        _check_detections(result, size, num_classes)
    return latencies


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
        flash_attention.launches = 0
        latencies = _post_jpegs(base, _jpegs(REQUESTS), config.num_classes)
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


def _device_path_ms(services: dict, batches=(1, 32), reps=None) -> dict:
    """Median device-path time (predict_raw + the packed result on the
    host, synced) of each service, at each batch, taken in turns (a, b,
    ..., b, a) so that every service sees the same card state; ``reps``
    calls per service (default 20 at batch 1, 5 above)."""
    import numpy as np

    times = {}
    for batch in batches:
        some = next(iter(services.values()))
        canvas = np.zeros((batch, *some.config.image_size, 3), np.uint8)
        count = reps or (20 if batch == 1 else 5)
        samples = {name: [] for name in services}
        order = list(services) + list(services)[::-1]
        for name in order:
            service = services[name]
            for _ in range(2):
                service.raw_to_detections(service.predict_raw(canvas))
            for _ in range(count // 2):
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
        _reset_counts()
        latencies = _post_jpegs(base, _jpegs(REQUESTS), config.num_classes)
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
    # CPU and the card through 8 blocks. The attention key bias's gradient is zero in exact
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
    # moments are compared directly).
    images8, labels8 = (torch.from_numpy(a).to("cuda") for a in data[0])
    saved = {"params": {n: t.clone() for n, t in
                        state["params"].state_dict().items()},
             "count": int(state["opt_state"]["count"]),
             **{m: {n: t.clone() for n, t in state["opt_state"][m].items()}
                for m in ("mu", "nu")}}
    with tempfile.TemporaryDirectory() as tmp:
        trainer.checkpoint_dir = tmp
        trainer.save(state, name="smoke")
        _, loss_a = trainer.train_step(state, images8, labels8)
        state = trainer.restore(state, name="smoke")
    _require(state["step"] == TRAIN_STEPS
             and int(state["opt_state"]["count"]) == saved["count"],
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
    # other orders through 2 full-width blocks.
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
    # the forward is the same computation (equal loss); the grads are held
    # within 1e-4 of each other.
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
    # remat recompute, and the backward with the replay; each pyramid
    # layer's dropout in the forward and the backward, and in the
    # recompute all but the block's last (the non-reentrant checkpoint
    # stops recomputing once it has every tensor the backward saved, and
    # the last dropout's output feeds only the residual add); each head
    # MLP layer's in the forward and the backward; the eval: one forward
    # without lse or dropout per block.
    layers = config.encoder_mlp_layers
    head_layers = len(config.head_units) * config.head_block_repeats
    want = dict({name: 0 for name in launches},
                flash=blocks, flash_drop=2 * blocks * HIGHRES_STEPS,
                flash_bwd_drop=blocks * HIGHRES_STEPS,
                mlp_drop=(blocks * (3 * layers - 1) + 2 * head_layers)
                * HIGHRES_STEPS)
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


WINDOW_EPOCHS = 12       # train_window (a): epochs of each of the two fits
WINDOW_CALL = 4          # epochs_per_call of the graph loop
BF16_STEP_TOL = 2 ** -7  # one bf16 rounding: a step's loss, across paths


def _graph_kernel_nodes(graphs, tag: str) -> dict:
    """Kernel nodes of each captured train-step graph (debug mode), read
    from its DOT dump: {graph: {fwd, fwd_drop, bwd, bwd_drop, bwd_dq,
    bwd_dq_drop, bwd_dq_sum, mlp_drop, kernels, replays}}, the flash
    kernels by symbol (template flag ``Lb1E``: the dropout instance;
    ``bwd_dq`` the split route's dq kernel and ``bwd_dq_sum`` the partials
    route's sum kernel, one of the two beside each ``bwd``), the MLP/head
    dropout kernel's, ``kernels`` every kernel node and ``replays`` the
    graph's replays so far."""
    node = re.compile(r'^"(graph_\d+_node_\d+)"\[', re.M)
    symbol = re.compile(
        r"flash_(fwd|bwd|bwd_dq|bwd_dq_sum)_kernelI\w*?(?:L(?:b([01]))E|EE)")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, step_graph in graphs.items():
            name = f"{tag}_{'update' if key[-1] else 'micro'}"
            path = os.path.join(tmp, name + ".dot")
            step_graph.graph.debug_dump(path)
            with open(path) as f:
                text = f.read()
            starts = [m.start() for m in node.finditer(text)] + [len(text)]
            counts = dict.fromkeys(("fwd", "fwd_drop", "bwd", "bwd_drop",
                                    "bwd_dq", "bwd_dq_drop", "bwd_dq_sum",
                                    "mlp_drop", "kernels"), 0)
            for begin, end in zip(starts, starts[1:]):
                block = text[begin:end]
                if "{KERNEL" not in block:
                    continue
                counts["kernels"] += 1
                counts["mlp_drop"] += "dropout_kernel" in block
                match = symbol.search(block)
                if match:
                    kind = match.group(1)
                    counts[kind + ("_drop" if match.group(2) == "1"
                                   else "")] += 1
            counts["replays"] = step_graph.replays
            # Each backward launches its dk/dv kernel and its dq or sum
            # kernel (the sum kernel has no dropout instance).
            _require(counts["bwd_dq"] + counts["bwd_dq_drop"]
                     + counts["bwd_dq_sum"]
                     == counts["bwd"] + counts["bwd_drop"],
                     f"{name}: backward kernel nodes without their dq "
                     f"kernel: {counts}")
            result[name] = counts
    return result


def _graph_launches(nodes: dict) -> dict:
    """Launches of each kernel kind made by replaying the graphs: kernel
    nodes times replays, summed over the graphs."""
    kinds = ("fwd", "fwd_drop", "bwd", "bwd_drop", "mlp_drop")
    return {kind: sum(n[kind] * n["replays"] for n in nodes.values())
            for kind in kinds}


def _median_step_ms(run, steps: int, per_call: int = 1) -> float:
    """Median ms per train step over ``steps`` timed calls of ``run`` (each
    ``per_call`` steps), each ended by a synchronize."""
    import numpy as np
    import torch

    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - tic) * 1e3 / per_call)
    return float(np.median(times))


def phase_train_window():
    """The windowed train loop, Trainer.fit(epochs_per_call > 1), whose
    make_multi_step captures the train step as a CUDA graph and replays
    it, against the per-epoch eager loop from the same seeded state:
    (a) reference_608, fp32, batch 8: 12 epochs, windows of 4 with an eval
    and checkpoint cadence (eval at 2, 5, 8, 11; checkpoints at 0, 3, 6, 9,
    11) that cuts them, per-epoch losses and the parameters after the fit
    bit-equal, graph against loop and a second eager loop against the
    first, the same AP records, the window cuts at the event epochs; (b)
    highres_1024, bf16, dropout 0.1, remat None, batch 8, lr 1e-5, 8
    steps: the graph's seed rows equal the loop's draws, every step's loss
    bit-equal, graph against loop, a second eager loop against the first
    and a third run under torch.use_deterministic_algorithms (the ops it
    warns about listed), and a planted stale seed buffer that fails that
    comparison; (c) each
    graph's flash kernel nodes, 8 + 8 per reference_608 step and 48 + 24
    per highres_1024 step, and the launches they make (nodes x replays);
    (d) accumulate_steps=2 at depth 2 (a micro and an update graph)
    against the loop; (e) "alternate" remat at depth 2 with dropout
    captures and matches the loop. Median ms per step of both loops."""
    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        seed_table_size)
    from vision_transformer_detector_tpu_torch.train import (
        trainer as trainer_module)
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, draw_seed_row, make_multi_step)

    loss_config = LossConfig()

    def pair(config, train_config, data, epochs, per_call, ckpt=False,
             eval_data=None, names=("loop", "graph")):
        """Loop and graph runs (those of ``names``) from one seed; returns
        their trainers and states, the graph trainer's multi-step built in
        debug mode."""
        runs = {}
        for name, k in (("loop", 1), ("graph", per_call)):
            if name not in names:
                continue
            tmp = tempfile.mkdtemp() if ckpt else None
            trainer = Trainer(config, loss_config, train_config,
                              checkpoint_dir=tmp, device="cuda")
            if k > 1:
                trainer.multi_step = make_multi_step(
                    config, loss_config, trainer.optimizer,
                    debug_graphs=True)
            state = trainer.init_state()
            _reset_counts()
            torch.cuda.synchronize()
            tic = time.perf_counter()
            state = trainer.fit(state, data, epochs=epochs,
                                eval_data=eval_data, epochs_per_call=k)
            torch.cuda.synchronize()
            runs[name] = (trainer, state, time.perf_counter() - tic,
                          _counts(), tmp)
        return runs

    # (a) reference_608 at full width.
    config = get_config("reference_608")
    train_config = TrainConfig(learning_rate=8e-5, seed=SEED,
                               epochs_warm_up=2, skip_epochs=3)
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 2))
    runs = pair(config, train_config, data, WINDOW_EPOCHS, WINDOW_CALL,
                ckpt=True, eval_data=data)
    (loop, loop_state, loop_s, loop_counts, loop_dir) = runs["loop"]
    (graph, graph_state, graph_s, graph_counts, graph_dir) = runs["graph"]
    (again, again_state, _, _, again_dir) = pair(
        config, train_config, data, WINDOW_EPOCHS, WINDOW_CALL, ckpt=True,
        eval_data=data, names=("loop",))["loop"]
    events = [e for e in range(WINDOW_EPOCHS)
              if graph._is_event_epoch(e, WINDOW_EPOCHS, True)]
    cuts = [start + n - 1 for start, n in graph.window_record]
    _require(set(events) <= set(cuts) and all(
        n <= WINDOW_CALL for _, n in graph.window_record)
        and sum(n for _, n in graph.window_record) == WINDOW_EPOCHS,
        f"window cuts {graph.window_record} vs event epochs {events}")
    # Every kernel of the step is deterministic (B2 sums dq in key order),
    # so the windowed graph and a second eager loop repeat the loop's
    # per-epoch losses bit for bit.
    _require(graph.loss_record == loop.loss_record
             and again.loss_record == loop.loss_record,
             f"per-epoch losses: graph {graph.loss_record}, a second loop "
             f"{again.loss_record} vs loop {loop.loss_record}")
    _require(graph.ap_record == loop.ap_record
             and len(graph.ap_record) == 4,
             f"AP records: graph {graph.ap_record} vs loop {loop.ap_record}")
    _require(graph_state["step"] == loop_state["step"] == WINDOW_EPOCHS
             and int(graph_state["opt_state"]["count"]) == WINDOW_EPOCHS,
             "step counts")
    _require(sorted(os.listdir(graph_dir)) == sorted(os.listdir(loop_dir)),
             f"checkpoints {os.listdir(graph_dir)} vs {os.listdir(loop_dir)}")
    _require(graph_counts["flash_lse"] > 0 and graph_counts["flash_bwd"] > 0,
             f"the graph run launched no flash kernel: {graph_counts}")
    # The parameters after the fit, bit for bit (the eval records above
    # are all 0.0 this early in training, so they alone would not tell two
    # trajectories apart).
    loop_params = loop_state["params"].state_dict()
    param_differ = {
        name: sum(int(not torch.equal(t, loop_params[n]))
                  for n, t in state["params"].state_dict().items())
        for name, state in (("graph", graph_state), ("loop_again",
                                                     again_state))}
    _require(not any(param_differ.values()), "parameters after the fit "
             f"differ from the loop's, tensors per run: {param_differ}")
    del loop_params, again, again_state
    shutil.rmtree(again_dir)
    ref_nodes = _graph_kernel_nodes(graph.multi_step.graphs,
                                    "reference_608")
    _require(len(ref_nodes) == 1 and all(
        n["fwd"] == n["bwd"] == config.encoder_blocks
        and n["fwd_drop"] == n["bwd_drop"] == n["mlp_drop"] == 0
        for n in ref_nodes.values()),
        f"reference_608 graph flash nodes {ref_nodes}")
    ref_launches = _graph_launches(ref_nodes)
    _require(ref_launches["fwd"] == ref_launches["bwd"]
             == config.encoder_blocks * WINDOW_EPOCHS,
             f"reference_608 graph launches {ref_launches}")
    images, labels = (t[None] for t in graph._put_batch(*data[0]))
    ref_ms = {
        "loop": _median_step_ms(lambda: loop.train_step(
            loop_state, images[0], labels[0]), 10),
        "graph": _median_step_ms(lambda: graph.multi_step(
            graph_state, images, labels, 4), 5, per_call=4)}
    window_a = {"losses": {"graph": graph.loss_record,
                           "loop": loop.loss_record},
                "losses_bit_equal": {"graph": True, "loop_again": True},
                "params_bit_equal": {"graph": True, "loop_again": True},
                "ap": {"graph": graph.ap_record, "loop": loop.ap_record},
                "window_cuts": graph.window_record, "event_epochs": events,
                "fit_seconds": {"graph": graph_s, "loop": loop_s},
                "graph_nodes": ref_nodes,
                "launches_graph": {"flash_lse": ref_launches["fwd"],
                                   "flash_bwd": ref_launches["bwd"]},
                "launches_at_capture": graph_counts,
                "launches_loop": loop_counts,
                "step_ms_median": ref_ms}
    for directory in (loop_dir, graph_dir):
        shutil.rmtree(directory)
    del runs, loop, graph, loop_state, graph_state, images, labels

    # (b) highres_1024 with dropout, remat None, bf16, batch 8, at
    # train_highres' lr 1e-5. Every kernel of the step is deterministic
    # (B2 sums dq in key order; the dropout masks are a hash of the seed
    # row), so a run repeats bit for bit: graph against loop, a second
    # eager loop, and a third under torch.use_deterministic_algorithms,
    # whose warnings name any PyTorch op without a deterministic version.
    # A graph that replays another seed row than the loop's draws other
    # masks; a planted fault shows that the comparison fails when the
    # graph's seed buffer is not written before a replay.
    config = get_config("highres_1024").replace(dropout=DROP_RATE,
                                                remat_policy=None)
    train_config = TrainConfig(learning_rate=1e-5, seed=SEED,
                               skip_epochs=0)
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 1))

    def compare(graph_losses, loop_losses):
        """(b)'s loss comparison: (passed, relative error per step)."""
        err = [abs(a - b) / abs(b) for a, b in zip(graph_losses,
                                                   loop_losses)]
        return list(graph_losses) == list(loop_losses), err

    runs = pair(config, train_config, data, HIGHRES_STEPS, HIGHRES_STEPS)
    (loop, loop_state, loop_s, loop_counts, _) = runs["loop"]
    (graph, graph_state, graph_s, graph_counts, _) = runs["graph"]
    chain = {"dropout_rng": torch.Generator().manual_seed(
        train_config.seed + 1)}
    want_rows = np.stack([draw_seed_row(chain, config)
                          for _ in range(HIGHRES_STEPS)])
    rows = graph.multi_step.seed_rows
    _require(rows is not None and rows.shape == (
        HIGHRES_STEPS, seed_table_size(config))
        and np.array_equal(rows, want_rows),
        "the graph's seed rows are not the loop's draws")
    # What the graph read last: its static seed buffer holds the last
    # step's row.
    (step_graph,) = graph.multi_step.graphs.values()
    buffer_row = step_graph.seeds.to(torch.int64).cpu().numpy()
    _require(np.array_equal(buffer_row, want_rows[-1]),
             "the graph's seed buffer does not hold the last step's row")
    _require(loop_counts["flash_drop"] == 2 * config.encoder_blocks
             * HIGHRES_STEPS, f"loop launches {loop_counts}")
    passed, highres_err = compare(graph.loss_record, loop.loss_record)
    _require(passed, f"highres losses: graph {graph.loss_record} vs loop "
             f"{loop.loss_record}")
    # A second eager loop, and a third with PyTorch's deterministic
    # algorithms on (warn_only: an op without a deterministic version
    # warns and runs), each bit-equal to the first.
    again = pair(config, train_config, data, HIGHRES_STEPS, 1,
                 names=("loop",))["loop"][0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            strict = pair(config, train_config, data, HIGHRES_STEPS, 1,
                          names=("loop",))["loop"][0]
        finally:
            torch.use_deterministic_algorithms(False)
    nondeterministic_ops = sorted({str(w.message).splitlines()[0][:200]
                                   for w in caught})
    for name, run in (("a second loop", again), ("a deterministic-"
                                                 "algorithms loop", strict)):
        _require(compare(run.loss_record, loop.loss_record)[0],
                 f"highres losses: {name} {run.loss_record} vs loop "
                 f"{loop.loss_record} (warnings under deterministic "
                 f"algorithms: {nondeterministic_ops})")
    del again, strict
    hi_nodes = _graph_kernel_nodes(graph.multi_step.graphs, "highres_1024")
    blocks = config.encoder_blocks
    mlp_per_step = loop_counts["mlp_drop"] // HIGHRES_STEPS
    _require(len(hi_nodes) == 1 and all(
        n["fwd_drop"] == 2 * blocks and n["bwd_drop"] == blocks
        and n["fwd"] == n["bwd"] == 0 and n["mlp_drop"] == mlp_per_step > 0
        for n in hi_nodes.values()),
        f"highres_1024 graph dropout nodes {hi_nodes} (the loop's MLP "
        f"dropout launches per step: {mlp_per_step})")
    hi_launches = _graph_launches(hi_nodes)
    _require(hi_launches["fwd_drop"] == 2 * blocks * HIGHRES_STEPS
             and hi_launches["bwd_drop"] == blocks * HIGHRES_STEPS
             and hi_launches["mlp_drop"] == loop_counts["mlp_drop"],
             f"highres_1024 graph launches {hi_launches}")
    images, labels = (t[None] for t in graph._put_batch(*data[0]))
    hi_ms = {
        "loop": _median_step_ms(lambda: loop.train_step(
            loop_state, images[0], labels[0]), 5),
        "graph": _median_step_ms(lambda: graph.multi_step(
            graph_state, images, labels, 2), 3, per_call=2)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loop_losses = loop.loss_record
    window_b = {"losses": {"graph": graph.loss_record, "loop": loop_losses},
                "learning_rate": train_config.learning_rate,
                "losses_bit_equal": {"graph": True, "loop_again": True,
                                     "deterministic_algorithms": True},
                "deterministic_algorithms_warnings": nondeterministic_ops,
                "loss_rel_err": highres_err, "seed_rows_equal": True,
                "seed_rows_shape": list(rows.shape),
                "seed_buffer_is_last_row": True,
                "fit_seconds": {"graph": graph_s, "loop": loop_s},
                "graph_nodes": hi_nodes,
                "launches_graph": {"flash_drop": hi_launches["fwd_drop"],
                                   "flash_bwd_drop": hi_launches["bwd_drop"],
                                   "mlp_drop": hi_launches["mlp_drop"]},
                "launches_at_capture": graph_counts,
                "launches_loop": loop_counts,
                "step_ms_median": hi_ms, "peak_memory_gib": peak_gib}
    del runs, loop, graph, loop_state, graph_state, images, labels
    del step_graph

    # The planted fault: replays that leave the seed buffer as captured
    # (zeros), as a graph that baked its capture-time seed would run.
    sound_replay = trainer_module._StepGraph.replay
    trainer_module._StepGraph.replay = (
        lambda self, images, labels, seeds, loss_out: sound_replay(
            self, images, labels, self.seeds, loss_out))
    try:
        stale = pair(config, train_config, data, HIGHRES_STEPS,
                     HIGHRES_STEPS, names=("graph",))["graph"][0]
    finally:
        trainer_module._StepGraph.replay = sound_replay
    stale_passed, stale_err = compare(stale.loss_record, loop_losses)
    _require(not stale_passed, "the loss comparison passed a graph whose "
             f"seed buffer was never written: {stale.loss_record}")
    window_b["planted_stale_seed_buffer"] = {
        "losses": stale.loss_record, "loss_rel_err": stale_err,
        "comparison_failed": True}
    del stale

    # (d) accumulate_steps=2 at depth 2 (reference_608 widths, fp32): 2
    # batches an epoch, 4 epochs, 4 updates; a micro and an update graph.
    config = get_config("reference_608").replace(encoder_blocks=2)
    train_config = TrainConfig(learning_rate=8e-5, seed=SEED,
                               skip_epochs=0, accumulate_steps=2)
    data = list(synthetic_batches(config, 8, 2, seed=SEED + 3))
    runs = pair(config, train_config, data, 4, 4)
    (loop, loop_state, _, _, _) = runs["loop"]
    (graph, graph_state, _, _, _) = runs["graph"]
    _require(np.allclose(graph.loss_record, loop.loss_record, rtol=2e-5,
                         atol=1e-6), f"accumulation losses: graph "
             f"{graph.loss_record} vs loop {loop.loss_record}")
    params_ok = all(torch.allclose(graph_state["params"].state_dict()[n], t,
                                   rtol=1e-4, atol=1e-5)
                    for n, t in loop_state["params"].state_dict().items())
    _require(params_ok and int(graph_state["opt_state"]["count"]) == 4,
             "accumulation: parameters or update count differ")
    acc_nodes = _graph_kernel_nodes(graph.multi_step.graphs, "accumulate")
    _require(sorted(acc_nodes) == ["accumulate_micro", "accumulate_update"],
             f"accumulation graphs {acc_nodes}")
    window_d = {"losses": {"graph": graph.loss_record,
                           "loop": loop.loss_record},
                "graph_nodes": acc_nodes, "updates": 4}
    del runs, loop, graph, loop_state, graph_state

    # (e) "alternate" remat (the shipped policy) with dropout, depth 2.
    config = get_config("highres_1024").replace(dropout=DROP_RATE,
                                                encoder_blocks=2)
    train_config = TrainConfig(learning_rate=1e-5, seed=SEED,
                               skip_epochs=0)
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 4))
    runs = pair(config, train_config, data, 3, 3)
    loop, graph = runs["loop"][0], runs["graph"][0]
    alt_err = [abs(a - b) / abs(b) for a, b in zip(graph.loss_record,
                                                   loop.loss_record)]
    _require(all(e <= BF16_STEP_TOL * (i + 1) for i, e in enumerate(alt_err)),
             f"alternate remat: graph {graph.loss_record} vs loop "
             f"{loop.loss_record}")
    alt_nodes = _graph_kernel_nodes(graph.multi_step.graphs, "alternate")
    window_e = {"remat_policy": "alternate", "blocks": 2,
                "losses": {"graph": graph.loss_record,
                           "loop": loop.loss_record},
                "graph_nodes": alt_nodes}
    del runs, loop, graph
    _report("train_window", reference_608=window_a, highres_1024=window_b,
            accumulate=window_d, alternate=window_e)
    return {"flash_lse": window_a["launches_graph"]["flash_lse"],
            "flash_bwd": window_a["launches_graph"]["flash_bwd"],
            "flash_drop": window_b["launches_graph"]["flash_drop"],
            "flash_bwd_drop": window_b["launches_graph"]["flash_bwd_drop"],
            "mlp_drop": window_b["launches_graph"]["mlp_drop"],
            "step_ms_graph": {"reference_608": ref_ms["graph"],
                              "highres_1024": hi_ms["graph"]}}


LIFECYCLE_IMAGES = 8     # seeded JPEGs of the lifecycle phase, one box each
# Custom-operator nodes of one exported vit_b16_384 graph with the fused
# dense+mish and the fused LayerNorm, and so the launches per exported
# call: one flash forward per block, 24 + 3 dense+mish, two LayerNorms per
# block.
EXPORTED_OPS = {"flash_attention_fwd": 12, "dense_mish": 27, "layer_norm": 24}
EXPORTED_COUNTS = {"flash": 12, "dense_mish": 27, "layer_norm": 24,
                   "dense_mish_tc": 27}


def _lifecycle_dataset(root: str) -> dict:
    """LIFECYCLE_IMAGES seeded JPEGs of other aspect ratios than 384 x 384
    (so each is letterboxed), each with one filled box, and their
    annotation dict ({image_id: [[coco_id, cx, cy, h, w, area]]})."""
    import numpy as np
    from PIL import Image, ImageDraw

    images = os.path.join(root, "images")
    os.makedirs(images)
    rng = np.random.default_rng(SEED)
    sizes = ((320, 480), (400, 300), (288, 512), (360, 360))
    annotations = {}
    for i in range(LIFECYCLE_IMAGES):
        h, w = sizes[i % len(sizes)]
        img = Image.new("RGB", (w, h), tuple(int(c) for c in
                                             rng.integers(0, 80, 3)))
        bw, bh = int(rng.integers(w // 5, w // 2)), int(
            rng.integers(h // 5, h // 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        ImageDraw.Draw(img).rectangle((x0, y0, x0 + bw, y0 + bh),
                                      fill=(250, 220, 30))
        img.save(os.path.join(images, f"{i + 1:012d}.jpg"), quality=92)
        annotations[str(i + 1)] = [[(1, 3, 18)[i % 3], x0 + bw / 2,
                                    y0 + bh / 2, float(bh), float(bw),
                                    float(bw * bh)]]
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(annotations, f)
    return {"images": images, "annotations": path, "rows": annotations}


def _cli(argv) -> dict:
    """One `vtd-torch` subcommand through cli.main; its last stdout line."""
    import contextlib

    from vision_transformer_detector_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _protocol_valid(summary: dict, what: str) -> None:
    for key in ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100"):
        value = summary[key]
        _require(value == -1.0 or 0.0 <= value <= 1.0,
                 f"{what}: {key} = {value}")
    _require(summary["AP"] <= summary["AP50"] or summary["AP50"] == -1.0,
             f"{what}: AP {summary['AP']} > AP50 {summary['AP50']}")


def _graph_ops(path: str) -> dict:
    """Node counts of a saved program by operator name (namespace::op)."""
    import collections

    import torch

    program = torch.export.load(path)
    counts = collections.Counter()
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            counts[node.target.name().split(".")[0]] += 1
    return dict(counts)


# Run in a fresh process: serve the artifact over HTTP with the batcher,
# post the JPEGs one after another, and report the kernels' launches, the
# answers, /stats and every loaded module of the port's models package
# (which must be none).
_ARTIFACT_SERVER = r"""
import json, sys, urllib.request
from vision_transformer_detector_tpu_torch.serving import (
    DetectionServer, ExportedDetectionService)
from vision_transformer_detector_tpu_torch.kernels import (
    flash_attention as fa, fused_ffn, fused_ln)

artifact, paths = sys.argv[1], sys.argv[2:]
service = ExportedDetectionService(artifact, score_threshold=-1.0)
server = DetectionServer(service, port=0, batching=True, max_batch=8)
server.start()
try:
    for fn, names in ((fa.flash_attention, ("launches", "lse_launches",
                                            "backward_launches")),
                      (fused_ffn.fused_dense_mish,
                       ("launches", "tensor_core_launches")),
                      (fused_ln.fused_layer_norm, ("launches",))):
        for name in names:
            setattr(fn, name, 0)
    base = f"http://127.0.0.1:{server.port}"
    answers = []
    for path in paths:
        with open(path, "rb") as f:
            request = urllib.request.Request(
                base + "/predict", data=f.read(),
                headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(request, timeout=300) as response:
            answers.append(json.loads(response.read()))
    counts = {"flash": fa.flash_attention.launches,
              "flash_lse": fa.flash_attention.lse_launches,
              "flash_bwd": fa.flash_attention.backward_launches,
              "dense_mish": fused_ffn.fused_dense_mish.launches,
              "dense_mish_tc": fused_ffn.fused_dense_mish.tensor_core_launches,
              "layer_norm": fused_ln.fused_layer_norm.launches}
    with urllib.request.urlopen(base + "/stats", timeout=60) as response:
        stats = json.loads(response.read())
finally:
    server.stop()
models = sorted(m for m in sys.modules
                if m.startswith("vision_transformer_detector_tpu_torch.models"))
if models:
    raise SystemExit(f"the artifact server imported {models}")
print(json.dumps({"counts": counts, "stats": stats, "answers": answers,
                  "batch_sizes": list(service._exported.batch_sizes),
                  "models": models}))
"""


def _compare_detections(got: list, want: list) -> dict:
    """Served (artifact) against live answers, image by image: the same
    class ids and number of detections, scores within 1e-3 and boxes within
    0.1 px; the largest differences, and whether all were bit-equal."""
    score, box, exact = 0.0, 0.0, True
    for g, w in zip(got, want):
        _require(g["image_size"] == w["image_size"],
                 f"image sizes {g['image_size']} vs {w['image_size']}")
        gd, wd = g["detections"], w["detections"]
        _require([d["class_id"] for d in gd] == [d["class_id"] for d in wd],
                 "artifact and live service disagree on the detections' "
                 "classes or number")
        for a, b in zip(gd, wd):
            score = max(score, abs(a["score"] - b["score"]))
            box = max(box, max(abs(a["box"][k] - b["box"][k])
                               for k in ("cx", "cy", "h", "w")))
            exact = exact and a == b
    _require(score <= 1e-3 and box <= 0.1,
             f"artifact vs live: score diff {score}, box diff {box} px")
    return {"bit_equal": exact, "max_score_diff": score,
            "max_box_diff_px": box}


def phase_cli_tools():
    """`vtd-torch benchmark` (inference on vit_b16_384 at batch 32, train on
    reference_608 at batch 8), `doctor` (exit 0, device ok, every kernel
    library built), `sweep --synthetic` over two learning rates on tiny_96,
    `train --resumable` stopped after a checkpoint and resumed against an
    uninterrupted run (the same step and input position), `train
    --epochs-per-call`, and an async checkpoint of reference_608 written
    while training goes on, bit-equal to the state at save time."""
    import contextlib

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.cli import main as cli_main
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    report = {}
    _reset_counts()
    report["benchmark_inference"] = _cli(
        ["benchmark", "--preset", "vit_b16_384", "--batch-size", "32",
         "--mode", "inference", "--iterations", "10"])
    launches = _counts()
    _require(report["benchmark_inference"]["device"] == "cuda"
             and report["benchmark_inference"]["ms_per_step"] > 0
             and launches["flash"] >= 12 * 11,
             f"benchmark inference {report['benchmark_inference']}, "
             f"launches {launches}")
    _reset_counts()
    report["benchmark_train"] = _cli(
        ["benchmark", "--preset", "reference_608", "--batch-size", "8",
         "--mode", "train", "--iterations", "5"])
    launches = _counts()
    _require(report["benchmark_train"]["device"] == "cuda"
             and launches["flash_lse"] == launches["flash_bwd"] == 8 * 6,
             f"benchmark train {report['benchmark_train']}, "
             f"launches {launches}")
    for line in (report["benchmark_inference"], report["benchmark_train"]):
        print(json.dumps(line), flush=True)

    doctor = _cli(["doctor", "--probe-timeout", "120"])
    _require(doctor["device"]["ok"] and doctor["device"]["capability"]
             == "sm_90" and all(lib["ok"] for lib in
                                doctor["native"]["kernels"].values()),
             f"doctor {doctor}")
    report["doctor"] = doctor

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(["sweep", "--preset", "tiny_96", "--batch-size", "2",
                      "--synthetic", "--epochs", "2",
                      "--sweep", "learning_rate=8e-5,4e-5",
                      "--out-dir", os.path.join(tmp, "sweep")])
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        _require(summary["records"] == 2, f"sweep {summary}")
        report["sweep"] = summary

        data = _lifecycle_dataset(os.path.join(tmp, "data"))

        def train(ckpt, *extra):
            return _cli(["train", "--preset", "tiny_96", "--batch-size", "2",
                         "--train-images", data["images"],
                         "--train-annotations", data["annotations"],
                         "--learning-rate", "1e-4", "--epochs-warm-up", "0",
                         "--skip-epochs", "1", "--checkpoint-dir", ckpt,
                         "--metrics", ckpt + ".jsonl", *extra])

        whole = train(os.path.join(tmp, "whole"), "--resumable",
                      "--epochs", "2")
        part = os.path.join(tmp, "part")
        train(part, "--resumable", "--epochs", "1")
        stopped = _read_json(os.path.join(part, "ongoing.dataset.json"))
        resumed = train(part, "--resumable", "--epochs", "1",
                        "--restore", "ongoing")
        positions = [_read_json(os.path.join(d, "ongoing.dataset.json"))
                     for d in (os.path.join(tmp, "whole"), part)]
        _require(resumed["step"] == whole["step"] == 8
                 and positions[0] == positions[1],
                 f"resumed {resumed} at {positions[1]} vs whole {whole} at "
                 f"{positions[0]}")
        report["resumable"] = {"whole": whole, "resumed": resumed,
                               "stopped_at": stopped,
                               "position": positions[0]}
        window = train(os.path.join(tmp, "window"), "--epochs", "4",
                       "--epochs-per-call", "2")
        _require(window["step"] == 16 and np.isfinite(window["final_loss"]),
                 f"train --epochs-per-call {window}")
        report["epochs_per_call"] = window

        # An async checkpoint of reference_608 at full width, written while
        # two more steps change the parameters in place.
        config = get_config("reference_608")
        trainer = Trainer(config, LossConfig(), TrainConfig(
            learning_rate=8e-5), checkpoint_dir=os.path.join(tmp, "async"),
            async_checkpointing=True, device="cuda")
        state = trainer.init_state()
        images, labels = (torch.from_numpy(a).to("cuda") for a in next(
            synthetic_batches(config, 8, 1, seed=SEED)))
        trainer.train_step(state, images, labels)
        snapshot = {
            "params": {n: t.clone() for n, t in
                       state["params"].state_dict().items()},
            **{m: {n: t.clone() for n, t in state["opt_state"][m].items()}
               for m in ("mu", "nu")}}
        tic = time.perf_counter()
        trainer.save(state, name="async")
        save_s = time.perf_counter() - tic
        for _ in range(2):
            trainer.train_step(state, images, labels)
        trainer.wait_for_checkpoints()
        fresh = Trainer(config, LossConfig(), TrainConfig(
            learning_rate=8e-5), checkpoint_dir=os.path.join(tmp, "async"),
            device="cuda")
        restored = fresh.restore(fresh.init_state(seed=SEED + 9), "async")
        got = {"params": restored["params"].state_dict(),
               "mu": restored["opt_state"]["mu"],
               "nu": restored["opt_state"]["nu"]}
        for part_name, tensors in snapshot.items():
            _require(all(torch.equal(got[part_name][n], t)
                         for n, t in tensors.items()),
                     f"async checkpoint: {part_name} differ")
        _require(restored["step"] == 1
                 and int(restored["opt_state"]["count"]) == 1,
                 "async checkpoint: step")
        report["async_checkpoint"] = {"bit_equal": True,
                                      "save_call_s": save_s,
                                      "moved_on_steps": 2}
        del trainer, fresh, state, restored, snapshot, got
    _report("cli_tools", **report)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def phase_lifecycle():
    """The deployment lifecycle at vit_b16_384's full width (bf16, flash,
    the fused dense+mish and, at inference, the fused LayerNorm), each
    step through `vtd-torch`: (a) train 2 epochs at batch 4 on 8 seeded
    JPEGs; (b)
    evaluate --protocol coco-original with a dump, score-coco of the dump,
    and a perfect detector; (c) export the final checkpoint on CUDA as a
    (1, 8) bundle with a baked postprocess, and count the custom-operator
    nodes of each graph; (d) serve the artifact from a process that never
    imports models/, 8 POSTs, the kernels' launches per request; (e) the
    answers against the live service on the same weights; (f) device-path
    times of the artifact and the live service at batch 1 and 8."""
    import argparse

    import numpy as np

    from vision_transformer_detector_tpu_torch import cli
    from vision_transformer_detector_tpu_torch import config as port_config
    from vision_transformer_detector_tpu_torch.metrics.coco_eval import (
        score_coco_results)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService, ExportedDetectionService)

    base = port_config.get_config("vit_b16_384")
    _require(base.compute_dtype == "bfloat16" and base.use_flash_attention
             and base.embedding_dim == 768 and base.num_patches == 576,
             "vit_b16_384 preset changed")
    config = base.replace(use_fused_layer_norm=True)
    model = ["--preset", "vit_b16_384", "--fused-ffn"]
    tic = time.monotonic()
    with tempfile.TemporaryDirectory() as root:
        data = _lifecycle_dataset(root)
        ckpt = os.path.join(root, "ckpt")
        artifact = os.path.join(root, "artifact")
        common = [*model, "--checkpoint-dir", ckpt]

        # (a) train
        _reset_counts()
        trained = _cli(["train", *common, "--batch-size", "4", "--epochs",
                        "2", "--learning-rate", "1e-5", "--device", "cuda",
                        "--train-images", data["images"],
                        "--train-annotations", data["annotations"],
                        "--metrics", os.path.join(root, "metrics.jsonl")])
        steps = 2 * LIFECYCLE_IMAGES // 4
        train_counts = _counts()
        _require(np.isfinite(trained["final_loss"]),
                 f"train: loss {trained['final_loss']}")
        _require(train_counts["flash_lse"] == 12 * steps
                 and train_counts["flash_bwd"] == 12 * steps
                 and train_counts["dense_mish"] == 27 * steps,
                 f"train: {steps} steps launched {train_counts}")
        # Training keeps the differentiable LayerNorm (the kernel has no
        # backward; the JAX package routes only inference through it).
        # From here on the preset the CLI builds carries the fused
        # LayerNorm, in this process: the CLI has no flag for it, nor has
        # the JAX CLI.
        port_config.PRESETS["vit_b16_384"] = lambda: config

        # (b) evaluate, score the dump, score a perfect detector
        dump = os.path.join(root, "detections.json")
        evaluated = _cli(["evaluate", *common, "--restore", "final",
                          "--device", "cuda", "--batch-size", "4",
                          "--val-images", data["images"],
                          "--val-annotations", data["annotations"],
                          "--protocol", "coco-original",
                          "--dump-detections", dump])
        scored = _cli(["score-coco", "--annotations", data["annotations"],
                       "--results", dump])
        _protocol_valid(evaluated, "evaluate")
        _protocol_valid(scored, "score-coco")
        ap_diff = {key: abs(evaluated[key] - scored[key])
                   for key in ("AP", "AP50")}
        # The dump rounds boxes to 0.01 px and scores to 1e-5.
        _require(max(ap_diff.values()) <= 0.02,
                 f"evaluate {evaluated} vs score-coco {scored}")
        perfect = os.path.join(root, "perfect.json")
        with open(perfect, "w") as f:
            json.dump([{"image_id": int(image_id), "category_id": cat,
                        "bbox": [cx - w / 2, cy - h / 2, w, h], "score": 1.0}
                       for image_id, rows in data["rows"].items()
                       for cat, cx, cy, h, w, _ in rows], f)
        perfect_ap = score_coco_results(data["annotations"], perfect)["AP"]
        _require(perfect_ap == 1.0, f"perfect detector AP {perfect_ap}")

        # (c) export on CUDA and read the graphs
        export_tic = time.monotonic()
        exported = _cli(["export", *common, "--restore", "final",
                         "--output-dir", artifact, "--batch-sizes", "1",
                         "8", "--bake-postprocess", "--score-threshold",
                         "-1.0"])
        export_s = time.monotonic() - export_tic
        _require(exported["platforms"] == ["cuda"], f"export {exported}")
        graph_ops = {}
        for name in ("model_b1.pt2", "model_b8.pt2"):
            ops = _graph_ops(os.path.join(artifact, name))
            custom = {op.split("::")[1]: n for op, n in ops.items()
                      if op.startswith("vtd_torch::")}
            _require(custom == EXPORTED_OPS,
                     f"{name}: custom-operator nodes {custom}, expected "
                     f"{EXPORTED_OPS}")
            # No plain version is left in the graph: the plain attention's
            # softmax, the plain dense+mish's log1p and tanh, the plain
            # LayerNorm's rsqrt (a CPU export holds one of each per use).
            plain = {op: n for op, n in ops.items()
                     if op.split("::")[-1] in ("softmax", "_softmax",
                                               "log1p", "tanh", "rsqrt")}
            _require(not plain, f"{name}: plain-version nodes {plain}")
            graph_ops[name] = {"vtd_torch": custom,
                               "nodes": sum(ops.values())}

        # (d) serve the artifact from a process without models/
        paths = sorted(os.path.join(data["images"], name)
                       for name in os.listdir(data["images"]))
        proc = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_SERVER, artifact, *paths],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        _require(proc.returncode == 0,
                 f"artifact server exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        _require(served["models"] == [] and served["batch_sizes"] == [1, 8],
                 f"artifact server {served['models']} "
                 f"{served['batch_sizes']}")
        _require(served["stats"]["requests"]["ok"] == LIFECYCLE_IMAGES,
                 f"/stats {served['stats']}")
        want = {name: n * LIFECYCLE_IMAGES
                for name, n in EXPORTED_COUNTS.items()}
        want.update(flash_lse=0, flash_bwd=0)
        _require(served["counts"] == want,
                 f"artifact server launches {served['counts']}, expected "
                 f"{want} for {LIFECYCLE_IMAGES} requests")
        per_request = {name: served["counts"][name] / LIFECYCLE_IMAGES
                       for name in EXPORTED_COUNTS}

        # (e) the live service on the same weights and JPEGs
        args = argparse.Namespace(params_npz=None, checkpoint_dir=ckpt,
                                  restore="final")
        live_config = config.replace(use_fused_ffn=True)
        live = DetectionService(live_config,
                                cli._load_params(args, live_config, "cuda"),
                                device="cuda", score_threshold=-1.0)
        answers = []
        for path in paths:
            with open(path, "rb") as f:
                answers.append(live.detect_jpeg(f.read()))
        comparison = _compare_detections(served["answers"], answers)

        # (f) device-path times, in turns on this card
        artifact_service = ExportedDetectionService(artifact,
                                                    score_threshold=-1.0)
        times = _device_path_ms({"artifact": artifact_service,
                                 "live": live}, batches=(1, 8), reps=40)
    seconds = time.monotonic() - tic
    port_config.PRESETS["vit_b16_384"] = port_config.vit_b16_384
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _report("lifecycle", preset="vit_b16_384", fused_ffn=True,
            use_fused_layer_norm=True, seconds=seconds,
            train={"steps": steps, "final_loss": trained["final_loss"],
                   "launches": train_counts},
            evaluate={k: evaluated[k] for k in ("AP", "AP50", "AR@100")},
            score_coco={k: scored[k] for k in ("AP", "AP50", "AR@100")},
            ap_diff=ap_diff, perfect_detector_ap=perfect_ap,
            export_seconds=export_s, graphs=graph_ops,
            served_stats=served["stats"]["requests"],
            launches_per_request=per_request, artifact_vs_live=comparison,
            device_path=times, card=smi)
    return per_request


NATIVE_IMAGES = 5000         # COCO val2017's image count
NATIVE_ANNOTATIONS = 36800   # about val2017's 36,781 annotations
NATIVE_DETECTIONS = 17       # detections per image (max_objects slots)
DECODE_IMAGES = 160          # seeded 640 x 480 JPEGs of the decode sweep
DECODE_WORKERS = (1, 4, 8, 16)
DECODE_WARMUP_BATCHES = 4    # the pool's start and the prefetch fill
DECODE_WINDOW_S = 1.5        # the timed steady-state window of each cell
DECODE_SLICES = 3            # equal parts of the window, for the spread
DECODE_CANVASES = {"vit_b16_384": 384, "reference_608": 608,
                   "highres_1024": 1024}


def _coco_instances(rng) -> dict:
    """A seeded COCO-val-sized instances file: NATIVE_IMAGES images of
    640 x 480 and about NATIVE_ANNOTATIONS annotations over the 80 COCO
    category ids, each with a polygon segmentation of 8 to 40 vertices,
    1 % crowds."""
    import numpy as np

    from vision_transformer_detector_tpu_torch.data.categories import (
        COCO_ID_TO_MODEL_ID)

    category_ids = np.array(sorted(COCO_ID_TO_MODEL_ID), np.int64)
    image_of = np.sort(rng.integers(1, NATIVE_IMAGES + 1,
                                    NATIVE_ANNOTATIONS))
    wh = np.round(rng.uniform(2, 300, (NATIVE_ANNOTATIONS, 2)), 2)
    xy = np.round(rng.uniform(0, 1, (NATIVE_ANNOTATIONS, 2))
                  * (np.array([640.0, 480.0]) - wh), 2)
    annotations = []
    for i in range(NATIVE_ANNOTATIONS):
        n = int(rng.integers(8, 41))
        polygon = np.round(rng.uniform(0, 1, 2 * n) * np.tile(wh[i], n)
                           + np.tile(xy[i], n), 2)
        annotations.append({
            "segmentation": [polygon.tolist()],
            "area": round(float(wh[i, 0] * wh[i, 1]) * 0.6, 4),
            "iscrowd": int(rng.uniform() < 0.01),
            "image_id": int(image_of[i]),
            "bbox": [float(xy[i, 0]), float(xy[i, 1]), float(wh[i, 0]),
                     float(wh[i, 1])],
            "category_id": int(rng.choice(category_ids)),
            "id": 900000 + i})
    return {"info": {"description": "seeded COCO-val-sized instances"},
            "images": [{"id": i, "width": 640, "height": 480,
                        "file_name": f"{i:012d}.jpg"}
                       for i in range(1, NATIVE_IMAGES + 1)],
            "annotations": annotations,
            "categories": [{"id": int(c), "name": f"category-{c}"}
                           for c in category_ids]}


def _decode_corpus(rng, count: int) -> list:
    """``count`` seeded 640 x 480 JPEGs (COCO's usual size): smooth
    gradients with blocks and noise, quality 90."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:480, 0:640]
    out = []
    for _ in range(count):
        a, b, c = rng.uniform(0.2, 1.0, 3)
        img = np.stack([yy * a * 255 / 480, xx * b * 255 / 640,
                        (yy + xx) * c * 255 / 1120], axis=-1)
        for _ in range(6):
            y0, x0 = rng.integers(0, 400), rng.integers(0, 560)
            img[y0:y0 + 80, x0:x0 + 80] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 6, img.shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _decode_rate(dataset, size: int) -> dict:
    """Images/s of the pipeline's steady state: DECODE_WARMUP_BATCHES
    batches discarded, then every batch until DECODE_WINDOW_S seconds
    have passed; the rate over the window and the least and the most over
    its DECODE_SLICES equal parts."""
    import numpy as np

    stamps = []
    for i, (images, _) in enumerate(dataset):
        _require(images.shape[1:] == (size, size, 3),
                 f"decode sweep: batch of {images.shape}")
        stamps.append((time.perf_counter(), images.shape[0]))
        if (i >= DECODE_WARMUP_BATCHES
                and stamps[-1][0] - stamps[DECODE_WARMUP_BATCHES][0]
                >= DECODE_WINDOW_S):
            break
    _require(len(stamps) > DECODE_WARMUP_BATCHES + DECODE_SLICES,
             f"decode sweep: {len(stamps)} batches before the corpus ran "
             "out")
    times = np.array([t for t, _ in stamps[DECODE_WARMUP_BATCHES:]])
    counts = np.cumsum([n for _, n in stamps[DECODE_WARMUP_BATCHES + 1:]])
    edges = np.linspace(times[0], times[-1], DECODE_SLICES + 1)
    # Images of the batches that arrived by each edge.
    done = np.concatenate([[0], counts])[
        np.searchsorted(times, edges, side="right") - 1]
    rates = np.diff(done) / np.diff(edges)
    return {"img_s": float(counts[-1] / (times[-1] - times[0])),
            "slice_min": float(rates.min()), "slice_max": float(rates.max()),
            "window_s": float(times[-1] - times[0]),
            "images": int(counts[-1])}


def phase_native_host(consumption: dict) -> dict:
    """The port's native host cores through their entry points: the JSON
    and matcher cores must build and load (the decode core's state is
    printed: the card's host may lack jpeglib.h); a COCO-val-sized
    instances file parsed natively and in Python, bit-equal; 5,000 images
    x 17 detections evaluated with the native and the NumPy matcher,
    summaries bit-equal; the decode sweep (letterbox of 640 x 480 JPEGs to
    384, 608 and 1024 with 1 to 16 thread workers of the train/eval
    pipeline, each cell timed over a steady-state window) beside the
    rates at which the card consumes images
    (``consumption``, images/s, from this run's step and service times);
    4 HTTP requests of those JPEGs through vit_b16_384 (B1 12 times each),
    their latency with the decoder named. Returns the flash launches."""
    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import _native, get_config
    from vision_transformer_detector_tpu_torch.data.annotations import (
        build_annotations_from_instances)
    from vision_transformer_detector_tpu_torch.data.pipeline import (
        CocoDetectionDataset, native_available)
    from vision_transformer_detector_tpu_torch.kernels.flash_attention import (
        flash_attention)
    from vision_transformer_detector_tpu_torch.metrics.coco_eval import (
        CocoEvaluator)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionServer, DetectionService)

    phase_tic = time.perf_counter()
    tic = time.perf_counter()
    cores = _native.build()
    build_s = time.perf_counter() - tic
    _require(cores["coco_json"]["built"] and cores["coco_eval"]["built"],
             f"the JSON and matcher cores must build on this host: {cores}")
    rng = np.random.default_rng(SEED + 9)
    tmp = tempfile.mkdtemp()
    try:
        # JSON: native against Python, bit-equal.
        path = os.path.join(tmp, "instances_val_seeded.json")
        with open(path, "w") as f:
            json.dump(_coco_instances(rng), f)
        parsed, parse_s = {}, {}
        for name, flag in (("native", True), ("python", False)):
            tic = time.perf_counter()
            parsed[name] = build_annotations_from_instances(
                path, use_native=flag)
            parse_s[name] = time.perf_counter() - tic
        _require(parsed["native"] == parsed["python"],
                 "native and Python annotation dicts differ")
        annotations = parsed["native"]
        json_line = {"file_mb": os.path.getsize(path) / 1e6,
                     "images": len(annotations),
                     "annotations": sum(map(len, annotations.values())),
                     "parse_s": parse_s, "bit_equal": True}
        del parsed

        # Matcher: 17 detections per image, jittered ground truths first.
        evaluators = {"native": CocoEvaluator(use_native=True),
                      "numpy": CocoEvaluator(use_native=False)}
        for image_id in range(1, NATIVE_IMAGES + 1):
            rows = np.asarray(annotations.get(str(image_id), []),
                              np.float64).reshape(-1, 6)
            gt = np.concatenate([rows[:, 1:3] - rows[:, 3:5] / 2,
                                 rows[:, 3:5]], axis=1)
            det = np.concatenate([gt, rng.uniform(0, 300, (
                NATIVE_DETECTIONS, 4))])[:NATIVE_DETECTIONS]
            det[:len(gt)] += rng.normal(0, 4, det[:len(gt)].shape)
            det[:, 2:] = np.abs(det[:, 2:]) + 1
            # The other detections take the image's own classes, as a
            # detector's do, or any class on an image without objects.
            pool = rows[:, 0] if len(rows) else np.arange(80)
            classes = np.concatenate([rows[:, 0], rng.choice(
                pool, NATIVE_DETECTIONS)])[:NATIVE_DETECTIONS]
            scores = np.round(rng.uniform(0, 1, NATIVE_DETECTIONS), 2)
            for ev in evaluators.values():
                ev.add_image(gt_boxes=gt, gt_categories=rows[:, 0],
                             gt_areas=rows[:, 5], det_boxes=det,
                             det_categories=classes, det_scores=scores)
        summaries, match_s = {}, {}
        for name, ev in evaluators.items():
            tic = time.perf_counter()
            summaries[name] = ev.evaluate().summarize()
            match_s[name] = time.perf_counter() - tic
        _require(summaries["native"] == summaries["numpy"],
                 f"matcher summaries differ: {summaries}")
        _require(0.0 < summaries["native"]["AP"] < 1.0,
                 f"matcher AP {summaries['native']['AP']}")
        match_line = {"images": NATIVE_IMAGES,
                      "detections_per_image": NATIVE_DETECTIONS,
                      "evaluate_s": match_s, "AP": summaries["native"]["AP"],
                      "bit_equal": True}
        del evaluators

        # Decode: the train/eval pipeline over 640 x 480 JPEGs on disk.
        corpus = _decode_corpus(rng, DECODE_IMAGES)
        image_dir = os.path.join(tmp, "images")
        os.makedirs(image_dir)
        paths = []
        for i, data in enumerate(corpus):
            paths.append(os.path.join(image_dir, f"{i + 1:012d}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(data)
        decoder = "native" if native_available() else "pil"
        sweep = {}
        for preset, size in DECODE_CANVASES.items():
            config = get_config(preset)
            sweep[preset] = {}
            for workers in DECODE_WORKERS:
                # The corpus repeated, more than any window reads.
                dataset = CocoDetectionDataset(
                    paths * 40, annotations, config, batch_size=8,
                    num_workers=workers, prefetch=4, normalize=False,
                    pool="thread")
                sweep[preset][workers] = _decode_rate(dataset, size)
        best = {preset: max(cells.values(), key=lambda c: c["img_s"])
                for preset, cells in sweep.items()}
        feeds = {path_name: {"card_img_s": rate,
                             "decode_img_s_best": best[preset]["img_s"],
                             "keeps_up": best[preset]["img_s"] >= rate}
                 for path_name, (preset, rate) in consumption.items()}

        # Serving: 4 of those JPEGs through vit_b16_384 over HTTP.
        config = get_config("vit_b16_384")
        service = DetectionService(
            config, init_params(config, torch.Generator().manual_seed(SEED)),
            device="cuda")
        server = DetectionServer(service, port=0)
        server.start()
        try:
            flash_attention.launches = 0
            latencies = _post_jpegs(
                f"http://127.0.0.1:{server.port}",
                [((480, 640), data) for data in corpus[:REQUESTS]],
                config.num_classes)
            launches = flash_attention.launches
        finally:
            server.stop()
        _require(launches == config.encoder_blocks * REQUESTS,
                 f"flash kernel launched {launches} times for {REQUESTS} "
                 "requests")
    finally:
        shutil.rmtree(tmp)
    seconds = time.perf_counter() - phase_tic
    _report("native_host", cores=cores, build_s=build_s, json=json_line,
            matcher=match_line, decoder=decoder,
            decode_img_s={p: {str(w): r for w, r in cells.items()}
                          for p, cells in sweep.items()},
            canvases=DECODE_CANVASES, host_cpus=os.cpu_count(),
            decode_feeds_the_card=feeds,
            serve={"requests": REQUESTS, "decoder": decoder,
                   "request_latency_ms": latencies,
                   "flash_launches": launches},
            seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# parallel: data parallelism and ring attention on the one card
# ---------------------------------------------------------------------------

RING_TOKENS = (2, 4096, 16, 64)     # highres_1024_ring: (B, N, H, K)
RING_FP32 = (8, 1296, 8, 40)        # reference_608 at batch 8
OFFSET_SHAPE = (8, 256, 256, 64)    # highres_1024 b8 heads-major: 2048 rows
PARALLEL_STEPS = 3
PARALLEL_TIMEOUT_S = 420
RING_TIMED = 5                      # timed ring calls (host clock)
# (b)'s cases: the ring's output and q/k/v grads against the plain versions
# and the whole-sequence kernels.
RING_CASES = (("bf16", RING_TOKENS, "bfloat16", False),
              ("bf16_drop", RING_TOKENS, "bfloat16", True),
              ("fp32", RING_FP32, "float32", False))
# (d)'s limits on |ring - one process| / one process of the loss at steps
# 1-3. Step 1 (equal parameters): 2^-7. Step 2: 2^-7 x 2. Step 3: 5e-2,
# where 2^-7 x 3 lies below what two correct bf16 routes of one process
# differ by on this batch (its loss falls by two thirds a step): the einsum
# route against the flash kernels read 0.46 %, 2.28 % and 4.36 % at steps
# 1-3 (PERF.md §6), the ring 0.53 %, 0.28 % and 3.51 %. The fp32 step
# of (d) holds the function itself at 1e-5.
HIGHRES_RING_LOSS_LIMITS = (2 ** -7, 2 * 2 ** -7, 5e-2)


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b))


def _offsets_at_the_kernel() -> dict:
    """(a) B1-drop with lse and B2-replay over the whole (2048, 256, 64)
    batch against two half-batches launched with ``bh_base``, and the
    MLP/head dropout kernel at (8, 4096, 2048) against two halves with
    ``row_base``: bit for bit. A second half launched with offset 0 (the
    planted fault) must differ."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        dropout as dk, flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    b, h, n, k = OFFSET_SHAPE
    q, kk, v, g = ((torch.randn(OFFSET_SHAPE, device="cuda", generator=gen)
                    * (0.125 if i == 0 else 1.0)).to(torch.bfloat16)
                   for i in range(4))
    seed = fa.seed_tensor(DROP_SEED, "cuda")
    drop = (seed, DROP_RATE)

    def forward(rows, base):
        return fa._launch_forward(q[rows], kk[rows], v[rows], "bhnk",
                                  with_lse=True, dropout=drop,
                                  offsets=(base, 0, 0))

    def backward(rows, base, out, lse):
        delta = (g[rows].float() * out.float()).sum(-1).contiguous()
        return fa._launch_backward(q[rows], kk[rows], v[rows], g[rows], lse,
                                   delta, "bhnk", drop, offsets=(base, 0, 0))

    whole = slice(0, b)
    halves = (slice(0, b // 2), slice(b // 2, b))
    out, lse = forward(whole, 0)
    grads = backward(whole, 0, out, lse)
    parts = [forward(rows, rows.start * h) for rows in halves]
    part_grads = [backward(rows, rows.start * h, *part)
                  for rows, part in zip(halves, parts)]
    joined = [torch.cat([p[i] for p in parts]) for i in range(2)]
    joined_grads = [torch.cat([p[i] for p in part_grads]) for i in range(3)]
    flash_equal = (all(_bits_equal(x, y) for x, y in zip((out, lse), joined))
                   and all(_bits_equal(x, y)
                           for x, y in zip(grads, joined_grads)))
    planted = forward(halves[1], 0)
    flash_planted_caught = not _bits_equal(planted[0], out[halves[1]])
    torch.cuda.synchronize()

    rows_shape = MLP_DROP_SHAPES[0]
    x = torch.randn(rows_shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    mlp_seed = fa.seed_tensor(DROP_SEED - 1, "cuda")
    half = rows_shape[0] // 2
    per_row = rows_shape[1]
    mlp_whole = dk._launch(x, mlp_seed, DROP_RATE)
    mlp_parts = torch.cat([dk._launch(x[:half], mlp_seed, DROP_RATE),
                           dk._launch(x[half:], mlp_seed, DROP_RATE,
                                      half * per_row)])
    mlp_equal = _bits_equal(mlp_whole, mlp_parts)
    mlp_planted_caught = not _bits_equal(
        dk._launch(x[half:], mlp_seed, DROP_RATE), mlp_whole[half:])
    # The offsets against the plain versions (dropout mask and all).
    plain = fa.reference_attention(q[halves[1]], kk[halves[1]],
                                   v[halves[1]], "bhnk", drop,
                                   (halves[1].start * h, 0, 0))
    plain_err = float((plain.float() - parts[1][0].float()).abs().max())
    plain_mlp = dk.dropout_reference(x[half:], mlp_seed, DROP_RATE,
                                     half * per_row)
    result = {"flash_bit_equal": flash_equal,
              "flash_planted_fault_caught": flash_planted_caught,
              "mlp_bit_equal": mlp_equal,
              "mlp_planted_fault_caught": mlp_planted_caught,
              "flash_half_vs_plain_max_abs_err": plain_err,
              "mlp_half_vs_plain_bit_equal": _bits_equal(
                  plain_mlp, mlp_parts[half:])}
    _require(flash_equal and mlp_equal, f"parallel (a): offsets {result}")
    _require(flash_planted_caught and mlp_planted_caught,
             f"parallel (a): a zero offset went unnoticed {result}")
    _require(result["mlp_half_vs_plain_bit_equal"] and plain_err < 2e-2,
             f"parallel (a): offset kernels against plain {result}")
    return result


MAP_SHAPE = (2, 4096, 16, 64)       # highres_1024 at batch 2: (B, N, H, K)
MAP_WINDOW = 256                    # its windows' tokens
MAP_MLP = (2, 4096, 2048)           # its first pyramid layer's activation


def _maps_at_the_kernel() -> dict:
    """(f) The sharded coordinate maps at the kernel, highres_1024's
    heads-major window fold at batch 2 ((2, 16 heads x 16 windows, 256,
    64) bf16, rate 0.1): B1-drop (out, lse) and B2-replay (dq, dk, dv)
    over the whole array against the two head halves (map (8 W, 16 W,
    h0 W)) and the two window halves (map (8, 16, w0)), bit for bit; (D)
    at (2, 4096, 2048) bf16 against its two token halves (row map (2048,
    4096, n0)) and two column halves (``col_base``); each with a planted
    wrong base that must differ; the halves against the plain versions.
    Returns the results and the kernels line's numbers of the
    tensor-parallel rank's launches (one head half, one column half)."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        dropout as dk, flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 48)
    b, n, h, k = MAP_SHAPE
    w = n // MAP_WINDOW
    fold = (b, h * w, MAP_WINDOW, k)
    q, kk, v, g = ((torch.randn(fold, device="cuda", generator=gen)
                    * (0.125 if i == 0 else 1.0)).to(torch.bfloat16)
                   for i in range(4))
    drop = (fa.seed_tensor(DROP_SEED, "cuda"), DROP_RATE)

    def run(tensors, offsets):
        q_, k_, v_, g_ = tensors
        out, lse = fa._launch_forward(q_, k_, v_, "bhnk", with_lse=True,
                                      dropout=drop, offsets=offsets)
        delta = (g_.float() * out.float()).sum(-1).contiguous()
        return (out, lse) + fa._launch_backward(q_, k_, v_, g_, lse, delta,
                                                "bhnk", drop,
                                                offsets=offsets)

    def heads(t, h0, count=h // 2):
        return t.reshape(b, h, w, MAP_WINDOW, -1)[:, h0:h0 + count].reshape(
            b, count * w, MAP_WINDOW, -1)

    def windows(t, w0, count=w // 2):
        return t.reshape(b, h, w, MAP_WINDOW, -1)[:, :, w0:w0 + count] \
            .reshape(b, h * count, MAP_WINDOW, -1)

    whole = run((q, kk, v, g), (0, 0, 0))
    result = {"shape": list(fold)}
    for tag, part, maps in (
            ("heads", heads, [(0, 0, 0, h // 2 * w, h * w, h0 * w)
                              for h0 in (0, h // 2)]),
            ("windows", windows, [(0, 0, 0, w // 2, w, w0)
                                  for w0 in (0, w // 2)])):
        starts = (0, h // 2) if tag == "heads" else (0, w // 2)
        equal = True
        for start, offsets in zip(starts, maps):
            got = run([part(t.contiguous(), start) for t in (q, kk, v, g)],
                      offsets)
            want = [part(whole[0], start), part(whole[1][..., None],
                                                start)[..., 0]]
            want += [part(t, start) for t in whole[2:]]
            equal = equal and all(_bits_equal(a.contiguous(), c.contiguous())
                                  for a, c in zip(got, want))
        planted = run([part(t.contiguous(), starts[1]) for t in
                       (q, kk, v, g)], (0, 0, 0))[0]
        result[f"flash_{tag}_bit_equal"] = equal
        result[f"flash_{tag}_planted_fault_caught"] = not _bits_equal(
            planted, part(whole[0], starts[1]).contiguous())
    # One tensor-parallel rank's launch against its plain version.
    mine = [heads(t.contiguous(), h // 2) for t in (q, kk, v)]
    rank_offsets = (0, 0, 0, h // 2 * w, h * w, h // 2 * w)
    plain = fa.reference_attention(*mine, "bhnk", drop, rank_offsets)
    kernel_out = fa._launch_forward(*mine, "bhnk", dropout=drop,
                                    offsets=rank_offsets)
    result["flash_rank_vs_plain_max_abs_err"] = float(
        (plain.float() - kernel_out.float()).abs().max())
    torch.cuda.synchronize()

    x = torch.randn(MAP_MLP, device="cuda", generator=gen).to(
        torch.bfloat16)
    seed = fa.seed_tensor(DROP_SEED - 2, "cuda")
    mlp_whole = dk._launch(x, seed, DROP_RATE)
    rows, cols = MAP_MLP[1] // 2, MAP_MLP[2] // 2
    token_parts = [dk._launch(x[:, n0:n0 + rows], seed, DROP_RATE, 0, rows,
                              MAP_MLP[1], n0) for n0 in (0, rows)]
    col_parts = [dk._launch(x[..., c0:c0 + cols], seed, DROP_RATE,
                            col_base=c0) for c0 in (0, cols)]
    result["mlp_tokens_bit_equal"] = _bits_equal(
        torch.cat(token_parts, 1), mlp_whole)
    result["mlp_columns_bit_equal"] = _bits_equal(
        torch.cat(col_parts, 2), mlp_whole)
    result["mlp_tokens_planted_fault_caught"] = not _bits_equal(
        dk._launch(x[:, rows:], seed, DROP_RATE), mlp_whole[:, rows:])
    result["mlp_columns_planted_fault_caught"] = not _bits_equal(
        dk._launch(x[..., cols:], seed, DROP_RATE), mlp_whole[..., cols:])
    result["mlp_vs_plain_bit_equal"] = (
        _bits_equal(dk.dropout_reference(x[:, rows:], seed, DROP_RATE, 0,
                                         (rows, MAP_MLP[1], rows)),
                    token_parts[1])
        and _bits_equal(dk.dropout_reference(x[..., cols:], seed, DROP_RATE,
                                             col_base=cols), col_parts[1]))
    _require(all(v for key, v in result.items()
                 if key.endswith(("bit_equal", "caught"))),
             f"parallel (f): the coordinate maps {result}")
    _require(result["flash_rank_vs_plain_max_abs_err"] < 2e-2,
             f"parallel (f): mapped kernel against plain {result}")

    # The kernels line: one tensor-parallel rank's B1-drop and B2-replay
    # (8 of 16 heads) and its column half of (D), against their plain
    # versions and the library call (SDPA with dropout, F.dropout).
    import torch.nn.functional as F

    g_mine = heads(g.contiguous(), h // 2)
    out, lse = fa._launch_forward(*mine, "bhnk", with_lse=True,
                                  dropout=drop, offsets=rank_offsets)
    delta = (g_mine.float() * out.float()).sum(-1).contiguous()
    lib = [t.detach().clone().requires_grad_() for t in mine]
    lib_out = F.scaled_dot_product_attention(*lib, dropout_p=DROP_RATE,
                                             scale=1.0)
    times = {
        "fwd": _in_turns({
            "kernel_ms": lambda: fa._launch_forward(
                *mine, "bhnk", with_lse=True, dropout=drop,
                offsets=rank_offsets),
            "plain_ms": lambda: (fa.reference_attention(
                *mine, "bhnk", drop, rank_offsets),
                fa.reference_attention_lse(*mine[:2], "bhnk")),
            "library_ms": lambda: F.scaled_dot_product_attention(
                *mine, dropout_p=DROP_RATE, scale=1.0)}, 5),
        "bwd": _in_turns({
            "kernel_ms": lambda: fa._launch_backward(
                *mine, g_mine, lse, delta, "bhnk", drop,
                offsets=rank_offsets),
            "plain_ms": lambda: fa.reference_attention_backward(
                *mine, g_mine, "bhnk", drop, rank_offsets, lse=lse,
                delta=delta),
            "library_ms": lambda: torch.autograd.grad(
                lib_out, lib, g_mine, retain_graph=True)}, 5),
        "mlp": _in_turns({
            "kernel_ms": lambda: dk._launch(x[..., cols:], seed, DROP_RATE,
                                            col_base=cols),
            "plain_ms": lambda: dk.dropout_reference(
                x[..., cols:], seed, DROP_RATE, col_base=cols),
            "library_ms": lambda: F.dropout(x[..., cols:], DROP_RATE)}, 10)}
    grads = fa._launch_backward(*mine, g_mine, lse, delta, "bhnk", drop,
                                offsets=rank_offsets)
    plain_grads = fa.reference_attention_backward(
        *mine, g_mine, "bhnk", drop, rank_offsets, lse=lse, delta=delta)
    errors = {"fwd": result["flash_rank_vs_plain_max_abs_err"],
              "bwd": max(float((a.float() - c.float()).abs().max())
                         for a, c in zip(grads, plain_grads)),
              "mlp": 0.0}
    return result, {"times": times, "errors": errors,
                    "rank_shape": list(mine[0].shape)}


def _ring_inputs(shape, dtype, seed):
    """q (scaled by 1/sqrt(K)), k, v and the output cotangent g on the
    card, the same on every process."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen) for _ in range(4))
    q = q / shape[-1] ** 0.5
    return [t.to(dtype).cuda() for t in (q, k, v, g)]


def _whole_sequence(q, k, v, g, dropout):
    """Output and q/k/v grads of the flash kernels over the whole sequence
    in one process (B1-lse, or B1-drop, and B2 through the Function)."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, layout="bnhk",
                             dropout_rate=dropout and dropout[1],
                             dropout_seed=dropout and dropout[0])
    grads = torch.autograd.grad(out, leaves, g)
    return (out.detach(), *grads)


def _scaled_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _plain_attention_grads(q, k, v, g, dropout, heads=4):
    """Output and q/k/v grads of the plain versions (reference_attention,
    reference_attention_backward) over the whole sequence, ``heads`` heads
    of one image at a time: attention is independent per batch*head row,
    and ``bh_base`` places each group's dropout mask."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    b, _, h, _ = q.shape
    result = [torch.empty_like(t) for t in (q, q, k, v)]
    for i in range(b):
        for h0 in range(0, h, heads):
            part = (slice(i, i + 1), slice(None), slice(h0, h0 + heads))
            args = [t[part] for t in (q, k, v)]
            offsets = (i * h + h0, 0, 0)
            out = fa.reference_attention(*args, "bnhk", dropout, offsets)
            grads = fa.reference_attention_backward(*args, g[part], "bnhk",
                                                    dropout, offsets)
            for dst, src in zip(result, (out, *grads)):
                dst[part] = src
    return result


# ----- the worker processes (python3 chip_smoke.py --parallel-worker ...) --

def _worker_ring(mesh, rank: int) -> dict:
    """(b) ring attention over R = the mesh's model axis: each rank's
    output, dq, dk and dv against the plain versions over the whole
    sequence and against the whole-sequence kernels in one process, bf16
    at highres_1024_ring's shape with and without dropout 0.1 scaled by
    the largest value within 1e-2 (the flash tolerance), fp32 at (64,
    1296, 40) within 2e-5 + 2e-5 x |want|; and the times of a ring forward
    + backward and of the one-process kernels (host clock,
    synchronized)."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, ring_attention as ra)
    from vision_transformer_detector_tpu_torch.parallel import collectives
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        MODEL_AXIS, axis_size)

    ring = axis_size(mesh, MODEL_AXIS)
    names = ("out", "dq", "dk", "dv")
    result = {}
    for tag, shape, dtype_name, dropout in RING_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, g = _ring_inputs(shape, dtype, SEED + 42)
        drop = (fa.seed_tensor(DROP_SEED, "cuda"), DROP_RATE) \
            if dropout else None
        n = shape[1] // ring
        mine = slice(rank * n, (rank + 1) * n)
        leaves = [t[:, mine].contiguous().requires_grad_()
                  for t in (q, k, v)]

        def ring_call():
            out = ra.ring_attention(*leaves, mesh,
                                    dropout_rate=drop and DROP_RATE,
                                    dropout_seed=drop and drop[0])
            return out, torch.autograd.grad(out, leaves,
                                            g[:, mine].contiguous())

        out, grads = ring_call()
        got = (out.detach(), *grads)
        # dk/dv of this rank's keys: its slice of the whole-sequence grads.
        wants = {"plain": [t[:, mine] for t in
                           _plain_attention_grads(q, k, v, g, drop)],
                 "whole": [t[:, mine] for t in
                           _whole_sequence(q, k, v, g, drop)]}
        entry = {"shape": list(shape), "ring": ring, "ok": True}
        for against, want in wants.items():
            abs_errs = {name: float((a.float() - b.float()).abs().max())
                        for name, a, b in zip(names, got, want)}
            if dtype == torch.float32:
                ok = all(bool(((a.float() - b.float()).abs()
                               <= 2e-5 + 2e-5 * b.float().abs()).all())
                         for a, b in zip(got, want))
            else:
                scaled = {name: _scaled_err(a, b)
                          for name, a, b in zip(names, got, want)}
                ok = max(scaled.values()) < 1e-2
                entry[f"scaled_errors_vs_{against}"] = scaled
            entry[f"abs_errors_vs_{against}"] = abs_errs
            entry["ok"] = entry["ok"] and ok

        def timed(fn):
            fn()
            collectives.barrier()
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(RING_TIMED):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - tic) * 1e3 / RING_TIMED

        entry["ring_fwd_bwd_ms"] = timed(ring_call)
        entry["one_process_fwd_bwd_ms"] = timed(
            lambda: _whole_sequence(q, k, v, g, drop))
        result[tag] = entry
    return result


def _worker_ring_host_ms(mesh, rank: int) -> dict:
    """The ring's own times at highres_1024_ring's shape (bf16, R = 2,
    this rank's shard), host clock, synchronized: a forward, and a
    backward alone (retain_graph) with its exchanges."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        ring_attention as ra)
    from vision_transformer_detector_tpu_torch.parallel import collectives

    q, k, v, g = _ring_inputs(RING_TOKENS, torch.bfloat16, SEED + 43)
    n = RING_TOKENS[1] // 2
    mine = slice(rank * n, (rank + 1) * n)
    ql, kl, vl, gl = (t[:, mine].contiguous() for t in (q, k, v, g))

    def host_ms(fn):
        fn()
        collectives.barrier()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(RING_TIMED):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - tic) * 1e3 / RING_TIMED

    leaves = [t.requires_grad_() for t in (ql, kl, vl)]
    fwd_ms = host_ms(lambda: ra.ring_attention(*leaves, mesh))
    out = ra.ring_attention(*leaves, mesh)
    bwd_ms = host_ms(lambda: torch.autograd.grad(out, leaves, gl,
                                                 retain_graph=True))
    return {"fwd_host_ms": fwd_ms, "bwd_host_ms": bwd_ms}


def _worker_dp(mesh, rank: int) -> dict:
    """(c) reference_608 fp32, global batch 8 as 2 x 4, 3 steps through
    Trainer(mesh): each step's loss against one process at batch 8 (rank
    0), rtol 1e-5, and the largest parameter difference after them."""
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.parallel import collectives
    from vision_transformer_detector_tpu_torch.parallel.data import (
        process_batch_indices)
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    config = get_config("reference_608")
    train_config = TrainConfig(learning_rate=1e-5)
    images, labels = next(synthetic_batches(config, 8, 1, seed=SEED + 44))
    rows = process_batch_indices(mesh, 8)

    def run(trainer, batch_images, batch_labels):
        state = trainer.init_state()
        x = torch.from_numpy(batch_images).cuda()
        y = torch.from_numpy(batch_labels).cuda()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        losses = [float(trainer.train_step(state, x, y)[1])
                  for _ in range(PARALLEL_STEPS)]
        step_s = (time.perf_counter() - tic) / PARALLEL_STEPS
        return losses, {name: p.detach().clone() for name, p in
                        state["params"].named_parameters()}, step_s

    losses, params, step_s = run(Trainer(config, LossConfig(), train_config,
                                         mesh=mesh, device="cuda:0"),
                                 images[rows.start:rows.stop],
                                 labels[rows.start:rows.stop])
    result = {"losses": losses, "step_s": step_s}
    if rank == 0:
        single, single_params, single_step_s = run(
            Trainer(config, LossConfig(), train_config, device="cuda:0"),
            images, labels)
        result["single_step_s"] = single_step_s
        result["single_losses"] = single
        result["max_param_diff"] = max(
            float((params[name] - single_params[name]).abs().max())
            for name in params)
        result["ok"] = all(abs(a - b) <= 1e-5 * abs(b)
                           for a, b in zip(losses, single))
    collectives.barrier()
    return result


def _worker_highres_ring(mesh, rank: int) -> dict:
    """(d) highres_1024_ring at full width and depth (1024 px, D 1024, 24
    blocks, remat) through Trainer(mesh) with R = 2: batch 2, 3 steps at
    lr 1e-5; the ring's B1-lse and B2 launches (the counts are zeroed
    just before and read just after); each process's peak memory; then
    (rank 0) one process on the same preset without a mesh, whose global
    attention runs the flash kernels over 4,096 tokens: each step's loss
    within HIGHRES_RING_LOSS_LIMITS, relative; and the control, the same
    preset in one process with the einsum route, within 2^-7 of the flash
    one at step 1 (its later steps are reported). And one fp32
    step (compute_dtype float32, the 3xTF32 kernels) of the ring against
    one process: the loss within 1e-5 and every gradient within 1e-4 of
    its tensor's largest value, but the attention key bias's, whose exact
    gradient is zero (a shift of every score of a query row, which the
    softmax cancels), reported apart."""
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.parallel import collectives
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    config = get_config("highres_1024_ring")
    _require(config.ring_attention and config.embedding_dim == 1024
             and config.encoder_blocks == 24 and config.num_patches == 4096
             and config.remat_encoder, "highres_1024_ring preset changed")
    train_config = TrainConfig(learning_rate=1e-5)
    images, labels = next(synthetic_batches(config, 2, 1, seed=SEED + 45))
    x = torch.from_numpy(images).cuda()
    y = torch.from_numpy(labels).cuda()

    def run(trainer, steps=PARALLEL_STEPS):
        state = trainer.init_state()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, x, y)
            losses.append(float(loss))
        step_s.append((time.perf_counter() - tic) / steps)
        return losses, torch.cuda.max_memory_allocated() / 2 ** 30

    step_s = []

    def fp32_grads(run_mesh):
        """Loss and gradients of one fp32 step's forward and backward."""
        from vision_transformer_detector_tpu_torch.models.vit_detector import (
            forward, init_params)
        from vision_transformer_detector_tpu_torch.ops.loss import (
            detection_loss)

        fp32 = config.replace(compute_dtype="float32",
                              use_flash_attention=True)
        model = init_params(fp32, torch.Generator().manual_seed(SEED),
                            "cuda:0")
        names, params = zip(*model.named_parameters())
        loss = detection_loss(y, forward(model, x, fp32, mesh=run_mesh), fp32,
                              LossConfig())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                                  params)))

    trainer = Trainer(config, LossConfig(), train_config, mesh=mesh,
                      device="cuda:0")
    _reset_counts()
    losses, peak = run(trainer)
    counts = _counts()
    del trainer
    torch.cuda.empty_cache()
    # Queue C 2: the same three steps in fp32 (the 3xTF32 kernels), ring
    # against one process.
    fp32_config = config.replace(compute_dtype="float32",
                                 use_flash_attention=True)
    fp32_losses, _ = run(Trainer(fp32_config, LossConfig(), train_config,
                                 mesh=mesh, device="cuda:0"))
    torch.cuda.empty_cache()
    result = {"losses": losses, "peak_gib": peak,
              "ring_lse_launches": counts["flash_lse"],
              "ring_bwd_launches": counts["flash_bwd"],
              "ring_lse_per_step": counts["flash_lse"] / PARALLEL_STEPS,
              "ring_bwd_per_step": counts["flash_bwd"] / PARALLEL_STEPS,
              "other_launches": {k: c for k, c in counts.items()
                                 if c and k not in ("flash_lse",
                                                    "flash_bwd")},
              "step_s": step_s[0]}
    ring_fp32 = fp32_grads(mesh)
    collectives.barrier()
    if rank == 0:
        single, single_peak = run(Trainer(
            config.replace(use_flash_attention=True), LossConfig(),
            train_config, device="cuda:0"))
        einsum, _ = run(Trainer(config.replace(use_flash_attention=False),
                                LossConfig(), train_config, device="cuda:0"))
        result.update(single_losses=single, single_peak_gib=single_peak,
                      single_step_s=step_s[1],
                      rel_diffs=[abs(a - b) / abs(b)
                                 for a, b in zip(losses, single)],
                      einsum_losses=einsum,
                      einsum_rel_diffs=[abs(a - b) / abs(b)
                                        for a, b in zip(einsum, single)])
        result["tolerances"] = list(HIGHRES_RING_LOSS_LIMITS)
        single_fp32_losses, _ = run(Trainer(fp32_config, LossConfig(),
                                            train_config, device="cuda:0"))
        result["fp32_losses"] = fp32_losses
        result["fp32_single_losses"] = single_fp32_losses
        result["fp32_step_rel_diffs"] = [
            abs(a - b) / abs(b) for a, b in zip(fp32_losses,
                                                single_fp32_losses)]
        # The record the widened bf16 bound rests on (reported: whether
        # fp32 agrees decides ROADMAP Queue C 2, it gates nothing here).
        result["fp32_steps_agree"] = max(
            result["fp32_step_rel_diffs"]) <= 1e-5
        single_fp32 = fp32_grads(None)
        result["fp32_loss_rel_diff"] = float(
            (ring_fp32[0] - single_fp32[0]).abs() / single_fp32[0].abs())
        grads = {name: _scaled_err(ring_fp32[1][name], want)
                 for name, want in single_fp32[1].items()}
        key_bias = [n for n in grads if n.endswith("mha.key.bias")]
        result["fp32_grad_scaled_diff"] = max(
            v for n, v in grads.items() if n not in key_bias)
        result["fp32_key_bias_grad_abs"] = max(
            float(single_fp32[1][n].abs().max()) for n in key_bias)
        result["ok"] = (all(d <= t for d, t in zip(result["rel_diffs"],
                                                   result["tolerances"]))
                        and result["einsum_rel_diffs"][0] <= 2 ** -7
                        and result["fp32_loss_rel_diff"] <= 1e-5
                        and result["fp32_grad_scaled_diff"] <= 1e-4)
    collectives.barrier()
    return result


def _collective_bytes():
    """Count the bytes the port's collectives move over groups of more
    than one process (the tensor each call hands in, as bytes):
    ``(counts, undo)``; ``undo()`` restores the collectives."""
    import torch.distributed as dist

    from vision_transformer_detector_tpu_torch.parallel import collectives

    counts = {"all_reduce": 0, "all_gather": 0}
    originals = {"all_reduce": collectives.all_reduce_,
                 "all_gather": collectives.all_gather}

    def counted(name):
        def call(t, group=None, *args, **kwargs):
            if dist.get_world_size(group) > 1:
                counts[name] += t.numel() * t.element_size()
            return originals[name](t, group, *args, **kwargs)
        return call

    collectives.all_reduce_ = counted("all_reduce")
    collectives.all_gather = counted("all_gather")

    def undo():
        collectives.all_reduce_ = originals["all_reduce"]
        collectives.all_gather = originals["all_gather"]
    return counts, undo


def _mesh_run(trainer, x, y, steps=PARALLEL_STEPS):
    """(losses, step seconds, peak GiB, state) of ``steps`` train steps
    from a fresh state on one batch."""
    import torch

    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    losses = [float(trainer.train_step(state, x, y)[1])
              for _ in range(steps)]
    torch.cuda.synchronize()
    return (losses, (time.perf_counter() - tic) / steps,
            torch.cuda.max_memory_allocated() / 2 ** 30, state)


def _fp32_step(config, x, y, mesh):
    """Loss and full-shape gradients of one fp32 forward and backward of
    ``config`` (the 3xTF32 kernels, its dropout with a fixed seed: the
    masks on the mesh's coordinate maps) from the seed, on a mesh (tensor
    parallelism's slices gathered) or in one process."""
    import torch

    from vision_transformer_detector_tpu_torch import LossConfig
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector_tpu_torch.ops.loss import (
        detection_loss)
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        gather_tensors, shard_params)

    fp32 = config.replace(compute_dtype="float32")
    model = init_params(fp32, torch.Generator().manual_seed(SEED), "cuda:0")
    if mesh is not None:
        shard_params(model, mesh)
    names, params = zip(*model.named_parameters())
    dropping = bool(config.dropout)
    logits = forward(model, x, fp32, train=dropping,
                     dropout_seed=SEED + 50 if dropping else None, mesh=mesh)
    loss = detection_loss(y, logits, fp32, LossConfig())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    if mesh is not None:
        grads = gather_tensors(grads, model, mesh)
    return loss.detach(), grads


def _worker_highres_mesh(mesh, rank: int, sequence: bool) -> dict:
    """(g) tensor parallelism or (h) sequence sharding of highres_1024 at
    full width and depth (1024 px, D 1024, 16 heads: 8 a rank under
    tensor parallelism, 24 blocks, MLP 1024 -> 2048 -> 1024, windows of
    256: 8 of 16 a rank under sequence sharding, head scales (1, 2, 4)),
    bf16, dropout 0.1, full remat (remat_policy None), over the 'model'
    axis of two processes sharing the card: batch 2, 3 steps at lr 1e-5,
    the flash and dropout launches (counted from 0 just before, read just
    after), step time, peak memory and the bytes of the collectives over
    'model' per step; then (rank 0) one process on the same batch,
    weights and seed: under sequence sharding (whose shards compute what
    one process computes, operation for operation) each step's loss within
    HIGHRES_RING_LOSS_LIMITS, relative; under tensor parallelism, whose
    sharded sums round otherwise in bf16, the same three steps in fp32
    within 1e-5 at every step, and each bf16 step no farther from the fp32
    loss than one process's bf16 step, plus the step's
    HIGHRES_RING_LOSS_LIMITS; and one fp32 step with dropout of both: the
    loss within
    1e-5, relative, every gradient within 1e-4 of its tensor's largest
    value but the attention key bias's (exact gradient zero), reported
    apart."""
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.parallel import collectives
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        model_axis_role)
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    config = get_config("highres_1024").replace(
        dropout=0.1, remat_policy=None, sequence_sharding=sequence)
    _require(config.embedding_dim == 1024 and config.encoder_blocks == 24
             and config.num_heads == 16 and config.num_patches == 4096
             and config.attention_window ** 2 == 256
             and tuple(config.encoder_mlp_units) == (2048, 1024)
             and tuple(config.head_scales) == (1, 2, 4),
             "highres_1024 preset changed")
    _require(model_axis_role(mesh, config)
             == ("sequence" if sequence else "tensor"),
             f"parallel: the mesh's role for {config}")
    train_config = TrainConfig(learning_rate=1e-5)
    images, labels = next(synthetic_batches(config, 2, 1, seed=SEED + 46))
    x = torch.from_numpy(images).cuda()
    y = torch.from_numpy(labels).cuda()
    counts, undo = _collective_bytes()
    trainer = Trainer(config, LossConfig(), train_config, mesh=mesh,
                      device="cuda:0")
    _reset_counts()
    for key in counts:
        counts[key] = 0
    losses, step_s, peak, _ = _mesh_run(trainer, x, y)
    launches = _counts()
    moved = {key: value / PARALLEL_STEPS for key, value in counts.items()}
    undo()
    del trainer
    torch.cuda.empty_cache()
    result = {"losses": losses, "step_s": step_s, "peak_gib": peak,
              "collective_bytes_per_step": moved,
              "launches": {k: c for k, c in launches.items() if c}}
    mesh_fp32 = _fp32_step(config, x, y, mesh)
    fp32_config = config.replace(compute_dtype="float32")
    if not sequence:
        # Tensor parallelism's sharded sums round otherwise than one
        # process's in bf16: the same three steps in fp32 anchor them.
        result["fp32_losses"] = _mesh_run(Trainer(
            fp32_config, LossConfig(), train_config, mesh=mesh,
            device="cuda:0"), x, y)[0]
        torch.cuda.empty_cache()
    collectives.barrier()
    if rank == 0:
        torch.cuda.empty_cache()
        single, single_s, single_peak, _ = _mesh_run(
            Trainer(config, LossConfig(), train_config, device="cuda:0"),
            x, y)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
        single_fp32 = _fp32_step(config, x, y, None)
        grads = {name: _scaled_err(mesh_fp32[1][name], want)
                 for name, want in single_fp32[1].items()}
        key_bias = [n for n in grads if n.endswith("mha.key.bias")]
        result.update(
            single_losses=single, single_step_s=single_s,
            single_peak_gib=single_peak, rel_diffs=rel,
            tolerances=list(HIGHRES_RING_LOSS_LIMITS),
            fp32_loss_rel_diff=float((mesh_fp32[0] - single_fp32[0]).abs()
                                     / single_fp32[0].abs()),
            fp32_grad_scaled_diff=max(v for n, v in grads.items()
                                      if n not in key_bias),
            fp32_key_bias_grad_abs=max(float(single_fp32[1][n].abs().max())
                                       for n in key_bias))
        within = all(d <= t for d, t in zip(rel, HIGHRES_RING_LOSS_LIMITS))
        if not sequence:
            anchor = _mesh_run(Trainer(fp32_config, LossConfig(),
                                       train_config, device="cuda:0"),
                               x, y)[0]
            result["fp32_single_losses"] = anchor
            result["fp32_step_rel_diffs"] = [
                abs(a - b) / abs(b)
                for a, b in zip(result["fp32_losses"], anchor)]
            # Each bf16 run's distance from the fp32 trajectory: the mesh's
            # may exceed one process's by the step's limit at most.
            result["bf16_from_fp32"] = {
                "mesh": [abs(a - f) / abs(f) for a, f in zip(losses, anchor)],
                "one_process": [abs(a - f) / abs(f)
                                for a, f in zip(single, anchor)]}
            within = (max(result["fp32_step_rel_diffs"]) <= 1e-5 and all(
                m <= o + t for m, o, t in zip(
                    result["bf16_from_fp32"]["mesh"],
                    result["bf16_from_fp32"]["one_process"],
                    HIGHRES_RING_LOSS_LIMITS)))
        result["ok"] = (within and result["fp32_loss_rel_diff"] <= 1e-5
                        and result["fp32_grad_scaled_diff"] <= 1e-4)
    collectives.barrier()
    return result


def _worker_dp_tp(mesh, rank: int) -> dict:
    """(i) data x tensor parallelism of reference_608 fp32 at full width
    and depth over a 2 x 2 mesh (8 heads: 4 a rank, the 8-layer pyramid
    alternating column- and row-parallel): global batch 4, 3 steps at lr
    1e-5, each step's loss within 1e-5 relative of one process at the
    global batch (rank 0), the parameters within 2 x lr (the attention
    key bias, whose exact gradient is zero, reported apart), step time,
    peak memory and collective bytes; then ``evaluate_map(mesh=...)`` of
    the trained state on the 4 images, labelled from one process's
    predictions, against that process's AP within 1e-3."""
    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.parallel import collectives
    from vision_transformer_detector_tpu_torch.parallel.data import (
        process_batch_indices)
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        gather_params, model_axis_role)
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, evaluate_map, make_eval_step)

    config = get_config("reference_608")
    _require(config.num_heads == 8 and config.encoder_mlp_layers == 8
             and config.compute_dtype == "float32"
             and model_axis_role(mesh, config) == "tensor",
             "reference_608 preset changed")
    train_config = TrainConfig(learning_rate=1e-5)
    images, labels = next(synthetic_batches(config, 4, 1, seed=SEED + 47))
    rows = process_batch_indices(mesh, 4)
    x = torch.from_numpy(images).cuda()
    y = torch.from_numpy(labels).cuda()
    counts, undo = _collective_bytes()
    trainer = Trainer(config, LossConfig(), train_config, mesh=mesh,
                      device="cuda:0")
    for key in counts:
        counts[key] = 0
    losses, step_s, peak, state = _mesh_run(
        trainer, x[rows.start:rows.stop], y[rows.start:rows.stop])
    moved = {key: value / PARALLEL_STEPS for key, value in counts.items()}
    undo()
    full = gather_params(state["params"], mesh)
    result = {"losses": losses, "step_s": step_s, "peak_gib": peak,
              "collective_bytes_per_step": moved}
    # Eval labels: one process's two most confident slots per image,
    # boxes scaled by 0.8-1.2 (rank 0's, broadcast).
    eval_labels = torch.zeros((4, config.max_objects, 6), device="cuda")
    single = None
    if rank == 0:
        single, single_s, single_peak, single_state = _mesh_run(
            Trainer(config, LossConfig(), train_config, device="cuda:0"),
            x, y)
        decoded = make_eval_step(config)(single_state["params"], x).cpu(
            ).numpy()
        rng = np.random.default_rng(SEED + 49)
        made = np.full((4, config.max_objects, 6), -8.0, np.float32)
        made[..., 0] = 0.0
        for i in range(4):
            for slot in np.argsort(-decoded[i, :, 0])[:2]:
                cx, cy, bh, bw = decoded[i, slot, 2:]
                scale = rng.uniform(0.8, 1.2)
                made[i, slot] = (1, np.round(decoded[i, slot, 1]), cx, cy,
                                 bh * scale, bw * scale)
        eval_labels.copy_(torch.from_numpy(made))
        single_params = dict(single_state["params"].state_dict())
        diffs = {k: float((full[k] - single_params[k]).abs().max())
                 for k in single_params}
        result.update(
            single_losses=single, single_step_s=single_s,
            single_peak_gib=single_peak,
            max_param_diff=max(v for k, v in diffs.items()
                               if not k.endswith("mha.key.bias")),
            key_bias_param_diff=max(v for k, v in diffs.items()
                                    if k.endswith("mha.key.bias")))
        result["single_ap"] = evaluate_map(
            single_state["params"], [(images, eval_labels.cpu().numpy())],
            config, device="cuda:0")
    collectives.broadcast_(eval_labels, src=0)
    # Host arrays, as a dataset yields them (the lockstep rounds read
    # their layout on the host).
    result["ap"] = evaluate_map(
        state["params"], [(images[rows.start:rows.stop],
                           eval_labels[rows.start:rows.stop].cpu().numpy())],
        config, device="cuda:0", mesh=mesh)
    if rank == 0:
        result["ok"] = (
            all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, single))
            and result["max_param_diff"] <= 2 * train_config.learning_rate
            and abs(result["ap"] - result["single_ap"]) <= 1e-3)
    collectives.barrier()
    return result


PARALLEL_TASKS = {"ring": _worker_ring, "ring_host": _worker_ring_host_ms,
                  "dp": _worker_dp, "highres_ring": _worker_highres_ring,
                  "highres_tp": lambda mesh, rank: _worker_highres_mesh(
                      mesh, rank, sequence=False),
                  "highres_sp": lambda mesh, rank: _worker_highres_mesh(
                      mesh, rank, sequence=True),
                  "dp_tp": _worker_dp_tp}
# Each task's mesh: (data, model) from the group's size.
PARALLEL_MESHES = {"dp": lambda world: (world, 1),
                   "dp_tp": lambda world: (2, world // 2)}


def parallel_worker(rank: int, world: int, port: int, out_path: str,
                    tasks: str) -> int:
    """One rank of the parallel phase: a gloo group of ``world`` processes
    on card 0 (host-staged exchange; NCCL refuses two ranks on one card)
    runs the comma-separated PARALLEL_TASKS (each over its
    PARALLEL_MESHES shape: dp over a data axis of ``world``, dp_tp over 2
    x world / 2, the others over a model axis of ``world``) and writes
    their results as JSON to ``out_path``."""
    import torch
    import torch.distributed as dist

    from vision_transformer_detector_tpu_torch.parallel.data import (
        initialize_distributed)
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        create_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend="gloo", device="cuda")
    try:
        result, meshes = {}, {}
        for task in tasks.split(","):
            shape = PARALLEL_MESHES.get(task, lambda n: (1, n))(world)
            if shape not in meshes:
                meshes[shape] = create_mesh(data=shape[0], model=shape[1])
            result[task] = PARALLEL_TASKS[task](meshes[shape], rank)
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _run_parallel_workers(world: int, tasks: str) -> list:
    """Start the phase's worker processes (this script with
    ``--parallel-worker``), wait for them within PARALLEL_TIMEOUT_S, stop
    them all if one fails, and return their results in rank order."""
    port = _free_tcp_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             str(r), str(world), str(port), outs[r], tasks],
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.returncode not in (None, 0)
                               for p in procs)):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-4000:])
            log.close()
        _require(all(p.returncode == 0 for p in procs),
                 "parallel: worker processes failed: "
                 + " | ".join(f"rank {r} rc {p.returncode}: {tails[r]}"
                              for r, p in enumerate(procs)))
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results


def _free_tcp_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _nccl_group_of_one() -> dict:
    """(e) An NCCL group of one process: reference_608 fp32 at batch 8
    through Trainer(mesh=create_mesh(1, 1)).fit(epochs_per_call=4), the
    step captured as a CUDA graph through the NCCL code path (an
    all-reduce over one rank launches nothing to capture), against the
    meshless graph run from the same seed: per-epoch losses and the
    parameters bit-equal; the collective nodes of the mesh's graph (debug
    dump); then `vtd-torch train --distributed` as a group of one for one
    epoch."""
    import torch
    import torch.distributed as dist

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config, synthetic_batches)
    from vision_transformer_detector_tpu_torch.parallel.data import (
        initialize_distributed)
    from vision_transformer_detector_tpu_torch.parallel.mesh import (
        create_mesh)
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, make_multi_step)

    config = get_config("reference_608")
    # No eval or checkpoint events: one window of 4 epochs.
    train_config = TrainConfig(learning_rate=1e-5, skip_epochs=0)
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 46))
    initialize_distributed(f"127.0.0.1:{_free_tcp_port()}", 1, 0,
                           backend="nccl", device="cuda")
    try:
        mesh = create_mesh(1, 1)
        runs = {}
        for tag, run_mesh in (("mesh", mesh), ("meshless", None)):
            trainer = Trainer(config, LossConfig(), train_config,
                              mesh=run_mesh, device="cuda")
            trainer.multi_step = make_multi_step(
                config, LossConfig(), trainer.optimizer, debug_graphs=True,
                mesh=run_mesh)
            state = trainer.fit(trainer.init_state(), data, epochs=4,
                                epochs_per_call=4)
            runs[tag] = (trainer.loss_record,
                         [p.detach().clone()
                          for p in state["params"].parameters()],
                         trainer.multi_step.graphs, trainer.window_record)
        losses_equal = runs["mesh"][0] == runs["meshless"][0]
        params_equal = all(torch.equal(a, b) for a, b in
                           zip(runs["mesh"][1], runs["meshless"][1]))
        nodes = {}
        for tag in ("mesh", "meshless"):
            with tempfile.TemporaryDirectory() as tmp:
                for i, step_graph in enumerate(runs[tag][2].values()):
                    path = os.path.join(tmp, f"{tag}{i}.dot")
                    step_graph.graph.debug_dump(path)
                    with open(path) as f:
                        text = f.read()
                    node = re.compile(r'^"(graph_\d+_node_\d+)"\[', re.M)
                    starts = ([m.start() for m in node.finditer(text)]
                              + [len(text)])
                    blocks = [text[a:b] for a, b in zip(starts, starts[1:])]
                    nodes[tag] = {
                        "kernel_nodes": sum("{KERNEL" in b for b in blocks),
                        "nccl_kernel_nodes": sum(
                            "{KERNEL" in b and "nccl" in b.lower()
                            for b in blocks),
                        "memcpy_nodes": sum("MEMCPY" in b for b in blocks),
                        "graphs": len(runs[tag][2])}
        result = {"losses": runs["mesh"][0], "losses_bit_equal": losses_equal,
                  "params_bit_equal": params_equal,
                  "windows": runs["mesh"][3], "graph_nodes": nodes}
        _require(losses_equal and params_equal and len(runs["mesh"][2]) == 1,
                 f"parallel (e): NCCL group of one against meshless {result}")
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as root:
        dataset = _lifecycle_dataset(root)
        out = subprocess.run(
            [sys.executable, "-m", "vision_transformer_detector_tpu_torch.cli",
             "train", "--distributed", "--coordinator",
             f"127.0.0.1:{_free_tcp_port()}", "--num-processes", "1",
             "--process-id", "0", "--preset", "tiny_96", "--device", "cuda",
             "--batch-size", "2", "--epochs", "1",
             "--train-images", dataset["images"],
             "--train-annotations", dataset["annotations"],
             "--checkpoint-dir", os.path.join(root, "ckpt"),
             "--metrics", os.path.join(root, "metrics.jsonl")],
            capture_output=True, text=True, timeout=300)
        _require(out.returncode == 0,
                 f"parallel (e): train --distributed: {out.stderr[-3000:]}")
        cli = json.loads(out.stdout.strip().splitlines()[-1])
        _require(cli["step"] == LIFECYCLE_IMAGES // 2
                 and cli["final_loss"] == cli["final_loss"],
                 f"parallel (e): train --distributed printed {cli}")
        result["cli_distributed_train"] = cli
    return result


def _ring_block_times() -> dict:
    """The kernels line's times of the ring's blocks at
    highres_1024_ring's shape (bf16, R = 2, rank 0's queries; CUDA events,
    in turns): the R B1-lse block launches of its forward against the
    same blocks' plain versions and one scaled_dot_product_attention
    forward of its queries over the whole sequence; the R B2 block
    launches of its backward (the global lse and delta) against their
    plain versions and that SDPA call's backward."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, ring_attention as ra)

    ring = 2
    q, k, v, g = _ring_inputs(RING_TOKENS, torch.bfloat16, SEED + 43)
    n = RING_TOKENS[1] // ring
    ql, gl = q[:, :n].contiguous(), g[:, :n].contiguous()
    blocks = [(k[:, i * n:(i + 1) * n].contiguous(),
               v[:, i * n:(i + 1) * n].contiguous(), i)
              for i in range(ring)]
    lse = fa.reference_attention_lse(ql, k, "bnhk")
    delta = (gl.float() * fa.reference_attention(ql, k, v).float()).sum(
        -1).transpose(1, 2).contiguous()

    def forward(use_kernel):
        return ra._attend_blocks(ql, iter(blocks), ring, use_kernel, None, 0,
                                 0)

    def backward(use_kernel):
        return [ra._block_backward(ql, kb, vb, gl, lse, delta, use_kernel,
                                   None, (0, 0, i * n))
                for kb, vb, i in blocks]

    heads = [fa._heads_major(t, "bnhk") for t in (ql, k, v, gl)]
    lib_leaves = [t.detach().clone().requires_grad_() for t in heads[:3]]

    def lib_step(backend):
        torch.autograd.grad(_sdpa(*lib_leaves, backend), lib_leaves,
                            heads[3])

    backend = _sdpa_backend(lib_step)
    lib_out = _sdpa(*lib_leaves, backend)
    return {"fwd": _in_turns({
                "kernel_ms": lambda: forward(True),
                "plain_ms": lambda: forward(False),
                "library_ms": lambda: _sdpa(*heads[:3], backend)}, 10),
            "bwd": _in_turns({
                "kernel_ms": lambda: backward(True),
                "plain_ms": lambda: backward(False),
                "library_ms": lambda: torch.autograd.grad(
                    lib_out, lib_leaves, heads[3], retain_graph=True)}, 5),
            "sdpa_backend": backend.name}


def phase_parallel() -> dict:
    """Data, tensor and sequence parallelism and ring attention on the one
    H100: (a) the kernels' offsets and (f) their sharded coordinate maps,
    bit for bit, with planted faults; the ring blocks' kernel times; then
    in two worker processes (b) at R = 2, (c), (d), (g) and (h), and in
    four (b) at R = 4 and (i), joined by gloo on this card (every
    collective through the host: their times say nothing of NCCL across
    cards); (e) an NCCL group of one. Returns the kernels line's numbers
    of the ring and of the sharded launches."""
    import torch

    tic = time.monotonic()
    offsets = _offsets_at_the_kernel()
    maps, mapped = _maps_at_the_kernel()
    block_times = _ring_block_times()
    # The workers share this card: hand back what this process caches.
    torch.cuda.empty_cache()
    workers = _run_parallel_workers(
        2, "ring,ring_host,dp,highres_ring,highres_tp,highres_sp")
    four = _run_parallel_workers(4, "ring,dp_tp")
    dp, highres = workers[0]["dp"], workers[0]["highres_ring"]
    tp, sp = workers[0]["highres_tp"], workers[0]["highres_sp"]
    dp_tp = four[0]["dp_tp"]
    _report("parallel_workers",
            ring={f"R=2 rank {r}": w["ring"] for r, w in enumerate(workers)}
            | {f"R=4 rank {r}": w["ring"] for r, w in enumerate(four)},
            ring_host_ms={r: w["ring_host"] for r, w in enumerate(workers)},
            dp=dp, highres_ring={r: w["highres_ring"]
                                 for r, w in enumerate(workers)},
            highres_tp={r: w["highres_tp"] for r, w in enumerate(workers)},
            highres_sp={r: w["highres_sp"] for r, w in enumerate(workers)},
            dp_tp={r: w["dp_tp"] for r, w in enumerate(four)},
            note="processes sharing one card over gloo, every collective "
                 "through the host: no measure of NCCL scaling")
    for rank, result in enumerate(workers + four):
        for tag, entry in result["ring"].items():
            _require(entry["ok"], f"parallel (b) R={entry['ring']} rank "
                     f"{rank % entry['ring']} {tag}: {entry}")
    _require(dp["ok"], f"parallel (c): DP losses {dp['losses']} against "
             f"one process {dp['single_losses']}")
    _require(highres["ok"], f"parallel (d): ring losses {highres['losses']}"
             f" against one process {highres['single_losses']}: relative "
             f"{highres['rel_diffs']}, allowed {highres['tolerances']}; "
             f"einsum control {highres['einsum_rel_diffs']}; fp32 loss "
             f"{highres['fp32_loss_rel_diff']}, gradients "
             f"{highres['fp32_grad_scaled_diff']}")
    for name, entry in (("(g) tensor parallelism", tp),
                        ("(h) sequence sharding", sp)):
        _require(entry["ok"], f"parallel {name}: losses {entry['losses']} "
                 f"against one process {entry['single_losses']}: relative "
                 f"{entry['rel_diffs']}, allowed {entry['tolerances']}; "
                 f"from fp32 {entry.get('bf16_from_fp32')}, fp32 steps "
                 f"{entry.get('fp32_step_rel_diffs')}; fp32 loss "
                 f"{entry['fp32_loss_rel_diff']}, gradients "
                 f"{entry['fp32_grad_scaled_diff']}")
    _require(dp_tp["ok"], f"parallel (i): DP x TP {dp_tp}")
    for rank, result in enumerate(workers):
        h = result["highres_ring"]
        _require(h["ring_lse_launches"] > 0 and h["ring_bwd_launches"] > 0,
                 f"parallel (d) rank {rank}: the ring launched no kernel "
                 f"{h}")
        for task in ("highres_tp", "highres_sp"):
            launched = result[task]["launches"]
            _require(all(launched.get(k, 0) > 0 for k in
                         ("flash_drop", "flash_bwd_drop", "mlp_drop")),
                     f"parallel {task} rank {rank}: a kernel of the path "
                     f"was not launched {launched}")
    nccl = _nccl_group_of_one()
    _report("parallel", offsets=offsets, maps=maps,
            ring_block_times=block_times, nccl_group_of_one=nccl,
            seconds=time.monotonic() - tic)
    bf16 = [w["ring"]["bf16"]["abs_errors_vs_plain"] for w in workers]
    return {"times": block_times,
            "host_ms": {key: max(w["ring_host"][key] for w in workers)
                        for key in ("fwd_host_ms", "bwd_host_ms")},
            "launches": {"lse": sum(w["highres_ring"]["ring_lse_launches"]
                                    for w in workers),
                         "bwd": sum(w["highres_ring"]["ring_bwd_launches"]
                                    for w in workers)},
            "errors": {"fwd": max(e["out"] for e in bf16),
                       "bwd": max(e[name] for e in bf16
                                  for name in ("dq", "dk", "dv"))},
            "mapped": dict(mapped, launches={
                key: sum(w["highres_tp"]["launches"].get(key, 0)
                         for w in workers)
                for key in ("flash_drop", "flash_bwd_drop", "mlp_drop")})}


WIDE_DIMS = (80, 96, 128)      # ViT-H/14's 80, and two more in the instance
WIDE_N = 321                   # five key tiles, the last one ragged
WIDE_HEADS = 16                # ViT-H/14's heads
WIDE_RING_N = 256              # two ring blocks of 128 keys (whole tiles)
# (B * 16, 256, 80 -> 128) bf16 for B = 1, 8, 32 (the wide_heads model at
# those batches), and (2048, 256, 128) with the instance's own width.
WIDE_TIMED = ((1, 80), (8, 80), (32, 80), (128, 128))


def _wide_inputs(gen, layout, b, n, h, kd, dtype):
    """Scaled q, and k, v and a cotangent g, in ``layout``; heads-major
    ones are views of tokens-major memory, as the model hands them over."""
    import torch

    q, k, v, g = (torch.randn(b, n, h, kd, device="cuda", generator=gen)
                  for _ in range(4))
    out = [t.to(dtype) for t in (q.mul(kd ** -0.5), k, v, g)]
    return [t.transpose(1, 2) for t in out] if layout == "bhnk" else out


def _wide_kernels() -> dict:
    """(a) every route of the 128-wide instance at K 80, 96 and 128, both
    layouts, bf16 and fp32, against the plain versions at the tolerances
    the 64-wide instance is held to: the forward, its lse, the dropout
    forward, the backward by each dq route and with the mask replayed,
    the fp32-output instance and fp32 dk/dv (a ring block); a ring chained
    over two key blocks against one launch over the whole sequence, bit
    for bit; B2 launched 10 times, bit-equal."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    seed = fa.seed_tensor(DROP_SEED, "cuda")
    drop = (seed, DROP_RATE)
    out_tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    grad_tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    lse_tol = 1e-4
    errors = {}
    for kd in WIDE_DIMS:
        for layout in ("bhnk", "bnhk"):
            for dtype in (torch.bfloat16, torch.float32):
                name = f"K{kd}_{layout}_{str(dtype).split('.')[-1]}"
                q, k, v, g = _wide_inputs(gen, layout, 2, WIDE_N, 4, kd,
                                          dtype)
                err = {}
                before = fa.flash_attention.launches
                out = fa.flash_attention(q, k, v, layout=layout)
                _require(fa.flash_attention.launches == before + 1,
                         f"wide_heads {name}: the forward did not launch")
                ref = fa.reference_attention(q, k, v, layout)
                _require(out.shape == q.shape and out.dtype == dtype,
                         f"wide_heads {name}: out {out.shape} {out.dtype}")
                err["fwd"] = _max_err(out, ref)
                out, lse = fa.flash_attention(q, k, v, layout=layout,
                                              with_lse=True)
                err["lse"] = _max_err(lse, fa.reference_attention_lse(
                    q, k, layout))
                err["fwd_lse"] = _max_err(out, ref)
                d_out, d_lse = fa.flash_attention(
                    q, k, v, layout=layout, with_lse=True,
                    dropout_rate=DROP_RATE, dropout_seed=seed)
                err["fwd_drop"] = _max_err(d_out, fa.reference_attention(
                    q, k, v, layout, drop))
                err["fwd_drop_lse"] = _max_err(d_lse, lse)
                plain = fa.reference_attention_backward(q, k, v, g, layout)
                delta = fa._heads_major((g.float() * out.float()).sum(-1),
                                        layout).contiguous()
                routes = ((None, "split", "partials")
                          if dtype == torch.float32 else (None,))
                for route in routes:
                    grads = fa._launch_backward(q, k, v, g, lse, delta,
                                                layout, route=route)
                    err[f"bwd_{route or 'default'}_rel"] = max(
                        _rel_err(a, b) for a, b in zip(grads, plain))
                    if route is None:
                        err["bwd_abs"] = max(
                            _max_err(a, b) for a, b in zip(grads, plain))
                d_delta = fa._heads_major(
                    (g.float() * d_out.float()).sum(-1), layout).contiguous()
                d_plain = fa.reference_attention_backward(q, k, v, g,
                                                          layout, drop)
                d_grads = fa._launch_backward(q, k, v, g, d_lse, d_delta,
                                              layout, drop)
                err["bwd_drop_rel"] = max(
                    _rel_err(a, b) for a, b in zip(d_grads, d_plain))
                if dtype == torch.bfloat16:
                    # The ring block's instances: bf16 in, fp32 out, and
                    # fp32 dk/dv from the whole sequence's lse and delta.
                    f_out = fa._launch_forward(q, k, v, layout,
                                               out_fp32=True)
                    _require(f_out.dtype == torch.float32,
                             f"wide_heads {name}: fp32 out {f_out.dtype}")
                    err["fwd_fp32_out"] = _max_err(
                        f_out, fa.reference_attention(
                            q, k, v, layout, out_dtype=torch.float32))
                    f_grads = fa._launch_backward(
                        q, k, v, g, lse, delta, layout, fp32_dq=True,
                        fp32_dkv=True)
                    f_plain = fa.reference_attention_backward(
                        q, k, v, g, layout, lse=lse, delta=delta,
                        out_dtype=torch.float32)
                    _require(all(t.dtype == torch.float32 for t in f_grads),
                             f"wide_heads {name}: fp32 dk/dv dtypes")
                    err["bwd_fp32_dkv_rel"] = max(
                        _rel_err(a, b) for a, b in zip(f_grads, f_plain))
                torch.cuda.synchronize()
                for key, value in err.items():
                    if key == "bwd_abs":     # reported; held relative
                        continue
                    tol = (lse_tol if "lse" in key and key != "fwd_lse"
                           else grad_tol[dtype] if key.endswith("_rel")
                           else out_tol[dtype])
                    _require(value <= tol, f"wide_heads {name} {key}: "
                             f"{value} > {tol}")
                errors[name] = err

    # The ring: each half of the queries over two key blocks of 128,
    # chained (resume, suspend), against one launch over the 256 keys,
    # tokens-major as the ring runs them, with and without dropout (each
    # block's query and key bases place its mask).
    ring = {}
    for kd in (80, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for dropout in (None, drop):
                name = (f"K{kd}_{str(dtype).split('.')[-1]}"
                        f"{'_drop' if dropout else ''}")
                q, k, v, _ = _wide_inputs(gen, "bnhk", 2, WIDE_RING_N, 4,
                                          kd, dtype)
                out, lse = fa._launch_forward(q, k, v, "bnhk",
                                              with_lse=True, dropout=dropout,
                                              out_fp32=True)
                m = WIDE_RING_N // 2
                equal = True
                for first in (0, m):
                    rows = slice(first, first + m)
                    state = fa._launch_forward(
                        q[:, rows], k[:, :m], v[:, :m], "bnhk",
                        with_lse=True, dropout=dropout,
                        offsets=(0, first, 0), out_fp32=True, suspend=True)
                    chained = fa._launch_forward(
                        q[:, rows], k[:, m:], v[:, m:], "bnhk",
                        with_lse=True, dropout=dropout,
                        offsets=(0, first, m), out_fp32=True, state=state)
                    equal = (equal and _bits_equal(chained[0], out[:, rows])
                             and _bits_equal(chained[1], lse[:, :, rows]))
                torch.cuda.synchronize()
                _require(equal, f"wide_heads ring {name}: the chain of two "
                         "blocks differs from one launch")
                ring[name] = {"bit_equal": equal, "max_abs_err_vs_plain":
                              _max_err(out, fa.reference_attention(
                                  q, k, v, "bnhk", dropout,
                                  out_dtype=torch.float32))}

    # B2 launched 10 times on the same inputs: dq, dk, dv bit-equal, each
    # instance of the wide model's training (bf16, with and without the
    # replay) and both fp32 routes, at (128, 256, 80).
    repeats = {}
    for dtype, dropout, route in ((torch.bfloat16, None, None),
                                  (torch.bfloat16, drop, None),
                                  (torch.float32, None, "split"),
                                  (torch.float32, None, "partials")):
        q, k, v, g = _wide_inputs(gen, "bnhk", 8, 256, WIDE_HEADS, 80,
                                  dtype)
        out, lse = fa._launch_forward(q, k, v, "bnhk", with_lse=True,
                                      dropout=dropout)
        delta = fa._heads_major((g.float() * out.float()).sum(-1),
                                "bnhk").contiguous()
        name = (f"{str(dtype).split('.')[-1]}"
                f"{'_drop' if dropout else ''}_{route or 'default'}")
        repeats[name] = _b2_repeats(q, k, v, g, lse, delta, "bnhk",
                                    dropout, route)
    return {"errors": errors, "ring": ring, "b2_repeats": repeats}


def _wide_shape_errors(q, k, v, g, layout, tol) -> tuple:
    """The wrappers at one timed shape against the plain versions on the
    same inputs, at the 64-wide instance's tolerances ``tol`` (out, lse,
    grads relative): the forward's and the lse forward's out (max abs),
    the lse (max abs) and B2's dq, dk, dv (each relative to its largest
    value, and max abs). Returns (errors, out, lse, delta)."""
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    out_tol, lse_tol, grad_tol = tol
    ref = fa.reference_attention(q, k, v, layout)
    err = {"fwd": _max_err(fa.flash_attention(q, k, v, layout=layout), ref)}
    out, lse = fa.flash_attention(q, k, v, layout=layout, with_lse=True)
    err["fwd_lse"] = _max_err(out, ref)
    err["lse"] = _max_err(lse, fa.reference_attention_lse(q, k, layout))
    delta = fa._heads_major((g.float() * out.float()).sum(-1),
                            layout).contiguous()
    grads = fa._launch_backward(q, k, v, g, lse, delta, layout)
    plain = fa.reference_attention_backward(q, k, v, g, layout)
    for name, a, b in zip(("dq", "dk", "dv"), grads, plain):
        err[f"bwd_{name}_rel"] = _rel_err(a, b)
        err[f"bwd_{name}_abs"] = _max_err(a, b)
    err["bwd_abs"] = max(err[f"bwd_{x}_abs"] for x in ("dq", "dk", "dv"))
    for key, value in err.items():
        if key.endswith("_abs"):           # reported; grads held relative
            continue
        limit = (lse_tol if key == "lse" else grad_tol
                 if key.endswith("_rel") else out_tol)
        _require(value <= limit, f"wide_heads {tuple(q.shape)} "
                 f"{q.dtype} {key}: {value} > {limit}")
    return err, out, lse, delta


def _wide_times() -> dict:
    """(b) the 128-wide instance at (B * 16, 256, 80 -> 128) bf16 for B =
    1, 8, 32 and at (2048, 256, 128), tokens-major as the model runs K =
    80: the serving forward, the forward with lse and the backward, each
    held against its plain version at that shape (``errors``), then timed
    in turns with it and scaled_dot_product_attention on the same unpadded
    (heads-major) inputs, forward and backward, and each beside its bound
    (operations at the unpadded K)."""
    import torch

    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    times = {}
    for batch, kd in WIDE_TIMED:
        n = 256
        q, k, v, g = _wide_inputs(gen, "bnhk", batch, n, WIDE_HEADS, kd,
                                  torch.bfloat16)
        bh = batch * WIDE_HEADS
        errors, out, lse, delta = _wide_shape_errors(
            q, k, v, g, "bnhk", (2e-2, 1e-4, 2e-2))
        hm = [fa._heads_major(t, "bnhk") for t in (q, k, v, g)]
        leaves = [t.detach().clone().requires_grad_() for t in hm[:3]]

        def lib_step(backend):
            o = _sdpa(*leaves, backend)
            torch.autograd.grad(o, leaves, hm[3])
            return o

        backend = _sdpa_backend(lib_step)
        lib_out = _sdpa(*leaves, backend)
        lib_err = _max_err(lib_out.detach(), fa._heads_major(out, "bnhk"))
        _require(lib_err <= 2e-2, f"wide_heads SDPA differs by {lib_err}")
        operand = bh * n * kd * 2            # one bf16 operand, unpadded
        rows = bh * n * 4                    # one fp32 row statistic
        run = {
            "fwd": (_in_turns({
                "plain_ms": lambda: fa.reference_attention(q, k, v),
                "kernel_ms": lambda: fa.flash_attention(q, k, v),
                "library_ms": lambda: _sdpa(*hm[:3], backend)}, 20),
                4 * bh * n * n * kd, 4 * operand),
            "fwd_lse": (_in_turns({
                "plain_ms": lambda: (fa.reference_attention(q, k, v),
                                     fa.reference_attention_lse(q, k)),
                "kernel_ms": lambda: fa.flash_attention(q, k, v,
                                                        with_lse=True),
                "library_ms": lambda: _sdpa(*hm[:3], backend)}, 20),
                4 * bh * n * n * kd, 4 * operand + rows),
            # q, k, v, g read and dk, dv written (bf16), dq written
            # (fp32), lse and delta read.
            "bwd": (_in_turns({
                "plain_ms": lambda: fa.reference_attention_backward(
                    q, k, v, g),
                "kernel_ms": lambda: fa._launch_backward(q, k, v, g, lse,
                                                         delta, "bnhk"),
                "library_ms": lambda: torch.autograd.grad(
                    lib_out, leaves, hm[3], retain_graph=True)}, 20),
                10 * bh * n * n * kd, 6 * operand + 2 * operand + 2 * rows),
        }
        entry = {}
        for what, (t, ops, nbytes) in run.items():
            bound_ms, bound_by = _bound(ops, nbytes, "bf16")
            entry[what] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
        times[f"{bh}x{n}x{kd}"] = dict(entry, errors=errors,
                                       sdpa_backend=backend.name,
                                       padded_to=128)
    # B2 in fp32 at the train step's shape, by each dq route, held against
    # the plain version and beside its 3xTF32 bound: the routes an fp32 run
    # of the model takes (partials while its workspace stays under
    # PARTIALS_MAX_BYTES).
    q, k, v, g = _wide_inputs(gen, "bnhk", 8, 256, WIDE_HEADS, 80,
                              torch.float32)
    errors, out, lse, delta = _wide_shape_errors(q, k, v, g, "bnhk",
                                                 (2e-5, 1e-4, 2e-5))
    plain = fa.reference_attention_backward(q, k, v, g)
    for route in ("partials", "split"):
        grads = fa._launch_backward(q, k, v, g, lse, delta, "bnhk",
                                    route=route)
        errors[f"bwd_{route}_rel"] = max(_rel_err(a, b)
                                         for a, b in zip(grads, plain))
        _require(errors[f"bwd_{route}_rel"] <= 2e-5,
                 f"wide_heads fp32 B2 {route}: "
                 f"{errors[f'bwd_{route}_rel']} > 2e-5")
    bh, n, kd = 8 * WIDE_HEADS, 256, 80
    fp32 = _in_turns({
        "plain_ms": lambda: fa.reference_attention_backward(q, k, v, g),
        "kernel_ms": lambda: fa._launch_backward(q, k, v, g, lse, delta,
                                                 "bnhk", route="partials"),
        "split_ms": lambda: fa._launch_backward(q, k, v, g, lse, delta,
                                                "bnhk", route="split")}, 10)
    bound_ms, bound_by = _bound(10 * bh * n * n * kd,
                                (7 * bh * n * kd + 2 * bh * n) * 4, "3xtf32")
    times[f"{bh}x{n}x{kd}_fp32_bwd"] = dict(fp32, bound_ms=bound_ms,
                                            bound_by=bound_by, errors=errors)
    return times


# ViT-H/14's attention widths (arXiv 2010.11929, Table 1: D 1280, 16 heads
# of 80, 32 blocks) on the detector at 224 px in 14 px patches (256
# tokens), with the detector's own 2-layer 2560 -> 1280 pyramid and a
# 3-layer head: a DetectorConfig the JAX package runs as it is (no preset).
WIDE_CONFIG = dict(image_size=(224, 224), patch_size=14, embedding_dim=1280,
                   num_heads=16, key_dim=80, encoder_blocks=32,
                   encoder_mlp_layers=2, head_last_units=512, head_layers=3,
                   compute_dtype="bfloat16", use_flash_attention=True,
                   train_use_flash_attention=True)
WIDE_STEPS = 5           # Trainer.fit epochs (one batch of 8 each)


def _wide_config():
    from vision_transformer_detector_tpu_torch.config import DetectorConfig

    config = DetectorConfig(**WIDE_CONFIG)
    _require(config.num_patches == 256 and config.key_dim == 80,
             f"wide_heads config: {config.num_patches} tokens")
    return config


def _wide_serve(config, params) -> dict:
    """(c) DetectionService at ViT-H/14's widths: one seeded image on the
    card against the CPU plain path from the same weights, at
    model_serve's bf16 limits (8 bf16 ulps of the largest logit at the
    max, 1 at the median); 32 flash launches a call and nothing else;
    device-path medians at batch 1 and 32."""
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        forward)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    h, w = config.image_size
    image = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, (1, h, w, 3)).astype(np.float32))
    tic = time.monotonic()
    with torch.inference_mode():
        cpu = forward(params, image, config)
    cpu_s = time.monotonic() - tic
    card = copy.deepcopy(params).to("cuda")
    with torch.inference_mode():
        gpu = forward(card, image.to("cuda"), config).cpu()
    _require(tuple(gpu.shape) == (1, config.max_objects, 6)
             and bool(torch.isfinite(gpu).all()),
             f"wide_heads logits {tuple(gpu.shape)}")
    ulp = 2.0 ** -7
    scale = cpu.abs().max().item()
    err = (gpu - cpu).abs()
    limits = (8 * ulp * scale, ulp * scale)
    _require(err.max().item() <= limits[0]
             and err.median().item() <= limits[1],
             f"wide_heads serving: card vs CPU max {err.max().item()} / "
             f"median {err.median().item()}, limits {limits}")
    service = DetectionService(config, card, device="cuda")
    canvas = np.zeros((1, h, w, 3), np.uint8)
    service.raw_to_detections(service.predict_raw(canvas))   # warm
    torch.cuda.synchronize()
    _reset_counts()
    service.raw_to_detections(service.predict_raw(canvas))
    torch.cuda.synchronize()
    launches = _counts()
    want = dict({name: 0 for name in launches},
                flash=config.encoder_blocks)
    _require(launches == want, f"wide_heads service call launched "
             f"{launches}, expected {want}")
    times = _device_path_ms({"bf16": service})["bf16"]
    return {"max_abs_err": err.max().item(),
            "median_abs_err": err.median().item(), "limits": limits,
            "max_abs_logit": scale, "cpu_forward_s": cpu_s,
            "launches_per_call": launches, "device_path": times}


def _wide_train(config) -> dict:
    """(d) WIDE_STEPS train steps at batch 8 through Trainer.fit (bf16,
    flash in training): the loss finite and falling, 32 forward-with-lse
    and 32 backward launches per step and no other; one fp32 step at depth
    2 and batch 1 against the CPU, as `train` (a) is; the median step and
    peak memory."""
    import copy

    import numpy as np
    import torch

    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, synthetic_batches)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        count_params, forward, init_params)
    from vision_transformer_detector_tpu_torch.ops.loss import detection_loss
    from vision_transformer_detector_tpu_torch.train.trainer import (
        Trainer, train_config_view)

    loss_config = LossConfig()
    small = config.replace(encoder_blocks=2, compute_dtype="float32")
    train_view = train_config_view(small)

    def loss_and_grads(model, images, labels, device):
        named = dict(model.named_parameters())
        logits = forward(model, torch.from_numpy(images).to(device),
                         train_view, train=True)
        loss = detection_loss(torch.from_numpy(labels).to(device), logits,
                              train_view, loss_config)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.item(), {n: g.cpu() for n, g in zip(named, grads)}

    loss_tol, grad_tol = 1e-4, 2e-3
    params = init_params(small, torch.Generator().manual_seed(SEED))
    images, labels = next(synthetic_batches(small, 1, 1, seed=SEED))
    cpu_loss, cpu_grads = loss_and_grads(params, images, labels, "cpu")
    card = copy.deepcopy(params).to("cuda")
    _reset_counts()
    gpu_loss, gpu_grads = loss_and_grads(card, images, labels, "cuda")
    small_launches = _counts()
    _require(small_launches["flash_lse"] == 2
             and small_launches["flash_bwd"] == 2,
             f"wide_heads fp32 step launched {small_launches}")
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    _require(np.isfinite(gpu_loss) and loss_err <= loss_tol,
             f"wide_heads loss card {gpu_loss} vs CPU {cpu_loss}")
    worst = _grad_errors(gpu_grads, cpu_grads, grad_tol,
                         "wide_heads card vs CPU")
    del params, card, cpu_grads, gpu_grads

    train_config = TrainConfig(learning_rate=1e-5, seed=SEED,
                               epochs_warm_up=WIDE_STEPS - 1,
                               skip_epochs=WIDE_STEPS)
    trainer = Trainer(config, loss_config, train_config, device="cuda")
    state = trainer.init_state()
    n_params = count_params(state["params"])
    data = list(synthetic_batches(config, 8, 1, seed=SEED + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tic = time.perf_counter()
    state = trainer.fit(state, data, epochs=WIDE_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    launches = _counts()
    blocks = config.encoder_blocks
    want = dict({name: 0 for name in launches},
                flash_lse=blocks * WIDE_STEPS, flash_bwd=blocks * WIDE_STEPS)
    _require(launches == want, f"wide_heads fit launched {launches}, "
             f"expected {want}")
    losses = trainer.loss_record
    _require(len(losses) == WIDE_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0], f"wide_heads losses {losses}")
    images8, labels8 = (torch.from_numpy(a).to("cuda") for a in data[0])
    # Each step's time, and the host's share of it: the time until
    # train_step returns, having queued the step's work (it reads nothing
    # back). Near the step's time, the host holds the card back.
    step_ms, host_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        trainer.train_step(state, images8, labels8)
        host_ms.append((time.perf_counter() - tic) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - tic) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer, state
    return {"params": n_params, "batch": 8, "steps": WIDE_STEPS,
            "fit_seconds": fit_s, "losses": losses, "launches": launches,
            "step_ms_median": float(np.median(step_ms)),
            "step_ms_min": min(step_ms),
            "step_host_ms_median": float(np.median(host_ms)),
            "peak_memory_gib": peak_gib,
            "step_vs_cpu": {"batch": 1, "blocks": 2, "dtype": "float32",
                            "loss_card": gpu_loss, "loss_cpu": cpu_loss,
                            "loss_rel_err": loss_err, "loss_tol": loss_tol,
                            "grad_worst": worst, "grad_tol": grad_tol}}


def _host_info() -> dict:
    """The host's cores and load, and the card's SM clock against its
    maximum: what launch-bound times (serving at batch 1, an eager train
    step) vary with from one machine to the next."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {"cpus": os.cpu_count(), "load_avg": os.getloadavg(),
            "sm_clock": smi.stdout.strip().splitlines()[:1]}


def phase_wide_heads() -> dict:
    """A detector at ViT-H/14's attention widths (K = 80, the flash
    kernels' 128-wide instance): (a) the instance's routes against the
    plain versions, (b) its times beside SDPA and the bound, (c) serving
    through DetectionService, (d) training through Trainer.fit."""
    import torch

    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        count_params, init_params)

    tic = time.monotonic()
    kernels = _wide_kernels()
    times = _wide_times()
    config = _wide_config()
    params = init_params(config, torch.Generator().manual_seed(SEED))
    n_params = count_params(params)
    serve = _wide_serve(config, params)
    del params
    torch.cuda.empty_cache()
    train = _wide_train(config)
    torch.cuda.empty_cache()
    _report("wide_heads", config=WIDE_CONFIG, params=n_params,
            seconds=time.monotonic() - tic, kernels=kernels, times=times,
            serve=serve, train=train, host=_host_info())
    return {"kernels": kernels, "times": times, "serve": serve,
            "train": train}


WALKTHROUGH_EPOCHS = 4


def phase_walkthrough() -> dict:
    """examples/end_to_end_torch.py on the card (tiny_96 with flash
    attention, WALKTHROUGH_EPOCHS epochs): every stage's JSON line and
    artifact, the served detections well-formed, the flash kernels
    launched in training and inference, the artifact server stopped."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as workdir:
        tic = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "examples",
                                          "end_to_end_torch.py"),
             "--device", "cuda", "--epochs", str(WALKTHROUGH_EPOCHS),
             "--workdir", workdir], cwd=root, capture_output=True,
            text=True, timeout=600)
        seconds = time.monotonic() - tic
        _require(proc.returncode == 0,
                 f"walkthrough exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        lines = [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        stages = {line["stage"]: line for line in lines if "stage" in line}
        _require(tuple(stages) == ("dataset", "train", "evaluate", "plot",
                                   "visualize", "export", "serve"),
                 f"walkthrough stages {list(stages)}")
        summary = lines[-1]
        _require(summary.get("ok") is True and summary["device"] == "cuda",
                 f"walkthrough summary {summary}")
        missing = [a for a in summary["artifacts"]
                   if not os.path.exists(os.path.join(workdir, a))]
        _require(not missing, f"walkthrough artifacts missing: {missing}")
        with open(os.path.join(workdir, "served.json")) as f:
            served = json.load(f)
        size = (served["image_size"]["height"], served["image_size"]["width"])
        _check_detections(served, size, 80)
        _require(len(served["detections"]) > 0, "no served detection")
        train = stages["train"]["launches"]
        _require(train["forward_lse"] > 0 and train["backward"] > 0
                 and train["forward"] > 0,
                 f"walkthrough training launched {train}")
        _require(stages["export"]["platforms"] == ["cuda"]
                 and stages["serve"]["server_exit_code"] == 0,
                 f"walkthrough export/serve {stages['export']} "
                 f"{stages['serve']}")
    result = {"seconds": seconds, "epochs": WALKTHROUGH_EPOCHS,
              "stages": stages, "artifacts": summary["artifacts"],
              "served_detections": len(served["detections"])}
    _report("walkthrough", **result)
    return result


PEAK_NAMES = {"bf16": "bf16 989 TFLOP/s", "int8": "int8 1979 TOP/s",
              "3xtf32": "tf32 495 TFLOP/s, 3 products per fp32 product",
              "fp32": "fp32 67 TFLOP/s"}


def _entry(name, source, replaces, shape, launches, err, times, work):
    """One kernel of the kernels line; ``work`` is (operations, bytes,
    kind) for its bound; ``replaces`` is a place in the JAX package's
    kernels/ unless it names its directory."""
    bound = _bound(*work)
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": (replaces if "/" in replaces
                         else TPU_KERNELS + replaces), "shape": shape,
            "launches": launches, "max_abs_err": err,
            "ms": times["kernel_ms"], "plain_ms": times["plain_ms"],
            "library_ms": times.get("library_ms"),
            "bound_ms": bound[0], "bound_by": bound[1],
            "peak": PEAK_NAMES[work[2]]}


def _wide_entries(wide: dict) -> list:
    """The 128-wide instance's rows (wide_heads): B1 at the service's
    batch 32, B1-lse and B2 at the train step's batch 8, each shape (B *
    16, 256, 80) bf16 padded to 128, with the launches of (c) and (d) and
    the errors against the plain versions measured at that shape (B1-lse's
    is its lse's, as for the 64-wide row; B2's the largest of dq, dk,
    dv)."""
    times = wide["times"]
    serve_key, train_key = "512x256x80", "128x256x80"
    rows = []
    for name, what, replaces, key, launches, err in (
            ("flash_attention_fwd_d128", "fwd", "flash_attention.py:64",
             serve_key, wide["serve"]["launches_per_call"]["flash"], "fwd"),
            ("flash_attention_fwd_lse_d128", "fwd_lse",
             "flash_attention.py:653", train_key,
             wide["train"]["launches"]["flash_lse"], "lse"),
            ("flash_attention_bwd_d128", "bwd", "flash_attention.py:151",
             train_key, wide["train"]["launches"]["flash_bwd"], "bwd_abs")):
        t = times[key][what]
        errors = times[key]["errors"]
        bh, n, kd = (int(x) for x in key.split("x"))
        rows.append({
            "name": name, "route": "cuda",
            "source": CSRC + ("flash_attention_bwd.cu" if what == "bwd"
                              else "flash_attention_fwd.cu"),
            "replaces": TPU_KERNELS + replaces,
            "shape": [bh, n, kd, "bfloat16", "padded to 128"],
            "launches": launches, "max_abs_err": errors[err],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "peak": PEAK_NAMES["bf16"],
            "launch_source": ("wide_heads (c), one DetectionService call"
                              if what == "fwd" else
                              f"wide_heads (d), {WIDE_STEPS} train steps"),
            "times_2048x256x128": dict(
                times["2048x256x128"][what],
                max_abs_err=times["2048x256x128"]["errors"][err])})
    return rows


def _kernels_line(flash_err, flash_times, train_errors, train_times,
                  drop_errors, drop_times, mlp_errors, mlp_times,
                  serve_errors, serve_times, launches, exported,
                  graph, ring, wide_heads, walkthrough) -> dict:
    """The kernels of every path, each with its launches on its main path,
    its error against its plain version, its times and its bound; B1, B3
    and B4 also with their launches per call of the exported program
    (``launches_exported``), and the four flash kernels and the MLP
    dropout kernel of the train step with their launches in the windowed
    loop's CUDA-graph fits (``launches_graph``: kernel nodes of the graph
    x replays); and the flash kernels as the blocks of ring attention in
    the parallel phase (``ring``: one rank of R = 2 at highres_1024_ring's
    shape, its queries against the whole sequence; launches of both
    processes in the highres_1024_ring training run; the R block launches
    timed with CUDA events, the whole ring's forward and backward on the
    host clock beside them in ``ring_host_ms``), and a tensor-parallel
    rank's B1-drop, B2-replay and MLP dropout with their coordinate maps
    (``*_sharded``: launches of both processes of (g)); the 128-wide
    instance's B1, B1-lse and B2 (``*_d128``, wide_heads), and the 48-wide
    ones' launches in the walkthrough (``launches_walkthrough``)."""
    bh, n, k = 12, 576, 64                     # vit_b16_384, batch 1
    flash_bytes = 4 * bh * n * k * 2
    tbh, tn, tk = 64, 1296, 40                 # reference_608, batch 8
    qkv = tbh * tn * tk * 4
    hbh, hn, hk = 2048, 256, 64                # highres_1024, batch 8
    hqkv = hbh * hn * hk * 2                   # one bf16 operand
    rows, d, wide = 576 * 32, 768, 1536        # vit_b16_384, batch 32
    mlp_n = 1
    for size in MLP_DROP_SHAPES[0]:            # highres_1024, batch 8
        mlp_n *= size
    rb, rn, rh, rk = RING_TOKENS               # highres_1024_ring, batch 2
    local = rn // 2                            # this rank's queries, R = 2
    ring_q = rb * local * rh * rk * 2          # bf16 bytes of local q
    ring_kv = rb * rn * rh * rk * 2            # bf16 bytes of all of k
    ring_lse = rb * rh * local * 4
    mapped = ring["mapped"]
    mb, mbh_per, mt, mk = mapped["rank_shape"]   # one TP rank, heads-major
    mbh = mb * mbh_per
    mqkv = mbh * mt * mk * 2                   # one bf16 operand
    map_n = MAP_MLP[0] * MAP_MLP[1] * MAP_MLP[2] // 2
    walked = walkthrough["stages"]["train"]["launches"]
    return {"kernels": [
        dict(_entry("flash_attention_fwd", "flash_attention_fwd.cu",
                    "flash_attention.py:64", [bh, n, k, "bfloat16"],
                    launches["flash"], flash_err, flash_times[1],
                    (4 * bh * n * n * k, flash_bytes, "bf16")),
             launches_exported=exported["flash"],
             launches_walkthrough=walked["forward"]),
        dict(_entry("flash_attention_fwd_lse", "flash_attention_fwd.cu",
                    "flash_attention.py:653", [tbh, tn, tk, "float32"],
                    launches["flash_lse"], train_errors["lse_abs"],
                    train_times["fwd_lse"],
                    (4 * tbh * tn * tn * tk, 4 * qkv + tbh * tn * 4,
                     "3xtf32")),
             launches_graph=graph["flash_lse"],
             launches_walkthrough=walked["forward_lse"]),
        dict(_entry("flash_attention_bwd", "flash_attention_bwd.cu",
                    "flash_attention.py:151", [tbh, tn, tk, "float32"],
                    launches["flash_bwd"], train_errors["bwd_abs"],
                    train_times["bwd"],
                    (10 * tbh * tn * tn * tk, 7 * qkv + 2 * tbh * tn * 4,
                     "3xtf32")),
             launches_graph=graph["flash_bwd"],
             launches_walkthrough=walked["backward"]),
        *_wide_entries(wide_heads),
        # q, k, v read, out written (bf16), lse written (fp32).
        dict(_entry("flash_attention_fwd_drop", "flash_attention_fwd.cu",
                    "flash_attention.py:679",
                    [hbh, hn, hk, "bfloat16", DROP_RATE],
                    launches["flash_drop"], drop_errors["out_abs"],
                    drop_times["fwd_drop"],
                    (4 * hbh * hn * hn * hk, 4 * hqkv + hbh * hn * 4,
                     "bf16")),
             launches_graph=graph["flash_drop"]),
        # q, k, v, g read and dk, dv written (bf16), lse and delta read and
        # dq written (fp32).
        dict(_entry("flash_attention_bwd_drop", "flash_attention_bwd.cu",
                    "flash_attention.py:151",
                    [hbh, hn, hk, "bfloat16", DROP_RATE],
                    launches["flash_bwd_drop"], drop_errors["bwd_abs"],
                    drop_times["bwd_drop"],
                    (10 * hbh * hn * hn * hk,
                     6 * hqkv + 2 * hqkv + 2 * hbh * hn * 4, "bf16")),
             launches_graph=graph["flash_bwd_drop"]),
        # x read and out written (bf16), the seed read; about 12 integer
        # operations of the hash per element, counted at the fp32 rate.
        dict(_entry("dropout", "dropout.cu",
                    "vision_transformer_detector_tpu/models/"
                    "vit_detector.py:317",
                    [*MLP_DROP_SHAPES[0], "bfloat16", DROP_RATE],
                    launches["mlp_drop"],
                    max(e["max_abs_err"] for e in mlp_errors.values()),
                    mlp_times, (12 * mlp_n, 4 * mlp_n + 4, "fp32")),
             launches_graph=graph["mlp_drop"]),
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
        dict(_entry("layer_norm", "layer_norm.cu", "fused_ln.py:37",
                    [rows, d, "bfloat16"], launches["layer_norm"],
                    serve_errors["layer_norm"],
                    serve_times[f"layer_norm_B=32_{rows}x768_bf16"],
                    (7 * rows * d, 2 * rows * d * 2 + 2 * d * 4, "fp32")),
             launches_exported=exported["layer_norm"]),
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
             launches_exported=exported["dense_mish"],
             # `ms` is the wgmma instance's (the one this shape selects);
             # the mma.sync instance on the same inputs beside it.
             mma_sync_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_bf16"]["mma_sync_ms"],
             # The same shape in fp32, 3xTF32 on mma.sync.
             fp32_ms=serve_times[f"dense_mish_B=32_{rows}x768x1536_fp32"][
                 "kernel_ms"],
             fp32_plain_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_fp32"]["plain_ms"],
             fp32_unfused_library_ms=serve_times[
                 f"dense_mish_B=32_{rows}x768x1536_fp32"][
                     "unfused_library_ms"],
             fp32_bound_ms=_bound(2 * rows * d * wide,
                                  (rows * d + d * wide + wide
                                   + rows * wide) * 4, "3xtf32")[0]),
        # The ring's blocks (B1-lse, the fp32-output instance): local q,
        # all of k and v read (bf16), the local out and lse (fp32)
        # written.
        dict(_entry("ring_attention_fwd", "flash_attention_fwd.cu",
                    "vision_transformer_detector_tpu/kernels/"
                    "ring_attention.py:34",
                    [rb, local, rh, rk, "bfloat16", "R=2"],
                    ring["launches"]["lse"], ring["errors"]["fwd"],
                    ring["times"]["fwd"],
                    (4 * rb * rh * local * rn * rk,
                     3 * ring_q + 2 * ring_kv + ring_lse, "bf16")),
             kernel="B1-lse, one launch per ring step, bf16 in and fp32 "
                    "out (the fp32-output instance)",
             ring_host_ms=ring["host_ms"]["fwd_host_ms"],
             ring_host_clock="the whole ring forward, host clock, the "
             "exchange staged through the host over gloo on one card"),
        # Its backward (B2): local q and g read (bf16), dq written (fp32);
        # all of k and v read and their dk, dv written; lse and delta read.
        dict(_entry("ring_attention_bwd", "flash_attention_bwd.cu",
                    "vision_transformer_detector_tpu/kernels/"
                    "ring_attention.py:34",
                    [rb, local, rh, rk, "bfloat16", "R=2"],
                    ring["launches"]["bwd"], ring["errors"]["bwd"],
                    ring["times"]["bwd"],
                    (10 * rb * rh * local * rn * rk,
                     4 * ring_q + 4 * ring_kv + 2 * ring_lse, "bf16")),
             kernel="B2, one launch per ring step",
             ring_host_ms=ring["host_ms"]["bwd_host_ms"],
             ring_host_clock="the whole ring backward, host clock, the "
             "exchange staged through the host over gloo on one card"),
        # A tensor-parallel rank's B1-drop with the batch*head map (8 of
        # 16 heads of highres_1024 at batch 2, heads-major windows): q, k,
        # v read and out written (bf16), lse written (fp32).
        dict(_entry("flash_attention_fwd_drop_sharded",
                    "flash_attention_fwd.cu", "flash_attention.py:679",
                    [*mapped["rank_shape"], "bfloat16", DROP_RATE],
                    mapped["launches"]["flash_drop"],
                    mapped["errors"]["fwd"], mapped["times"]["fwd"],
                    (4 * mbh * mt * mt * mk, 4 * mqkv + mbh * mt * 4,
                     "bf16")),
             kernel="B1-drop, the batch*head map (8 W, 16 W, h0 W)",
             launch_source="both processes of (g), tensor parallelism"),
        dict(_entry("flash_attention_bwd_drop_sharded",
                    "flash_attention_bwd.cu", "flash_attention.py:151",
                    [*mapped["rank_shape"], "bfloat16", DROP_RATE],
                    mapped["launches"]["flash_bwd_drop"],
                    mapped["errors"]["bwd"], mapped["times"]["bwd"],
                    (10 * mbh * mt * mt * mk,
                     6 * mqkv + 2 * mqkv + 2 * mbh * mt * 4, "bf16")),
             kernel="B2-replay, the batch*head map",
             launch_source="both processes of (g), tensor parallelism"),
        # A tensor-parallel rank's column half of highres_1024's first
        # pyramid activation at batch 2: x read, out written (bf16).
        dict(_entry("dropout_sharded", "dropout.cu",
                    "vision_transformer_detector_tpu/models/"
                    "vit_detector.py:317",
                    [MAP_MLP[0], MAP_MLP[1], MAP_MLP[2] // 2, "bfloat16",
                     DROP_RATE],
                    mapped["launches"]["mlp_drop"],
                    mapped["errors"]["mlp"], mapped["times"]["mlp"],
                    (12 * map_n, 4 * map_n + 4, "fp32")),
             kernel="the MLP/head dropout with the column base",
             launch_source="both processes of (g), tensor parallelism"),
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
    mlp_errors, mlp_times = phase_kernel_mlp_drop()
    serve_errors, serve_times = phase_kernel_serve()
    phase_model()
    phase_model_serve()
    flash_launches = phase_serve()
    int8_launches, int8_times = phase_serve_int8()
    ffn_launches, _ = phase_serve_fused_ffn()
    train_launches = phase_train()
    highres_launches = phase_train_highres()
    window_launches = phase_train_window()
    phase_cli_tools()
    exported_launches = phase_lifecycle()
    # The images/s the card consumes on each path of this run (8 images a
    # train step, 32 a service call), beside the host decode's rate.
    steps = window_launches["step_ms_graph"]
    phase_native_host({
        "reference_608_graph_step": ("reference_608",
                                     8e3 / steps["reference_608"]),
        "highres_1024_graph_step": ("highres_1024",
                                    8e3 / steps["highres_1024"]),
        "int8_service_b32": ("vit_b16_384",
                             32e3 / int8_times["int8"]["b32_ms_median"])})
    wide = phase_wide_heads()
    walk = phase_walkthrough()
    ring = phase_parallel()
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
                "mlp_drop": highres_launches["mlp_drop"],
                "int8_fused_tc": int8_launches["int8_fused_tc"],
                "int8_dense_tc": int8_launches["int8_dense_tc"],
                "dense_mish_tc": ffn_launches["dense_mish_tc"]}
    print(json.dumps(_kernels_line(flash_err, flash_times, train_errors,
                                   train_times, drop_errors, drop_times,
                                   mlp_errors, mlp_times, serve_errors,
                                   serve_times, launches, exported_launches,
                                   window_launches, ring, wide, walk)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
