#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port (vision_transformer_detector_tpu_torch) through its main
path, serving the ViT-B/16 384px detector over HTTP, and checks each
hand-written kernel on that path against its plain PyTorch version.
Phases, one output line each:

  1. build   — compile every kernel of the path from csrc/ with nvcc;
  2. kernel  — flash attention against reference_attention on the card,
               in bf16 and fp32: the serving shape (B*H, N, K) =
               (12, 576, 64), (96, 576, 64), and the ragged (8, 1296, 40)
               that the wrapper pads to K = 64; times both at
               (B*12, 576, 64) bf16 for B = 1 and 64;
  3. model   — vit_b16_384 in fp32 on one seeded image: the kernel path
               on the card against the plain path on the CPU;
  4. serve   — vit_b16_384 in bf16 with seeded random weights behind
               DetectionServer on port 0: POSTs seeded JPEGs, checks the
               answers and GET /stats, and that the flash kernel ran 12
               times (once per encoder block) per request.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with each kernel's launches, error and times, and as the last line
{"ok": true, "device": {...}}. Any failed check ends the run with a
non-zero exit and no result line; so does a host without a CUDA device,
or a directory without the port's sources. Imports no JAX.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import urllib.request

REQUESTS = 4            # HTTP requests in the serving phase
SEED = 0


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


def phase_build():
    from vision_transformer_detector_tpu_torch.kernels import _build

    tic = time.monotonic()
    _build.load_library("flash_attention_fwd.cu")
    ptxas = [line.strip() for log in _build.BUILD_LOGS.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    _report("build", seconds=round(time.monotonic() - tic, 3),
            ptxas=ptxas)


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
    # ragged (8, 1296, 40) that the wrapper pads to K = 64.
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

    times = {}
    for batch in (1, 64):
        q, key, v = qkv(batch, 12, 576, 64, torch.bfloat16)
        runs = {"kernel_ms": lambda: flash_attention(q, key, v,
                                                     layout="bhnk"),
                "plain_ms": lambda: reference_attention(q, key, v,
                                                        layout="bhnk")}
        # In turns (plain, kernel, kernel, plain), averaged per side.
        order = ("plain_ms", "kernel_ms", "kernel_ms", "plain_ms")
        sums = {name: 0.0 for name in runs}
        for name in order:
            sums[name] += _time_ms(runs[name], 50) / 2
        times[batch] = sums
    _report("kernel", max_abs_err=errors,
            times_bf16_576x64={f"B={b}": t for b, t in times.items()})
    return errors["12x576x64_bfloat16"], times[1]


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
    err, times = phase_kernel()
    phase_model()
    launches = phase_serve()
    _require("jax" not in sys.modules, "JAX was imported")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "vision_transformer_detector_tpu_torch/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "vision_transformer_detector_tpu/kernels/"
                    "flash_attention.py:64",
        "launches": launches,
        "max_abs_err": err,
        "ms": times["kernel_ms"],
        "plain_ms": times["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
