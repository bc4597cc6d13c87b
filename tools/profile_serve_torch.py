"""Where the time of one PyTorch-port serving call goes, on one GPU.

Builds the vit_b16_384 service (bf16, flash attention) three ways on the
same seeded weights: as it is (``bf16``), int8-quantized with the fused
LayerNorm (``int8``, what ``vtd-torch serve --int8`` runs with
``use_fused_layer_norm``), and with the fused dense+mish and the fused
LayerNorm (``fused_ffn``). For each, at each batch: the median wall time
of the device path (``predict_raw`` + the packed result on the host,
synced) over 20 calls, then ``torch.profiler`` over 5 calls: device time
per call by kernel group (the port's flash, int8 dense, LayerNorm and
dense+mish kernels, cuBLAS GEMMs, everything else), the device's busy
share of the profiled wall time, and kernel launches per call. Prints one
JSON line per (service, batch), then the card's name and power limit.

Usage: python tools/profile_serve_torch.py [--batches 1 32]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Kernel name fragments of each group; a kernel goes to the first match.
GROUPS = (("flash", ("flash_fwd_kernel", "flash_bwd_kernel")),
          ("int8_dense", ("int8_dense_kernel", "int8_dense_wgmma_kernel")),
          ("layer_norm", ("layer_norm_kernel",)),
          ("dense_mish", ("dense_mish_kernel", "dense_mish_mma_kernel",
                          "dense_mish_wgmma_kernel")),
          ("gemm", ("gemm", "xmma", "cutlass", "nvjet")))


def _group(name: str) -> str:
    for group, parts in GROUPS:
        if any(part in name.lower() for part in parts):
            return group
    return "other"


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", type=int, nargs="+", default=[1, 32])
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vision_transformer_detector_tpu_torch import get_config
    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve_torch: needs a CUDA device")
    config = get_config("vit_b16_384")
    fused_ln = config.replace(use_fused_layer_norm=True)
    params = init_params(config, torch.Generator().manual_seed(0))
    services = {
        "int8": DetectionService(fused_ln, quantize_params(params)),
        "fused_ffn": DetectionService(fused_ln.replace(use_fused_ffn=True),
                                      params),
        "bf16": DetectionService(config, params),
    }
    for batch in args.batches:
        canvas = np.zeros((batch, *config.image_size, 3), np.uint8)
        for name, service in services.items():
            def call():
                service.raw_to_detections(service.predict_raw(canvas))

            for _ in range(3):
                call()
            wall = []
            for _ in range(20):
                tic = time.perf_counter()
                call()
                wall.append((time.perf_counter() - tic) * 1e3)
            calls = 5
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tic = time.perf_counter()
                for _ in range(calls):
                    call()
                profiled_ms = (time.perf_counter() - tic) * 1e3 / calls
            groups, launches = {}, 0
            for evt in prof.key_averages():
                if evt.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                group = _group(evt.key)
                groups[group] = groups.get(group, 0.0) + us / 1e3 / calls
                launches += evt.count
            busy = sum(groups.values())
            if busy <= 0:
                raise SystemExit("profile_serve_torch: the profiler saw no "
                                 "device time; time with CUDA events instead")
            print(json.dumps({
                "service": name, "batch": batch,
                "wall_ms_median": float(np.median(wall)),
                "wall_ms_min": min(wall), "profiled_wall_ms": profiled_ms,
                "device_busy_ms": busy, "busy_share": busy / profiled_ms,
                "ms_by_group": dict(sorted(groups.items(),
                                           key=lambda kv: -kv[1])),
                "kernel_launches_per_call": launches / calls}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
