"""The flash forward at vit_b16_384's serving shape, and the serving call
around it, on one GPU.

Times, for the package tree given by ``--root`` (default: this checkout):

  * ``b1``: the bf16 flash forward (``flash_attention``, no lse, no
    dropout) at vit_b16_384's serving shape, one image: (B, N, H, K) =
    (1, 576, 12, 64), tokens-major as the model hands it over. ``ms`` is
    the time per call of ``--calls`` calls issued back to back between two
    CUDA events (the rate at which the host can launch them: at this
    size the host sets it); ``host_ms`` the host's wall time per call of
    the same calls before the sync; ``sdpa_ms`` the same for
    ``scaled_dot_product_attention`` on the heads-major views;
  * ``predict_b1``: the device path of ``DetectionService`` (vit_b16_384,
    bf16, flash attention, seeded random weights) at batch 1, as
    chip_smoke.py's ``serve`` phase takes it: ``predict_raw`` and the
    packed result on the host, synced, median and min of 20 calls after 3.

Prints one JSON line, then the card's name and power limit. To compare two
trees on one card, run it once per tree in one command, in the order
a, b, b, a.

Usage: python tools/time_flash_serving_torch.py [--root DIR] [--label L]
           [--calls 200]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from vision_transformer_detector_tpu_torch import get_config
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa)
    from vision_transformer_detector_tpu_torch.models.vit_detector import (
        init_params)
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 576, 12, 64, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    q = q * 64 ** -0.5
    hm = [t.transpose(1, 2) for t in (q, k, v)]

    def per_call(fn) -> tuple:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        tic = time.perf_counter()
        for _ in range(args.calls):
            fn()
        host = (time.perf_counter() - tic) * 1e3 / args.calls
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.calls, host

    err = float((fa.flash_attention(q, k, v).float()
                 - fa.reference_attention(q, k, v).float()).abs().max())
    kernel = per_call(lambda: fa.flash_attention(q, k, v))
    sdpa = per_call(lambda: F.scaled_dot_product_attention(*hm))

    config = get_config("vit_b16_384")
    service = DetectionService(
        config, init_params(config, torch.Generator().manual_seed(0)),
        device="cuda")
    canvas = np.zeros((1, *config.image_size, 3), np.uint8)
    for _ in range(3):
        service.raw_to_detections(service.predict_raw(canvas))
    device_ms = []
    for _ in range(20):
        tic = time.perf_counter()
        service.raw_to_detections(service.predict_raw(canvas))
        device_ms.append((time.perf_counter() - tic) * 1e3)
    print(json.dumps({
        "label": args.label, "root": args.root,
        "b1": {"shape": [1, 576, 12, 64], "dtype": "bfloat16",
               "ms": kernel[0], "host_ms": kernel[1], "sdpa_ms": sdpa[0],
               "sdpa_host_ms": sdpa[1], "max_abs_err": err,
               "calls": args.calls},
        "predict_b1": {"ms_median": float(np.median(device_ms)),
                       "ms_min": min(device_ms)}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
