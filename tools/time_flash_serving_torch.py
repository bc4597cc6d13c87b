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
  * ``bwd``: the flash backward (``flash_attention._launch_backward``,
    what the autograd Function's backward calls, dq in q's dtype) at the
    ViT-H/14-width detector's (B*H, N, K) = (128, 256, 80), (8, 256, 16,
    80) tokens-major, and at highres_1024's (2048, 256, 64), (8, 256, 256,
    64) heads-major; ``ms`` and ``host_ms`` as for ``b1``, and beside them
    ``sdpa_ms``/``sdpa_host_ms`` of scaled_dot_product_attention's
    backward on the same inputs (``torch.autograd.grad`` with
    ``retain_graph``: the autograd engine's own host time included);
  * ``predict_b1``: the device path of ``DetectionService`` (vit_b16_384,
    bf16, flash attention, seeded random weights) at batch 1, as
    chip_smoke.py's ``serve`` phase takes it: ``predict_raw`` and the
    packed result on the host, synced, median and min of ``--predict-calls``
    calls (default 100) after 3.

Prints one JSON line, then the card's name and power limit. To compare two
trees on one card, run it once per tree in one command, in the order
a, b, b, a.

Usage: python tools/time_flash_serving_torch.py [--root DIR] [--label L]
           [--calls 200] [--predict-calls 100]
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
    parser.add_argument("--predict-calls", type=int, default=100)
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

    bwd = {}
    for name, memory, layout in (("128x256x80", (8, 256, 16, 80), "bnhk"),
                                 ("2048x256x64", (8, 256, 256, 64), "bhnk")):
        bq, bk, bv, bg = (torch.randn(memory, device="cuda", generator=gen)
                          .to(torch.bfloat16) for _ in range(4))
        bq = bq * memory[-1] ** -0.5
        out, lse = fa._launch_forward(bq, bk, bv, layout, with_lse=True)
        delta = fa._heads_major((bg.float() * out.float()).sum(-1),
                                layout).contiguous()
        timed = per_call(lambda: fa._launch_backward(
            bq, bk, bv, bg, lse, delta, layout))
        leaves = [fa._heads_major(t, layout).detach().clone()
                  .requires_grad_() for t in (bq, bk, bv)]
        lib_out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        lib_g = fa._heads_major(bg, layout)
        lib = per_call(lambda: torch.autograd.grad(
            lib_out, leaves, lib_g, retain_graph=True))
        bwd[name] = {"layout": layout, "ms": timed[0], "host_ms": timed[1],
                     "sdpa_ms": lib[0], "sdpa_host_ms": lib[1]}
        del bq, bk, bv, bg, out, lse, delta, leaves, lib_out, lib_g

    config = get_config("vit_b16_384")
    service = DetectionService(
        config, init_params(config, torch.Generator().manual_seed(0)),
        device="cuda")
    canvas = np.zeros((1, *config.image_size, 3), np.uint8)
    for _ in range(3):
        service.raw_to_detections(service.predict_raw(canvas))
    device_ms = []
    for _ in range(args.predict_calls):
        tic = time.perf_counter()
        service.raw_to_detections(service.predict_raw(canvas))
        device_ms.append((time.perf_counter() - tic) * 1e3)
    print(json.dumps({
        "label": args.label, "root": args.root,
        "b1": {"shape": [1, 576, 12, 64], "dtype": "bfloat16",
               "ms": kernel[0], "host_ms": kernel[1], "sdpa_ms": sdpa[0],
               "sdpa_host_ms": sdpa[1], "max_abs_err": err,
               "calls": args.calls},
        "bwd": bwd,
        "predict_b1": {"ms_median": float(np.median(device_ms)),
                       "ms_min": min(device_ms)}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
