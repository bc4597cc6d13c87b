"""Command-line entry point of the PyTorch port: ``serve`` only, for now.

  python -m vision_transformer_detector_tpu_torch.cli serve \
      --preset vit_b16_384 --bf16 [--params-npz params.npz] [--device cuda]

Takes the JAX CLI's model flags that serving reads and its serve flags;
weights come from a ``save_params_npz`` file or, without one, from a
seeded initialisation. The HTTP loop is the JAX CLI's own ``_serve``
(which imports no JAX). ``--int8`` and ``--from-export`` are not ported
yet and are refused.
"""

from __future__ import annotations

import argparse

from vision_transformer_detector_tpu.config import DetectorConfig, get_config


def _build_config(args) -> DetectorConfig:
    config = get_config(args.preset)
    overrides = {}
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.flash_attention and args.no_flash_attention:
        raise SystemExit("--flash-attention and --no-flash-attention "
                         "are mutually exclusive")
    if args.flash_attention:
        overrides["use_flash_attention"] = True
    if args.no_flash_attention:
        overrides["use_flash_attention"] = False
    return config.replace(**overrides) if overrides else config


def cmd_serve(args) -> None:
    import torch

    from vision_transformer_detector_tpu.cli import _serve

    from .models.vit_detector import init_params
    from .serving import DetectionService
    from .utils.checkpoint import load_params_npz
    from .utils.device import resolve_device

    for flag, given in (("--int8", args.int8),
                        ("--from-export", args.from_export)):
        if given:
            raise SystemExit(f"{flag} is not ported to PyTorch yet")
    config = _build_config(args)
    device = resolve_device(args.device)
    if args.params_npz:
        params = load_params_npz(args.params_npz, config)
    else:
        params = init_params(config, torch.Generator().manual_seed(0))
    service = DetectionService(config, params, device=device,
                               iou_threshold=args.nms_iou_threshold,
                               score_threshold=args.score_threshold)
    _serve(args, service)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vision_transformer_detector_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("serve", help="HTTP detection endpoint")
    p.add_argument("--preset", default="reference_608",
                   help="config preset name (see config.PRESETS)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype")
    p.add_argument("--flash-attention", action="store_true")
    p.add_argument("--no-flash-attention", action="store_true",
                   help="force the plain attention path")
    p.add_argument("--params-npz", default=None,
                   help="load params from a save_params_npz .npz file")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--nms-iou-threshold", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--int8", action="store_true",
                   help="not ported yet (refused)")
    batching = p.add_mutually_exclusive_group()
    batching.add_argument(
        "--batching", dest="batching", action="store_true",
        help="route concurrent requests through the micro-batcher (one "
             "device call serves up to --max-batch requests)")
    batching.add_argument(
        "--no-batching", dest="batching", action="store_false",
        help="dispatch each request directly (the default)")
    p.set_defaults(batching=False)
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batcher cap (device call batch size)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="max extra latency spent collecting a batch")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds before a queued request gets HTTP 503")
    p.add_argument("--max-body-mb", type=int, default=32,
                   help="reject request bodies above this size (HTTP 413)")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="bound concurrent predictions (excess gets "
                        "HTTP 429)")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="not ported yet (refused)")
    p.set_defaults(func=cmd_serve)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
