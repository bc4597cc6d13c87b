"""Command-line entry point of the PyTorch port: ``serve`` and ``train``.

  python -m vision_transformer_detector_tpu_torch.cli serve \
      --preset vit_b16_384 --bf16 [--params-npz params.npz] [--device cuda]
  python -m vision_transformer_detector_tpu_torch.cli train \
      --train-images DIR --train-annotations ann.json \
      [--val-images DIR --val-annotations ann.json] [--preset reference_608]

Each subcommand takes the JAX CLI's flags that this port supports and
refuses the others with SystemExit. ``serve``: weights come from a
``save_params_npz`` file or, without one, from a seeded initialisation;
``--int8`` quantizes them after loading (kernels/quantization.py), as the
JAX CLI does; the HTTP loop ``_serve`` is a copy of the JAX CLI's;
``--from-export`` is refused. Both subcommands take ``--fused-ffn`` (the
fused dense+mish kernel). ``train``: the datasets are built from the
port's copy of the host pipeline (data/pipeline.py, data/annotations.py)
and ship uint8; the JAX CLI's mesh, ``--distributed``, ``--resumable``
and ``--epochs-per-call`` flags are not declared, so argparse refuses
them. The fused LayerNorm kernel has no flag in either CLI: set
``DetectorConfig.use_fused_layer_norm`` from Python.
"""

from __future__ import annotations

import argparse
import json

from .config import DetectorConfig, LossConfig, TrainConfig, get_config


def _positive_int(value: str) -> int:
    n = int(value)
    if n <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, "
                                         f"got {value}")
    return n


def _build_config(args) -> DetectorConfig:
    config = get_config(args.preset)
    overrides = {}
    if getattr(args, "image_size", None):
        overrides["image_size"] = (args.image_size, args.image_size)
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.flash_attention and args.no_flash_attention:
        raise SystemExit("--flash-attention and --no-flash-attention "
                         "are mutually exclusive")
    if args.flash_attention:
        overrides["use_flash_attention"] = True
    if args.no_flash_attention:
        # Everywhere, as in the JAX CLI: the train-only override too.
        overrides["use_flash_attention"] = False
        overrides["train_use_flash_attention"] = False
    if args.fused_ffn:
        overrides["use_fused_ffn"] = True
    return config.replace(**overrides) if overrides else config


def cmd_serve(args) -> None:
    import torch

    from .kernels.quantization import quantize_params
    from .models.vit_detector import init_params
    from .serving import DetectionService
    from .utils.checkpoint import load_params_npz
    from .utils.device import resolve_device

    if args.from_export:
        raise SystemExit("--from-export is not ported to PyTorch yet")
    config = _build_config(args)
    device = resolve_device(args.device)
    if args.params_npz:
        params = load_params_npz(args.params_npz, config)
    else:
        params = init_params(config, torch.Generator().manual_seed(0))
    if args.int8:
        params = quantize_params(params)
    service = DetectionService(config, params, device=device,
                               iou_threshold=args.nms_iou_threshold,
                               score_threshold=args.score_threshold)
    _serve(args, service)


def _serve(args, service) -> None:
    """The JAX CLI's HTTP loop (vision_transformer_detector_tpu/cli.py
    ``_serve``), copied as it is."""
    import signal
    import threading

    from .serving import DetectionServer
    server = DetectionServer(service, host=args.host, port=args.port,
                             batching=args.batching,
                             max_batch=args.max_batch,
                             max_wait_ms=args.batch_window_ms,
                             request_timeout=args.request_timeout,
                             max_body_bytes=args.max_body_mb * 1024 * 1024,
                             max_inflight=args.max_inflight)
    from .data import pipeline as _pipe
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "endpoints": ["/healthz", "/stats",
                                    "POST /predict"],
                      # Which JPEG decode core handles request payloads
                      # (round-4 verdict #2: a silent PIL fallback looked
                      # identical to the native path from the outside).
                      "decode_core": ("native" if _pipe.native_available()
                                      else "pil")}),
          flush=True)
    # Serve on a worker thread so SIGTERM/SIGINT can drive a graceful
    # stop (shutdown() must not be called from the serving thread).
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    stop.wait()
    print(json.dumps({"stopping": True}), flush=True)
    server.stop()   # drains in-flight batches, then stops the batcher


def _build_dataset(args, config, images, annotations, shuffle=False):
    """The host pipeline's dataset, uint8 images (the train and eval
    steps normalise on the device)."""
    from .data.annotations import load_annotations_dict
    from .data.pipeline import CocoDetectionDataset, list_image_paths

    start, end = args.images_range
    paths = list_image_paths(images,
                             images_range=(start, end if end >= 0 else None),
                             shuffle=shuffle, seed=args.seed)
    return CocoDetectionDataset(
        paths, load_annotations_dict(annotations), config,
        batch_size=args.batch_size, drop_remainder=True,
        on_corrupt=args.on_corrupt, normalize=False,
        fast_decode=args.fast_decode, pool=args.decode_pool)


def cmd_train(args) -> None:
    from .train.trainer import Trainer
    from .utils.checkpoint import load_params_npz

    config = _build_config(args)
    moments = "bfloat16" if args.bf16_moments else None
    train_config = TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        epochs=args.epochs, epochs_warm_up=args.epochs_warm_up,
        skip_epochs=args.skip_epochs, seed=args.seed,
        adam_mu_dtype=moments, adam_nu_dtype=moments)
    train_data = _build_dataset(args, config, args.train_images,
                                args.train_annotations, shuffle=args.shuffle)
    eval_data = None
    if args.val_images and args.val_annotations:
        eval_data = _build_dataset(args, config, args.val_images,
                                   args.val_annotations)
    trainer = Trainer(config, LossConfig(), train_config,
                      steps_per_epoch=max(1, len(train_data)),
                      checkpoint_dir=args.checkpoint_dir,
                      keep_checkpoints=args.keep_checkpoints,
                      metrics_path=args.metrics, device=args.device)
    state = trainer.init_state()
    if args.params_npz:
        state["params"].load_state_dict(
            load_params_npz(args.params_npz, config).state_dict())
    if args.restore == "latest":
        state = trainer.restore_latest(state)
    elif args.restore:
        state = trainer.restore(state, args.restore)
    state = trainer.fit(state, train_data, epochs=args.epochs,
                        eval_data=eval_data)
    trainer.save(state, name="final")
    trainer.metrics.close()
    print(json.dumps({"best_ap": trainer.best_ap,
                      "final_loss": trainer.loss_record[-1]
                      if trainer.loss_record else None}))


def _add_train_parser(sub) -> None:
    """The JAX CLI's train flags (vision_transformer_detector_tpu/cli.py)
    that this port supports; argparse refuses the others."""
    p = sub.add_parser("train", help="train a detector")
    p.add_argument("--preset", default="reference_608",
                   help="config preset name (see config.PRESETS)")
    p.add_argument("--image-size", type=_positive_int, default=None)
    p.add_argument("--batch-size", type=_positive_int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype")
    p.add_argument("--flash-attention", action="store_true")
    p.add_argument("--no-flash-attention", action="store_true",
                   help="force the plain attention path everywhere, the "
                        "train-only flash override included")
    p.add_argument("--fused-ffn", action="store_true",
                   help="dense+mish pyramid layers through the fused "
                        "kernel (kernels/fused_ffn.py)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--restore", default=None,
                   help="checkpoint name to restore (e.g. 'ongoing'), or "
                        "'latest' for the newest step-stamped checkpoint")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="also write step-stamped checkpoints at each "
                        "periodic save, pruned to the newest K")
    p.add_argument("--params-npz", default=None,
                   help="start from a save_params_npz .npz file")
    p.add_argument("--images-range", type=int, nargs=2, default=(0, -1),
                   metavar=("START", "END"))
    p.add_argument("--on-corrupt", choices=("raise", "skip"),
                   default="raise",
                   help="policy for undecodable image files")
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-domain reduced-scale JPEG decode")
    p.add_argument("--decode-pool", choices=("thread", "process"),
                   default="thread")
    p.add_argument("--train-images", required=True)
    p.add_argument("--train-annotations", required=True)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--val-images", default=None)
    p.add_argument("--val-annotations", default=None)
    p.add_argument("--epochs", type=int, default=12_502)
    p.add_argument("--learning-rate", type=float, default=8e-5)
    p.add_argument("--epochs-warm-up", type=int, default=500)
    p.add_argument("--skip-epochs", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", default="metrics.jsonl")
    p.add_argument("--bf16-moments", action="store_true",
                   help="store Adam moment state in bf16 (fp32 arithmetic, "
                        "stochastically rounded nu)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    p.set_defaults(func=cmd_train)


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
    p.add_argument("--fused-ffn", action="store_true",
                   help="dense+mish pyramid layers through the fused "
                        "kernel (kernels/fused_ffn.py)")
    p.add_argument("--params-npz", default=None,
                   help="load params from a save_params_npz .npz file")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--nms-iou-threshold", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--int8", action="store_true",
                   help="serve int8-quantized weights through the fused "
                        "int8 dense kernel (kernels/quantization.py)")
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

    _add_train_parser(sub)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
