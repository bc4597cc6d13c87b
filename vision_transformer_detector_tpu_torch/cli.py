"""Command-line entry point of the PyTorch port (``vtd-torch``): the
deployment lifecycle of the JAX CLI.

  python -m vision_transformer_detector_tpu_torch.cli train \
      --train-images DIR --train-annotations ann.json [--preset tiny_96]
  python -m vision_transformer_detector_tpu_torch.cli evaluate \
      --val-images DIR --val-annotations ann.json --restore final \
      --protocol coco-original --dump-detections dets.json
  python -m vision_transformer_detector_tpu_torch.cli score-coco \
      --annotations ann.json --results dets.json
  python -m vision_transformer_detector_tpu_torch.cli export \
      --restore final --batch-sizes 1 8 --bake-postprocess [--platforms cpu]
  python -m vision_transformer_detector_tpu_torch.cli serve \
      --from-export exported_model [--batching] [--device cpu]

plus ``predict``, ``visualize``, ``plot`` and ``stats``. Each subcommand
takes the JAX CLI's flags that this port supports; the others (the mesh
flags, ``--distributed``, ``--resumable``, ``--epochs-per-call``) are not
declared, so argparse refuses them. Every model subcommand takes
``--device`` (default ``cuda``, which fails without a card); ``export``
names its device with ``--platforms``: one of ``cuda`` or ``cpu``, the
device the artifact is traced on and runs on. ``serve``: weights come
from a ``save_params_npz`` file or a seeded initialisation, ``--int8``
quantizes them (kernels/quantization.py), and ``--from-export`` serves an
artifact instead and refuses ``--int8`` and ``--params-npz``. The other
model subcommands load a train checkpoint with ``--restore``. The fused
LayerNorm kernel has no flag: set ``DetectorConfig.use_fused_layer_norm``
from Python.
"""

from __future__ import annotations

import argparse
import json
import sys

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


def _load_params(args, config, device):
    """The model's weights on ``device``: a ``save_params_npz`` file,
    else a train checkpoint (``--restore NAME`` or ``latest``) through the
    Trainer, else the seeded initialisation (seed 0), as in the JAX
    CLI."""
    from .train.trainer import Trainer
    from .utils.checkpoint import load_params_npz
    from .utils.device import resolve_device

    device = resolve_device(device)
    if args.params_npz:
        return load_params_npz(args.params_npz, config).to(device)
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir,
                      device=device)
    state = trainer.init_state()
    if args.restore == "latest":
        state = trainer.restore_latest(state)
    elif args.restore:
        state = trainer.restore(state, args.restore)
    return state["params"]


def cmd_serve(args) -> None:
    import torch

    from .serving import DetectionService, ExportedDetectionService

    if args.from_export:
        # The frozen artifact owns its weights and precision: refuse the
        # model flags rather than ignore them.
        ignored = [flag for flag, given in (
            ("--int8", args.int8),
            ("--params-npz", args.params_npz)) if given]
        if ignored:
            raise SystemExit(
                "--from-export serves the frozen artifact and cannot "
                f"honour {', '.join(ignored)}; bake the model into the "
                "artifact at `export` time instead")
        service = ExportedDetectionService(
            args.from_export, iou_threshold=args.nms_iou_threshold,
            score_threshold=args.score_threshold, device=args.device)
        _serve(args, service)
        return

    from .kernels.quantization import quantize_params
    from .models.vit_detector import init_params
    from .utils.checkpoint import load_params_npz
    from .utils.device import resolve_device

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


def _build_dataset(args, config, images, annotations, shuffle=False,
                   drop_remainder=True):
    """The host pipeline's dataset, uint8 images (the train and eval
    steps normalise on the device)."""
    from .data.annotations import load_annotations_dict
    from .data.pipeline import CocoDetectionDataset, list_image_paths

    start, end = args.images_range
    paths = list_image_paths(images,
                             images_range=(start, end if end >= 0 else None),
                             shuffle=shuffle, seed=getattr(args, "seed", 0))
    return CocoDetectionDataset(
        paths, load_annotations_dict(annotations), config,
        batch_size=args.batch_size, drop_remainder=drop_remainder,
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


def cmd_evaluate(args) -> None:
    from .train.trainer import evaluate_map

    config = _build_config(args)
    protocol = args.protocol
    dump = args.dump_detections
    if dump and protocol != "coco-original":
        raise SystemExit("--dump-detections requires "
                         "--protocol coco-original (detections are "
                         "dumped in original-frame pixels)")
    params = _load_params(args, config, args.device)
    if protocol == "coco-original":
        from .data.annotations import load_annotations_dict
        from .metrics.coco_eval import evaluate_coco_protocol_original_frame

        start, end = args.images_range
        summary = evaluate_coco_protocol_original_frame(
            params, args.val_images,
            load_annotations_dict(args.val_annotations), config,
            batch_size=args.batch_size,
            objectness_threshold=args.objectness_threshold,
            images_range=(start, end if end >= 0 else None),
            dump_detections=dump, per_category=args.per_category,
            fast_decode=args.fast_decode)
        out = {"protocol": "coco-original", **summary}
        if dump:
            out["dumped_detections"] = dump
        print(json.dumps(out))
        return
    # The reference's metric drops the ragged final batch, as its tf.data
    # pipeline did; the official protocol scores every image.
    data = _build_dataset(args, config, args.val_images,
                          args.val_annotations,
                          drop_remainder=(protocol != "coco"))
    if len(data) == 0:
        raise SystemExit(
            f"no evaluation batches: {args.val_images!r} matched no "
            "images, or --batch-size exceeds the dataset size")
    if protocol == "coco":
        from .metrics.coco_eval import evaluate_coco_protocol

        summary = evaluate_coco_protocol(
            params, data, config,
            objectness_threshold=args.objectness_threshold,
            per_category=args.per_category)
        print(json.dumps({"protocol": "coco", **summary}))
    else:
        print(json.dumps({"mAP": evaluate_map(params, data, config)}))


def cmd_score_coco(args) -> None:
    """Standalone official-protocol scoring of a COCO results JSON
    against ground truth; no model or device involved."""
    from .metrics.coco_eval import score_coco_results

    summary = score_coco_results(args.annotations, args.results,
                                 per_category=args.per_category)
    print(json.dumps({"protocol": "coco", **summary}))


def _letterboxed_chunks(args, config):
    """``(paths, images)`` chunks of ``--batch-size`` letterboxed [-1, 1]
    float images from ``--images``."""
    import numpy as np

    from .data.pipeline import list_image_paths, load_and_letterbox_image

    start, end = args.images_range
    paths = list_image_paths(args.images,
                             images_range=(start, end if end >= 0 else None))
    # Chunked: one stack of thousands of images would exhaust the host.
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        yield i, chunk, np.stack([
            load_and_letterbox_image(p, config,
                                     fast_decode=args.fast_decode)[0]
            for p in chunk])


def cmd_predict(args) -> None:
    import torch

    from .train.trainer import make_eval_step

    config = _build_config(args)
    params = _load_params(args, config, args.device)
    eval_step = make_eval_step(config)
    device = next(params.parameters()).device
    outputs = []
    for _, chunk, images in _letterboxed_chunks(args, config):
        decoded = eval_step(params, torch.from_numpy(images).to(device))
        for path, dets in zip(chunk, decoded.float().cpu().numpy()):
            outputs.append({"image": path, "detections": dets.tolist()})
    json.dump(outputs, sys.stdout)
    print()


def cmd_visualize(args) -> None:
    import torch

    from .train.trainer import make_predict_step
    from .utils.visualize import visualize_predictions

    config = _build_config(args)
    params = _load_params(args, config, args.device)
    predict_step = make_predict_step(config)
    device = next(params.parameters()).device
    written: list = []
    for i, _, images in _letterboxed_chunks(args, config):
        raw = predict_step(params, torch.from_numpy(images).to(device))
        written.extend(visualize_predictions(
            images, raw.float().cpu().numpy(), args.output_dir,
            objectness_threshold=args.objectness_threshold,
            classification_threshold=args.classification_threshold,
            config=config, start_index=i))
    out = {"written": written}
    if args.contact_sheet:
        from .utils.visualize import write_contact_sheet
        out["contact_sheet"] = write_contact_sheet(
            written, args.contact_sheet)
    print(json.dumps(out))


def cmd_export(args) -> None:
    from .export import DEVICE_TYPES, save_exported

    platforms = args.platforms or ["cuda"]
    if len(platforms) != 1 or platforms[0] not in DEVICE_TYPES:
        raise SystemExit(
            f"--platforms takes one of {list(DEVICE_TYPES)} (the device the "
            f"programs are traced on), got {platforms}")
    config = _build_config(args)
    params = _load_params(args, config, platforms[0])
    batch = args.batch_sizes if args.batch_sizes else args.batch_size
    postprocess = None
    if args.bake_postprocess:
        postprocess = {"k": args.nms_k,
                       "iou_threshold": args.nms_iou_threshold,
                       "score_threshold": args.score_threshold,
                       "per_class": not args.class_agnostic_nms}
    path = save_exported(args.output_dir, params, config, batch_size=batch,
                         device=platforms[0], postprocess=postprocess)
    print(json.dumps({"exported": path, "batch_size": batch,
                      "platforms": platforms, "postprocess": postprocess}))


def cmd_plot(args) -> None:
    from .utils.plotting import plot_training_curves

    print(json.dumps({"written": plot_training_curves(args.metrics,
                                                      args.output)}))


def cmd_stats(args) -> None:
    from .data.annotations import load_annotations_dict
    from .data.statistics import (
        coco_statistics, coco_statistics_multi_processing)

    annotations = load_annotations_dict(args.annotations)
    names = list(annotations)[: args.images_quantity or None]
    if args.multi_processing:
        result = coco_statistics_multi_processing(names, annotations)
    else:
        result = coco_statistics(names, annotations)
    print(json.dumps(result, indent=2))


def _add_model_args(p, device: bool = True) -> None:
    """The JAX CLI's model flags (``_add_model_args``) and, unless the
    subcommand names its device otherwise, ``--device``."""
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
    p.add_argument("--params-npz", default=None,
                   help="load params from a save_params_npz .npz file")
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when no GPU is "
                            "visible")


def _add_image_args(p) -> None:
    p.add_argument("--images-range", type=int, nargs=2, default=(0, -1),
                   metavar=("START", "END"))
    p.add_argument("--on-corrupt", choices=("raise", "skip"),
                   default="raise",
                   help="policy for undecodable image files")
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-domain reduced-scale JPEG decode")
    p.add_argument("--decode-pool", choices=("thread", "process"),
                   default="thread")


def _add_train_parser(sub) -> None:
    """The JAX CLI's train flags (vision_transformer_detector_tpu/cli.py)
    that this port supports; argparse refuses the others."""
    p = sub.add_parser("train", help="train a detector")
    _add_model_args(p)
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="also write step-stamped checkpoints at each "
                        "periodic save, pruned to the newest K")
    _add_image_args(p)
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
                   help="serve a torch.export artifact (`export`) instead "
                        "of building the model; pair with a multi-batch "
                        "bundle for the micro-batcher. The artifact runs on "
                        "the device type it was exported on")
    p.set_defaults(func=cmd_serve)

    _add_train_parser(sub)

    p = sub.add_parser("evaluate", help="compute mAP on a dataset")
    _add_model_args(p)
    _add_image_args(p)
    p.add_argument("--val-images", required=True)
    p.add_argument("--val-annotations", required=True)
    p.add_argument("--protocol",
                   choices=("custom", "coco", "coco-original"),
                   default="custom",
                   help="'custom' = the reference's streaming metric; "
                        "'coco' = the official COCO protocol on "
                        "letterboxed-frame boxes; 'coco-original' = the "
                        "official protocol in original image coordinates "
                        "(metrics/coco_eval.py)")
    p.add_argument("--objectness-threshold", type=float, default=0.0,
                   help="coco protocols only: drop detections at or below "
                        "this objectness (default keeps all)")
    p.add_argument("--dump-detections", default=None, metavar="PATH",
                   help="coco-original protocol only: also write every "
                        "detection in the standard COCO results format "
                        "(original-frame pixels, COCO category ids)")
    p.add_argument("--per-category", action="store_true",
                   help="coco protocols: include the per-class AP "
                        "breakdown (AP_per_category)")
    p.set_defaults(func=cmd_evaluate)

    p = sub.add_parser(
        "score-coco",
        help="score a COCO results JSON against ground truth (official "
             "protocol; no model involved)")
    p.add_argument("--annotations", required=True,
                   help="a full COCO instances JSON or an annotation-dict "
                        "JSON (data/annotations.py)")
    p.add_argument("--results", required=True,
                   help="standard COCO results list (what evaluate "
                        "--dump-detections writes)")
    p.add_argument("--per-category", action="store_true",
                   help="include the per-class AP breakdown")
    p.set_defaults(func=cmd_score_coco)

    p = sub.add_parser("predict", help="decoded detections as json")
    _add_model_args(p)
    _add_image_args(p)
    p.add_argument("--images", required=True)
    p.set_defaults(func=cmd_predict)

    p = sub.add_parser("visualize", help="render detections to PNGs")
    _add_model_args(p)
    _add_image_args(p)
    p.add_argument("--images", required=True)
    p.add_argument("--output-dir", default="visualizations")
    p.add_argument("--objectness-threshold", type=float, default=0.5)
    p.add_argument("--classification-threshold", type=float, default=0.5)
    p.add_argument("--contact-sheet", default=None, metavar="PATH",
                   help="also bundle the PNGs into one self-contained "
                        "interactive HTML sheet")
    p.set_defaults(func=cmd_visualize)

    p = sub.add_parser("export", help="write a torch.export artifact")
    _add_model_args(p, device=False)      # --platforms names the device
    p.add_argument("--output-dir", default="exported_model")
    p.add_argument("--batch-sizes", type=int, nargs="*", default=None,
                   help="export a bundle with one graph per batch size; "
                        "the loader routes requests to the smallest "
                        "fitting graph (overrides --batch-size)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="the one device type the programs are traced on "
                        "and will run on: cuda (default: the kernels as "
                        "custom operators) or cpu (the plain versions)")
    p.add_argument("--bake-postprocess", action="store_true",
                   help="bake NMS + top-k (ops/nms.py) into the exported "
                        "graphs; 'serve --from-export' honours the baked "
                        "spec")
    p.add_argument("--nms-k", type=int, default=17,
                   help="top-k kept per image when baking postprocess")
    p.add_argument("--nms-iou-threshold", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--class-agnostic-nms", action="store_true",
                   help="suppress across classes (default: per-class)")
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("plot", help="loss/AP training curves")
    p.add_argument("--metrics", required=True)
    p.add_argument("--output", default="loss-AP-scatters.html")
    p.set_defaults(func=cmd_plot)

    p = sub.add_parser("stats", help="COCO dataset statistics")
    p.add_argument("--annotations", required=True)
    p.add_argument("--images-quantity", type=int, default=0)
    p.add_argument("--multi-processing", action="store_true")
    p.set_defaults(func=cmd_stats)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
