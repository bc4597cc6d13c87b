"""The reference's headline overfit run on the PyTorch port, one GPU.

The same 8 synthetic images as examples/overfit_demo.py (solid-colour
boxes on a flat background, seed 7), the reference_608 detector in fp32
(flash attention in training through the port's CUDA kernels), batch 8,
lr 8e-5, eval every 500 epochs after a 500-epoch warm-up, through the
port's Trainer. Prints one JSON line with the AP and loss at each eval,
the wall time, and the card's name and power limit.

Usage: python examples/overfit_demo_torch.py [--epochs 3001] [--seed 0]
       [--epochs-per-call 100] [--no-train-flash]
       [--metrics overfit_torch_metrics.jsonl]

``--no-train-flash`` trains on the plain matmul attention route instead
of the kernels, to tell the kernels' numerics from the rest of the port.
``--epochs-per-call K`` trains through the windowed loop (the train
step as a CUDA graph, replayed up to K epochs per call, windows cut at
the evals).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3001,
                        help="3001 puts the last eval at epoch 3000")
    parser.add_argument("--learning-rate", type=float, default=8e-5)
    parser.add_argument("--eval-every", type=int, default=500)
    parser.add_argument("--warm-up", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weight initialisation")
    parser.add_argument("--no-train-flash", action="store_true",
                        help="train on the plain attention route")
    parser.add_argument("--metrics", default="overfit_torch_metrics.jsonl")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs-per-call", type=int, default=1,
                        help="epochs per call of the windowed loop")
    args = parser.parse_args()

    import torch

    from overfit_demo import synthetic_coco_batch
    from vision_transformer_detector_tpu_torch import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector_tpu_torch.train.trainer import Trainer

    config = get_config("reference_608")
    if args.no_train_flash:
        config = config.replace(train_use_flash_attention=False)
    train_config = TrainConfig(
        learning_rate=args.learning_rate, epochs=args.epochs,
        epochs_warm_up=args.warm_up, skip_epochs=args.eval_every,
        seed=args.seed)
    trainer = Trainer(config, LossConfig(), train_config,
                      metrics_path=args.metrics, device=args.device)
    state = trainer.init_state()
    data = [synthetic_coco_batch(config, 8)]

    tic = time.time()
    state = trainer.fit(state, data, epochs=args.epochs, eval_data=data,
                        epochs_per_call=args.epochs_per_call)
    seconds = time.time() - tic
    trainer.metrics.close()

    card = None
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    with open(args.metrics) as f:
        records = [json.loads(line) for line in f]
    print(json.dumps({
        "best_ap": trainer.best_ap,
        "evals": [{"epoch": r["epoch"], "ap": r["ap"], "loss": r["loss"]}
                  for r in records if "ap" in r],
        "final_loss": trainer.loss_record[-1],
        "epochs": args.epochs,
        "seed": args.seed,
        "train_flash": config.train_use_flash_attention,
        "epochs_per_call": args.epochs_per_call,
        "seconds": seconds,
        "epochs_per_second": args.epochs / seconds,
        "card": card,
    }))


if __name__ == "__main__":
    main()
