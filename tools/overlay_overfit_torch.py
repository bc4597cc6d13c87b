"""Overlay the port's overfit trajectory against the reference's recorded
run: the PyTorch port's counterpart of tools/overlay_overfit.py, drawn
with the port's utils/plotting.py.

The reference's only measured training run (ipynb cell 7 stream output,
TF 2.9.1, single GPU, 2022-09-18) logged 13 (epoch, eval-loss, AP) points
at epochs 500, 1500, ..., 12500 with LR decays at 1000/10000/11000. This
tool reads a matched-configuration run's metrics jsonl (from
examples/overfit_demo_torch.py --eval-every 1000 --metrics FILE, or
`vtd-torch train --metrics FILE`) and writes the loss + AP overlay chart
and prints a side-by-side table.

Usage: python tools/overlay_overfit_torch.py \
           --metrics overfit_torch_metrics.jsonl \
           [--output overlay_overfit_torch.html]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# ipynb cell 7 stream output: "Checking the AP after epoch N" + eval line.
REFERENCE_TRAJECTORY = [
    # (epoch, eval_loss, AP)
    (500, 2.9804, 0.4522),
    (1500, 1.0112, 0.7930),
    (2500, 0.6949, 0.8625),
    (3500, 0.5426, 0.8643),
    (4500, 0.3680, 0.8984),
    (5500, 0.4938, 0.9043),
    (6500, 0.4679, 0.9020),
    (7500, 0.3168, 0.9225),
    (8500, 0.2650, 0.9467),
    (9500, 0.2098, 0.9760),
    (10500, 0.0484, 0.9987),
    (11500, 0.0353, 1.0000),
    (12500, 0.0322, 0.9991),
]


def overlay(metrics: str, output: str) -> dict:
    """Write the overlay chart of ``metrics`` against the reference's run
    to ``output``; returns {"plot": path, "table": rows}."""
    from vision_transformer_detector_tpu_torch.utils.plotting import (
        read_metrics, scatters_plot)

    epochs, losses, ap_epochs, aps = read_metrics(metrics)
    loss_at = dict(zip(epochs, losses))
    ap_at = dict(zip(ap_epochs, aps))

    ref_e = [e for e, _, _ in REFERENCE_TRAJECTORY]
    ref_loss = [loss for _, loss, _ in REFERENCE_TRAJECTORY]
    ref_ap = [ap for _, _, ap in REFERENCE_TRAJECTORY]

    ours_e = [e for e in ref_e if e in loss_at]
    scatters = [
        (ref_e, ref_loss, "reference loss (TF/GPU 2022)"),
        (ours_e, [loss_at[e] for e in ours_e], "this port's loss (PyTorch)"),
        (ref_e, ref_ap, "reference AP"),
        ([e for e in ref_e if e in ap_at],
         [ap_at[e] for e in ref_e if e in ap_at], "this port's AP"),
    ]
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    path = scatters_plot(
        scatters,
        ("8-image overfit: loss + AP vs the reference's recorded run",
         "epoch", "loss / AP"),
        output)
    rows = [{"epoch": e, "ref_loss": rl,
             "our_loss": round(loss_at.get(e, float("nan")), 4),
             "ref_ap": ra, "our_ap": round(ap_at.get(e, float("nan")), 4)}
            for e, rl, ra in REFERENCE_TRAJECTORY]
    return {"plot": path, "table": rows}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--metrics", required=True,
                        help="jsonl from examples/overfit_demo_torch.py "
                             "--eval-every 1000")
    parser.add_argument("--output", default="overlay_overfit_torch.html")
    args = parser.parse_args(argv)
    print(json.dumps(overlay(args.metrics, args.output), indent=1))


if __name__ == "__main__":
    main()
