"""The readings a cell's correctness limits are set from.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--faults half_batch] [--seconds 3] \
        [--out chiprun_out/readings.json]

For each seed: one run of the cell as ``run.py`` makes it (set-up, a short
window of ``--seconds``, the check), printing the numbers compared. Then
the control on ``--control-seeds`` seeds: the plain reference with its
products in float8 e4m3 put in the program's place. Then each fault of
``--faults`` (``perfbench/faults.py``) planted in the program on as many
seeds. Every reading is one JSON line on standard output and all of them
go to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def seeds(count: int, base: int):
    return [base + 7919 * i for i in range(count)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--base", type=int, default=3_000_000_017)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    parser.add_argument("--leaves", action="store_true",
                        help="keep a training check's per-leaf norms")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import faults, harness, manifest

    cell = manifest.cell(args.workload, ROOT)
    readings = []

    def emit(kind, seed, numbers, **extra):
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "numbers": numbers, **extra}
        readings.append(line)
        print(json.dumps({k: v for k, v in line.items() if k != "detail"}),
              flush=True)

    def tidy():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    for seed in seeds(args.seeds, args.base):
        run = harness.run_cell(cell, seed, args.seconds, False, args.device,
                               time.perf_counter())
        emit("program", seed, run.numbers, end_to_end=run.end_to_end,
             setup_s=run.setup_s, failed=run.failed,
             **({"detail": run.detail} if args.leaves else {}))
        del run
        tidy()
    for seed in seeds(args.control_seeds, args.base + 1):
        run = harness.Run(cell, seed, args.seconds, args.device)
        driver = manifest.driver(cell.traffic["kind"])(run)
        driver.make_inputs()
        emit("control", seed, driver.control(),
             **({"detail": run.detail} if args.leaves else {}))
        del run, driver
        tidy()
    for fault in filter(None, args.faults.split(",")):
        for seed in seeds(args.control_seeds, args.base + 2):
            with faults.planted(fault):
                run = harness.run_cell(cell, seed, args.seconds, False,
                                       args.device, time.perf_counter())
            emit("fault:" + fault, seed, run.numbers)
            del run
            tidy()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    for kind in sorted({r["kind"] for r in readings}):
        rows = [r["numbers"] for r in readings if r["kind"] == kind]
        summary = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                   for k in rows[0]}
        print(json.dumps({"kind": kind, "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
