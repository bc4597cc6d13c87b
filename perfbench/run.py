"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers end standard error. Exits non-zero, printing no result,
without a card, or when JAX or the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Whole top-level module names that must never load in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "vision_transformer_detector_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its CUDA libraries into its own ``build/`` directory
    there; these cover any PyTorch extension or Triton cache."""
    out = os.path.join(ROOT, "perfbench", "out")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(out, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(out, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness, manifest, report

    cell = manifest.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded in the run: {found}",
              file=sys.stderr)
        return 4
    result = report.result(run, cell, bool(args.trace))
    for note in run.notes:
        print(note, file=sys.stderr)
    for line in report.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
