"""Sweep of fixed offered rates for an open-loop cell: where the batcher
stops keeping up (the knee).

    python3 perfbench/tools/sweep_rate.py --workload vit_b16_384.serve_open \
        --rates 200,400,600,800 [--seconds 10] [--seed 1] [--out file]

Sets the cell up once, then offers each rate for ``--seconds`` on the
cell's own schedule generator and prints one JSON line a rate: the
completed rate, p50 / p95 latency (from when each request was due), how
late the generator ran, the requests still queued when the last one was
sent (backlog), and how long after the window the last answer came. The
knee is the highest rate whose backlog stays near zero and whose last
answer comes within a batch's time of the close. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from perfbench import harness, manifest

    cell = manifest.cell(args.workload, ROOT)
    run = harness.Run(cell, args.seed, args.seconds, args.device)
    driver = manifest.driver("open_loop")(run)
    driver.setup()
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        driver.schedule(rate, args.seconds, f"sweep.{rate:g}")
        before = driver.batcher.stats()
        late = driver.offer(args.seconds)
        after = driver.batcher.stats()
        done = np.isfinite(driver.latency)
        lat = np.where(done, driver.latency, driver.timeout) * 1e3
        finish = float(np.nanmax(driver.latency + driver.due))
        batches = after["batches_served"] - before["batches_served"]
        row = {"rate_per_s": rate, "requests": len(lat),
               "completed_per_s": float(done.sum()) / finish,
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "batch_mean": (after["images_served"]
                              - before["images_served"]) / max(1, batches),
               "late_p95_ms": float(np.percentile(late, 95) * 1e3),
               "backlog_at_last_send":
                   run.counters["queue_depth_at_last_send"],
               "last_answer_after_close_s": finish - args.seconds,
               "failed": int((~done).sum())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        time.sleep(1.0)
    driver.release()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
