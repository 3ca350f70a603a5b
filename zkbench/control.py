#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the program's
place with one of the configuration's guarantees broken (its ``control``
key), judged by the cell's own comparison against the sound reference.  It
has to come out as not correct on every seed.

From the root of a checkout, on the card (the runs of the benchmark never
run this):
    python3 zkbench/control.py --workload <name> --seeds <n>,<n>,... --jobs <k>

``--jobs`` is how many answers a run checks; each seed prints the numbers
compared beside their limits, and the last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from zkbench import harness  # noqa: E402
from zkbench.traffic import Traffic  # noqa: E402


def readings(cell: harness.Cell, seed: int, jobs: int, device) -> list:
    """[(name, value, limit)] of the control on one seed."""
    entry = harness.load_entry(cell.config)
    traffic = Traffic(cell.traffic, seed)
    inputs = entry.make_inputs(cell.config, traffic)
    ref = entry.Reference(cell.config, inputs, device)
    expected = {k: ref.answer(traffic.job(k)) for k in range(jobs)}
    control = {k: ref.answer(traffic.job(k), control=True) for k in range(jobs)}
    return entry.compare(control, expected, cell.config["limits"])


def main() -> int:
    ap = argparse.ArgumentParser(description="Run a cell's control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    cell = harness.find_cell(args.workload)
    device = torch.device(args.device)
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        checks = readings(cell, seed, args.jobs, device)
        failed = any(v > lim for _, v, lim in checks)
        print(f"# control {args.workload} seed {seed} ({time.perf_counter() - t} s): "
              + ", ".join(f"{n} {v} limit {lim}" for n, v, lim in checks)
              + (" -> not correct" if failed else " -> PASSES, the check does not catch it"))
        out[seed] = {n: v for n, v, _ in checks}
    print(json.dumps({"workload": args.workload, "jobs": args.jobs, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
