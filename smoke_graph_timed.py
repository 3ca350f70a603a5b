#!/usr/bin/env python3
"""Run another checkout's chip_smoke.py with this tree's kernel timing.

    python3 smoke_graph_timed.py DIR

DIR is a checkout of an earlier commit of this repository (for example one
unpacked with `git archive` into an ignored directory) whose chip_smoke.py
times its kernels in time_cases(cases, results).  That script runs from DIR,
on DIR's package and kernels, with its time_cases replaced by this tree's:
each kernel by CUDA-graph replay (graph_time_ms), each plain version with
CUDA events around its calls.  The two trees' kernel times then come from
one method, and can be compared within one call.  When that script exits 0,
this tree's time_chains then times DIR's doubling kernels K3 and K8 at the
chain shapes (chip_smoke.CHAIN_SHAPES): a tree whose wrappers take no step
count runs a chain of n as n launches, all captured in the one graph; and
this tree's time_k1 times DIR's K1 at its three shapes and DIR's pow_const
(a tree without the chain kernel runs it as its loop of K1 launches, in the
one graph).  The exit code is DIR's script's.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    other = Path(argv[0]).resolve()
    ours = load("chip_smoke_timing", Path(__file__).resolve().parent / "chip_smoke.py")
    os.chdir(other)
    sys.path.insert(0, str(other))
    theirs = load("chip_smoke", other / "chip_smoke.py")
    if not hasattr(theirs, "time_cases"):
        raise SystemExit(f"{other / 'chip_smoke.py'} has no time_cases to replace")
    theirs.time_cases = ours.time_cases
    rc = theirs.main()
    if rc == 0:
        dev = ours.torch.device("cuda", 0)
        ours.time_chains(dev, None)
        ours.time_k1(dev, None)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
