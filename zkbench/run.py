#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA device of this machine.

From the root of a checkout:
    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up's parts, the card, each job's time and the reference's
time on earlier lines, each compared number beside its limit as the last
lines of standard error, and one JSON result as the last line of standard
output.  Exits non-zero, printing no result, without enough CUDA devices,
when a forbidden module (JAX or the JAX package) was loaded, or when the
program under test is not in the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache at a fixed path inside the checkout, so that
# only a checkout's first run builds.  The program keeps its nvcc builds in
# its own myzkp_tpu_torch/_build/.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(ROOT, ".zkbench_cache", _sub)
sys.path[0] = ROOT

from zkbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
