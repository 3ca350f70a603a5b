#!/usr/bin/env python3
"""Time the complete-add kernels built with other values of their unroll
constants, on one GPU.

Run from the repository root:  python3 unroll_sweep.py

The constants are the rows of the Montgomery product unrolled in the code of
K2 and the G1 level (MYZKP_K2_UNROLL, csrc/curve.cu) and of the G2 lane
pair's products (MYZKP_PAIR2_UNROLL, csrc/pair.cuh).  Each variant is the
library that _ext builds with one -D definition (_ext.use_defines), and the
variants not yet built are built at once.  Per variant it prints ptxas's
registers and spills and the static SASS counts (chip_smoke.sass_counts) of
the add kernels, then the device time (CUDA-graph replay, chip_smoke.graph_time_ms)
of K2 without a mask and of K9 at 32,768 and 4,194,304 points, of K7 with its
mask on 1 lane in 32 at 32,768 lanes and of the G2 level with no flag set at
d = 1 on (2, 16384) lanes, each through its entry point in curve_kernels.
K2 at 32,768 points and K7 are held to their plain versions bit for bit.
The last line is a JSON object of every time.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs

VARIANTS = {
    "tree": (),
    "k2_unroll8": ("MYZKP_K2_UNROLL=8",),
    "k2_unroll2": ("MYZKP_K2_UNROLL=2",),
    "k7_unroll8": ("MYZKP_PAIR2_UNROLL=8",),
    "k7_unroll4": ("MYZKP_PAIR2_UNROLL=4",),
    "k7_unroll1": ("MYZKP_PAIR2_UNROLL=1",),
}
KERNELS = ("padd_kernel", "padd_mixed_kernel", "padd_seg_level_kernel", "padd2_kernel",
           "padd2_seg_level_kernel")
K2_WIDTHS = (1 << 15, 1 << 22)
LANES = 1 << 15


def check(name: str, got, want) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")


def main() -> int:
    cs.phase_device()
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    todo = [d for d in VARIANTS.values() if not _ext.library_path(d).exists()]
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        seconds = list(pool.map(_ext.build, todo))
    cs.log(f"# built {len(todo)} variants at once in {max(seconds, default=0):.1f} s")
    for name, defines in VARIANTS.items():
        text = _ext.library_path(defines).with_suffix(".log").read_text()
        fn = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = next((k for k in KERNELS if f"{k}P" in line or f"{k}E" in line), None)
            elif fn and ("registers" in line or "spill" in line):
                cs.log(f"# {name} ptxas {fn}: {line.split(':', 1)[-1].strip()}")
        sass = cs.sass_counts(_ext.library_path(defines))
        for k in KERNELS:
            c = sass[k]
            cs.log(f"# {name} sass {k}: total {c['total']}, IMAD {c['IMAD']}, IADD3 "
                   f"{c['IADD3']}, LDL {c['LDL']}, STL {c['STL']}, SHFL {c['SHFL']}")

    dev = torch.device("cuda", 0)
    spec = bn254.q_spec()
    b3, b32 = bn254.g1_b3((), dev), bn254.g2_b3((), dev)
    rng = np.random.default_rng(cs.SEED)
    times = {name: {} for name in VARIANTS}
    for n in K2_WIDTHS:
        P = tuple(cs.random_fe(rng, n, dev) for _ in range(3))
        Q = tuple(cs.random_fe(rng, n, dev) for _ in range(3))
        want = ck.padd_ref(spec, b3, P, Q) if n == LANES else None
        reps = 5 if n > LANES else 20
        for name, defines in VARIANTS.items():
            _ext.use_defines(defines)
            if want is not None:
                check(f"{name}: K2 at {n} points", ck.padd(spec, b3, P, Q), want)
            t2 = cs.graph_time_ms(lambda: ck.padd(spec, b3, P, Q), reps)
            t9 = cs.graph_time_ms(lambda: ck.padd_mixed(spec, b3, P, Q[0], Q[1]), reps)
            times[name][f"padd_{n}"], times[name][f"padd_mixed_{n}"] = t2, t9
            cs.log(f"# {name} n = {n}: K2 {t2:.4f} ms, K9 {t9:.4f} ms")
        del P, Q, want

    pair = lambda: tuple((cs.random_fe(rng, LANES, dev), cs.random_fe(rng, LANES, dev))
                         for _ in range(3))
    P2, Q2 = pair(), pair()
    h = torch.arange(LANES, device=dev) % 32 == 0
    want = ck._leaves2(ck.padd2_ref(spec, b32, P2, Q2, h))
    x = tuple(tuple(c.reshape(16, 2, LANES // 2) for c in e) for e in P2)
    flags = torch.zeros((2, LANES // 2), dtype=torch.bool, device=dev)
    for name, defines in VARIANTS.items():
        _ext.use_defines(defines)
        check(f"{name}: K7", ck._leaves2(ck.padd2(spec, b32, P2, Q2, h)), want)
        t7 = cs.graph_time_ms(lambda: ck.padd2(spec, b32, P2, Q2, h), 20)
        tl = cs.graph_time_ms(lambda: ck.padd2_seg_level(spec, b32, x, flags, 1), 20)
        times[name]["padd2"], times[name]["padd2_seg_level"] = t7, tl
        cs.log(f"# {name} {LANES} lanes: K7 (mask on 1 in 32) {t7:.4f} ms, G2 level (no "
               f"flag, d = 1) {tl:.4f} ms")
    _ext.use_defines(())
    cs.log(json.dumps({"sweep_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
