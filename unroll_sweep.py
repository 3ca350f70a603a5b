#!/usr/bin/env python3
"""Time the group-law kernels built with other values of their unroll
constants, on one GPU.

Run from the repository root:  python3 unroll_sweep.py [add] [dbl]

The arguments name the families of variants to build and time (both if
none is given).

The constants are the rows of the Montgomery product unrolled in the code of
K2 and the G1 level (MYZKP_K2_UNROLL, csrc/curve.cu), of the G2 lane pair's
products in K7 and the G2 level (MYZKP_PAIR2_UNROLL, csrc/pair.cuh), and of
the step loops of the chains of doublings K3 (MYZKP_K3_UNROLL, csrc/curve.cu)
and K8 (MYZKP_K8_UNROLL, csrc/curve2.cu).  Each variant is the library that
_ext builds with its -D definitions (_ext.use_defines), and the variants not
yet built are built at once.  Per variant it prints ptxas's registers and
spills and the static SASS counts (chip_smoke.sass_counts) of the group-law
kernels, then the device time (CUDA-graph replay, chip_smoke.graph_time_ms)
of each kernel through its entry point in curve_kernels.  The add variants
(and the tree) time K2 without a mask and K9 at 32,768 and 4,194,304 points,
K7 with its mask on 1 lane in 32 at 32,768 lanes and the G2 level with no
flag set at d = 1 on (2, 16384) lanes; K2 at 32,768 points and K7 are held
to their plain versions bit for bit.  The doubling variants (and the tree)
time K3 and K8 at the prover's widths, 1 and 16 points, with n = 16 (a Horner
window) and n = 255 with every step (a ladder's bases), each held to its
plain version bit for bit.  The last line is a JSON object of every time.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs

ADD_VARIANTS = {
    "tree": (),
    "k2_unroll8": ("MYZKP_K2_UNROLL=8",),
    "k2_unroll2": ("MYZKP_K2_UNROLL=2",),
    "k7_unroll8": ("MYZKP_PAIR2_UNROLL=8",),
    "k7_unroll4": ("MYZKP_PAIR2_UNROLL=4",),
    "k7_unroll1": ("MYZKP_PAIR2_UNROLL=1",),
}
# K3 and K8 at the same unroll in one build: they are separate kernels
DBL_VARIANTS = {"tree": ()} | {
    f"dbl_unroll{u}": (f"MYZKP_K3_UNROLL={u}", f"MYZKP_K8_UNROLL={u}") for u in (1, 2, 4, 8)}
FAMILIES = {"add": ADD_VARIANTS, "dbl": DBL_VARIANTS}
KERNELS = ("padd_kernel", "padd_mixed_kernel", "padd_seg_level_kernel", "padd2_kernel",
           "padd2_seg_level_kernel", "pdbl_kernel", "pdbl2_kernel")
K2_WIDTHS = (1 << 15, 1 << 22)
LANES = 1 << 15
# (points, n, steps) of the chains: a Horner window and a ladder's bases, on
# one point and on a window batch
CHAIN_SHAPES = tuple((pts, n, n == 255) for pts in (1, 16) for n in (16, 255))


def check(name: str, got, want) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")


def main(argv: list[str]) -> int:
    families = tuple(argv) or tuple(FAMILIES)
    if not set(families) <= set(FAMILIES):
        raise SystemExit(f"families: {', '.join(FAMILIES)}, not {families}")
    variants = {k: v for f in families for k, v in FAMILIES[f].items()}
    cs.phase_device()
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254

    todo = [d for d in variants.values() if not _ext.library_path(d).exists()]
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        seconds = list(pool.map(_ext.build, todo))
    cs.log(f"# built {len(todo)} variants at once in {max(seconds, default=0):.1f} s")
    for name, defines in variants.items():
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
    times = {name: {} for name in variants}
    if "add" in families:
        time_adds(ADD_VARIANTS, spec, b3, b32, rng, dev, times)
    if "dbl" in families:
        time_chains(DBL_VARIANTS, spec, b3, b32, rng, dev, times)
    _ext.use_defines(())
    cs.log(json.dumps({"sweep_ms": times}))
    return 0


def time_adds(variants, spec, b3, b32, rng, dev, times) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import curve_kernels as ck

    for n in K2_WIDTHS:
        P = tuple(cs.random_fe(rng, n, dev) for _ in range(3))
        Q = tuple(cs.random_fe(rng, n, dev) for _ in range(3))
        want = ck.padd_ref(spec, b3, P, Q) if n == LANES else None
        reps = 5 if n > LANES else 20
        for name, defines in variants.items():
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
    for name, defines in variants.items():
        _ext.use_defines(defines)
        check(f"{name}: K7", ck._leaves2(ck.padd2(spec, b32, P2, Q2, h)), want)
        t7 = cs.graph_time_ms(lambda: ck.padd2(spec, b32, P2, Q2, h), 20)
        tl = cs.graph_time_ms(lambda: ck.padd2_seg_level(spec, b32, x, flags, 1), 20)
        times[name]["padd2"], times[name]["padd2_seg_level"] = t7, tl
        cs.log(f"# {name} {LANES} lanes: K7 (mask on 1 in 32) {t7:.4f} ms, G2 level (no "
               f"flag, d = 1) {tl:.4f} ms")


def time_chains(variants, spec, b3, b32, rng, dev, times) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import curve_kernels as ck

    for pts, n, steps in CHAIN_SHAPES:
        P1 = tuple(cs.random_fe(rng, pts, dev) for _ in range(3))
        P2 = tuple((cs.random_fe(rng, pts, dev), cs.random_fe(rng, pts, dev))
                   for _ in range(3))
        cases = (("K3", ck.pdbl, ck.pdbl_ref, b3, P1), ("K8", ck.pdbl2, ck.pdbl2_ref, b32, P2))
        wants = [cs.flat(ref(spec, b, P, n, steps=steps)) for _, _, ref, b, P in cases]
        reps = 20 if n < 255 else 4
        for name, defines in variants.items():
            _ext.use_defines(defines)
            line = []
            for (k, wrap, _, b, P), want in zip(cases, wants):
                check(f"{name}: {k} [{pts} x {n}]", cs.flat(wrap(spec, b, P, n, steps=steps)),
                      want)
                t = cs.graph_time_ms(lambda: wrap(spec, b, P, n, steps=steps), reps)
                times[name][f"{k}_{pts}x{n}{'_steps' if steps else ''}"] = t
                line.append(f"{k} {t:.4f} ms ({t / n * 1e3:.2f} us a double)")
            cs.log(f"# {name} chains, {pts} points, n = {n}{', steps' if steps else ''}: "
                   + ", ".join(line))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
