#!/usr/bin/env python3
"""Time the kernels built with other values of their design constants, on
one GPU.

Run from the repository root:

    python3 unroll_sweep.py [add] [dbl] [mont] [leaf] [ntt] [mixed] [div] [pow] [leaf8]
        [--parent DIR]

The arguments name the families of variants to build and time (all nine if
none is given).  With --parent DIR (a checkout of an earlier commit, for
example unpacked with `git archive` into an ignored directory), the ntt,
mixed, div, pow and leaf8 families also time DIR's package (its K5, K9, K10,
K17, K1's chain and K6 through the same entry points, built from DIR's
sources into DIR's own build directory), first and last, around this tree's
variants: parent, variants, parent.

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
plain version bit for bit.

The mont variants (csrc/mont_mul.cu) are K1 at blocks of MYZKP_K1_THREADS =
128, 256, 512 threads with MYZKP_K1_EPT = 1, 2, 4 elements a thread, on the
carry-chain product (MYZKP_K1_MUL = 0) and on fe_mul_u<8> (8), plus
fe_mul_u<4> at the tree's block; each times K1 at (16, 8192) (a setup
to_mont) and at the quotient's level-twiddle pass (3 x 2^21 elements against
the level table, read with a period), the chain (pow_const, an element on a
lane pair) at 1, 2 and 16 elements with e = q - 2, and one product's latency
on one warp: the chain on one element at e = 2^255 less e = 2^16 (256 and
17 bits, one product deep each, with the pair's shuffle), over 239.  The
leaf variants (csrc/ntt.cu) are K6 at r = MYZKP_K6_RADIX = 4, 8 elements a
thread and MYZKP_K6_COLS = 8, 16, 32 columns a block, plus, at the tree's r
and columns, the products 4 and 8; each times K6 at E = 3, m = 128,
B = 16,384 running s = 1, 2, 3, 5 and 7 of its stages.  The ntt variants
(csrc/ntt.cu) are K5 at BN254's width at r = MYZKP_K5_RADIX = 2, 4, 8, 16,
32 (log2 r stages a launch) on the carry-chain product (MYZKP_K5_MUL = 0)
and on fe_mul_u<8> (8); each times the Stockham transforms of the paths
through ops/ntt._stockham_axis, its passes in one graph (shifted h at m =
2^12: the batched 2^12-point INTT and 2^13-point coset NTT, R = 3, and the
2^13-point coset INTT; fast_multiply's 2^9-point transform), and each pass
of the batched 2^13-point coset NTT.  The mont, leaf and ntt families
also time the four-word (M128) instances that the STARK runs: K1 at (8,
2^20) and its chain on 1 element (e = p - 2) and on 4,096 (alpha^-1), with
the same constants; K6 at (1, 128, 8,192), the top leaf of the FastStark
prove's 2^20-point coset NTTs (its four-word instance has constants of its
own: the leaf8 family); the tree and the parent time
K5's four-word design over every Stockham transform one FastStark prove at
65,528 cycles runs (recorded from a prove first), each transform's
launches in one graph, summed with their counts; beside the tree, the
floors a launch in a graph: a one-int add and a copy of the widest
transform's input.  The pow variants (csrc/mont_mul.cu,
csrc/pow_plan.cuh) are K1's chain with the form forced (MYZKP_K1_PAIR_SM = 0:
the window form at every n; 2^30: the lane pair) and the window form's
blocks at MYZKP_K1_POW_THREADS = 64 and 256; each (and the tree, whose
launcher picks the form) times the chain at POW_NS
elements for q - 2 (BN254), alpha^-1 and p - 2 (M128) and p - 2 (M64),
every output held to the plain version (up to 2^12 elements) or to the
first run's.  The leaf8 variants are K6's four-word instance with its
block size forced (MYZKP_K6_L8_SMALL = 2^30: 128 threads at every shape; 0:
256); each (and the tree, whose launcher picks the block size) times K6 at
the top leaf (also its first 1, 3
and 5 stages: the memory phases' share) and at every (E, m, B) that one
FastStark prove at 65,528 cycles runs it at (recorded from a prove first),
summed with their counts, each held to the plain version; beside them a
copy of the top leaf's input (torch clone: one read and one write of its
bytes, the card's practical floor at that access).  The
mixed variants are K10 (csrc/curve2.cu) at MYZKP_K10_UNROLL = 0 (the carry
chains, the tree), 1, 2, 4, 8; each times K10 at 32,768 lanes with its mask
on 1 lane in 32 and at 2^20 lanes without, K7 on the first inputs with Q =
(qx, qy, one), and K9 (csrc/curve.cu, the same in every variant) at
4,194,304 points and at 32,768 lanes with its mask on 1 in 32.  The div
variants (csrc/poly.cu) are K17 at other design constants (MYZKP_K17_B
coefficients a barrier, MYZKP_K17_THREADS, the narrow threshold
MYZKP_K17_NARROW); each times K17 at the 17 shapes of a FastStark prove over
a 2^20-point FRI domain (chip_smoke.STARK_DIV_SHAPES) and their sum, each
shape held bit for bit to the parent's kernel (else to a = q b + r), and
holds K17 to its plain version at chip_smoke's regime edges at both
widths.  Every variant is held to the plain versions bit for bit.
The last line is a JSON object of every time.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from myzkp_tpu_torch.fields.spec import m128_spec
from myzkp_tpu_torch.stark.rescue_constants import ALPHA_INV

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
MONT_VARIANTS = {"tree": ()} | {
    f"k1_t{t}_e{e}_mul{u}": (f"MYZKP_K1_THREADS={t}", f"MYZKP_K1_EPT={e}", f"MYZKP_K1_MUL={u}")
    for u in (0, 8) for t in (128, 256, 512) for e in (1, 2, 4) if (t, e, u) != (256, 1, 0)
} | {"k1_mul4": ("MYZKP_K1_MUL=4",)}
LEAF_VARIANTS = {"tree": ()} | {
    f"k6_r{r}_c{c}": (f"MYZKP_K6_RADIX={r}", f"MYZKP_K6_COLS={c}")
    for r in (4, 8) for c in (8, 16, 32) if (r, c) != (8, 16)
} | {f"k6_mul{u}": (f"MYZKP_K6_MUL={u}",) for u in (4, 8)}
NTT_VARIANTS = {"tree": ()} | {
    f"k5_r{r}_mul{u}": (f"MYZKP_K5_RADIX={r}", f"MYZKP_K5_MUL={u}")
    for r in (2, 4, 8, 16, 32) for u in (0, 8)}
MIXED_VARIANTS = {"tree": ()} | {
    f"k10_unroll{u}": (f"MYZKP_K10_UNROLL={u}",) for u in (1, 2, 4, 8)}
DIV_VARIANTS = {"tree": ()} | {
    "k17_b32": ("MYZKP_K17_B=32",),
    "k17_b128": ("MYZKP_K17_B=128",),
    "k17_t256": ("MYZKP_K17_THREADS=256",),
    "k17_narrow4": ("MYZKP_K17_NARROW=4",),
}
POW_VARIANTS = {"tree": (), "pair": ("MYZKP_K1_PAIR_SM=1073741824",),
                "wide": ("MYZKP_K1_PAIR_SM=0",)} | {
    f"wide_t{t}": ("MYZKP_K1_PAIR_SM=0", f"MYZKP_K1_POW_THREADS={t}") for t in (64, 256)}
LEAF8_VARIANTS = {"tree": (), "k6_l8_t128": ("MYZKP_K6_L8_SMALL=1073741824",),
                  "k6_l8_t256": ("MYZKP_K6_L8_SMALL=0",)}
FAMILIES = {"add": ADD_VARIANTS, "dbl": DBL_VARIANTS, "mont": MONT_VARIANTS,
            "leaf": LEAF_VARIANTS, "ntt": NTT_VARIANTS, "mixed": MIXED_VARIANTS,
            "div": DIV_VARIANTS, "pow": POW_VARIANTS, "leaf8": LEAF8_VARIANTS}
GROUP_KERNELS = ("padd_kernel", "padd_mixed_kernel", "padd_seg_level_kernel", "padd2_kernel",
                 "padd2_seg_level_kernel", "pdbl_kernel", "pdbl2_kernel")
KERNELS = {"add": GROUP_KERNELS, "dbl": GROUP_KERNELS,
           "mont": ("mont_mul_kernel", "mont_pow_kernel", "mont_mul_l8_kernel",
                    "mont_pow_l8_kernel"),
           "leaf": ("ntt_leaf_kernel<8>", "ntt_leaf_kernel<4>", "ntt_leaf_l8_kernel<8,256>",
                    "ntt_leaf_l8_kernel<8,128>"),
           "ntt": tuple(f"butterfly_kernel<{e}>" for e in (2, 4, 8, 16, 32))
           + tuple(f"stockham_l8_kernel<{p}>" for p in (1, 2, 4)),
           "mixed": ("padd_mixed2_kernel", "padd2_kernel", "pdbl2_kernel",
                     "padd2_seg_level_kernel", "padd_mixed_kernel"),
           "div": tuple(k for n in (4, 8) for k in (
               f"div_rows_kernel<{n}>", f"div_chunks_kernel<{n}>", f"div_block_kernel<{n},0>",
               f"div_block_kernel<{n},1>")),
           "pow": ("mont_pow_kernel", "mont_pow_l8_kernel", "mont_pow_l4_kernel",
                   "mont_pow_wide_kernel", "mont_pow_wide_l8_kernel", "mont_pow_wide_l4_kernel"),
           "leaf8": tuple(f"ntt_leaf_l8_kernel<{r},{t}>" for r in (8, 4, 2) for t in (128, 256))
           + ("ntt_leaf_kernel<8>", "ntt_leaf_kernel<4>", "ntt_leaf_kernel<2>")}
# K1's chain: elements on either side of the launcher's threshold (132 SMs x
# MYZKP_K1_PAIR_SM) up to hash_batch's 2^20
POW_NS = (2, 1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 20)
POW_CHECK_N = 1 << 12  # held to the plain version up to here, above to the first run
LEAF8_STAGES = (1, 3, 5)  # the top leaf's first s stages too: the memory phases' share
K2_WIDTHS = (1 << 15, 1 << 22)
LANES = 1 << 15
# (points, n, steps) of the chains: a Horner window and a ladder's bases, on
# one point and on a window batch
CHAIN_SHAPES = tuple((pts, n, n == 255) for pts in (1, 16) for n in (16, 255))
POW_WIDTHS = (1, 2, 16)  # the chain's elements: an inversion and a batch
LEAF_SHAPE = (3, 128, 1 << 14)  # K6's row: a leaf level of the 2^21 coset NTT
LEAF_STAGES = (1, 2, 3, 5, 7)
# M128 (four words): K6 at the top leaf of the FastStark prove's 2^20-point
# coset NTTs; K1 at a coset scaling (2^20 x 2^20); the chain on one element
# (the inversion) and on hash_batch's S-box (2^12 elements, alpha^-1)
LEAF_SHAPE_M128 = (1, 128, 1 << 13)
K1_WIDTH_M128 = 1 << 20
POW_WIDTHS_M128 = (1, 1 << 12)
# the FastStark prove whose K5 transforms the ntt family times at M128: the
# squaring AIR with a 2^16-row trace (a 2^20-point FRI domain)
STARK_CYCLES = (1 << 16) - 8
# (R, n, inverse) of the Stockham transforms: shifted h at m = 2^12 and
# fast_multiply of 2^8-coefficient inputs; the second's passes are timed too
K5_TRANSFORMS = cs.STOCKHAM_TRANSFORMS + cs.FAST_MUL_TRANSFORMS[:1]
K5_PASSES = K5_TRANSFORMS[1]
MIXED_WIDTHS = (LANES, 1 << 20)  # K10 with the mask on 1 lane in 32, and without
K9_WIDTHS = (1 << 22, LANES)  # K9 without the mask, and with it on 1 lane in 32


def check(name: str, got, want) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")


def load_parent(path: str):
    """DIR's myzkp_tpu_torch as the package ``parent_port`` (its modules
    import each other relatively), with its own _ext and build directory."""
    init = Path(path).resolve() / "myzkp_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "parent_port", init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = module
    spec.loader.exec_module(module)
    return module


def main(argv: list[str]) -> int:
    parent_dir = None
    if "--parent" in argv:
        k = argv.index("--parent")
        parent_dir, argv = argv[k + 1], argv[:k] + argv[k + 2:]
    families = tuple(argv) or tuple(FAMILIES)
    if not set(families) <= set(FAMILIES):
        raise SystemExit(f"families: {', '.join(FAMILIES)}, not {families}")
    variants = {k: v for f in families for k, v in FAMILIES[f].items()}
    cs.phase_device()
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254

    todo = [lambda d=d: _ext.build(d) for d in variants.values()
            if not _ext.library_path(d).exists()]
    parent = None
    if parent_dir is not None:
        load_parent(parent_dir)
        parent = {k: importlib.import_module(f"parent_port.{k}") for k in
                  ("_ext", "ops.ntt", "ops.poly", "fields.spec", "fields.limb",
                   "fields.ntt_kernels", "curves.bn254", "curves.curve_kernels")}
        todo.append(lambda: parent["_ext"].build(()))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        list(pool.map(lambda f: f(), todo))
    cs.log(f"# built {len(todo)} libraries at once in {time.perf_counter() - t0:.1f} s")
    for fam in families:
        for name, defines in FAMILIES[fam].items():
            print_build(f"{fam} {name}", _ext.library_path(defines), KERNELS[fam])
    if parent is not None:
        print_build("parent", parent["_ext"].library_path(()),
                    GROUP_KERNELS + ("padd_mixed2_kernel", "butterfly_kernel",
                                     "long_division_kernel", "long_division_l8_kernel")
                    + KERNELS["pow"] + KERNELS["leaf8"])

    dev = torch.device("cuda", 0)
    spec = bn254.q_spec()
    b3, b32 = bn254.g1_b3((), dev), bn254.g2_b3((), dev)
    rng = np.random.default_rng(cs.SEED)
    times = {name: {} for name in variants}
    if "add" in families:
        time_adds(ADD_VARIANTS, spec, b3, b32, rng, dev, times)
    if "dbl" in families:
        time_chains(DBL_VARIANTS, spec, b3, b32, rng, dev, times)
    if "mont" in families:
        time_mont(MONT_VARIANTS, rng, dev, times)
    if "leaf" in families:
        time_leaf(LEAF_VARIANTS, rng, dev, times)
    runs = lambda fam: ([("parent", None)] if parent else []) + list(
        FAMILIES[fam].items()) + ([("parent_2", None)] if parent else [])
    if parent:
        times["parent"], times["parent_2"] = {}, {}
    if "ntt" in families:
        time_ntt(runs("ntt"), parent, rng, dev, times)
    if "mixed" in families:
        time_mixed(runs("mixed"), parent, rng, dev, times)
    if "div" in families:
        time_div(runs("div"), parent, rng, dev, times)
    if "pow" in families:
        time_pow(runs("pow"), parent, rng, dev, times)
    if "leaf8" in families:
        time_leaf8(runs("leaf8"), parent, rng, dev, times)
    _ext.use_defines(())
    cs.log(json.dumps({"sweep_ms": times}))
    return 0


def print_build(label: str, lib, kernels) -> None:
    """ptxas's registers and spills and the SASS counts of kernels in lib
    (a template instantiation named kernel<N>, kernel<R,T> or kernel<N,flag>)."""
    fn = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            arg = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", m.group(1))
            name = next((k for k in kernels if k.split("<")[0] in m.group(1)), None)
            args = arg and ",".join(g for g in arg.groups() if g is not None)
            fn = name and (f"{name.split('<')[0]}<{args}>" if arg else name)
            fn = fn if fn in kernels else None
        elif fn and ("registers" in line or "spill" in line):
            cs.log(f"# {label} ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    sass = cs.sass_counts(lib)
    for k in kernels:
        if k in sass:
            c = sass[k]
            cs.log(f"# {label} sass {k}: total {c['total']}, IMAD {c['IMAD']}, IADD3 "
                   f"{c['IADD3']}, LOP3 {c['LOP3']}, LDL {c['LDL']}, STL {c['STL']}, "
                   f"SHFL {c['SHFL']}, BRA {c['BRA']}")


def time_mont(variants, rng, dev, times) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    qspec, rspec = bn254_q_spec(), bn254_r_spec()
    a, b = cs.random_fe(rng, 8192, dev), cs.random_fe(rng, 8192, dev)
    n = 1 << 21
    m1, m2 = ntt._fourstep_split(n)
    xw = cs.random_fe(rng, 3 * n, dev).reshape(16, 3, m1, m2, 1)
    tab = ntt.fourstep_tables(rspec, n, False, dev)[0].reshape(16, m1, m2, 1)
    e = qspec.p - 2
    xs = {k: cs.random_fe(rng, k, dev) for k in POW_WIDTHS}
    want_mm = limb.mont_mul_ref(qspec, a, b)
    want_wide = limb.mont_mul_ref(rspec, xw, tab)
    want_pow = {k: limb.mont_pow_ref(qspec, x, e) for k, x in xs.items()}
    one = xs[1]
    mspec = m128_spec()
    a4, b4 = (m128_fe(rng, K1_WIDTH_M128, dev) for _ in range(2))
    want4 = limb.mont_mul_ref(mspec, a4, b4)
    e4 = {1: mspec.p - 2, 1 << 12: ALPHA_INV}
    xs4 = {k: m128_fe(rng, k, dev) for k in POW_WIDTHS_M128}
    want_pow4 = {k: limb.mont_pow_ref(mspec, x, e4[k]) for k, x in xs4.items()}
    for name, defines in variants.items():
        _ext.use_defines(defines)
        check(f"{name}: K1 (16, 8192)", [limb.mont_mul(qspec, a, b)], [want_mm])
        check(f"{name}: K1 level twiddle", [limb.mont_mul(rspec, xw, tab)], [want_wide])
        t = times[name]
        t["k1_8192"] = cs.graph_time_ms(lambda: limb.mont_mul(qspec, a, b), 100)
        t["k1_level_3x2^21"] = cs.graph_time_ms(lambda: limb.mont_mul(rspec, xw, tab), 20)
        line = [f"K1 (16, 8192) {t['k1_8192']:.4f} ms, level pass {t['k1_level_3x2^21']:.4f} ms"]
        for k, x in xs.items():
            check(f"{name}: chain at {k}", [limb.mont_pow_cuda(qspec, x, e)], [want_pow[k]])
            t[f"pow_{k}"] = cs.graph_time_ms(lambda: limb.mont_pow_cuda(qspec, x, e), 5)
        line.append(f"chain at {POW_WIDTHS}: " + ", ".join(
            f"{t[f'pow_{k}']:.4f}" for k in POW_WIDTHS) + " ms")
        lat = [cs.graph_time_ms(lambda: limb.mont_pow_cuda(qspec, one, 1 << k), 5)
               for k in (16, 255)]
        t["product_latency_us"] = (lat[1] - lat[0]) / 239 * 1e3
        line.append(f"one product on one warp {t['product_latency_us']:.4f} us "
                    f"(n = 16: {lat[0]:.4f} ms, n = 255: {lat[1]:.4f} ms)")
        check(f"{name}: K1 at M128", [limb.mont_mul(mspec, a4, b4)], [want4])
        t["k1_m128_2^20"] = cs.graph_time_ms(lambda: limb.mont_mul(mspec, a4, b4), 20)
        line.append(f"M128: K1 (8, 2^20) {t['k1_m128_2^20']:.4f} ms")
        for k, x in xs4.items():
            check(f"{name}: M128 chain at {k}", [limb.mont_pow_cuda(mspec, x, e4[k])],
                  [want_pow4[k]])
            t[f"pow_m128_{k}"] = cs.graph_time_ms(lambda: limb.mont_pow_cuda(mspec, x, e4[k]), 5)
            line.append(f"chain at {k} (e of {e4[k].bit_length()} bits) "
                        f"{t[f'pow_m128_{k}']:.4f} ms")
        cs.log(f"# mont {name}: " + "; ".join(line))


def time_leaf(variants, rng, dev, times) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    E, m, B = LEAF_SHAPE
    x = cs.random_fe(rng, E * m * B, dev).reshape(16, E, m, B)
    tw = ntt._leaf_twiddles(spec, m, False, dev)
    wants = {s: nk.ntt_leaf_ref(spec, x, tw, s) for s in LEAF_STAGES}
    mspec = m128_spec()
    E4, m4, B4 = LEAF_SHAPE_M128
    x4 = m128_fe(rng, E4 * m4 * B4, dev).reshape(8, E4, m4, B4)
    tw4 = ntt._leaf_twiddles(mspec, m4, False, dev)
    want4 = nk.ntt_leaf_ref(mspec, x4, tw4)
    for name, defines in variants.items():
        _ext.use_defines(defines)
        for s in LEAF_STAGES:
            check(f"{name}: K6 stages = {s}", [nk.ntt_leaf(spec, x, tw, s)], [wants[s]])
            times[name][f"k6_s{s}"] = cs.graph_time_ms(lambda: nk.ntt_leaf(spec, x, tw, s), 5)
        check(f"{name}: K6 at M128", [nk.ntt_leaf(mspec, x4, tw4)], [want4])
        times[name]["k6_m128"] = cs.graph_time_ms(lambda: nk.ntt_leaf(mspec, x4, tw4), 10)
        cs.log(f"# leaf {name} (E, m, B) = {LEAF_SHAPE}: " + ", ".join(
            f"s = {s} {times[name][f'k6_s{s}']:.4f} ms" for s in LEAF_STAGES)
            + f"; M128 {LEAF_SHAPE_M128}, all stages: {times[name]['k6_m128']:.4f} ms")


def time_ntt(runs, parent, rng, dev, times) -> None:
    """The K5 variants (and the parent's K5) over K5_TRANSFORMS (BN254),
    each transform's passes in one graph, and this tree's variants at each
    pass of K5_PASSES; the tree and the parent over every M128 Stockham
    transform of one FastStark prove, each transform's passes in one graph,
    summed with their counts.  A run named parent* goes through the
    parent's modules."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    mspec = m128_spec()
    m128 = {}  # (R, n, inverse) -> (input, the plain version's output, count a prove)
    for (R, n, inv), count in prove_transforms(dev).items():
        x4 = m128_fe(rng, R * n, dev).reshape(8, R, n, 1)
        y = x4.reshape(8, R, 1, n, 1)
        for s in range(n.bit_length() - 1):
            y = nk.butterfly_ref(mspec, y, ntt._pass_twiddles(mspec, n, s, 1, inv, dev))
        m128[(R, n, inv)] = (x4, y.reshape(x4.shape), count)
    xs = [cs.random_fe(rng, R * n, dev).reshape(16, R, n, 1) for R, n, _ in K5_TRANSFORMS]
    wants = []
    for x, (R, n, inv) in zip(xs, K5_TRANSFORMS):  # the one-stage plain chain
        y = x.reshape(16, R, 1, n, 1)
        for s in range(n.bit_length() - 1):
            y = nk.butterfly_ref(spec, y, ntt._pass_twiddles(spec, n, s, 1, inv, dev))
        wants.append(y.reshape(x.shape))
    for name, defines in runs:
        if name.startswith("parent"):
            mod, sp = parent["ops.ntt"], parent["fields.spec"].bn254_r_spec()
            msp = parent["fields.spec"].m128_spec()
        else:
            _ext.use_defines(defines)
            mod, sp, msp = ntt, spec, mspec
        t, line = times[name], []
        for x, want, (R, n, inv) in zip(xs, wants, K5_TRANSFORMS):
            check(f"{name}: K5 transform {(R, n, inv)}",
                  [mod._stockham_axis(sp, x, n, inv)], [want])
            key = f"k5_{R}x{n}{'_inv' if inv else ''}"
            t[key] = cs.graph_time_ms(lambda: mod._stockham_axis(sp, x, n, inv), 20)
            line.append(f"{key} {t[key]:.4f} ms")
        if name == "tree" or name.startswith("k5_r"):
            R, n, inv = K5_PASSES
            y = xs[K5_TRANSFORMS.index(K5_PASSES)].reshape(16, R, 1, n, 1)
            for s0, s in ntt._stockham_passes(n):
                tw = ntt._pass_twiddles(spec, n, s0, s, inv, dev)
                check(f"{name}: K5 pass {tuple(y.shape)}", [nk.butterfly(spec, y, tw, s)],
                      [nk.butterfly_ref(spec, y, tw, s)])
                key = f"k5_pass_{y.shape[2]}x{y.shape[3]}_s{s}"
                t[key] = cs.graph_time_ms(lambda: nk.butterfly(spec, y, tw, s), 100)
                line.append(f"{key} {t[key]:.4f} ms")
                y = nk.butterfly(spec, y, tw, s)
        if not name.startswith("k5_r"):
            total = 0.0
            for (R, n, inv), (x4, want4, count) in m128.items():
                check(f"{name}: M128 K5 transform {(R, n, inv)}",
                      [mod._stockham_axis(msp, x4, n, inv)], [want4])
                total += count * cs.graph_time_ms(
                    lambda: mod._stockham_axis(msp, x4, n, inv), 10)
            t["k5_m128_prove"] = total
            line.append(f"M128: the prove's {sum(c for *_, c in m128.values())} transforms "
                        f"({len(m128)} shapes) {total:.4f} ms")
        if name == "tree":  # the floors a launch: a one-int add and a copy of the widest input
            one = torch.zeros(1, dtype=torch.int32, device=dev)
            widest = max((x4 for x4, _, _ in m128.values()), key=lambda v: v.numel())
            t["floor_add"] = cs.graph_time_ms(lambda: one.add_(1), 100)
            t["floor_copy"] = cs.graph_time_ms(lambda: widest.clone(), 20)
            line.append(f"floors: a one-int add {t['floor_add']:.4f} ms, a copy of "
                        f"{tuple(widest.shape)} {t['floor_copy']:.4f} ms a launch")
        cs.log(f"# ntt {name}: " + ", ".join(line))


def m128_fe(rng, n: int, dev) -> torch.Tensor:
    """n random canonical M128 elements, (8, n) limbs: the top limb below
    p's, p = 1 + 407 * 2^119."""
    limbs = rng.integers(0, 1 << 16, size=(8, n), dtype=np.int64)
    limbs[7] = rng.integers(0, 0xCB80, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def prove_transforms(dev) -> dict:
    """{(R, n, inverse): count} of the Stockham transforms (K5) of one
    FastStark prove at STARK_CYCLES, recorded from ops/ntt._stockham_axis;
    R counts every batch row (B is 1 on this path)."""
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.stark import fast_stark

    spec = m128_spec()
    st = fast_stark.initialize_fast_stark_m128(4, 2, 2, 1, STARK_CYCLES, 2, dev)
    trace, air, boundary = cs.squaring_air(spec, STARK_CYCLES)
    pre = st.preprocess()
    seen, axis = {}, ntt._stockham_axis

    def recorded(sp, x, m, inverse):
        if m > 1:
            key = (x.numel() // (sp.L * m), m, inverse)
            seen[key] = seen.get(key, 0) + 1
        return axis(sp, x, m, inverse)

    ntt._stockham_axis = recorded
    try:
        st.prove(trace, boundary, air, preprocessed=pre, rng=random.Random(cs.STARK_SEED))
    finally:
        ntt._stockham_axis = axis
    return seen


def time_pow(runs, parent, rng, dev, times) -> None:
    """K1's chain in each run at POW_NS elements for q - 2 (BN254), alpha^-1
    and p - 2 (M128) and p - 2 (M64), with the form the run's launcher
    picks (the tree: pow_plan.cuh; the parent: the lane pair).  A run named
    parent* goes through the parent's modules."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, m64_spec

    specs = {"q": bn254_q_spec(), "m128": m128_spec(), "m64": m64_spec()}
    cases = {"q, q - 2": ("q", specs["q"].p - 2), "m128, alpha^-1": ("m128", ALPHA_INV),
             "m128, p - 2": ("m128", specs["m128"].p - 2), "m64, p - 2": ("m64", specs["m64"].p - 2)}
    big = max(POW_NS)
    xs = {"q": cs.random_fe(rng, big, dev), "m128": m128_fe(rng, big, dev),
          "m64": cs.random_fe64(rng, big, dev)}
    xs = {(f, n): x[:, :n].contiguous() for f, x in xs.items() for n in POW_NS}
    want = {}
    for case, (f, e) in cases.items():
        for n in POW_NS:
            if n <= POW_CHECK_N:
                want[case, n] = limb.mont_pow_ref(specs[f], xs[f, n], e)
    for name, defines in runs:
        if name.startswith("parent"):
            mod = parent["fields.limb"]
            sp = {"q": parent["fields.spec"].bn254_q_spec(), "m128": parent["fields.spec"].m128_spec(),
                  "m64": parent["fields.spec"].m64_spec()}
        else:
            _ext.use_defines(defines)
            mod, sp = limb, specs
        line = []
        for case, (f, e) in cases.items():
            ms = []
            for n in POW_NS:
                x = xs[f, n]
                got = mod.mont_pow_cuda(sp[f], x, e)
                want.setdefault((case, n), got)
                check(f"{name}: chain {case} at {n}", [got], [want[case, n]])
                t = cs.graph_time_ms(lambda: mod.mont_pow_cuda(sp[f], x, e), 5 if n >= 1 << 18 else 20)
                times[name][f"pow {case} {n}"] = t
                ms.append(f"{n}: {t:.4f}")
            line.append(f"{case}: " + ", ".join(ms))
        if not name.startswith("parent"):
            forms = {n: limb.mont_pow_form(n, dev) for n in POW_NS}
            line.append(f"forms {forms}")
        cs.log(f"# pow {name} (ms): " + "; ".join(line))


def leaf_prove_shapes(dev) -> dict:
    """{(E, m, B, inverse): (count, twiddles)} of the K6 launches of one
    FastStark prove at STARK_CYCLES, recorded from ntt_kernels.ntt_leaf."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.stark import fast_stark

    spec = m128_spec()
    st = fast_stark.initialize_fast_stark_m128(4, 2, 2, 1, STARK_CYCLES, 2, dev)
    trace, air, boundary = cs.squaring_air(spec, STARK_CYCLES)
    pre = st.preprocess()
    seen, leaf = {}, nk.ntt_leaf
    inverse = {ntt._leaf_twiddles(spec, m, True, dev).data_ptr(): True for m in
               (2 << k for k in range(7))}

    def recorded(sp, x, tw, stages=None):
        key = tuple(x.shape[1:]) + (inverse.get(tw.data_ptr(), False),)
        count, _ = seen.get(key, (0, tw))
        seen[key] = (count + 1, tw)
        return leaf(sp, x, tw, stages)

    nk.ntt_leaf = recorded
    try:
        st.prove(trace, boundary, air, preprocessed=pre, rng=random.Random(cs.STARK_SEED))
    finally:
        nk.ntt_leaf = leaf
    return seen


def time_leaf8(runs, parent, rng, dev, times) -> None:
    """K6's four-word instance in each run at the top leaf and at every
    shape of one FastStark prove (summed with their counts), each held to
    the plain version.  A run named parent* goes through the parent's
    modules."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt

    spec = m128_spec()
    shapes = leaf_prove_shapes(dev)
    top = LEAF_SHAPE_M128 + (False,)
    shapes.setdefault(top, (0, ntt._leaf_twiddles(spec, top[1], False, dev)))
    x_top = m128_fe(rng, math.prod(top[:3]), dev).reshape(8, *top[:3])
    want_top = {s: nk.ntt_leaf_ref(spec, x_top, shapes[top][1], s) for s in LEAF8_STAGES}
    cs.log(f"# leaf8: the prove's {len(shapes) - (shapes[top][0] == 0)} K6 shapes "
           f"(E, m, B, inverse): count " + json.dumps({str(k): c for k, (c, _) in shapes.items()}))
    xs = {k: m128_fe(rng, k[0] * k[1] * k[2], dev).reshape(8, *k[:3]) for k in shapes}
    copy_ms = cs.graph_time_ms(lambda: x_top.clone(), 10)
    times["copy"] = {"leaf8 top clone": copy_ms}
    cs.log(f"# leaf8: a copy of the top leaf's input (torch clone, {x_top.numel() * 4} B each "
           f"way) {copy_ms:.4f} ms")
    want = {k: nk.ntt_leaf_ref(spec, xs[k], tw) for k, (_, tw) in shapes.items()}
    for name, defines in runs:
        if name.startswith("parent"):
            mod, sp = parent["fields.ntt_kernels"], parent["fields.spec"].m128_spec()
        else:
            _ext.use_defines(defines)
            mod, sp = nk, spec
        total = 0.0
        for k, (count, tw) in shapes.items():
            x = xs[k]
            check(f"{name}: K6 M128 {k}", [mod.ntt_leaf(sp, x, tw)], [want[k]])
            t = cs.graph_time_ms(lambda: mod.ntt_leaf(sp, x, tw), 10)
            times[name][f"leaf8 {k}"] = t
            total += count * t
        times[name]["leaf8 prove sum"] = total
        for s in LEAF8_STAGES:
            tw = shapes[top][1]
            check(f"{name}: K6 M128 top leaf, {s} stages", [mod.ntt_leaf(sp, x_top, tw, s)],
                  [want_top[s]])
            times[name][f"leaf8 top s{s}"] = cs.graph_time_ms(
                lambda: mod.ntt_leaf(sp, x_top, tw, s), 10)
        cs.log(f"# leaf8 {name}: top leaf {LEAF_SHAPE_M128} {times[name][f'leaf8 {top}']:.4f} ms "
               f"(its first " + ", ".join(f"{s}: {times[name][f'leaf8 top s{s}']:.4f}"
                                         for s in LEAF8_STAGES)
               + f" stages); the prove's launches summed {total:.4f} ms")


def time_mixed(runs, parent, rng, dev, times) -> None:
    """The K10 variants (and the parent's K10) at MIXED_WIDTHS, and K7 on the
    first width's inputs.  A run named parent* goes through the parent's
    modules."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    spec, b32 = bn254.q_spec(), bn254.g2_b3((), dev)
    h = torch.arange(LANES, device=dev) % 32 == 0
    fe2 = lambda n: (cs.random_fe(rng, n, dev), cs.random_fe(rng, n, dev))
    cases = []
    for n in MIXED_WIDTHS:
        P, q = tuple(fe2(n) for _ in range(3)), tuple(fe2(n) for _ in range(2))
        hn = h if n == LANES else None
        cases.append((n, P, q, hn, ck._leaves2(ck.padd_mixed2_ref(spec, b32, P, *q, hn))))
    _, P, q, _, _ = cases[0]
    one = tuple(c.contiguous() for c in bn254.g2_ops().one((LANES,), dev))
    want7 = ck._leaves2(ck.padd2_ref(spec, b32, P, (*q, one), h))
    b31 = bn254.g1_b3((), dev)
    k9 = []
    for n in K9_WIDTHS:
        P1, q1 = tuple(cs.random_fe(rng, n, dev) for _ in range(3)), (
            cs.random_fe(rng, n, dev), cs.random_fe(rng, n, dev))
        h1 = h if n == LANES else None
        k9.append((n, P1, q1, h1, ck.padd_mixed_ref(spec, b31, P1, *q1, h1)))
    for name, defines in runs:
        if name.startswith("parent"):
            mod = parent["curves.curve_kernels"]
            sp, b = parent["curves.bn254"].q_spec(), parent["curves.bn254"].g2_b3((), dev)
            b1 = parent["curves.bn254"].g1_b3((), dev)
        else:
            _ext.use_defines(defines)
            mod, sp, b, b1 = ck, spec, b32, b31
        t, line = times[name], []
        for n, P1, q1, h1, want in k9:
            check(f"{name}: K9 at {n}", mod.padd_mixed(sp, b1, P1, *q1, h1), want)
            t[f"k9_{n}"] = cs.graph_time_ms(lambda: mod.padd_mixed(sp, b1, P1, *q1, h1),
                                            20 if n == LANES else 5)
            line.append(f"K9 at {n}{' (mask)' if h1 is not None else ''} {t[f'k9_{n}']:.4f} ms")
        for n, P, q, hn, want in cases:
            check(f"{name}: K10 at {n}", ck._leaves2(mod.padd_mixed2(sp, b, P, *q, hn)), want)
            t[f"k10_{n}"] = cs.graph_time_ms(lambda: mod.padd_mixed2(sp, b, P, *q, hn),
                                             20 if n == LANES else 5)
            line.append(f"K10 at {n}{' (mask)' if hn is not None else ''} "
                        f"{t[f'k10_{n}']:.4f} ms")
        _, P, q, _, _ = cases[0]
        check(f"{name}: K7", ck._leaves2(mod.padd2(sp, b, P, (*q, one), h)), want7)
        t["k7"] = cs.graph_time_ms(lambda: mod.padd2(sp, b, P, (*q, one), h), 20)
        line.append(f"K7 on the same inputs {t['k7']:.4f} ms")
        cs.log(f"# mixed {name}: " + ", ".join(line))


def time_div(runs, parent, rng, dev, times) -> None:
    """K17's variants (and the parent's K17) at the prove's 17 shapes, each
    shape's (q, r) held to the parent's (else, for the first run, to a = q b
    + r), the time of each shape (graph replay, two launches) and the sum;
    each of this tree's variants also held to the plain version at
    chip_smoke's regime edges, both widths.  A run named parent* goes
    through the parent's modules."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops import ntt, poly

    mspec = m128_spec()
    cases = [(shape, m128_fe(rng, shape[0] * shape[1], dev).reshape(8, *shape[:2]),
              m128_fe(rng, shape[0] * (shape[2] + 1), dev).reshape(8, shape[0], shape[2] + 1))
             for shape in cs.STARK_DIV_SHAPES]
    wants = {}
    for name, defines in runs:
        if name.startswith("parent"):
            mod, sp = parent["ops.poly"], parent["fields.spec"].m128_spec()
        else:
            _ext.use_defines(defines)
            mod, sp = poly, mspec
            cs.bitcheck_div_edges(dev, log_it=False)
        t, total = times[name], 0.0
        for (rows, na, bd), a, b in cases:
            got = mod.long_division_cuda(sp, a, b, bd)
            if (rows, na, bd) not in wants:
                q, r = got
                back = ntt.fast_multiply(Fp(mspec, q), Fp(mspec, b)) + Fp(mspec, r).pad_to(na)
                if not torch.equal(back.mont, a):
                    raise AssertionError(f"{name}: K17 {(rows, na, bd)}: a != q b + r")
                wants[(rows, na, bd)] = got
            check(f"{name}: K17 {(rows, na, bd)}", got, wants[(rows, na, bd)])
            ms = cs.graph_time_ms(lambda: mod.long_division_cuda(sp, a, b, bd), 2)
            t[f"k17_{rows}x{na}x{bd}"] = ms
            total += ms
        t["k17_sum"] = total
        cs.log(f"# div {name}: " + ", ".join(
            f"{shape} {t[f'k17_{shape[0]}x{shape[1]}x{shape[2]}']:.4f}"
            for shape in cs.STARK_DIV_SHAPES) + f" ms; sum {total:.4f} ms")


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
