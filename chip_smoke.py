#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (myzkp_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one output line each (or more), in order:
  1. device    the card (nvidia-smi name and power limit), torch, nvcc;
  2. build     the CUDA kernels from myzkp_tpu_torch/csrc/ with nvcc, one
               process per source, all started together, and the verifier's
               host pairing library (myzkp_tpu_torch/native/) with g++;
  3. bitcheck  each kernel against its plain PyTorch version on the card,
               exact equality of limbs (the tolerance is 0: modular integers):
               K1 over F_q on 2^20 random pairs after every pair of the
               word edges (values below q whose 32-bit words are each 0 or
               0xFFFFFFFF, and q - 1, 1, R mod q), every such pair also
               against the host; K2, K3 over F_q and the G1 group law; K4
               and its G2 instance
               (acc and the bucket table written in place: all four tags,
               flush targets with -1 and at step 0, rows of 0, 1, q - 1, R
               mod q in every coordinate component, 3000 lanes, K = 4; the
               point table read in order, the row-major contract the scan
               had before it read by index, and at random repeating
               indices); K14 gather_planes and K16 scatter_rows in both
               groups at a fixed-base chunk (8,388,608 int32 indices), the
               lane merge's 32,768 int64 repeating targets and its bucket
               table, 2^20 points and ragged sizes, with indices and
               without, then timed at those shapes beside the PyTorch calls
               they replaced; K7
               (with and without its select mask) and K8 over F_q2 at the
               MSM's 32,768 lanes (P+P, P+(-P), infinity on either side,
               z != 1, and lanes whose every c0 and c1 is 0, 1, q - 1 or R mod
               q) and K7 at a G2 fixed-base tree level; then K1 over F_r
               (the same edges), K1's chain mont_pow over F_q and F_r at 1,
               2, 3, 16 and 4,097 elements (0, 1, p - 1, R mod p among
               them) for e = 0, 1, 2, 3, p - 2 and a seeded 256-bit e,
               against mont_pow_ref and the host's pow(x, e, p), K1 with
               an operand broadcast as the paths broadcast it (the 1/n
               constant, coset offsets against (3, n), the four-step level
               table against E = 3, to_mont / from_mont columns), K5
               on 2^20 pairs and at every stage shape of the m = 2^12 path,
               K6 at every
               leaf shape of the 2^20 paths, at m = 16, 64, 128 with a
               ragged batch and at every stage count s = 1..7 of m = 128
               with a ragged batch, forward and inverse; segment_sum_mod on
               the card against the CPU and
               host ints, 2^20 entries with heavy duplicates; K2 and K7 (one
               G2 point on a lane pair) at 32,768 lanes, K2 at 2^17 + 5
               too, and at tail lengths that are not multiples of a block,
               a warp's 16 pairs or 2, with the mask on 1 lane in 32 and
               without, edge values, infinity, Q = P and Q = -P; the lane-merge
               levels of both groups (padd_seg_level, padd2_seg_level) at
               every level of the scan at the lane merge's (2, 16384) shape
               and at a ragged (3, 1000), under four head patterns (all,
               lane 0 only, 3 in 10 with lane 0 clear, 97 in 100), with edge
               values and infinity in the inputs, out and flags exact; and
               msm._seg_scan_hs on the card, exact, one launch a level; the
               chains of doublings K3 and K8 at 1 point, 16 points and a wide
               batch with a tail (2^16 + 3 for K3, 32,768 + 5 for K8), n = 1,
               16 and 255 with and without the steps output, exact against
               the plain version's 255 steps, with infinity, y = 0 (P = -P)
               and edge-value lanes, and 2^n P equal to the host's;
  4. msm       the G1 slice: fixed-base setup of 2^20 points [m_i]G, then the
               2^20 Pippenger MSM against 2^20 scalars k_i, checked against
               the host's [sum k_i m_i mod r]G; kernel launch counts of that
               run; the MSM timed; msm_pippenger at n = 2^16 with c = 14,
               checked the same way; K2 timed beside its plain version;
               K3 and K8 timed at the prover's shapes (1 point,
               n = 16: a Horner window; 1 point, n = 255 with every step: a
               ladder's bases) and at their earlier shapes (16 points and
               32,768 lanes, n = 1), per double and beside their bounds;
               K4 at the MSM's shape (one window group's sorted digits, K = 64,
               32,768 lanes, reading the 2^20-point table by the path's own
               indices, checked below its rows; real flush targets checked
               unique) exact against its plain version, acc and bucket
               table, and timed beside it and beside the parent's path
               (index_select, then the scan of the copy read in order), and
               probe 13: the same 64 steps as 64 launches of K2 with the
               mask; the lane merge's first level on the scan's acc and the
               real segment heads, exact and timed with cold inputs, and with
               lane 0 the only head (every lane adds);
  5. ntt       a forward NTT of 2^20 seeded F_r elements checked at 3 points
               against host evaluation, intt(ntt(a)) == a, its launches, and
               its time;
  6. shifted h the prover's quotient stage get_shifted_h on square_chain(m)
               at m = 2^20 (four-step transforms over K6) and m = 2^12
               (Stockham stages over K5), each checked on the host: ell(w^j)
               equals the constraint evaluation u_j, and the Pinocchio
               identity (ell + d_ell t)(r + d_r t) - (o + d_o t) = H t holds at
               a random point; launch counts of each run; the calls timed;
               K5 and K6 timed beside their plain versions, and K1 at the
               four-step level-twiddle pass over 3 x 2^21 elements (the
               quotient's shape) and at (16, 8192) (a setup to_mont), and
               its chain at 2 elements with e = q - 2 (the proof's
               inversion; also with CUDA events around the calls);
  7. g2 msm    fixed-base setup of 2^20 G2 points [m_i]G2, then the 2^20 G2
               Pippenger MSM (one launch of K4's G2 instance per window
               group) against 2^20 scalars with a zero and duplicates,
               checked against the host's [sum k_i m_i mod r]G2; launch
               counts; the MSM timed; the G2 scan at the MSM's shape and
               probe 13 (64 launches of K7 with the mask), as for G1;
  8. pinocchio setup, prove and verify on square_chain(2^20): the proof is
               accepted and the proof of a wrong witness (one x_k changed) is
               rejected; launch counts of setup (its fixed-base row tables
               made anew, as in a fresh process) and of prove; setup seconds,
               prove median of 3, verify seconds (host); then setup and prove
               at m = 2^4 on the card and on the CPU plain versions with the
               same seeds, keys and proofs equal point for point; K3's and
               K8's prove launches on a line of their own, and K1's and its
               chain's (at most 100 together, the chain at least once); K7
               timed beside
               its plain version at the MSM's 32,768 lanes, and K2 at the
               same shape;
  9. mixed add the entry points weierstrass.padd_mixed / padd_mixed_sel, counted:
               K9 over G1 at 2^15 lanes (the mask set on about 1 lane in 32)
               and at 4,194,304 points, K10 over G2 at the MSM's 32,768
               lanes; inputs with P = O, P = lam (qx, qy, 1) with lam != 1 (a
               doubling through the mixed formula), P = -Q (the sum is O), and
               lanes whose every c0 and c1 is 0, 1, q - 1 or R mod q; each
               kernel held against its plain version, against the complete add
               (K2, K7) of P and (qx, qy, one) and against the host group law
               on a sample of lanes, then timed beside its plain version;
 10. groth16   setup, prove and verify on square_chain(2^20) with 2 public
               inputs: the proof is accepted, and rejected under a wrong public
               input; the proof of a wrong witness is rejected; launch counts
               of setup and of prove (K3's and K8's on a line of their own,
               and K1's and its chain's, as for Pinocchio);
               setup seconds, prove median of 3, verify seconds; then setup
               and prove at m = 2^4 on the card and on the
               CPU plain versions with the same seeds, keys and proofs equal
               point for point;
 11. kzg       KZG and Gemini (commit/kzg.py, commit/gemini.py) from a seeded
               toxic waste s: setup of degree 2^20 with every G2 power (the
               fixed-base tables; seconds, the host's powers of s timed
               alone), [s^i]G1 and [s^i]G2 equal to the host's at seeded i;
               a 2^20-coefficient commit equal to [p(s)]G1 (median of 3);
               open at a seeded u (y and w equal to the host's; verify
               accepts, and rejects y + 1; K1 and its chain launched fewer
               than 1,000 times); batch open at 3 points (ys and w equal to
               the host's; batch verify accepts, and rejects one y changed);
               the degree proof at d = 2^19 (equal to the host's; verify true
               at d, false at d - 1); Gemini over the 2^20 coefficients with
               20 seeded rhos and a seeded beta (each of the 21 commitments
               equal to the host's [f_i(s)]G1; verify accepts, and rejects
               mu + 1, two whole verifies timed apart); fast_multiply at 2^19 x 2^19 (K6) and 2^8 x 2^8 (K5)
               against the host's p(x) q(x) at 3 points; KZG and Gemini at
               degree 15 on the card and on the CPU plain versions with the
               same s, commitments and proofs equal point for point; launch
               counts of commit, open, batch open, the degree proof and
               Gemini's commit and open; times beside the card's name and
               power limit;
 12. sumcheck  both sumcheck provers (protocols/sumcheck_tpu.py,
               protocols/sumcheck.py): the table prover on the sumcheck
               demo's problem (three multilinear factors of 8 terms from
               seed 45, degree 3) over a 2^20-point hypercube: the verifier
               accepts, and rejects a changed claimed sum and a changed
               round coefficient; K1 launches a prove under 2,000; the
               prove timed (median of 3, split into table build and
               rounds); the same prover at 2^12 equal to the host mirror
               (claimed sum and every round polynomial); the Gemini-tied
               prove_sumcheck at el = 20 on phase 11's SRS, an 8-term
               multilinear g: the hypercube sum equal to the host's, c_g
               equal to [f_i(s)]G1 of the host folds at the transcript's
               challenges, verify_sumcheck accepting, and rejecting a
               changed h and a changed g_j; the prove split into host
               rounds, commit and open; each verify timed; launch counts.
The build phase prints ptxas's registers and spills of every kernel and the
static SASS instruction counts (cuobjdump -sass) of the curve kernels.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object with one entry per kernel (its
"launches" from the proves, "kzg_launches" from phase 11's runs,
"sumcheck_launches" from phase 12's); the last
line is {"ok": true, "device": {...}}.  Any failure exits nonzero before it.
Neither this script nor the port imports JAX.
"""

from __future__ import annotations

import itertools
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
LOG_N = 20
LOG_N_C14 = 16
LOG_M_BIG, LOG_M_SMALL = 20, 12  # shifted h: four-step (K6) and Stockham (K5)
LOG_M_PIN = 20  # Pinocchio setup / prove / verify on square_chain(2^20)
LOG_M_CMP = 4  # the whole path on the card and on the CPU plain versions
LOG_M_G16, NPUB_G16 = 20, 2  # Groth16 on square_chain(2^20), 2 public inputs
MIX_WIDE = 1 << 22  # K9 at a fixed-base tree level's width (K2's timed shape)

# The card's peaks for a kernel's bound (NVIDIA H100 SXM at 700 W): device
# memory 3.35 TB/s; 32-bit integer multiply-adds at 64 per SM per clock
# (half the 128 float32 lanes behind the 67 TFLOP/s float32 peak), 132 SMs,
# 1.98 GHz.  A 256-bit Montgomery product (CIOS over eight 32-bit words) is
# 264 of them: 64 wide products a*b and 64 m*p at two each, plus 8 for m.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
IMAD_PER_MONT = 264
LIMB_BYTES = 64  # one element at the tensor interface: 16 int32 limbs
MSM_KERNELS = ("mont_mul", "mont_pow", "padd", "pdbl", "bucket_scan_rows", "padd_seg_level",
               "gather_planes", "scatter_rows")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of fn over reps calls (after one warm-up), CUDA events
    around the calls: the device's time where it is the longer, else the
    host's time to make the calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of fn's launches: reps calls captured in one CUDA
    graph (after one warm-up call), the graph replayed once to warm up and
    then timed with CUDA events.  The host's cost of a call is left out, so
    a launch shorter than the host takes to make it reads its own time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(nbytes: float, mont_products: float) -> dict:
    """The least time the card could take: bytes at the memory rate against
    Montgomery products at the integer multiply rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mont_products * IMAD_PER_MONT / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn):
    """(fn(), its seconds on the host clock, ended by a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = card()
    from myzkp_tpu_torch import _ext

    nvcc = subprocess.run([_ext._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"# device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc {nvcc}")


def phase_build() -> None:
    from myzkp_tpu_torch import _ext, native

    seconds = _ext.build()
    _ext.library()
    log(f"# build: {len(list(_ext.CSRC.glob('*.cu')))} sources -> "
        f"{_ext.library_path().name} in {seconds:.2f} s")
    t0 = time.perf_counter()
    native.build()
    native.library()
    log(f"# build: the verifier's host pairing -> {native.library_path().name} "
        f"in {time.perf_counter() - t0:.2f} s (g++)")
    for line in _ext.library_path().with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            log(f"#   ptxas: {line.strip()}")
    for kernel, counts in sass_counts(_ext.library_path()).items():
        log(f"#   sass {kernel}: {json.dumps(counts)}")


# SASS opcode classes counted per kernel: the 32-bit multiply-adds and adds of
# the Montgomery products and the carry chains, local memory (spills),
# shuffles, global memory, branches and calls.
SASS_CLASSES = ("IMAD", "IADD3", "LOP3", "SEL", "ISETP", "LDL", "STL", "SHFL", "LDG",
                "STG", "BRA", "CALL")


def sass_counts(lib) -> dict:
    """Static instruction counts of each curve kernel in the built library,
    from cuobjdump -sass: the total and each class of SASS_CLASSES (an opcode
    counts in the class it starts with: IMAD.WIDE.U32 is an IMAD)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = next((k for k in SASS_KERNELS if k in m.group(1)), None)
            arg = re.search(r"kernelILi(\d+)E", m.group(1))
            if name and arg:  # a template instantiation: kernel<R>
                name = f"{name}<{arg.group(1)}>"
            if name:
                out[name] = dict.fromkeys(("total",) + SASS_CLASSES, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            out[name]["total"] += 1
            cls = next((c for c in SASS_CLASSES if op.startswith(c)), None)
            if cls:
                out[name][cls] += 1
    return out


SASS_KERNELS = ("padd_seg_level_kernel", "padd2_seg_level_kernel", "padd_mixed_kernel",
                "padd_mixed2_kernel", "padd2_kernel", "pdbl2_kernel", "padd_kernel",
                "pdbl_kernel", "mont_mul_kernel", "mont_pow_kernel", "ntt_leaf_kernel")


def random_fe(rng: np.random.Generator, n: int, dev) -> torch.Tensor:
    """n random canonical F_q limb columns (top limb kept below q's)."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] = rng.integers(0, 0x3064, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def word_edges(p: int) -> list:
    """The values below p whose eight 32-bit words are each 0 or 0xFFFFFFFF,
    then p - 1, 1 and R mod p: the operands at the ends of every carry chain
    of the Montgomery product."""
    out = []
    for bits in range(256):
        v = sum(0xFFFFFFFF << (32 * k) for k in range(8) if bits >> k & 1)
        if v < p:
            out.append(v)
    return out + [p - 1, 1, (1 << 256) % p]


def bitcheck_mont_mul(spec, rng, dev, name: str) -> int:
    """K1 on 2^20 pairs: every pair of word_edges first, then random; exact
    against the plain version, and the edge pairs against the host too.
    Returns the max_abs_err."""
    from myzkp_tpu_torch.fields import limb

    p = spec.p
    edges = word_edges(p)
    k = len(edges) ** 2
    n = 1 << LOG_N
    a, b = random_fe(rng, n, dev), random_fe(rng, n, dev)
    a[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    b[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    got = limb.mont_mul(spec, a, b)
    err = check_equal(name, [got], [limb.mont_mul_ref(spec, a, b)])
    rinv = pow(1 << 256, -1, p)
    gi = limb.to_int(spec, got[:, :k])
    if any(int(g) != x * y * rinv % p
           for g, (x, y) in zip(gi, ((x, y) for x in edges for y in edges))):
        raise AssertionError(f"{name}: disagrees with the host on the word edges")
    log(f"# bitcheck {name}: 2^{LOG_N} pairs, the first {k} every pair of {len(edges)} "
        f"word edges (each 32-bit word 0 or 0xFFFFFFFF below p; p - 1, 1, R mod p): "
        f"exact, and the edge pairs == host")
    return err


def check_equal(name: str, got, want) -> int:
    got, want = list(got), list(want)
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version disagree")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_bitcheck(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, msm
    from myzkp_tpu_torch.fields import limb

    rng = np.random.default_rng(SEED)
    spec = bn254.q_spec()

    # K1 at 2^20 pairs, the word edges first
    err = bitcheck_mont_mul(spec, rng, dev, "mont_mul")
    results["mont_mul"] = {"max_abs_err": err}

    # K2 / K3 at 2^16 points: projective rescalings of 63 host points and
    # infinity, with P+P, P+(-P), P+O, O+Q and O+O among them
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    g = bn254.g1_generator()
    hrng = random.Random(SEED)
    host = [g * hrng.randrange(1, bn254.R) for _ in range(63)]
    host.append(bn254.curve_g1.infinity())
    base = bn254.g1_points_to_device(host, dev)
    m = 1 << 16
    ia = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    ib = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    kinds = torch.from_numpy(rng.integers(0, 8, m)).to(dev)
    ib = torch.where(kinds == 0, ia, ib)  # P + P
    ib = torch.where(kinds == 1, torch.full_like(ib, 63), ib)  # P + O
    ia = torch.where(kinds == 2, torch.full_like(ia, 63), ia)  # O + Q
    ia = torch.where(kinds == 3, torch.full_like(ia, 63), ia)  # O + O
    ib = torch.where(kinds == 3, torch.full_like(ib, 63), ib)

    def rescaled(idx):
        lam = random_fe(rng, m, dev)
        lam[0] |= 1  # nonzero
        return tuple(limb.mont_mul_ref(spec, c[:, idx], lam) for c in base)

    P, Q = rescaled(ia), rescaled(ib)
    negate = kinds == 4  # P + (-P)
    Q = (torch.where(negate, P[0], Q[0]),
         torch.where(negate, limb.neg(spec, P[1]), Q[1]),
         torch.where(negate, P[2], Q[2]))
    h = torch.from_numpy(rng.integers(0, 2, m).astype(bool)).to(dev)
    err = check_equal("padd", ck.padd(spec, b3, P, Q), ck.padd_ref(spec, b3, P, Q))
    err = max(err, check_equal("padd(h)", ck.padd(spec, b3, P, Q, h),
                               ck.padd_ref(spec, b3, P, Q, h)))
    sums = ck.padd(spec, b3, P, Q)
    got = bn254.g1_points_to_host(tuple(c[:, :256] for c in sums))
    ha, hb = ia[:256].tolist(), ib[:256].tolist()
    kk = kinds[:256].tolist()
    want = [host[x] + (-host[x] if k == 4 else host[y])
            for x, y, k in zip(ha, hb, kk)]
    if got != want:
        raise AssertionError("padd: disagrees with the host group law")
    results["padd"] = {"max_abs_err": err}
    log(f"# bitcheck padd: 2^16 points (P+P, P+(-P), P+O, O+Q, O+O), "
        f"with and without h: exact; 256 sums match the host")
    err = check_equal("pdbl", ck.pdbl(spec, b3, P), ck.pdbl_ref(spec, b3, P))
    dbl = bn254.g1_points_to_host(tuple(c[:, :256] for c in ck.pdbl(spec, b3, P)))
    if dbl != [host[x] + host[x] for x in ha]:
        raise AssertionError("pdbl: disagrees with the host group law")
    results["pdbl"] = {"max_abs_err": err}
    log("# bitcheck pdbl: 2^16 points incl. O: exact; 256 match the host")

    # K4 at N = 3000 lanes (ragged), K = 4
    rows, _ = msm._rows_of_point(tuple(c[:, :4 * 3000] for c in P))
    err = bitcheck_scan(spec, F, b3, rows, 4, rng, dev)
    results["bucket_scan_rows"] = {"max_abs_err": err}
    log(f"# bitcheck bucket_scan_rows: {SCAN_CASE}: acc and bucket table exact")


SCAN_CASE = ("N = 3000 lanes, K = 4, tags 0-3, flush targets on 3 steps in 10 "
             "(step 0 included) and -1 elsewhere, 375 table rows of 0, 1, q - 1, R mod q "
             "in every coordinate component; the table read in order (the row-major "
             "contract it replaced) and at seeded random indices with repeats")


def scan_table(F, S: int, width: int, dev):
    """An S-row bucket table of infinity rows, as the MSM makes it."""
    from myzkp_tpu_torch.curves import msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    return msm._rows_of_point(wst.infinity(F, (S,), dev), width)[0]


def bitcheck_scan(spec, F, b3, table, K: int, rng, dev) -> int:
    """K4 (G1) or its G2 instance against the plain version on a table of
    K * N points: all four tags (the first eight pinned), unique random flush
    targets on about 3 steps in 10, step 0 included, -1 elsewhere; N / 8
    rows at seeded random positions hold 0, 1, q - 1 or R mod q in every
    coordinate component.  Read in order (idx = arange: step k of lane l
    reads row k * N + l, the row-major contract the scan had before it read
    by index), some edge rows are added (no segment head) to a live
    accumulator at a step after 0; then read at seeded random indices with
    repeats.  acc and the whole bucket table must agree exactly."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.fields import limb

    total, W = table.shape
    N = total // K
    table = table.clone()
    E = N // 8
    at = np.sort(rng.choice(total, E, replace=False))
    at_dev = torch.from_numpy(at).to(dev)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    for j in range(W // 64 * 3):  # coordinate components: 3 for G1, 6 for G2
        vals = [edges[i] for i in rng.integers(0, 4, E)]
        table[at_dev, 16 * j:16 * j + 16] = limb.from_int(spec, vals, dev).T
    tag = torch.from_numpy(rng.integers(0, 4, total).astype(np.int32)).to(dev)
    tag[:8] = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], dtype=torch.int32)
    if not ((at >= N) & (tag.cpu().numpy()[at] & 2 == 0)).any():
        raise AssertionError("bucket scan bitcheck: no edge row added after step 0")
    S = total + 64
    tgt = np.where(rng.random(total) < 0.3, rng.permutation(S)[:total], -1)
    tgt = torch.from_numpy(tgt.astype(np.int32)).to(dev)
    if not (tgt[:N] >= 0).any():
        raise AssertionError("bucket scan bitcheck: no flush at step 0")
    g2 = isinstance(b3, tuple)
    name = "bucket_scan_rows2" if g2 else "bucket_scan_rows"
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    at_random = torch.from_numpy(rng.integers(0, total, total).astype(np.int32)).to(dev)
    if at_random.unique().numel() == total:
        raise AssertionError("bucket scan bitcheck: no repeated index")
    err = 0
    for kind, idx in (("in order", torch.arange(total, dtype=torch.int32, device=dev)),
                      ("random, repeating", at_random)):
        t_k, t_p = scan_table(F, S, W, dev), scan_table(F, S, W, dev)
        acc = scan(spec, table, idx, tag, tgt, b3, t_k, K)
        acc_p = ck.bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, t_p, K)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"{name} [idx {kind}]", [acc, t_k], [acc_p, t_p]))
    return err


def time_scan(F, b3, pts, dev, results: dict) -> None:
    """The bucket scan at the 2^20 MSM's shape, one window group (c = 16,
    G = 2, K = 64, 32,768 lanes) of seeded scalars' sorted digits, reading
    the 2^20-point table by the path's own indices, with its tags and
    targets: the indices checked below the table's rows, the real targets
    unique, the kernel held to its plain version (acc and the whole bucket
    table exact; repeated launches rewrite the same rows), both timed, and
    beside them the parent's path: the step-major gather (index_select) and
    the scan over the gathered copy read in order, held to the kernel's
    result and timed, each of the two also alone.  It is two steps, not one
    PyTorch call computing the scan, so library_ms stays null.  Then probe 13
    (tools/exp_kernel_ledger.py:80): the same K steps as K launches of the
    select-masked complete add (K2 for G1, K7 for G2) over plane-major
    inputs laid out beforehand from its own gathered copy, its result equal
    to the scan's acc, timed the same way."""
    from myzkp_tpu_torch.curves import curve_kernels as ck, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    g2 = isinstance(b3, tuple)
    name = "bucket_scan_rows2" if g2 else "bucket_scan_rows"
    spec = F.spec
    n = wst.leaves(pts)[0].shape[1]
    rng = np.random.default_rng(SEED + 10)
    c = msm.default_window(n)
    num_buckets = (1 << (c - 1)) + 1
    G = msm._group_size(n, -(-256 // c), num_buckets + 1)
    K = int(min(n, max(8, msm._next_pow2(G * n // (1 << 15)))))
    N = G * n // K
    digits, dneg = msm.signed_digits(msm.scalar_digits(random_fe(rng, n, dev), c), c)
    d_sorted, order = torch.sort(digits[:G], dim=1, stable=True)
    vals = (torch.arange(n, dtype=torch.int32, device=dev)[None] << 1) | dneg[:G].int()
    idx, tag, tgt = msm._scan_inputs(vals.gather(1, order), d_sorted, num_buckets, K)
    table, C = msm._rows_of_point(pts)
    if int(idx.min()) < 0 or int(idx.max()) >= table.shape[0]:
        raise AssertionError(f"{name}: an index outside the {table.shape[0]}-row table")
    real = tgt[tgt >= 0]
    msm._check_unique_targets(real, num_buckets, num_buckets + 1)  # raises
    if (tgt[:N] >= 0).any():
        raise AssertionError(f"{name}: a flush target at step 0")
    S, W = G * (num_buckets + 1), table.shape[1]
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    t_k, t_p, t_l = (scan_table(F, S, W, dev) for _ in range(3))
    in_order = torch.arange(K * N, dtype=torch.int32, device=dev)
    kern = lambda: [scan(spec, table, idx, tag, tgt, b3, t_k, K), t_k]
    plain = lambda: [ck.bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, t_p, K), t_p]
    parent = lambda: [scan(spec, table.index_select(0, idx), in_order, tag, tgt, b3, t_l, K),
                      t_l]
    heads, flushes = int(((tag & 2) > 0).sum()), int(real.numel())
    adds = 42 if g2 else 14  # Montgomery products of a complete add
    # the used limbs of each table row the steps read, once; each step's
    # index, tag and target; the real flushes; acc
    used = int(idx.unique().numel())
    bnd = bound(used * 4 * C + K * N * 12 + flushes * 4 * C + N * 4 * C
                + LIMB_BYTES * (C // 48), adds * (K * N - heads))
    shape = f"K = {K}, N = {N} lanes, {heads} heads, {flushes} real flushes"
    time_cases({name: (shape, kern, plain, 5, 1, bnd)}, results)
    acc = kern()[0]
    check_equal(f"{name} the parent's path [{shape}]", parent(), kern())
    rows = table.index_select(0, idx)  # the parent's gathered copy
    split = {"parent_path_ms": graph_time_ms(parent, 5),
             "index_select_ms": graph_time_ms(lambda: table.index_select(0, idx), 5),
             "scan_of_copy_ms": graph_time_ms(
                 lambda: scan(spec, rows, in_order, tag, tgt, b3, t_l, K), 5)}
    results.setdefault("_scan_parent_path", {})[name] = split
    log(f"# {name}: the parent's path {split['parent_path_ms']:.4f} ms = index_select "
        f"{split['index_select_ms']:.4f} ms + the scan of the copy read in order "
        f"{split['scan_of_copy_ms']:.4f} ms; the scan reading the table by index "
        f"{results[name]['ms']:.4f} ms")

    # probe 13: K launches of K2 / K7 with the mask, acc <- Q on a head
    q_rows = rows.reshape(K, N, W)
    steps = []
    for k in range(K):
        q = msm._point_of_rows(q_rows[k], C, (N,))
        neg = (tag[k * N:(k + 1) * N] & 1) > 0
        q = wst.point_map(torch.Tensor.contiguous,
                          wst.Point(q.x, F.select(neg, F.neg(q.y), q.y), q.z))
        steps.append((q, (tag[k * N:(k + 1) * N] & 2) > 0))
    add = ck.padd2 if g2 else ck.padd

    def loop():
        p = wst.point_map(torch.Tensor.contiguous, wst.infinity(F, (N,), dev))
        for q, h in steps:
            p = add(spec, b3, p, q, h)
        return p

    check_equal(f"probe 13 [{name}]", list(wst.leaves(loop())),
                list(wst.leaves(wst.from_leaves(acc.split(16)))))
    time_level(F, b3, acc, d_sorted, K, results)
    loop_ms = cuda_time_ms(loop, 3)
    results.setdefault("_probe13", {})[name] = {
        "scan_ms": results[name]["ms"], "loop_ms": loop_ms, "K": K, "lanes": N,
        "heads": heads, "real_flushes": flushes}
    log(f"# probe 13 [{shape}]: {K} launches of {'K7' if g2 else 'K2'} with the "
        f"mask {loop_ms:.4f} ms against the scan's {results[name]['ms']:.4f} ms; "
        f"the loop's acc == the scan's")


def time_level(F, b3, acc, d_sorted, K: int, results: dict) -> None:
    """The lane merge's first level (d = 1) on its own inputs in the 2^20
    MSM: the scan's acc as (G, B) lanes and the segment heads of the lanes'
    last digits, as msm._merge_lane_partials makes them; held to its plain
    version and timed.  Then the same lanes with lane 0 the only head, where
    every other lane adds (the level's most work at this shape)."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    g2 = isinstance(b3, tuple)
    name = "padd2_seg_level" if g2 else "padd_seg_level"
    level = ck.padd2_seg_level if g2 else ck.padd_seg_level
    ref = ck.padd2_seg_level_ref if g2 else ck.padd_seg_level_ref
    spec = F.spec
    G, n = d_sorted.shape
    B = n // K
    x = tuple(wst.point_map(lambda a: a.reshape(16, G, B).contiguous(),
                            wst.from_leaves(acc.split(16))))
    d_end = d_sorted.reshape(G, B, K)[..., -1]
    ones = torch.ones((G, 1), dtype=torch.bool, device=d_end.device)
    heads = torch.cat([ones, d_end[:, 1:] != d_end[:, :-1]], dim=-1)
    C = 48 * (2 if g2 else 1)
    adds_per = G2_ADD_PRODUCTS if g2 else 14
    L = lambda r: list(wst.leaves(wst.Point(*r[0]))) + [r[1]]
    nbytes = 2 * (4 * C * G * B + G * B) + LIMB_BYTES * (C // 48)
    copies = [x] + [tuple(wst.point_map(torch.clone, wst.Point(*x)))
                    for _ in range(2 * L2_BYTES // nbytes + 1)]
    for kind, h in (("path", heads), ("lane0", torch.zeros_like(heads))):
        h = h.clone()
        h[:, 0] = True
        adds = int((~h).sum())
        kern, kept = cold_calls(lambda xc: L(level(spec, b3, xc, h, 1)), copies)
        case = {name: (f"({G}, {B}) lanes, d = 1, heads {kind}: {adds} adds; "
                       f"inputs cold ({len(copies)} copies)",
                       kern, lambda: L(ref(spec, b3, x, h, 1)), 50, 1,
                       bound(nbytes, adds_per * adds))}
        if kind == "path":
            time_cases(case, results)
        else:
            res = {name: {"max_abs_err": 0}}
            time_cases(case, res)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               res[name]["max_abs_err"])
            results.setdefault("_levels_all_adds", {})[name] = res[name]
        kept.clear()


def cold_calls(fn, inputs: list):
    """(call, kept): call() runs fn on inputs[0], inputs[1], ... in turn and
    keeps every result in kept.  With enough copies of the same inputs that
    the bytes between two uses of one copy pass the L2, each call reads its
    inputs from memory and writes memory that no call has touched, as the
    bytes bound assumes; a graph replay of one input set would find it in
    L2.  Clear kept after the timing."""
    turn, kept = itertools.cycle(inputs), []

    def call():
        kept.append(fn(next(turn)))
        return kept[-1]
    return call, kept


def phase_slice(dev, results: dict) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    n = 1 << LOG_N
    rng = random.Random(SEED)
    ms = [rng.randrange(1, bn254.R) for _ in range(n)]
    ks = [rng.randrange(0, bn254.R) for _ in range(n)]
    ks[0], ks[1], ks[2], ks[3] = 0, 5, 5, bn254.R - 1  # zero and duplicates
    rspec = bn254.r_spec()
    m_limbs = msm.scalars_from_int(rspec, ms, dev)
    k_limbs = msm.scalars_from_int(rspec, ks, dev)
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    g = bn254.g1_generator()
    exp = g * (sum(k * m for k, m in zip(ks, ms)) % bn254.R)

    def to_host_single(pt):
        return bn254.g1_points_to_host(wst.Point(*(c[:, None] for c in pt)))[0]

    # the main path, counted: setup, MSM, result to the host
    table = ("loaded from its .npz cache"
             if fixed_base.table_path("g1").exists()
             else "built on the host first")
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    pts = fixed_base.fixed_base_multi("g1", m_limbs)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = msm.msm(F, b3, pts, k_limbs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = to_host_single(res)
    counts = {k: _ext.launches[k] for k in MSM_KERNELS}
    if got != exp:
        raise AssertionError("MSM 2^20: result differs from the host golden")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    c = msm.default_window(n)
    log(f"# slice fixed-base g1 2^{LOG_N}: {fb_s:.3f} s (table {table})")
    log(f"# slice msm 2^{LOG_N} (c = {c}): first run {first_s:.3f} s; result "
        f"== host [sum k_i m_i mod r]G")
    log(f"# slice launches: {json.dumps(counts)}")
    for k, v in counts.items():
        results[k]["launches"] = v

    # MSM timing: median of 5 reps after the warm-up above
    med, ts = median_ms(lambda: msm.msm(F, b3, pts, k_limbs))
    results["_msm"] = {"ms": med, "reps_ms": ts, "points_per_s": n / med * 1e3,
                       "fixed_base_s": fb_s}
    log(f"# slice msm 2^{LOG_N}: median {med:.2f} ms of "
        f"{[round(t, 2) for t in ts]} -> {n / med * 1e3:,.0f} points/s")

    # msm_pippenger at 2^16 with c = 14 (the step-0 flush fault's shape)
    n2 = 1 << LOG_N_C14
    sub = wst.Point(*(c_[:, :n2] for c_ in pts))
    res2 = msm.msm_pippenger(F, b3, sub, k_limbs[:, :n2].contiguous(), c=14)
    exp2 = g * (sum(k * m for k, m in zip(ks[:n2], ms[:n2])) % bn254.R)
    if to_host_single(res2) != exp2:
        raise AssertionError("MSM 2^16 c = 14: result differs from the host")
    log(f"# slice msm_pippenger 2^{LOG_N_C14} c = 14: == host golden")

    # each kernel beside its plain version at the slice's own shapes
    spec = bn254.q_spec()
    W = -(-256 // 8)
    tree_w = (W // 2) * fixed_base._CHUNK  # first tree level of one chunk
    x = tuple(cc.repeat(1, -(-tree_w // n))[:, :tree_w].contiguous() for cc in pts)
    y = tuple(torch.roll(cc, 1, dims=1) for cc in x)
    cases = {
        "padd": (f"{tree_w} points, first fixed-base tree level",
                 lambda: ck.padd(spec, b3, x, y),
                 lambda: ck.padd_ref(spec, b3, x, y), 5, 1,
                 bound(9 * LIMB_BYTES * tree_w + LIMB_BYTES, 14 * tree_w)),
    }
    time_cases(cases, results)
    del x, y
    time_scan(F, b3, pts, dev, results)


def time_cases(cases: dict, results: dict) -> None:
    """Each kernel against its plain version (exact), then both timed: the
    kernel by graph replay (graph_time_ms), the plain version with CUDA
    events around its calls; the bound and the library time go beside
    them.  A case is (shape, kernel, plain, reps, plain reps, bound) and,
    where PyTorch calls compute the same function, a seventh entry: those
    calls, held to the kernel's result and timed by graph replay as
    library_ms (else null: no PyTorch call computes a 256-bit Montgomery
    product)."""
    as_list = lambda r: [r] if torch.is_tensor(r) else list(r)
    for name, (shape, kern, plain, reps, preps, bnd, *lib) in cases.items():
        err = check_equal(f"{name} [{shape}]", as_list(kern()), as_list(plain()))
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms_k, ms_p = graph_time_ms(kern, reps), cuda_time_ms(plain, preps)
        ms_l = None
        if lib:
            check_equal(f"{name} library [{shape}]", as_list(lib[0]()), as_list(kern()))
            ms_l = graph_time_ms(lib[0], reps)
        res.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_l, **bnd)
        log(f"# time {name} [{shape}]: exact vs plain; kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})" + (f", library {ms_l:.4f} ms" if lib else ""))


def phase_bitcheck_fr(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 1)
    spec = bn254_r_spec()
    p = spec.p
    edges = [0, 1, p - 1, (1 << 256) % p]
    ea = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    eb = limb.from_int(spec, [y for _ in edges for y in edges], dev)

    # K1 over F_r at 2^20 pairs, the word edges first
    n = 1 << LOG_N
    err = bitcheck_mont_mul(spec, rng, dev, "mont_mul over F_r")
    results["mont_mul"]["max_abs_err"] = max(results["mont_mul"]["max_abs_err"], err)

    # K5: 2^20 pairs as a (16, R = 2, Bk = 4, 2h = 512, B = 512) stage input;
    # u and v of the first 16 pairs are the crossed edges
    x = random_fe(rng, 2 * n, dev).reshape(16, 2, 4, 512, n >> 11)
    x[:, 0, 0, 0, :16], x[:, 0, 0, 256, :16] = ea, eb
    tw = random_fe(rng, 256, dev)
    err = check_equal("butterfly", [nk.butterfly(spec, x, tw)],
                      [nk.butterfly_ref(spec, x, tw)])

    # K5 at every stage of the m = 2^12 path's transforms: the batched INTT
    # (R = 3, 2^12 points), the batched coset NTT (R = 3, 2^13) and the coset
    # INTT (R = 1, 2^13); each stage's input is the kernel's previous output
    for R, c, inv in STOCKHAM_TRANSFORMS:
        y = random_fe(rng, R * c, dev).reshape(16, R, 1, c, 1)
        for s in range(c.bit_length() - 1):
            tw = ntt._stage_twiddle_dev(spec, c, s, inv, dev)
            got = nk.butterfly(spec, y, tw)
            err = max(err, check_equal(f"butterfly {tuple(y.shape)}", [got],
                                       [nk.butterfly_ref(spec, y, tw)]))
            y = got
    results["butterfly"] = {"max_abs_err": err}
    log(f"# bitcheck butterfly: 2^{LOG_N} pairs (R = 2, Bk = 4, h = 256, "
        f"B = {n >> 11}) + 16 edge pairs, and every stage of "
        f"{len(STOCKHAM_TRANSFORMS)} transforms (R, n, inverse) "
        f"{STOCKHAM_TRANSFORMS}: exact")

    # K6 at every leaf shape of the main paths, then E = 2 with a ragged B
    err = 0
    for E, m, B, inv in sorted(set(leaf_shapes())):
        xl = random_fe(rng, E * m * B, dev).reshape(16, E, m, B)
        twl = ntt._leaf_twiddles(spec, m, inv, dev)
        err = max(err, check_equal(f"ntt_leaf ({E}, {m}, {B}) inverse = {inv}",
                                   [nk.ntt_leaf(spec, xl, twl)],
                                   [nk.ntt_leaf_ref(spec, xl, twl)]))
    for m in (16, 64, 128):
        xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
        for inv in (False, True):
            twl = ntt._leaf_twiddles(spec, m, inv, dev)
            err = max(err, check_equal(f"ntt_leaf m = {m} inverse = {inv}",
                                       [nk.ntt_leaf(spec, xl, twl)],
                                       [nk.ntt_leaf_ref(spec, xl, twl)]))
    m = nk.MAX_LEAF
    xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
    for inv in (False, True):
        twl = ntt._leaf_twiddles(spec, m, inv, dev)
        for s in range(1, m.bit_length()):
            err = max(err, check_equal(f"ntt_leaf m = {m} stages = {s} inverse = {inv}",
                                       [nk.ntt_leaf(spec, xl, twl, s)],
                                       [nk.ntt_leaf_ref(spec, xl, twl, s)]))
    # a table of random entries, so that no stage row starts with 1: the
    # kernel must then run the j = 0 products it skips on the paths' tables
    for m in (4, 16, 128):
        xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
        twl = random_fe(rng, m - 1, dev)
        err = max(err, check_equal(f"ntt_leaf m = {m}, random table",
                                   [nk.ntt_leaf(spec, xl, twl)],
                                   [nk.ntt_leaf_ref(spec, xl, twl)]))
    results["ntt_leaf"] = {"max_abs_err": err}
    log(f"# bitcheck ntt_leaf: the paths' leaves (E, m, B, inverse) "
        f"{sorted(set(leaf_shapes()))}; m = 16, 64, 128, E = 2, B = 3000, "
        f"and m = 128 at every stage count 1..{m.bit_length() - 1}, "
        f"forward and inverse; m = 4, 16, 128 on a random table: exact")
    bitcheck_broadcast(spec, rng, dev, results)

    # segment_sum_mod at 2^20 entries on the card against the same call on
    # the host's CPU and against Python ints: 2^12 segments, the odd ones
    # empty but segment 1, which takes 2^14 entries of r - 1
    nnz, nseg, heavy = n, 1 << 12, 1 << 14
    vals = random_fe(rng, nnz, dev)
    vals[:, :heavy] = limb.from_int(spec, [p - 1], dev)
    segs = 2 * torch.from_numpy(rng.integers(0, nseg // 2, nnz)).to(dev)
    segs[:heavy] = 1
    got = limb.segment_sum_mod(spec, vals, segs, nseg)
    cpu = limb.segment_sum_mod(spec, vals.cpu(), segs.cpu(), nseg)
    if not torch.equal(got.cpu(), cpu):
        raise AssertionError("segment_sum_mod: the card and the CPU disagree")
    want = [0] * nseg
    for v, s in zip(limb.to_int(spec, vals), segs.tolist()):
        want[s] += int(v)
    if [int(x) for x in limb.to_int(spec, got)] != [w % p for w in want]:
        raise AssertionError("segment_sum_mod: disagrees with the host's sums")
    log(f"# bitcheck segment_sum_mod: {nnz} entries into {nseg} segments "
        f"({nseg // 2 - 1} empty, {heavy} x (r - 1) in one): card == CPU == host")


POW_SIZES = (1, 2, 3, 16, 4097)


def pow_exponents(p: int) -> tuple:
    """The chain's exponents: 0, 1, 2, 3, p - 2 and a seeded 256-bit one."""
    return (0, 1, 2, 3, p - 2, random.Random(SEED).getrandbits(256) | 1 << 255)


def phase_bitcheck_pow(dev, results: dict) -> None:
    """K1's chain (limb.pow_const, one launch) over F_q and F_r against its
    plain version and the host's pow(x, e, p)."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, bn254_r_spec

    rng = np.random.default_rng(SEED + 7)
    err = 0
    for spec in (bn254_q_spec(), bn254_r_spec()):
        p, R = spec.p, 1 << 256
        rinv = pow(R, -1, p)
        for n in POW_SIZES:
            a = random_fe(rng, n, dev)
            edges = [0, 1, p - 1, R % p]  # as Montgomery words
            a[:, :min(n, 4)] = limb.from_int(spec, edges[:n], dev)
            xs = [int(v) * rinv % p for v in limb.to_int(spec, a)]
            for e in pow_exponents(p):
                before = _ext.launches["mont_pow"]
                got = limb.pow_const(spec, a, e)
                if _ext.launches["mont_pow"] != before + 1:
                    raise AssertionError("pow_const: not one launch of the chain")
                err = max(err, check_equal(f"mont_pow n = {n} e = {e}", [got],
                                           [limb.mont_pow_ref(spec, a, e)]))
                gi = limb.to_int(spec, got)
                if any(int(g) != pow(x, e, p) * R % p for g, x in zip(gi, xs)):
                    raise AssertionError(f"mont_pow n = {n} e = {e}: differs from the host")
    results["mont_pow"] = {"max_abs_err": err}
    log(f"# bitcheck mont_pow: F_q and F_r, {POW_SIZES} "
        f"elements (0, 1, p - 1, R mod p among them), e = 0, 1, 2, 3, p - 2 and a "
        f"seeded 256-bit e, one launch each: exact vs plain and == host pow(x, e, p)")


def bitcheck_broadcast(spec, rng, dev, results: dict) -> None:
    """K1 with one operand broadcast along leading batch axes, read in place
    with a period, at the broadcasts of the paths (F_r, the 2^21-point
    batched coset NTT of shifted h at 2^20), against the plain version."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.ops import ntt

    n, E = 2 << LOG_M_BIG, 3
    m1, m2 = ntt._fourstep_split(n)
    x = random_fe(rng, E * n, dev).reshape(16, E, n)
    r2_col = limb._limb_column(spec.r2_limbs, 1, dev)
    cases = {
        "1/n constant (16, 1, 1) against (16, 3, n)": (
            x, limb.const(spec, spec.to_mont_int(pow(n, -1, spec.p)), (1, 1), dev)),
        "coset offsets (16, n) against (16, 3, n)": (x, random_fe(rng, n, dev)),
        "level table (16, m1, m2, 1) against (16, 3, m1, m2, 1)": (
            x.reshape(16, E, m1, m2, 1),
            ntt.fourstep_tables(spec, n, False, dev)[0].reshape(16, m1, m2, 1)),
        "to_mont column (16, 1) against (16, n)": (x[:, 0], r2_col),
        "the same, operands swapped": (r2_col, x[:, 0]),
    }
    err = results["mont_mul"]["max_abs_err"]
    for name, (a, b) in cases.items():
        before = _ext.launches["mont_mul"]
        got = limb.mont_mul(spec, a, b)
        if _ext.launches["mont_mul"] != before + 1:
            raise AssertionError(f"mont_mul [{name}]: not one launch")
        err = max(err, check_equal(f"mont_mul [{name}]", [got],
                                   [limb.mont_mul_ref(spec, a, b)]))
    results["mont_mul"]["max_abs_err"] = err
    log(f"# bitcheck mont_mul with a broadcast operand read in place, n = 2^{LOG_M_BIG + 1}: "
        f"{'; '.join(cases)}: exact")


# The transforms of the paths, as the port runs them (ops/ntt.py): Stockham
# (R, n, inverse) of shifted h at m = 2^12, and the K6 leaves (E, m, B,
# inverse) of the four-step recursion of shifted h at m = 2^20 and the NTT.
STOCKHAM_TRANSFORMS = ((3, 1 << LOG_M_SMALL, True), (3, 2 << LOG_M_SMALL, False),
                       (1, 2 << LOG_M_SMALL, True))


def leaf_shapes() -> list:
    from myzkp_tpu_torch.ops import ntt

    out = []
    for E, n, inv in ((3, 1 << LOG_M_BIG, True), (3, 2 << LOG_M_BIG, False),
                      (1, 2 << LOG_M_BIG, True), (1, 1 << LOG_N, False)):
        B, last = 1, n
        for _, m1, m2 in ntt._fourstep_splits(n):
            out.append((E, m1, m2 * B, inv))
            B, last = B * m1, m2
        out.append((E, last, B, inv))
    return out


def horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def median_ms(fn, reps: int = 5) -> tuple:
    """Median and all reps (ms) of fn on the host clock, each ended by a
    synchronize; the caller has run fn once already."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def counted(fn):
    """fn() run once with every launch count set to 0 first; returns its
    result and the counts that moved."""
    from myzkp_tpu_torch import _ext

    torch.cuda.synchronize()
    _ext.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _ext.launches.items() if v}


def phase_ntt(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    p, n = spec.p, 1 << LOG_N
    rng = random.Random(SEED + 2)
    coeffs = [rng.randrange(p) for _ in range(n)]
    a = Fp.from_int(spec, coeffs, dev)
    ev, counts = counted(lambda: ntt.ntt(a))
    if counts.get("ntt_leaf", 0) < 1:
        raise AssertionError(f"NTT 2^{LOG_N}: K6 never launched: {counts}")
    w = ntt.nth_root_of_unity(p, n)
    ks = rng.sample(range(n), 3)
    got = Fp(spec, ev.mont[:, ks]).to_int()
    if [int(g) for g in got] != [horner(coeffs, pow(w, k, p), p) for k in ks]:
        raise AssertionError(f"NTT 2^{LOG_N}: a(w^k) differs from the host")
    if not torch.equal(ntt.intt(ev).mont, a.mont):
        raise AssertionError(f"NTT 2^{LOG_N}: intt(ntt(a)) != a")
    med, ts = median_ms(lambda: ntt.ntt(a))
    results["_ntt"] = {"ms": med, "reps_ms": ts, "launches": counts}
    log(f"# ntt 2^{LOG_N}: a(w^k) == host at k = {ks}; intt(ntt(a)) == a; "
        f"launches {json.dumps(counts)}; median {med:.3f} ms of "
        f"{[round(t, 3) for t in ts]}")


def phase_shifted_h(dev, log_m: int) -> dict:
    from myzkp_tpu_torch.arith import sparse
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.snark import pinocchio

    spec = bn254_r_spec()
    p, m = spec.p, 1 << log_m
    rng = random.Random(SEED + log_m)
    t0 = time.perf_counter()
    r1cs, asg = sparse.square_chain(spec, m, x0=rng.randrange(2, p), device=dev)
    qap = sparse.SparseQAP(r1cs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    deltas = [rng.randrange(p) for _ in range(3)]
    t0 = time.perf_counter()
    H, counts = counted(lambda: pinocchio.get_shifted_h(qap, asg, *deltas))
    first_s = time.perf_counter() - t0

    ell, r, o = (x.coef.to_int().tolist() for x in qap.combine(asg))
    hc = H.coef.to_int().tolist()
    if len(hc) != m + 1:
        raise AssertionError(f"shifted h 2^{log_m}: {len(hc)} coefficients")
    u = r1cs.left.matvec(asg)
    w = ntt.nth_root_of_unity(p, m)
    js = rng.sample(range(m), 2)
    uj = [int(v) for v in Fp(spec, u.mont[:, js]).to_int()]
    if uj != [horner(ell, pow(w, j, p), p) for j in js]:
        raise AssertionError(f"shifted h 2^{log_m}: ell(w^j) != u_j")
    s = rng.randrange(p)
    t = (pow(s, m, p) - 1) % p
    d_ell, d_r, d_o = deltas
    lhs = ((horner(ell, s, p) + d_ell * t) * (horner(r, s, p) + d_r * t)
           - (horner(o, s, p) + d_o * t))
    if (lhs - horner(hc, s, p) * t) % p:
        raise AssertionError(f"shifted h 2^{log_m}: the Pinocchio identity fails")
    med, ts = median_ms(lambda: pinocchio.get_shifted_h(qap, asg, *deltas))
    log(f"# shifted h m = 2^{log_m}: ell(w^j) == u_j at j = {js}; "
        f"(ell + d_ell t)(r + d_r t) - (o + d_o t) == H t at a random s; "
        f"circuit built in {build_s:.3f} s; first call {first_s:.3f} s")
    log(f"# shifted h m = 2^{log_m} launches: {json.dumps(counts)}")
    log(f"# shifted h m = 2^{log_m}: median {med:.3f} ms of "
        f"{[round(t_, 3) for t_ in ts]}")
    return {"ms": med, "reps_ms": ts, "first_s": first_s, "launches": counts}


def leaf_products(m: int) -> int:
    """The Montgomery products a length-m leaf needs a column: log2(m) stages
    of m / 2 pairs, less the pairs whose twiddle is 1 (j = 0: one a block,
    m - 1 in all), which K6 skips."""
    return m // 2 * (m.bit_length() - 1) - (m - 1)


def time_ntt_kernels(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    rng = np.random.default_rng(SEED + 3)
    # K6 at the leaf shape of the batched 2^21 coset NTT (three of the nine
    # launches of shifted h at 2^20); K5 at stage 0 of the batched 2^13 coset
    # NTT of shifted h at 2^12
    E, m, B = 3, 128, 1 << 14
    xl = random_fe(rng, E * m * B, dev).reshape(16, E, m, B)
    twl = ntt._leaf_twiddles(spec, m, False, dev)
    R, c = 3, 2 << LOG_M_SMALL
    xb = random_fe(rng, R * c, dev).reshape(16, R, 1, c, 1)
    twb = ntt._stage_twiddle_dev(spec, c, 0, False, dev)
    pairs = R * c // 2
    cases = {
        "ntt_leaf": (f"E = {E}, m = {m}, B = {B}: a leaf level of the batched "
                     f"2^{LOG_M_BIG + 1}-point coset NTT",
                     lambda: nk.ntt_leaf(spec, xl, twl),
                     lambda: nk.ntt_leaf_ref(spec, xl, twl), 5, 1,
                     bound(2 * LIMB_BYTES * E * m * B + (m - 1) * LIMB_BYTES,
                           E * B * leaf_products(m))),
        "butterfly": (f"(16, {R}, 1, {c}, 1): stage 0 of the batched "
                      f"2^{LOG_M_SMALL + 1}-point coset NTT",
                      lambda: nk.butterfly(spec, xb, twb),
                      lambda: nk.butterfly_ref(spec, xb, twb), 100, 3,
                      bound(4 * LIMB_BYTES * pairs + LIMB_BYTES * (c // 2), pairs)),
    }
    time_cases(cases, results)
    every = bound(0, E * B * (m // 2) * (m.bit_length() - 1))["bound_ms"]
    log(f"# ntt_leaf: the bound counts the {leaf_products(m)} products a column needs; "
        f"all {m // 2 * (m.bit_length() - 1)} would take {every:.4f} ms")


def time_k1(dev, results: dict | None) -> dict:
    """K1 and its chain against their plain versions (exact), each timed by
    time_cases: K1 at (16, 8192) (a setup to_mont, the shape timed before),
    at the level-twiddle pass of the batched 2^21-point coset NTT (3 x 2^21
    elements against the level table: the quotient's widest K1 pass), and
    pow_const on 2 elements with e = q - 2 (the proof's inversion).  The
    level pass and the chain go to results (the kernels line); every case
    to the returned dict, printed as '# k1'.  pow_const is also timed with
    CUDA events around its calls in every tree (host time included: what
    it costs a prove), the one method a tree without the chain allows: its
    pow_const is a loop of K1 launches that makes tensors from host data,
    which a graph cannot capture, and is held to the same call on the CPU."""
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 14)
    qspec, rspec = bn254_q_spec(), bn254_r_spec()
    a, b = random_fe(rng, 8192, dev), random_fe(rng, 8192, dev)
    n = 2 << LOG_M_BIG
    m1, m2 = ntt._fourstep_split(n)
    xw = random_fe(rng, 3 * n, dev).reshape(16, 3, m1, m2, 1)
    tab = ntt.fourstep_tables(rspec, n, False, dev)[0].reshape(16, m1, m2, 1)
    e = qspec.p - 2
    a2 = random_fe(rng, 2, dev)
    products = 2 * (e.bit_length() - 1 + bin(e).count("1"))
    cases = {
        "setup": ("mont_mul", "(16, 8192): a setup to_mont",
                  lambda: limb.mont_mul(qspec, a, b), lambda: limb.mont_mul_ref(qspec, a, b),
                  100, 3, bound(3 * LIMB_BYTES * 8192, 8192)),
        "level": ("mont_mul", f"(16, 3, {m1}, {m2}, 1) x (16, {m1}, {m2}, 1): the "
                  f"level-twiddle pass of the batched 2^{LOG_M_BIG + 1}-point coset NTT",
                  lambda: limb.mont_mul(rspec, xw, tab),
                  lambda: limb.mont_mul_ref(rspec, xw, tab), 20, 1,
                  bound(LIMB_BYTES * (2 * 3 * n + n), 3 * n)),
        "chain": ("mont_pow", "pow_const, 2 elements, e = q - 2: the proof's inversion",
                  lambda: limb.pow_const(qspec, a2, e),
                  lambda: limb.mont_pow_ref(qspec, a2, e), 20, 1,
                  bound(2 * 2 * LIMB_BYTES, products)),
    }
    call = lambda: limb.pow_const(qspec, a2, e)
    check_equal("pow_const", [call()], [limb.pow_const(qspec, a2.cpu(), e).to(dev)])
    out = {"inversion_events_ms": cuda_time_ms(call, 5)}
    log(f"# time pow_const [2 elements, e = q - 2]: exact vs the CPU; "
        f"{out['inversion_events_ms']:.4f} ms a call (CUDA events around the calls)")
    if not hasattr(limb, "mont_pow_ref"):
        del cases["chain"]
    for key, (name, what, kern, plain, reps, preps, bnd) in cases.items():
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (what, kern, plain, reps, preps, bnd)}, res)
        out[key] = res[name]
        if results is not None and key != "setup":
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               res[name]["max_abs_err"])
            results[name].update({k: res[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "library_ms")})
    log(f"# k1 {json.dumps(out)}")
    return out


# The 2^20 MSM's lanes, G * n / K (c = 16, G = 2, K = 64): the width of the
# bucket scan and of the lane merge's adds
SCAN_LANES = 1 << 15
# Montgomery products of a G2 complete add: the function needs 14 F_q2
# products of 3 (Karatsuba, csrc/fq2.cuh), which the bounds count; K7's lane
# pair does 4 an F_q2 product (csrc/pair.cuh), its chosen extra work
G2_ADD_PRODUCTS = 42
PAIR_G2_ADD_PRODUCTS = 56
# The H100's L2 cache: a kernel timed against the memory rate reads inputs
# that are not in it (cold_calls)
L2_BYTES = 50 * 2**20


def fq2_rescale(F, pt, lam):
    """Projective rescaling (x, y, z) -> (lam x, lam y, lam z) over F_q2."""
    return tuple(F.mul(c, lam) for c in pt)


def phase_bitcheck_g2(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    rng = np.random.default_rng(SEED + 4)
    spec = bn254.q_spec()
    p = spec.p
    F, b3 = bn254.g2_ops(), bn254.g2_b3((), dev)
    g = bn254.g2_generator()
    hrng = random.Random(SEED + 4)
    host = [g * hrng.randrange(1, bn254.R) for _ in range(63)]
    host.append(bn254.curve_g2.infinity())
    base = bn254.g2_points_to_device(host, dev)
    m = SCAN_LANES
    ia = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    ib = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    kinds = torch.from_numpy(rng.integers(0, 8, m)).to(dev)
    ib = torch.where(kinds == 0, ia, ib)  # P + P
    ib = torch.where(kinds == 1, torch.full_like(ib, 63), ib)  # P + O
    ia = torch.where(kinds == 2, torch.full_like(ia, 63), ia)  # O + Q
    ia = torch.where(kinds == 3, torch.full_like(ia, 63), ia)  # O + O
    ib = torch.where(kinds == 3, torch.full_like(ib, 63), ib)

    def rescaled(idx):  # z != 1: a random F_q2 factor per lane
        lam = (random_fe(rng, m, dev), random_fe(rng, m, dev))
        lam[0][0] |= 1  # nonzero
        return fq2_rescale(F, tuple((c[0][:, idx], c[1][:, idx]) for c in base), lam)

    P, Q = rescaled(ia), rescaled(ib)
    negate = kinds == 4  # P + (-P)
    Q = tuple(F.select(negate, pc, qc) for pc, qc in zip((P[0], F.neg(P[1]), P[2]), Q))
    # the first m / 8 lanes: every coordinate component, c0 and c1 of x, y,
    # z of P and Q, drawn from 0, 1, q - 1 and R mod q (not points)
    edges = [0, 1, p - 1, (1 << 256) % p]
    E = m // 8
    P, Q = ([[c.clone() for c in coord] for coord in pt] for pt in (P, Q))
    for coord in (*P, *Q):
        for c in coord:
            c[:, :E] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
    P, Q = (tuple(tuple(coord) for coord in pt) for pt in (P, Q))
    h = torch.from_numpy(rng.integers(0, 2, m).astype(bool)).to(dev)
    L = lambda pt: list(wst.leaves(pt))
    err = check_equal("padd2", L(ck.padd2(spec, b3, P, Q)), L(ck.padd2_ref(spec, b3, P, Q)))
    err = max(err, check_equal("padd2(h)", L(ck.padd2(spec, b3, P, Q, h)),
                               L(ck.padd2_ref(spec, b3, P, Q, h))))
    sums = ck.padd2(spec, b3, P, Q)
    got = bn254.g2_points_to_host(wst.point_map(lambda c: c[:, E:E + 64], wst.Point(*sums)))
    ha, hb, kk = (t[E:E + 64].tolist() for t in (ia, ib, kinds))
    want = [host[x] + (-host[x] if k == 4 else host[y]) for x, y, k in zip(ha, hb, kk)]
    if got != want:
        raise AssertionError("padd2: disagrees with the host group law")
    # one tree level of the G2 fixed base: (W / 2) * chunk lanes
    tree_w = (-(-256 // 8) // 2) * fixed_base._CHUNK
    reps = tree_w // m
    wide = lambda pt: tuple(tuple(c.repeat(1, reps) for c in coord) for coord in pt)
    Pw, Qw = wide(P), wide(Q)
    err = max(err, check_equal(f"padd2 [{tree_w} lanes]", L(ck.padd2(spec, b3, Pw, Qw)),
                               L(ck.padd2_ref(spec, b3, Pw, Qw))))
    del Pw, Qw
    results["padd2"] = {"max_abs_err": err}
    log(f"# bitcheck padd2: {m} lanes (P+P, P+(-P), P+O, O+Q, O+O, z != 1; "
        f"{E} lanes of 0, 1, q-1, R mod q in every c0 and c1), with and without h, "
        f"and {tree_w} lanes (a fixed-base tree level): exact; 64 sums match the host")
    err = check_equal("pdbl2", L(ck.pdbl2(spec, b3, P)), L(ck.pdbl2_ref(spec, b3, P)))
    dbl = bn254.g2_points_to_host(
        wst.point_map(lambda c: c[:, E:E + 64], wst.Point(*ck.pdbl2(spec, b3, P))))
    if dbl != [host[x] + host[x] for x in ha]:
        raise AssertionError("pdbl2: disagrees with the host group law")
    results["pdbl2"] = {"max_abs_err": err}
    log(f"# bitcheck pdbl2: {m} lanes incl. O and the edge lanes: exact; "
        f"64 match the host")
    # K4's G2 instance at N = 3000 lanes (ragged), K = 4
    rows, _ = msm._rows_of_point(wst.point_map(lambda c: c[:, :4 * 3000], wst.Point(*P)))
    err = bitcheck_scan(spec, F, b3, rows, 4, rng, dev)
    results["bucket_scan_rows2"] = {"max_abs_err": err}
    log(f"# bitcheck bucket_scan_rows2: {SCAN_CASE}: acc and bucket table exact")


# The point-row moves K14 and K16 at the path's shapes: a fixed-base chunk
# (32 windows of the 2^8-entry table for 2^18 scalars: 8,388,608 int32
# indices into 8,192 rows), the lane merge's (G, B) = (2, 16,384) targets
# (int64, into the 2 x (2^15 + 2)-row bucket table of the 2^20 MSM, c = 16),
# the 2^20-point MSM table, and ragged sizes.
FB_ROWS, FB_INDICES = 32 << 8, 32 << 18
MERGE_TABLE, MERGE_POINTS = 2 * ((1 << 15) + 2), SCAN_LANES
ROW_TAILS = (1, 33, 4099)


def random_rows(spec, rng, nt: int, C: int, W: int, dev) -> torch.Tensor:
    """An (nt, W) int32 point table: random 16-bit limbs in the C used
    columns, zeros after, and 0, 1, q - 1, R mod q in every coordinate
    component of the first nt / 8 rows and of the last."""
    from myzkp_tpu_torch.fields import limb

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    t = torch.randint(0, 1 << 16, (nt, W), generator=gen, dtype=torch.int32, device=dev)
    t[:, C:] = 0
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    e = max(1, nt // 8)
    at = torch.cat([torch.arange(e - 1, device=dev), torch.tensor([nt - 1], device=dev)])
    for j in range(C // 16):
        vals = [edges[i] for i in rng.integers(0, 4, at.numel())]
        t[at, 16 * j:16 * j + 16] = limb.from_int(spec, vals, dev).T
    return t


def random_leaves(spec, C: int, n: int, rng, dev) -> list:
    """The C / 16 coordinate tensors of n points, (16, n) int32: the
    columns of a random table's used limbs."""
    t = random_rows(spec, rng, n, C, C, dev)
    return [t[:, 16 * j:16 * j + 16].T.contiguous() for j in range(C // 16)]


def fixed_base_indices(rng, dev) -> torch.Tensor:
    """A fixed-base chunk's gather indices, as fixed_base_multi makes them:
    window w's digit of each of the FB_INDICES / 32 scalars, offset by w *
    2^8, int32, window-major."""
    digits = rng.integers(0, 256, (32, FB_INDICES // 32)) + (np.arange(32) << 8)[:, None]
    return torch.from_numpy(digits.reshape(-1).astype(np.int32)).to(dev)


def repeating(rng, nt: int, n: int, dtype, dev) -> torch.Tensor:
    """n indices below nt at random, each of the first n / 16 repeated once
    more at random places."""
    idx = rng.integers(0, nt, n)
    k = max(1, n // 16)
    idx[rng.integers(0, n, k)] = idx[:k]
    return torch.from_numpy(idx).to(dtype).to(dev)


def phase_bitcheck_rows(dev, results: dict) -> None:
    """K14 (gather_planes) and K16 (scatter_rows) against their plain
    versions, exact, in both groups (C = 48, W = 64; C = 96, W = 128).  K14:
    at a fixed-base chunk's indices (int32, the digits of every window), at
    the lane merge's targets (int64, random, repeating) and with no indices
    over the whole bucket table, at ragged sizes with random repeating
    indices and with none; K16: the 2^20-point MSM table (no targets), the
    merge's scatter of 32,768 points at int64 targets of which 1 in 16
    repeat (the tables compared on the rows no two points target; the MSM
    drops its only repeated rows), and ragged sizes with unique targets and
    with none, every write over a table of other values, so the zero pad
    columns and the rows left alone are checked too.  Tables and points:
    random limbs with rows of 0, 1, q - 1, R mod q in every coordinate
    component.  Then each timed at the path's shapes beside its plain
    version, its bound and the PyTorch calls it replaced (library_ms): K14
    at the fixed-base chunk (index_select, then the transpose's copy) and
    at the merge's two gathers (the indexing and the transpose), with cold
    inputs; K16 at 2^20 points (cat, transpose, pad, copy) and at the
    merge's scatter (the same, then index_put_)."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    rng = np.random.default_rng(SEED + 14)
    spec = bn254.q_spec()
    errs = {"gather_planes": 0, "scatter_rows": 0}
    timed = {}
    for group, C, W in (("g1", 48, 64), ("g2", 96, 128)):
        # K14
        gathers = [("fixed-base chunk", FB_ROWS, fixed_base_indices(rng, dev)),
                   ("merge targets", MERGE_TABLE,
                    repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev)),
                   ("merge table", MERGE_TABLE, None)]
        for n in ROW_TAILS:
            gathers += [(f"ragged n = {n}", 1000, repeating(rng, 1000, n, torch.int32, dev)),
                        (f"ragged {n} rows", n, None)]
        for what, nt, idx in gathers:
            table = random_rows(spec, rng, nt, C, W, dev)
            errs["gather_planes"] = max(errs["gather_planes"], check_equal(
                f"gather_planes [{group}, {what}]", [ck.gather_planes(table, idx, C)],
                [ck.gather_planes_ref(table, idx, C)]))
        del table, gathers
        # K16
        scatters = [("2^20 points", 1 << LOG_N, 1 << LOG_N, None),
                    ("merge", MERGE_POINTS, MERGE_TABLE,
                     repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev))]
        for n in ROW_TAILS:
            scatters += [(f"ragged n = {n}", n, n + 50, torch.from_numpy(
                              rng.permutation(n + 50)[:n].astype(np.int32)).to(dev)),
                         (f"ragged {n} rows", n, n + 50, None)]
        for what, n, S, tgt in scatters:
            leaves = random_leaves(spec, C, n, rng, dev)
            base = random_rows(spec, rng, S, W, W, dev)  # other values, pad included
            out_k, out_p = base.clone(), base.clone()
            ck.scatter_rows(leaves, out_k, tgt)
            ck.scatter_rows_ref(leaves, out_p, tgt)
            keep = torch.ones(S, dtype=torch.bool, device=dev)
            if tgt is not None:
                hits = torch.bincount(tgt.long(), minlength=S)
                keep = hits <= 1
            errs["scatter_rows"] = max(errs["scatter_rows"], check_equal(
                f"scatter_rows [{group}, {what}]", [out_k[keep]], [out_p[keep]]))
        del leaves, base, out_k, out_p, scatters
        torch.cuda.synchronize()
        log(f"# bitcheck gather_planes, scatter_rows [{group}]: a fixed-base chunk "
            f"({FB_INDICES} int32 indices into {FB_ROWS} rows), the merge's {MERGE_POINTS} "
            f"int64 repeating targets and its {MERGE_TABLE}-row table, 2^{LOG_N} points, "
            f"ragged n = {ROW_TAILS} with random repeating indices / unique targets and "
            f"with none: exact (repeated targets' rows left out)")
        timed[group] = time_rows(spec, C, W, rng, dev)
    for k, e in errs.items():
        results[k] = {"max_abs_err": e}
    # the kernels line: G1 at the fixed-base chunk (K14) and 2^20 points (K16)
    for k in errs:
        results[k].update({f: timed["g1"][k][f] for f in
                           ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    results["_rows"] = timed


def time_rows(spec, C: int, W: int, rng, dev) -> dict:
    """K14 and K16 of one group timed at the path's shapes (phase_bitcheck_rows);
    returns {case: timings}."""
    from myzkp_tpu_torch.curves import curve_kernels as ck

    out = {}
    # the bytes a gather must move: the used limbs of each distinct row it
    # reads, once; its indices; the planes it writes
    gather_bytes = lambda ix, n: ((n if ix is None else int(ix.unique().numel())) * 4 * C
                                  + (0 if ix is None else ix.nbytes) + n * 4 * C)

    def case(key, shape, kern, plain, lib, nbytes, reps=5):
        name = key.split()[0]  # the kernel: gather_planes or scatter_rows
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (shape, kern, plain, reps, 1, bound(nbytes, 0), lib)}, res)
        out[key] = res[name]

    old_planes = lambda rows: rows[:, :C].T.contiguous()
    table = random_rows(spec, rng, FB_ROWS, C, W, dev)
    idx = fixed_base_indices(rng, dev)
    n = FB_INDICES
    case("gather_planes", f"fixed-base chunk: {n} int32 indices into {FB_ROWS} rows",
         lambda: ck.gather_planes(table, idx, C), lambda: ck.gather_planes_ref(table, idx, C),
         lambda: old_planes(table.index_select(0, idx)), gather_bytes(idx, n), reps=3)
    out["gather_planes"]["one_call_ms"] = graph_time_ms(
        lambda: table[:, :C].T.index_select(1, idx), 3)
    del table, idx
    # the merge's gathers, each call on its own copy of the bucket table:
    # enough copies that the bytes between two uses of one pass the L2
    base = random_rows(spec, rng, MERGE_TABLE, C, W, dev)
    copies = [base] + [base.clone() for _ in range(2 * L2_BYTES // base.nbytes + 1)]
    tgt = repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev)
    for key, ix, n in (("gather_planes merge targets", tgt, MERGE_POINTS),
                       ("gather_planes merge table", None, MERGE_TABLE)):
        kern, kept = cold_calls(lambda t, ix=ix: ck.gather_planes(t, ix, C), copies)
        lib, kept_l = cold_calls(lambda t, ix=ix: old_planes(t if ix is None else t[ix]),
                                 copies)
        case(key, f"{n} points from the {MERGE_TABLE}-row bucket table, "
                  f"{'int64 targets' if ix is not None else 'every row'}; inputs cold "
                  f"({len(copies)} copies)",
             kern, lambda ix=ix: ck.gather_planes_ref(copies[0], ix, C), lib,
             gather_bytes(ix, n), reps=50)
        kept.clear()
        kept_l.clear()
    leaves = random_leaves(spec, C, 1 << LOG_N, rng, dev)
    rows_k = torch.empty((1 << LOG_N, W), dtype=torch.int32, device=dev)
    rows_p = torch.empty_like(rows_k)
    old_rows = lambda ls: torch.nn.functional.pad(torch.cat(ls, dim=0).T,
                                                  (0, W - C)).contiguous()
    case("scatter_rows", f"2^{LOG_N} points into a new table",
         lambda: ck.scatter_rows(leaves, rows_k), lambda: ck.scatter_rows_ref(leaves, rows_p),
         lambda: old_rows(leaves), (1 << LOG_N) * (4 * C + 4 * W))
    del leaves, rows_k, rows_p
    leaves = random_leaves(spec, C, MERGE_POINTS, rng, dev)
    uniq = torch.from_numpy(rng.permutation(MERGE_TABLE)[:MERGE_POINTS]).to(dev)
    t_k, t_p, t_l = (base.clone() for _ in range(3))

    def index_put(ls):
        t_l[uniq] = old_rows(ls)
        return t_l
    case("scatter_rows merge", f"{MERGE_POINTS} points at int64 targets into the "
                               f"{MERGE_TABLE}-row bucket table",
         lambda: ck.scatter_rows(leaves, t_k, uniq),
         lambda: ck.scatter_rows_ref(leaves, t_p, uniq), lambda: index_put(leaves),
         MERGE_POINTS * (4 * C + 8 + 4 * W), reps=50)
    del copies, base
    return out


# Tail lengths for the add kernels: not multiples of a block (64 or 128
# threads), of a warp's 16 lane pairs, or of 2.
TAILS = (1, 17, 63, 65, 4097, SCAN_LANES - 5)
# A width of K2 above 2^17 points, where wider launches than the lane merge's
# run (the fixed-base setup's tree levels)
K2_WIDE = (1 << 17) + 5


def level_inputs(group: str, rows: int, B: int, rng, dev):
    """(F, b3, x) over a (rows, B) batch: random canonical coordinates, every
    component of 1 lane in 8 drawn from 0, 1, q - 1 and R mod q, and 1 lane
    in 16 infinity (0, 1, 0).  The formulas do not need points on the curve
    to be held bit for bit to their plain versions."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    n = rows * B
    E, I = -(-n // 8), -(-n // 16)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    at = torch.from_numpy(rng.choice(n, E, replace=False)).to(dev)
    inf_at = torch.from_numpy(rng.choice(n, I, replace=False)).to(dev)
    one = limb.one_mont(spec, (I,), dev)
    comps = []
    for k in range(6 if g2 else 3):
        c = random_fe(rng, n, dev)
        c[:, at] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
        c[:, inf_at] = one if k == (2 if g2 else 1) else torch.zeros_like(one)
        comps.append(c.reshape(16, rows, B))
    x = tuple(zip(comps[0::2], comps[1::2])) if g2 else tuple(comps)
    return F, b3, x


def level_heads(kind: str, rows: int, B: int, rng, dev) -> torch.Tensor:
    """Segment heads: every lane, lane 0 only, 3 lanes in 10 with lane 0
    clear (lanes below d then add infinity), or 97 in 100 with lane 0 set."""
    lane = np.arange(B)[None, :].repeat(rows, 0)
    h = {"all": np.ones((rows, B), bool), "lane0": lane == 0,
         "random": (rng.random((rows, B)) < 0.3) & (lane > 0),
         "dense": (rng.random((rows, B)) < 0.97) | (lane == 0)}[kind]
    return torch.from_numpy(h).to(dev)


def phase_bitcheck_levels(dev, results: dict) -> None:
    """K2 and K7 with the mask on 1 lane in 32 and at tail lengths; the
    lane-merge levels of both groups against their plain versions, every
    level of the scan at the lane merge's (2, 16384) shape under four head
    patterns, and at a ragged (3, 1000); then msm._seg_scan_hs on the card
    against the plain levels."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 11)
    spec = bn254.q_spec()
    L = lambda pt: list(wst.leaves(wst.Point(*pt)))
    errs = {k: 0 for k in ("padd", "padd2", "padd_seg_level", "padd2_seg_level")}
    for group, add, ref in (("g1", ck.padd, ck.padd_ref), ("g2", ck.padd2, ck.padd2_ref)):
        name = "padd2" if group == "g2" else "padd"
        for n in (SCAN_LANES,) + (K2_WIDE,) * (group == "g1") + TAILS:
            F, b3, P = level_inputs(group, 1, n, rng, dev)
            _, _, Q = level_inputs(group, 1, n, rng, dev)
            flat = lambda pt: tuple(wst.point_map(lambda c: c.reshape(16, n),
                                                  wst.Point(*pt)))
            P, Q = flat(P), flat(Q)
            lane = torch.arange(n, device=dev)
            same, opp = lane % 7 == 3, lane % 7 == 4  # Q = P, Q = -P
            Q = (F.select(same | opp, P[0], Q[0]),
                 F.select(opp, F.neg(P[1]), F.select(same, P[1], Q[1])),
                 F.select(same | opp, P[2], Q[2]))
            h = lane % 32 == 5
            for hh in (None, h):
                errs[name] = max(errs[name], check_equal(
                    f"{name} [{n} lanes, h {'1 in 32' if hh is not None else 'none'}]",
                    L(add(spec, b3, P, Q, hh)), L(ref(spec, b3, P, Q, hh))))
    log(f"# bitcheck padd, padd2: {SCAN_LANES} lanes, padd at {K2_WIDE} too, and tails "
        f"{TAILS}, with h on 1 lane in 32 and without; 1 lane in 8 of 0, 1, q - 1, "
        f"R mod q in every component, 1 in 16 infinity on either side, Q = P on 1 "
        f"lane in 7 and Q = -P on another: exact")

    for group in ("g1", "g2"):
        name = "padd2_seg_level" if group == "g2" else "padd_seg_level"
        level = ck.padd2_seg_level if group == "g2" else ck.padd_seg_level
        ref = ck.padd2_seg_level_ref if group == "g2" else ck.padd_seg_level_ref
        for rows, B in ((2, SCAN_LANES // 2), (3, 1000)):
            F, b3, x0 = level_inputs(group, rows, B, rng, dev)
            for kind in ("all", "lane0", "random", "dense"):
                x, flags = x0, level_heads(kind, rows, B, rng, dev)
                d = 1
                while d < B:
                    got, gf = level(spec, b3, x, flags, d)
                    want, wf = ref(spec, b3, x, flags, d)
                    errs[name] = max(errs[name], check_equal(
                        f"{name} [({rows}, {B}), heads {kind}, d = {d}]",
                        L(got) + [gf], L(want) + [wf]))
                    x, flags, d = got, gf, 2 * d
        # the whole scan through msm._seg_scan_hs: one launch a level
        F, b3, x = level_inputs(group, 2, SCAN_LANES // 2, rng, dev)
        heads = level_heads("random", 2, SCAN_LANES // 2, rng, dev)
        got, counts = counted(lambda: msm._seg_scan_hs(F, b3, wst.Point(*x), heads))
        xr, fr, d = x, heads, 1
        while d < SCAN_LANES // 2:
            xr, fr = ref(spec, b3, xr, fr, d)
            d *= 2
        errs[name] = max(errs[name], check_equal(f"{name} [_seg_scan_hs]",
                                                 L(got), L(xr)))
        levels = (SCAN_LANES // 2 - 1).bit_length()
        if counts != {name: levels}:
            raise AssertionError(f"_seg_scan_hs ({group}): launches {counts}, expected "
                                 f"{levels} of {name} and nothing else")
        log(f"# bitcheck {name}: every level d = 1 .. {SCAN_LANES // 4} at (2, "
            f"{SCAN_LANES // 2}) and d = 1 .. 512 at (3, 1000), heads all / lane 0 only "
            f"/ 3 in 10 with lane 0 clear / 97 in 100; 1 lane in 8 of edge values, 1 in "
            f"16 infinity: out and flags exact; _seg_scan_hs at (2, {SCAN_LANES // 2}): "
            f"exact, {levels} launches of {name} and nothing else")
    for k, e in errs.items():
        results[k]["max_abs_err"] = max(results[k].get("max_abs_err", 0), e)


# The chains of doublings (K3, K8): the widths of their bitchecks (one point:
# Horner and the ladders' bases; a window batch: the window sums' top
# buckets; a wide batch with a tail) and their step counts (one double, a
# Horner window of c = 16, a ladder's 255 bases)
CHAIN_WIDTHS = {"g1": (1, 16, (1 << 16) + 3), "g2": (1, 16, SCAN_LANES + 5)}
CHAIN_STEPS = (1, 16, 255)


def chain_inputs(group: str, n: int, rng, dev):
    """(F, b3, P, host) over n lanes for K3 (G1) or K8 (G2), by lane % 16:
    10 infinity (0, lam y, 0), 11 y = 0 (where P = -P; not a point), 12 and
    13 every coordinate component 0, 1, q - 1 or R mod q; every other lane a
    projective rescaling by a random lam of one of 64 host points, which
    host(lanes) returns."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    gen = bn254.g2_generator() if g2 else bn254.g1_generator()
    to_device = bn254.g2_points_to_device if g2 else bn254.g1_points_to_device
    hrng = random.Random(SEED + 12 + g2)
    host = [gen * hrng.randrange(1, bn254.R) for _ in range(64)]
    idx = rng.integers(0, 64, n)
    lam = ((random_fe(rng, n, dev), random_fe(rng, n, dev)) if g2
           else random_fe(rng, n, dev))
    (lam[0] if g2 else lam)[0] |= 1  # nonzero
    P = wst.Point(*(F.mul(c, lam) for c in wst.point_map(
        lambda c: c[:, torch.from_numpy(idx).to(dev)], to_device(host, dev))))
    kind = torch.arange(n, device=dev) % 16
    edge = (kind == 12) | (kind == 13)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    comps = 2 if g2 else 1
    leaves = [c.clone() for c in wst.leaves(P)]
    for j, c in enumerate(leaves):
        c[:, kind == (11 if j // comps == 1 else 10)] = 0
        k = int(edge.sum())
        if k:
            c[:, edge] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, k)], dev)
    return F, b3, wst.from_leaves(leaves), lambda lanes: [host[idx[i]] for i in lanes]


def phase_bitcheck_chains(dev, results: dict) -> None:
    """K3 and K8 chains against their plain versions and the host group law:
    at each width of CHAIN_WIDTHS, the plain version's 255 steps once, then
    the kernel at n = 1, 16 and 255, with and without the steps output, each
    exact against the plain version's step n (or steps 1 .. n); on up to 16
    point lanes of each width, 2^n P equal to the host's."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 12)
    spec = bn254.q_spec()
    nmax = max(CHAIN_STEPS)
    for group in ("g1", "g2"):
        g2 = group == "g2"
        name = "pdbl2" if g2 else "pdbl"
        wrap, ref = (ck.pdbl2, ck.pdbl2_ref) if g2 else (ck.pdbl, ck.pdbl_ref)
        to_host = bn254.g2_points_to_host if g2 else bn254.g1_points_to_host
        err = results[name]["max_abs_err"]
        for width in CHAIN_WIDTHS[group]:
            F, b3, P, host = chain_inputs(group, width, rng, dev)
            want = wst.leaves(wst.Point(*ref(spec, b3, P, nmax, steps=True)))
            pts = [i for i in range(width) if i % 16 not in (10, 11, 12, 13)][:16]
            lanes = torch.tensor(pts, device=dev)
            for n in CHAIN_STEPS:
                got = wst.leaves(wst.Point(*wrap(spec, b3, P, n)))
                err = max(err, check_equal(f"{name} [{width} points, n = {n}]", got,
                                           [w[n - 1] for w in want]))
                got = wst.leaves(wst.Point(*wrap(spec, b3, P, n, steps=True)))
                err = max(err, check_equal(f"{name} [{width} points, n = {n}, steps]",
                                           got, [w[:n] for w in want]))
                k = 1 << n
                last = wst.point_map(lambda c: c[n - 1][:, lanes], wst.from_leaves(got))
                if to_host(last) != [p * (k % bn254.R) for p in host(pts)]:
                    raise AssertionError(f"{name} [{width} points, n = {n}]: 2^n P "
                                         f"disagrees with the host group law")
            del want, got
        results[name]["max_abs_err"] = err
        log(f"# bitcheck {name} chains: widths {CHAIN_WIDTHS[group]}, n = {CHAIN_STEPS}, "
            f"with and without the steps output, exact against the plain version's "
            f"{nmax} steps; by lane % 16 infinity, y = 0 (P = -P), two lanes of 0, 1, "
            f"q - 1, R mod q in every component; 2^n P == host on up to 16 point "
            f"lanes a width")


def chain_call(fn, spec, b3, p, n: int, steps: bool = False):
    """n doublings of p by fn, K3's or K8's wrapper or plain version: one call
    where fn takes n; else (a tree from before the chain kernels, whose
    kernels smoke_graph_timed.py times through this) n calls, every step
    kept when steps is set."""
    import inspect

    if "n" in inspect.signature(fn).parameters:
        return fn(spec, b3, p, n, steps=steps)
    out = []
    for _ in range(n):
        p = fn(spec, b3, p)
        out.append(p)
    return out if steps else p


def flat(x) -> list:
    """The tensors of nested tuples and lists, in order."""
    return [x] if torch.is_tensor(x) else [t for e in x for t in flat(e)]


# (group, points, n, steps, reps, what): the chains timed, at the prover's
# shapes and at the shape each kernel was timed at before the chains
CHAIN_SHAPES = (
    ("g1", 16, 1, False, 100, "16 points, n = 1: the window sums' top buckets, one double"),
    ("g1", 1, 16, False, 20, "1 point, n = 16: a Horner window"),
    ("g1", 1, 255, True, 4, "1 point, n = 255, every step: a ladder's bases"),
    ("g2", SCAN_LANES, 1, False, 20, f"{SCAN_LANES} lanes, n = 1"),
    ("g2", 1, 16, False, 20, "1 point, n = 16: a Horner window"),
    ("g2", 1, 255, True, 4, "1 point, n = 255, every step: a ladder's bases"),
)


def time_chains(dev, results: dict | None) -> dict:
    """K3 and K8 at CHAIN_SHAPES against their plain versions (exact), each
    timed by time_cases, with the bound of its inputs: 9 (G1) or 25 (G2)
    Montgomery products a double a point against reading P and writing 2^n P
    (or every step).  The Horner window's times go to results (the kernels
    line); every shape's to the returned dict, printed as '# chains'."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    rng = np.random.default_rng(SEED + 13)
    spec = bn254.q_spec()
    out = {}
    for group, pts, n, steps, reps, what in CHAIN_SHAPES:
        g2 = group == "g2"
        name = "pdbl2" if g2 else "pdbl"
        wrap, ref = (ck.pdbl2, ck.pdbl2_ref) if g2 else (ck.pdbl, ck.pdbl_ref)
        b3 = bn254.g2_b3((), dev) if g2 else bn254.g1_b3((), dev)
        fe = lambda: random_fe(rng, pts, dev)
        P = tuple((fe(), fe()) for _ in range(3)) if g2 else tuple(fe() for _ in range(3))
        comps = 2 if g2 else 1
        nbytes = comps * LIMB_BYTES * (3 + 3 * (n if steps else 1)) * pts + comps * LIMB_BYTES
        bnd = bound(nbytes, (25 if g2 else 9) * n * pts)
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (what, lambda: flat(chain_call(wrap, spec, b3, P, n, steps)),
                           lambda: flat(chain_call(ref, spec, b3, P, n, steps)), reps, 1,
                           bnd)}, res)
        r = dict(res[name], points=pts, n=n, steps=steps, per_double_ms=res[name]["ms"] / n)
        out[f"{name} {pts} x {n}{' steps' if steps else ''}"] = r
        log(f"# chain {name} [{what}]: {r['per_double_ms']:.5f} ms a double")
        if results is not None:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], r["max_abs_err"])
            if (pts, n) == (1, 16):
                results[name].update({k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")})
    log(f"# chains {json.dumps(out)}")
    return out


def phase_g2_msm(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    n = 1 << LOG_N
    rng = random.Random(SEED + 5)
    ms = [rng.randrange(1, bn254.R) for _ in range(n)]
    ks = [rng.randrange(0, bn254.R) for _ in range(n)]
    ks[0], ks[1], ks[2], ks[3] = 0, 5, 5, bn254.R - 1  # zero and duplicates
    rspec = bn254.r_spec()
    m_limbs = msm.scalars_from_int(rspec, ms, dev)
    k_limbs = msm.scalars_from_int(rspec, ks, dev)
    F, b3 = bn254.g2_ops(), bn254.g2_b3((), dev)
    exp = bn254.g2_generator() * (sum(k * m for k, m in zip(ks, ms)) % bn254.R)
    table = ("loaded from its .npz cache" if fixed_base.table_path("g2").exists()
             else "built on the host first")
    t0 = time.perf_counter()
    pts, fb_counts = counted(lambda: fixed_base.fixed_base_multi("g2", m_limbs))
    fb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, counts = counted(lambda: msm.msm(F, b3, pts, k_limbs))
    first_s = time.perf_counter() - t0
    got = bn254.g2_points_to_host(wst.point_map(lambda c: c[:, None], res))[0]
    if got != exp:
        raise AssertionError("G2 MSM 2^20: result differs from the host golden")
    need = ("padd2", "pdbl2", "bucket_scan_rows2", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"G2 MSM: a kernel of {need} never launched: {counts}")
    med, ts = median_ms(lambda: msm.msm(F, b3, pts, k_limbs))
    results["_g2_msm"] = {"ms": med, "reps_ms": ts, "points_per_s": n / med * 1e3,
                          "first_s": first_s, "fixed_base_s": fb_s,
                          "launches": counts, "fixed_base_launches": fb_counts}
    log(f"# g2 fixed-base 2^{LOG_N}: {fb_s:.3f} s (table {table}); launches "
        f"{json.dumps(fb_counts)}")
    log(f"# g2 msm 2^{LOG_N} (c = {msm.default_window(n)}): == host "
        f"[sum k_i m_i mod r]G2; first run {first_s:.3f} s; launches "
        f"{json.dumps(counts)}; median {med:.2f} ms of {[round(t, 2) for t in ts]}")
    time_scan(F, b3, pts, dev, results)


K1_PROVE_LAUNCHES = 100  # K1 + its chain in a prove at 2^20 (818 / 828 before)


def fresh_tables(fn):
    """fn() with the fixed-base row tables made anew, as a setup in a fresh
    process makes them (K16; the host tables stay loaded)."""
    from myzkp_tpu_torch.curves import fixed_base

    fixed_base._table_rows.cache_clear()
    return fn()


def check_setup_launches(name: str, counts: dict) -> None:
    need = ("gather_planes", "scatter_rows", "padd", "padd2")
    if min(counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"{name} setup: a kernel of {need} never launched: {counts}")


def check_k1_launches(name: str, counts: dict) -> None:
    k1, chain = counts.get("mont_mul", 0), counts.get("mont_pow", 0)
    log(f"# {name} prove: K1 {k1} launches, its chain mont_pow {chain}: {k1 + chain} in all")
    if chain < 1 or k1 + chain > K1_PROVE_LAUNCHES:
        raise AssertionError(f"{name} prove: K1 {k1} + mont_pow {chain} launches, expected "
                             f"the chain at least once and at most {K1_PROVE_LAUNCHES} in all")


def _square_chain_case(spec, m: int, dev):
    from myzkp_tpu_torch.arith import sparse

    r1cs, asg = sparse.square_chain(spec, m, device=dev)
    return sparse.SparseQAP(r1cs), asg


def _wrong_witness(asg, k: int):
    """The assignment with x_k changed: it no longer satisfies the circuit."""
    from myzkp_tpu_torch.fields.fp import Fp

    mont = asg.mont.clone()
    mont[:, k + 1] = Fp.from_int(asg.spec, 12345, asg.device).mont
    return Fp(asg.spec, mont)


def phase_pinocchio(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.snark import pinocchio as pin

    spec = bn254.r_spec()
    m = 1 << LOG_M_PIN
    t0 = time.perf_counter()
    qap, asg = _square_chain_case(spec, m, dev)
    bad_asg = _wrong_witness(asg, m // 2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pk, vk), setup_counts = counted(lambda: fresh_tables(
        lambda: pin.setup(qap, random.Random(SEED))))
    setup_s = time.perf_counter() - t0
    check_setup_launches("pinocchio", setup_counts)
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: pin.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(prove_counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"prove 2^{LOG_M_PIN}: a kernel of {need} never launched: "
                             f"{prove_counts}")
    t0 = time.perf_counter()
    ok = pin.verify(proof, vk)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"Pinocchio 2^{LOG_M_PIN}: verify rejected the proof")
    bad = pin.prove(bad_asg, pk, qap, random.Random(SEED + 1))
    if pin.verify(bad, vk):
        raise AssertionError(f"Pinocchio 2^{LOG_M_PIN}: verify accepted a wrong witness")
    med, ts = median_ms(lambda: pin.prove(asg, pk, qap, random.Random(SEED + 1)), reps=3)
    results["_pinocchio"] = {"setup_s": setup_s, "prove_ms": med, "prove_reps_ms": ts,
                             "prove_first_s": first_s, "verify_s": verify_s,
                             "circuit_s": build_s, "setup_launches": setup_counts,
                             "prove_launches": prove_counts}
    for k in ("padd2", "pdbl2", "bucket_scan_rows2", "padd2_seg_level"):
        results[k]["launches"] = prove_counts[k]
    log(f"# pinocchio m = 2^{LOG_M_PIN}: circuit {build_s:.3f} s; setup {setup_s:.3f} s; "
        f"prove first {first_s:.3f} s, median {med:.2f} ms of {[round(t, 2) for t in ts]}; "
        f"verify {verify_s:.3f} s (host): accepted; a wrong witness (one x_k "
        f"changed): rejected")
    log(f"# pinocchio setup launches: {json.dumps(setup_counts)}")
    log(f"# pinocchio prove launches: {json.dumps(prove_counts)}")
    log(f"# pinocchio prove: K3 {prove_counts['pdbl']} launches, K8 "
        f"{prove_counts['pdbl2']}")
    check_k1_launches("pinocchio", prove_counts)

    # the whole path on the card against the plain versions on the CPU
    cpu = torch.device("cpu")
    ms = 1 << LOG_M_CMP
    proofs = []
    for d in (dev, cpu):
        t0 = time.perf_counter()
        q, a = _square_chain_case(spec, ms, d)
        pk_, vk_ = pin.setup(q, random.Random(SEED + 2))
        pr = pin.prove(a, pk_, q, random.Random(SEED + 3))
        if not pin.verify(pr, vk_):
            raise AssertionError(f"Pinocchio 2^{LOG_M_CMP} on {d}: verify rejected")
        proofs.append((pr, vk_, time.perf_counter() - t0))
    (card, card_vk, card_s), (plain, plain_vk, plain_s) = proofs
    if card != plain or card_vk != plain_vk:
        raise AssertionError(f"Pinocchio 2^{LOG_M_CMP}: the card's key or proof differs "
                             f"from the CPU plain versions'")
    log(f"# pinocchio m = 2^{LOG_M_CMP}: setup + prove on the card ({card_s:.2f} s) "
        f"and on the CPU plain versions ({plain_s:.2f} s), same seeds: verification "
        f"keys and proofs equal point for point; both accepted")


def time_g2_kernels(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 6)
    spec = bn254.q_spec()
    b3 = bn254.g2_b3((), dev)
    m = SCAN_LANES
    coords = lambda: tuple((random_fe(rng, m, dev), random_fe(rng, m, dev))
                           for _ in range(3))
    P, Q = coords(), coords()
    # a segment head every 32 steps: heads are a few percent of the digits
    h = torch.arange(m, device=dev) % 32 == 0
    heads = int(h.sum())
    L = wst.leaves
    cases = {
        # an add reads 12 coordinates and writes 6 and needs 42 Montgomery
        # products, none on the lanes where h is set
        "padd2": (f"{m} lanes with h set on 1 in 32: one step of probe 13's loop",
                  lambda: L(ck.padd2(spec, b3, P, Q, h)),
                  lambda: L(ck.padd2_ref(spec, b3, P, Q, h)), 20, 1,
                  bound(18 * LIMB_BYTES * m + m + 2 * LIMB_BYTES, G2_ADD_PRODUCTS * (m - heads))),
    }
    time_cases(cases, results)
    design = bound(0, PAIR_G2_ADD_PRODUCTS * (m - heads))["bound_ms"]
    log(f"# padd2: the lane pair does {PAIR_G2_ADD_PRODUCTS} Montgomery products an add "
        f"where the function needs {G2_ADD_PRODUCTS}; at the integer multiply rate its "
        f"own products take {design:.4f} ms (bound {results['padd2']['bound_ms']:.4f})")
    # K2 at the same shape: 32,768 lanes is also the width of the first tree
    # level of the weighted bucket sum (G * 256 * 64)
    P1 = tuple(random_fe(rng, m, dev) for _ in range(3))
    Q1 = tuple(random_fe(rng, m, dev) for _ in range(3))
    b31 = bn254.g1_b3((), dev)
    lanes = {"padd": {"max_abs_err": 0}}
    time_cases({"padd": (f"{m} lanes with h set on 1 in 32",
                         lambda: ck.padd(spec, b31, P1, Q1, h),
                         lambda: ck.padd_ref(spec, b31, P1, Q1, h), 50, 1,
                         bound(9 * LIMB_BYTES * m + m + LIMB_BYTES, 14 * (m - heads)))},
               lanes)
    results["_padd_lanes"] = lanes["padd"]
    results["padd"]["max_abs_err"] = max(results["padd"]["max_abs_err"],
                                         lanes["padd"]["max_abs_err"])


def mixed_add_inputs(group: str, m: int, dev, seed: int):
    """P (projective) and Q = (qx, qy) (affine) over m lanes, for K9 (G1) or
    K10 (G2).  Q is one of 64 host points (never O: the affine form cannot
    express it); P a rescaling by a random lam of one of them or of O.  Lane
    kinds: P = O, P = Q (a doubling through the mixed formula, lam != 1), P =
    -Q (the sum is O), generic; the first m / 8 lanes hold 0, 1, q - 1 or
    R mod q in every coordinate component (not points).  Returns (F, b3, P,
    qx, qy, E, want) with want(lane) the host sum of a lane at or after E."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    rng = np.random.default_rng(seed)
    hrng = random.Random(seed)
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    gen = bn254.g2_generator() if g2 else bn254.g1_generator()
    curve = bn254.curve_g2 if g2 else bn254.curve_g1
    to_device = bn254.g2_points_to_device if g2 else bn254.g1_points_to_device
    host = [gen * hrng.randrange(1, bn254.R) for _ in range(64)]
    base = to_device(host + [curve.infinity()], dev)  # z = one: affine
    ia, ib, kinds = (rng.integers(0, n, m) for n in (64, 64, 8))
    ia = np.where((kinds == 0) | (kinds == 2), ib, ia)  # P = Q, P = -Q
    ia = np.where(kinds == 1, 64, ia)  # P = O
    ta, tb = (torch.from_numpy(i).to(dev) for i in (ia, ib))
    lam = ((random_fe(rng, m, dev), random_fe(rng, m, dev)) if g2
           else random_fe(rng, m, dev))
    (lam[0] if g2 else lam)[0] |= 1  # nonzero
    P = [F.mul(c, lam) for c in wst.point_map(lambda c: c[:, ta], base)]
    P[1] = F.select(torch.from_numpy(kinds == 2).to(dev), F.neg(P[1]), P[1])
    qx, qy = (wst.point_map(lambda c: c[:, tb], base)[k] for k in (0, 1))
    E = m // 8
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    coords = [[t.clone() for t in (e if g2 else (e,))] for e in (*P, qx, qy)]
    for comps in coords:
        for t in comps:
            t[:, :E] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
    elems = [tuple(c) if g2 else c[0] for c in coords]

    def want(k):
        pk = curve.infinity() if ia[k] == 64 else host[ia[k]]
        return (-pk if kinds[k] == 2 else pk) + host[ib[k]]

    return F, b3, wst.Point(*elems[:3]), elems[3], elems[4], E, want


def phase_mixed_add(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    spec = bn254.q_spec()
    m = SCAN_LANES
    inputs = {g: mixed_add_inputs(g, m, dev, SEED + 7 + k) for k, g in enumerate(("g1", "g2"))}
    # a segment head every 32 steps, as in a bucket scan
    h = torch.arange(m, device=dev) % 32 == 0
    F1, b31, P1, qx1, qy1, E1, want1 = inputs["g1"]
    reps = MIX_WIDE // m
    wide = lambda e: e.repeat(1, reps)
    Pw = wst.point_map(wide, P1)
    qxw, qyw = wide(qx1), wide(qy1)
    F2, b32, P2, qx2, qy2, E2, want2 = inputs["g2"]

    def main_path():
        return {"g1_sel": wst.padd_mixed_sel(F1, b31, P1, qx1, qy1, h),
                "g1": wst.padd_mixed(F1, b31, P1, qx1, qy1),
                "g1_wide": wst.padd_mixed(F1, b31, Pw, qxw, qyw),
                "g2_sel": wst.padd_mixed_sel(F2, b32, P2, qx2, qy2, h),
                "g2": wst.padd_mixed(F2, b32, P2, qx2, qy2)}

    out, counts = counted(main_path)
    if min(counts.get(k, 0) for k in ("padd_mixed", "padd_mixed2")) < 1:
        raise AssertionError(f"mixed add: K9 or K10 never launched: {counts}")
    L = wst.leaves
    plain = {"g1_sel": ck.padd_mixed_ref(spec, b31, P1, qx1, qy1, h),
             "g1": ck.padd_mixed_ref(spec, b31, P1, qx1, qy1),
             "g1_wide": ck.padd_mixed_ref(spec, b31, Pw, qxw, qyw),
             "g2_sel": ck.padd_mixed2_ref(spec, b32, P2, qx2, qy2, h),
             "g2": ck.padd_mixed2_ref(spec, b32, P2, qx2, qy2)}
    err = {"padd_mixed": 0, "padd_mixed2": 0}
    for k, got in out.items():
        name = "padd_mixed2" if k.startswith("g2") else "padd_mixed"
        err[name] = max(err[name], check_equal(f"{name} [{k}]", L(got), L(wst.Point(*plain[k]))))
    del Pw, qxw, qyw, plain
    # the complete add of P and (qx, qy, one), with and without the mask
    for k, F, b3, P, qx, qy in (("g1", F1, b31, P1, qx1, qy1), ("g2", F2, b32, P2, qx2, qy2)):
        Q = wst.from_affine(F, qx, qy)
        full = wst.padd(F, b3, P, Q), wst.padd_sel(F, b3, P, Q, h)
        for got, w in zip((out[k], out[f"{k}_sel"]), full):
            if not all(torch.equal(a, b) for a, b in zip(L(got), L(w))):
                raise AssertionError(f"mixed add {k}: differs from the complete add of "
                                     f"(qx, qy, one)")
    # the host group law on 64 lanes past the edge lanes; P = -Q gives O
    for k, to_host, E, want in (("g1", bn254.g1_points_to_host, E1, want1),
                                ("g2", bn254.g2_points_to_host, E2, want2)):
        got = to_host(wst.point_map(lambda c: c[:, E:E + 64], out[k]))
        if got != [want(j) for j in range(E, E + 64)]:
            raise AssertionError(f"mixed add {k}: disagrees with the host group law")
    for k in ("padd_mixed", "padd_mixed2"):
        results[k] = {"max_abs_err": err[k], "launches": counts[k]}
    log(f"# mixed add: K9 at {m} lanes (with and without h) and {MIX_WIDE} points, "
        f"K10 at {m} lanes (with and without h), through weierstrass.padd_mixed(_sel); "
        f"P = O, P = lam Q, P = -Q, and {E1} / {E2} lanes of 0, 1, q-1, R mod q in every "
        f"c0 and c1: exact vs plain and vs the complete add K2 / K7 of (qx, qy, one); "
        f"64 lanes per group match the host; launches {json.dumps(counts)}")

    # timing: K9 at K2's shape, K10 at K7's, and K9 with the mask at probe
    # 12's width (tools/scratch_prof4.py:84); a mixed add reads 5 coordinates
    # and writes 3 (G2: 10 and 6); 13 products (G2: 39), none where h is set
    rng = np.random.default_rng(SEED + 9)
    fe = lambda n: random_fe(rng, n, dev)
    Pt = tuple(fe(MIX_WIDE) for _ in range(3))
    qxt, qyt = fe(MIX_WIDE), fe(MIX_WIDE)
    P2t = tuple((fe(m), fe(m)) for _ in range(3))
    q2t = tuple((fe(m), fe(m)) for _ in range(2))
    heads = int(h.sum())
    probe = {"padd_mixed": {"max_abs_err": 0}}
    time_cases({"padd_mixed": (
        f"{m} lanes with h set on 1 in 32: probe 12's width",
        lambda: ck.padd_mixed(spec, b31, P1, qx1, qy1, h),
        lambda: ck.padd_mixed_ref(spec, b31, P1, qx1, qy1, h), 100, 3,
        bound(8 * LIMB_BYTES * m + m + LIMB_BYTES, 13 * (m - heads)))}, probe)
    time_cases({
        "padd_mixed": (f"{MIX_WIDE} points: a fixed-base tree level's width",
                       lambda: ck.padd_mixed(spec, b31, Pt, qxt, qyt),
                       lambda: ck.padd_mixed_ref(spec, b31, Pt, qxt, qyt), 5, 1,
                       bound(8 * LIMB_BYTES * MIX_WIDE + LIMB_BYTES, 13 * MIX_WIDE)),
        "padd_mixed2": (f"{m} lanes with h set on 1 in 32",
                        lambda: L(wst.Point(*ck.padd_mixed2(spec, b32, P2t, *q2t, h))),
                        lambda: L(wst.Point(*ck.padd_mixed2_ref(spec, b32, P2t, *q2t, h))),
                        20, 1,
                        bound(16 * LIMB_BYTES * m + m + 2 * LIMB_BYTES, 39 * (m - heads))),
    }, results)
    # K2 on the same inputs as K9's timed call, with (qx, qy, one) for Q
    Qt = (qxt, qyt, F1.one((MIX_WIDE,), dev).contiguous())
    k2_ms = graph_time_ms(lambda: ck.padd(spec, b31, Pt, Qt), 5)
    log(f"# time padd [{MIX_WIDE} points, the same P and Q = (qx, qy, one) as "
        f"padd_mixed's]: kernel {k2_ms:.4f} ms")
    results["_mixed_add"] = {"probe12": probe["padd_mixed"], "launches": counts,
                             "padd_same_inputs_ms": k2_ms}


def _key_points(pk, vk) -> dict:
    """A Groth16 key on the host: every point batch (the proving key's and
    g1_k_pub) as a list of affine points, every other field as it is."""
    from myzkp_tpu_torch.curves import bn254

    out = {}
    for name, key in (("pk", pk), ("vk", vk)):
        for f, v in vars(key).items():
            if isinstance(v, tuple):  # a device point batch
                v = (bn254.g2_points_to_host if f.startswith("g2")
                     else bn254.g1_points_to_host)(v)
            out[f"{name}.{f}"] = v
    return out


def phase_groth16(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.snark import groth16 as g16

    spec = bn254.r_spec()
    m, npub = 1 << LOG_M_G16, NPUB_G16
    t0 = time.perf_counter()
    qap, asg = _square_chain_case(spec, m, dev)
    bad_asg = _wrong_witness(asg, m // 2)
    public = [int(v) for v in asg[:npub].to_int()]
    wrong_public = public[:-1] + [(public[-1] + 1) % bn254.R]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pk, vk), setup_counts = counted(lambda: fresh_tables(
        lambda: g16.setup(qap, npub, random.Random(SEED))))
    setup_s = time.perf_counter() - t0
    check_setup_launches("groth16", setup_counts)
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: g16.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(prove_counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"groth16 prove 2^{LOG_M_G16}: a kernel of {need} never "
                             f"launched: {prove_counts}")
    t0 = time.perf_counter()
    ok = g16.verify(proof, vk, public)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify rejected the proof")
    if g16.verify(proof, vk, wrong_public):
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify accepted a wrong public input")
    bad = g16.prove(bad_asg, pk, qap, random.Random(SEED + 1))
    if g16.verify(bad, vk, public):
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify accepted a wrong witness")
    med, ts = median_ms(lambda: g16.prove(asg, pk, qap, random.Random(SEED + 1)), reps=3)
    results["_groth16"] = {"setup_s": setup_s, "prove_ms": med, "prove_reps_ms": ts,
                           "prove_first_s": first_s, "verify_s": verify_s,
                           "circuit_s": build_s, "setup_launches": setup_counts,
                           "prove_launches": prove_counts}
    for k in ("gather_planes", "scatter_rows"):
        results[k]["launches"] = prove_counts[k]
    log(f"# groth16 m = 2^{LOG_M_G16}, {npub} public inputs: circuit {build_s:.3f} s; "
        f"setup {setup_s:.3f} s; prove first {first_s:.3f} s, median {med:.2f} ms of "
        f"{[round(t, 2) for t in ts]}; verify {verify_s:.3f} s (host pairing): accepted; "
        f"a wrong public input: rejected; a wrong witness (one x_k changed): rejected")
    log(f"# groth16 setup launches: {json.dumps(setup_counts)}")
    log(f"# groth16 prove launches: {json.dumps(prove_counts)}")
    log(f"# groth16 prove: K3 {prove_counts['pdbl']} launches, K8 "
        f"{prove_counts['pdbl2']}")
    check_k1_launches("groth16", prove_counts)
    del pk, vk, qap, asg, bad_asg

    # the whole path on the card against the plain versions on the CPU
    cpu = torch.device("cpu")
    ms = 1 << LOG_M_CMP
    runs = []
    for d in (dev, cpu):
        t0 = time.perf_counter()
        q, a = _square_chain_case(spec, ms, d)
        pk_, vk_ = g16.setup(q, npub, random.Random(SEED + 2))
        pr = g16.prove(a, pk_, q, random.Random(SEED + 3))
        pub = [int(v) for v in a[:npub].to_int()]
        if not g16.verify(pr, vk_, pub):
            raise AssertionError(f"Groth16 2^{LOG_M_CMP} on {d}: verify rejected")
        runs.append((pr, _key_points(pk_, vk_), time.perf_counter() - t0))
    (card, card_keys, card_s), (plain, plain_keys, plain_s) = runs
    if card != plain or card_keys != plain_keys:
        raise AssertionError(f"Groth16 2^{LOG_M_CMP}: the card's keys or proof differ "
                             f"from the CPU plain versions'")
    log(f"# groth16 m = 2^{LOG_M_CMP}: setup + prove on the card ({card_s:.2f} s) and "
        f"on the CPU plain versions ({plain_s:.2f} s), same seeds: proving and "
        f"verifying keys and proofs equal point for point; both accepted")


# Phase 11: KZG and Gemini at 2^20 coefficients (commit/kzg.py, commit/gemini.py).
# The SRS has degree 2^20: Gemini's first fold carries a degree bound of its
# 2^20 coefficients, which needs the power s^(2^20).
LOG_KZG = 20
KZG_SMALL = 15  # KZG and Gemini on the card and on the CPU: the JAX tests' degree
K1_OPEN_LAUNCHES = 1000  # K1 + its chain in one open at 2^20 (a loop a coefficient: ~2^20)
# The kernels of the KZG / Gemini path (the MSMs, the G2 setup tree and the
# ladder of commit_g2) and of fast_multiply (K5 below 2^14 points, K6 above)
KZG_KERNELS = MSM_KERNELS + ("padd2", "pdbl2")
FAST_MUL_LOGS = ((19, "ntt_leaf"), (8, "butterfly"))


def lagrange_at(xs, ys, x: int, p: int) -> int:
    """I(x) for the interpolant of the host points (xs, ys)."""
    total = 0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num, den = num * (x - xj) % p, den * (xi - xj) % p
        total = (total + yi * num * pow(den, -1, p)) % p
    return total


def host_folds(coeffs, rhos, p: int) -> list:
    """Gemini's folds f_i = even(f_(i-1)) + rho_i odd(f_(i-1)) on host ints."""
    fs = [coeffs]
    for rho in rhos:
        f = fs[-1]
        fs.append([(e + rho * o) % p for e, o in zip(f[0::2], f[1::2])])
    return fs


def kzg_small(d, s: int) -> tuple:
    """KZG and Gemini at degree KZG_SMALL on device d from one seed: the
    commitment, the opening, the batch opening, the degree proof, Gemini's
    commitments and proof (host points and ints), and the key."""
    from myzkp_tpu_torch.commit import gemini, kzg
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops.poly import Poly

    spec, R = bn254.r_spec(), bn254.R
    rng = random.Random(SEED + 21)
    pk = kzg.setup(KZG_SMALL, s=s, full_g2=True, device=d)
    p = Poly.from_int_coeffs(spec, [rng.randrange(R) for _ in range(8)], d)
    mcoefs, rhos = [rng.randrange(R) for _ in range(4)], [rng.randrange(R) for _ in range(2)]
    beta = rng.randrange(R)
    fs = gemini.split_and_fold(Fp.from_int(spec, mcoefs, d), rhos)
    pi = gemini.open_gemini(fs, beta, pk)
    out = [kzg.commit(pk, p), kzg.open(pk, p, 123), kzg.batch_open(pk, p, [2, 5, 9]),
           kzg.prove_degree_bound(pk, p, 8), gemini.commit_gemini(fs, pk), pi.es,
           pi.degree_proofs]
    return out, pk, (rhos, int(fs[-1].to_int()[0]), beta)


def phase_kzg(dev, results: dict) -> tuple:
    from myzkp_tpu_torch.commit import gemini, kzg
    from myzkp_tpu_torch.curves import bn254, weierstrass as wst
    from myzkp_tpu_torch.curves.msm import scalars_from_int
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.ops.poly import Poly

    t_phase = time.perf_counter()
    spec, R = bn254.r_spec(), bn254.R
    G1, G2 = bn254.g1_generator(), bn254.g2_generator()
    n = 1 << LOG_KZG
    rng = random.Random(SEED + 20)
    s = rng.randrange(1, R)
    counts, secs = {}, {}

    def run(name: str, fn):
        (out, counts[name]), secs[name] = timed(lambda: counted(fn))
        return out

    # setup: the host powers of s and their limbs, then the whole setup
    _, secs["setup_host"] = timed(lambda: scalars_from_int(spec, kzg._powers_of_s(s, n + 1), dev))
    pk = run("setup", lambda: fresh_tables(lambda: kzg.setup(n, s=s, full_g2=True)))
    idx = sorted({0, 1, n} | set(rng.sample(range(n + 1), 5)))
    sample = lambda pt: wst.point_map(lambda a: a[:, idx], pt)
    if (bn254.g1_points_to_host(sample(pk.powers1)) != [G1 * pow(s, i, R) for i in idx]
            or bn254.g2_points_to_host(sample(pk.powers2)) != [G2 * pow(s, i, R) for i in idx]):
        raise AssertionError(f"KZG setup 2^{LOG_KZG}: [s^i]G1 or [s^i]G2 differs from the "
                             f"host at i in {idx}")

    # commit, open, batch open
    coeffs = [rng.randrange(R) for _ in range(n)]
    p = Poly.from_int_coeffs(spec, coeffs, dev)
    ps = horner(coeffs, s, R)
    C = run("commit", lambda: kzg.commit(pk, p))
    if C != G1 * ps:
        raise AssertionError(f"KZG commit 2^{LOG_KZG}: C != [p(s)]G1")
    commit_ms, commit_reps = median_ms(lambda: kzg.commit(pk, p), reps=3)
    u = rng.randrange(R)
    y, w = run("open", lambda: kzg.open(pk, p, u))
    if y != horner(coeffs, u, R) or w != G1 * ((ps - y) * pow(s - u, -1, R) % R):
        raise AssertionError(f"KZG open 2^{LOG_KZG}: y or w differs from the host")
    k1_open = counts["open"].get("mont_mul", 0) + counts["open"].get("mont_pow", 0)
    if k1_open >= K1_OPEN_LAUNCHES:
        raise AssertionError(f"KZG open 2^{LOG_KZG}: {k1_open} K1 + chain launches, "
                             f"expected fewer than {K1_OPEN_LAUNCHES}")
    ok = run("verify", lambda: (kzg.verify(pk, u, y, C, w),
                                kzg.verify(pk, u, (y + 1) % R, C, w)))
    if ok != (True, False):
        raise AssertionError(f"KZG verify 2^{LOG_KZG}: (accept, y + 1) gave {ok}")
    us = [rng.randrange(R) for _ in range(3)]
    ys, wb = run("batch_open", lambda: kzg.batch_open(pk, p, us))
    z_s = (s - us[0]) * (s - us[1]) * (s - us[2]) % R
    if (ys != [horner(coeffs, x, R) for x in us]
            or wb != G1 * ((ps - lagrange_at(us, ys, s, R)) * pow(z_s, -1, R) % R)):
        raise AssertionError(f"KZG batch open 2^{LOG_KZG}: ys or w differs from the host")
    bad = [(ys[0] + 1) % R] + ys[1:]
    ok = run("batch_verify", lambda: (kzg.batch_verify(pk, us, ys, C, wb),
                                      kzg.batch_verify(pk, us, bad, C, wb)))
    if ok != (True, False):
        raise AssertionError(f"KZG batch verify 2^{LOG_KZG}: (accept, one y changed) gave {ok}")

    # the degree bound: d = 2^19 on a polynomial of degree 2^19
    d = n // 2
    p_d = Poly(p.coef[: d + 1])
    pd_s = horner(coeffs[: d + 1], s, R)
    C_d = kzg.commit(pk, p_d)
    dp = run("degree", lambda: kzg.prove_degree_bound(pk, p_d, d))
    if C_d != G1 * pd_s or dp != G1 * (pow(s, n - d, R) * pd_s % R):
        raise AssertionError(f"KZG degree bound 2^{LOG_KZG - 1}: C or proof differs from the host")
    ok = run("verify_degree", lambda: (kzg.verify_degree_bound(pk, C_d, dp, d),
                                       kzg.verify_degree_bound(pk, C_d, dp, d - 1)))
    if ok != (True, False):
        raise AssertionError(f"KZG degree bound: (d, d - 1) gave {ok}")

    # Gemini over the 2^20 coefficients: 20 folds, 21 polynomials
    rhos = [rng.randrange(R) for _ in range(LOG_KZG)]
    beta = rng.randrange(R)
    def fold_and_commit():
        fs = gemini.split_and_fold(p.coef, rhos)
        return fs, gemini.commit_gemini(fs, pk)

    fs, cg = run("gemini_commit", fold_and_commit)
    host = host_folds(coeffs, rhos, R)
    mu = host[-1][0]
    if int(fs[-1].to_int()[0]) != mu or cg != [G1 * horner(f, s, R) for f in host]:
        raise AssertionError(f"Gemini 2^{LOG_KZG}: a commitment differs from [f_i(s)]G1")
    pi = run("gemini_open", lambda: gemini.open_gemini(fs, beta, pk))
    # two whole verifies: each checks every degree bound and batch opening
    # and computes its own [Z(s)]G2 (the mu + 1 proof fails only at the end)
    ok = (run("gemini_verify", lambda: gemini.verify_gemini(rhos, mu, beta, cg, pi, pk)),
          run("gemini_reject", lambda: gemini.verify_gemini(rhos, (mu + 1) % R, beta, cg, pi, pk)))
    if ok != (True, False):
        raise AssertionError(f"Gemini 2^{LOG_KZG}: verify (accept, mu + 1) gave {ok}")
    del fs, pi, p, p_d

    # fast_multiply: K6 at 2^19 x 2^19, K5 at 2^8 x 2^8
    fm = {}
    for logm, kern in FAST_MUL_LOGS:
        a, b = ([rng.randrange(R) for _ in range(1 << logm)] for _ in range(2))
        fa, fb = Fp.from_int(spec, a, dev), Fp.from_int(spec, b, dev)
        prod = run(f"fast_multiply_2^{logm}", lambda: ntt.fast_multiply(fa, fb))
        if counts[f"fast_multiply_2^{logm}"].get(kern, 0) < 1:
            raise AssertionError(f"fast_multiply 2^{logm}: {kern} never launched")
        pv = [int(v) for v in prod.to_int()]
        xs = [rng.randrange(R) for _ in range(3)]
        if [horner(pv, x, R) for x in xs] != [horner(a, x, R) * horner(b, x, R) % R for x in xs]:
            raise AssertionError(f"fast_multiply 2^{logm}: p(x) q(x) differs from the host")
        fm[f"2^{logm}"] = median_ms(lambda: ntt.fast_multiply(fa, fb), reps=3)[0]

    # degree KZG_SMALL on the card and on the CPU plain versions, same s
    (card_out, pk_c, (rh, mu_c, be)), card_s = timed(lambda: kzg_small(dev, s))
    (plain_out, _, _), plain_s = timed(lambda: kzg_small(torch.device("cpu"), s))
    if card_out != plain_out:
        raise AssertionError(f"KZG / Gemini degree {KZG_SMALL}: the card's commitments or "
                             f"proofs differ from the CPU plain versions'")
    C_c, (y_c, w_c), (ys_c, wb_c), dp_c, cg_c, es_c, dps_c = card_out
    ok = (kzg.verify(pk_c, 123, y_c, C_c, w_c), kzg.batch_verify(pk_c, [2, 5, 9], ys_c, C_c, wb_c),
          kzg.verify_degree_bound(pk_c, C_c, dp_c, 8),
          gemini.verify_gemini(rh, mu_c, be, cg_c, gemini.ProofGemini(es_c, dps_c), pk_c))
    if not all(ok):
        raise AssertionError(f"KZG / Gemini degree {KZG_SMALL} on the card: a verifier "
                             f"rejected: {ok}")

    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    need = KZG_KERNELS + tuple(k for _, k in FAST_MUL_LOGS)
    if min(total.get(k, 0) for k in need) < 1:
        raise AssertionError(f"KZG phase: a kernel of {need} never launched: {total}")
    if min(counts["commit"].get(k, 0) for k in MSM_KERNELS) < 1:
        raise AssertionError(f"KZG commit: a kernel of {MSM_KERNELS} never launched: "
                             f"{counts['commit']}")
    for k in results:
        if not k.startswith("_"):
            results[k]["kzg_launches"] = total.get(k, 0)
    secs["phase"] = time.perf_counter() - t_phase
    results["_kzg"] = {"card": card(), "seconds": secs, "commit_ms": commit_ms,
                       "commit_reps_ms": commit_reps, "fast_multiply_ms": fm,
                       "small_card_s": card_s, "small_plain_s": plain_s, "launches": counts}
    smi = card()
    log(f"# kzg 2^{LOG_KZG} ({smi}): setup of degree 2^{LOG_KZG}, full G2, "
        f"{secs['setup']:.3f} s (host powers and limbs {secs['setup_host']:.3f} s), "
        f"[s^i]G1, G2 == host at i in {idx}; commit == [p(s)]G1, median {commit_ms:.2f} ms of "
        f"{[round(t, 2) for t in commit_reps]}; open {secs['open']:.3f} s, y and w == host, "
        f"verify {secs['verify']:.3f} s (2 calls, pairings on the host): accepted, y + 1 rejected; "
        f"batch open at 3 points {secs['batch_open']:.3f} s, ys and w == host, batch verify "
        f"{secs['batch_verify']:.3f} s (2 calls): accepted, one y changed rejected; degree "
        f"bound d = 2^{LOG_KZG - 1} {secs['degree']:.3f} s == host: verify (2 calls) "
        f"{secs['verify_degree']:.3f} s, true at d, false at d - 1")
    log(f"# gemini 2^{LOG_KZG} ({smi}): fold + commit of 21 polynomials "
        f"{secs['gemini_commit']:.3f} s, each == [f_i(s)]G1; open {secs['gemini_open']:.3f} s; "
        f"verify {secs['gemini_verify']:.3f} s: accepted; the same proof with mu + 1 "
        f"{secs['gemini_reject']:.3f} s: rejected")
    sizes = " and ".join(f"2^{m} x 2^{m} ({k})" for m, k in FAST_MUL_LOGS)
    log(f"# fast_multiply ({smi}): {sizes} == host p(x) q(x) at 3 points; median ms "
        f"{json.dumps(fm)}")
    log(f"# kzg degree {KZG_SMALL}: on the card ({card_s:.2f} s) and on the CPU plain "
        f"versions ({plain_s:.2f} s), same s: commitments, openings, degree proof and "
        f"Gemini's commitments and proof equal point for point; the card's verified")
    for name in ("commit", "open", "batch_open", "degree", "gemini_commit", "gemini_open"):
        log(f"# kzg {name} launches: {json.dumps(counts[name])}")
    log(f"# kzg open: K1 {counts['open'].get('mont_mul', 0)} launches, its chain "
        f"{counts['open'].get('mont_pow', 0)}: {k1_open} in all (under {K1_OPEN_LAUNCHES})")
    log(f"# kzg phase {secs['phase']:.1f} s")
    return pk, s


# Phase 12: both sumcheck provers (protocols/sumcheck_tpu.py, protocols/sumcheck.py)
# at the width of the port's other paths: a 2^20-point hypercube, and the
# Gemini-tied sumcheck at el = 20 (Gemini over 2^20 coefficients) on phase 11's
# SRS.  The table prover's problem is the demo's (examples/sumcheck_demo.py:
# three multilinear factors of 8 terms from random.Random(45), degree 3).
LOG_SC = 20
LOG_SC_HOST = 12  # the table prover against the port's host mirror
SC_FACTORS, SC_TERMS, SC_SEED = 3, 8, 45
K1_SUMCHECK_LAUNCHES = 2000  # K1 + its chain in a table prove (a loop an element: ~2^20)


def demo_factors(spec, num_vars: int) -> list:
    """The demo's factors: random multilinear MPolys of SC_TERMS terms."""
    from myzkp_tpu_torch.ops.mpoly import MPoly

    rng = random.Random(SC_SEED)
    out = []
    for _ in range(SC_FACTORS):
        d = {}
        for _ in range(SC_TERMS):
            d[tuple(rng.randint(0, 1) for _ in range(num_vars))] = rng.randrange(spec.p)
        out.append(MPoly(spec, d))
    return out


class split_timer:
    """Within the block, each call of owner.name also adds its seconds (host
    clock, ended by a synchronize) to ``self.secs``; callers reach the
    function through its owner, so they see the wrapper."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.secs = owner, name, 0.0

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            out, sec = timed(lambda: fn(*a, **k))
            self.secs += sec
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def phase_sumcheck(dev, results: dict, pk, s: int) -> None:
    from myzkp_tpu_torch.commit import gemini
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.ops.mpoly import MPoly
    from myzkp_tpu_torch.protocols import sumcheck as sc
    from myzkp_tpu_torch.protocols import sumcheck_tpu as st

    t_phase = time.perf_counter()
    spec, R = bn254.r_spec(), bn254.R
    G1 = bn254.g1_generator()
    counts, secs = {}, {}

    def run(name: str, fn):
        (out, counts[name]), secs[name] = timed(lambda: counted(fn))
        return out

    def rejects(name: str, fn, what: str):
        if run(name, fn):
            raise AssertionError(f"sumcheck: the verifier accepted {what}")

    # (a) the table prover over the 2^20-point hypercube
    factors = demo_factors(spec, LOG_SC)
    prover, verifier = st.SumCheckProverTPU(spec, SC_FACTORS), st.SumCheckVerifier(spec)
    with split_timer(st, "eval_all_binary_combinations") as build:
        proof = run("table_prove", lambda: prover.prove(factors, LOG_SC))
    first = {"total_s": secs["table_prove"], "build_s": build.secs}
    k1 = counts["table_prove"].get("mont_mul", 0) + counts["table_prove"].get("mont_pow", 0)
    if k1 >= K1_SUMCHECK_LAUNCHES or counts["table_prove"].get("mont_mul", 0) < 1:
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: {k1} K1 + chain launches, "
                             f"expected 1 to {K1_SUMCHECK_LAUNCHES - 1}")
    if not run("table_verify", lambda: verifier.verify(proof, factors)):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: the verifier rejected it")
    rejects("table_reject_sum", lambda: verifier.verify(st.ProductSumcheckProof(
        proof.el, (proof.claimed_sum + 1) % R, proof.round_polys), factors),
        "a changed claimed sum")
    rp = [list(c) for c in proof.round_polys]
    rp[LOG_SC // 2][2] = (rp[LOG_SC // 2][2] + 1) % R
    rejects("table_reject_round", lambda: verifier.verify(st.ProductSumcheckProof(
        proof.el, proof.claimed_sum, rp), factors), "a changed round coefficient")
    reps = []
    for _ in range(3):
        with split_timer(st, "eval_all_binary_combinations") as build:
            again, total = timed(lambda: prover.prove(factors, LOG_SC))
        if (again.claimed_sum, again.round_polys) != (proof.claimed_sum, proof.round_polys):
            raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: a second prove differs")
        reps.append((total * 1e3, build.secs * 1e3))
    med = sorted(reps)[1]
    table = {"prove_ms": med[0], "build_ms": med[1], "rounds_ms": med[0] - med[1],
             "reps_ms": reps, "first": first, "k1_launches": k1}
    del factors, proof, again

    # (b) the same prover at 2^12 against the port's host mirror
    small = demo_factors(spec, LOG_SC_HOST)
    card_p, card_s = timed(lambda: prover.prove(small, LOG_SC_HOST))
    t0 = time.perf_counter()
    host_p = st.SumCheckProverHost(spec, SC_FACTORS).prove(small, LOG_SC_HOST)
    host_s = time.perf_counter() - t0
    if (card_p.claimed_sum, card_p.round_polys) != (host_p.claimed_sum, host_p.round_polys):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC_HOST}: the card's claimed sum "
                             f"or round polynomials differ from the host mirror's")
    if not verifier.verify(card_p, small):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC_HOST}: the verifier rejected it")

    # (c) the Gemini-tied sumcheck at el = 20 on phase 11's SRS
    rng = random.Random(SEED + 30)
    d = {tuple(rng.randint(0, 1) for _ in range(LOG_SC)): rng.randrange(R)
         for _ in range(SC_TERMS)}
    d[(1,) * LOG_SC] = rng.randrange(1, R)  # g has all 20 variables
    g = MPoly(spec, d)
    h = run("hypercube_sum", lambda: sc.sum_over_boolean_hypercube(g, dev))
    if h != sum(c << (LOG_SC - sum(e)) for e, c in g.d.items()) % R:
        raise AssertionError(f"sumcheck 2^{LOG_SC}: the hypercube sum differs from the host's")
    with split_timer(sc, "commit_sumcheck") as commit, \
            split_timer(gemini, "open_gemini") as opening:
        sp = run("gemini_prove", lambda: sc.prove_sumcheck(g, h, pk))
    stream = sc._transcript(sp.el, sp.h)
    rs = [sc._round_challenge(spec, stream, g_j) for g_j in sp.gs]
    folds = host_folds(sc.get_coefs_in_order(g), rs, R)
    if sp.c_g != [G1 * horner(f, s, R) for f in folds]:
        raise AssertionError(f"sumcheck 2^{LOG_SC}: c_g differs from the host's [f_i(s)]G1")
    if not run("gemini_verify", lambda: sc.verify_sumcheck(sp, pk)):
        raise AssertionError(f"sumcheck 2^{LOG_SC}: verify_sumcheck rejected the proof")
    rejects("gemini_reject_h", lambda: sc.verify_sumcheck(
        sc.SumCheckProof(**{**sp.__dict__, "h": (h + 1) % R}), pk), "a changed h")
    gs = list(sp.gs)
    gs[LOG_SC // 2] = gs[LOG_SC // 2] + MPoly.constant(spec, 1)
    rejects("gemini_reject_gj", lambda: sc.verify_sumcheck(
        sc.SumCheckProof(**{**sp.__dict__, "gs": gs}), pk), "a changed g_j")
    gem = {"prove_s": secs["gemini_prove"], "commit_s": commit.secs, "open_s": opening.secs,
           "rounds_s": secs["gemini_prove"] - commit.secs - opening.secs}

    need = {"gemini_prove": MSM_KERNELS, "gemini_verify": ("padd", "pdbl", "padd2", "pdbl2")}
    for name, kernels in need.items():
        if min(counts[name].get(k, 0) for k in kernels) < 1:
            raise AssertionError(f"sumcheck {name}: a kernel of {kernels} never launched: "
                                 f"{counts[name]}")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    for k in results:
        if not k.startswith("_"):
            results[k]["sumcheck_launches"] = total.get(k, 0)
    secs["phase"] = time.perf_counter() - t_phase
    results["_sumcheck"] = {"card": card(), "table": table, "small_card_s": card_s,
                            "small_host_s": host_s, "gemini": gem, "seconds": secs,
                            "launches": counts}
    smi = card()
    log(f"# sumcheck table 2^{LOG_SC} ({smi}): {SC_FACTORS} factors x {SC_TERMS} terms, "
        f"degree {SC_FACTORS}; prove median {med[0]:.2f} ms of "
        f"{[round(t, 2) for t, _ in reps]} (table build {med[1]:.2f}, rounds "
        f"{med[0] - med[1]:.2f}); first {first['total_s']:.3f} s (build "
        f"{first['build_s']:.3f}); verify {secs['table_verify']:.3f} s: accepted; a changed "
        f"claimed sum and a changed round coefficient rejected; K1 {k1} launches "
        f"(under {K1_SUMCHECK_LAUNCHES})")
    log(f"# sumcheck table 2^{LOG_SC_HOST}: the card's proof ({card_s:.3f} s) == the host "
        f"mirror's ({host_s:.3f} s): claimed sum and all {LOG_SC_HOST} round polynomials")
    log(f"# sumcheck gemini el = {LOG_SC} ({smi}): hypercube sum == host "
        f"({secs['hypercube_sum']:.3f} s); prove {gem['prove_s']:.3f} s (host rounds "
        f"{gem['rounds_s']:.3f}, commit {gem['commit_s']:.3f}, open {gem['open_s']:.3f}); "
        f"c_g == [f_i(s)]G1 of the host folds; verify {secs['gemini_verify']:.3f} s: "
        f"accepted; a changed h {secs['gemini_reject_h']:.3f} s and a changed g_j "
        f"{secs['gemini_reject_gj']:.3f} s: rejected")
    for name in ("table_prove", "gemini_prove", "gemini_verify"):
        log(f"# sumcheck {name} launches: {json.dumps(counts[name])}")
    log(f"# sumcheck phase {secs['phase']:.1f} s")


SOURCES = {
    "mont_mul": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                 "myzkp_tpu/fields/limb_pallas.py:286"),
    # the reference's pow_const / inv: a lax.scan of mont_mul_pallas steps
    # (myzkp_tpu/fields/limb.py:346-371)
    "mont_pow": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                 "myzkp_tpu/fields/limb_pallas.py:286"),
    "padd": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:322"),
    "pdbl": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:340"),
    "bucket_scan_rows": ("myzkp_tpu_torch/csrc/bucket_scan.cu",
                         "myzkp_tpu/curves/curve_pallas.py:425"),
    "butterfly": ("myzkp_tpu_torch/csrc/ntt.cu",
                  "myzkp_tpu/fields/limb_pallas.py:76"),
    "ntt_leaf": ("myzkp_tpu_torch/csrc/ntt.cu",
                 "myzkp_tpu/fields/limb_pallas.py:242"),
    "padd2": ("myzkp_tpu_torch/csrc/curve2.cu",
              "myzkp_tpu/curves/curve_pallas.py:534"),
    "pdbl2": ("myzkp_tpu_torch/csrc/curve2.cu",
              "myzkp_tpu/curves/curve_pallas.py:550"),
    "padd_mixed": ("myzkp_tpu_torch/csrc/curve.cu",
                   "myzkp_tpu/curves/curve_pallas.py:239"),
    "padd_mixed2": ("myzkp_tpu_torch/csrc/curve2.cu",
                    "myzkp_tpu/curves/curve_pallas.py:289"),
    # the reference's G2 scan: K steps of padd2_sel_fused (msm.py:215-280)
    "bucket_scan_rows2": ("myzkp_tpu_torch/csrc/bucket_scan.cu",
                          "myzkp_tpu/curves/curve_pallas.py:542"),
    # one level of the reference's _seg_scan_hs (msm.py:335-357) over K2 / K7
    "padd_seg_level": ("myzkp_tpu_torch/csrc/curve.cu",
                       "myzkp_tpu/curves/curve_pallas.py:322"),
    "padd2_seg_level": ("myzkp_tpu_torch/csrc/curve2.cu",
                        "myzkp_tpu/curves/curve_pallas.py:534"),
    # probe 14's row gather with probe 16's rows -> planes transpose fused in
    "gather_planes": ("myzkp_tpu_torch/csrc/rows.cu", "tools/exp_gather_pallas.py:33"),
    # probe 16's planes -> rows transpose, written at targets
    "scatter_rows": ("myzkp_tpu_torch/csrc/rows.cu", "tools/exp_transpose.py:78"),
}


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    results = {k: {} for k in SOURCES}
    phase_bitcheck(dev, results)
    phase_bitcheck_g2(dev, results)
    phase_bitcheck_rows(dev, results)
    phase_bitcheck_levels(dev, results)
    phase_bitcheck_chains(dev, results)
    phase_bitcheck_fr(dev, results)
    phase_bitcheck_pow(dev, results)
    phase_slice(dev, results)
    results["_chains"] = time_chains(dev, results)
    phase_ntt(dev, results)
    big = phase_shifted_h(dev, LOG_M_BIG)
    small = phase_shifted_h(dev, LOG_M_SMALL)
    for run, need in ((big, ("mont_mul", "ntt_leaf")), (small, ("mont_mul", "butterfly"))):
        if min(run["launches"].get(k, 0) for k in need) < 1:
            raise AssertionError(f"shifted h: a kernel of {need} never launched: "
                                 f"{run['launches']}")
    results["ntt_leaf"]["launches"] = big["launches"]["ntt_leaf"]
    results["butterfly"]["launches"] = small["launches"]["butterfly"]
    results["_shifted_h"] = {f"2^{LOG_M_BIG}": big, f"2^{LOG_M_SMALL}": small}
    time_ntt_kernels(dev, results)
    results["_k1"] = time_k1(dev, results)
    phase_g2_msm(dev, results)
    phase_pinocchio(dev, results)
    time_g2_kernels(dev, results)
    phase_mixed_add(dev, results)
    phase_groth16(dev, results)
    srs, s = phase_kzg(dev, results)
    phase_sumcheck(dev, results, srs, s)
    del srs
    keys = ("launches", "kzg_launches", "sumcheck_launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], **{key: results[k][key] for key in keys}}
               for k in SOURCES]
    log(f"# msm {json.dumps(results['_msm'])}")
    log(f"# ntt {json.dumps(results['_ntt'])}")
    log(f"# shifted_h {json.dumps(results['_shifted_h'])}")
    log(f"# g2_msm {json.dumps(results['_g2_msm'])}")
    log(f"# pinocchio {json.dumps(results['_pinocchio'])}")
    log(f"# mixed_add {json.dumps(results['_mixed_add'])}")
    log(f"# groth16 {json.dumps(results['_groth16'])}")
    log(f"# kzg {json.dumps(results['_kzg'])}")
    log(f"# sumcheck {json.dumps(results['_sumcheck'])}")
    log(f"# probe13 {json.dumps(results['_probe13'])}")
    log(f"# scan_parent_path {json.dumps(results['_scan_parent_path'])}")
    log(f"# rows {json.dumps(results['_rows'])}")
    log(f"# padd_lanes {json.dumps(results['_padd_lanes'])}")
    log(f"# levels_all_adds {json.dumps(results['_levels_all_adds'])}")

    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
