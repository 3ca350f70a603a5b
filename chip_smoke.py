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
               K1-K3 over F_q and the G1 group law; K4 and its G2 instance
               (acc and the bucket table written in place: all four tags,
               flush targets with -1 and at step 0, rows of 0, 1, q - 1, R
               mod q in every coordinate component, 3000 lanes, K = 4); K7
               (with and without its select mask) and K8 over F_q2 at the
               MSM's 32,768 lanes (P+P, P+(-P), infinity on either side,
               z != 1, and lanes whose every c0 and c1 is 0, 1, q - 1 or R mod
               q) and K7 at a G2 fixed-base tree level; then K1 over F_r, K5
               on 2^20 pairs and at every stage shape of the m = 2^12 path,
               K6 at every
               leaf shape of the 2^20 paths and at m = 16, 64, 128 with a
               ragged batch; segment_sum_mod on the card against the CPU and
               host ints, 2^20 entries with heavy duplicates;
  4. msm       the G1 slice: fixed-base setup of 2^20 points [m_i]G, then the
               2^20 Pippenger MSM against 2^20 scalars k_i, checked against
               the host's [sum k_i m_i mod r]G; kernel launch counts of that
               run; the MSM timed; msm_pippenger at n = 2^16 with c = 14,
               checked the same way; K1-K3 timed beside their plain versions;
               K4 at the MSM's shape (one window group's sorted digits, K = 64,
               32,768 lanes; real flush targets checked unique) exact against
               its plain version, acc and bucket table, and timed beside it,
               and probe 13: the same 64 steps as 64 launches of K2 with the
               mask;
  5. ntt       a forward NTT of 2^20 seeded F_r elements checked at 3 points
               against host evaluation, intt(ntt(a)) == a, its launches, and
               its time;
  6. shifted h the prover's quotient stage get_shifted_h on square_chain(m)
               at m = 2^20 (four-step transforms over K6) and m = 2^12
               (Stockham stages over K5), each checked on the host: ell(w^j)
               equals the constraint evaluation u_j, and the Pinocchio
               identity (ell + d_ell t)(r + d_r t) - (o + d_o t) = H t holds at
               a random point; launch counts of each run; the calls timed;
               K5 and K6 timed beside their plain versions;
  7. g2 msm    fixed-base setup of 2^20 G2 points [m_i]G2, then the 2^20 G2
               Pippenger MSM (one launch of K4's G2 instance per window
               group) against 2^20 scalars with a zero and duplicates,
               checked against the host's [sum k_i m_i mod r]G2; launch
               counts; the MSM timed; the G2 scan at the MSM's shape and
               probe 13 (64 launches of K7 with the mask), as for G1;
  8. pinocchio setup, prove and verify on square_chain(2^20): the proof is
               accepted and the proof of a wrong witness (one x_k changed) is
               rejected; launch counts of setup and of prove; setup seconds,
               prove median of 3, verify seconds (host); then setup and prove
               at m = 2^4 on the card and on the CPU plain versions with the
               same seeds, keys and proofs equal point for point; K7 and K8
               timed beside their plain versions at the MSM's 32,768 lanes;
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
               of setup and of prove; setup seconds, prove median of 3, verify
               seconds; then setup and prove at m = 2^4 on the card and on the
               CPU plain versions with the same seeds, keys and proofs equal
               point for point.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.  Any failure exits nonzero before it.
Neither this script nor the port imports JAX.
"""

from __future__ import annotations

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
MSM_KERNELS = ("mont_mul", "padd", "pdbl", "bucket_scan_rows")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches (after one warm-up)."""
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


def bound(nbytes: float, mont_products: float) -> dict:
    """The least time the card could take: bytes at the memory rate against
    Montgomery products at the integer multiply rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mont_products * IMAD_PER_MONT / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from myzkp_tpu_torch import _ext

    nvcc = subprocess.run([_ext._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(smi.splitlines()[0])
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


def random_fe(rng: np.random.Generator, n: int, dev) -> torch.Tensor:
    """n random canonical F_q limb columns (top limb kept below q's)."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] = rng.integers(0, 0x3064, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def check_equal(name: str, got, want) -> int:
    got, want = list(got), list(want)
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version disagree")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_bitcheck(dev, results: dict):
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, msm
    from myzkp_tpu_torch.fields import limb

    rng = np.random.default_rng(SEED)
    spec = bn254.q_spec()
    p = spec.p

    # K1 at 2^20 elements; the first 16 are all pairs of 0, 1, p-1, R mod p
    n = 1 << LOG_N
    a, b = random_fe(rng, n, dev), random_fe(rng, n, dev)
    edges = [0, 1, p - 1, (1 << 256) % p]
    ea = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    eb = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    a[:, :16], b[:, :16] = ea, eb
    got, want = limb.mont_mul(spec, a, b), limb.mont_mul_ref(spec, a, b)
    torch.cuda.synchronize()
    err = check_equal("mont_mul", [got], [want])
    ai, bi, gi = (limb.to_int(spec, t[:, :64]) for t in (a, b, got))
    rinv = pow(1 << 256, -1, p)
    if any(int(g) != int(x) * int(y) * rinv % p for g, x, y in zip(gi, ai, bi)):
        raise AssertionError("mont_mul: disagrees with the host on 64 elements")
    results["mont_mul"] = {"max_abs_err": err}
    log(f"# bitcheck mont_mul: 2^{LOG_N} elements + 16 edge pairs: exact")

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
    return a, b


SCAN_CASE = ("N = 3000 lanes, K = 4, tags 0-3, flush targets on 3 steps in 10 "
             "(step 0 included) and -1 elsewhere, 375 rows of 0, 1, q - 1, R mod q "
             "in every coordinate component at random steps and lanes")


def scan_table(F, S: int, width: int, dev):
    """An S-row bucket table of infinity rows, as the MSM makes it."""
    from myzkp_tpu_torch.curves import msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    return msm._rows_of_point(wst.infinity(F, (S,), dev), width)[0]


def bitcheck_scan(spec, F, b3, rows, K: int, rng, dev) -> int:
    """K4 (G1) or its G2 instance against the plain version on rows of
    points: all four tags (the first eight pinned), unique random flush
    targets on about 3 steps in 10, step 0 included, -1 elsewhere; N / 8
    rows at seeded random positions hold 0, 1, q - 1 or R mod q in every
    coordinate component, some of them added (no segment head) to a live
    accumulator at a step after 0.  acc and the whole bucket table must
    agree exactly."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.fields import limb

    total, W = rows.shape
    N = total // K
    rows = rows.clone()
    E = N // 8
    at = np.sort(rng.choice(total, E, replace=False))  # rows are step-major
    at_dev = torch.from_numpy(at).to(dev)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    for j in range(W // 64 * 3):  # coordinate components: 3 for G1, 6 for G2
        vals = [edges[i] for i in rng.integers(0, 4, E)]
        rows[at_dev, 16 * j:16 * j + 16] = limb.from_int(spec, vals, dev).T
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
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    t_k, t_p = scan_table(F, S, W, dev), scan_table(F, S, W, dev)
    acc = scan(spec, rows, tag, tgt, b3, t_k, K)
    acc_p = ck.bucket_scan_rows_ref(spec, rows, tag, tgt, b3, t_p, K)
    torch.cuda.synchronize()
    return check_equal("bucket_scan_rows2" if g2 else "bucket_scan_rows", [acc, t_k], [acc_p, t_p])


def time_scan(F, b3, pts, dev, results: dict) -> None:
    """The bucket scan at the 2^20 MSM's shape, one window group (c = 16,
    G = 2, K = 64, 32,768 lanes) of seeded scalars' sorted digits, with the
    path's own gather, tags and targets: the real targets checked unique,
    the kernel held to its plain version (acc and the whole bucket table
    exact; repeated launches rewrite the same rows), both timed; then probe
    13 (tools/exp_kernel_ledger.py:80): the same K steps as K launches of
    the select-masked complete add (K2 for G1, K7 for G2)
    over plane-major inputs laid out beforehand, its result equal to the
    scan's acc, timed the same way."""
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
    table_rows, _ = msm._rows_of_point(pts)
    rows = table_rows.index_select(0, idx)
    del table_rows
    real = tgt[tgt >= 0]
    msm._check_unique_targets(real, num_buckets, num_buckets + 1)  # raises
    if (tgt[:N] >= 0).any():
        raise AssertionError(f"{name}: a flush target at step 0")
    S, W = G * (num_buckets + 1), rows.shape[1]
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    t_k, t_p = scan_table(F, S, W, dev), scan_table(F, S, W, dev)
    kern = lambda: [scan(spec, rows, tag, tgt, b3, t_k, K), t_k]
    plain = lambda: [ck.bucket_scan_rows_ref(spec, rows, tag, tgt, b3, t_p, K), t_p]
    heads, flushes = int(((tag & 2) > 0).sum()), int(real.numel())
    C = 48 * (2 if g2 else 1)
    adds = 42 if g2 else 14  # Montgomery products of a complete add
    # the used limbs of every row, its tag and target; the real flushes; acc
    bnd = bound(K * N * (4 * C + 8) + flushes * 4 * C + N * 4 * C + LIMB_BYTES * (C // 48),
                adds * (K * N - heads))
    shape = f"K = {K}, N = {N} lanes, {heads} heads, {flushes} real flushes"
    time_cases({name: (shape, kern, plain, 5, 1, bnd)}, results)
    acc = kern()[0]

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
    loop_ms = cuda_time_ms(loop, 3)
    results.setdefault("_probe13", {})[name] = {
        "scan_ms": results[name]["ms"], "loop_ms": loop_ms, "K": K, "lanes": N,
        "heads": heads, "real_flushes": flushes}
    log(f"# probe 13 [{shape}]: {K} launches of {'K7' if g2 else 'K2'} with the "
        f"mask {loop_ms:.4f} ms against the scan's {results[name]['ms']:.4f} ms; "
        f"the loop's acc == the scan's")


def phase_slice(dev, results: dict, a, b) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

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
    W, slots = -(-256 // 8), 1 << 8
    tree_w = (W // 2) * fixed_base._CHUNK  # first tree level of one chunk
    x = tuple(cc.repeat(1, -(-tree_w // n))[:, :tree_w].contiguous() for cc in pts)
    y = tuple(torch.roll(cc, 1, dims=1) for cc in x)
    nwin = -(-256 // c)  # MSM windows: the bucket sum's and Horner's width
    wins = tuple(cc[:, :nwin].contiguous() for cc in x)
    tm = a[:, :W * slots].contiguous(), b[:, :W * slots].contiguous()
    n_mm = W * slots
    cases = {
        "mont_mul": (f"(16, {n_mm}) table to_mont",
                     lambda: limb.mont_mul(spec, *tm),
                     lambda: limb.mont_mul_ref(spec, *tm), 100, 3,
                     bound(3 * LIMB_BYTES * n_mm, n_mm)),
        "padd": (f"{tree_w} points, first fixed-base tree level",
                 lambda: ck.padd(spec, b3, x, y),
                 lambda: ck.padd_ref(spec, b3, x, y), 5, 1,
                 bound(9 * LIMB_BYTES * tree_w + LIMB_BYTES, 14 * tree_w)),
        "pdbl": (f"{nwin} points, one per MSM window (bucket sum)",
                 lambda: ck.pdbl(spec, b3, wins),
                 lambda: ck.pdbl_ref(spec, b3, wins), 100, 3,
                 bound(6 * LIMB_BYTES * nwin + LIMB_BYTES, 9 * nwin)),
    }
    time_cases(cases, results)
    del x, y
    time_scan(F, b3, pts, dev, results)


def time_cases(cases: dict, results: dict) -> None:
    """Each kernel against its plain version (exact), then both timed with
    CUDA events; the bound and the library time go beside them."""
    as_list = lambda r: [r] if torch.is_tensor(r) else list(r)
    for name, (shape, kern, plain, reps, preps, bnd) in cases.items():
        err = check_equal(f"{name} [{shape}]", as_list(kern()), as_list(plain()))
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms_k, ms_p = cuda_time_ms(kern, reps), cuda_time_ms(plain, preps)
        # no PyTorch call computes a 256-bit Montgomery product
        res.update(ms=ms_k, plain_ms=ms_p, library_ms=None, **bnd)
        log(f"# time {name} [{shape}]: exact vs plain; kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")


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

    # K1 over F_r at 2^20 elements; the first 16 are the crossed edges
    n = 1 << LOG_N
    a, b = random_fe(rng, n, dev), random_fe(rng, n, dev)
    a[:, :16], b[:, :16] = ea, eb
    got = limb.mont_mul(spec, a, b)
    err = check_equal("mont_mul (F_r)", [got], [limb.mont_mul_ref(spec, a, b)])
    ai, bi, gi = (limb.to_int(spec, t[:, :64]) for t in (a, b, got))
    rinv = pow(1 << 256, -1, p)
    if any(int(g) != int(x) * int(y) * rinv % p for g, x, y in zip(gi, ai, bi)):
        raise AssertionError("mont_mul (F_r): disagrees with the host on 64 elements")
    results["mont_mul"]["max_abs_err"] = max(results["mont_mul"]["max_abs_err"], err)
    log(f"# bitcheck mont_mul over F_r: 2^{LOG_N} elements + 16 edge pairs: exact")

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
    results["ntt_leaf"] = {"max_abs_err": err}
    log(f"# bitcheck ntt_leaf: the paths' leaves (E, m, B, inverse) "
        f"{sorted(set(leaf_shapes()))}; m = 16, 64, 128, E = 2, B = 3000, "
        f"forward and inverse: exact")

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
                     lambda: nk.ntt_leaf_ref(spec, xl, twl), 20, 1,
                     bound(2 * LIMB_BYTES * E * m * B + (m - 1) * LIMB_BYTES,
                           E * B * (m // 2) * (m.bit_length() - 1))),
        "butterfly": (f"(16, {R}, 1, {c}, 1): stage 0 of the batched "
                      f"2^{LOG_M_SMALL + 1}-point coset NTT",
                      lambda: nk.butterfly(spec, xb, twb),
                      lambda: nk.butterfly_ref(spec, xb, twb), 100, 3,
                      bound(4 * LIMB_BYTES * pairs + LIMB_BYTES * (c // 2), pairs)),
    }
    time_cases(cases, results)


# The 2^20 MSM's lanes, G * n / K (c = 16, G = 2, K = 64): the width of the
# bucket scan and of the lane merge's adds
SCAN_LANES = 1 << 15


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
    if min(counts.get(k, 0) for k in ("padd2", "pdbl2", "bucket_scan_rows2")) < 1:
        raise AssertionError(f"G2 MSM: K7, K8 or the G2 scan never launched: {counts}")
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
    (pk, vk), setup_counts = counted(lambda: pin.setup(qap, random.Random(SEED)))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: pin.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2")
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
    for k in ("padd2", "pdbl2", "bucket_scan_rows2"):
        results[k]["launches"] = prove_counts[k]
    log(f"# pinocchio m = 2^{LOG_M_PIN}: circuit {build_s:.3f} s; setup {setup_s:.3f} s; "
        f"prove first {first_s:.3f} s, median {med:.2f} ms of {[round(t, 2) for t in ts]}; "
        f"verify {verify_s:.3f} s (host): accepted; a wrong witness (one x_k "
        f"changed): rejected")
    log(f"# pinocchio setup launches: {json.dumps(setup_counts)}")
    log(f"# pinocchio prove launches: {json.dumps(prove_counts)}")

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
        # an add reads 12 coordinates and writes 6; 14 F_q2 products of 3
        # Montgomery products each, none on the lanes where h is set
        "padd2": (f"{m} lanes with h set on 1 in 32: one step of probe 13's loop",
                  lambda: L(ck.padd2(spec, b3, P, Q, h)),
                  lambda: L(ck.padd2_ref(spec, b3, P, Q, h)), 20, 1,
                  bound(18 * LIMB_BYTES * m + m + 2 * LIMB_BYTES, 42 * (m - heads))),
        # a double: 7 F_q2 products (3 each) and 2 squares (2 each)
        "pdbl2": (f"{m} lanes", lambda: L(ck.pdbl2(spec, b3, P)),
                  lambda: L(ck.pdbl2_ref(spec, b3, P)), 20, 1,
                  bound(12 * LIMB_BYTES * m + 2 * LIMB_BYTES, 25 * m)),
    }
    time_cases(cases, results)


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
    k2_ms = cuda_time_ms(lambda: ck.padd(spec, b31, Pt, Qt), 5)
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
    (pk, vk), setup_counts = counted(lambda: g16.setup(qap, npub, random.Random(SEED)))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: g16.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2")
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
    log(f"# groth16 m = 2^{LOG_M_G16}, {npub} public inputs: circuit {build_s:.3f} s; "
        f"setup {setup_s:.3f} s; prove first {first_s:.3f} s, median {med:.2f} ms of "
        f"{[round(t, 2) for t in ts]}; verify {verify_s:.3f} s (host pairing): accepted; "
        f"a wrong public input: rejected; a wrong witness (one x_k changed): rejected")
    log(f"# groth16 setup launches: {json.dumps(setup_counts)}")
    log(f"# groth16 prove launches: {json.dumps(prove_counts)}")
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


SOURCES = {
    "mont_mul": ("myzkp_tpu_torch/csrc/mont_mul.cu",
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
}


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    results = {k: {} for k in SOURCES}
    a, b = phase_bitcheck(dev, results)
    phase_bitcheck_g2(dev, results)
    phase_bitcheck_fr(dev, results)
    phase_slice(dev, results, a, b)
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
    phase_g2_msm(dev, results)
    phase_pinocchio(dev, results)
    time_g2_kernels(dev, results)
    phase_mixed_add(dev, results)
    phase_groth16(dev, results)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
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
    log(f"# probe13 {json.dumps(results['_probe13'])}")
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
