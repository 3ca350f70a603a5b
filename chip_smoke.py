#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (myzkp_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one output line each (or more), in order:
  1. device    the card (nvidia-smi name and power limit), torch, nvcc;
  2. build     the four CUDA kernels from myzkp_tpu_torch/csrc/ with nvcc;
  3. bitcheck  each kernel against its plain PyTorch version on the card,
               exact equality of limbs (the tolerance is 0: modular integers);
  4. slice     the main path: fixed-base setup of 2^20 points [m_i]G, then the
               2^20 Pippenger MSM against 2^20 scalars k_i, checked against
               the host's [sum k_i m_i mod r]G; kernel launch counts of that
               run; the MSM timed; msm_pippenger at n = 2^16 with c = 14,
               checked the same way; each kernel timed beside its plain
               version at the slice's shapes.
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
    from myzkp_tpu_torch import _ext

    seconds = _ext.build()
    _ext.library()
    log(f"# build: {len(list(_ext.CSRC.glob('*.cu')))} sources -> "
        f"{_ext.library_path().name} in {seconds:.2f} s")
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

    # K4 at N = 3000 lanes (ragged), K = 4, all four tags
    N, K = 3000, 4
    rows, _ = msm._rows_of_point(tuple(c[:, :K * N] for c in P))
    tag = torch.from_numpy(rng.integers(0, 4, K * N).astype(np.int32)).to(dev)
    tag[:8] = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], dtype=torch.int32)
    acc, flush = ck.bucket_scan_rows(spec, rows, tag, b3, K)
    acc_r, flush_r = ck.bucket_scan_rows_ref(spec, rows, tag, b3, K)
    err = check_equal("bucket_scan_rows", [acc, flush], [acc_r, flush_r])
    results["bucket_scan_rows"] = {"max_abs_err": err}
    log(f"# bitcheck bucket_scan_rows: N = {N} lanes, K = {K}, tags 0-3: "
        f"acc and flush exact")
    return a, b


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
    counts = dict(_ext.launches)
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
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msm.msm(F, b3, pts, k_limbs)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    results["_msm"] = {"ms": med * 1e3, "reps_ms": [t * 1e3 for t in ts],
                       "points_per_s": n / med, "fixed_base_s": fb_s}
    log(f"# slice msm 2^{LOG_N}: median {med * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in ts]} -> {n / med:,.0f} points/s")

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
    G = msm._group_size(n, -(-256 // c), (1 << (c - 1)) + 2)
    K = int(min(n, max(8, msm._next_pow2(G * n // (1 << 15)))))
    lanes = G * n // K
    tree_w = (W // 2) * fixed_base._CHUNK  # first tree level of one chunk
    x = tuple(cc.repeat(1, -(-tree_w // n))[:, :tree_w].contiguous() for cc in pts)
    y = tuple(torch.roll(cc, 1, dims=1) for cc in x)
    nwin = -(-256 // c)  # MSM windows: the bucket sum's and Horner's width
    wins = tuple(cc[:, :nwin].contiguous() for cc in x)
    rows, _ = msm._rows_of_point(tuple(cc.repeat(1, G) for cc in pts))  # G * n
    # a segment head every 32 steps: heads are a few percent of the digits
    tag = (torch.arange(K * lanes, device=dev, dtype=torch.int32) % 32 == 0).int() << 1
    tm = a[:, :W * slots].contiguous(), b[:, :W * slots].contiguous()
    cases = {
        "mont_mul": (f"(16, {W * slots}) table to_mont",
                     lambda: limb.mont_mul(spec, *tm),
                     lambda: limb.mont_mul_ref(spec, *tm), 100, 3),
        "padd": (f"{tree_w} points, first fixed-base tree level",
                 lambda: ck.padd(spec, b3, x, y),
                 lambda: ck.padd_ref(spec, b3, x, y), 5, 1),
        "pdbl": (f"{nwin} points, one per MSM window (bucket sum)",
                 lambda: ck.pdbl(spec, b3, wins),
                 lambda: ck.pdbl_ref(spec, b3, wins), 100, 3),
        "bucket_scan_rows": (f"K = {K}, N = {lanes} lanes",
                             lambda: ck.bucket_scan_rows(spec, rows, tag, b3, K),
                             lambda: ck.bucket_scan_rows_ref(spec, rows, tag, b3, K),
                             5, 1),
    }
    as_list = lambda r: [r] if torch.is_tensor(r) else list(r)
    for name, (shape, kern, plain, reps, preps) in cases.items():
        err = check_equal(f"{name} [{shape}]", as_list(kern()), as_list(plain()))
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms_k, ms_p = cuda_time_ms(kern, reps), cuda_time_ms(plain, preps)
        res.update(ms=ms_k, plain_ms=ms_p)
        log(f"# time {name} [{shape}]: exact vs plain; kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms")


SOURCES = {
    "mont_mul": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                 "myzkp_tpu/fields/limb_pallas.py:286"),
    "padd": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:322"),
    "pdbl": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:340"),
    "bucket_scan_rows": ("myzkp_tpu_torch/csrc/bucket_scan.cu",
                         "myzkp_tpu/curves/curve_pallas.py:425"),
}


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    results = {k: {} for k in SOURCES}
    a, b = phase_bitcheck(dev, results)
    phase_slice(dev, results, a, b)
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": results[k]["launches"],
                "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"]}
               for k in SOURCES]
    log(f"# msm {json.dumps(results['_msm'])}")
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
