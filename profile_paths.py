#!/usr/bin/env python3
"""Device-time profile of one call of a path of the port on one GPU.

Run from the repository root:
    python3 profile_paths.py [--path msm|ntt|shifted_h|prove|groth16|sumcheck] [--log-n 20]

Paths: ``msm``, one BN254 G1 MSM of 2^log_n points (made with
fixed_base_multi from seeded scalars); ``ntt``, one forward NTT of 2^log_n
seeded F_r elements; ``shifted_h``, the prover's quotient stage
get_shifted_h on square_chain(2^log_n); ``prove``, one Pinocchio prove on
square_chain(2^log_n) with a key from a seeded setup (the setup is not
profiled); ``groth16``, one Groth16 prove the same way, with 2 public
inputs; ``sumcheck``, one prove of the table sumcheck prover over a
2^log_n-point hypercube (log_n variables), on the sumcheck demo's problem
(examples/sumcheck_demo.py: three multilinear factors of 8 seeded terms,
degree 3).  Builds the kernels, runs the call
twice to warm up and a third time under torch.profiler.  Prints the card
(nvidia-smi name and power limit), the wall time of the profiled call (host
clock, synchronized), the device busy time (the sum of the durations of every
device event: kernels, copies, memsets; one stream, so they do not overlap),
the idle share 1 - busy / wall, the device memory allocated before and at
the peak of the call, the kernel launch counts, and the device time by
kernel name.  The profiler's own overhead is inside the wall time, so the
idle share is an upper bound.

The prover's stages run inside ``torch.profiler.record_function`` ranges
named ``stage:<name>`` (set here by wrapping the functions in STAGES for the
profiled call only): the quotient stage, the digits' sort, the scan's
inputs (each step's index, tag and target, and the bucket table), the bucket
scan, the lane merge, the window sums
(bucket sums), Horner, the double-and-add ladders, and the conversion of
points to affine (one batch inversion each: the proof's points on their way
to the host); for the sumcheck prover, the table build (and within it the
hypercube), the folds, the pointwise products, the table sums, the
transcript (pushes, hashes, challenges and the round polynomials'
interpolation on the host) and the rounds (the rest of the prove: the
loop and its host reads of the sums).  Each device event is
put in the innermost stage whose range holds the host call that launched it
(its CUDA runtime call, matched by correlation id), and each stage's host
time is its ranges' time less the stages nested in them; the table gives per
stage the host ms, device busy ms and idle share 1 - busy / host.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import random
import subprocess
import time

import numpy as np
import torch


def _path(name: str, n: int, seed: int, dev):
    """The call to profile and a line naming it."""
    rng = np.random.default_rng(seed)

    def field_elems():  # uniform limbs, top limb below r's: every value < r
        limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        limbs[15] = rng.integers(0, 0x3064, size=n)
        return torch.from_numpy(limbs.astype(np.int32)).to(dev)

    if name == "msm":
        from myzkp_tpu_torch.curves import bn254, fixed_base, msm

        pts = fixed_base.fixed_base_multi("g1", field_elems())
        ks = field_elems()
        F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
        return (lambda: msm.msm(F, b3, pts, ks),
                f"msm n = {n} (c = {msm.default_window(n)})")
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import bn254_r_spec

    spec = bn254_r_spec()
    if name == "sumcheck":
        from myzkp_tpu_torch.ops.mpoly import MPoly
        from myzkp_tpu_torch.protocols.sumcheck_tpu import SumCheckProverTPU

        num_vars, prng = n.bit_length() - 1, random.Random(seed)
        factors = [MPoly(spec, {tuple(prng.randint(0, 1) for _ in range(num_vars)):
                                prng.randrange(spec.p) for _ in range(8)})
                   for _ in range(3)]
        prover = SumCheckProverTPU(spec, 3, dev)
        return (lambda: prover.prove(factors, num_vars),
                f"sumcheck table prove over 2^{num_vars} points (3 factors x 8 terms)")
    if name == "ntt":
        from myzkp_tpu_torch.ops import ntt

        a = Fp(spec, field_elems())
        return lambda: ntt.ntt(a), f"ntt n = {n}"
    from myzkp_tpu_torch.arith import sparse
    from myzkp_tpu_torch.snark import groth16, pinocchio

    r1cs, asg = sparse.square_chain(spec, n, device=dev)
    qap = sparse.SparseQAP(r1cs)
    if name == "groth16":
        pk, _ = groth16.setup(qap, 2, random.Random(seed))
        return (lambda: groth16.prove(asg, pk, qap, random.Random(seed + 1)),
                f"groth16 prove m = {n}")
    if name == "prove":
        pk, _ = pinocchio.setup(qap, random.Random(seed))
        return (lambda: pinocchio.prove(asg, pk, qap, random.Random(seed + 1)),
                f"prove m = {n}")
    deltas = [int(v) for v in rng.integers(1, 1 << 62, 3)]
    return (lambda: pinocchio.get_shifted_h(qap, asg, *deltas),
            f"shifted_h m = {n}")


# (stage, module, attribute): the function whose calls make up the stage; an
# attribute "Class.method" wraps the method on the class.
STAGES = (
    ("quotient", "myzkp_tpu_torch.snark.pinocchio", "get_shifted_h"),
    ("quotient", "myzkp_tpu_torch.arith.sparse", "SparseQAP.combine_batched"),
    ("quotient", "myzkp_tpu_torch.arith.sparse", "SparseQAP.quotient"),
    ("sort", "myzkp_tpu_torch.curves.msm", "_sorted_digits"),
    ("scan inputs", "myzkp_tpu_torch.curves.msm", "_bucket_accumulate"),
    ("scan", "myzkp_tpu_torch.curves.curve_kernels", "bucket_scan_rows"),
    ("scan", "myzkp_tpu_torch.curves.curve_kernels", "bucket_scan_rows2"),
    ("lane merge", "myzkp_tpu_torch.curves.msm", "_merge_lane_partials"),
    ("bucket sum", "myzkp_tpu_torch.curves.msm", "_window_sums"),
    ("horner", "myzkp_tpu_torch.curves.msm", "_horner"),
    ("ladder", "myzkp_tpu_torch.curves.weierstrass", "scalar_mul_bits"),
    ("to affine", "myzkp_tpu_torch.curves.weierstrass", "to_affine"),
    ("rounds", "myzkp_tpu_torch.protocols.sumcheck_tpu", "SumCheckProverTPU.prove"),
    ("table build", "myzkp_tpu_torch.protocols.sumcheck_tpu", "eval_all_binary_combinations"),
    ("hypercube", "myzkp_tpu_torch.protocols.sumcheck_tpu", "hypercube_points"),
    ("fold", "myzkp_tpu_torch.protocols.sumcheck_tpu", "fold_into_half"),
    ("product", "myzkp_tpu_torch.protocols.sumcheck_tpu", "fold_factors_pointwise"),
    ("sum", "myzkp_tpu_torch.protocols.sumcheck_tpu", "table_sum"),
    ("transcript", "myzkp_tpu_torch.protocols.sumcheck_tpu", "_push_ints"),
    ("transcript", "myzkp_tpu_torch.protocols.sumcheck_tpu", "sample_field"),
    ("transcript", "myzkp_tpu_torch.protocols.sumcheck_tpu", "_host_interpolate"),
    ("transcript", "myzkp_tpu_torch.utils.fiat_shamir", "FiatShamirTransformer.prover_fiat_shamir"),
)


@contextlib.contextmanager
def stage_ranges():
    """Wrap each function of STAGES in a record_function range while the
    block runs; callers reach them through their module or class, so the
    wrappers are seen."""
    saved = []
    for stage, module, attr in STAGES:
        owner = importlib.import_module(module)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        fn = owner.__dict__[name]

        def wrapped(*a, _fn=fn, _label=f"stage:{stage}", **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def stage_split(events, wall_ms: float) -> dict:
    """{stage: [host ms, device busy ms, device events]} over the profiled
    call, with "(none)" for what lies outside every stage.  events:
    prof.events(); the ranges nest (one host thread)."""
    from torch.autograd import DeviceType

    ranges = sorted(((e.time_range.start, e.time_range.end, e.name[len("stage:"):])
                     for e in events
                     if e.device_type == DeviceType.CPU and e.name.startswith("stage:")),
                    key=lambda r: (r[0], -r[1]))
    out = collections.defaultdict(lambda: [0.0, 0.0, 0])
    open_ = []  # the ranges holding the current one, outermost first
    for s0, e0, name in ranges:
        while open_ and open_[-1][1] <= s0:
            open_.pop()
        out[name][0] += (e0 - s0) / 1e3
        if open_:
            out[open_[-1][2]][0] -= (e0 - s0) / 1e3
        open_.append((s0, e0, name))
    out["(none)"][0] = wall_ms - sum(v[0] for v in out.values())
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}

    def innermost(t):
        held = [r for r in ranges if r[0] <= t <= r[1]]
        return max(held, key=lambda r: (r[0], -r[1]))[2] if held else "(none)"

    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:"):
            t = launched.get(e.id)
            stage = innermost(t) if t is not None else "(unmatched)"
            out[stage][1] += e.self_device_time_total / 1e3
            out[stage][2] += 1
    return dict(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("msm", "ntt", "shifted_h", "prove", "groth16",
                                       "sumcheck"),
                    default="msm")
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda.is_available() is False")
    from torch.autograd import DeviceType

    from myzkp_tpu_torch import _ext

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _ext.build()
    dev = torch.device("cuda", 0)
    call, what = _path(args.path, 1 << args.log_n, args.seed, dev)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    _ext.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mib = torch.cuda.memory_allocated(dev) / 2**20
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with stage_ranges(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        # the ranges' own device-timeline spans are not device work
        if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:"):
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.self_device_time_total / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    events = sum(calls for calls, _ in by_name.values())
    print(f"# {what}: wall {wall_ms} ms under the profiler; device busy "
          f"{busy_ms} ms in {events} device events; idle share {1 - busy_ms / wall_ms}")
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"# device memory: {base_mib} MiB held before the call, peak "
          f"{peak_mib} MiB during it")
    print(f"# launches: {json.dumps(dict(_ext.launches))}")
    print(f"# {'device ms':>12} {'share':>7} {'calls':>6}  kernel")
    for name, (calls, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"# {ms:12.4f} {ms / busy_ms:7.2%} {calls:6d}  {name[:100]}")
    split = stage_split(prof.events(), wall_ms)
    print(f"# {'host ms':>12} {'busy ms':>12} {'idle':>7} {'events':>7}  stage")
    for name, (host, busy, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        idle = f"{1 - busy / host:7.3f}" if host > 0 else f"{'-':>7}"
        print(f"# {host:12.4f} {busy:12.4f} {idle} {n:7d}  {name}")
    print(f"# stages {json.dumps(split)}")


if __name__ == "__main__":
    main()
