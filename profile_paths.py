#!/usr/bin/env python3
"""Device-time profile of one call of a path of the port on one GPU.

Run from the repository root:
    python3 profile_paths.py [--path msm|ntt|shifted_h|prove|groth16|groth16-mesh|sumcheck|stark]
                             [--log-n 20] [--ranks 4]

Paths: ``msm``, one BN254 G1 MSM of 2^log_n points (made with
fixed_base_multi from seeded scalars); ``ntt``, one forward NTT of 2^log_n
seeded F_r elements; ``shifted_h``, the prover's quotient stage
get_shifted_h on square_chain(2^log_n); ``prove``, one Pinocchio prove on
square_chain(2^log_n) with a key from a seeded setup (the setup is not
profiled); ``groth16``, one Groth16 prove the same way, with 2 public
inputs; ``groth16-mesh``, one prove of the cell ``mesh-g16-sq25-4chip``'s
entry (``zkbench/entries/groth16_mesh_prove.py``: the split-key mesh
Groth16 prover over a ``parallel/mesh.RankPool`` of ``--ranks`` ranks, a
card each), profiled on rank 0, this process, which also holds card 0;
``sumcheck``, one prove of the table sumcheck prover over a
2^log_n-point hypercube (log_n variables), on the sumcheck demo's problem
(examples/sumcheck_demo.py: three multilinear factors of 8 seeded terms,
degree 3); ``stark``, one FastStark prove over M128 on the JAX package's
squaring AIR (one register, x_(i+1) = x_i^2) at 2^(log_n - 4) - 8 cycles,
so that the FRI domain has 2^log_n points (the preprocessed zerofier made
once, before the call).  Builds the kernels, runs the call
twice to warm up and a third time under torch.profiler.  Prints the card
(nvidia-smi name and power limit), the wall time of the profiled call (host
clock, synchronized), the device busy time (the sum of the durations of every
device event: kernels, copies, memsets; one stream, so they do not overlap),
the idle share 1 - busy / wall, the device memory allocated before and at
the peak of the call, the kernel launch counts, and the device time by
kernel name.  The profiler's own overhead is inside the wall time, so the
idle share is an upper bound.

The port marks its stages with spans (``myzkp_tpu_torch/utils/metrics.py``),
ranges named ``myzkp:<name>`` on the profiler's clock: for Groth16 and
Pinocchio the quotient stage, the digits' sort, the scan's inputs (with the
scan and the lane merge inside), the bucket scan, the lane merge, the
bucket sums, Horner, the ladders, the conversion to affine, and each host
read; for the sumcheck prover the table build (the hypercube inside), each
round and in it each evaluation point's fold, product, sum and host read,
the transcript and the bind at the challenge; for the FastStark prove the
trace interpolation, the boundary quotients, the codewords, the symbolic
AIR, the transition quotients, the combination codeword, FRI and the
openings, with the long divisions (K17), the Merkle trees' builds (host
SHA3) and the host reads inside them; for the mesh prover also its split
set-up (``key block``), the pool's ``job dispatch`` and each collective
(``all gather``, ``all to all``, ``broadcast``).  The span table gives per span its
calls, its host ms (the ranges' time, the spans nested in them included),
the device ms and count of the events launched in it (each put in the
innermost span holding the CUDA API call that launched it, matched by
correlation id), and the idle ms (each gap between device events put in the
innermost span holding its midpoint); "(none)" is what lies outside every
span.  Last come the device ms matched to no launch call, the span entries
in the call, and what an entry costs on the host with and without a
profiler recording.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import json
import random
import subprocess
import time
import timeit

import numpy as np
import torch

from myzkp_tpu_torch.utils.metrics import PREFIX, span


def _mesh_path(n: int, seed: int, ranks: int, dev):
    """The cell's entry over a pool of ``ranks`` ranks: the witness chain,
    the circuit and the split key from the seed, once; the call is one
    prove of the chain's first statement."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.parallel import mesh as pm
    from zkbench.entries import groth16_mesh_prove as entry

    rng = random.Random(seed)
    toxic = tuple(rng.randrange(1, bn254.R) for _ in range(5))
    x0, rs = rng.randrange(2, bn254.R), (rng.randrange(1, bn254.R), rng.randrange(1, bn254.R))
    pool = pm.RankPool(ranks, device=dev, timeout=600)
    atexit.register(pool.close)
    pool.run(entry.job_inputs, n, 1, x0)
    pool.run(entry.job_keys, 2, toxic)
    return (lambda: pool.run(entry.job_prove, 1, 0, rs),
            f"groth16 mesh prove m = {n} over {ranks} ranks (rank 0's trace)")


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

    if name == "stark":
        from myzkp_tpu_torch.fields.spec import m128_spec
        from myzkp_tpu_torch.ops.mpoly import MPoly
        from myzkp_tpu_torch.stark import fast_stark

        p, cycles, x0 = m128_spec().p, (n >> 4) - 8, 123456789
        stark = fast_stark.initialize_fast_stark_m128(4, 2, 2, 1, cycles, 2, dev)
        trace = [[x0]]
        for _ in range(cycles - 1):
            trace.append([trace[-1][0] ** 2 % p])
        var = MPoly.variables(stark.spec, 3)
        air, boundary = [var[1] ** 2 - var[2]], [(0, 0, x0), (cycles - 1, 0, trace[-1][0])]
        pre = stark.preprocess()
        return (lambda: stark.prove(trace, boundary, air, preprocessed=pre,
                                    rng=random.Random(seed)),
                f"FastStark prove, {cycles} cycles, FRI domain {stark.fri.domain_length}")
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


def span_events(prof) -> tuple:
    """(device events, spans, launch calls, window) of a finished
    torch.profiler run, in us on the profiler's clock: device events
    (name, start, end, correlation id), the kernels, copies and memsets;
    spans (name, start, end), the port's ``myzkp:`` ranges with the prefix
    cut; launch calls (correlation id, start), the host's CUDA API calls
    (``cuda*``, ``cu*``); the window from the first event's start to the
    last one's end."""
    from torch.autograd import DeviceType

    device, spans, launches, t0, t1 = [], [], [], float("inf"), float("-inf")
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        t0, t1 = min(t0, start), max(t1, end)
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, start, end, ev.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end))
        elif name.startswith("cu"):
            launches.append((ev.correlation_id(), start))
    return device, spans, launches, (t0, t1)


def _innermost(times, spans) -> list:
    """The name of the innermost span holding each of ``times`` (None
    outside every span), in the order of ``times``; the spans nest (one
    host thread)."""
    ranges = sorted(spans, key=lambda r: (r[1], -r[2]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(ranges) and ranges[i][1] <= t:
            while stack and stack[-1][2] <= ranges[i][1]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[k] = stack[-1][0] if stack else None
    return out


def span_table(device, spans, launches, window) -> tuple:
    """({span: {calls, host_ms, device_ms, idle_ms, launches}}, unmatched
    device ms) over ``window``, from ``span_events``' lists.

    host_ms: the span's ranges' time, inclusive of the spans nested in
    them.  A device event is put in the innermost span holding the launch
    call of its correlation id (device_ms, launches); one with no launch
    call is unmatched.  The idle gaps between the device events (their
    union inside the window) are put in the innermost span holding each
    gap's midpoint.  What lies outside every span is the row "(none)"."""
    w0, w1 = window
    table = {}

    def row(name):
        return table.setdefault(name or "(none)", {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                                  "idle_ms": 0.0, "launches": 0})

    for name, s, e in spans:
        r = row(name)
        r["calls"] += 1
        r["host_ms"] += (e - s) / 1e3
    at = dict(launches)
    inside = [(s, e, c) for _, s, e, c in device if min(e, w1) > max(s, w0)]
    matched = [(s, e, c) for s, e, c in inside if c in at]
    for (s, e, _), name in zip(matched, _innermost([at[c] for *_, c in matched], spans)):
        r = row(name)
        r["device_ms"] += (min(e, w1) - max(s, w0)) / 1e3
        r["launches"] += 1
    unmatched = sum(min(e, w1) - max(s, w0) for s, e, c in inside if c not in at) / 1e3
    gaps, t = [], w0
    for s, e, _ in sorted(inside):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    for (s, e), name in zip(gaps, _innermost([(s + e) / 2 for s, e in gaps], spans)):
        row(name)["idle_ms"] += (e - s) / 1e3
    return table, unmatched


def span_cost(acts, n: int = 100_000) -> tuple:
    """us a ``with span(...)`` entry takes on the host: with no profiler
    recording, and under one recording ``acts``."""

    def entry():
        with span("cost"):
            pass

    off = timeit.timeit(entry, number=n) / n * 1e6
    with torch.profiler.profile(activities=acts):
        on = timeit.timeit(entry, number=n // 10) / (n // 10) * 1e6
    return off, on


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("msm", "ntt", "shifted_h", "prove", "groth16",
                                       "groth16-mesh", "sumcheck", "stark"),
                    default="msm")
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ranks", type=int, default=4)
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
    if args.path == "groth16-mesh":
        call, what = _mesh_path(1 << args.log_n, args.seed, args.ranks, dev)
    else:
        call, what = _path(args.path, 1 << args.log_n, args.seed, dev)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    _ext.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mib = torch.cuda.memory_allocated(dev) / 2**20
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
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
    table, unmatched_ms = span_table(*span_events(prof))
    print(f"# {'calls':>6} {'host ms':>12} {'busy ms':>12} {'idle ms':>12} {'events':>7}  span")
    for name, r in sorted(table.items(), key=lambda kv: -kv[1]["host_ms"]):
        print(f"# {r['calls']:6d} {r['host_ms']:12.4f} {r['device_ms']:12.4f} "
              f"{r['idle_ms']:12.4f} {r['launches']:7d}  {name}")
    entries = sum(r["calls"] for r in table.values())
    off_us, on_us = span_cost(acts)
    print(f"# unmatched device ms {unmatched_ms} ({unmatched_ms / busy_ms:.4%} of busy); "
          f"{entries} span entries, at {off_us} us each with no profiler recording and "
          f"{on_us} us under one (host clock)")
    print(f"# spans {json.dumps(table)}")

if __name__ == "__main__":
    main()
