#!/usr/bin/env python3
"""Device-time profile of one call of a path of the port on one GPU.

Run from the repository root:
    python3 profile_paths.py [--path msm|ntt|shifted_h|prove|groth16] [--log-n 20]

Paths: ``msm``, one BN254 G1 MSM of 2^log_n points (made with
fixed_base_multi from seeded scalars); ``ntt``, one forward NTT of 2^log_n
seeded F_r elements; ``shifted_h``, the prover's quotient stage
get_shifted_h on square_chain(2^log_n); ``prove``, one Pinocchio prove on
square_chain(2^log_n) with a key from a seeded setup (the setup is not
profiled); ``groth16``, one Groth16 prove the same way, with 2 public
inputs.  Builds the kernels, runs the call
twice to warm up and a third time under torch.profiler.  Prints the card
(nvidia-smi name and power limit), the wall time of the profiled call (host
clock, synchronized), the device busy time (the sum of the durations of every
device event: kernels, copies, memsets; one stream, so they do not overlap),
the idle share 1 - busy / wall, the device memory allocated before and at
the peak of the call, the kernel launch counts, and the device time by
kernel name.  The profiler's own overhead is inside the wall time, so the
idle share is an upper bound.
"""

from __future__ import annotations

import argparse
import collections
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("msm", "ntt", "shifted_h", "prove", "groth16"),
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
    print(f"# {what}: wall {wall_ms} ms under the profiler; device busy "
          f"{busy_ms} ms; idle share {1 - busy_ms / wall_ms}")
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"# device memory: {base_mib} MiB held before the call, peak "
          f"{peak_mib} MiB during it")
    print(f"# launches: {json.dumps(dict(_ext.launches))}")
    print(f"# {'device ms':>12} {'share':>7} {'calls':>6}  kernel")
    for name, (calls, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"# {ms:12.4f} {ms / busy_ms:7.2%} {calls:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
