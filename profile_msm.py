#!/usr/bin/env python3
"""Device-time profile of one BN254 G1 MSM of the port on one GPU.

Run from the repository root:  python3 profile_msm.py [--log-n 20]

Builds the kernels, makes 2^log_n points with fixed_base_multi from seeded
scalars, runs msm.msm twice to warm up and a third time under torch.profiler.
Prints the card (nvidia-smi name and power limit), the wall time of the
profiled MSM (host clock, synchronized), the device busy time (the sum of the
durations of every device event: kernels, copies, memsets; one stream, so
they do not overlap), the idle share 1 - busy / wall, the kernel launch
counts, and the device time by kernel name.  The profiler's own overhead is
inside the wall time, so the idle share is an upper bound.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_msm: torch.cuda.is_available() is False")
    from torch.autograd import DeviceType

    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, fixed_base, msm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _ext.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    n = 1 << args.log_n

    def scalars():  # uniform limbs, top limb below r's: every value < r
        limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        limbs[15] = rng.integers(0, 0x3064, size=n)
        return torch.from_numpy(limbs.astype(np.int32)).to(dev)

    pts = fixed_base.fixed_base_multi("g1", scalars())
    ks = scalars()
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    for _ in range(2):
        msm.msm(F, b3, pts, ks)
    torch.cuda.synchronize()
    _ext.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        msm.msm(F, b3, pts, ks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.self_device_time_total / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    print(f"# msm 2^{args.log_n} (c = {msm.default_window(n)}): wall {wall_ms} ms "
          f"under the profiler; device busy {busy_ms} ms; "
          f"idle share {1 - busy_ms / wall_ms}")
    print(f"# launches: {json.dumps(dict(_ext.launches))}")
    print(f"# {'device ms':>12} {'share':>7} {'calls':>6}  kernel")
    for name, (calls, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"# {ms:12.4f} {ms / busy_ms:7.2%} {calls:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
