"""Pinocchio scaling benchmark on square-chain circuits.

    python -m myzkp_tpu_torch.snark.cli [log2_m ...] [--g2 pippenger] [--device DEV]

The port's ``examples/pinocchio_bench.py``: for each size (default 10 12 14)
it builds the m-constraint squaring chain (``arith/sparse.square_chain``),
runs the trusted setup, proves (device MSMs and the coset NTT's quotient),
verifies on the host (the C++ multi-pairing), and prints each phase's
seconds.  It runs on the card unless ``--device`` names another device
(``--device cpu``).  ``--g2 pippenger`` is the G2 MSM the prover always
runs; ``--g2 naive`` (the reference's chunked naive G2 ladder, a TPU compile
trade) and ``--mesh D`` (the mesh-distributed prover, which waits for the
port of ``parallel/mesh.py``) are refused with a message, never ignored.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from .. import _ext
from ..arith.sparse import SparseQAP, square_chain
from ..curves import bn254
from . import pinocchio


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench(log2_m: int, device=None) -> dict:
    """Circuit, setup, prove and verify seconds at m = 2^log2_m; raises if
    the verifier rejects the proof."""
    dev = _ext.resolve_device(device)
    m = 1 << log2_m
    rng = random.Random(42)
    t0 = time.perf_counter()
    r1cs, assignment = square_chain(bn254.r_spec(), m, device=dev)
    qap = SparseQAP(r1cs)
    _sync(dev)
    t1 = time.perf_counter()
    pk, vk = pinocchio.setup(qap, rng=rng)
    _sync(dev)
    t2 = time.perf_counter()
    proof = pinocchio.prove(assignment, pk, qap, rng=rng)
    t3 = time.perf_counter()
    ok = pinocchio.verify(proof, vk)
    t4 = time.perf_counter()
    if not ok:
        raise RuntimeError(f"m = 2^{log2_m}: the verifier rejected the proof")
    return {"m": m, "circuit_s": round(t1 - t0, 3), "setup_s": round(t2 - t1, 3),
            "prove_s": round(t3 - t2, 3), "verify_s": round(t4 - t3, 3)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m myzkp_tpu_torch.snark.cli")
    parser.add_argument("log2_m", type=int, nargs="*", default=[10, 12, 14])
    parser.add_argument("--g2", default="pippenger", choices=("pippenger", "naive"))
    parser.add_argument("--mesh", type=int, default=None, metavar="D")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if args.g2 == "naive":
        parser.error("--g2 naive: the chunked naive G2 ladder is TPU-only and was not "
                     "ported; the prover's G2 MSMs are Pippenger's")
    if args.mesh is not None:
        parser.error(f"--mesh {args.mesh}: the mesh-distributed prover needs "
                     f"parallel/mesh.py, which is not ported yet")
    for k in args.log2_m:
        r = bench(k, args.device)
        print(f"m=2^{k}: circuit {r['circuit_s']}s  setup {r['setup_s']}s  "
              f"prove {r['prove_s']}s  verify {r['verify_s']}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
