"""Pinocchio scaling benchmark on square-chain circuits.

    python -m myzkp_tpu_torch.snark.cli [log2_m ...] [--g2 pippenger] [--mesh D] [--device DEV]

The port's ``examples/pinocchio_bench.py``: for each size (default 10 12 14)
it builds the m-constraint squaring chain (``arith/sparse.square_chain``),
runs the trusted setup, proves (device MSMs and the coset NTT's quotient),
verifies on the host (the C++ multi-pairing), and prints each phase's
seconds.  It runs on the card unless ``--device`` names another device
(``--device cpu``).  ``--mesh D`` proves with the mesh prover
(``pinocchio.prove_mesh``) over D ranks: ``parallel/mesh.run_ranks`` spawns
them, or takes them from ``torchrun``, and prints the backend; every rank
builds the circuit and the key from the same seed, proves and verifies, and
rank 0's seconds are printed with the mesh's shape (m >= D^2).
``--g2 pippenger`` is the G2 MSM the prover always runs; ``--g2 naive`` (the
reference's chunked naive G2 ladder, a TPU compile trade) is refused with a
message, never ignored.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from .. import _ext
from ..arith.sparse import SparseQAP, square_chain
from ..curves import bn254
from ..parallel import mesh as pm
from . import pinocchio


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench(log2_m: int, device=None, mesh=None) -> dict:
    """Circuit, setup, prove and verify seconds at m = 2^log2_m, the prove
    over ``mesh``'s ranks when given; raises if the verifier rejects the
    proof."""
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
    proof = pinocchio.prove(assignment, pk, qap, rng=rng, mesh=mesh)
    _sync(dev)
    t3 = time.perf_counter()
    ok = pinocchio.verify(proof, vk)
    t4 = time.perf_counter()
    if not ok:
        raise RuntimeError(f"m = 2^{log2_m}: the verifier rejected the proof")
    return {"m": m, "circuit_s": round(t1 - t0, 3), "setup_s": round(t2 - t1, 3),
            "prove_s": round(t3 - t2, 3), "verify_s": round(t4 - t3, 3)}


def _bench_ranks(mesh, sizes: list) -> list:
    """One rank of ``--mesh D``: ``bench`` of each size over the mesh."""
    return [bench(k, pm.mesh_device(mesh), mesh) for k in sizes]


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
    if args.mesh is None:
        runs = ([bench(k, args.device)] for k in args.log2_m)
        tag = ""
    else:
        runs = [pm.run_ranks(_bench_ranks, args.mesh, args.log2_m, device=args.device)]
        tag = f" (mesh=({args.mesh},))"
    for rs in runs:
        for r in rs or ():  # None on the ranks but 0 under torchrun
            print(f"m=2^{r['m'].bit_length() - 1}{tag}: circuit {r['circuit_s']}s  "
                  f"setup {r['setup_s']}s  prove {r['prove_s']}s  verify {r['verify_s']}s",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
