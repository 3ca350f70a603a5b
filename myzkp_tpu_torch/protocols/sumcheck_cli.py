"""Sumcheck demo: the table prover against the host mirror, verified.

    python -m myzkp_tpu_torch.protocols.sumcheck_cli [--host] [--device DEV]

The port's ``examples/sumcheck_demo.py`` (the reference's CPU / GPU sumcheck
example, three random multilinear factors of 8 terms over ``SUMCHECK_VARS``
variables, default 8, from ``random.Random(45)``): ``--host`` proves with the
host mirror instead of the table prover, the other prover's claimed sum is
checked against it, and the verifier must accept.  The table prover runs on
the card unless ``--device`` names another device (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import random
import time

from ..curves import bn254
from ..ops.mpoly import MPoly
from .sumcheck_tpu import SumCheckProverHost, SumCheckProverTPU, SumCheckVerifier

NUM_FACTORS = 3
SEED = 45


def demo_factors(spec, num_vars: int, rng: random.Random) -> list:
    """NUM_FACTORS multilinear MPolys of 8 random terms each."""
    factors = []
    for _ in range(NUM_FACTORS):
        d = {}
        for _ in range(8):
            exps = tuple(rng.randint(0, 1) for _ in range(num_vars))
            d[exps] = rng.randrange(bn254.R)
        factors.append(MPoly(spec, d))
    return factors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m myzkp_tpu_torch.protocols.sumcheck_cli")
    parser.add_argument("--host", action="store_true", help="prove with the host mirror")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    num_vars = int(os.environ.get("SUMCHECK_VARS", 8))
    spec = bn254.r_spec()
    factors = demo_factors(spec, num_vars, random.Random(SEED))

    table = SumCheckProverTPU(spec, NUM_FACTORS, device=args.device)
    host = SumCheckProverHost(spec, NUM_FACTORS)
    prover, other = (host, table) if args.host else (table, host)
    t0 = time.perf_counter()
    proof = prover.prove(factors, num_vars)
    prove_time = time.perf_counter() - t0
    print(f"prover={'host' if args.host else 'table'} vars={num_vars} "
          f"claimed_sum={proof.claimed_sum} prove_time={prove_time:.3f}s")
    if other.prove(factors, num_vars).claimed_sum != proof.claimed_sum:
        raise RuntimeError("the two provers' claimed sums differ")
    t0 = time.perf_counter()
    ok = SumCheckVerifier(spec).verify(proof, factors)
    print(f"verified={ok} verify_time={time.perf_counter() - t0:.3f}s")
    if not ok:
        raise RuntimeError("the verifier rejected the proof")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
