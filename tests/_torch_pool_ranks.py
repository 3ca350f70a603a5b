"""Rank bodies of tests/test_torch_mesh_pool.py: jobs of a
``parallel/mesh.RankPool``, each ``fn(mesh, state, *args)`` on every rank.

This module imports the port and the benchmark's Groth16 entry (for its
``Scripted`` rng) only, never ``jax`` or the JAX package, and every result
goes back as numpy arrays, host ints or tuples of them: the tests read
every rank's through ``RankPool.run_all``.  Each rank keeps a circuit, a
witness and a split key per m, under ``state[m]``.

Run as a script it starts a pool of 2 ranks, prints the worker's pid and
ends inside a job (``stall``) while the worker still runs it, as a rank 0
that dies would.
"""

import os
import sys
import time

import torch

from myzkp_tpu_torch.arith.sparse import SparseQAP, square_chain
from myzkp_tpu_torch.curves import bn254, weierstrass as wst
from myzkp_tpu_torch.parallel import mesh as pm
from myzkp_tpu_torch.snark import groth16
from zkbench.entries.groth16_prove import Scripted

DEV = torch.device("cpu")
NPUB = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "myzkp_tpu")


def points(proof) -> tuple:
    """A, B and C as the benchmark's entries write them: affine ints."""
    g2 = lambda p: (tuple(int(c.v) for c in p.x.c), tuple(int(c.v) for c in p.y.c))
    return (int(proof.a.x.v), int(proof.a.y.v)), g2(proof.b), (int(proof.c.x.v),
                                                               int(proof.c.y.v))


def setup(mesh, state, m: int, x0: int, toxic: tuple) -> tuple:
    """The square chain of m constraints from x0 and the rank's split key
    from ``toxic``; the rank's key block sizes (g1_xj, g2_xj, g1_k_priv,
    g1_ht)."""
    spec = bn254.r_spec()
    r1cs, asg = square_chain(spec, m, x0, DEV)
    qap = SparseQAP(r1cs)
    pk, _ = groth16.setup(qap, NPUB, Scripted(toxic), mesh=mesh)
    state[m] = {"qap": qap, "asg": asg, "pk": pk}
    return tuple(wst.leaves(v)[0].shape[-1] for v in
                 (pk.g1_xj, pk.g2_xj, pk.g1_k_priv, pk.g1_ht))


def prove(mesh, state, m: int, rs: tuple) -> tuple:
    """The rank's proof of the set-up witness of m constraints with (r, s)
    = rs."""
    st = state[m]
    return points(groth16.prove(st["asg"], st["pk"], st["qap"], Scripted(rs), mesh=mesh))


def quotient(mesh, state, m: int) -> tuple:
    """The rank's coefficient indices, u, v and h blocks (L, 3, m / D), the
    evaluation block's shape, and the bytes each collective sent, of the
    block quotient of the set-up witness of m constraints."""
    qap, asg = state[m]["qap"], state[m]["asg"]
    D, r = mesh.size(), mesh.get_local_rank("shard")
    rows = pm.eval_block(qap.r1cs, qap.m, D, r)
    uvw = torch.stack([x.mont for x in rows.matvecs(asg)], dim=1)
    pm.reset_traffic()
    out = pm.block_quotient(qap.spec, uvw, qap.m, mesh)
    sent = {k: dict(v) for k, v in pm.traffic.items()}
    return pm.coef_index(qap.m, D, r).numpy(), out.numpy(), tuple(uvw.shape), sent


def modules(mesh, state) -> list:
    """The rank's loaded modules of JAX or the JAX package."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def fail_on(mesh, state, bad: int) -> None:
    """Rank ``bad`` raises; the others wait for it in an all-gather."""
    if mesh.get_local_rank("shard") == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    pm.gather(torch.zeros(2, 1, dtype=torch.int32), mesh)


def stall(mesh, state, seconds: float) -> None:
    """Rank 0 ends its process at once; the others run on for ``seconds``
    (a collective waiting for a rank that died)."""
    if mesh.get_local_rank("shard") == 0:
        os._exit(3)
    time.sleep(seconds)


if __name__ == "__main__":
    pool = pm.RankPool(2, device="cpu", timeout=120)
    print(" ".join(str(p.pid) for p in pool._procs), flush=True)
    pool.run(stall, 120.0)
