"""Entry: Groth16 proofs of a circuit too large for one card, by the mesh
prover with its proving key split across the ranks
(``myzkp_tpu_torch.snark.groth16.setup`` and ``prove`` with a mesh), served
by a ``parallel/mesh.RankPool``: this process is rank 0 on the harness's
device, and each of the pool's workers holds a card of its own.

Set-up starts the pool, makes the circuit and the chain of witnesses on
every rank, and each rank's key block from the toxic waste.  The
statements, the toxic waste and each job's (r, s) are ``groth16_prove``'s,
so its plain reference and comparison serve here as they are.  The chain
x_0, x_1, ... (x_(i + 1) = x_i^2) of m + ``statements`` values is made on
each rank's card, blocks of squarings side by side, each from one host
power; the circuit is ``arith/sparse.square_chain``'s matrices, without
that function's host loop, which takes minutes at 2^25.

Job 0 opens the window: the traffic counters (``parallel/mesh.traffic``)
and every rank's allocator peak restart there.  At release the entry
prints rank 0's collectives a proof (``# mesh traffic``), every rank's key
block (``# key block``) and its allocator peak before and in the window
(``# rank peak``), sent back through the pool's queue rather than by a
collective, then the time the pool took to close (``# pool closed``).
"""

from __future__ import annotations

import inspect
import json
import time

import torch

from myzkp_tpu_torch.arith import sparse
from myzkp_tpu_torch.curves import bn254, weierstrass as wst
from myzkp_tpu_torch.fields import limb
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.parallel import mesh as pm
from myzkp_tpu_torch.snark import groth16

# the harness's interface that this entry shares with groth16_prove: load_library,
# make_inputs, Reference, compare
from .groth16_prove import (R, Reference, Scripted, _g1, _g2, chain_shift, compare,  # noqa: F401
                            job_randomness, load_library, make_inputs)

# a program without the split-key mesh prover fails here, before any rank starts
if not hasattr(pm, "RankPool") or "mesh" not in inspect.signature(groth16.setup).parameters:
    raise ImportError("the program has no split-key mesh Groth16 prover "
                      "(parallel/mesh.RankPool, groth16.setup(..., mesh=))")

TIMEOUT = 600.0  # seconds a job may take on the slowest rank before the pool fails
_BLOCK = 4096  # squarings a block of the chain


def _chain(spec, n: int, x0: int, device) -> Fp:
    """x0^(2^i) for i < n, (n,) Montgomery: blocks of ``_BLOCK`` squarings
    side by side, block b from x0^(2^(b _BLOCK)) by one host power (the
    exponent reduced mod R - 1, x0 being nonzero)."""
    B = min(_BLOCK, n)
    blocks = -(-n // B)
    cur = Fp.from_int(spec, [pow(x0, pow(2, b * B, R - 1), R) for b in range(blocks)], device)
    out = torch.empty((spec.L, B, blocks), dtype=cur.mont.dtype, device=device)
    for i in range(B):
        out[:, i] = cur.mont
        cur = cur * cur
    return Fp(spec, out.transpose(1, 2).reshape(spec.L, -1)[:, :n].contiguous())


def _circuit(spec, m: int, device) -> sparse.SparseQAP:
    """``square_chain``'s circuit x_(k + 1) = x_k^2 over the wires [1, x_0,
    ..., x_m]: row k of A and B holds 1 at wire k + 1, of C at wire k + 2."""
    rows = torch.arange(m, device=device)
    ones = Fp(spec, limb.one_mont(spec, (m,), device))
    mat = lambda off: sparse.SparseMatrix(rows, rows + off, ones, (m, m + 2))
    return sparse.SparseQAP(sparse.SparseR1CS(mat(1), mat(1), mat(2)))


# ---------------------------------------------------------------------------
# The jobs, on every rank: fn(mesh, state, *args)
# ---------------------------------------------------------------------------

def job_inputs(mesh, state, m: int, statements: int, x0: int) -> None:
    spec, dev = bn254.r_spec(), pm.mesh_device(mesh)
    state.update(m=m, one=Fp.from_int(spec, [1], dev), qap=_circuit(spec, m, dev),
                 chain=_chain(spec, m + statements, x0, dev))


def job_keys(mesh, state, num_public: int, toxic: tuple) -> None:
    """The rank's key block, from the toxic waste."""
    state["pk"], _ = groth16.setup(state["qap"], num_public, Scripted(toxic), mesh=mesh)


def job_prove(mesh, state, k: int, shift: int, rs: tuple) -> tuple:
    """Job k: the proof of the witness from x_shift with (r, s) = rs.  Job
    0 restarts the rank's allocator peak; a warm-up job (k < 0) notes the
    peak so far."""
    dev = pm.mesh_device(mesh)
    cuda = dev.type == "cuda"
    if cuda and k == 0:
        torch.cuda.reset_peak_memory_stats(dev)
    m = state["m"]
    witness = state["one"].concat(state["chain"][shift:shift + m + 1])
    proof = groth16.prove(witness, state["pk"], state["qap"], Scripted(rs), mesh=mesh)
    if cuda and k < 0:
        state["setup_peak"] = torch.cuda.max_memory_allocated(dev)
    return _g1(proof.a), _g2(proof.b), _g1(proof.c)


def job_report(mesh, state) -> tuple:
    """The rank's key block (points a vector) and allocator peaks in bytes
    (to the window, in it); the rank's state is freed."""
    dev = pm.mesh_device(mesh)
    pk = state["pk"]
    block = {name: wst.leaves(getattr(pk, name))[0].shape[-1]
             for name in ("g1_xj", "g2_xj", "g1_k_priv", "g1_ht")}
    peaks = ((state.get("setup_peak"), torch.cuda.max_memory_allocated(dev))
             if dev.type == "cuda" else (None, None))
    state.clear()
    return mesh.get_local_rank("shard"), block, peaks


class Program:
    def __init__(self, config: dict, inputs: dict, device, phase):
        self.config, self.m = config, int(config["constraints"])
        self.ranks = int(config["ranks"])
        self.jobs, self.failed = 0, None
        with phase("ranks"):
            self.pool = pm.RankPool(self.ranks, device=device, timeout=TIMEOUT)
        try:
            with phase("inputs"):
                self.pool.run(job_inputs, self.m, int(config["statements"]), inputs["x0"])
            with phase("keys"):
                self.pool.run(job_keys, int(config["num_public"]), inputs["toxic"])
        except BaseException:
            self.pool.close()
            raise

    def run(self, job):
        if self.failed:
            # the pool stopped every rank at its first failure: no later job can run
            raise SystemExit(f"the rank pool failed: {self.failed}")
        if job.k == 0:
            pm.reset_traffic()
        if job.k >= 0:
            self.jobs += 1
        try:
            return self.pool.run(job_prove, job.k, chain_shift(self.config, job),
                                 job_randomness(job))
        except RuntimeError as exc:
            self.failed = str(exc).splitlines()[0]
            raise

    def release(self) -> None:
        if self.failed:
            return
        every = self.pool.run_all(job_report)
        jobs = max(self.jobs, 1)
        sent = {k: {"calls": v["calls"] / jobs, "bytes": v["bytes"] / jobs}
                for k, v in pm.traffic.items()}
        print(f"# mesh traffic rank 0 a proof over {self.jobs} window jobs: "
              f"{json.dumps(sent)}")
        print("# key block " + json.dumps({r: block for r, block, _ in every}))
        gib = lambda b: None if b is None else b / 2**30
        print("# rank peak GiB (to the window, in it) "
              + json.dumps({r: [gib(a), gib(b)] for r, _, (a, b) in every}), flush=True)
        t = time.perf_counter()
        self.pool.close()
        print(f"# pool closed in {time.perf_counter() - t} s", flush=True)
