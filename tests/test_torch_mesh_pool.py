"""The split-key mesh Groth16 prover, its block quotient and the rank pool
(``parallel/mesh.RankPool``) on gloo ranks on the CPU at m = 2^6 and 2^7,
and the four-card cell ``mesh-g16-sq25-4chip`` through the benchmark's
harness at m = 2^6 over 2 ranks.

Every comparison is exact (field elements and curve points; the tolerance
is 0).  The statement is the cell run's job 0 (its x0, toxic waste and r,
s, from the cell's seed), so that one single-rank prove and one reference
proof serve the proves over 2 ranks (the cell run) and over 4 (the pool of
this file).  At m = 2^7 (an odd log2 m, as the cell's 2^25) the quotient's
split over 4 ranks is not square, n1 = 8 by n2 = 16, as 2^12 by 2^13 in
the cell; there the pool's proof is held to the reference's.  The two cell runs (``tests/_torch_pool_cell.py``: sound, and
with rank 1's key block from other toxic waste) run in processes of their
own, started with the file, beside the pool's tests: a pool's rank 0 holds
its process's process group, and a run checks its process for JAX, which
the test process has loaded.  The pool's workers import the port only
(``tests/_torch_pool_ranks.py``).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_pool_ranks as ranks
from myzkp_tpu_torch.arith.sparse import SparseQAP, square_chain
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.parallel import mesh as pm
from myzkp_tpu_torch.snark import groth16
from zkbench.entries import groth16_prove as entry
from zkbench.traffic import Traffic

torch.set_num_threads(1)
DEV = torch.device("cpu")
D = 4
TIMEOUT = 120  # seconds a pool job may take
CELL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_pool_cell.py")
sys.path.insert(0, os.path.dirname(CELL))
import _torch_pool_cell as cell_run  # noqa: E402

SMALL = cell_run.small_cell()
M = int(SMALL.config["constraints"])
M_ODD = 2 * M  # 2^7: dist_ntt's split (8, 16) over 4 ranks


@pytest.fixture(scope="module", autouse=True)
def cell_runs():
    """The cell's two CPU runs, started at once: {None: sound, 1: rank 1's
    key block from other toxic waste} -> their JSON lines, when read."""
    procs = {bad: subprocess.Popen([sys.executable, CELL]
                                   + ([] if bad is None else ["--bad-rank", str(bad)]),
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for bad in (None, 1)}
    out = {}

    def read(bad):
        if bad not in out:
            stdout, stderr = procs[bad].communicate(timeout=900)
            assert procs[bad].returncode == 0, stderr[-4000:]
            out[bad] = json.loads(stdout.strip().splitlines()[-1])
        return out[bad]

    yield read
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def statement() -> dict:
    """Job 0 of the cell run: x0, the toxic waste, (r, s), and the plain
    reference's proof of it at m = 2^6 and 2^7 (m -> proof)."""
    traffic = Traffic(SMALL.traffic, cell_run.SEED)
    inputs = entry.make_inputs(SMALL.config, traffic)
    job = traffic.job(0)
    assert entry.chain_shift(SMALL.config, job) == 0
    reference = {}
    for m in (M, M_ODD):
        config = dict(SMALL.config, constraints=m, wires=m + 2)
        ref = entry.Reference(config, inputs, DEV)
        reference[m] = json.loads(json.dumps(ref.answer(job)))
    return {"x0": inputs["x0"], "toxic": inputs["toxic"], "rs": entry.job_randomness(job),
            "reference": reference}


@pytest.fixture(scope="module")
def single(statement) -> tuple:
    """The one-card prove of the statement at m = 2^6."""
    r1cs, asg = square_chain(bn254.r_spec(), M, statement["x0"], DEV)
    qap = SparseQAP(r1cs)
    pk, _ = groth16.setup(qap, ranks.NPUB, entry.Scripted(statement["toxic"]))
    proof = groth16.prove(asg, pk, qap, entry.Scripted(statement["rs"]))
    return json.loads(json.dumps(ranks.points(proof)))


@pytest.fixture(scope="module")
def pool4(statement):
    """A pool of 4 gloo ranks with the statement's split key set up at m =
    2^6 and 2^7; every rank's key block sizes (m -> sizes)."""
    pool = pm.RankPool(D, device="cpu", timeout=TIMEOUT)
    sizes = {m: pool.run_all(ranks.setup, m, statement["x0"], statement["toxic"])
             for m in (M, M_ODD)}
    yield pool, sizes
    pool.close()


@pytest.mark.parametrize("m", [M, M_ODD])
def test_mesh_groth16_split_key_blocks(m, pool4):
    """Each rank holds a quarter of each of the four long vectors."""
    _, sizes = pool4
    assert sizes[m] == [(m // D,) * 4] * D


@pytest.mark.parametrize("m", [M, M_ODD])
def test_block_quotient_matches_single_rank(m, pool4, statement):
    """(b) u, v and h's blocks, put together at their coefficient indices,
    equal the one-card quotient's u, v and h[:m - 1] (coefficient m - 1
    zero); each rank held (L, 3, m / D) evaluations, and the transforms
    moved data by three all_to_alls and no all-gather.  m = 2^7 runs the
    split (8, 16), not square."""
    pool, _ = pool4
    if m == M_ODD:
        assert pm.quotient_split(m, D) == (8, 16)
    r1cs, asg = square_chain(bn254.r_spec(), m, statement["x0"], DEV)
    qap = SparseQAP(r1cs)
    coef = qap.combine_batched(asg)
    want = np.stack([coef.mont[:, 0].numpy(), coef.mont[:, 1].numpy(),
                     qap.quotient(coef).mont[:, :m].numpy()], axis=1)
    want[:, 2, m - 1] = 0
    got = np.zeros_like(want)
    seen = np.zeros(m, dtype=int)
    for idx, blk, shape, sent in pool.run_all(ranks.quotient, m):
        assert shape == (16, 3, m // D) and blk.shape == (16, 3, m // D)
        assert sent["all_gather"]["calls"] == 0 and sent["all_to_all"]["calls"] == 3
        got[:, :, idx] = blk
        seen[idx] += 1
    assert (seen == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ranks_, m", [(4, M), (2, M), (4, M_ODD)])
def test_mesh_groth16_split_key_prove(ranks_, m, pool4, single, statement, cell_runs):
    """(a) The split-key mesh prove over 2 ranks (the cell run's job 0) and
    over 4 (this file's pool), on every rank, equals the one-card prove and
    the plain reference's proof, point for point; at m = 2^7 over 4 ranks,
    the reference's."""
    if ranks_ == 2:
        proofs = [next(a for k, a, _ in cell_runs(None)["answers"] if k == 0)]
    else:
        proofs = json.loads(json.dumps(pool4[0].run_all(ranks.prove, m, statement["rs"])))
        assert len(proofs) == D
    for proof in proofs:
        assert proof == statement["reference"][m]
        if m == M:
            assert proof == single


def test_pool_workers_load_no_jax(pool4):
    """(f) No worker of the pool has JAX or the JAX package loaded (rank 0
    is this test process; the cell run's rank 0 is held to it by the
    harness, which prints no result otherwise)."""
    assert pool4[0].run_all(ranks.modules)[1:] == [[]] * (D - 1)


def test_cell_on_the_cpu_is_correct(cell_runs):
    """(d) The whole cell through ``harness.execute`` at m = 2^6 over 2
    ranks: correct; (c) its three jobs back to back through one pool each
    equal the reference's proof; the run's rank 0 loaded no JAX (a result
    was printed)."""
    out = cell_runs(None)
    assert out["result"]["correct"] is True
    assert out["result"]["checks"]["mismatched_points"] == {"value": 0, "limit": 0}
    assert [k for k, _, _ in out["answers"]] == [-2, -1, 0]
    for _, answer, expected in out["answers"]:
        assert answer == expected


def test_cell_with_a_foreign_key_block_is_not_correct(cell_runs):
    """(e) The same run with rank 1's key block made from other toxic
    waste: not correct."""
    out = cell_runs(1)
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["mismatched_points"]["value"] > 0


def _alive(pid: int) -> bool:
    """The process runs (a zombie, ended but not reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_pool_workers_end_when_rank_0_dies():
    """(c) A rank 0 that dies inside a job leaves no worker behind: the
    worker, still in the job (120 s of it), ends within seconds."""
    script = os.path.join(os.path.dirname(CELL), "_torch_pool_ranks.py")
    root = os.path.dirname(os.path.dirname(script))
    p = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": root})
    assert p.returncode == 3, p.stderr[-4000:]
    pids = [int(w) for w in p.stdout.strip().splitlines()[-1].split()]
    end = time.monotonic() + 15
    while any(_alive(pid) for pid in pids) and time.monotonic() < end:
        time.sleep(0.2)
    assert pids and not any(_alive(pid) for pid in pids)


def test_pool_raises_on_a_failed_rank(pool4):
    """(c) A rank that raises makes the call raise in rank 0 well within the
    pool's timeout, with its traceback; the pool is closed, and no worker
    outlives it.  Last in the file: it ends the pool."""
    pool, _ = pool4
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        pool.run(ranks.fail_on, 2)
    assert time.perf_counter() - t0 < TIMEOUT / 2
    with pytest.raises(RuntimeError, match="closed"):
        pool.run_all(ranks.modules)
    pool.close()
    assert not any(p.is_alive() for p in pool._procs)
