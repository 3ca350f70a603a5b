"""Port parity of ``parallel/mesh.py``: the port's distributed functions, run
in one world of four gloo ranks on the CPU, against the JAX package's
``parallel/mesh.py`` on a 4-device JAX CPU mesh (2 x 2 for the batch axis),
at ``tests/test_parallel.py``'s sizes over its P32 field (L = 2).

The world is spawned once for the file (``parallel/mesh.run_ranks``), in a
thread, while the tests compute the JAX side; the ranks run
``tests/_torch_mesh_ranks.py``, which imports the port only and returns
numpy arrays and host ints.  Every value is a field element, a hash or a
curve point, so every comparison is exact (the tolerance is 0).  dist_msm is
held to the JAX package's host group law, the golden that
``tests/test_parallel.py`` holds the JAX dist_msm to (the JAX dist_msm costs
a minute and more of XLA compile a case on the CPU); dist_shifted_h_rou at
m = 16 to both the JAX package's and the port's single-rank get_shifted_h;
the mesh provers at m = 16 (Groth16's with the split key) to the port's
single-rank provers under the same seeds.
"""

import concurrent.futures
import random
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mesh_ranks as ranks
from myzkp_tpu.arith import sparse as jsparse
from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import FieldSpec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu.parallel import mesh as jpm
from myzkp_tpu.protocols import sumcheck_tpu as jst
from myzkp_tpu.stark.fri import fold_codeword as jfold
from myzkp_tpu.utils import merkle as jmerkle
from myzkp_tpu_torch.parallel import mesh as pm
from myzkp_tpu_torch.utils import merkle as tmerkle

torch.set_num_threads(1)
P32 = ranks.P32
JSPEC = FieldSpec.make(P32)
D = 4
TIMEOUT = 120  # seconds a rank waits in a collective before it fails


def _mont(rows) -> np.ndarray:
    return np.asarray(JFp.from_int(JSPEC, rows).mont)


def _rand(rng, n: int) -> list:
    return [rng.randrange(P32) for _ in range(n)]


def _msm_case(rng, n: int) -> dict:
    """n host G1 points P_i = [a + i b]G (one host add each) and random
    scalars k_i, the numpy limbs the ranks read, and the sum by the host
    group law, [sum k_i (a + i b)]G."""
    g1 = jbn.g1_generator()
    a, b = rng.randrange(1, jbn.R), rng.randrange(1, jbn.R)
    ks = [rng.randrange(1, jbn.R) for _ in range(n)]
    pts, step = [g1 * a], g1 * b
    for _ in range(n - 1):
        pts.append(pts[-1] + step)
    want = g1 * (sum(k * (a + i * b) for i, k in enumerate(ks)) % jbn.R)
    dev = jbn.g1_points_to_device(pts)
    scalars = np.asarray(jlimb.from_int(jbn.r_spec(), ks))
    return {"port": (tuple(np.asarray(c) for c in dev), scalars),
            "want": (int(want.x), int(want.y))}


def _inputs() -> dict:
    rng = random.Random(18)
    data = {
        "ntt": _mont(_rand(rng, 256)),
        "intt": _mont(_rand(rng, 512)),
        "ntt2d": _mont([_rand(rng, 128) for _ in range(4)]),
        "fri": _mont(_rand(rng, 256)),
        "fri_args": (rng.randrange(1, P32), 5, jntt.nth_root_of_unity(P32, 256),
                     rng.randrange(1, P32)),
        "merkle": np.asarray(jlimb.from_int(JSPEC, _rand(rng, 64))),
        "batch": np.moveaxis(_mont([_rand(rng, 32) for _ in range(8)]), 1, 0),
        "table": _mont(_rand(rng, 128)),
        "r": _mont([rng.randrange(1, P32)])[:, 0],
        "deltas": tuple(rng.randrange(1, jbn.R) for _ in range(3)),
    }
    msms = {"msm16": _msm_case(rng, 16), "msm256": _msm_case(rng, 256)}
    return {"port": {**data, **{k: v["port"] for k, v in msms.items()}}, "jax": data,
            "msm_want": {k: v["want"] for k, v in msms.items()}}


@pytest.fixture(scope="module")
def world():
    """The inputs, and the ranks' results as a future: the world runs in a
    thread while the tests compute the JAX side."""
    inputs = _inputs()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(pm.run_ranks, ranks.checks, D, inputs["port"], device="cpu",
                      timeout=TIMEOUT)
    yield inputs, fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def mesh4():
    return jpm.make_mesh(D)


def _sharded(a, mesh):
    return jax.device_put(a, NamedSharding(mesh, P(None, "shard")))


def test_dist_shifted_h_matches_jax(world, mesh4):
    """The ranks' shifted h at m = 16 against the JAX package's
    dist_shifted_h_rou on the same circuit and deltas.  First in the file:
    its XLA compile overlaps the world's run."""
    inputs, fut = world
    r1cs, asg = jsparse.square_chain(jbn.r_spec(), 16)
    u, v, w = (x.mont for x in r1cs.matvecs(asg))
    want = jpm.dist_shifted_h_rou(jbn.r_spec(), 16, u, v, w, *inputs["jax"]["deltas"], mesh4)
    np.testing.assert_array_equal(fut.result()["shifted_h"][0], np.asarray(want))


@pytest.mark.parametrize("case", ["ntt", "intt", "ntt2d"])
def test_dist_ntt_matches_jax(world, mesh4, case):
    inputs, fut = world
    a = inputs["jax"][case]
    if case == "ntt2d":
        mesh = jpm.make_mesh_2d(2, 2)
        out, (n1, n2) = jpm.dist_ntt(JSPEC, a, mesh, axis="ici", batch_axis="dcn")
    else:
        run = jpm.dist_intt if case == "intt" else jpm.dist_ntt
        out, (n1, n2) = run(JSPEC, a, mesh4)
    want = np.asarray(jpm.dist_ntt_to_natural(JSPEC, out, n1, n2))
    np.testing.assert_array_equal(fut.result()[case], want)


def test_dist_fri_fold_matches_jax(world, mesh4):
    inputs, fut = world
    alpha, offset, omega, alpha2 = inputs["jax"]["fri_args"]
    g1 = jpm.dist_fri_fold(JSPEC, _sharded(inputs["jax"]["fri"], mesh4), mesh4, alpha, offset,
                           omega)
    g2 = jpm.dist_fri_fold(JSPEC, g1, mesh4, alpha2, offset * offset % P32, omega * omega % P32)
    got1, got2 = fut.result()["fri"]
    np.testing.assert_array_equal(got1, np.asarray(g1))
    np.testing.assert_array_equal(got2, np.asarray(g2))
    np.testing.assert_array_equal(got1, np.asarray(jfold(JSPEC, inputs["jax"]["fri"], alpha,
                                                         offset, omega)))


@pytest.fixture(scope="module")
def jax_tree(world, mesh4):
    inputs, _ = world
    return jpm.dist_merkle_tree(JSPEC, _sharded(inputs["jax"]["merkle"], mesh4), mesh4)


def test_dist_merkle_root_matches_jax(world, jax_tree):
    root, n_shards, _ = world[1].result()["merkle"]
    assert (root, n_shards) == (jax_tree.root, D) and jax_tree.n_shards == D


@pytest.mark.parametrize("k", range(len(ranks.MERKLE_INDICES)))
def test_dist_merkle_path_matches_jax(world, jax_tree, k):
    inputs, fut = world
    idx = ranks.MERKLE_INDICES[k]
    root, _, paths = fut.result()["merkle"]
    assert paths[k] == jax_tree.open(idx)
    leaf = jlimb.to_bytes_batch(JSPEC, inputs["jax"]["merkle"])[idx]
    assert tmerkle.verify(root, idx, paths[k], leaf) and jmerkle.verify(root, idx, paths[k], leaf)


def test_dist_batch_matches_jax(world, mesh4):
    inputs, fut = world

    def square(x):  # (B / D, L, n) -> pointwise squares
        return jax.vmap(lambda y: jlimb.mont_mul(JSPEC, y, y))(x)

    want = jpm.dist_batch(square, mesh4)(inputs["jax"]["batch"])
    np.testing.assert_array_equal(fut.result()["batch"], np.asarray(want))


def test_dist_table_sum_matches_jax(world, mesh4):
    inputs, fut = world
    want = jpm.dist_table_sum(JSPEC, inputs["jax"]["table"], mesh4)
    np.testing.assert_array_equal(fut.result()["table_sum"], np.asarray(want))


def test_dist_fold_into_half_matches_jax(world, mesh4):
    """Every round from 128 entries down to 16, the table staying sharded."""
    inputs, fut = world
    cur, r = inputs["jax"]["table"], inputs["jax"]["r"]
    folds = fut.result()["folds"]
    assert len(folds) == 3
    for got in folds:
        cur = jpm.dist_fold_into_half(JSPEC, cur, mesh4, r)
        np.testing.assert_array_equal(got, np.asarray(cur))
    single = JFp(JSPEC, inputs["jax"]["table"])
    for _ in folds:
        single = jst.fold_into_half(single, JFp(JSPEC, r))
    np.testing.assert_array_equal(folds[-1], np.asarray(single.mont))


@pytest.mark.parametrize("case", ["msm16", "msm256"])
def test_dist_msm_matches_host(world, case):
    """16 points: 4 a rank on the naive ladder; 256 with c = 8, K = 8:
    Pippenger on every rank's 64."""
    inputs, fut = world
    assert fut.result()[case] == inputs["msm_want"][case]


def test_dist_shifted_h_matches_single_rank(world):
    got, want = world[1].result()["shifted_h"]
    assert got.shape == (16, 17)
    np.testing.assert_array_equal(got, want)


def test_mesh_pinocchio_prove_matches_single_rank(world):
    """The mesh prove at m = 16 over 4 ranks equals the single-rank prove
    under the same seed, point for point on every rank, and verifies."""
    res = world[1].result()
    assert all(p == res["pin_single"] for p in res["pin_mesh"])
    assert None not in res["pin_single"]
    assert res["verified"][0]


def test_mesh_groth16_prove_matches_single_rank(world):
    """The mesh prove at m = 16 over 4 ranks, each holding its block of the
    split key, equals the single-rank prove with the whole key under the
    same seeds, point for point on every rank, and verifies."""
    res = world[1].result()
    assert all(p == res["g16_single"] for p in res["g16_mesh"])
    assert res["verified"][1]


@pytest.mark.parametrize("k, words", [(0, "m = 8 < D^2 = 16"), (1, "SparseQAP")])
def test_mesh_prover_refusals(world, k, words):
    """pinocchio.prove(mesh=) raises ValueError for m < D^2 and for a
    dense QAP."""
    refusals = world[1].result()["refusals"]
    assert len(refusals) == 2 and words in refusals[k]


def test_run_ranks_raises_on_a_failed_rank():
    """A rank that raises fails the caller at once, with its traceback; the
    rank left in a collective is stopped."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        pm.run_ranks(ranks.fail_on_rank, 2, 1, device="cpu", timeout=60)
    assert time.perf_counter() - t0 < 60
