"""Port parity: the G1 group law and the bucket scan of myzkp_tpu_torch.

padd / padd_sel / pdbl (plain versions of kernels K2 and K3 on the CPU) are
held to myzkp_tpu.curves.weierstrass limb for limb on the same numpy-seeded
projective inputs; tree sums and the bucket scan (plain version of K4) are
held to the host group law as affine points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import curve_kernels as ck
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

Q = tbn.Q
RMOD = (1 << 256) % Q


def _np_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).T.astype(np.uint32)


def _rand_int(rng: np.random.Generator, below: int) -> int:
    return int.from_bytes(rng.bytes(40), "little") % below


def _projective(host, rng):
    """Random projective representatives (Montgomery form) of host points,
    as numpy (x, y, z) limb arrays; infinity is (0, lam, 0)."""
    cols = ([], [], [])
    for p in host:
        lam = 1 + _rand_int(rng, Q - 1)
        xyz = (0, lam, 0) if p.inf else (int(p.x) * lam, int(p.y) * lam, lam)
        for col, v in zip(cols, xyz):
            col.append(v * RMOD % Q)
    return tuple(_np_limbs(c) for c in cols)


@pytest.fixture(scope="module")
def pairs():
    """P, Q batches covering generic sums, P+P, P+(-P), P+O, O+Q and O+O."""
    rng = np.random.default_rng(5)
    g = tbn.g1_generator()
    O = tbn.curve_g1.infinity()
    pts = [g * (1 + _rand_int(rng, tbn.R - 1)) for _ in range(10)]
    hp = pts[:6] + [pts[6], pts[7], pts[8], O, O]
    hq = pts[9:] + pts[1:6] + [pts[6], -pts[7], O, pts[9], O]
    return hp, hq, _projective(hp, rng), _projective(hq, rng)


def _both(np_pt):
    return (tw.Point(*interop.point_from_numpy(np_pt, DEV)),
            jw.Point(*(jnp.asarray(a) for a in np_pt)))


def _assert_same(t_pt, j_pt):
    for t, j in zip(t_pt, j_pt):
        np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


def test_padd_matches_reference(pairs):
    hp, hq, p_np, q_np = pairs
    (tp, jp), (tq, jq) = _both(p_np), _both(q_np)
    got = tw.padd(tbn.g1_ops(), tbn.g1_b3((), DEV), tp, tq)
    _assert_same(got, jw.padd(jbn.g1_ops(), jbn.g1_b3(()), jp, jq))
    assert tbn.g1_points_to_host(got) == [a + b for a, b in zip(hp, hq)]


def test_padd_sel_matches_reference(pairs):
    _, _, p_np, q_np = pairs
    (tp, jp), (tq, jq) = _both(p_np), _both(q_np)
    h = np.arange(p_np[0].shape[1]) % 3 == 0
    got = tw.padd_sel(tbn.g1_ops(), tbn.g1_b3((), DEV), tp, tq, torch.from_numpy(h))
    want = jw.padd_sel(jbn.g1_ops(), jbn.g1_b3(()), jp, jq, jnp.asarray(h))
    _assert_same(got, want)


def test_pdbl_matches_reference(pairs):
    hp, _, p_np, _ = pairs
    tp, jp = _both(p_np)
    got = tw.pdbl(tbn.g1_ops(), tbn.g1_b3((), DEV), tp)
    _assert_same(got, jw.pdbl(jbn.g1_ops(), jbn.g1_b3(()), jp))
    assert tbn.g1_points_to_host(got) == [a + a for a in hp]


def test_points_to_device_match_reference(pairs):
    hp = pairs[0]
    ints = [None if p.inf else (int(p.x), int(p.y)) for p in hp]
    _assert_same(tbn.g1_points_to_device(ints, DEV), jbn.g1_points_to_device(ints))


def test_kernel_wrappers_take_plain_versions_on_cpu(pairs):
    """The wrappers' plain path is the *_ref function, bit for bit, and it
    returns canonical int32 limbs."""
    _, _, p_np, q_np = pairs
    spec, b3 = tbn.q_spec(), tbn.g1_b3((), DEV)
    tp, tq = interop.point_from_numpy(p_np, DEV), interop.point_from_numpy(q_np, DEV)
    for got, want in ((ck.padd(spec, b3, tp, tq), ck.padd_ref(spec, b3, tp, tq)),
                      (ck.pdbl(spec, b3, tp), ck.pdbl_ref(spec, b3, tp))):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
            assert int(g.min()) >= 0 and int(g.max()) < 1 << 16


@pytest.mark.parametrize("n", [1, 11, 16])
def test_tree_sum_matches_host(pairs, n):
    hp, hq, p_np, q_np = pairs
    host = (hp + hq)[:n]
    pts = tw.Point(*(torch.cat([a, b], dim=1)[:, :n] for a, b in
                     zip(interop.point_from_numpy(p_np, DEV),
                         interop.point_from_numpy(q_np, DEV))))
    got = tw.tree_sum(tbn.g1_ops(), tbn.g1_b3((), DEV), pts, axis=0)
    want = tbn.curve_g1.infinity()
    for p in host:
        want = want + p
    assert tbn.g1_points_to_host(tw.Point(*(a[:, None] for a in got))) == [want]


@pytest.mark.parametrize("group,N", [pytest.param("g1", 1000, id="1000"),
                                     pytest.param("g1", 2048, id="2048"),
                                     pytest.param("g2", 300, id="g2-300")])
def test_bucket_scan_rows_ref_matches_host(group, N):
    """Plain version of the bucket scan (K4 for G1, its G2 instance for G2)
    vs a host-simulated segmented scan, as affine points: each lane's
    accumulator, the bucket rows at the real targets (the accumulator before
    the step, step 0 included), and every other row left as it was: -1 writes
    nothing.  Each step reads the point table at a seeded random index, with
    repeats.  N = 1000 and 300 are ragged lane counts the TPU kernel did not
    take (curve_pallas.bucket_scan_rows, tests/test_pallas.py:271)."""
    rng = np.random.default_rng(23)
    g2 = group == "g2"
    F, b3 = (tbn.g2_ops(), tbn.g2_b3((), DEV)) if g2 else (tbn.g1_ops(), tbn.g1_b3((), DEV))
    to_device = tbn.g2_points_to_device if g2 else tbn.g1_points_to_device
    to_host = tbn.g2_points_to_host if g2 else tbn.g1_points_to_host
    K = 2
    if g2:  # a walk of host additions: far cheaper than G2 scalar products
        step = tbn.g2_generator() * 12345
        host_pts = [tbn.g2_generator()]
        while len(host_pts) < K * N:
            host_pts.append(host_pts[-1] + step)
    else:
        host_pts = [tbn.g1_generator() * int(v) for v in rng.integers(1, 1 << 30, K * N)]
    rows, C = tmsm._rows_of_point(to_device(host_pts, DEV))
    idx = rng.integers(0, K * N, K * N).astype(np.int32)
    tags = rng.integers(0, 4, K * N).astype(np.int32)
    tags[:7] = [0, 1, 2, 3, 2, 1, 0]  # all combinations early
    S = K * N + 17  # bucket rows, some never targeted
    tgt = np.where(rng.random(K * N) < 0.3, rng.permutation(S)[:K * N], -1).astype(np.int32)
    table, _ = tmsm._rows_of_point(tw.infinity(F, (S,), DEV), rows.shape[1])
    before = table.clone()
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    acc = scan(tbn.q_spec(), rows, torch.from_numpy(idx), torch.from_numpy(tags),
               torch.from_numpy(tgt), b3, table, K)
    inf = (tbn.curve_g2 if g2 else tbn.curve_g1).infinity()
    acc_h, flushed = [inf] * N, {}
    for k in range(K):
        for lane in range(N):
            r = k * N + lane
            if tgt[r] >= 0:
                flushed[int(tgt[r])] = acc_h[lane]
            q = -host_pts[idx[r]] if tags[r] & 1 else host_pts[idx[r]]
            acc_h[lane] = q if tags[r] & 2 else acc_h[lane] + q
    assert to_host(tw.from_leaves(acc.split(tbn.q_spec().L))) == acc_h
    real = sorted(flushed)
    assert (tgt[:N] >= 0).any()  # step 0 flushes too
    assert to_host(tmsm._point_of_rows(table[real], C, (len(real),))) == [flushed[t] for t in real]
    untouched = [i for i in range(S) if i not in flushed]
    assert untouched and torch.equal(table[untouched], before[untouched])
    assert not table[:, C:].any()  # the unused row lanes stay zero
