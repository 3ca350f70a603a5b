"""Port parity: F_q2, the G2 group law, G2 points, fixed base and MSM of
myzkp_tpu_torch.

Fq2Ops and the plain versions of kernels K7 (padd2, with and without the
select mask) and K8 (pdbl2) are held to myzkp_tpu's Fq2Ops and
weierstrass.padd / padd_sel / pdbl limb for limb, on the same numpy-seeded
projective inputs: P + P, P + (-P), P + O, O + Q, O + O, z != 1, and lanes
whose every coordinate component is 0, 1, q - 1 or R mod q.  Fixed-base and
MSM outputs are held to the host group law as affine points (tolerance 0
throughout: these are modular integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import field_ops as jfo
from myzkp_tpu.curves import fixed_base as jfb
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import curve_kernels as ck
from myzkp_tpu_torch.curves import fixed_base as tfb
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.curves.field_ops import Fq2Ops

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

Q, R = tbn.Q, tbn.R
RMOD = (1 << 256) % Q
EDGES = [0, 1, Q - 1, RMOD]


def _np_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).T.astype(np.uint32)


def _rand(rng: np.random.Generator, below: int) -> int:
    return int.from_bytes(rng.bytes(40), "little") % below


def _fq2_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q


def _coords(p):
    return tuple((e.c[0].v, e.c[1].v) for e in (p.x, p.y))


def _projective(host, rng) -> list:
    """Random projective representatives (x, y, z) * lam, lam a random
    nonzero F_q2 element, of host G2 points as six Montgomery int columns
    (x0, x1, y0, y1, z0, z1); infinity is (0, lam, 0)."""
    cols = [[] for _ in range(6)]
    for p in host:
        lam = (1 + _rand(rng, Q - 1), _rand(rng, Q))
        if p.inf:
            xyz = ((0, 0), lam, (0, 0))
        else:
            x, y = _coords(p)
            xyz = (_fq2_mul(x, lam), _fq2_mul(y, lam), lam)
        for k, e in enumerate(xyz):
            for j in range(2):
                cols[2 * k + j].append(e[j] * RMOD % Q)
    return cols


@pytest.fixture(scope="module")
def pairs():
    """P, Q batches: generic sums, P+P, P+(-P), P+O, O+Q, O+O (11 lanes with
    host counterparts), then 5 lanes whose every component is an edge value."""
    rng = np.random.default_rng(7)
    g = tbn.g2_generator()
    O = tbn.curve_g2.infinity()
    pts = [g * (1 + _rand(rng, R - 1)) for _ in range(10)]
    hp = pts[:6] + [pts[6], pts[7], pts[8], O, O]
    hq = pts[9:] + pts[1:6] + [pts[6], -pts[7], O, pts[9], O]

    def batch(host):
        cols = _projective(host, rng)
        for col in cols:
            col.extend(EDGES[i] for i in rng.integers(0, 4, 5))
        return tuple(_np_limbs(c) for c in cols)

    return hp, hq, batch(hp), batch(hq)


def _port(np_pt) -> tw.Point:
    return interop.point_from_numpy(np_pt, DEV)


def _jax(np_pt) -> jw.Point:
    a = [jnp.asarray(x) for x in np_pt]
    return jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5]))


def _assert_same(t_pt, j_pt):
    for t, j in zip(tw.leaves(t_pt), jax.tree_util.tree_leaves(j_pt)):
        np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


def _ops():
    return tbn.g2_ops(), tbn.g2_b3((), DEV), jbn.g2_ops(), jbn.g2_b3(())


def test_fq2_ops_match_reference():
    rng = np.random.default_rng(2)
    n = 24
    vals = lambda: [EDGES[k % 4] if k < 8 else _rand(rng, Q) for k in range(n)]
    a_np = (_np_limbs(vals()), _np_limbs(vals()[::-1]))
    b_np = (_np_limbs(vals()), _np_limbs(vals()))
    a_np[0][:, 0] = a_np[1][:, 0] = 0  # a zero element for batch_inv and is_zero
    F, J = Fq2Ops(tbn.q_spec()), jfo.Fq2Ops(jbn.q_spec())
    ta, tb = (tuple(interop.limbs_from_numpy(x, DEV) for x in e) for e in (a_np, b_np))
    ja, jb = (tuple(jnp.asarray(x) for x in e) for e in (a_np, b_np))
    mask = np.arange(n) % 3 == 0
    pairs = [(F.add(ta, tb), J.add(ja, jb)), (F.sub(ta, tb), J.sub(ja, jb)),
             (F.mul(ta, tb), J.mul(ja, jb)), (F.sqr(ta), J.sqr(ja)),
             (F.neg(ta), J.neg(ja)), (F.batch_inv(ta), J.batch_inv(ja)),
             (F.select(torch.from_numpy(mask), ta, tb), J.select(jnp.asarray(mask), ja, jb)),
             (F.const((5, Q - 2), (n,), DEV), J.const((5, Q - 2), (n,)))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(interop.limbs_to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(F.is_zero(ta).numpy(), np.asarray(J.is_zero(ja)))
    assert F.batch_shape(ta) == (n,)


def test_padd2_matches_reference(pairs):
    hp, hq, p_np, q_np = pairs
    F, b3, JF, jb3 = _ops()
    got = tw.padd(F, b3, _port(p_np), _port(q_np))
    _assert_same(got, jw.padd(JF, jb3, _jax(p_np), _jax(q_np)))
    head = tw.point_map(lambda a: a[:, :len(hp)], got)
    assert tbn.g2_points_to_host(head) == [a + b for a, b in zip(hp, hq)]


def test_padd2_sel_matches_reference(pairs):
    _, _, p_np, q_np = pairs
    F, b3, JF, jb3 = _ops()
    h = np.arange(p_np[0].shape[1]) % 3 == 0
    got = tw.padd_sel(F, b3, _port(p_np), _port(q_np), torch.from_numpy(h))
    _assert_same(got, jw.padd_sel(JF, jb3, _jax(p_np), _jax(q_np), jnp.asarray(h)))


def test_pdbl2_matches_reference(pairs):
    hp, _, p_np, _ = pairs
    F, b3, JF, jb3 = _ops()
    got = tw.pdbl(F, b3, _port(p_np))
    _assert_same(got, jw.pdbl(JF, jb3, _jax(p_np)))
    head = tw.point_map(lambda a: a[:, :len(hp)], got)
    assert tbn.g2_points_to_host(head) == [a + a for a in hp]


def test_g2_kernel_wrappers_take_plain_versions_on_cpu(pairs):
    """K7 / K8's wrappers run their plain versions on CPU tensors, bit for
    bit, and return canonical int32 limbs."""
    _, _, p_np, q_np = pairs
    spec, b3 = tbn.q_spec(), tbn.g2_b3((), DEV)
    tp, tq = _port(p_np), _port(q_np)
    h = torch.arange(p_np[0].shape[1]) % 2 == 0
    for got, want in ((ck.padd2(spec, b3, tp, tq, h), ck.padd2_ref(spec, b3, tp, tq, h)),
                      (ck.pdbl2(spec, b3, tp), ck.pdbl2_ref(spec, b3, tp))):
        for g, w in zip(tw.leaves(got), tw.leaves(want)):
            assert g.dtype == torch.int32 and torch.equal(g, w)
            assert int(g.min()) >= 0 and int(g.max()) < 1 << 16


def test_g2_points_to_device_and_host_match_reference(pairs):
    hp = pairs[0]
    ints = [None if p.inf else _coords(p) for p in hp]
    got = tbn.g2_points_to_device(ints, DEV)
    want = jbn.g2_points_to_device(ints)
    _assert_same(got, want)
    _assert_same(tbn.g2_points_to_device(hp, DEV), want)  # PyPoints in
    host_ref = jbn.g2_points_to_host(want)
    back = tbn.g2_points_to_host(got)
    assert back == hp
    assert [None if p.inf else _coords(p) for p in host_ref] == ints
    assert tbn.g2_generator() * R == tbn.curve_g2.infinity()


def test_fixed_base_multi_g2_matches_host_and_reference_table(tmp_path):
    """[k]G2 for 64 scalars (0, 1, 2, r - 1 and random ones) from the port's
    table; the table itself holds the same integers as the JAX package's,
    which the port also reads from the reference's .npz format."""
    rng = np.random.default_rng(64)
    ks = [0, 1, 2, R - 1] + [_rand(rng, R) for _ in range(60)]
    s = tmsm.scalars_from_int(tbn.r_spec(), ks, DEV)
    got = tbn.g2_points_to_host(tfb.fixed_base_multi("g2", s))
    g = tbn.g2_generator()
    assert got == [g * k for k in ks]
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jbn.g2_points_to_device(
        jfb._build_host_table("g2", tfb._TABLE_C)))]
    path = tmp_path / "g2_c8.npz"
    np.savez(path, **{f"l{i}": a for i, a in enumerate(leaves)})
    for loaded, own, want in zip(tw.leaves(interop.load_fixed_base_table(path, DEV)),
                                 tw.leaves(tfb._device_table("g2", DEV)), leaves):
        np.testing.assert_array_equal(interop.limbs_to_numpy(loaded), want)
        np.testing.assert_array_equal(interop.limbs_to_numpy(own), want)


def test_msm_g2_matches_host():
    """G2 Pippenger at n = 300 (c = 8, K = 8: padded to 304), with a zero
    and a duplicated scalar, against the host's [sum k_i m_i mod r]G2."""
    rng = np.random.default_rng(300)
    n = 300
    ms = [1 + _rand(rng, R - 1) for _ in range(n)]
    ks = [_rand(rng, R) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 5, 5
    rspec = tbn.r_spec()
    pts = tfb.fixed_base_multi("g2", tmsm.scalars_from_int(rspec, ms, DEV))
    got = tmsm.msm_pippenger(tbn.g2_ops(), tbn.g2_b3((), DEV), pts,
                             tmsm.scalars_from_int(rspec, ks, DEV), c=8, K=8)
    exp = tbn.g2_generator() * (sum(k * m for k, m in zip(ks, ms)) % R)
    assert tbn.g2_points_to_host(tw.point_map(lambda a: a[:, None], got)) == [exp]
