"""Port parity: the mixed add P + (qx, qy, 1) of myzkp_tpu_torch, G1 and G2.

The plain versions of kernels K9 (``padd_mixed_ref``) and K10
(``padd_mixed2_ref``), with and without the select mask, and the entry points
``weierstrass.padd_mixed`` / ``padd_mixed_sel`` are held to myzkp_tpu's
``weierstrass.padd_mixed`` / ``padd_mixed_sel`` (JAX on the CPU, where
``curve_pallas`` routes nothing) limb for limb, on the same inputs made with
numpy and ``random.Random``: n = 16 lanes for G1 and 8 for G2, with the
completeness edges P = O, P = Q (a doubling through the mixed formula) and
P = -Q (the sum is O), and lanes whose every coordinate component is 0, 1,
q - 1 or R mod q.  ``from_affine``, ``is_infinity`` and ``peq`` are held to
their JAX counterparts the same way.  Tolerance 0 throughout: modular
integers.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import curve_kernels as ck
from myzkp_tpu_torch.curves import weierstrass as tw

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

Q, R = tbn.Q, tbn.R
RMOD = (1 << 256) % Q
EDGES = [0, 1, Q - 1, RMOD]
GROUPS = ("g1", "g2")
LANES = {"g1": 16, "g2": 8}
N_EDGE = {"g1": 3, "g2": 1}  # trailing lanes of raw edge values


def _np_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).T.astype(np.uint32)


def _mul(a, b):
    """Product in F_q (ints) or F_q2 ((c0, c1) pairs)."""
    if isinstance(a, tuple):
        return (a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q
    return a * b % Q


def _comps(e) -> tuple:
    return e if isinstance(e, tuple) else (e,)


def _affine(p):
    if hasattr(p.x, "c"):
        return tuple((e.c[0].v, e.c[1].v) for e in (p.x, p.y))
    return int(p.x), int(p.y)


class Case:
    """P (projective) and Q (affine) lanes of one group as numpy limb arrays
    in the order of ``weierstrass.leaves`` (Montgomery form), the host points
    of the lanes that hold points, and a seeded select mask."""

    def __init__(self, group: str):
        g2 = group == "g2"
        n, n_edge = LANES[group], N_EDGE[group]
        rng = random.Random(31 if g2 else 29)
        nrng = np.random.default_rng(37 if g2 else 41)
        gen = tbn.g2_generator() if g2 else tbn.g1_generator()
        rand_el = ((lambda: (rng.randrange(1, Q), rng.randrange(Q))) if g2
                   else (lambda: rng.randrange(1, Q)))  # nonzero
        O = (tbn.curve_g2 if g2 else tbn.curve_g1).infinity()
        qs = [gen * rng.randrange(1, R) for _ in range(n)]
        ps = [gen * rng.randrange(1, R) for _ in range(n)]
        ps[n - n_edge - 3] = O               # P = O
        ps[n - n_edge - 2] = qs[n - n_edge - 2]  # P = Q: a doubling
        ps[n - n_edge - 1] = -qs[n - n_edge - 1]  # P = -Q: the sum is O
        self.host_p, self.host_q = ps[:n - n_edge], qs[:n - n_edge]
        zero = (0, 0) if g2 else 0
        pc, qc = [], []
        for k in range(n):
            lam = rand_el()  # P's projective rescaling
            if k >= n - n_edge:  # every component an edge value
                pick = lambda: (tuple(EDGES[i] for i in nrng.integers(0, 4, 2)) if g2
                                else EDGES[int(nrng.integers(0, 4))])
                pc.append((pick(), pick(), pick()))
                qc.append((pick(), pick()))
                continue
            qx, qy = _affine(qs[k])
            qc.append((qx, qy))
            if ps[k].inf:
                pc.append((zero, lam, zero))
            else:
                px, py = _affine(ps[k])
                pc.append((_mul(px, lam), _mul(py, lam), lam))
        mont = lambda col: _np_limbs([c * RMOD % Q for c in col])
        cols = lambda pts, i, j: [_comps(pt[i])[j] for pt in pts]
        ncomp = 2 if g2 else 1
        self.p_np = [mont(cols(pc, i, j)) for i in range(3) for j in range(ncomp)]
        self.q_np = [mont(cols(qc, i, j)) for i in range(2) for j in range(ncomp)]
        self.h = nrng.integers(0, 2, n).astype(bool)
        self.g2 = g2

    def port(self):
        """(F, b3, P, qx, qy, h) of the port."""
        t = [interop.limbs_from_numpy(a, DEV) for a in self.q_np]
        if self.g2:
            qx, qy = tuple(t[0:2]), tuple(t[2:4])
            F, b3 = tbn.g2_ops(), tbn.g2_b3((), DEV)
        else:
            (qx, qy), (F, b3) = t, (tbn.g1_ops(), tbn.g1_b3((), DEV))
        return (F, b3, interop.point_from_numpy(self.p_np, DEV), qx, qy,
                torch.from_numpy(self.h))

    def jax(self):
        """(F, b3, P, qx, qy, h) of the JAX package."""
        a = [jnp.asarray(x) for x in self.p_np]
        b = [jnp.asarray(x) for x in self.q_np]
        if self.g2:
            return (jbn.g2_ops(), jbn.g2_b3(()),
                    jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5])),
                    (b[0], b[1]), (b[2], b[3]), jnp.asarray(self.h))
        return (jbn.g1_ops(), jbn.g1_b3(()), jw.Point(*a), b[0], b[1],
                jnp.asarray(self.h))


@pytest.fixture(scope="module", params=GROUPS)
def case(request):
    return Case(request.param)


def _assert_same(t_pt, j_pt):
    t_leaves, j_leaves = tw.leaves(t_pt), jax.tree_util.tree_leaves(j_pt)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


def test_plain_versions_match_reference(case):
    """K9 / K10's plain versions, with and without the mask, equal the JAX
    package's padd_mixed and padd_mixed_sel limb for limb; where the mask is
    set the output is (qx, qy, one)."""
    F, b3, P, qx, qy, h = case.port()
    JF, jb3, JP, jqx, jqy, jh = case.jax()
    ref = ck.padd_mixed2_ref if case.g2 else ck.padd_mixed_ref
    _assert_same(tw.Point(*ref(F.spec, b3, P, qx, qy)), jw.padd_mixed(JF, jb3, JP, jqx, jqy))
    _assert_same(tw.Point(*ref(F.spec, b3, P, qx, qy, h)),
                 jw.padd_mixed_sel(JF, jb3, JP, jqx, jqy, jh))


def test_entry_points_match_reference_and_host(case):
    """weierstrass.padd_mixed / padd_mixed_sel equal the JAX package's limb
    for limb, and the point lanes' sums equal the host group law (P = O gives
    Q, P = Q gives 2Q, P = -Q gives O)."""
    F, b3, P, qx, qy, h = case.port()
    JF, jb3, JP, jqx, jqy, jh = case.jax()
    got = tw.padd_mixed(F, b3, P, qx, qy)
    _assert_same(got, jw.padd_mixed(JF, jb3, JP, jqx, jqy))
    _assert_same(tw.padd_mixed_sel(F, b3, P, qx, qy, h),
                 jw.padd_mixed_sel(JF, jb3, JP, jqx, jqy, jh))
    k = len(case.host_p)
    to_host = tbn.g2_points_to_host if case.g2 else tbn.g1_points_to_host
    assert to_host(tw.point_map(lambda a: a[:, :k], got)) == \
        [a + b for a, b in zip(case.host_p, case.host_q)]
    assert bool(tw.is_infinity(F, got)[k - 1])  # P = -Q


def test_mixed_add_equals_complete_add(case):
    """P + (qx, qy, 1) through K9 / K10's plain versions equals the complete
    add K2 / K7 of P and from_affine(qx, qy) limb for limb, on every lane:
    both compute the same field values and every output is canonical."""
    F, b3, P, qx, qy, _ = case.port()
    got = tw.padd_mixed(F, b3, P, qx, qy)
    want = tw.padd(F, b3, P, tw.from_affine(F, qx, qy))
    for g, w in zip(tw.leaves(got), tw.leaves(want)):
        assert torch.equal(g, w)


def test_from_affine_is_infinity_peq_match_reference(case):
    """peq of P and P + Q, of P and its rescaling by 2 (equal on every lane,
    O included) and of P + Q and itself, as the JAX package computes it."""
    F, b3, P, qx, qy, _ = case.port()
    JF, jb3, JP, jqx, jqy, _ = case.jax()
    _assert_same(tw.from_affine(F, qx, qy), jw.from_affine(JF, jqx, jqy))
    np.testing.assert_array_equal(tw.is_infinity(F, P).numpy(),
                                  np.asarray(jw.is_infinity(JF, JP)))
    n = LANES["g2" if case.g2 else "g1"]
    one, jone = F.one((n,), DEV), JF.one((n,))
    P2 = tw.Point(*(F.mul(c, F.add(one, one)) for c in P))
    JP2 = jw.Point(*(JF.mul(c, JF.add(jone, jone)) for c in JP))
    S = tw.padd_mixed(F, b3, P, qx, qy)
    JS = jw.padd_mixed(JF, jb3, JP, jqx, jqy)
    for (a, b), (ja, jb) in (((P, S), (JP, JS)), ((P, P2), (JP, JP2)), ((S, S), (JS, JS))):
        np.testing.assert_array_equal(tw.peq(F, b3, a, b).numpy(),
                                      np.asarray(jw.peq(JF, jb3, ja, jb)))
    assert bool(tw.peq(F, b3, P, P2).all())


def test_mixed_kernel_wrappers_take_plain_versions_on_cpu(case):
    """K9 / K10's wrappers run their plain versions on CPU tensors and return
    canonical int32 limbs."""
    F, b3, P, qx, qy, h = case.port()
    wrap, ref = ((ck.padd_mixed2, ck.padd_mixed2_ref) if case.g2
                 else (ck.padd_mixed, ck.padd_mixed_ref))
    for got, want in ((wrap(F.spec, b3, P, qx, qy, h), ref(F.spec, b3, P, qx, qy, h)),
                      (wrap(F.spec, b3, P, qx, qy), ref(F.spec, b3, P, qx, qy))):
        for g, w in zip(tw.leaves(tw.Point(*got)), tw.leaves(tw.Point(*want))):
            assert g.dtype == torch.int32 and torch.equal(g, w)
            assert int(g.min()) >= 0 and int(g.max()) < 1 << 16
