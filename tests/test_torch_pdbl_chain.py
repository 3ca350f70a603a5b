"""Port parity: chains of doublings (kernels K3 and K8) and their callers.

The port's ``weierstrass.pdbl(F, b3, P, n)`` (one launch of K3 or K8 on the
card; its plain version here on the CPU) and ``pdbl_steps`` are held to the
JAX package's ``weierstrass.pdbl`` applied n times, limb for limb, in both
groups at n = 1, 2, 5 and 16, on numpy-seeded lanes: projective rescalings
of host points, infinity (0, lam, 0), a lane with y = 0 (where P = -P), and
lanes whose every coordinate component is 0, 1, q - 1 or R mod q.  The
callers that now run chains, ``scalar_mul_bits`` (its bases from one steps
launch) on 16-bit scalars and ``msm._horner`` and ``msm._window_sums`` at
c = 4, are held to the JAX package's ladder and to the Horner and window-sum
steps of its ``msm_pippenger`` the same way.  Tolerance 0: these are modular
integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import msm as jmsm
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import _ext, interop
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
EDGES = [0, 1, Q - 1, RMOD]
GROUPS = ("g1", "g2")
STEPS = (1, 2, 5, 16)
LANES = 8
N_MAX = max(STEPS)


def _np_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).T.astype(np.uint32)


def _rand(rng: np.random.Generator, below: int) -> int:
    return int.from_bytes(rng.bytes(40), "little") % below


def _fq2_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q


def _lanes(group: str, n: int, seed: int) -> list:
    """n lanes as 3 (G1) or 6 (G2) numpy limb arrays (Montgomery form, the
    order of ``weierstrass.leaves``): random projective rescalings of host
    points, then infinity, a lane with y = 0 and two lanes of edge values in
    every component (the last four lanes, when n >= 8)."""
    g2 = group == "g2"
    rng = np.random.default_rng(seed)
    gen = tbn.g2_generator() if g2 else tbn.g1_generator()
    comps = 2 if g2 else 1
    rand_el = ((lambda: (1 + _rand(rng, Q - 1), _rand(rng, Q))) if g2
               else (lambda: 1 + _rand(rng, Q - 1)))
    zero = (0, 0) if g2 else 0
    cols = [[] for _ in range(3 * comps)]
    for k in range(n):
        lam = rand_el()
        if k == n - 4 and n >= 8:  # infinity
            xyz = (zero, lam, zero)
        elif k == n - 3 and n >= 8:  # y = 0: P = -P
            xyz = (rand_el(), zero, lam)
        elif k >= n - 2 and n >= 8:  # every component an edge value
            pick = lambda: EDGES[int(rng.integers(0, 4))]
            xyz = tuple((pick(), pick()) if g2 else pick() for _ in range(3))
        else:
            p = gen * (1 + _rand(rng, tbn.R - 1))
            if g2:
                x, y = ((e.c[0].v, e.c[1].v) for e in (p.x, p.y))
                xyz = (_fq2_mul(x, lam), _fq2_mul(y, lam), lam)
            else:
                xyz = (int(p.x) * lam % Q, int(p.y) * lam % Q, lam)
        for j, v in enumerate(c for e in xyz for c in (e if g2 else (e,))):
            cols[j].append(v * RMOD % Q)
    return [_np_limbs(c) for c in cols]


def _ops(group: str):
    """((F, b3) of the port, (F, b3) of the JAX package)."""
    if group == "g2":
        return (tbn.g2_ops(), tbn.g2_b3((), DEV)), (jbn.g2_ops(), jbn.g2_b3(()))
    return (tbn.g1_ops(), tbn.g1_b3((), DEV)), (jbn.g1_ops(), jbn.g1_b3(()))


def _jax_point(arrays):
    a = [jnp.asarray(x) for x in arrays]
    if len(a) == 6:
        return jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5]))
    return jw.Point(*a)


def _assert_same(t_pt, j_pt):
    t_leaves, j_leaves = tw.leaves(t_pt), jax.tree_util.tree_leaves(j_pt)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


@pytest.fixture(scope="module", params=GROUPS)
def chain(request):
    """A group's lanes, on the port and as the JAX package's doublings: the
    JAX points 2^i P for i = 1 .. N_MAX, one jw.pdbl call each."""
    group = request.param
    arrays = _lanes(group, LANES, seed=71 if group == "g2" else 73)
    (JF, jb3) = _ops(group)[1]
    jp, jsteps = _jax_point(arrays), []
    for _ in range(N_MAX):
        jp = jw.pdbl(JF, jb3, jp)
        jsteps.append(jp)
    return group, interop.point_from_numpy(arrays, DEV), jsteps


@pytest.mark.parametrize("n", STEPS)
def test_pdbl_chain_matches_reference(chain, n):
    """weierstrass.pdbl(F, b3, P, n) equals the JAX package's pdbl applied n
    times, limb for limb; the point lanes equal [2^n]P on the host."""
    group, P, jsteps = chain
    (F, b3), _ = _ops(group)
    got = tw.pdbl(F, b3, P, n)
    _assert_same(got, jsteps[n - 1])
    to_host = tbn.g2_points_to_host if group == "g2" else tbn.g1_points_to_host
    pts = LANES - 4
    want = [p * (1 << n) for p in to_host(tw.point_map(lambda a: a[:, :pts], P))]
    assert to_host(tw.point_map(lambda a: a[:, :pts], got)) == want


@pytest.mark.parametrize("n", STEPS)
def test_pdbl_steps_match_reference(chain, n):
    """Step i of pdbl_steps(F, b3, P, n) equals i + 1 of the JAX package's
    doublings, and each step is a view of one contiguous steps-first block."""
    group, P, jsteps = chain
    (F, b3), _ = _ops(group)
    steps = tw.pdbl_steps(F, b3, P, n)
    assert len(steps) == n
    for i, s in enumerate(steps):
        _assert_same(s, jsteps[i])
        assert all(t.is_contiguous() and t._base is not None for t in tw.leaves(s))


@pytest.mark.parametrize("group", GROUPS)
def test_scalar_mul_bits_matches_reference(group):
    """The port's ladder (its bases from one steps launch) equals the JAX
    package's scalar_mul_bits on 16-bit scalars, zero and 2^16 - 1 among
    them, limb for limb."""
    (F, b3), (JF, jb3) = _ops(group)
    arrays = _lanes(group, LANES, seed=79)
    rng = np.random.default_rng(83)
    scalars = rng.integers(0, 1 << 16, LANES)
    scalars[:2] = (0, (1 << 16) - 1)
    bits = (scalars[None, :] >> np.arange(16)[:, None]) & 1  # (16, n) LSB first
    got = tw.scalar_mul_bits(F, b3, interop.point_from_numpy(arrays, DEV),
                             torch.from_numpy(bits.astype(np.int32)))
    _assert_same(got, jw.scalar_mul_bits(JF, jb3, _jax_point(arrays),
                                         jnp.asarray(bits.astype(np.uint32))))


C = 4
W = 4  # windows


def _jax_weighted_sum_base(F, b3, buckets, c: int):
    """The base case (c <= 5) of myzkp_tpu.curves.msm._weighted_bucket_sum,
    its calls as they are but its fori_loop run as a Python loop over the same
    body: the loop's XLA compile alone took 20 s of CPU over F_q2."""
    Gw = jax.tree_util.tree_leaves(buckets)[0].shape[1]
    num = 1 << c
    idx = jnp.arange(num)
    bitmask = ((idx[None, :] >> jnp.arange(c)[:, None]) & 1) == 1
    stacked = jmsm._point_map(
        lambda a: jnp.broadcast_to(a[:, :, None, :], a.shape[:2] + (c, num)), buckets)
    sel = jw.pselect(F, bitmask[None], stacked, jw.infinity(F, (Gw, c, num)))
    totals = jw.tree_sum(F, b3, sel, axis=2)
    acc = jw.infinity(F, (Gw,))
    for j in reversed(range(c)):  # high bit first
        acc = jw.padd(F, b3, jw.pdbl(F, b3, acc), jmsm._point_map(lambda a: a[:, :, j], totals))
    return acc


@pytest.mark.parametrize("group", GROUPS)
def test_window_sums_match_reference(group):
    """msm._window_sums at c = 4 over (W, 2^(c-1) + 1) buckets equals the
    window sums of the JAX package's msm_pippenger (signed digits): the
    weighted sum of buckets 0 .. half - 1, plus the top bucket doubled c - 1
    times."""
    (F, b3), (JF, jb3) = _ops(group)
    half = 1 << (C - 1)
    arrays = _lanes(group, W * (half + 1), seed=89)
    arrays = [a.reshape(16, W, half + 1) for a in arrays]
    got = tmsm._window_sums(F, b3, interop.point_from_numpy(arrays, DEV), C)
    buckets = _jax_point(arrays)
    main = jmsm._point_map(lambda a: a[..., :half], buckets)
    top = jmsm._point_map(lambda a: a[..., half], buckets)
    s_w = _jax_weighted_sum_base(JF, jb3, main, C - 1)
    for _ in range(C - 1):
        top = jw.pdbl(JF, jb3, top)
    _assert_same(got, jw.padd(JF, jb3, s_w, top))


@pytest.mark.parametrize("group", GROUPS)
def test_horner_matches_reference(group):
    """msm._horner at c = 4 over W window sums equals the JAX package's
    Horner step of msm_pippenger: most significant window first, c doublings
    and one add a window."""
    (F, b3), (JF, jb3) = _ops(group)
    arrays = _lanes(group, W, seed=97)
    got = tmsm._horner(F, b3, interop.point_from_numpy(arrays, DEV), C)
    s_w = _jax_point(arrays)
    res = jw.infinity(JF, ())
    for w in reversed(range(W)):
        for _ in range(C):
            res = jw.pdbl(JF, jb3, res)
        res = jw.padd(JF, jb3, res, jmsm._point_map(lambda a: a[:, w], s_w))
    _assert_same(got, res)


@pytest.mark.parametrize("group", GROUPS)
def test_chain_wrappers_raise_below_one_step(group):
    """K3's and K8's wrappers and plain versions raise for n < 1."""
    (F, b3), _ = _ops(group)
    P = interop.point_from_numpy(_lanes(group, 2, seed=101), DEV)
    wrap, ref = ((ck.pdbl2, ck.pdbl2_ref) if group == "g2" else (ck.pdbl, ck.pdbl_ref))
    for fn in (wrap, ref):
        for n in (0, -1):
            with pytest.raises(ValueError):
                fn(F.spec, b3, P, n)
            with pytest.raises(ValueError):
                fn(F.spec, b3, P, n, steps=True)
    with pytest.raises(ValueError):
        tw.pdbl_steps(F, b3, P, 0)


@pytest.mark.parametrize("group", GROUPS)
def test_chain_wrappers_take_plain_versions_on_cpu(group):
    """On CPU tensors K3's and K8's wrappers return their plain versions'
    canonical int32 limbs, steps-first with steps, and count no launch."""
    (F, b3), _ = _ops(group)
    P = interop.point_from_numpy(_lanes(group, LANES, seed=103), DEV)
    wrap, ref = ((ck.pdbl2, ck.pdbl2_ref) if group == "g2" else (ck.pdbl, ck.pdbl_ref))
    name = "pdbl2" if group == "g2" else "pdbl"
    _ext.reset_launches()
    for n, steps in ((3, False), (3, True)):
        got = tw.leaves(tw.Point(*wrap(F.spec, b3, P, n, steps=steps)))
        want = tw.leaves(tw.Point(*ref(F.spec, b3, P, n, steps=steps)))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
            assert tuple(g.shape) == ((n,) if steps else ()) + (16, LANES)
            assert int(g.min()) >= 0 and int(g.max()) < 1 << 16
    assert _ext.launches[name] == 0
