"""Port parity: the lane merge's segmented Hillis-Steele scan of
myzkp_tpu_torch.

The port's ``msm._seg_scan_hs`` (one level entry per level) and the plain
versions of its level kernels (``curve_kernels.padd_seg_level`` for G1,
``padd2_seg_level`` for G2, on the CPU) are held to the JAX package's
``myzkp_tpu.curves.msm._seg_scan_hs`` and to one level of it (its rolls,
selects and complete add), limb for limb, on the same numpy-seeded
projective points at G = 2 rows of B = 16 lanes.  Head patterns: every lane
a head, only lane 0, and random heads with lane 0 clear (so that lanes below
d add infinity); points include infinity.  Tolerance 0: these are modular
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
G, B = 2, 16


def _np_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).T.astype(np.uint32)


def _rand(rng: np.random.Generator, below: int) -> int:
    return int.from_bytes(rng.bytes(40), "little") % below


def _fq2_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q


def _lanes(group: str, rng, n_inf: int):
    """G * B lanes of random projective representatives (Montgomery form) of
    8 host points and, on n_inf random lanes, of infinity (0, lam, 0): 3
    (G1) or 6 (G2) numpy limb arrays of shape (16, G, B)."""
    g2 = group == "g2"
    gen = tbn.g2_generator() if g2 else tbn.g1_generator()
    pool = [gen * (1 + _rand(rng, tbn.R - 1)) for _ in range(8)]
    inf_at = set(rng.choice(G * B, n_inf, replace=False).tolist())
    cols = [[] for _ in range(6 if g2 else 3)]
    for k in range(G * B):
        p = pool[int(rng.integers(0, 8))]
        if g2:
            lam = (1 + _rand(rng, Q - 1), _rand(rng, Q))
            if k in inf_at:
                xyz = ((0, 0), lam, (0, 0))
            else:
                x, y = ((e.c[0].v, e.c[1].v) for e in (p.x, p.y))
                xyz = (_fq2_mul(x, lam), _fq2_mul(y, lam), lam)
            vals = [c for e in xyz for c in e]
        else:
            lam = 1 + _rand(rng, Q - 1)
            vals = (0, lam, 0) if k in inf_at else (int(p.x) * lam, int(p.y) * lam, lam)
        for col, v in zip(cols, vals):
            col.append(v * RMOD % Q)
    return tuple(_np_limbs(c).reshape(16, G, B) for c in cols)


def _heads(kind: str, rng) -> np.ndarray:
    if kind == "all":
        return np.ones((G, B), bool)
    if kind == "lane0":
        return np.arange(B)[None, :].repeat(G, 0) == 0
    h = rng.random((G, B)) < 0.3
    h[:, 0] = False  # lanes below d keep no flag: they add infinity
    return h


def _setup(group: str, heads: str, seed: int, n_inf: int = 3):
    rng = np.random.default_rng(seed)
    lanes, h = _lanes(group, rng, n_inf), _heads(heads, rng)
    g2 = group == "g2"
    port = (tbn.g2_ops(), tbn.g2_b3((), DEV)) if g2 else (tbn.g1_ops(), tbn.g1_b3((), DEV))
    ref = (jbn.g2_ops(), jbn.g2_b3(())) if g2 else (jbn.g1_ops(), jbn.g1_b3(()))
    a = [jnp.asarray(x) for x in lanes]
    jpt = jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5])) if g2 else jw.Point(*a)
    return port, ref, interop.point_from_numpy(lanes, DEV), jpt, h


def _assert_same(t_pt, j_pt):
    for t, j in zip(tw.leaves(t_pt), jax.tree_util.tree_leaves(j_pt)):
        np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


def _jax_level(F, b3, x, flags, d: int):
    """One level of myzkp_tpu.curves.msm._seg_scan_hs, as its loop body."""
    valid = (jnp.arange(B) >= d)[None, :]
    xs = jax.tree_util.tree_map(lambda a: jnp.roll(a, d, axis=-1), x)
    xs = jw.pselect(F, valid, xs, jw.infinity(F, flags.shape))
    fs = jnp.roll(flags, d, axis=-1) & valid
    return jw.pselect(F, flags, x, jw.padd(F, b3, xs, x)), flags | fs


CASES = [(g, h) for g in ("g1", "g2") for h in ("all", "lane0", "random")]


@pytest.mark.parametrize("group,heads", CASES)
def test_seg_scan_hs_matches_reference(group, heads):
    (F, b3), (JF, jb3), tpt, jpt, h = _setup(group, heads, seed=11)
    got = tmsm._seg_scan_hs(F, b3, tpt, torch.from_numpy(h))
    _assert_same(got, jmsm._seg_scan_hs(JF, jb3, jpt, jnp.asarray(h)))


@pytest.mark.parametrize("group,heads", CASES)
def test_seg_level_matches_reference(group, heads):
    """Each level of the plain level entry against the reference's level,
    out and flags', chained over d = 1, 2, 4, 8."""
    (F, b3), (JF, jb3), tpt, jpt, h = _setup(group, heads, seed=12)
    level = ck.padd2_seg_level if group == "g2" else ck.padd_seg_level
    x, flags, jx, jflags = tuple(tpt), torch.from_numpy(h), jpt, jnp.asarray(h)
    d = 1
    while d < B:
        x, flags = level(F.spec, b3, x, flags, d)
        jx, jflags = _jax_level(JF, jb3, jx, jflags, d)
        _assert_same(tw.Point(*x), jx)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
        d *= 2


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_seg_scan_hs_sums_segments_with_infinity(group):
    """A third of the lanes infinity, random heads: the port's scan equals the
    reference's, and each lane's value is the host sum of its segment up to
    it (lanes before the first head sum from lane 0)."""
    (F, b3), (JF, jb3), tpt, jpt, h = _setup(group, "random", seed=13, n_inf=G * B // 3)
    got = tmsm._seg_scan_hs(F, b3, tpt, torch.from_numpy(h))
    _assert_same(got, jmsm._seg_scan_hs(JF, jb3, jpt, jnp.asarray(h)))
    to_host = tbn.g2_points_to_host if group == "g2" else tbn.g1_points_to_host
    flat = lambda pt: to_host(tw.point_map(lambda a: a.reshape(16, -1), pt))
    inp, out = flat(tpt), flat(got)
    O = (tbn.curve_g2 if group == "g2" else tbn.curve_g1).infinity()
    for r in range(G):
        run = O
        for k in range(B):
            run = inp[r * B + k] + (O if h[r, k] else run)
            assert out[r * B + k] == run
