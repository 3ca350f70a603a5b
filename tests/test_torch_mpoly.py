"""Port parity: Fiat-Shamir, the FRI host helpers and MPoly of
myzkp_tpu_torch against myzkp_tpu.

The same numpy-seeded inputs go through both packages and the outputs must
agree exactly: transcript and challenge bytes byte for byte, MPoly dicts
term for term, device tables limb for limb (modular integers: the
tolerance is 0).  BN254's scalar field r.  On the CPU the port's products
run K1's plain version.  ``evaluate_batch`` runs at num_vars 1, 3, 4, 6 and
8: 4 gives a batch of 16 = L, the size at which the JAX package's round-2
broadcast bug hid (tests/test_sumcheck.py).
"""

import struct

import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.ops.mpoly import MPoly as JMPoly
from myzkp_tpu.ops.poly import Poly as JPoly
from myzkp_tpu.protocols import sumcheck as jsc
from myzkp_tpu.stark import fri as jfri
from myzkp_tpu.utils.fiat_shamir import FiatShamirTransformer as JFS
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.fields.spec import bn254_r_spec
from myzkp_tpu_torch.ops.mpoly import MPoly
from myzkp_tpu_torch.ops.poly import Poly
from myzkp_tpu_torch.protocols import sumcheck as sc
from myzkp_tpu_torch.stark import fri
from myzkp_tpu_torch.utils.fiat_shamir import FiatShamirTransformer as FS

DEV = "cpu"
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
R = jbn.R
JSPEC, SPEC = jbn.r_spec(), bn254_r_spec()


def _ints(n: int, rng: np.random.Generator) -> list:
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def random_dict(rng: np.random.Generator, num_vars: int, terms: int,
                max_exp: int = 1, ragged: bool = False) -> dict:
    """{exponent tuple: coefficient}: ``terms`` random terms over num_vars
    variables with exponents up to max_exp; ``ragged`` also gives tuples
    shorter than num_vars and a constant term."""
    d = {}
    for _ in range(terms):
        n = int(rng.integers(0, num_vars + 1)) if ragged else num_vars
        d[tuple(int(v) for v in rng.integers(0, max_exp + 1, n))] = _ints(1, rng)[0]
    if ragged:
        d[()] = _ints(1, rng)[0]
    d[(max_exp,) * num_vars] = _ints(1, rng)[0]  # the full length is reached
    return d


def both(d: dict):
    return MPoly(SPEC, d), JMPoly(JSPEC, d)


# ---------------------------------------------------------------------------
# Fiat-Shamir and the FRI helpers
# ---------------------------------------------------------------------------

def _pushes(rng) -> list:
    return [[struct.pack("<Q", 5)], [rng.bytes(32)], [],
            [rng.bytes(int(k)) for k in rng.integers(0, 70, 4)], [b""]]


def test_fiat_shamir_matches_jax():
    """Serialize / deserialize round trips; prover and verifier challenge
    bytes equal to the JAX package's after the same pushes and pulls."""
    rng = np.random.default_rng(1)
    fs, jfs = FS(), JFS()
    for obj in _pushes(rng):
        fs.push(obj)
        jfs.push(obj)
        assert fs.prover_fiat_shamir(32) == jfs.prover_fiat_shamir(32)
        assert fs.prover_fiat_shamir(64) == jfs.prover_fiat_shamir(64)
    bb = fs.serialize()
    assert bb == jfs.serialize()
    back, jback = FS.deserialize(bb), JFS.deserialize(bb)
    assert back.objects == fs.objects == jback.objects
    assert back.serialize() == bb
    for _ in range(3):
        assert back.pull() == jback.pull()
        assert back.verifier_fiat_shamir(32) == jback.verifier_fiat_shamir(32)
    assert back.verifier_fiat_shamir(32) != back.prover_fiat_shamir(32)
    with pytest.raises(IndexError):
        FS().pull()


def test_fri_helpers_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(4):
        data = rng.bytes(32)
        assert fri.sample_field(SPEC, data) == jfri.sample_field(JSPEC, data)
    xs, ys = list(range(4)), _ints(4, rng)
    coeffs = fri._host_interpolate(xs, ys, R)
    assert coeffs == jfri._host_interpolate(xs, ys, R)
    assert [fri._host_eval(coeffs, x, R) for x in xs] == ys
    x = _ints(1, rng)[0]
    assert fri._host_eval(coeffs, x, R) == jfri._host_eval(coeffs, x, R)


# ---------------------------------------------------------------------------
# MPoly: host algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_exp, ragged", [(1, False), (3, True)])
def test_mpoly_host_algebra_matches_jax(max_exp, ragged):
    """Ring ops, powers, partial evaluation, evaluation, lift and _norm on
    seeded polynomials, multilinear and not (exponents up to 3, tuples
    shorter than num_vars, a constant term): every dict equal."""
    rng = np.random.default_rng(10 + max_exp)
    (a, ja), (b, jb) = (both(random_dict(rng, 4, 5, max_exp, ragged)) for _ in range(2))
    (c, jc) = both(random_dict(rng, 2, 3, max_exp, ragged))
    pairs = [(a + b, ja + jb), (a - b, ja - jb), (-a, -ja), (a * c, ja * jc),
             (a * 7, ja * 7), (3 + c, 3 + jc), (c ** 3, jc ** 3), (a ** 0, ja ** 0)]
    for got, want in pairs:
        assert got.d == want.d
        assert got._norm() == want._norm()
        assert (got.num_variables(), got.degree(), got.is_zero()) == \
            (want.num_variables(), want.degree(), want.is_zero())
    assert a * c == c * a and a != b and (a - a).is_zero()
    assert [v.d for v in MPoly.variables(SPEC, 3)] == [v.d for v in JMPoly.variables(JSPEC, 3)]
    assert MPoly.constant(SPEC, R + 5).d == JMPoly.constant(JSPEC, R + 5).d
    coeffs = _ints(4, rng) + [0, R]
    assert MPoly.lift(coeffs, SPEC, 2).d == JMPoly.lift(coeffs, JSPEC, 2).d
    for assign in ({0: 5}, {1: _ints(1, rng)[0], 3: 0}, {0: 1, 1: 2, 2: 3, 3: 4}, {7: 9}):
        assert a.partial_evaluate(assign).d == ja.partial_evaluate(assign).d
    for point in (_ints(4, rng), [0, 1, 0, 1], [0] * 4):
        assert a.evaluate(point) == ja.evaluate(point)


# ---------------------------------------------------------------------------
# MPoly: device evaluation and the hypercube
# ---------------------------------------------------------------------------

def _limbs(x) -> np.ndarray:
    return x.mont.numpy().astype(np.uint32) if isinstance(x, Fp) else np.asarray(x.mont)


@pytest.mark.parametrize("num_vars", [1, 3, 4, 6, 8])
def test_evaluate_batch_matches_jax(num_vars):
    """evaluate_batch over the hypercube (a multilinear g, and one with
    exponents up to 3 and short tuples) equal to the JAX package's limb
    for limb and to the host evaluation."""
    rng = np.random.default_rng(20 + num_vars)
    pts, jpts = sc.hypercube_points(SPEC, num_vars, DEV), jsc.hypercube_points(JSPEC, num_vars)
    cube = list(jsc.bit_combinations(num_vars))
    for d in (random_dict(rng, num_vars, 6), random_dict(rng, num_vars, 6, 3, True)):
        g, jg = both(d)
        got = g.evaluate_batch(pts)
        np.testing.assert_array_equal(_limbs(got), _limbs(jg.evaluate_batch(jpts)))
        assert [int(v) for v in got.to_int()] == [g.evaluate(c) for c in cube]


def test_evaluate_batch_2d_batch_and_zero():
    """A (V, 2, 4) batch of random points (not the hypercube's), and the
    zero polynomial."""
    rng = np.random.default_rng(30)
    g, jg = both(random_dict(rng, 3, 5, 2, True))
    vals = np.asarray(_ints(24, rng), dtype=object).reshape(3, 2, 4)
    xs = Fp.from_int(SPEC, vals, DEV)
    jxs = interop.fp_to_numpy(xs)
    from myzkp_tpu.fields.fp import Fp as JFp

    got = g.evaluate_batch(xs)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(_limbs(got), _limbs(jg.evaluate_batch(JFp(JSPEC, jxs))))
    flat = vals.reshape(3, 8)
    assert [int(v) for v in got.to_int().reshape(8)] == \
        [g.evaluate(list(flat[:, k])) for k in range(8)]
    zero = MPoly(SPEC, {}).evaluate_batch(xs)
    assert zero.shape == (2, 4) and not zero.mont.any()


@pytest.mark.parametrize("num_vars", [0, 1, 3, 5])
def test_hypercube_points_matches_from_int(num_vars):
    """The device-built table equals Fp.from_int of the bit lists (the JAX
    package's construction) and the JAX table, limb for limb."""
    pts = sc.hypercube_points(SPEC, num_vars, DEV)
    idx = np.arange(1 << num_vars)
    bits = np.stack([(idx >> i) & 1 for i in range(num_vars)]) if num_vars else \
        np.zeros((0, 1), dtype=np.int64)
    want = Fp.from_int(SPEC, bits.tolist(), DEV) if num_vars else Fp.zeros(SPEC, (0, 1), DEV)
    assert pts.shape == (num_vars, 1 << num_vars)
    assert torch.equal(pts.mont, want.mont)
    if num_vars:
        np.testing.assert_array_equal(_limbs(pts), _limbs(jsc.hypercube_points(JSPEC, num_vars)))


def test_sum_over_boolean_hypercube_matches_jax():
    rng = np.random.default_rng(40)
    for d in (random_dict(rng, 5, 6), random_dict(rng, 3, 4, 3, True), {(): 42}):
        g, jg = both(d)
        assert sc.sum_over_boolean_hypercube(g, DEV) == jsc.sum_over_boolean_hypercube(jg)


def test_evaluate_symbolic_matches_jax():
    """Substitution of univariate polynomials: coefficients equal to the
    JAX package's at the default capacity and at a cut one."""
    rng = np.random.default_rng(50)
    g, jg = both(random_dict(rng, 3, 4, 2, True))
    cs = [_ints(k, rng) for k in (3, 2, 4)]
    polys = [Poly.from_int_coeffs(SPEC, c, DEV) for c in cs]
    jpolys = [JPoly.from_int_coeffs(JSPEC, c) for c in cs]
    for cap in (None, 5):
        got, want = g.evaluate_symbolic(polys, cap), jg.evaluate_symbolic(jpolys, cap)
        assert [int(v) for v in got.to_int()] == [int(v) for v in want.coef.to_int()]
    assert MPoly(SPEC, {}).evaluate_symbolic(polys).capacity == 1
