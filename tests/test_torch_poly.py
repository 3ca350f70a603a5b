"""Port parity: the polynomial layer of myzkp_tpu_torch against myzkp_tpu.

Fp's constructors, shape helpers and operators, ``ops/poly.py`` (evaluation,
powers, the schoolbook and NTT products, division, the zerofier and Lagrange
interpolation, ``Poly``'s methods) and ``ops/ntt.fast_multiply``: the same
numpy-seeded values go through both packages, and the outputs must agree
limb for limb (modular integers: the tolerance is 0).  BN254's scalar field
r.  On the CPU the port runs the plain versions of its kernels (K1, its
chain, K5).  The port evaluates and divides by log-depth formulations where
the reference scans; the values are the same.
"""

import numpy as np
import pytest
import torch

from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import BN254_R, FieldSpec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu.ops import poly as jpoly
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.commit import kzg
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops import ntt as tntt
from myzkp_tpu_torch.ops import poly as tpoly

DEV = "cpu"
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
P = BN254_R
JSPEC = FieldSpec.make(P)
TSPEC = tspec.bn254_r_spec()


def _ints(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]
    return np.asarray(vals, dtype=object).reshape(shape)


def _both(vals):
    return JFp.from_int(JSPEC, vals), Fp.from_int(TSPEC, vals, DEV)


def _same(got: Fp, want: JFp) -> None:
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(interop.limbs_to_numpy(got.mont), np.asarray(want.mont))


def test_fp_constructors_and_shape_helpers():
    _same(Fp.zeros(TSPEC, (2, 3), DEV), JFp.zeros(JSPEC, (2, 3)))
    _same(Fp.ones(TSPEC, (4,), DEV), JFp.ones(JSPEC, (4,)))
    _same(Fp.arange(TSPEC, 6, DEV), JFp.arange(JSPEC, 6))
    _same(Fp.full(TSPEC, (2, 3), P - 5, DEV), JFp.full(JSPEC, (2, 3), P - 5))
    vals = _ints((2, 3), 1)
    ja, ta = _both(vals)
    assert ta.ndim == ja.ndim == 2
    assert ta[1, 2].item() == ja[1, 2].item() == vals[1, 2]
    _same(ta.reshape(3, 2), ja.reshape(3, 2))
    _same(ta.reshape((6,)), ja.reshape((6,)))
    _same(ta[0].broadcast_to((4, 3)), ja[0].broadcast_to((4, 3)))
    jb, tb = _both(_ints((3,), 2))
    _same(ta.at_set((1, 0), tb[2]), ja.at_set((1, 0), jb[2]))
    _same(ta.at_set(0, tb), ja.at_set(0, jb))
    _same(ta.concat(ta[:1], axis=0), ja.concat(ja[:1], axis=0))
    _same(ta.concat(ta, axis=1), ja.concat(ja, axis=1))
    _same(Fp.stack([tb, tb * tb], axis=0), JFp.stack([jb, jb * jb], axis=0))
    _same(Fp.stack([tb, tb], axis=1), JFp.stack([jb, jb], axis=1))
    _same(ta.take(np.array([2, 0, 2]), axis=1), ja.take(np.array([2, 0, 2]), axis=1))
    _same(ta.flip(axis=1), ja.flip(axis=1))
    with pytest.raises(ValueError):
        ta.broadcast_to((3,))


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((3, 5), 0), ((3, 5), -1),
                                        ((2, 4, 3), 1)])
def test_fp_sum_matches_reference(shape, axis):
    """The pairwise sum, odd lengths included (a tail carried up a level)."""
    ja, ta = _both(_ints(shape, 3 + len(shape)))
    _same(ta.sum(axis=axis), ja.sum(axis=axis))


def test_fp_operators_match_reference():
    """Every operator, with Fp and int operands on either side; inv(0) = 0,
    x^0 = 1 and negative exponents (the inverse's power)."""
    vals = _ints((6,), 4)
    vals[0] = 0
    vals[1] = 1
    vals[2] = P - 1
    ja, ta = _both(vals)
    jb, tb = _both(_ints((6,), 5))
    k = 123456789
    for got, want in [(ta + tb, ja + jb), (ta + k, ja + k), (k + ta, k + ja),
                      (ta - tb, ja - jb), (ta - k, ja - k), (k - ta, k - ja),
                      (ta * tb, ja * jb), (ta * k, ja * k), (k * ta, k * ja),
                      (-ta, -ja), (ta ** 0, ja ** 0), (ta ** 1, ja ** 1),
                      (ta ** 5, ja ** 5), (ta ** -3, ja ** -3), (ta / tb, ja / jb),
                      (ta / k, ja / k), (ta.inv(), ja.inv()), (ta.square(), ja.square()),
                      (ta.batch_inv(), ja.batch_inv()),
                      (Fp.select(torch.tensor([True, False] * 3), ta, tb),
                       JFp.select(np.array([True, False] * 3), ja, jb))]:
        _same(got, want)
    np.testing.assert_array_equal(ta.is_zero().numpy(), np.asarray(ja.is_zero()))
    np.testing.assert_array_equal(ta.equals(ta * 1).numpy(), np.asarray(ja.equals(ja * 1)))
    assert ta[1].equals(1).item() and bool(ja[1].equals(1))
    assert ta.equals(1).tolist() == [False, True, False, False, False, False]


def test_fp_random_is_canonical_and_seeded():
    """Fp.random draws from a torch.Generator: canonical values below p, the
    same for the same seed, others for another."""
    draw = [Fp.random(TSPEC, torch.Generator().manual_seed(s), (3, 50), DEV)
            for s in (7, 7, 8)]
    assert draw[0].shape == (3, 50)
    assert (draw[0].mont == draw[1].mont).all()
    assert not (draw[0].mont == draw[2].mont).all()
    vals = draw[0].to_int().reshape(-1)
    assert all(0 <= int(v) < P for v in vals) and len(set(vals)) == vals.size
    assert ((draw[0].mont >= 0) & (draw[0].mont < 1 << 16)).all()


@pytest.mark.parametrize("n,xshape,cshape", [(13, (), ()), (13, (3,), ()), (1, (2,), ()),
                                             (5, (2,), (2,)), (4, (3, 1), (3,))])
def test_poly_eval_matches_reference(n, xshape, cshape):
    """Powers by doubling, one product and a pairwise sum against the
    reference's Horner scan, at its broadcasts (the coefficients' batch
    aligned left, x's right)."""
    jc, tc = _both(_ints(cshape + (n,), 10 + n))
    jx, tx = _both(_ints(xshape, 20 + n))
    _same(tpoly.poly_eval(tc, tx), jpoly.poly_eval(jc, jx))


@pytest.mark.parametrize("n", [1, 2, 13])
def test_powers_match_reference(n):
    jx, tx = _both(_ints((2,), 30 + n))
    _same(tpoly.powers(tx, n), jpoly.powers(jx, n))


def _divisor(bd: int, seed: int, zero_lead: bool = False):
    vals = _ints((bd + 1,), seed)
    if zero_lead:
        vals[bd] = 0
    return vals


@pytest.mark.parametrize("bd,zero_lead", [(0, False), (1, False), (3, False), (5, False),
                                          (2, True)])
def test_poly_divmod_matches_reference(bd, zero_lead):
    """Long division (and the scale at b_degree = 0), including a stated
    degree whose coefficient is 0: inv(0) = 0 gives q = 0 and r = a's low
    coefficients, as the reference."""
    ja, ta = _both(_ints((13,), 40 + bd))
    jb, tb = _both(_divisor(bd, 50 + bd, zero_lead))
    (tq, tr), (jq, jr) = tpoly.poly_divmod(ta, tb, bd), jpoly.poly_divmod(ja, jb, bd)
    _same(tq, jq)
    _same(tr, jr)
    if zero_lead:
        assert not tq.to_int().any()


def test_poly_divmod_pads_a_short_dividend():
    ja, ta = _both(_ints((2,), 60))
    jb, tb = _both(_divisor(3, 61))
    for t, j in zip(tpoly.poly_divmod(ta, tb, 3), jpoly.poly_divmod(ja, jb, 3)):
        _same(t, j)


@pytest.mark.parametrize("na,roots", [(13, [0]), (13, [5]), (8, None), (3, [7, 0, 11]),
                                      (1, [9])])
def test_divide_by_roots_matches_long_division(na, roots):
    """The suffix scans (one a root; u = 0 included) give the quotient and
    remainder of the reference's long division by prod (X - x_i)."""
    roots = list(_ints((3,), 70)) if roots is None else roots
    ja, ta = _both(_ints((na,), 71 + na))
    jx, tx = _both(roots)
    tq, tr = tpoly.divide_by_roots(ta, tx)
    jq, jr = jpoly.poly_divmod(ja, jpoly.from_monomials(jx), len(roots))
    _same(tq, jq)
    _same(tr, jr)


def test_from_monomials_and_lagrange_match_reference():
    """The zerofier and the interpolant through 3 points, for one row of ys
    and for ys with a leading batch dim (one JAX compile: the rows of the
    batch are independent)."""
    jx, tx = _both(_ints((3,), 83))
    jy, ty = _both(_ints((2, 3), 93))
    want = jpoly.lagrange_interpolate(jx, jy)
    _same(tpoly.from_monomials(tx), jpoly.from_monomials(jx))
    _same(tpoly.zerofier_poly(tx).coef, jpoly.from_monomials(jx))
    _same(tpoly.lagrange_interpolate(tx, ty), want)
    _same(tpoly.lagrange_interpolate(tx, ty[0]), want[0])
    _same(tpoly.interpolate_poly(tx, ty[1]).coef, want[1])


def _host_eval(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + int(c)) % P
    return acc


@pytest.mark.parametrize("n", [1, 4])
def test_from_monomials_and_lagrange_match_host(n):
    """At other point counts, against host ints: the zerofier vanishes on
    the points and is monic, the interpolant passes through them."""
    xs, ys = _ints((n,), 84 + n), _ints((n,), 94 + n)
    tx, ty = Fp.from_int(TSPEC, xs, DEV), Fp.from_int(TSPEC, ys, DEV)
    z = tpoly.from_monomials(tx).to_int()
    assert int(z[-1]) == 1 and all(_host_eval(z, int(x)) == 0 for x in xs)
    coef = tpoly.lagrange_interpolate(tx, ty).to_int()
    assert len(coef) == n
    assert [_host_eval(coef, int(x)) for x in xs] == [int(y) for y in ys]


@pytest.mark.parametrize("na,nb", [(16, 16), (16, 17), (1, 9), (13, 20)])
def test_poly_mul_matches_reference(na, nb):
    """Poly.__mul__ on both sides of na * nb = 256 (schoolbook, then the NTT),
    and the two products against each other."""
    ja, ta = _both(_ints((na,), 100 + na))
    jb, tb = _both(_ints((nb,), 110 + nb))
    want = (jpoly.Poly(ja) * jpoly.Poly(jb)).coef
    _same((tpoly.Poly(ta) * tpoly.Poly(tb)).coef, want)
    _same(tpoly._mul_schoolbook(ta, tb), want)
    _same(tntt.fast_multiply(ta, tb), want)


@pytest.mark.parametrize("out_len", [None, 10, 40])
def test_fast_multiply_matches_reference(out_len):
    ja, ta = _both(_ints((2, 13), 120))
    jb, tb = _both(_ints((20,), 121))
    _same(tntt.fast_multiply(ta, tb, out_len), jntt.fast_multiply(ja, jb, out_len))


def test_poly_methods_match_reference():
    """Poly's constructors, degree / trim, negation, powers, evaluation,
    p(c x), division and remainder."""
    TP, JP = tpoly.Poly, jpoly.Poly
    _same(TP.zero(TSPEC, 3, DEV).coef, JP.zero(JSPEC, 3).coef)
    _same(TP.one(TSPEC, 1, DEV).coef, JP.one(JSPEC, 1).coef)
    _same(TP.one(TSPEC, 4, DEV).coef, JP.one(JSPEC, 4).coef)
    _same(TP.x(TSPEC, DEV).coef, JP.x(JSPEC).coef)
    vals = list(_ints((6,), 130)) + [0, 0]
    ja, ta = _both(vals)
    jp, tp = JP(ja), TP(ta)
    assert tp.degree() == jp.degree() == 5
    assert TP.zero(TSPEC, 4, DEV).degree() == -1
    assert list(tp.to_int()) == vals
    _same(tp.trim().coef, jp.trim().coef)
    _same(TP.zero(TSPEC, 4, DEV).trim().coef, JP.zero(JSPEC, 4).trim().coef)
    _same((-tp).coef, (-jp).coef)
    _same((tp * 7).coef, (jp * 7).coef)
    _same((TP(ta[:3]) ** 3).coef, (JP(ja[:3]) ** 3).coef)
    _same((tp ** 0).coef, (jp ** 0).coef)
    jx, tx = _both(_ints((3,), 131))
    _same(tp(tx[0]), jp(jx[0]))
    _same(tp.eval_domain(tx), jp.eval_domain(jx))
    _same(tp.scale(5).coef, jp.scale(5).coef)
    _same(tp.scale(tx[1]).coef, jp.scale(jx[1]).coef)
    jd, td = _both(_ints((3,), 132))
    for t, j in [(tp / TP(td), jp / JP(jd)), (tp % TP(td), jp % JP(jd))]:
        _same(t.coef, j.coef)
    tq, tr = tp.divmod(TP(td), divisor_degree=2)
    jq, jr = jp.divmod(JP(jd), divisor_degree=2)
    _same(tq.coef, jq.coef)
    _same(tr.coef, jr.coef)


def test_new_constructors_default_to_the_card():
    """Without a device the new constructors (KZG's setup among them) put
    their tensors on the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    TP = tpoly.Poly
    for make in (lambda: Fp.zeros(TSPEC, (2,)), lambda: Fp.ones(TSPEC, (2,)),
                 lambda: Fp.arange(TSPEC, 3), lambda: Fp.full(TSPEC, (2,), 5),
                 lambda: Fp.random(TSPEC, torch.Generator().manual_seed(1), (2,)),
                 lambda: TP.zero(TSPEC, 3), lambda: TP.one(TSPEC, 3), lambda: TP.x(TSPEC),
                 lambda: kzg.setup(3, s=5)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
