"""BN254 on the device: field specs, curve constants, the host <-> device
point conversions for G1 and G2; and on the host, GT = F_q12, the optimal
ate pairing and the verifier's pairing check.

Counterpart of ``myzkp_tpu/curves/bn254.py:65-176, 179-304``.  The host side
(generators, affine group law, F_q2, the generic extension field and the
Miller loop) is ``fields/host.py``; the pairing runs on the host in the
port's copy of the C++ engine (``native/``), which raises if it cannot be
built or loaded.  ``optimal_ate_pairing_ref`` is the pure-Python loop the
tests hold that engine to.
"""

from __future__ import annotations

import functools

import torch

from .. import _ext, native
from ..fields import limb
from ..fields.host import (  # noqa: F401
    B2, Fq, Fq2, PyCurve, PyExt, PyExtField, PyPoint, Q, R, curve_g1, curve_g2,
    g1_generator, g2_generator, get_lambda, miller)
from ..fields.spec import FieldSpec
from ..utils.metrics import span
from . import weierstrass as wst
from .field_ops import FpOps, Fq2Ops

B1 = 3  # G1: y^2 = x^3 + 3
ATE_LOOP_COUNT = 29793968203157093288
# GT's field: F_q12 = F_q[w] / (w^12 - 18 w^6 + 82), and the curve over it
# that G1 embeds in and G2 untwists onto
Fq12 = PyExtField(Fq, [82] + [0] * 5 + [-18] + [0] * 5 + [1])
curve_g12 = PyCurve(Fq12([0]), Fq12([3]))


@functools.lru_cache(maxsize=1)
def q_spec() -> FieldSpec:
    return FieldSpec.make(Q)


@functools.lru_cache(maxsize=1)
def r_spec() -> FieldSpec:
    return FieldSpec.make(R)


@functools.lru_cache(maxsize=1)
def g1_ops() -> FpOps:
    return FpOps(q_spec())


@functools.lru_cache(maxsize=1)
def g2_ops() -> Fq2Ops:
    return Fq2Ops(q_spec())


def g1_b3(batch_shape=(), device=None) -> torch.Tensor:
    """3 * b = 9 in Montgomery form, (L, *batch_shape)."""
    return g1_ops().const(3 * B1, batch_shape, device)


def g2_b3(batch_shape=(), device=None) -> tuple:
    """3 * B2 (B2 = 3 / (9 + u)) in Montgomery form, a (c0, c1) pair."""
    b3 = tuple(3 * c.v % Q for c in B2.c)
    return g2_ops().const(b3, batch_shape, device)


def _mont(ints, device) -> torch.Tensor:
    spec = q_spec()
    return limb.to_mont(spec, limb.from_int(spec, ints, device))


def _with_infinity(F, inf: list, x, y, device) -> wst.Point:
    """Affine (x, y) batches -> projective points, (0, 1, 0) where inf."""
    m = torch.tensor(inf, dtype=torch.bool, device=device)
    n = len(inf)
    one, zero = F.one((n,), device), F.zeros((n,), device)
    return wst.Point(F.select(m, zero, x), F.select(m, one, y),
                     F.select(m, zero, one))


def g1_points_to_device(points, device=None) -> wst.Point:
    """Host PyPoints, (x, y) int pairs or None (infinity) -> point batch, on
    the card unless ``device`` names another device."""
    device = _ext.resolve_device(device)
    xs, ys, infs = [], [], []
    for p in points:
        if isinstance(p, PyPoint):
            inf = p.inf
            x, y = (0, 1) if inf else (int(p.x), int(p.y))
        elif p is None:
            inf, x, y = True, 0, 1
        else:
            (x, y), inf = p, False
        xs.append(x % Q)
        ys.append(y % Q)
        infs.append(inf)
    return _with_infinity(g1_ops(), infs, _mont(xs, device), _mont(ys, device),
                          device)


def g2_points_to_device(points, device=None) -> wst.Point:
    """Host G2 PyPoints, ((x0, x1), (y0, y1)) int pairs or None (infinity)
    -> point batch with (c0, c1) coordinates; infinity is (0, (1, 0), 0)."""
    device = _ext.resolve_device(device)
    cols = ([], [], [], [])  # x0, x1, y0, y1
    infs = []
    for p in points:
        if p is None or (isinstance(p, PyPoint) and p.inf):
            vals, inf = (0, 0, 1, 0), True
        elif isinstance(p, PyPoint):
            vals, inf = (p.x.c[0].v, p.x.c[1].v, p.y.c[0].v, p.y.c[1].v), False
        else:
            (x0, x1), (y0, y1) = p
            vals, inf = (x0, x1, y0, y1), False
        for col, v in zip(cols, vals):
            col.append(v % Q)
        infs.append(inf)
    x0, x1, y0, y1 = (_mont(col, device) for col in cols)
    return _with_infinity(g2_ops(), infs, (x0, x1), (y0, y1), device)


def _ints(*coords: torch.Tensor) -> list:
    """Montgomery limb tensors of one shape -> numpy arrays of host ints, out
    of the Montgomery domain in one product for all of them."""
    spec = q_spec()
    return list(limb.to_int(spec, limb.from_mont(spec, torch.stack(coords, 1))))


def g1_points_to_host(pt: wst.Point, axis: int = 0) -> list:
    """(n,) device point batch -> list of host PyPoints."""
    x, y, inf = wst.to_affine(g1_ops(), pt, axis=axis)
    xi, yi = _ints(x, y)
    with span("host read"):
        infn = inf.cpu().numpy()
    return [curve_g1.infinity() if infn[k]
            else curve_g1.point(Fq(int(xi[k])), Fq(int(yi[k])))
            for k in range(infn.shape[0])]


def g2_points_to_host(pt: wst.Point, axis: int = 0) -> list:
    """(n,) device G2 point batch -> list of host PyPoints."""
    x, y, inf = wst.to_affine(g2_ops(), pt, axis=axis)
    x0, x1, y0, y1 = _ints(*x, *y)
    with span("host read"):
        infn = inf.cpu().numpy()
    return [curve_g2.infinity() if infn[k]
            else curve_g2.point(Fq2([int(x0[k]), int(x1[k])]),
                                Fq2([int(y0[k]), int(y1[k])]))
            for k in range(infn.shape[0])]


def pairing_product_is_one(pairs) -> bool:
    """prod_i e(P_i, Q_i) == 1 for host (G1, G2) point pairs: one
    multi-pairing with a shared final exponentiation, on the host (the C++
    engine of ``native/``).  A verifier equality e(A, B) == e(C, D) is
    e(A, B) * e(-C, D) == 1."""
    return native.multi_pairing_coeffs(pairs) == [1] + [0] * 11


def cast_g1_to_g12(p: PyPoint) -> PyPoint:
    """A G1 point on the F_q12 curve."""
    if p.inf:
        return curve_g12.infinity()
    return curve_g12.point(Fq12([int(p.x)]), Fq12([int(p.y)]))


def twist_g2_to_g12(p: PyPoint) -> PyPoint:
    """A G2 point untwisted onto the F_q12 curve: with F_q2 embedded by
    u = w^6 - 9, (c0, c1) maps to (c0 - 9 c1) + c1 w^6; x then takes w^2 and
    y w^3."""
    if p.inf:
        return curve_g12.infinity()

    def embed(e) -> PyExt:
        c0, c1 = e.c[0].v, e.c[1].v
        coeffs = [0] * 12
        coeffs[0], coeffs[6] = (c0 - 9 * c1) % Q, c1
        return Fq12(coeffs)

    w = Fq12([0, 1])
    return curve_g12.point(embed(p.x) * w ** 2, embed(p.y) * w ** 3)


def optimal_ate_pairing(p_g1: PyPoint, q_g2: PyPoint) -> PyExt:
    """e(P, Q) in F_q12, by the C++ engine (``native.pairing_coeffs``)."""
    return Fq12(native.pairing_coeffs(p_g1, q_g2))


def optimal_ate_pairing_ref(p_g1: PyPoint, q_g2: PyPoint) -> PyExt:
    """e(P, Q) by the pure-Python Miller loop: the loop over
    ATE_LOOP_COUNT, the two Frobenius line steps, the final exponentiation
    by (q^12 - 1) / r.  The plain version the tests hold the engine to."""
    p, q = cast_g1_to_g12(p_g1), twist_g2_to_g12(q_g2)
    if p.inf or q.inf:
        return Fq12([1])
    f = Fq12([1])
    if p != q:
        f, r = miller(q, p, ATE_LOOP_COUNT)
        q1 = curve_g12.point(q.x ** Q, q.y ** Q)
        nq2 = curve_g12.point(q1.x ** Q, -(q1.y ** Q))
        f = f * get_lambda(r, q1, p)
        r = r + q1
        f = f * get_lambda(r, nq2, p)
    return f ** ((Q ** 12 - 1) // R)
