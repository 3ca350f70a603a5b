"""BN254 on the device: field specs, curve constants, the host <-> device
point conversions for G1 and G2, and the verifier's pairing check.

Counterpart of ``myzkp_tpu/curves/bn254.py:123-154, 179-304``.  The host side
(generators, affine group law, F_q2) is ``fields/host.py``; the pairing runs
on the host in the port's copy of the C++ engine (``native/``).
"""

from __future__ import annotations

import functools

import torch

from .. import _ext, native
from ..fields import limb
from ..fields.host import (  # noqa: F401
    B2, Fq, Fq2, PyPoint, Q, R, curve_g1, curve_g2, g1_generator, g2_generator)
from ..fields.spec import FieldSpec
from . import weierstrass as wst
from .field_ops import FpOps, Fq2Ops

B1 = 3  # G1: y^2 = x^3 + 3


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


def _ints(a: torch.Tensor):
    spec = q_spec()
    return limb.to_int(spec, limb.from_mont(spec, a))


def g1_points_to_host(pt: wst.Point, axis: int = 0) -> list:
    """(n,) device point batch -> list of host PyPoints."""
    x, y, inf = wst.to_affine(g1_ops(), pt, axis=axis)
    xi, yi = _ints(x), _ints(y)
    infn = inf.cpu().numpy()
    return [curve_g1.infinity() if infn[k]
            else curve_g1.point(Fq(int(xi[k])), Fq(int(yi[k])))
            for k in range(infn.shape[0])]


def g2_points_to_host(pt: wst.Point, axis: int = 0) -> list:
    """(n,) device G2 point batch -> list of host PyPoints."""
    x, y, inf = wst.to_affine(g2_ops(), pt, axis=axis)
    x0, x1, y0, y1 = (_ints(c) for c in (*x, *y))
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
