"""BN254 G1 on the device: field specs, curve constant and the host <-> device
point conversions.

Counterpart of the G1 half of ``myzkp_tpu/curves/bn254.py:179-286``.  The host
side (generator, affine group law) is ``fields/host.py``.
"""

from __future__ import annotations

import functools

import torch

from .. import _ext
from ..fields import limb
from ..fields.host import Fq, PyPoint, Q, R, curve_g1, g1_generator  # noqa: F401
from ..fields.spec import FieldSpec
from . import weierstrass as wst
from .field_ops import FpOps

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


def g1_b3(batch_shape=(), device=None) -> torch.Tensor:
    """3 * b = 9 in Montgomery form, (L, *batch_shape)."""
    return g1_ops().const(3 * B1, batch_shape, device)


def g1_points_to_device(points, device=None) -> wst.Point:
    """Host PyPoints, (x, y) int pairs or None (infinity) -> point batch, on
    the card unless ``device`` names another device."""
    device = _ext.resolve_device(device)
    F = g1_ops()
    spec = q_spec()
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
    x = limb.to_mont(spec, limb.from_int(spec, xs, device))
    y = limb.to_mont(spec, limb.from_int(spec, ys, device))
    m = torch.tensor(infs, dtype=torch.bool, device=device)
    n = len(points)
    one, zero = F.one((n,), device), F.zeros((n,), device)
    return wst.Point(F.select(m, zero, x), F.select(m, one, y),
                     F.select(m, zero, one))


def g1_points_to_host(pt: wst.Point, axis: int = 0) -> list:
    """(n,) device point batch -> list of host PyPoints."""
    F = g1_ops()
    spec = q_spec()
    x, y, inf = wst.to_affine(F, pt, axis=axis)
    xi = limb.to_int(spec, limb.from_mont(spec, x))
    yi = limb.to_int(spec, limb.from_mont(spec, y))
    infn = inf.cpu().numpy()
    return [curve_g1.infinity() if infn[k]
            else curve_g1.point(Fq(int(xi[k])), Fq(int(yi[k])))
            for k in range(infn.shape[0])]
