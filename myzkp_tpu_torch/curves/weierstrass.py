"""Batched short-Weierstrass arithmetic in homogeneous projective coordinates
with the complete formulas of Renes-Costello-Batina 2016 (a = 0).

Counterpart of ``myzkp_tpu/curves/weierstrass.py``.  A point batch is
``Point(x, y, z)``; each coordinate is an element of the ops bundle ``F``: an
``(L, *batch)`` Montgomery limb tensor for G1 (``FpOps``) or a ``(c0, c1)``
pair of them for G2 (``Fq2Ops``).  Infinity is (0, 1, 0).  The group law
itself is in the kernels of ``curve_kernels`` (K2, K3, K9 for G1; K7, K8, K10
for G2) and their plain versions; this layer accepts any strided input and
hands the kernels contiguous tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import curve_kernels
from .field_ops import Fq2Ops


class Point(NamedTuple):
    """Homogeneous projective point batch."""

    x: Any
    y: Any
    z: Any


def leaves(p: Point) -> tuple:
    """The coordinate tensors: (x, y, z) for G1, (x0, x1, y0, y1, z0, z1)
    for G2."""
    return tuple(t for e in p for t in (e if isinstance(e, tuple) else (e,)))


def from_leaves(ts) -> Point:
    """Inverse of ``leaves``: 3 tensors make a G1 point, 6 a G2 point."""
    ts = tuple(ts)
    if len(ts) == 3:
        return Point(*ts)
    if len(ts) == 6:
        return Point(ts[0:2], ts[2:4], ts[4:6])
    raise ValueError(f"a point has 3 or 6 coordinate tensors, not {len(ts)}")


def point_map(f, *pts: Point) -> Point:
    """Point of f applied to the corresponding coordinate tensors of pts."""
    return from_leaves(f(*ts) for ts in zip(*map(leaves, pts)))


def _contig(p: Point) -> Point:
    return point_map(torch.Tensor.contiguous, p)


def _contig_elem(e):
    """A field element (a tensor, or a (c0, c1) pair) with contiguous tensors."""
    return tuple(t.contiguous() for t in e) if isinstance(e, tuple) else e.contiguous()


def _kernels(F):
    """(add, double, mixed add) kernel wrappers for F's group: K7/K8/K10 over
    F_q2, else K2/K3/K9."""
    if isinstance(F, Fq2Ops):
        return curve_kernels.padd2, curve_kernels.pdbl2, curve_kernels.padd_mixed2
    return curve_kernels.padd, curve_kernels.pdbl, curve_kernels.padd_mixed


def infinity(F, batch_shape=(), device=None) -> Point:
    return Point(F.zeros(batch_shape, device), F.one(batch_shape, device),
                 F.zeros(batch_shape, device))


def from_affine(F, x, y) -> Point:
    """(x, y, 1) on the device of x."""
    dev = (x[0] if isinstance(x, tuple) else x).device
    return Point(x, y, F.one(F.batch_shape(x), dev))


def is_infinity(F, p: Point):
    return F.is_zero(p.z)


def padd(F, b3, p: Point, q: Point) -> Point:
    """Complete addition P + Q (RCB16 Algorithm 7), kernel K2 or K7."""
    return Point(*_kernels(F)[0](F.spec, b3, _contig(p), _contig(q)))


def padd_sel(F, b3, p: Point, q: Point, keep_q) -> Point:
    """select(keep_q, Q, P + Q) in one K2 or K7 launch."""
    return Point(*_kernels(F)[0](F.spec, b3, _contig(p), _contig(q),
                                 h=keep_q.contiguous()))


def padd_mixed(F, b3, p: Point, qx, qy) -> Point:
    """Complete mixed addition P + (qx, qy, 1) (RCB16 Algorithm 8), kernel K9
    or K10.  Q must not be infinity (the affine form cannot express it)."""
    return Point(*_kernels(F)[2](F.spec, b3, _contig(p), _contig_elem(qx),
                                 _contig_elem(qy)))


def padd_mixed_sel(F, b3, p: Point, qx, qy, keep_q) -> Point:
    """select(keep_q, (qx, qy, 1), P + Q) in one K9 or K10 launch."""
    return Point(*_kernels(F)[2](F.spec, b3, _contig(p), _contig_elem(qx),
                                 _contig_elem(qy), h=keep_q.contiguous()))


def pdbl(F, b3, p: Point, n: int = 1) -> Point:
    """2^n P: n >= 1 complete doublings (RCB16 Algorithm 9) in one launch of
    kernel K3 or K8."""
    return Point(*_kernels(F)[1](F.spec, b3, _contig(p), n))


def pdbl_steps(F, b3, p: Point, n: int) -> list:
    """[2P, 4P, ..., 2^n P] from one launch of K3 or K8 (n >= 1): each point
    a view of one step of the kernel's steps-first output."""
    steps = Point(*_kernels(F)[1](F.spec, b3, _contig(p), n, steps=True))
    return [point_map(lambda a: a[i], steps) for i in range(n)]


def pneg(F, p: Point) -> Point:
    return Point(p.x, F.neg(p.y), p.z)


def pselect(F, mask, p: Point, q: Point) -> Point:
    return Point(F.select(mask, p.x, q.x), F.select(mask, p.y, q.y),
                 F.select(mask, p.z, q.z))


def peq(F, b3, p: Point, q: Point):
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1 (both inf ok)."""
    inf_p, inf_q = is_infinity(F, p), is_infinity(F, q)
    ex = F.eq(F.mul(p.x, q.z), F.mul(q.x, p.z))
    ey = F.eq(F.mul(p.y, q.z), F.mul(q.y, p.z))
    return (inf_p & inf_q) | (ex & ey & ~(inf_p ^ inf_q))


def to_affine(F, p: Point, axis: int = -1):
    """(x, y, inf_mask) with one batch inversion of z along a batch axis."""
    x, y, z = p
    zinv = F.batch_inv(z, axis=axis)
    return F.mul(x, zinv), F.mul(y, zinv), F.is_zero(z)


def scalar_mul_bits(F, b3, p: Point, bits) -> Point:
    """[e]P with e given as an LSB-first (nbits, *batch) bit tensor.  The
    bases P, 2P, ..., 2^(nbits-1) P come from one steps launch of K3 or K8."""
    nbits = bits.shape[0]
    acc = infinity(F, F.batch_shape(p.x), leaves(p)[0].device)
    bases = [p] + (pdbl_steps(F, b3, p, nbits - 1) if nbits > 1 else [])
    for bit, base in zip(bits, bases):
        acc = pselect(F, bit > 0, padd(F, b3, acc, base), acc)
    return acc


def scalar_mul_const(F, b3, p: Point, e: int) -> Point:
    """[e]P for a host int e >= 0, the same e for every point: infinity for
    e = 0, else the LSB-first ladder of ``scalar_mul_bits`` over e's bits."""
    if e < 0:
        raise ValueError(f"scalar_mul_const takes e >= 0, not {e}")
    bshape = F.batch_shape(p.x)
    dev = leaves(p)[0].device
    if e == 0:
        return infinity(F, bshape, dev)
    bits = torch.tensor([(e >> i) & 1 for i in range(e.bit_length())], dtype=torch.int32,
                        device=dev)
    return scalar_mul_bits(F, b3, p, bits.reshape((-1,) + (1,) * len(bshape)).expand(
        (-1,) + bshape))


def tree_sum(F, b3, p: Point, axis: int = 0) -> Point:
    """EC sum of a point batch along a batch axis by halving: each level adds
    the top half onto the bottom half in one kernel launch, 2n adds in all.
    Sizes that are not a power of two are padded with infinity."""
    dim = axis + 1  # limb axis leads
    x0 = leaves(p)[0]
    n = x0.shape[dim]
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        pad_shape = list(x0.shape[1:])
        pad_shape[axis] = n2 - n
        inf = infinity(F, tuple(pad_shape), x0.device)
        p = point_map(lambda a, i: torch.cat([a, i], dim=dim), p, inf)
    m = n2
    while m > 1:
        m //= 2
        p = padd(F, b3, point_map(lambda a: a.narrow(dim, 0, m), p),
                 point_map(lambda a: a.narrow(dim, m, m), p))
    return point_map(lambda a: a.select(dim, 0), p)
