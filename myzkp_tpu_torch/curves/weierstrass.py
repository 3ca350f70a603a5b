"""Batched short-Weierstrass arithmetic in homogeneous projective coordinates
with the complete formulas of Renes-Costello-Batina 2016 (a = 0).

Counterpart of ``myzkp_tpu/curves/weierstrass.py``.  A point batch is
``Point(x, y, z)``, each coordinate an ``(L, *batch)`` Montgomery limb tensor;
infinity is (0, 1, 0).  The group law itself is in the kernels of
``curve_kernels`` (K2, K3) and their plain versions; this layer accepts any
strided input and hands the kernels contiguous tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import curve_kernels


class Point(NamedTuple):
    """Homogeneous projective point batch."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _contig(p) -> tuple:
    return tuple(c.contiguous() for c in p)


def infinity(F, batch_shape=(), device=None) -> Point:
    return Point(F.zeros(batch_shape, device), F.one(batch_shape, device),
                 F.zeros(batch_shape, device))


def padd(F, b3, p: Point, q: Point) -> Point:
    """Complete addition P + Q (RCB16 Algorithm 7), kernel K2."""
    return Point(*curve_kernels.padd(F.spec, b3, _contig(p), _contig(q)))


def padd_sel(F, b3, p: Point, q: Point, keep_q) -> Point:
    """select(keep_q, Q, P + Q) in one K2 launch."""
    return Point(*curve_kernels.padd(F.spec, b3, _contig(p), _contig(q),
                                     h=keep_q.contiguous()))


def pdbl(F, b3, p: Point) -> Point:
    """Complete doubling 2P (RCB16 Algorithm 9), kernel K3."""
    return Point(*curve_kernels.pdbl(F.spec, b3, _contig(p)))


def pneg(F, p: Point) -> Point:
    return Point(p.x, F.neg(p.y), p.z)


def pselect(F, mask, p: Point, q: Point) -> Point:
    return Point(F.select(mask, p.x, q.x), F.select(mask, p.y, q.y),
                 F.select(mask, p.z, q.z))


def to_affine(F, p: Point, axis: int = -1):
    """(x, y, inf_mask) with one batch inversion of z along a batch axis."""
    x, y, z = p
    zinv = F.batch_inv(z, axis=axis)
    return F.mul(x, zinv), F.mul(y, zinv), F.is_zero(z)


def scalar_mul_bits(F, b3, p: Point, bits) -> Point:
    """[e]P with e given as an LSB-first (nbits, *batch) bit tensor."""
    acc = infinity(F, F.batch_shape(p.x), p.x.device)
    base = p
    for i in range(bits.shape[0]):
        acc = pselect(F, bits[i] > 0, padd(F, b3, acc, base), acc)
        if i + 1 < bits.shape[0]:
            base = pdbl(F, b3, base)
    return acc


def tree_sum(F, b3, p: Point, axis: int = 0) -> Point:
    """EC sum of a point batch along a batch axis by halving: each level adds
    the top half onto the bottom half in one K2 launch, 2n adds in all.
    Sizes that are not a power of two are padded with infinity."""
    dim = axis + 1  # limb axis leads
    n = p.x.shape[dim]
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        pad_shape = list(p.x.shape[1:])
        pad_shape[axis] = n2 - n
        inf = infinity(F, tuple(pad_shape), p.x.device)
        p = Point(*(torch.cat([a, i], dim=dim) for a, i in zip(p, inf)))
    m = n2
    while m > 1:
        m //= 2
        p = padd(F, b3, Point(*(a.narrow(dim, 0, m) for a in p)),
                 Point(*(a.narrow(dim, m, m) for a in p)))
    return Point(*(a.select(dim, 0) for a in p))
