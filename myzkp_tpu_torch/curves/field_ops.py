"""Field-operation bundles for the curve formulas: ``FpOps`` over limb
tensors and ``Fq2Ops`` over pairs of them.

Counterpart of ``myzkp_tpu/curves/field_ops.py``.  An Fp element is an
``(L, *batch)`` int32 limb tensor in Montgomery form; an Fq2 = F_q[u]/(u^2 + 1)
element is a ``(c0, c1)`` pair of such tensors.  Constructors make their
tensors on the card unless ``device`` names another device.
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import FieldSpec


class FpOps:
    """Prime-field ops on Montgomery limb tensors of shape (L, *batch)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def add(self, a, b):
        return limb.add(self.spec, a, b)

    def sub(self, a, b):
        return limb.sub(self.spec, a, b)

    def mul(self, a, b):
        return limb.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return limb.mont_mul(self.spec, a, a)

    def neg(self, a):
        return limb.neg(self.spec, a)

    def zeros(self, batch_shape=(), device=None):
        return limb.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None):
        return limb.one_mont(self.spec, batch_shape, device)

    def const(self, x: int, batch_shape=(), device=None):
        """Host int -> Montgomery limb tensor broadcast over batch."""
        return limb.const(self.spec, self.spec.to_mont_int(x), batch_shape,
                          device)

    def select(self, mask, a, b):
        return limb.select(mask, a, b)

    def is_zero(self, a):
        return limb.is_zero(self.spec, a)

    def eq(self, a, b):
        return limb.eq(self.spec, a, b)

    def inv(self, a):
        """Fermat inverse elementwise (inv(0) = 0): K1's chain on the card."""
        return limb.inv(self.spec, a)

    def batch_inv(self, a, axis=-1):
        """Batch inversion along batch axis ``axis`` (limb axis excluded)."""
        return limb.batch_inv(self.spec, a, axis=axis + 1 if axis >= 0 else axis)

    def batch_shape(self, a):
        return tuple(a.shape[1:])

    def stack(self, elems, axis=0):
        """Stack elements along a new batch axis ``axis``."""
        return torch.stack(elems, dim=axis + 1 if axis >= 0 else axis)

    def index(self, a, idx):
        """a[idx] over the batch axes (the limb axis kept)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return a[(slice(None),) + idx]

    def take(self, a, indices, axis=0):
        """The elements at ``indices`` along batch axis ``axis``."""
        idx = torch.as_tensor(indices, device=a.device)
        return torch.index_select(a, axis + 1, idx.reshape(-1)).reshape(
            a.shape[:axis + 1] + idx.shape + a.shape[axis + 2:])


class Fq2Ops:
    """F_q[u]/(u^2 + 1) ops on (c0, c1) pairs of limb tensors.

    The non-residue is -1, so (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) +
    ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u: Karatsuba, 3 base products."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.base = FpOps(spec)

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def mul(self, a, b):
        f = self.base
        t0 = f.mul(a[0], b[0])
        t1 = f.mul(a[1], b[1])
        t2 = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        return (f.sub(t0, t1), f.sub(t2, f.add(t0, t1)))

    def sqr(self, a):
        # (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
        f = self.base
        t = f.mul(a[0], a[1])
        return (f.mul(f.add(a[0], a[1]), f.sub(a[0], a[1])), f.add(t, t))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def zeros(self, batch_shape=(), device=None):
        return (self.base.zeros(batch_shape, device),
                self.base.zeros(batch_shape, device))

    def one(self, batch_shape=(), device=None):
        return (self.base.one(batch_shape, device),
                self.base.zeros(batch_shape, device))

    def const(self, x, batch_shape=(), device=None):
        """x: an int (embedded F_q) or a (c0, c1) int pair."""
        c0, c1 = x if isinstance(x, tuple) else (x, 0)
        return (self.base.const(c0, batch_shape, device),
                self.base.const(c1, batch_shape, device))

    def select(self, mask, a, b):
        s = self.base.select
        return (s(mask, a[0], b[0]), s(mask, a[1], b[1]))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 + a1^2), the norm inverted by the base field's
        ``inv`` (K1's chain on the card); inv(0) = 0."""
        f = self.base
        ninv = f.inv(f.add(f.sqr(a[0]), f.sqr(a[1])))
        return (f.mul(a[0], ninv), f.neg(f.mul(a[1], ninv)))

    def batch_inv(self, a, axis=-1):
        """(a0 - a1 u) / (a0^2 + a1^2), one base batch inversion of the norms."""
        f = self.base
        ninv = f.batch_inv(f.add(f.sqr(a[0]), f.sqr(a[1])), axis=axis)
        return (f.mul(a[0], ninv), f.neg(f.mul(a[1], ninv)))

    def batch_shape(self, a):
        return tuple(a[0].shape[1:])

    def stack(self, elems, axis=0):
        b = self.base
        return (b.stack([e[0] for e in elems], axis), b.stack([e[1] for e in elems], axis))

    def index(self, a, idx):
        return (self.base.index(a[0], idx), self.base.index(a[1], idx))

    def take(self, a, indices, axis=0):
        return (self.base.take(a[0], indices, axis), self.base.take(a[1], indices, axis))
