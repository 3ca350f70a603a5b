"""Field-operation bundle for the curve formulas: ``FpOps`` over limb tensors.

Counterpart of ``FpOps`` in ``myzkp_tpu/curves/field_ops.py``; elements are
``(L, *batch)`` int32 limb tensors in Montgomery form.  Constructors make
their tensors on the card unless ``device`` names another device.
"""

from __future__ import annotations

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

    def batch_inv(self, a, axis=-1):
        """Batch inversion along batch axis ``axis`` (limb axis excluded)."""
        return limb.batch_inv(self.spec, a, axis=axis + 1 if axis >= 0 else axis)

    def batch_shape(self, a):
        return tuple(a.shape[1:])
