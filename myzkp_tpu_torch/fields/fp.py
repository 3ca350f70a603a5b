"""Fp: a batch of prime-field elements in Montgomery form.

Counterpart of ``myzkp_tpu/fields/fp.py``: ``mont`` is an int32
``(L, *batch)`` limb tensor in Montgomery form, operators broadcast over the
batch dims (an int operand is a constant on the same device), and every
result is canonical, so it equals the reference limb for limb.  The
constructors make their tensors on the card unless the caller names another
device; ``random`` draws from a ``torch.Generator`` instead of a JAX key.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limb
from .spec import FieldSpec


class Fp:
    """Batched element(s) of F_p in Montgomery form."""

    __slots__ = ("spec", "mont")

    def __init__(self, spec: FieldSpec, mont: torch.Tensor):
        self.spec = spec
        self.mont = mont

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_int(cls, spec: FieldSpec, x, device=None) -> "Fp":
        """Host int(s) -> Montgomery form, on the card unless ``device``
        names another device."""
        return cls(spec, limb.to_mont(spec, limb.from_int(spec, x, device)))

    @classmethod
    def zeros(cls, spec: FieldSpec, batch_shape=(), device=None) -> "Fp":
        return cls(spec, limb.zeros(spec, batch_shape, device))

    @classmethod
    def ones(cls, spec: FieldSpec, batch_shape=(), device=None) -> "Fp":
        return cls(spec, limb.one_mont(spec, batch_shape, device).contiguous())

    @classmethod
    def arange(cls, spec: FieldSpec, n: int, device=None) -> "Fp":
        return cls.from_int(spec, np.arange(n, dtype=object), device)

    @classmethod
    def full(cls, spec: FieldSpec, batch_shape, value: int, device=None) -> "Fp":
        return cls.from_int(spec, value, device).broadcast_to(tuple(batch_shape))

    @classmethod
    def random(cls, spec: FieldSpec, gen: torch.Generator, batch_shape=(),
               device=None) -> "Fp":
        """Near-uniform elements, as the reference draws them: 2L random
        limbs x = lo + hi * R in [0, R^2) give lo + hi * R mod p (lo and hi
        reduced below p by conditional subtractions, hi * R by to_mont).
        The limbs are drawn on the generator's device."""
        return cls(spec, limb.to_mont(spec, limb.random(spec, gen, batch_shape, device)))

    # -- host round trip -----------------------------------------------------------
    def to_int(self):
        """numpy object array of Python ints (standard domain)."""
        return limb.to_int(self.spec, limb.from_mont(self.spec, self.mont))

    def item(self) -> int:
        return int(np.asarray(self.to_int()).reshape(()))

    # -- shape helpers -------------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.mont.shape[1:])

    @property
    def ndim(self) -> int:
        return self.mont.dim() - 1

    @property
    def device(self) -> torch.device:
        return self.mont.device

    def reshape(self, *shape) -> "Fp":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Fp(self.spec, self.mont.reshape((self.spec.L,) + tuple(shape)))

    def broadcast_to(self, shape) -> "Fp":
        """Broadcast the batch dims to ``shape`` (right-aligned, as numpy):
        the batch shape is padded with leading 1s past the limb axis first."""
        shape = tuple(shape)
        cur = self.shape
        if len(shape) < len(cur):
            raise ValueError(f"cannot broadcast batch {cur} to {shape}")
        m = self.mont.reshape((self.spec.L,) + (1,) * (len(shape) - len(cur)) + cur)
        return Fp(self.spec, m.expand((self.spec.L,) + shape))

    def __getitem__(self, idx) -> "Fp":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Fp(self.spec, self.mont[(slice(None),) + idx])

    def at_set(self, idx, value: "Fp") -> "Fp":
        """A copy with the batch positions ``idx`` set to ``value``."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        out = self.mont.clone()
        out[(slice(None),) + idx] = value.mont
        return Fp(self.spec, out)

    def concat(self, other: "Fp", axis: int = 0) -> "Fp":
        return Fp(self.spec, torch.cat([self.mont, other.mont], dim=_dim(axis)))

    @staticmethod
    def stack(xs, axis: int = 0) -> "Fp":
        return Fp(xs[0].spec, torch.stack([x.mont for x in xs], dim=_dim(axis)))

    def take(self, indices, axis: int = 0) -> "Fp":
        idx = torch.as_tensor(indices, device=self.device).long()
        dim = _dim(axis) % self.mont.dim()
        out = self.mont.index_select(dim, idx.reshape(-1))
        return Fp(self.spec, out.reshape(self.mont.shape[:dim] + idx.shape
                                         + self.mont.shape[dim + 1:]))

    def flip(self, axis: int = 0) -> "Fp":
        return Fp(self.spec, self.mont.flip(_dim(axis)))

    def pad_to(self, n: int) -> "Fp":
        """Zero-pad the last batch axis to length n (no-op when it is longer)."""
        cur = self.shape[-1]
        if cur >= n:
            return self
        return Fp(self.spec, torch.nn.functional.pad(self.mont, (0, n - cur)))

    def sum(self, axis: int = 0) -> "Fp":
        """Field sum along a batch axis by pairwise halving: log2(n) adds.

        Negative axes count from the last batch axis."""
        dim = _dim(axis) % self.mont.dim()
        m = self.mont
        n = m.shape[dim]
        while n > 1:
            half = n // 2
            s = limb.add(self.spec, m.narrow(dim, 0, half), m.narrow(dim, half, half))
            if n % 2:
                s = torch.cat([s, m.narrow(dim, 2 * half, 1)], dim=dim)
            m, n = s, s.shape[dim]
        return Fp(self.spec, m.squeeze(dim))

    # -- arithmetic ----------------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Fp):
            return other
        if isinstance(other, (int, np.integer)):
            return Fp(self.spec, limb.const(self.spec, self.spec.to_mont_int(int(other)),
                                            (), self.device))
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return Fp(self.spec, limb.add(self.spec, self.mont, o.mont))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return Fp(self.spec, limb.sub(self.spec, self.mont, o.mont))

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return Fp(self.spec, limb.sub(self.spec, o.mont, self.mont))

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return Fp(self.spec, limb.mont_mul(self.spec, self.mont, o.mont))

    __rmul__ = __mul__

    def __neg__(self) -> "Fp":
        return Fp(self.spec, limb.neg(self.spec, self.mont))

    def __pow__(self, e: int) -> "Fp":
        if e < 0:
            return self.inv() ** (-e)
        return Fp(self.spec, limb.pow_const(self.spec, self.mont, e))

    def __truediv__(self, other) -> "Fp":
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return self * o.inv()

    def inv(self) -> "Fp":
        """Fermat inverse; inv(0) = 0."""
        return Fp(self.spec, limb.inv(self.spec, self.mont))

    def batch_inv(self, axis: int = -1) -> "Fp":
        """Inverses along batch axis ``axis`` by one Montgomery-trick batch
        inversion; zeros map to zero."""
        return Fp(self.spec, limb.batch_inv(self.spec, self.mont, axis=_dim(axis)))

    def square(self) -> "Fp":
        return Fp(self.spec, limb.mont_sqr(self.spec, self.mont))

    # -- predicates ----------------------------------------------------------------
    def is_zero(self) -> torch.Tensor:
        return limb.is_zero(self.spec, self.mont)

    def equals(self, other) -> torch.Tensor:
        o = self._coerce(other)
        a, b = limb._broadcast_pair(self.spec.L, self.mont, o.mont)
        return limb.eq(self.spec, a, b)

    @staticmethod
    def select(mask, a: "Fp", b: "Fp") -> "Fp":
        return Fp(a.spec, limb.select(mask, a.mont, b.mont))

    def __repr__(self):
        return f"Fp(p={self.spec.p}, shape={self.shape}, device={self.device})"


def _dim(axis: int) -> int:
    """The limb tensor's dim of batch axis ``axis`` (the limb axis leads;
    a negative axis counts from the end either way)."""
    return axis + 1 if axis >= 0 else axis
