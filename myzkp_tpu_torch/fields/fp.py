"""Fp: a batch of prime-field elements in Montgomery form.

Counterpart of ``myzkp_tpu/fields/fp.py`` with what the Pinocchio setup and
prover use: ``mont`` is an int32 ``(L, *batch)`` limb tensor in Montgomery
form, operators broadcast over the batch dims, and every result is
canonical, so it equals the reference limb for limb.
"""

from __future__ import annotations

import torch

from . import limb
from .spec import FieldSpec


class Fp:
    """Batched element(s) of F_p in Montgomery form."""

    __slots__ = ("spec", "mont")

    def __init__(self, spec: FieldSpec, mont: torch.Tensor):
        self.spec = spec
        self.mont = mont

    @classmethod
    def from_int(cls, spec: FieldSpec, x, device=None) -> "Fp":
        """Host int(s) -> Montgomery form, on the card unless ``device``
        names another device."""
        return cls(spec, limb.to_mont(spec, limb.from_int(spec, x, device)))

    def to_int(self):
        """numpy object array of Python ints (standard domain)."""
        return limb.to_int(self.spec, limb.from_mont(self.spec, self.mont))

    @property
    def shape(self) -> tuple:
        return tuple(self.mont.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.mont.device

    def __getitem__(self, idx) -> "Fp":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Fp(self.spec, self.mont[(slice(None),) + idx])

    def __add__(self, other: "Fp") -> "Fp":
        return Fp(self.spec, limb.add(self.spec, self.mont, other.mont))

    def __sub__(self, other: "Fp") -> "Fp":
        return Fp(self.spec, limb.sub(self.spec, self.mont, other.mont))

    def __mul__(self, other: "Fp") -> "Fp":
        return Fp(self.spec, limb.mont_mul(self.spec, self.mont, other.mont))

    def batch_inv(self, axis: int = -1) -> "Fp":
        """Inverses along batch axis ``axis`` by one Montgomery-trick batch
        inversion; zeros map to zero."""
        ax = axis + 1 if axis >= 0 else axis
        return Fp(self.spec, limb.batch_inv(self.spec, self.mont, axis=ax))

    def pad_to(self, n: int) -> "Fp":
        """Zero-pad the last batch axis to length n (no-op when it is longer)."""
        cur = self.shape[-1]
        if cur >= n:
            return self
        return Fp(self.spec, torch.nn.functional.pad(self.mont, (0, n - cur)))
