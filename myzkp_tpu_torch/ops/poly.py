"""Dense univariate polynomials over Fp, low coefficient first.

Counterpart of ``myzkp_tpu/ops/poly.py`` with what the prover's quotient
stage uses: the capacity is the last axis of ``coef`` (trailing zeros
allowed), and sums pad the shorter operand with zeros.
"""

from __future__ import annotations

from ..fields.fp import Fp
from ..fields.spec import FieldSpec


class Poly:
    """Polynomial with Fp coefficients, low-first, static capacity."""

    __slots__ = ("coef",)

    def __init__(self, coef: Fp):
        self.coef = coef

    @classmethod
    def from_int_coeffs(cls, spec: FieldSpec, coeffs, device=None) -> "Poly":
        return cls(Fp.from_int(spec, list(coeffs), device))

    @property
    def spec(self) -> FieldSpec:
        return self.coef.spec

    @property
    def capacity(self) -> int:
        return self.coef.shape[-1]

    def pad_to(self, n: int) -> "Poly":
        return Poly(self.coef.pad_to(n))

    def __add__(self, other: "Poly") -> "Poly":
        n = max(self.capacity, other.capacity)
        return Poly(self.coef.pad_to(n) + other.coef.pad_to(n))

    def __sub__(self, other: "Poly") -> "Poly":
        n = max(self.capacity, other.capacity)
        return Poly(self.coef.pad_to(n) - other.coef.pad_to(n))

    def scale_const(self, c: Fp) -> "Poly":
        """Every coefficient times the Fp scalar c."""
        return Poly(self.coef * c)
