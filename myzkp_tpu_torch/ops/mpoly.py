"""Sparse multivariate polynomials over F_p.

Counterpart of ``myzkp_tpu/ops/mpoly.py`` (the reference's
``mpolynomials.rs``: a map from exponent tuples to coefficients).  The
symbolic algebra (ring ops, ``lift``, ``partial_evaluate``, ``evaluate``)
stays on the host over Python ints, term for term as the reference does it.
Two consumers run on the device:

- ``evaluate_batch``: evaluation at a whole batch of points, a power table
  per variable, then one product per exponent of each term (K1 on the card)
  and a sum over the terms; the sumcheck prover's factor tables;
- ``evaluate_symbolic``: substitution of univariate device polynomials for
  the variables (``Poly`` products and powers).

Results on the device follow the points' device (``evaluate_batch``) or the
polynomials' (``evaluate_symbolic``).
"""

from __future__ import annotations

from .. import _ext
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from .poly import Poly


class MPoly:
    """dictionary: {exponent tuple: int coefficient (mod p)}."""

    __slots__ = ("spec", "d")

    def __init__(self, spec: FieldSpec, d: dict | None = None):
        self.spec = spec
        clean = {}
        for exps, c in (d or {}).items():
            c = c % spec.p
            if c:
                clean[tuple(int(e) for e in exps)] = c
        self.d = clean

    # -- constructors ------------------------------------------------------
    @classmethod
    def constant(cls, spec: FieldSpec, v: int) -> "MPoly":
        return cls(spec, {(): v})

    @classmethod
    def variables(cls, spec: FieldSpec, n: int) -> list:
        """[x_0, ..., x_{n-1}] as MPolys."""
        out = []
        for i in range(n):
            e = [0] * n
            e[i] = 1
            out.append(cls(spec, {tuple(e): 1}))
        return out

    def num_variables(self) -> int:
        return max((len(e) for e in self.d), default=0)

    def is_zero(self) -> bool:
        return not self.d

    def degree(self) -> int:
        return max((sum(e) for e in self.d), default=0)

    # -- ring ops (host) -----------------------------------------------------
    def _pad(self, e, n):
        return tuple(e) + (0,) * (n - len(e))

    def __add__(self, o):
        o = self._coerce(o)
        n = max(self.num_variables(), o.num_variables())
        d = {}
        for src in (self.d, o.d):
            for e, c in src.items():
                k = self._pad(e, n)
                d[k] = (d.get(k, 0) + c) % self.spec.p
        return MPoly(self.spec, d)

    def __sub__(self, o):
        return self + (-self._coerce(o))

    def __neg__(self):
        return MPoly(self.spec, {e: -c for e, c in self.d.items()})

    def __mul__(self, o):
        o = self._coerce(o)
        n = max(self.num_variables(), o.num_variables())
        d = {}
        p = self.spec.p
        for e1, c1 in self.d.items():
            e1p = self._pad(e1, n)
            for e2, c2 in o.d.items():
                e2p = self._pad(e2, n)
                k = tuple(a + b for a, b in zip(e1p, e2p))
                d[k] = (d.get(k, 0) + c1 * c2) % p
        return MPoly(self.spec, d)

    __rmul__ = __mul__
    __radd__ = __add__

    def __pow__(self, k: int) -> "MPoly":
        result = MPoly.constant(self.spec, 1)
        base = self
        while k:
            if k & 1:
                result = result * base
            base = base * base
            k >>= 1
        return result

    def _coerce(self, o):
        if isinstance(o, MPoly):
            return o
        if isinstance(o, int):
            return MPoly.constant(self.spec, o)
        return NotImplemented

    def __eq__(self, o):
        return isinstance(o, MPoly) and self._norm() == o._norm()

    def _norm(self):
        n = self.num_variables()
        return {self._pad(e, n): c for e, c in self.d.items()}

    # -- lift / partial evaluation -------------------------------------------
    @classmethod
    def lift(cls, coeffs: list[int], spec: FieldSpec, var_index: int) -> "MPoly":
        """Univariate coefficients -> MPoly in variable var_index."""
        d = {}
        for k, c in enumerate(coeffs):
            if c % spec.p:
                e = [0] * (var_index + 1)
                e[var_index] = k
                d[tuple(e)] = c
        return cls(spec, d)

    def partial_evaluate(self, assignments: dict) -> "MPoly":
        """Substitute {var_index: int value} for a subset of variables."""
        p = self.spec.p
        d = {}
        for e, c in self.d.items():
            coef = c
            new_e = list(e)
            for idx, val in assignments.items():
                if idx < len(e) and e[idx]:
                    coef = coef * pow(val % p, e[idx], p) % p
                    new_e[idx] = 0
            k = tuple(new_e)
            d[k] = (d.get(k, 0) + coef) % p
        return MPoly(self.spec, d)

    # -- host evaluation -----------------------------------------------------
    def evaluate(self, point: list[int]) -> int:
        p = self.spec.p
        acc = 0
        for e, c in self.d.items():
            term = c
            for v, k in enumerate(e):
                if k:
                    term = term * pow(point[v] % p, k, p) % p
            acc = (acc + term) % p
        return acc

    # -- device batched evaluation ------------------------------------------
    def evaluate_batch(self, xs: Fp) -> Fp:
        """Evaluate at many points at once.  xs: (V, *batch) Fp (variable
        axis leading).  Returns (*batch) Fp on xs's device.

        pows[v][k] is x_v^k for 1 <= k <= the largest exponent of x_v (a
        view of xs at k = 1: x^0 is never read, a term skips its zero
        exponents); each term is its coefficient times one table entry per
        nonzero exponent, and the terms are summed in sorted order."""
        spec = self.spec
        batch = xs.shape[1:]
        dev = xs.device
        if not self.d:
            return Fp.zeros(spec, batch, dev)
        V = xs.shape[0]
        terms = sorted(self.d.items())
        max_e = [0] * V
        for e, _ in terms:
            for v in range(min(V, len(e))):
                max_e[v] = max(max_e[v], e[v])
        pows = []
        for v in range(V):
            tab = [None, xs[v]]
            for _ in range(1, max_e[v]):
                tab.append(tab[-1] * xs[v])
            pows.append(tab)
        coefs = Fp.from_int(spec, [c for _, c in terms], dev)  # one copy to the device
        acc = Fp.zeros(spec, batch, dev)
        for i, (e, _) in enumerate(terms):
            term = coefs[i].broadcast_to(batch)
            for v in range(min(V, len(e))):
                if e[v]:
                    term = term * pows[v][e[v]]
            acc = acc + term
        return acc

    # -- symbolic composition ------------------------------------------------
    def evaluate_symbolic(self, polys: list[Poly], capacity: int | None = None
                          ) -> Poly:
        """Substitute univariate device polynomials for the variables.  The
        result lies on the polynomials' device (on the card when none is
        given)."""
        spec = self.spec
        dev = polys[0].device if polys else _ext.resolve_device(None)
        if not self.d:
            return Poly.zero(spec, capacity or 1, dev)
        if capacity is None:
            deg = 0
            for e, _ in self.d.items():
                d_term = sum(
                    e[v] * max(polys[v].capacity - 1, 0)
                    for v in range(min(len(e), len(polys)))
                )
                deg = max(deg, d_term)
            capacity = deg + 1
        acc = Poly.zero(spec, capacity, dev)
        for e, c in sorted(self.d.items()):
            term = Poly.from_int_coeffs(spec, [c], dev)
            for v in range(min(len(e), len(polys))):
                if e[v]:
                    term = term * (polys[v] ** e[v])
            if term.capacity > capacity:
                term = Poly(term.coef[:capacity])
            acc = acc + term.pad_to(capacity)
        return acc
