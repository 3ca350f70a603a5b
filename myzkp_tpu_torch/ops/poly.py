"""Dense univariate polynomials over Fp, low coefficient first.

Counterpart of ``myzkp_tpu/ops/poly.py``: the capacity is the last axis of
``coef`` (trailing zeros allowed), sums pad the shorter operand with zeros,
and a product goes to the schoolbook below 256 coefficient pairs and to the
NTT above.  The reference's sequential scans become formulations whose
launch count grows as log2(n) on the card, with the same field values:
evaluation is the powers of x by doubling, one product and a pairwise field
sum; division by X - u is a suffix scan of log2(n) Hillis-Steele levels (one
product and one add a level); division by prod_i (X - x_i) is one such scan
per point.  The loop whose trip count grows with the number of points
(``from_monomials``) stays a loop of vector steps.  The long division by a
general divisor is one call of kernel K17 (csrc/poly.cu, ``long_division``)
on the card, which takes a block of quotient coefficients a barrier, or runs a
narrow divisor as a chunked recurrence (``long_division_plan``); its plain
version ``long_division_ref`` runs the reference's na - bd steps as a loop of
vector steps.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _ext
from ..fields import limb
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..utils.metrics import span
from . import ntt as _ntt


class Poly:
    """Polynomial with Fp coefficients, low-first, static capacity."""

    __slots__ = ("coef",)

    def __init__(self, coef: Fp):
        self.coef = coef

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_int_coeffs(cls, spec: FieldSpec, coeffs, device=None) -> "Poly":
        return cls(Fp.from_int(spec, list(coeffs), device))

    @classmethod
    def zero(cls, spec: FieldSpec, capacity: int = 1, device=None) -> "Poly":
        return cls(Fp.zeros(spec, (capacity,), device))

    @classmethod
    def one(cls, spec: FieldSpec, capacity: int = 1, device=None) -> "Poly":
        return cls(Fp.ones(spec, (1,), device).pad_to(capacity))

    @classmethod
    def x(cls, spec: FieldSpec, device=None) -> "Poly":
        return cls.from_int_coeffs(spec, [0, 1], device)

    @property
    def spec(self) -> FieldSpec:
        return self.coef.spec

    @property
    def capacity(self) -> int:
        return self.coef.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.coef.device

    def degree(self) -> int:
        """Semantic degree (-1 for the zero polynomial); one host read."""
        nz = torch.nonzero(~self.coef.is_zero())
        return int(nz[-1, -1]) if nz.numel() else -1

    def to_int(self):
        return self.coef.to_int()

    def trim(self) -> "Poly":
        return Poly(self.coef[: max(1, self.degree() + 1)])

    def pad_to(self, n: int) -> "Poly":
        return Poly(self.coef.pad_to(n))

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, other: "Poly") -> "Poly":
        n = max(self.capacity, other.capacity)
        return Poly(self.coef.pad_to(n) + other.coef.pad_to(n))

    def __sub__(self, other: "Poly") -> "Poly":
        n = max(self.capacity, other.capacity)
        return Poly(self.coef.pad_to(n) - other.coef.pad_to(n))

    def __neg__(self) -> "Poly":
        return Poly(-self.coef)

    def __mul__(self, other) -> "Poly":
        if isinstance(other, (int, Fp)):
            return self.scale_const(other)
        na, nb = self.capacity, other.capacity
        if na * nb <= 256:
            return Poly(_mul_schoolbook(self.coef, other.coef))
        return Poly(_ntt.fast_multiply(self.coef, other.coef))

    __rmul__ = __mul__

    def scale_const(self, c) -> "Poly":
        """Every coefficient times the constant c (an int or an Fp)."""
        return Poly(self.coef * c)

    def __pow__(self, e: int) -> "Poly":
        result = Poly.one(self.spec, device=self.device)
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    # -- evaluation --------------------------------------------------------------
    def __call__(self, x: Fp) -> Fp:
        return poly_eval(self.coef, x)

    def eval_domain(self, xs: Fp) -> Fp:
        return poly_eval(self.coef, xs)

    def scale(self, c) -> "Poly":
        """p(c x): coef[i] *= c^i."""
        if isinstance(c, Fp):
            pows = powers(c, self.capacity)
        else:
            pows = _ntt.geometric_series(self.spec, int(c), self.capacity, self.device)
        return Poly(self.coef * pows)

    # -- division ---------------------------------------------------------------
    def divmod(self, divisor: "Poly", divisor_degree: int | None = None):
        dd = divisor.degree() if divisor_degree is None else divisor_degree
        q, r = poly_divmod(self.coef, divisor.coef, dd)
        return Poly(q), Poly(r)

    def __truediv__(self, other: "Poly") -> "Poly":
        return self.divmod(other)[0]

    def __mod__(self, other: "Poly") -> "Poly":
        return self.divmod(other)[1]

    def __repr__(self):
        return f"Poly(capacity={self.capacity}, device={self.device})"


# ---------------------------------------------------------------------------
# Functional forms
# ---------------------------------------------------------------------------

def powers(x: Fp, n: int) -> Fp:
    """[1, x, x^2, ..., x^(n-1)] along a new last axis, by doubling: each
    step multiplies the powers so far by x^k and squares x^k (2 log2(n)
    products)."""
    spec = x.spec
    out = Fp.ones(spec, x.shape + (1,), x.device).mont
    cur = x.mont[..., None]
    k = 1
    while k < n:
        out = torch.cat([out, limb.mont_mul(spec, out, cur)], dim=-1)
        cur = limb.mont_mul(spec, cur, cur)
        k *= 2
    return Fp(spec, out[..., :n])


def poly_eval(coef: Fp, x: Fp) -> Fp:
    """sum_i coef_i x^i; coef (..., n), x any batch shape.

    The result has the batch shape of the reference's Horner scan: coef's
    batch dims and x's broadcast right-aligned, with each coefficient's
    batch dims aligned left against it (as the scan broadcasts them)."""
    spec, L = coef.spec, coef.spec.L
    n = coef.shape[-1]
    cb, xb = coef.shape[:-1], x.shape
    out = tuple(torch.broadcast_shapes(cb, xb))
    c = coef.mont.reshape((L,) + cb + (1,) * (len(out) - len(cb)) + (n,))
    pw = powers(x, n).mont.reshape((L,) + (1,) * (len(out) - len(xb)) + xb + (n,))
    return Fp(spec, limb.mont_mul(spec, c, pw)).sum(axis=-1).broadcast_to(out)


def _mul_schoolbook(a: Fp, b: Fp) -> Fp:
    """Coefficient convolution for small sizes: every product a_i b_j in one
    product call, row i shifted by i (a pad and a reshape), and the rows
    summed pairwise."""
    spec = a.spec
    na, nb = a.shape[-1], b.shape[-1]
    outer = limb.mont_mul(spec, a.mont[..., :, None], b.mont[..., None, :])
    lead = tuple(outer.shape[:-2])
    rows = torch.nn.functional.pad(outer, (0, na)).reshape(lead + (na * (na + nb),))
    rows = rows[..., : na * (na + nb - 1)].reshape(lead + (na, na + nb - 1))
    return Fp(spec, rows).sum(axis=-2)


def _synthetic_div(a: Fp, u: Fp):
    """(q, a(u)) with a = q (X - u) + a(u): the suffix sums
    S_k = sum_j a_(k+j) u^j by Hillis-Steele levels S_k += u^d S_(k+d)
    (d = 1, 2, 4, ...), then q_(k-1) = S_k and the remainder is S_0.  u
    broadcasts against a's batch dims; u = 0 gives q_(k-1) = a_k."""
    spec = a.spec
    n = a.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-1], u.shape))
    s = a.broadcast_to(batch + (n,)).mont
    upow = u.mont[..., None]
    d = 1
    while d < n:
        hi = limb.mont_mul(spec, s[..., d:], upow)
        s = torch.cat([limb.add(spec, s[..., : n - d], hi), s[..., n - d:]], dim=-1)
        d *= 2
        if d < n:
            upow = limb.mont_mul(spec, upow, upow)
    return Fp(spec, s[..., 1:]), Fp(spec, s[..., 0])


def divide_by_roots(a: Fp, roots: Fp):
    """(q, r) with a = q Z + r for Z = prod_i (X - roots_i), deg r < t: the
    values poly_divmod(a, from_monomials(roots), t) gives.  Z is monic of
    degree t, so dividing by its linear factors one after another leaves its
    quotient; r is the low t coefficients of a - q Z.  roots: (t,)."""
    t = roots.shape[-1]
    a = a.pad_to(t + 1)
    q = a
    for i in range(t):
        q, _ = _synthetic_div(q, roots[i])
    qz = _mul_schoolbook(q.pad_to(t)[..., :t], from_monomials(roots))
    return q, a[..., :t] - qz[..., :t]


def long_division_ref(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, bd: int):
    """Plain version of K17: a (L, ..., na) by b (L, ..., >= bd + 1) of stated
    degree 1 <= bd < na, b's batch dims broadcasting against a's: na - bd
    steps, each one product and one subtraction on a bd-wide window.  The
    leading coefficient's inverse is inv(0) = 0 when it is zero, which gives
    q = 0 and r = a's low bd coefficients, as in the reference.  Returns q
    (L, ..., na - bd) and r (L, ..., bd)."""
    na = a.shape[-1]
    lead = limb.inv(spec, b[..., bd].contiguous())
    bl = b[..., :bd]
    rem = a.clone()
    qs = []
    for k in range(na - bd):
        pos = na - 1 - k
        c = limb.mont_mul(spec, rem[..., pos], lead)
        rem[..., pos - bd:pos] = limb.sub(spec, rem[..., pos - bd:pos],
                                          limb.mont_mul(spec, c[..., None], bl))
        rem[..., pos] = 0
        qs.append(c)
    return torch.stack(qs[::-1], dim=-1), rem[..., :bd]


_K17_MODES = ("rows", "chunks", "blocks")


def long_division_plan(rows: int, na: int, bd: int, words: int, device=None) -> dict:
    """The launch plan K17 takes on ``device`` (default: the card) for rows
    divisions of na coefficients by degree bd at ``words`` 32-bit words an
    element, as csrc/div_plan.cuh's ``plan_division`` makes it from the
    card's SM count and shared memory: ``mode`` ("rows": a thread a row;
    "chunks": P chunks of Lc steps a row; "blocks": B coefficients a row
    barrier on G blocks a row), ``p1`` (Lc or B), ``p2`` (P or G), ``T``,
    ``S``, ``per`` (rows a launch), ``global_window``, ``smem`` and
    ``scratch`` (bytes).  Launches nothing; raises where no plan exists."""
    dev = _ext.resolve_device(device)
    out = (ctypes.c_int64 * 9)()
    with torch.cuda.device(dev):
        err = _ext.library().myzkp_long_division_plan(rows, na, bd, words, out)
    if err:
        raise ValueError(f"K17 has no plan for {rows} rows of {na} coefficients at degree "
                         f"{bd}, {words} words: CUDA error {err}")
    keys = ("mode", "p1", "p2", "T", "S", "per", "global_window", "smem", "scratch")
    plan = dict(zip(keys, out))
    plan["mode"] = _K17_MODES[plan["mode"]]
    return plan


@span("long division")
def long_division_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, bd: int):
    """Launch K17 (csrc/poly.cu, the instance of spec's width) on CUDA
    tensors, the contract of long_division_ref: the rows of a's batch dims in
    one call, b broadcast to them (the launcher plans its kernel and
    launches: ``long_division_plan``); the leading coefficients' inverses by
    one launch of K1's chain (limb.inv)."""
    L, na = spec.L, a.shape[-1]
    if a.dtype != limb.I32 or b.dtype != limb.I32:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype}, expected {limb.I32}")
    if a.shape[0] != L or b.shape[0] != L or not 1 <= bd < na or b.shape[-1] < bd + 1:
        raise ValueError(f"long division of {tuple(a.shape)} by {tuple(b.shape)} "
                         f"at degree {bd}")
    batch = tuple(a.shape[1:-1])
    rows = math.prod(batch)
    a3 = a.reshape(L, rows, na).contiguous()
    bb = b[..., :bd + 1]  # its batch dims right-aligned against a's, as limb.mont_mul's
    bb = bb.reshape((L,) + (1,) * (len(batch) + 2 - bb.dim()) + tuple(bb.shape[1:]))
    b3 = bb.expand((L,) + batch + (bd + 1,)).reshape(L, rows, bd + 1).contiguous()
    lead = limb.inv(spec, b3[..., bd].contiguous())
    q = torch.empty((L, rows, na - bd), dtype=a.dtype, device=a.device)
    r = torch.empty((L, rows, bd), dtype=a.dtype, device=a.device)
    if rows:
        _ext.launch(_ext.kernel_name("long_division", spec), a.device, _ext.ptr(a3),
                    _ext.ptr(b3), _ext.ptr(lead), _ext.ptr(q), _ext.ptr(r), rows, na, bd,
                    _ext.consts_ptr(spec))
    return q.reshape((L,) + batch + (na - bd,)), r.reshape((L,) + batch + (bd,))


def _long_division(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, bd: int):
    """K17 on the card, its plain version on the CPU."""
    if not _ext.use_kernel(a, b):
        return long_division_ref(spec, a, b, bd)
    return long_division_cuda(spec, a, b, bd)


def poly_divmod(a: Fp, b: Fp, b_degree: int):
    """a = q b + r with deg r < b_degree, b_degree the stated degree of b
    (a zero coefficient there gives q = 0: inv(0) = 0).  q has capacity
    max(na, b_degree + 1) - b_degree and r max(b_degree, 1)."""
    spec = a.spec
    if b_degree == 0:
        c_inv = limb.inv(spec, b.mont[..., 0].contiguous())
        q = limb.mont_mul(spec, a.mont, c_inv[..., None])
        return Fp(spec, q), Fp.zeros(spec, a.shape[:-1] + (1,), a.device)
    a = a.pad_to(b_degree + 1)
    q, r = _long_division(spec, a.mont, b.pad_to(b_degree + 1).mont, b_degree)
    return Fp(spec, q), Fp(spec, r)


def from_monomials(xs: Fp) -> Fp:
    """Coefficients (n + 1 of them) of prod_i (X - x_i) for xs (n,): n steps
    of coef := X coef - x_i coef."""
    spec = xs.spec
    n = xs.shape[-1]
    coef = Fp.ones(spec, (1,), xs.device).pad_to(n + 1).mont
    zero = torch.zeros_like(coef[..., :1])
    for i in range(n):
        shifted = torch.cat([zero, coef[..., :-1]], dim=-1)
        coef = limb.sub(spec, shifted, limb.mont_mul(spec, coef, xs.mont[..., i:i + 1]))
    return Fp(spec, coef)


def zerofier_poly(xs: Fp) -> Poly:
    return Poly(from_monomials(xs))


def lagrange_interpolate(xs: Fp, ys: Fp) -> Fp:
    """Coefficients of the unique polynomial of degree < n through (xs, ys).

    The zerofier M = prod (X - x_i) once, every numerator M / (X - x_i) by
    one batched synthetic division, the weights y_i / M'(x_i) by one batch
    inversion (M'(x_i) = numerator_i(x_i)), and the weighted numerators
    summed.  ys may carry extra leading batch dims."""
    spec = xs.spec
    numer, _ = _synthetic_div(from_monomials(xs), xs)  # (n_i, n)
    mprime = poly_eval(numer, xs)
    w = ys * mprime.batch_inv(axis=-1)
    return Fp(spec, limb.mont_mul(spec, numer.mont, w.mont[..., None])).sum(axis=-2)


def interpolate_poly(xs: Fp, ys: Fp) -> Poly:
    return Poly(lagrange_interpolate(xs, ys))
