"""Dense QAP from a dense R1CS, over the natural or the root-of-unity domain.

Counterpart of ``myzkp_tpu/arith/qap.py:21-137``: every witness column of L,
R and O is interpolated over the domain, all d columns of a matrix in one
batched call, and the target is t = prod (X - x_j).  The natural domain
(x = 1..m) interpolates by the batched Lagrange formula of ``ops/poly.py``
and divides ell r - o by t with the long division (K17 on the card); the
root-of-unity domain (x = w^j, m a power of two) interpolates by one batched
INTT, t = X^m - 1, and divides pointwise on a coset
(``arith/sparse.rou_quotient``, the sparse QAP's quotient).
"""

from __future__ import annotations

import torch

from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops import ntt as _ntt
from ..ops.poly import Poly, from_monomials, lagrange_interpolate, poly_eval
from .r1cs import R1CS
from .sparse import rou_quotient

# The natural domain's batched Lagrange interpolation of a (rows, m) batch
# forms a (rows, m, m) product, and its field sum int64 temporaries several
# times that: a matrix's rows go through it in batches of at most this many
# product elements (2 GiB at 64 B an element), with the same values.
_LAGRANGE_ELEMS = 1 << 25


class QAP:
    """ell, r, o: (d, m) coefficient batches, one polynomial per witness
    index; t: the target's (m + 1,) coefficients."""

    __slots__ = ("ell", "r", "o", "t", "m", "d")

    def __init__(self, ell: Fp, r: Fp, o: Fp, t: Fp, m: int, d: int):
        self.ell = ell
        self.r = r
        self.o = o
        self.t = t
        self.m = m
        self.d = d

    @property
    def spec(self) -> FieldSpec:
        return self.ell.spec

    @property
    def device(self) -> torch.device:
        return self.ell.device

    @classmethod
    def from_r1cs(cls, r1cs: R1CS, domain: str = "natural") -> "QAP":
        """domain="natural": x = 1..m, batched Lagrange interpolation (the
        reference's domain); domain="rou": the m-th roots of unity, one
        batched INTT a matrix (m a power of two)."""
        spec, dev = r1cs.spec, r1cs.left.device
        m, d = r1cs.num_constraints, r1cs.witness_len
        if domain == "rou":
            if m & (m - 1):
                raise ValueError(f"the root-of-unity domain needs a power-of-two m, not {m}")
            interp = _ntt.intt
            t = Fp.from_int(spec, [spec.p - 1] + [0] * (m - 1) + [1], dev)
        elif domain == "natural":
            xs = Fp.from_int(spec, list(range(1, m + 1)), dev)
            rows = max(1, _LAGRANGE_ELEMS // (m * m))
            interp = lambda ev: Fp(spec, torch.cat(
                [lagrange_interpolate(xs, ev[k:k + rows]).mont for k in range(0, d, rows)],
                dim=1))
            t = from_monomials(xs)
        else:
            raise ValueError(f"domain {domain!r}: expected 'natural' or 'rou'")
        # one (d, m) row per witness column, dense for the kernels, one
        # matrix at a time
        ell, r, o = (interp(Fp(spec, mat.mont.transpose(1, 2).contiguous()))
                     for mat in (r1cs.left, r1cs.right, r1cs.out))
        return cls(ell, r, o, t, m, d)

    def combine(self, assignment: Fp):
        """(sum_i a_i ell_i, sum_i a_i r_i, sum_i a_i o_i) as (m,)
        coefficient Polys; assignment: (d,)."""
        a = Fp(self.spec, assignment.mont[..., None])  # (d, 1)
        return tuple(Poly((polys * a).sum(axis=-2)) for polys in (self.ell, self.r, self.o))

    def h_poly(self, assignment: Fp) -> Poly:
        """h = (ell r - o) / t, exact iff the R1CS is satisfied: pointwise on
        a 2m coset when t = X^m - 1, else the long division by t (degree m,
        lead 1; 2m - 1 coefficients by m + 1)."""
        ell, r, o = self.combine(assignment)
        if self._is_rou_target():
            return self._h_poly_coset(ell, r, o)
        num = ell * r - o.pad_to(2 * self.m - 1)
        q, _ = num.divmod(Poly(self.t), divisor_degree=self.m)
        return q

    def _is_rou_target(self) -> bool:
        """t = X^m - 1, read back in one host copy of its m + 1 values."""
        if self.m & (self.m - 1):
            return False
        t = [int(v) for v in self.t.to_int()]
        return len(t) == self.m + 1 and t == [self.spec.p - 1] + [0] * (self.m - 1) + [1]

    def _h_poly_coset(self, ell: Poly, r: Poly, o: Poly) -> Poly:
        """(ell r - o) / (X^m - 1): its m + 1 low coefficients."""
        coef = Fp.stack([ell.coef, r.coef, o.coef])
        return Poly(rou_quotient(coef)[:self.m + 1])

    def eval_all_at(self, s: int):
        """(ell_i(s), r_i(s), o_i(s)) as (d,) batches and t(s) as a scalar
        Fp: the trusted setup's evaluation at its toxic waste."""
        s_fp = Fp.from_int(self.spec, s, self.device)
        return tuple(poly_eval(polys, s_fp) for polys in (self.ell, self.r, self.o, self.t))
