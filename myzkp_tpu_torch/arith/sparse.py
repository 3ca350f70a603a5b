"""Sparse R1CS and QAP over the 2^k root-of-unity domain.

Counterpart of ``myzkp_tpu/arith/sparse.py``: each of L, R, O is a COO matrix
(rows, cols, Montgomery vals); a matrix-vector product is one gather, one
Montgomery product (K1) and one field segment sum, O(nnz).  The QAP never
forms its (d, m) column polynomials: the matrix-vector products are the
evaluations of the combined polynomials over the domain, and one INTT each
gives their coefficients.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _ext
from ..fields import limb
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops import ntt as _ntt
from ..ops.poly import Poly


@dataclass
class SparseMatrix:
    """COO sparse (m x d) matrix over F_p; duplicate entries add up."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: Fp  # (nnz,) Montgomery
    shape: tuple  # (m, d)

    @classmethod
    def from_entries(cls, spec: FieldSpec, m: int, d: int, entries, device=None):
        """entries: iterable of (row, col, int value)."""
        device = _ext.resolve_device(device)
        entries = list(entries)
        idx = np.array([(e[0], e[1]) for e in entries], dtype=np.int64).reshape(-1, 2)
        rows = torch.from_numpy(idx[:, 0].copy()).to(device)
        cols = torch.from_numpy(idx[:, 1].copy()).to(device)
        vals = Fp.from_int(spec, [e[2] for e in entries], device)
        return cls(rows, cols, vals, (m, d))

    def matvec(self, a: Fp) -> Fp:
        """(m,) = M @ a for a: (d,)."""
        gathered = Fp(a.spec, a.mont.index_select(-1, self.cols))
        prod = self.vals * gathered
        return Fp(a.spec, limb.segment_sum_mod(a.spec, prod.mont, self.rows,
                                               self.shape[0]))

    def block(self, rows: torch.Tensor, cols: torch.Tensor, shape: tuple) -> "SparseMatrix":
        """The entries whose new row and column (``rows``, ``cols``: one
        index an entry, -1 to leave it out) are both kept, renumbered to
        them, as a matrix of ``shape``: a block of rows or of columns."""
        keep = ((rows >= 0) & (cols >= 0)).nonzero().squeeze(1)
        return SparseMatrix(rows[keep], cols[keep],
                            Fp(self.vals.spec, self.vals.mont.index_select(-1, keep)), shape)

    def col_accumulate(self, weights: Fp) -> Fp:
        """(d,) = M^T @ weights for weights: (m,)."""
        gathered = Fp(weights.spec, weights.mont.index_select(-1, self.rows))
        prod = self.vals * gathered
        return Fp(weights.spec, limb.segment_sum_mod(weights.spec, prod.mont,
                                                     self.cols, self.shape[1]))


@dataclass
class SparseR1CS:
    """Sparse (L, R, O) triple: L a * R a = O a row by row."""

    left: SparseMatrix
    right: SparseMatrix
    out: SparseMatrix

    @property
    def spec(self) -> FieldSpec:
        return self.left.vals.spec

    @property
    def num_constraints(self) -> int:
        return self.left.shape[0]

    @property
    def witness_len(self) -> int:
        return self.left.shape[1]

    def matvecs(self, assignment: Fp):
        return (self.left.matvec(assignment), self.right.matvec(assignment),
                self.out.matvec(assignment))

    def is_satisfied(self, assignment: Fp) -> bool:
        u, v, w = self.matvecs(assignment)
        return bool(torch.equal((u * v).mont, w.mont))


class SparseQAP:
    """QAP over the m-point root-of-unity domain, t(X) = X^m - 1."""

    def __init__(self, r1cs: SparseR1CS):
        m = r1cs.num_constraints
        if m & (m - 1):
            raise ValueError(f"the root-of-unity domain needs a power-of-two m, not {m}")
        self.r1cs = r1cs
        self.m = m
        self.d = r1cs.witness_len

    @property
    def spec(self) -> FieldSpec:
        return self.r1cs.spec

    @property
    def t(self) -> Fp:
        spec = self.spec
        return Fp.from_int(spec, [spec.p - 1] + [0] * (self.m - 1) + [1],
                           self.r1cs.left.rows.device)

    def evaluations(self, assignment: Fp) -> Fp:
        """The (3, m) constraint evaluations u, v, w: the three
        matrix-vector products, stacked."""
        return Fp(self.spec, torch.stack([x.mont for x in self.r1cs.matvecs(assignment)], dim=1))

    def combine_batched(self, assignment: Fp) -> Fp:
        """Coefficients (3, m) of the combined polynomials ell, r, o: one
        batched INTT of the three matrix-vector products."""
        return _ntt.intt(self.evaluations(assignment))

    def combine(self, assignment: Fp):
        coef = self.combine_batched(assignment)
        return tuple(Poly(coef[k]) for k in range(3))

    def quotient(self, coef: Fp) -> Fp:
        return rou_quotient(coef)

    def h_poly(self, assignment: Fp) -> Poly:
        return Poly(self.quotient(self.combine_batched(assignment))[:self.m + 1])

    def _lagrange_at(self, s: int) -> Fp:
        """lam_j(s) = w^j (s^m - 1) / (m (s - w^j)) over the root-of-unity
        domain, (m,); w^j comes from the device geometric series."""
        spec, m = self.spec, self.m
        p, dev = spec.p, self.r1cs.left.rows.device
        wj = _ntt.geometric_series(spec, _ntt.nth_root_of_unity(p, m), m, dev)
        denom = (Fp.from_int(spec, s, dev) - wj).batch_inv(axis=-1)
        scale = (pow(s, m, p) - 1) * pow(m, -1, p) % p
        return wj * denom * Fp.from_int(spec, scale, dev)

    def eval_blocks_at(self, s: int, blocks) -> list:
        """(ell_i(s), r_i(s), o_i(s)) as (hi - lo,) batches for the wires of
        each [lo, hi) in ``blocks``: lam_j(s) once, then per matrix its
        entries in the block's columns accumulated against it (ell_i(s) =
        sum_j L[j, i] lam_j(s)), O(nnz).  A rank's share of a split key's
        scalars holds no more than its block's entries."""
        lam = self._lagrange_at(s)
        out = []
        for lo, hi in blocks:
            def acc(mat: SparseMatrix) -> Fp:
                c = mat.cols
                sub = mat.block(mat.rows, torch.where((c >= lo) & (c < hi), c - lo, -1),
                                (self.m, hi - lo))
                return sub.col_accumulate(lam)

            out.append(tuple(acc(mat) for mat in (self.r1cs.left, self.r1cs.right,
                                                  self.r1cs.out)))
        return out

    def eval_all_at(self, s: int):
        """(ell_i(s), r_i(s), o_i(s)) as (d,) batches (``eval_blocks_at``
        over every wire) and t(s) as a scalar Fp."""
        (ell, r, o), = self.eval_blocks_at(s, [(0, self.d)])
        spec = self.spec
        t_s = Fp.from_int(spec, (pow(s, self.m, spec.p) - 1) % spec.p, ell.device)
        return ell, r, o, t_s


def rou_quotient(coef: Fp, transform=_ntt.transform) -> Fp:
    """(2m,) coefficients of h = (ell r - o) / t, t = X^m - 1, from ell, r,
    o's (3, m) coefficients: one batched coset NTT on g <w_2m> with g = w_4m,
    the pointwise division by t's two alternating coset values, one coset
    INTT.  ``transform``: ``ops/ntt.transform``, or a mesh's."""
    spec, m = coef.spec, coef.shape[-1]
    g = _ntt.nth_root_of_unity(spec.p, 4 * m)
    lro = _ntt.coset_evaluate(coef, g, 2 * m, transform)
    num = lro[0] * lro[1] - lro[2]
    return _ntt.coset_interpolate(num * _t_coset_inv(spec, m, g, num.device), g, transform)


def shifted_h_rou(uvw: Fp, d_ell: int, d_r: int, d_o: int, transform=_ntt.transform) -> Poly:
    """The m + 1 coefficients of H = h + ell d_r + r d_ell + t d_ell d_r - d_o
    over the m-point root-of-unity domain (t = X^m - 1), from the (3, m)
    constraint evaluations u, v, w: ell, r, o interpolate them (one batched
    inverse transform), h = (ell r - o) / t (``rou_quotient``), and
    t d_ell d_r - d_o is two coefficient corrections: -(d_ell d_r + d_o) at
    0 and +d_ell d_r at m.  ``transform``: ``ops/ntt.transform``, or a
    mesh's (``parallel/mesh.transform_over``)."""
    spec, m = uvw.spec, uvw.shape[-1]
    p, dev = spec.p, uvw.device
    scalar = lambda x: Fp.from_int(spec, x % p, dev)
    n1 = m + 1
    coef = transform(uvw, True)
    ell, r = Poly(coef[0]), Poly(coef[1])
    drdl, d_o_ = scalar(d_ell * d_r), scalar(d_o)
    corr = limb.zeros(spec, (n1,), dev)
    corr[:, 0] = limb.neg(spec, limb.add(spec, drdl.mont, d_o_.mont))
    corr[:, m] = drdl.mont
    return (Poly(rou_quotient(coef, transform)[:n1])
            + ell.scale_const(scalar(d_r)).pad_to(n1)
            + r.scale_const(scalar(d_ell)).pad_to(n1)
            + Poly(Fp(spec, corr)))


def _t_coset_inv(spec: FieldSpec, m: int, g: int, device) -> Fp:
    """1 / t on the coset g <w_2m>, (2m,): t(g w^j) = g^m (-1)^j - 1, two
    alternating values, inverted on the host and tiled (the reference
    inverts the tiled vector; the values are the same)."""
    p = spec.p
    gm = pow(g, m, p)
    pair = Fp.from_int(spec, [pow(gm - 1, -1, p), pow(-gm - 1, -1, p)], device)
    return Fp(spec, pair.mont.repeat(1, m))


# ---------------------------------------------------------------------------
# Benchmark circuits
# ---------------------------------------------------------------------------

def square_chain(spec: FieldSpec, m: int, x0: int = 3, device=None):
    """m-constraint squaring chain x_{k+1} = x_k^2 (m a power of two).

    Witness layout [1, x_0, x_1, ..., x_m] (d = m + 2).  Returns the sparse
    R1CS and a satisfying assignment, on the card unless ``device`` names
    another device."""
    if m & (m - 1):
        raise ValueError(f"m = {m} is not a power of two")
    device = _ext.resolve_device(device)
    d = m + 2
    k = np.arange(m, dtype=np.int64)
    rows = torch.from_numpy(k).to(device)
    ones = Fp.from_int(spec, [1] * m, device)

    def mat(col_off: int) -> SparseMatrix:
        cols = torch.from_numpy(k + col_off).to(device)
        return SparseMatrix(rows, cols, ones, (m, d))

    xs = [1, x0 % spec.p]
    for _ in range(m):
        xs.append(xs[-1] * xs[-1] % spec.p)
    return SparseR1CS(mat(1), mat(1), mat(2)), Fp.from_int(spec, xs, device)
