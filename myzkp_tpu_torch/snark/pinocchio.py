"""Pinocchio prover pieces over the sparse QAP.

Counterpart of ``myzkp_tpu/snark/pinocchio.py``; so far the quotient stage,
``get_shifted_h``, with the semantics of ``_jitted_shifted_h_rou``
(pinocchio.py:332-388).  Setup, prove and verify come in a later slice.
"""

from __future__ import annotations

from ..arith.sparse import SparseQAP
from ..fields import limb
from ..fields.fp import Fp
from ..ops.poly import Poly


def get_shifted_h(qap: SparseQAP, assignment: Fp, d_ell: int, d_r: int,
                  d_o: int) -> Poly:
    """The m + 1 coefficients of H = h + ell d_r + r d_ell + t d_ell d_r - d_o.

    ell, r, o interpolate the constraint evaluations over the m-point domain
    (one batched INTT), h = (ell r - o) / t with t = X^m - 1
    (``SparseQAP.quotient``: a batched coset NTT at 2m, the division, a
    coset INTT), and t d_ell d_r - d_o is two coefficient corrections:
    -(d_ell d_r + d_o) at 0 and +d_ell d_r at m."""
    spec, m = qap.spec, qap.m
    p, dev = spec.p, assignment.device
    scalar = lambda x: Fp.from_int(spec, x % p, dev)
    coef = qap.combine_batched(assignment)
    ell, r = Poly(coef[0]), Poly(coef[1])
    n1 = m + 1
    drdl, d_o_ = scalar(d_ell * d_r), scalar(d_o)
    corr = limb.zeros(spec, (n1,), dev)
    corr[:, 0] = limb.neg(spec, limb.add(spec, drdl.mont, d_o_.mont))
    corr[:, m] = drdl.mont
    return (Poly(qap.quotient(coef)[:n1])
            + ell.scale_const(scalar(d_r)).pad_to(n1)
            + r.scale_const(scalar(d_ell)).pad_to(n1)
            + Poly(Fp(spec, corr)))
