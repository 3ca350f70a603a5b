"""Table-based device sumcheck prover for products of multivariate factors.

Counterpart of ``myzkp_tpu/protocols/sumcheck_tpu.py``, the reference's CUDA
sumcheck example (``myzkp/examples/sumcheck/``: Algorithm 1 of
Bagad-Domb-Thaler).  The example's five CUDA kernels map onto ``Fp`` table
ops, whose products are K1 launches on the card (``fields/limb.py``) and
whose sums are torch's int64 adds:

  CUDA kernel (sumcheck.cu)          ->  here
  ------------------------------------------------------------------
  eval_all_binary_combinations :4-29 ->  MPoly.evaluate_batch over the
                                         hypercube (power tables, products)
  fold_factors_pointwise :47-58      ->  running Fp product over factor tables
  fold_into_half :76-95              ->  table[0::2] + r*(table[1::2]-table[0::2])
  eval_folded_poly :110-141          ->  the same fold at an evaluation point t
  sum :143-154                       ->  pairwise Fp.sum

The host drives the rounds and the Fiat-Shamir transcript; a round's d + 1
sums each end in one host read.  ``SumCheckProverHost`` is the pure-host
mirror (the reference's CPU prover) for parity tests.  The device prover
makes its tables on the card unless ``device`` names another device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import _ext
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops.mpoly import MPoly
from ..stark.fri import _host_interpolate, sample_field
from ..utils.fiat_shamir import FiatShamirTransformer
from .sumcheck import bit_combinations, hypercube_points


# ---------------------------------------------------------------------------
# Device table ops (the five CUDA-kernel equivalents)
# ---------------------------------------------------------------------------

def eval_all_binary_combinations(g: MPoly, num_vars: int, device=None) -> Fp:
    """(2^num_vars,) table of g over the hypercube (sumcheck.cu:4-29)."""
    return g.evaluate_batch(hypercube_points(g.spec, num_vars, device))


def fold_factors_pointwise(tables: list[Fp]) -> Fp:
    """Pointwise product of factor tables (sumcheck.cu:47-58)."""
    acc = tables[0]
    for t in tables[1:]:
        acc = acc * t
    return acc


def fold_into_half(table: Fp, r) -> Fp:
    """Bind the lowest variable to r (an Fp or an int): out[k] = t[2k] +
    r * (t[2k+1] - t[2k]).

    (sumcheck.cu:76-95; the reference binds the MSB-first top variable;
    the tables are LSB-first, so the bound variable is the low bit.)
    """
    spec = table.spec
    even = Fp(spec, table.mont[..., 0::2])
    odd = Fp(spec, table.mont[..., 1::2])
    return even + r * (odd - even)


def eval_folded_poly(table: Fp, t) -> Fp:
    """Same fold rule at an arbitrary evaluation point (sumcheck.cu:110-141)."""
    return fold_into_half(table, t)


def table_sum(table: Fp) -> Fp:
    """Tree-sum of a table (sumcheck.cu:143-154)."""
    return table.sum(axis=0)


# ---------------------------------------------------------------------------
# Prover / verifier (the reference's examples/sumcheck/src/{prover,verifier}.rs)
# ---------------------------------------------------------------------------

@dataclass
class ProductSumcheckProof:
    """Transcript-styled proof: claimed sum + round polynomials (coeffs)."""
    el: int
    claimed_sum: int
    round_polys: list  # list[list[int]] coefficients, low-first


def _push_ints(fs: FiatShamirTransformer, vals: list[int]):
    fs.push([v.to_bytes(32, "little") for v in vals])


class SumCheckProverTPU:
    """Proves sum over the hypercube of prod_k factor_k(x), on device
    tables (the name kept from the JAX package, whose device is a TPU)."""

    def __init__(self, spec: FieldSpec, max_degree: int, device=None):
        self.spec = spec
        self.max_degree = max_degree  # max degree per variable of the product
        self.device = _ext.resolve_device(device)

    def prove(self, factors: list[MPoly], num_vars: int
              ) -> ProductSumcheckProof:
        spec = self.spec
        p = spec.p
        fs = FiatShamirTransformer()
        fs.push([struct.pack("<Q", num_vars)])

        tables = [eval_all_binary_combinations(g, num_vars, self.device)
                  for g in factors]
        claimed = int(table_sum(fold_factors_pointwise(tables)).item())
        _push_ints(fs, [claimed])

        round_polys = []
        eval_points = list(range(self.max_degree + 1))
        for _ in range(num_vars):
            # s_j(t) for t = 0..d: fold each factor at t, multiply, sum
            evals = []
            for t in eval_points:
                folded = [eval_folded_poly(tab, t) for tab in tables]
                evals.append(int(table_sum(fold_factors_pointwise(folded)).item()))
            coeffs = _host_interpolate(eval_points, evals, p)
            round_polys.append(coeffs)
            _push_ints(fs, coeffs)
            r = sample_field(spec, fs.prover_fiat_shamir(32))
            tables = [fold_into_half(tab, r) for tab in tables]
        return ProductSumcheckProof(el=num_vars, claimed_sum=claimed,
                                    round_polys=round_polys)


class SumCheckProverHost:
    """Pure-host mirror (the reference's prover.rs:339-457 and the CPU
    kernel twins in utils.rs:83-156)."""

    def __init__(self, spec: FieldSpec, max_degree: int):
        self.spec = spec
        self.max_degree = max_degree

    def _tables(self, factors: list[MPoly], num_vars: int) -> list[list[int]]:
        out = []
        for g in factors:
            out.append([g.evaluate(c) for c in bit_combinations(num_vars)])
        return out

    def prove(self, factors: list[MPoly], num_vars: int
              ) -> ProductSumcheckProof:
        spec = self.spec
        p = spec.p
        fs = FiatShamirTransformer()
        fs.push([struct.pack("<Q", num_vars)])
        tables = self._tables(factors, num_vars)

        def prod_sum(tabs):
            total = 0
            for vals in zip(*tabs):
                term = 1
                for v in vals:
                    term = term * v % p
                total = (total + term) % p
            return total

        claimed = prod_sum(tables)
        _push_ints(fs, [claimed])
        round_polys = []
        eval_points = list(range(self.max_degree + 1))
        for _ in range(num_vars):
            evals = []
            for t in eval_points:
                folded = [
                    [(tab[2 * k] + t * (tab[2 * k + 1] - tab[2 * k])) % p
                     for k in range(len(tab) // 2)]
                    for tab in tables
                ]
                evals.append(prod_sum(folded))
            coeffs = _host_interpolate(eval_points, evals, p)
            round_polys.append(coeffs)
            _push_ints(fs, coeffs)
            r = sample_field(spec, fs.prover_fiat_shamir(32))
            tables = [
                [(tab[2 * k] + r * (tab[2 * k + 1] - tab[2 * k])) % p
                 for k in range(len(tab) // 2)]
                for tab in tables
            ]
        return ProductSumcheckProof(el=num_vars, claimed_sum=claimed,
                                    round_polys=round_polys)


class SumCheckVerifier:
    """Replay the transcript; check the s(0) + s(1) chain and the final
    product evaluation (the reference's verifier.rs:15-76)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def verify(self, proof: ProductSumcheckProof, factors: list[MPoly]
               ) -> bool:
        spec = self.spec
        p = spec.p
        fs = FiatShamirTransformer()
        fs.push([struct.pack("<Q", proof.el)])
        _push_ints(fs, [proof.claimed_sum])

        expected = proof.claimed_sum % p
        rs = []
        for coeffs in proof.round_polys:
            s0 = coeffs[0] % p
            s1 = sum(coeffs) % p
            if (s0 + s1) % p != expected:
                return False
            _push_ints(fs, coeffs)
            r = sample_field(spec, fs.prover_fiat_shamir(32))
            rs.append(r)
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * r + c) % p
            expected = acc
        # final check: product of factors at the random point
        final = 1
        for g in factors:
            final = final * g.evaluate(rs) % p
        return final == expected
