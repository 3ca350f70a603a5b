"""Gemini: a multilinear polynomial committed as univariate KZG folds.

Counterpart of ``myzkp_tpu/commit/gemini.py``: ``tensor_product``,
``split_and_fold`` (f_i = even(f_(i-1)) + rho_i odd(f_(i-1)), one product and
one add a level over the whole polynomial), a KZG commitment per fold, the
opening (every fold but the last batch-opened at {beta, -beta, beta^2}, a
degree-bound proof per fold), the verifier (degree checks, batch-KZG checks
and the fold identity 2 beta e_hat = beta (e + e_neg) + rho (e - e_neg)) and
its plaintext variant ``debug_verify``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.fp import Fp
from ..fields.host import PyPoint
from ..ops.poly import Poly
from . import kzg


class SplitFoldError(ValueError):
    """A coefficient count that is not a power of two, or a count of fold
    points that is not its log2."""


def tensor_product(a: Fp, b: Fp) -> Fp:
    """Outer product flattened with b's index outer: out[i * len(a) + j] =
    a[j] * b[i]."""
    prod = Fp(a.spec, a.mont[..., :, None]) * Fp(b.spec, b.mont[..., None, :])
    m = prod.mont.transpose(-1, -2)
    return Fp(a.spec, m.reshape(m.shape[:-2] + (-1,)))


def split_and_fold(coef: Fp, rhos: list[int]) -> list[Poly]:
    """All log2(n) + 1 fold polynomials of the n coefficients."""
    spec = coef.spec
    n = coef.shape[-1]
    if n & (n - 1):
        raise SplitFoldError(f"coefs.len() must be a power of two, got {n}")
    log2n = n.bit_length() - 1
    if len(rhos) != log2n:
        raise SplitFoldError(f"points.len() must be {log2n}, but got {len(rhos)}")
    f = coef
    fs = [Poly(f)]
    for rho in rhos:
        f = f[..., 0::2] + f[..., 1::2] * rho
        fs.append(Poly(f))
    return fs


@dataclass
class ProofGemini:
    es: list  # (ys, w) of each batch opening
    degree_proofs: list  # list[PyPoint]


def commit_gemini(polys: list[Poly], pk: kzg.KZGPublicKey) -> list[PyPoint]:
    """A KZG commitment per fold, all in one ``kzg.commit_many``."""
    return kzg.commit_many(pk, polys)


def _points(beta: int, p: int) -> list[int]:
    return [beta % p, (-beta) % p, beta * beta % p]


def open_gemini(polys: list[Poly], beta: int, pk: kzg.KZGPublicKey) -> ProofGemini:
    """Every fold but the last batch-opened at {beta, -beta, beta^2}, and a
    degree-bound proof of each fold f_i against 2^(len(polys) - 1 - i): the
    quotients and shifted folds committed in one ``kzg.commit_many``."""
    num = len(polys)
    points = _points(beta, polys[0].spec.p)
    opened = [kzg.batch_quotient(p, points) for p in polys[:-1]]
    shifted = [kzg.degree_shifted(pk, p, 1 << (num - i - 1)) for i, p in enumerate(polys)]
    ws = kzg.commit_many(pk, [q for _, q in opened] + shifted)
    return ProofGemini(es=[(ys, w) for (ys, _), w in zip(opened, ws)],
                       degree_proofs=ws[len(opened):])


def _folds_consistent(rhos, mu: int, beta: int, es, es_neg, es_hat, p: int) -> bool:
    es_hat = list(es_hat) + [mu % p]
    return all(2 * beta * es_hat[j] % p
               == (beta * (es[j] + es_neg[j]) + rhos[j] * (es[j] - es_neg[j])) % p
               for j in range(len(rhos)))


def verify_gemini(rhos: list[int], mu: int, beta: int, commitment: list[PyPoint],
                  proof: ProofGemini, pk: kzg.KZGPublicKey) -> bool:
    p = kzg.bn254.R
    log2n = len(rhos)
    if log2n != len(commitment) - 1:
        return False
    for i, (c, dp) in enumerate(zip(commitment, proof.degree_proofs)):
        if not kzg.verify_degree_bound(pk, c, dp, 1 << (log2n - i)):
            return False
    openings = [(ys, c, w) for c, (ys, w) in zip(commitment[:-1], proof.es)]
    if not kzg.batch_verify_many(pk, _points(beta, p), openings):
        return False
    es = [ys[0] for ys, _ in proof.es]
    es_neg = [ys[1] for ys, _ in proof.es]
    es_hat = [ys[2] for ys, _ in proof.es][1:]
    return _folds_consistent(rhos, mu, beta, es, es_neg, es_hat, p)


def debug_verify(rhos: list[int], mu: int, polys: list[Poly], beta: int) -> bool:
    """The fold identity on evaluations of the folds themselves."""
    spec = polys[0].spec
    p = spec.p
    log2n = len(rhos)
    dev = polys[0].device
    beta_fp, nbeta_fp, b2_fp = (Fp.from_int(spec, v, dev) for v in _points(beta, p))
    es = [f(beta_fp).item() for f in polys[:log2n]]
    es_neg = [f(nbeta_fp).item() for f in polys[:log2n]]
    es_hat = [f(b2_fp).item() for f in polys[1:log2n]]
    return _folds_consistent(rhos, mu, beta, es, es_neg, es_hat, p)
