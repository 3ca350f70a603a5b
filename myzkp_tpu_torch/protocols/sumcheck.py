"""Sumcheck over the boolean hypercube, tied to the Gemini commitment.

Counterpart of ``myzkp_tpu/protocols/sumcheck.py`` (the reference's
``sumcheck.rs``): the LSB-first hypercube, its sum, the round polynomials
g_j, the fold g_j(0) + g_j(1), the multilinear coefficient vector, and the
Fiat-Shamir prove / verify whose last check is a Gemini opening
(``commit/gemini.py`` over ``commit/kzg.py``).

Three parts are reformulated, with the same values:

- ``hypercube_points`` builds the (V, 2^V) table on the device from the bit
  masks (0 is the zero limbs, 1 is R mod p in Montgomery form), where the
  reference converts 2^V * V Python ints;
- ``build_gj_from_prefix`` sums term by term: c x^e contributes
  c prod_(i<j) r_i^(e_i) x_j^(e_j) once for every suffix assignment that
  keeps it, 2^(suffix variables it does not hold) of them, where the
  reference partially evaluates g at each of the 2^(el-1-j) suffix
  assignments (exponential in el);
- ``commit_sumcheck`` writes the nonzero multilinear coefficients into a
  zero tensor at their hypercube indices, where the reference converts the
  whole 2^el list of ints.

Device tensors follow the key's device (``prove_sumcheck``) or the caller's
``device`` (the card unless it names another).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import torch

from .. import _ext
from ..commit import gemini, kzg
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops.mpoly import MPoly
from ..stark.fri import sample_field
from ..utils.fiat_shamir import FiatShamirTransformer
from ..utils.metrics import span


def bit_combinations(length: int, start: int = 0):
    """LSB-first bit vectors of the hypercube."""
    for n in range(start, 1 << length):
        yield [(n >> i) & 1 for i in range(length)]


@span("hypercube")
def hypercube_points(spec: FieldSpec, length: int, device=None) -> Fp:
    """(V, 2^V) Fp array: column n = LSB-first bits of n, made on the device
    by one select between the zero limbs and R mod p."""
    dev = _ext.resolve_device(device)
    idx = torch.arange(1 << length, device=dev)
    shifts = torch.arange(length, device=dev).unsqueeze(1)
    bits = ((idx.unsqueeze(0) >> shifts) & 1).bool()  # (V, n)
    shape = tuple(bits.shape)
    return Fp.select(bits, Fp.ones(spec, (1, 1), dev).broadcast_to(shape),
                     Fp.zeros(spec, (1, 1), dev).broadcast_to(shape))


def sum_over_boolean_hypercube(g: MPoly, device=None) -> int:
    """One batched evaluation over the 2^el points and a pairwise sum."""
    el = g.num_variables()
    if el == 0:
        return g.evaluate([])
    pts = hypercube_points(g.spec, el, device)
    vals = g.evaluate_batch(pts)
    return int(vals.sum(axis=0).item())


def build_gj_from_prefix(g: MPoly, rs: list[int]) -> MPoly:
    """Round polynomial in variable j = len(rs): g with x_i = r_i for i < j,
    summed over the suffix x_(j+1), ..., x_(el-1) in {0, 1}.

    Term by term (module docstring).  Each key keeps only its exponent of
    x_j and is padded to the length of the longest term that survives the
    prefix, as the literal sum's additions pad it."""
    spec = g.spec
    p = spec.p
    el = g.num_variables()
    j = len(rs)
    assert el >= 1 and el > j, "invalid sizes for sum-check round"
    contrib = []
    n = 0
    for e, c in g.d.items():
        coef = c
        for i in range(min(j, len(e))):
            if e[i]:
                coef = coef * pow(rs[i] % p, e[i], p) % p
        if not coef:
            continue  # a zero challenge: the term vanishes in every assignment
        free = sum(1 for i in range(j + 1, el) if i >= len(e) or not e[i])
        contrib.append((e[j] if j < len(e) else 0, coef * (1 << free) % p))
        n = max(n, len(e))
    d = {}
    for ej, coef in contrib:
        k = tuple(ej if i == j else 0 for i in range(n))
        d[k] = (d.get(k, 0) + coef) % p
    return MPoly(spec, d)


def sumcheck_fold(g_j: MPoly, j: int) -> int:
    """g_j(..,0,..) + g_j(..,1,..) at variable j."""
    el = g_j.num_variables()
    one = [0] * el
    one[j] = 1
    zero = [0] * el
    return (g_j.evaluate(one) + g_j.evaluate(zero)) % g_j.spec.p


def _multilinear_terms(g: MPoly) -> dict:
    """{hypercube index: coefficient} of the keys of length el whose
    exponents are all 0 or 1: the entries ``get_coefs_in_order`` finds."""
    el = g.num_variables()
    return {sum(b << i for i, b in enumerate(e)): c for e, c in g.d.items()
            if len(e) == el and all(b in (0, 1) for b in e)}


def get_coefs_in_order(g: MPoly) -> list[int]:
    """Multilinear coefficient vector in LSB-first hypercube order: entry n
    is the coefficient of the key of bits of n, 0 where g has none."""
    out = [0] * (1 << g.num_variables())
    for n, c in _multilinear_terms(g).items():
        out[n] = c
    return out


def _coef_vector(g: MPoly, device) -> Fp:
    """``Fp.from_int(spec, get_coefs_in_order(g), device)`` made as a zero
    tensor with the nonzero coefficients written at their indices."""
    spec = g.spec
    terms = _multilinear_terms(g)
    mont = Fp.zeros(spec, (1 << g.num_variables(),), device).mont
    if terms:
        dev = mont.device
        idx = torch.tensor(list(terms), dtype=torch.int64, device=dev)
        mont[:, idx] = Fp.from_int(spec, list(terms.values()), dev).mont
    return Fp(spec, mont)


def _mpoly_bytes(g: MPoly) -> bytes:
    """Canonical transcript encoding of an MPoly (sorted terms)."""
    items = sorted(g._norm().items())
    out = [struct.pack("<Q", len(items))]
    for exps, c in items:
        out.append(struct.pack("<Q", len(exps)))
        out.extend(struct.pack("<Q", e) for e in exps)
        out.append(c.to_bytes(32, "little"))
    return b"".join(out)


@dataclass
class SumCheckProof:
    h: int
    el: int
    gs: list  # list[MPoly]
    c_g: list  # Gemini's commitments: host points
    pi: gemini.ProofGemini


def commit_sumcheck(g: MPoly, rs: list[int], pk: kzg.KZGPublicKey):
    """Gemini's folds of g's coefficient vector at rs, and their
    commitments."""
    fs = gemini.split_and_fold(_coef_vector(g, pk.device), rs)
    return gemini.commit_gemini(fs, pk), fs


def _round_challenge(spec: FieldSpec, stream: FiatShamirTransformer, g_j: MPoly) -> int:
    stream.push([_mpoly_bytes(g_j)])
    return sample_field(spec, stream.prover_fiat_shamir(32))


def _transcript(el: int, h: int) -> FiatShamirTransformer:
    stream = FiatShamirTransformer()
    stream.push([struct.pack("<Q", el)])
    stream.push([h.to_bytes(32, "little")])
    return stream


def prove_sumcheck(g: MPoly, h: int, pk: kzg.KZGPublicKey) -> SumCheckProof:
    """The claim sum_x g(x) = h: a round polynomial and a challenge per
    variable, then Gemini's commitment and opening of g at the challenges."""
    spec = g.spec
    el = g.num_variables()
    stream = _transcript(el, h)
    gs, rs = [], []
    for _ in range(el):
        g_j = build_gj_from_prefix(g, rs)
        gs.append(g_j)
        rs.append(_round_challenge(spec, stream, g_j))
    beta = sample_field(spec, stream.prover_fiat_shamir(32))
    c_g, fs = commit_sumcheck(g, rs, pk)
    pi = gemini.open_gemini(fs, beta, pk)
    return SumCheckProof(h=h, el=el, gs=gs, c_g=c_g, pi=pi)


def verify_sumcheck(proof: SumCheckProof, pk: kzg.KZGPublicKey) -> bool:
    """h = g_0(0) + g_0(1); g_(j-1)(r_(j-1)) = g_j(0) + g_j(1); then Gemini
    at the challenges with mu = g_(el-1)(r_(el-1))."""
    spec = kzg.bn254.r_spec()
    p = spec.p
    stream = _transcript(proof.el, proof.h)
    if proof.h % p != sumcheck_fold(proof.gs[0], 0):
        return False
    rs = [_round_challenge(spec, stream, proof.gs[0])]
    for j in range(1, proof.el):
        prev_point = [0] * proof.el
        prev_point[j - 1] = rs[j - 1]
        if proof.gs[j - 1].evaluate(prev_point) != sumcheck_fold(proof.gs[j], j):
            return False
        rs.append(_round_challenge(spec, stream, proof.gs[j]))
    beta = sample_field(spec, stream.prover_fiat_shamir(32))
    last_point = [0] * proof.el
    last_point[proof.el - 1] = rs[proof.el - 1]
    mu = proof.gs[proof.el - 1].evaluate(last_point)
    return gemini.verify_gemini(rs, mu, beta, proof.c_g, proof.pi, pk)
