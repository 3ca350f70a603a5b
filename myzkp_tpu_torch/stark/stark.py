"""STARK prover and verifier (the slow variant: Lagrange interpolation).

Counterpart of ``myzkp_tpu/stark/stark.py`` (the reference's ``stark.rs``):
``StarkProof``; ``Stark`` with the degree bounds, the transition and boundary
zerofiers and interpolants, ``sample_weights`` (Blake2b per index),
``prove`` and ``verify``; ``check_openings``, ``_shift_poly``,
``_host_zerofier`` and ``initialize_stark_m128``.  The prove runs the
reference's steps in its order, on the Stark's device (the card unless
``initialize_stark_m128`` is given another): the randomizer rows, the trace
interpolation (one batched Lagrange solve over the registers), the boundary
quotients (``poly_divmod``), their codewords on the FRI domain and Merkle
roots, the symbolic AIR, the transition quotients (``poly_divmod`` by the
transition zerofier), the randomizer polynomial, the weighted combination,
FRI and the openings at the duplicated indices.  The rng draws and the
transcript follow the reference, so the same ``random.Random(seed)`` gives
the JAX package's proof byte for byte.  The verifier is host code on ints.

The prove is split into stage methods (``_interpolate_trace``,
``_boundary_quotients``, ``_commit_codeword``, ``_transition_polys``,
``_transition_quotients``, ``_combined_codeword``, ``_open``) that
``FastStark`` shares, and a codeword's Merkle tree is built once and opened
from there, where the reference builds it again for the openings.
"""

from __future__ import annotations

import hashlib
import random as _random
from dataclasses import dataclass

import torch

from .. import _ext
from ..fields.fp import Fp
from ..fields.spec import M128, FieldSpec
from ..ops import ntt as _ntt
from ..ops.poly import Poly, from_monomials, lagrange_interpolate
from ..utils import merkle
from ..utils.fiat_shamir import FiatShamirTransformer
from ..utils.metrics import span
from .fri import (FRI, FriProof, _host_eval, _host_interpolate, _int_from_le, _path_ok,
                  codeword_bytes, sample_field)

# The reference's generator of M128's multiplicative group, the FRI domain's
# coset offset (stark.rs:474-515).
GENERATOR = 85408008396924667383611388730472331217


@dataclass
class StarkProof:
    fri_proof: FriProof
    bqc_roots: list
    bqc_points: list  # list[bytes]
    bqc_paths: list
    rdc_root: bytes
    rdc_points: list
    rdc_paths: list


class Stark:
    def __init__(self, expansion_factor: int, num_colinearity_checks: int,
                 security_level: int, num_randomizers: int, num_registers: int,
                 original_trace_length: int, generator: int, omega: int,
                 omicron: int, omicron_domain: list, fri: FRI, spec: FieldSpec,
                 device=None):
        self.expansion_factor = expansion_factor
        self.num_colinearity_checks = num_colinearity_checks
        self.security_level = security_level
        self.num_randomizers = num_randomizers
        self.num_registers = num_registers
        self.original_trace_length = original_trace_length
        self.generator = generator
        self.omega = omega
        self.omicron = omicron
        self.omicron_domain = omicron_domain
        self.fri = fri
        self.spec = spec
        self.device = _ext.resolve_device(device)

    # -- degree bookkeeping ---------------------------------------------------
    def transition_degree_bounds(self, air: list) -> list:
        point_degrees = [1] + [
            self.original_trace_length + self.num_randomizers - 1
        ] * (2 * self.num_registers)
        return [max((sum(r * e for r, e in zip(point_degrees, k)) for k in a.d), default=0)
                for a in air]

    def transition_quotient_degree_bounds(self, air) -> list:
        return [d - (self.original_trace_length - 1)
                for d in self.transition_degree_bounds(air)]

    def max_degree(self, air) -> int:
        md = max(self.transition_quotient_degree_bounds(air))
        return (1 << md.bit_length()) - 1

    def transition_zerofier_points(self) -> list:
        return self.omicron_domain[: self.original_trace_length - 1]

    def transition_zerofier(self) -> Poly:
        return Poly(from_monomials(
            Fp.from_int(self.spec, self.transition_zerofier_points(), self.device)))

    def boundary_zerofiers(self, boundary) -> list:
        """Per-register zerofier coefficients (host ints)."""
        p = self.spec.p
        return [_host_zerofier([pow(self.omicron, c, p) for c, r, v in boundary if r == s], p)
                for s in range(self.num_registers)]

    def boundary_interpolants(self, boundary) -> list:
        p = self.spec.p
        out = []
        for s in range(self.num_registers):
            dom = [pow(self.omicron, c, p) for c, r, v in boundary if r == s]
            vals = [v % p for c, r, v in boundary if r == s]
            out.append(_host_interpolate(dom, vals, p) if dom else [0])
        return out

    def boundary_quotient_degree_bounds(self, randomized_trace_length, boundary) -> list:
        rtd = randomized_trace_length - 1
        return [rtd - (len(z) - 1) for z in self.boundary_zerofiers(boundary)]

    def sample_weights(self, number: int, randomness: bytes) -> list:
        out = []
        for i in range(number):
            h = hashlib.blake2b(randomness + i.to_bytes(8, "little"), digest_size=32).digest()
            out.append(sample_field(self.spec, h))
        return out

    # -- prove stages -----------------------------------------------------------
    @span("trace interpolation")
    def _interpolate_trace(self, trace: list) -> Fp:
        """The trace polynomials (S, tlen) through omicron^i: one batched
        Lagrange solve over the registers."""
        spec, p = self.spec, self.spec.p
        tlen = len(trace)
        xs = Fp.from_int(spec, [pow(self.omicron, i, p) for i in range(tlen)], self.device)
        ys = Fp.from_int(spec, [[trace[c][s] for c in range(tlen)]
                                for s in range(self.num_registers)], self.device)
        return lagrange_interpolate(xs, ys)

    @span("boundary quotients")
    def _boundary_quotients(self, trace_coef: Fp, boundary, tlen: int) -> list:
        """(trace poly - boundary interpolant) / boundary zerofier, per
        register, by poly_divmod."""
        spec, dev = self.spec, self.device
        interpolants = self.boundary_interpolants(boundary)
        zerofiers = self.boundary_zerofiers(boundary)
        out = []
        for s in range(self.num_registers):
            tp = Poly(trace_coef[s])
            ip = Poly.from_int_coeffs(spec, interpolants[s], dev).pad_to(tlen)
            z = Poly.from_int_coeffs(spec, zerofiers[s], dev)
            q, _ = (tp - ip).divmod(z, divisor_degree=len(zerofiers[s]) - 1)
            out.append(q)
        return out

    @span("codewords")
    def _commit_codeword(self, coef: Fp) -> merkle.MerkleTree:
        """The Merkle tree of a polynomial's codeword on the FRI domain."""
        cw = _ntt.coset_evaluate(coef, self.generator, self.fri.domain_length)
        return merkle.MerkleTree(codeword_bytes(cw))

    @span("symbolic AIR")
    def _transition_polys(self, trace_coef: Fp, air: list) -> list:
        """The AIR composed with (X, the trace polys, the trace polys at
        omicron X)."""
        spec = self.spec
        points = [Poly.from_int_coeffs(spec, [0, 1], self.device)]
        points += [Poly(trace_coef[s]) for s in range(self.num_registers)]
        omicron = Fp.from_int(spec, self.omicron, self.device)
        points += [Poly(trace_coef[s]).scale(omicron) for s in range(self.num_registers)]
        return [a.evaluate_symbolic(points) for a in air]

    @span("transition quotients")
    def _transition_quotients(self, transition_polys: list) -> list:
        """Each transition poly divided by the transition zerofier
        (poly_divmod)."""
        tz = self.transition_zerofier()
        tz_deg = self.original_trace_length - 1
        return [tp.divmod(tz, divisor_degree=tz_deg)[0] for tp in transition_polys]

    @span("combination")
    def _combined_codeword(self, randomizer_poly: Poly, tqs: list, bqs: list, air,
                           tlen: int, boundary, weights: list) -> Fp:
        """The weighted sum of the randomizer, each quotient and each
        quotient shifted up to the max degree, on the FRI domain."""
        spec = self.spec
        md = self.max_degree(air)
        tq_bounds = self.transition_quotient_degree_bounds(air)
        bq_bounds = self.boundary_quotient_degree_bounds(tlen, boundary)
        cap = md + 1
        terms = [randomizer_poly.pad_to(cap)]
        for i, tq in enumerate(tqs):
            terms.append(tq.pad_to(cap))
            terms.append(_shift_poly(tq, md - tq_bounds[i], cap))
        for i, bq in enumerate(bqs):
            terms.append(bq.pad_to(cap))
            terms.append(_shift_poly(bq, md - bq_bounds[i], cap))
        combination = Poly.zero(spec, cap, self.device)
        for w, t in zip(weights, terms):
            combination = combination + t.scale_const(Fp.from_int(spec, w, self.device))
        return _ntt.coset_evaluate(combination.coef, self.generator, self.fri.domain_length)

    def _duplicated_indices(self, fri_proof: FriProof) -> list:
        n_fri = self.fri.domain_length
        fri_proof.top_level_indices.sort()
        duplicated = list(fri_proof.top_level_indices)
        for i in fri_proof.top_level_indices:
            duplicated.append((i + self.expansion_factor) % n_fri)
        for i in list(duplicated):
            duplicated.append((i + n_fri // 2) % n_fri)
        return sorted(duplicated)

    @span("openings")
    def _open(self, trees: list, indices: list) -> tuple:
        """(points, paths) of each tree in turn at every index."""
        points, paths = [], []
        for tree in trees:
            for i in indices:
                points.append(tree.leaves[i])
                paths.append(tree.open(i))
        return points, paths

    def _prove(self, trace: list, boundary, air: list, rng, transition_quotients):
        """The prove's steps, with ``transition_quotients`` (transition polys
        -> quotients) the one step the two STARKs run differently.  Returns
        the proof's fields and the duplicated indices."""
        spec, p = self.spec, self.spec.p
        rng = rng or _random
        proof_stream = FiatShamirTransformer()

        trace = [list(row) for row in trace]
        for _ in range(self.num_randomizers):
            trace.append([rng.randrange(p) for _ in range(self.num_registers)])
        tlen = len(trace)
        trace_coef = self._interpolate_trace(trace)  # (S, tlen)
        bq_polys = self._boundary_quotients(trace_coef, boundary, tlen)
        bq_trees = [self._commit_codeword(q.coef) for q in bq_polys]
        for tree in bq_trees:
            proof_stream.push([tree.root])

        transition_polys = self._transition_polys(trace_coef, air)
        tqs = transition_quotients(transition_polys)

        md = self.max_degree(air)
        randomizer_poly = Poly.from_int_coeffs(spec, [rng.randrange(p) for _ in range(md + 1)],
                                               self.device)
        rand_tree = self._commit_codeword(randomizer_poly.coef)
        proof_stream.push([rand_tree.root])

        weights = self.sample_weights(1 + 2 * len(tqs) + 2 * len(bq_polys),
                                      proof_stream.prover_fiat_shamir(32))
        combined = self._combined_codeword(randomizer_poly, tqs, bq_polys, air, tlen,
                                           boundary, weights)
        fri_proof = self.fri.prove(combined)
        duplicated = self._duplicated_indices(fri_proof)
        bqc_points, bqc_paths = self._open(bq_trees, duplicated)
        rdc_points, rdc_paths = self._open([rand_tree], duplicated)
        fields = dict(fri_proof=fri_proof, bqc_roots=[t.root for t in bq_trees],
                      bqc_points=bqc_points, bqc_paths=bqc_paths, rdc_root=rand_tree.root,
                      rdc_points=rdc_points, rdc_paths=rdc_paths)
        return fields, duplicated

    def prove(self, trace: list, boundary, air: list, rng=None) -> StarkProof:
        fields, _ = self._prove(trace, boundary, air, rng, self._transition_quotients)
        return StarkProof(**fields)

    # -- verify -------------------------------------------------------------------
    def verify(self, proof: StarkProof, air: list, boundary) -> bool:
        p = self.spec.p
        tz_points = self.transition_zerofier_points()

        def tz_value(_index, dci, _leafs):
            v = 1
            for pt in tz_points:
                v = v * (dci - pt) % p
            return v

        return _verify(self, proof, air, boundary, (), tz_value)


def _verify(stark: Stark, proof, air: list, boundary, extra: tuple, tz_value) -> bool:
    """The verifier of both STARKs.  ``extra`` holds (root, points, paths) of
    further openings at the duplicated indices (FastStark's transition
    zerofier); ``tz_value(index, dci, extra_leafs)`` gives the transition
    zerofier's value at the current index (None rejects)."""
    spec, p = stark.spec, stark.spec.p
    proof_stream = FiatShamirTransformer()

    original_trace_length = 1 + max(c for c, r, v in boundary)
    randomized_trace_length = original_trace_length + stark.num_randomizers

    for bqr in proof.bqc_roots:
        proof_stream.push([bqr])
    proof_stream.push([proof.rdc_root])

    weights = stark.sample_weights(1 + 2 * len(air) + 2 * stark.num_registers,
                                   proof_stream.prover_fiat_shamir(32))

    polynomial_values: list = []
    if not stark.fri.verify(proof.fri_proof, polynomial_values):
        return False
    polynomial_values.sort(key=lambda iv: iv[0])
    indices = [i for i, _ in polynomial_values]
    values = [v for _, v in polynomial_values]

    n_fri = stark.fri.domain_length
    duplicated = list(indices)
    for i in indices:
        duplicated.append((i + stark.expansion_factor) % n_fri)
    duplicated = sorted(duplicated)

    # structural validation: reject malformed proofs instead of crashing
    leaf_w = 2 * spec.L
    nd = len(duplicated)
    if len(proof.bqc_roots) != stark.num_registers or not all(
            isinstance(r, bytes) and len(r) == 32 for r in proof.bqc_roots):
        return False
    if not check_openings(proof.bqc_points, proof.bqc_paths,
                          stark.num_registers * nd, leaf_w):
        return False
    if not check_openings(proof.rdc_points, proof.rdc_paths, nd, leaf_w):
        return False
    if not all(check_openings(pts, paths, nd, leaf_w) for _, pts, paths in extra):
        return False

    leafs = []
    ctr = 0
    for r in range(len(proof.bqc_roots)):
        tmp = {}
        for i in duplicated:
            tmp[i] = proof.bqc_points[ctr]
            if not merkle.verify(proof.bqc_roots[r], i, proof.bqc_paths[ctr], tmp[i]):
                return False
            ctr += 1
        leafs.append(tmp)

    randomizer = {}
    for ctr, i in enumerate(duplicated):
        randomizer[i] = proof.rdc_points[ctr]
        if not merkle.verify(proof.rdc_root, i, proof.rdc_paths[ctr], randomizer[i]):
            return False

    extra_leafs = []
    for root, pts, paths in extra:
        tmp = {}
        for ctr, i in enumerate(duplicated):
            tmp[i] = pts[ctr]
            if not merkle.verify(root, i, paths[ctr], tmp[i]):
                return False
        extra_leafs.append(tmp)

    # per-index AIR and combination re-evaluation (host ints)
    interpolants = stark.boundary_interpolants(boundary)
    zerofiers = stark.boundary_zerofiers(boundary)
    tq_bounds = stark.transition_quotient_degree_bounds(air)
    bq_bounds = stark.boundary_quotient_degree_bounds(randomized_trace_length, boundary)
    md = stark.max_degree(air)

    for i in range(len(indices)):
        current_index = indices[i]
        dci = stark.generator * pow(stark.omega, current_index, p) % p
        next_index = (current_index + stark.expansion_factor) % n_fri
        dni = stark.generator * pow(stark.omega, next_index, p) % p
        current_trace = [0] * stark.num_registers
        next_trace = [0] * stark.num_registers
        for s in range(stark.num_registers):
            zc = _host_eval(zerofiers[s], dci, p)
            zn = _host_eval(zerofiers[s], dni, p)
            ic = _host_eval(interpolants[s], dci, p)
            inx = _host_eval(interpolants[s], dni, p)
            cur = _int_from_le(leafs[s][current_index])
            nxt = _int_from_le(leafs[s][next_index])
            current_trace[s] = (cur * zc + ic) % p
            next_trace[s] = (nxt * zn + inx) % p

        point = [dci] + current_trace + next_trace
        tcv = [a.evaluate(point) for a in air]
        tz_val = tz_value(current_index, dci, extra_leafs)
        if tz_val is None:
            return False
        tz_inv = pow(tz_val, -1, p)

        terms = [_int_from_le(randomizer[current_index])]
        for s in range(len(tcv)):
            quotient = tcv[s] * tz_inv % p
            terms.append(quotient)
            terms.append(quotient * pow(dci, md - tq_bounds[s], p) % p)
        for s in range(stark.num_registers):
            bqv = _int_from_le(leafs[s][current_index])
            terms.append(bqv)
            terms.append(bqv * pow(dci, md - bq_bounds[s], p) % p)
        combination = 0
        for w, t in zip(weights, terms):
            combination = (combination + w * t) % p
        if combination != values[i] % p:
            return False
    return True


def check_openings(points, paths, n: int, leaf_w: int) -> bool:
    """Structural validation of a (points, paths) opening list: exactly n
    leaves of leaf_w bytes with well-formed auth paths."""
    if not isinstance(points, (list, tuple)) or len(points) != n:
        return False
    if not isinstance(paths, (list, tuple)) or len(paths) != n:
        return False
    if not all(isinstance(v, bytes) and len(v) == leaf_w for v in points):
        return False
    return all(_path_ok(pp, leaf_w) for pp in paths)


def _shift_poly(q: Poly, shift: int, cap: int) -> Poly:
    """X^shift q, cut or zero-padded to capacity cap."""
    m = torch.nn.functional.pad(q.coef.mont, (shift, 0))[..., :cap]
    return Poly(Fp(q.spec, m)).pad_to(cap)


def _host_zerofier(points: list, p: int) -> list:
    coeffs = [1]
    for x in points:
        nc = [0] * (len(coeffs) + 1)
        for k, c in enumerate(coeffs):
            nc[k] = (nc[k] - c * x) % p
            nc[k + 1] = (nc[k + 1] + c) % p
        coeffs = nc
    return coeffs


def m128_params(expansion_factor: int, num_colinearity_checks: int, security_level: int,
                num_registers: int, num_cycles: int, transition_constraints_degree: int,
                device=None) -> dict:
    """The constructor arguments of the reference's M128 factories
    (stark.rs:474-515, fast_stark.rs:573-616): the generator as the FRI
    domain's offset, 4 randomizers a colinearity check, the omicron domain
    the power of two past randomized trace length x constraint degree, the
    FRI domain expansion_factor times that."""
    spec = FieldSpec.make(M128)
    num_randomizers = 4 * num_colinearity_checks
    randomized_trace_length = num_cycles + num_randomizers
    omicron_domain_length = 1 << (
        randomized_trace_length * transition_constraints_degree).bit_length()
    fri_domain_length = omicron_domain_length * expansion_factor
    omega = _ntt.nth_root_of_unity(M128, fri_domain_length)
    omicron = _ntt.nth_root_of_unity(M128, omicron_domain_length)
    omicron_domain, acc = [], 1
    for _ in range(omicron_domain_length):
        omicron_domain.append(acc)
        acc = acc * omicron % M128
    fri = FRI(offset=GENERATOR, omega=omega, domain_length=fri_domain_length,
              expansion_factor=expansion_factor,
              num_colinearity_tests=num_colinearity_checks, spec=spec)
    return dict(expansion_factor=expansion_factor,
                num_colinearity_checks=num_colinearity_checks,
                security_level=security_level, num_randomizers=num_randomizers,
                num_registers=num_registers, original_trace_length=num_cycles,
                generator=GENERATOR, omega=omega, omicron=omicron,
                omicron_domain=omicron_domain, fri=fri, spec=spec, device=device)


def initialize_stark_m128(expansion_factor: int, num_colinearity_checks: int,
                          security_level: int, num_registers: int, num_cycles: int,
                          transition_constraints_degree: int, device=None) -> Stark:
    """The reference's factory over M128; the prove runs on ``device`` (the
    card unless another is named)."""
    return Stark(**m128_params(expansion_factor, num_colinearity_checks, security_level,
                               num_registers, num_cycles, transition_constraints_degree,
                               device))
