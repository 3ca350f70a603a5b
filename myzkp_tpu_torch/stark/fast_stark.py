"""FastStark: the NTT-accelerated STARK with a preprocessed transition
zerofier.

Counterpart of ``myzkp_tpu/stark/fast_stark.py`` (the reference's
``fast_stark.rs``): ``preprocess`` (the transition zerofier by
``fast_zerofier``, its codeword on the FRI domain and Merkle root),
``prove`` (the trace by ``fast_interpolate``, the transition quotients by
``fast_coset_divide`` against the preprocessed zerofier, and the zerofier's
codeword opened at the duplicated indices beside the other openings) and
``verify`` (the zerofier's openings checked against the preprocessed root
and their values used for the quotients), with ``FastStarkProof`` and
``initialize_fast_stark_m128``.  Every other step is ``Stark``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.fp import Fp
from ..ops import ntt as _ntt
from ..ops.poly import Poly
from ..utils import merkle
from ..utils.metrics import span
from .fri import _int_from_le, codeword_bytes
from .stark import Stark, StarkProof, _verify, m128_params


@dataclass
class FastStarkProof(StarkProof):
    tzc_points: list = None
    tzc_paths: list = None


class FastStark(Stark):
    def preprocess(self):
        """(tz_poly, tz_codeword, tz_root, tz_leaves)."""
        spec = self.spec
        pts = Fp.from_int(spec, self.transition_zerofier_points(), self.device)
        tz = Poly(_ntt.fast_zerofier(pts))
        tz_codeword = _ntt.fast_coset_evaluate(tz.coef, self.generator,
                                               self.fri.domain_length)
        tz_leaves = codeword_bytes(tz_codeword)
        return tz, tz_codeword, merkle.commit(tz_leaves), tz_leaves

    @span("trace interpolation")
    def _interpolate_trace(self, trace: list) -> Fp:
        """The trace polynomials (S, tlen) through omicron^i by
        divide-and-conquer interpolation, batched over the registers."""
        spec, p = self.spec, self.spec.p
        tlen = len(trace)
        xs = Fp.from_int(spec, [pow(self.omicron, i, p) for i in range(tlen)], self.device)
        ys = Fp.from_int(spec, [[trace[c][s] for c in range(tlen)]
                                for s in range(self.num_registers)], self.device)
        return _ntt.fast_interpolate(xs, ys)

    @span("transition quotients")
    def _coset_divide(self, transition_polys: list, tz: Poly) -> list:
        """Each transition poly divided by the zerofier pointwise on the FRI
        domain's coset, cut to its quotient's degree."""
        out = []
        for tp in transition_polys:
            q = _ntt.fast_coset_divide(tp.coef, tz.coef, self.generator,
                                       self.fri.domain_length)
            qd = (tp.capacity - 1) - (self.original_trace_length - 1)
            out.append(Poly(q[..., :qd + 1]))
        return out

    def prove(self, trace: list, boundary, air: list, preprocessed=None,
              rng=None) -> FastStarkProof:
        if preprocessed is None:
            preprocessed = self.preprocess()
        tz, _, _, tz_leaves = preprocessed
        fields, duplicated = self._prove(trace, boundary, air, rng,
                                         lambda tps: self._coset_divide(tps, tz))
        tzc_points, tzc_paths = self._open([merkle.MerkleTree(tz_leaves)], duplicated)
        return FastStarkProof(**fields, tzc_points=tzc_points, tzc_paths=tzc_paths)

    def verify(self, proof: FastStarkProof, air: list, tz_root: bytes, boundary) -> bool:
        """As Stark.verify, with the transition zerofier's value at each index
        read from its opening, checked against tz_root (a zero value
        rejects)."""
        p = self.spec.p

        def tz_value(index, _dci, extra_leafs):
            v = _int_from_le(extra_leafs[0][index])
            return None if v % p == 0 else v

        return _verify(self, proof, air, boundary,
                       ((tz_root, proof.tzc_points, proof.tzc_paths),), tz_value)


def initialize_fast_stark_m128(expansion_factor: int, num_colinearity_checks: int,
                               security_level: int, num_registers: int, num_cycles: int,
                               transition_constraints_degree: int,
                               device=None) -> FastStark:
    """The reference's factory over M128 (fast_stark.rs:573-616); the prove
    runs on ``device`` (the card unless another is named)."""
    return FastStark(**m128_params(expansion_factor, num_colinearity_checks,
                                   security_level, num_registers, num_cycles,
                                   transition_constraints_degree, device))
