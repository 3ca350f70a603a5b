"""KZG polynomial commitment on BN254.

Counterpart of ``myzkp_tpu/commit/kzg.py``: trusted setup (minimal or full
G2 powers), commit as an MSM over [s^i]G1, opening at one point and at many,
the pairing verifiers and the degree-bound proof.

The setup computes the powers [s^i]G1 and [s^i]G2 by the fixed-base tables
(``fixed_base_multi``: K14 gathers and K2 / K7 trees) where the reference
ran a double-and-add ladder over degree + 1 copies of the generator, whose
steps output would hold 255 points per power (48 GiB for G1 at 2^20); the
points are the same, compared as affine points.  Division by X - u and by
prod_i (X - x_i) runs as log-depth suffix scans (``ops/poly.py``), the
commitments as device MSMs, the pairings on the host (``native/``).  The
verifiers read only the G2 powers they need, converted to host points one
index at a time and cached.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field

import torch

from .. import _ext
from ..curves import bn254, fixed_base, msm as _msm, weierstrass as wst
from ..fields import limb
from ..fields.fp import Fp
from ..fields.host import PyPoint
from ..ops.poly import (Poly, divide_by_roots, from_monomials,
                        lagrange_interpolate)


@dataclass
class KZGPublicKey:
    """SRS: device G1 / G2 power batches and host mirrors made on demand."""

    powers1: wst.Point  # (d + 1,) G1 batch: [s^i] G1
    powers2: wst.Point  # (k,) G2 batch: [s^i] G2 (k = 2 minimal, d + 1 full)
    _host1: list = field(default=None, repr=False)
    _host2: dict = field(default_factory=dict, repr=False)

    @property
    def degree(self) -> int:
        return self.powers1.x.shape[1] - 1

    @property
    def num_g2(self) -> int:
        return self.powers2.x[0].shape[1]

    @property
    def device(self) -> torch.device:
        return self.powers1.x.device

    def host_g1(self) -> list:
        """Every G1 power as a host point (converted once)."""
        if self._host1 is None:
            self._host1 = bn254.g1_points_to_host(self.powers1)
        return self._host1

    def host_g2(self, i: int) -> PyPoint:
        """[s^i]G2 as a host point, converted at its first use."""
        if i not in self._host2:
            one = wst.point_map(lambda a: a[:, i:i + 1], self.powers2)
            self._host2[i] = bn254.g2_points_to_host(one)[0]
        return self._host2[i]


def _powers_of_s(s: int, n: int) -> list:
    acc, out = 1, []
    for _ in range(n):
        out.append(acc)
        acc = acc * s % bn254.R
    return out


def setup(degree: int, s: int | None = None, rng=None, full_g2: bool = False,
          device=None) -> KZGPublicKey:
    """Trusted setup with toxic waste s, drawn as the reference draws it
    when not given: [s^i]G1 for i <= degree and [s^i]G2 for i <= 1
    (minimal) or i <= degree (``full_g2``), on the card unless ``device``
    names another device."""
    if s is None:
        rng = rng or _random
        s = rng.randrange(1, bn254.R)
    device = _ext.resolve_device(device)
    scalars = _msm.scalars_from_int(bn254.r_spec(), _powers_of_s(s, degree + 1), device)
    n2 = degree + 1 if full_g2 else 2
    return KZGPublicKey(powers1=fixed_base.fixed_base_multi("g1", scalars),
                        powers2=fixed_base.fixed_base_multi("g2", scalars[:, :n2]))


def _coef_scalars(p: Poly) -> torch.Tensor:
    """Poly coefficients (Montgomery Fp) -> standard-domain limb scalars."""
    return limb.from_mont(p.spec, p.coef.mont)


def _slice_points(pt: wst.Point, n: int) -> wst.Point:
    return wst.point_map(lambda a: a[:, :n], pt)


def _stack(pts: list) -> wst.Point:
    return wst.point_map(lambda *cs: torch.stack(cs, dim=1), *pts)


def commit_many(pk: KZGPublicKey, polys: list[Poly]) -> list[PyPoint]:
    """[p(s)] G1 for each polynomial: the MSMs of one ``msm_many`` call (those
    below 128 coefficients share one double-and-add ladder, the others run
    Pippenger each), then one conversion to host points for all of them.
    The points equal ``commit``'s, one call each."""
    for p in polys:
        if p.capacity > pk.degree + 1:
            raise ValueError(f"polynomial of capacity {p.capacity} exceeds the SRS "
                             f"degree {pk.degree}")
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), pk.device)
    jobs = [(_slice_points(pk.powers1, p.capacity), _coef_scalars(p)) for p in polys]
    return bn254.g1_points_to_host(_stack(_msm.msm_many(F, b3, jobs)))


def commit(pk: KZGPublicKey, p: Poly) -> PyPoint:
    """C = [p(s)] G1 as an MSM over the SRS."""
    return commit_many(pk, [p])[0]


def commit_g2(pk: KZGPublicKey, p: Poly) -> PyPoint:
    """[p(s)] G2 over the full-G2 SRS (used by batch verification)."""
    n = p.capacity
    if n > pk.num_g2:
        raise ValueError(f"G2 commitment of capacity {n} needs a full_g2 setup "
                         f"(SRS has {pk.num_g2} G2 powers)")
    F, b3 = bn254.g2_ops(), bn254.g2_b3((), p.device)
    pt = _msm.msm_naive(F, b3, _slice_points(pk.powers2, n), _coef_scalars(p))
    return bn254.g2_points_to_host(_stack([pt]))[0]


def open(pk: KZGPublicKey, p: Poly, u: int) -> tuple[int, PyPoint]:
    """Evaluation proof at u: y = p(u), w = [(p - y) / (X - u)](s) G1.  The
    quotient is one suffix scan of log2(n) levels; the witness one MSM."""
    spec = p.spec
    u_fp = Fp.from_int(spec, u, p.device)
    y = p(u_fp)
    num = p.coef.at_set(0, p.coef[0] - y)
    q, _ = divide_by_roots(num, u_fp.reshape(1))
    return y.item(), commit(pk, Poly(q))


def verify(pk: KZGPublicKey, u: int, y: int, commitment: PyPoint,
           witness: PyPoint) -> bool:
    """e(C - [y]G1, G2) == e(w, [s]G2 - [u]G2)."""
    g1 = bn254.g1_generator()
    g2, s_g2 = pk.host_g2(0), pk.host_g2(1)
    return bn254.pairing_product_is_one([
        (commitment + (-(g1 * y)), g2),
        (-witness, s_g2 + (-(g2 * u))),
    ])


def batch_quotient(p: Poly, us: list[int]) -> tuple[list[int], Poly]:
    """The evaluations ys = p(us) and the quotient (p - I) / Z that
    ``batch_open`` commits to (I the interpolant of the evaluations, Z =
    prod (X - u_i)): one suffix scan per point."""
    xs = Fp.from_int(p.spec, us, p.device)
    ys = p.eval_domain(xs)
    num = p - Poly(lagrange_interpolate(xs, ys))
    q, _ = divide_by_roots(num.coef, xs)
    return [int(v) for v in ys.to_int()], Poly(q)


def batch_open(pk: KZGPublicKey, p: Poly, us: list[int]
               ) -> tuple[list[int], PyPoint]:
    """Open at many points: ys = p(us) and w = [(p - I) / Z](s) G1."""
    ys, q = batch_quotient(p, us)
    return ys, commit(pk, q)


def batch_verify(pk: KZGPublicKey, us: list[int], ys: list[int],
                 commitment: PyPoint, witness: PyPoint) -> bool:
    """e(C - [I(s)]G1, G2) == e(w, [Z(s)]G2).

    Needs a full-G2 SRS for [Z(s)]G2; returns False (never raises) on
    structurally invalid input: no points, repeated points, a count of ys
    that differs, or too few G2 powers."""
    return batch_verify_many(pk, us, [(ys, commitment, witness)])


def batch_verify_many(pk: KZGPublicKey, us: list[int], openings) -> bool:
    """``batch_verify`` of every (ys, commitment, witness) in ``openings`` at
    the same points us: the interpolants in one batch, their commitments in
    one ``commit_many``, and [Z(s)]G2 once.  True when every one holds."""
    if not us or len(set(u % bn254.R for u in us)) != len(us):
        return False
    if any(len(ys) != len(us) for ys, _, _ in openings) or len(us) + 1 > pk.num_g2:
        return False
    spec = bn254.r_spec()
    xs = Fp.from_int(spec, us, pk.device)
    ysf = Fp.from_int(spec, [ys for ys, _, _ in openings], pk.device)
    icoef = lagrange_interpolate(xs, ysf)
    i_commits = commit_many(pk, [Poly(icoef[k]) for k in range(len(openings))])
    z_g2 = commit_g2(pk, Poly(from_monomials(xs)))
    g2 = pk.host_g2(0)
    return all(bn254.pairing_product_is_one([(c + (-ic), g2), (-w, z_g2)])
               for (_, c, w), ic in zip(openings, i_commits))


def degree_shifted(pk: KZGPublicKey, p: Poly, d: int) -> Poly:
    """X^(max_d - d) times the first d + 1 coefficients of p (max_d the SRS
    degree): the polynomial ``prove_degree_bound`` commits to."""
    shift = pk.degree - d
    if shift < 0:
        raise ValueError(f"degree bound {d} exceeds SRS degree {pk.degree}")
    shifted = torch.nn.functional.pad(p.coef.mont[..., : d + 1], (shift, 0))
    return Poly(Fp(p.spec, shifted))


def prove_degree_bound(pk: KZGPublicKey, p: Poly, d: int) -> PyPoint:
    """Commitment to X^(max_d - d) p, proving deg(p) <= d against the top of
    the SRS."""
    return commit(pk, degree_shifted(pk, p, d))


def verify_degree_bound(pk: KZGPublicKey, commitment: PyPoint,
                        degree_proof: PyPoint, d: int) -> bool:
    """e(proof, G2) == e(C, [s^(max_d - d)]G2).  Needs that G2 power; returns
    False (never raises) on a bound outside the SRS."""
    shift = pk.degree - d
    if d < 0 or not 0 <= shift < pk.num_g2:
        return False
    return bn254.pairing_product_is_one([
        (degree_proof, pk.host_g2(0)), (-commitment, pk.host_g2(shift))])
