"""Pinocchio zk-SNARK over the sparse or the dense QAP: setup, prove and
verify.

Counterpart of ``myzkp_tpu/snark/pinocchio.py`` (setup :115-202, prove
:546-610, verify :613-634, the quotient stage ``get_shifted_h`` with the
semantics of ``_jitted_shifted_h_rou`` :332-388 and the dense branch
:407-418, and the mesh prover ``prove_mesh`` :441-544).  Every proving-key
vector is one fixed-base batch per group (``curves/fixed_base``), every
prover accumulation a Pippenger MSM (``curves/msm``), and h comes from the
QAP's quotient (the NTT pipeline, or the long division on the dense QAP's
natural domain); the verifier's twelve pairings run on the host
(``native/``).  With a mesh (``parallel/mesh``), the MSMs and the quotient
stage's transforms are split over its ranks.
Randomness is drawn from ``rng`` in the reference's order, so the same seeded
``random.Random`` and the same key give the reference's proof, point for
point.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

import torch

from ..arith.qap import QAP
from ..arith.sparse import SparseQAP, shifted_h_rou
from ..curves import bn254, fixed_base, msm as _msm, weierstrass as wst
from ..fields import limb
from ..fields.fp import Fp
from ..fields.host import PyPoint
from ..ops import ntt as _ntt
from ..ops.poly import Poly
from ..parallel import mesh as pm
from ..utils.metrics import span


@dataclass
class PinocchioProofKey:
    g1_ell_i: wst.Point  # (d,)
    g2_r_i: wst.Point
    g1_o_i: wst.Point
    g1_alpha_ell_i: wst.Point
    g2_alpha_r_i: wst.Point
    g1_alpha_o_i: wst.Point
    g1_sj: wst.Point  # (m+1,)
    g1_checksum: wst.Point  # (d,)
    g1_ell_ts: wst.Point  # singles (batch (1,))
    g2_r_ts: wst.Point
    g1_o_ts: wst.Point
    g1_ell_alpha_ts: wst.Point
    g2_r_alpha_ts: wst.Point
    g1_o_alpha_ts: wst.Point
    g1_ell_beta_ts: wst.Point
    g1_r_beta_ts: wst.Point
    g1_o_beta_ts: wst.Point


@dataclass
class PinocchioVerificationKey:
    g2_alpha_ell: PyPoint
    g1_alpha_r: PyPoint
    g2_alpha_o: PyPoint
    g1_beta_eta: PyPoint
    g2_beta_eta: PyPoint
    g2_t_s: PyPoint
    g2_eta: PyPoint


@dataclass
class PinocchioProof:
    g1_ell: PyPoint
    g2_r: PyPoint
    g1_o: PyPoint
    g1_ell_prime: PyPoint
    g2_r_prime: PyPoint
    g1_o_prime: PyPoint
    g1_h: PyPoint
    g1_z: PyPoint


def _std(x: Fp) -> torch.Tensor:
    return limb.from_mont(x.spec, x.mont)


def _cat(*fps: Fp) -> Fp:
    """Fp batches joined along their last batch axis."""
    return Fp(fps[0].spec, torch.cat([f.mont for f in fps], dim=-1))


def _g_multi(which: str, scalars_std) -> wst.Point:
    """[x_i]G for the generator of ``which`` ("g1" or "g2"), one fixed-base
    batch; scalars_std: (L, n) standard-domain limbs."""
    return fixed_base.fixed_base_multi(which, scalars_std)


def _split(pt: wst.Point, sizes) -> list:
    """A point batch cut along its batch axis into consecutive pieces."""
    outs, off = [], 0
    for s in sizes:
        outs.append(wst.point_map(lambda a, o=off, s=s: a.narrow(1, o, s), pt))
        off += s
    return outs


def _single(pt: wst.Point) -> wst.Point:
    """(1,) batch -> unbatched point."""
    return wst.point_map(lambda a: a[:, 0], pt)


def setup(qap: SparseQAP | QAP, rng=None) -> tuple[PinocchioProofKey, PinocchioVerificationKey]:
    """Toxic waste s, alpha_{ell,r,o}, beta, eta, rho_{ell,r} (rho_o =
    rho_ell rho_r) from ``rng``; the key's G1 points are one fixed-base batch
    and its G2 points another (5d + m + 10 and 2d + 7 points)."""
    rng = rng or _random
    R = bn254.R
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    beta, eta = rng.randrange(1, R), rng.randrange(1, R)
    rho_ell, rho_r = rng.randrange(1, R), rng.randrange(1, R)
    rho_o = rho_ell * rho_r % R

    spec, d, m = qap.spec, qap.d, qap.m
    ell_s, r_s, o_s, t_s_fp = qap.eval_all_at(s)  # (d,) each, t(s) scalar
    t_s = int(t_s_fp.to_int())
    dev = ell_s.device
    mk = lambda v: Fp.from_int(spec, v, dev)
    ell_rho = ell_s * mk(rho_ell)
    r_rho = r_s * mk(rho_r)
    o_rho = o_s * mk(rho_o)
    # checksum_i = beta (rho_ell ell_i(s) + rho_r r_i(s) + rho_o o_i(s))
    checksum = (ell_rho + r_rho + o_rho) * mk(beta)
    s_pows = _ntt.geometric_series(spec, s, m + 1, dev)

    g1_scalars = _cat(
        ell_rho,                       # g1_ell_i             (d)
        o_rho,                         # g1_o_i               (d)
        ell_rho * mk(a_ell),           # g1_alpha_ell_i       (d)
        o_rho * mk(a_o),               # g1_alpha_o_i         (d)
        checksum,                      # g1_checksum          (d)
        s_pows,                        # g1_sj                (m+1)
        mk([
            rho_ell * t_s % R,                 # g1_ell_ts
            rho_o * t_s % R,                   # g1_o_ts
            rho_ell * t_s % R * a_ell % R,     # g1_ell_alpha_ts
            rho_o * t_s % R * a_o % R,         # g1_o_alpha_ts
            rho_ell * beta % R * t_s % R,      # g1_ell_beta_ts
            rho_r * beta % R * t_s % R,        # g1_r_beta_ts
            rho_o * beta % R * t_s % R,        # g1_o_beta_ts
            a_r,                               # vk g1_alpha_r
            beta * eta % R,                    # vk g1_beta_eta
        ]),
    )
    g2_scalars = _cat(
        r_rho,                         # g2_r_i               (d)
        r_rho * mk(a_r),               # g2_alpha_r_i         (d)
        mk([
            rho_r * t_s % R,                   # g2_r_ts
            rho_r * t_s % R * a_r % R,         # g2_r_alpha_ts
            a_ell,                             # vk g2_alpha_ell
            a_o,                               # vk g2_alpha_o
            beta * eta % R,                    # vk g2_beta_eta
            rho_o * t_s % R,                   # vk g2_t_s  (= t(s) * g2_o)
            eta,                               # vk g2_eta
        ]),
    )

    g1_all = _g_multi("g1", _std(g1_scalars))
    g2_all = _g_multi("g2", _std(g2_scalars))
    (g1_ell_i, g1_o_i, g1_a_ell_i, g1_a_o_i, g1_check, g1_sj, g1_singles
     ) = _split(g1_all, [d, d, d, d, d, m + 1, 9])
    g2_r_i, g2_a_r_i, g2_singles = _split(g2_all, [d, d, 7])
    g1s = _split(g1_singles, [1] * 9)
    g2s = _split(g2_singles, [1] * 7)
    vk1 = bn254.g1_points_to_host(g1_singles)
    vk2 = bn254.g2_points_to_host(g2_singles)

    pk = PinocchioProofKey(
        g1_ell_i=g1_ell_i, g2_r_i=g2_r_i, g1_o_i=g1_o_i,
        g1_alpha_ell_i=g1_a_ell_i, g2_alpha_r_i=g2_a_r_i, g1_alpha_o_i=g1_a_o_i,
        g1_sj=g1_sj, g1_checksum=g1_check,
        g1_ell_ts=g1s[0], g1_o_ts=g1s[1], g1_ell_alpha_ts=g1s[2],
        g1_o_alpha_ts=g1s[3], g1_ell_beta_ts=g1s[4], g1_r_beta_ts=g1s[5],
        g1_o_beta_ts=g1s[6],
        g2_r_ts=g2s[0], g2_r_alpha_ts=g2s[1],
    )
    vk = PinocchioVerificationKey(
        g2_alpha_ell=vk2[2], g1_alpha_r=vk1[7], g2_alpha_o=vk2[3],
        g1_beta_eta=vk1[8], g2_beta_eta=vk2[4], g2_t_s=vk2[5], g2_eta=vk2[6],
    )
    return pk, vk


@span("quotient")
def get_shifted_h(qap: SparseQAP | QAP, assignment: Fp, d_ell: int, d_r: int,
                  d_o: int, transform=_ntt.transform) -> Poly:
    """The m + 1 coefficients of H = h + ell d_r + r d_ell + t d_ell d_r - d_o.

    For the sparse QAP, ``arith/sparse.shifted_h_rou`` of the constraint
    evaluations: ell, r, o interpolate them over the m-point domain, h =
    (ell r - o) / t with t = X^m - 1, each transform a ``transform`` (a
    mesh's splits them over its ranks).  For the dense QAP (either domain),
    h is ``QAP.h_poly`` and ell, r, o ``QAP.combine``, and t d_ell d_r - d_o
    is t's coefficients scaled, less d_o at 0, as the reference's dense
    branch computes them; it takes no other transform."""
    if isinstance(qap, SparseQAP):
        return shifted_h_rou(qap.evaluations(assignment), d_ell, d_r, d_o, transform)
    if transform is not _ntt.transform:
        raise ValueError("the dense QAP's quotient runs on one rank: it takes no transform")
    spec, m = qap.spec, qap.m
    p, dev = spec.p, assignment.device
    scalar = lambda x: Fp.from_int(spec, x % p, dev)
    n1 = m + 1
    h = qap.h_poly(assignment)
    ell, r, _ = qap.combine(assignment)
    return (h.pad_to(n1)
            + ell.scale_const(scalar(d_r)).pad_to(n1)
            + r.scale_const(scalar(d_ell)).pad_to(n1)
            + Poly(qap.t).scale_const(scalar(d_ell * d_r)).pad_to(n1)
            - Poly(scalar(d_o).reshape(1)).pad_to(n1))


def _stack(pts) -> wst.Point:
    """Unbatched points -> one (n,) batch."""
    return wst.point_map(lambda *cs: torch.stack(cs, dim=1), *pts)


def _mesh_axis(mesh) -> str:
    """The one axis of a mesh prover's mesh."""
    if mesh.ndim != 1:
        raise ValueError(f"the mesh provers take a 1-D mesh, not axes {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names[0]


def _rank_block(pts: wst.Point, s, mesh, axis: str) -> tuple:
    """This rank's block of an MSM over (n,) points padded to a multiple of
    the mesh size with the first point and zero scalars (their terms are
    infinity; the reference's ``_dist_msm_pad``); only a block past the end
    gets padding."""
    n, D = s.shape[1], mesh.size()
    b = -(-n // D)
    r = mesh.get_local_rank(axis)
    lo, hi = min(r * b, n), min((r + 1) * b, n)
    pad = b - (hi - lo)
    blk = wst.point_map(lambda a: torch.cat([a[:, lo:hi], a[:, :1].expand(-1, pad)], dim=1),
                        pts)
    return blk, torch.nn.functional.pad(s[:, lo:hi], (0, pad))


def _msms(F, b3, jobs, shifts, mesh) -> list:
    """The MSMs of the whole (points, scalars) ``jobs`` then of ``shifts``
    (one point each: the delta shifts) in one group, the results in that
    order: one ``msm_many`` call; with a mesh, ``parallel/mesh.dist_msm_many``
    of each job's rank block (``_rank_block``), the shifts whole on every
    rank."""
    if mesh is None:
        return _msm.msm_many(F, b3, list(jobs) + list(shifts))
    axis = _mesh_axis(mesh)
    return pm.dist_msm_many(F, b3, [_rank_block(p, s, mesh, axis) for p, s in jobs], mesh,
                            axis, shifts)


def prove(assignment: Fp, pk: PinocchioProofKey, qap: SparseQAP | QAP, rng=None,
          mesh=None) -> PinocchioProof:
    """The 8-element proof: six G1 and two G2 MSMs over the assignment, the
    shifted h and its commitment, and the delta_{ell,r,o} shifts (drawn from
    ``rng`` in that order).  With ``mesh``: ``prove_mesh``."""
    if mesh is not None:
        return prove_mesh(assignment, pk, qap, mesh, rng)
    return _prove(assignment, pk, qap, rng, None)


def prove_mesh(assignment: Fp, pk: PinocchioProofKey, qap: SparseQAP, mesh,
               rng=None) -> PinocchioProof:
    """The proof with its work split over the ranks of a 1-D mesh
    (``parallel/mesh``), called on every rank with the same whole inputs
    and the same ``rng`` state: the eight MSMs run data-parallel
    (``_msms``; the delta shifts stay on each rank's ladder), and the
    quotient stage's transforms run as ``dist_ntt`` / ``dist_intt``
    (``get_shifted_h`` with ``parallel/mesh.transform_over``).  Every rank returns the proof of the
    single-rank ``prove``, point for point.  Raises ValueError for a dense
    QAP, or m < D^2 (the four-step split)."""
    if not isinstance(qap, SparseQAP):
        raise ValueError(f"the mesh prover takes a SparseQAP (the root-of-unity domain, "
                         f"t = X^m - 1), not {type(qap).__name__}")
    _mesh_axis(mesh)
    D = mesh.size()
    if qap.m < D * D:
        raise ValueError(f"m = {qap.m} < D^2 = {D * D}: the quotient's four-step "
                         f"transforms over {D} ranks need m >= D^2")
    return _prove(assignment, pk, qap, rng, mesh)


def _prove(assignment: Fp, pk: PinocchioProofKey, qap: SparseQAP | QAP, rng,
           mesh) -> PinocchioProof:
    rng = rng or _random
    R = bn254.R
    d_ell, d_r, d_o = (rng.randrange(1, R) for _ in range(3))
    dev = assignment.device
    a_std = _std(assignment)
    transform = _ntt.transform if mesh is None else pm.transform_over(mesh, _mesh_axis(mesh))
    h_std = _std(get_shifted_h(qap, assignment, d_ell, d_r, d_o, transform).coef)
    delta = lambda x: _msm.scalars_from_int(bn254.r_spec(), [x], dev)

    # each group's MSMs and its delta shifts [delta] ts in one call: the
    # shifts (one point each) share one double-and-add ladder
    F1, b31 = bn254.g1_ops(), bn254.g1_b3((), dev)
    (ell, o, ell_p, o_p, g1_h, z, sh_ell, sh_o, sh_ell_p, sh_o_p, sh_ell_b,
     sh_r_b, sh_o_b) = _msms(F1, b31, [
        (pk.g1_ell_i, a_std), (pk.g1_o_i, a_std), (pk.g1_alpha_ell_i, a_std),
        (pk.g1_alpha_o_i, a_std), (pk.g1_sj, h_std), (pk.g1_checksum, a_std)], [
        (pk.g1_ell_ts, delta(d_ell)), (pk.g1_o_ts, delta(d_o)),
        (pk.g1_ell_alpha_ts, delta(d_ell)), (pk.g1_o_alpha_ts, delta(d_o)),
        (pk.g1_ell_beta_ts, delta(d_ell)), (pk.g1_r_beta_ts, delta(d_r)),
        (pk.g1_o_beta_ts, delta(d_o))], mesh)
    F2, b32 = bn254.g2_ops(), bn254.g2_b3((), dev)
    r, r_p, sh_r, sh_r_p = _msms(F2, b32, [(pk.g2_r_i, a_std), (pk.g2_alpha_r_i, a_std)], [
        (pk.g2_r_ts, delta(d_r)), (pk.g2_r_alpha_ts, delta(d_r))], mesh)

    add1 = lambda a, b: wst.padd(F1, b31, a, b)
    # z = <checksum, a> + d_ell ell_beta_ts + d_r r_beta_ts + d_o o_beta_ts
    z = add1(add1(add1(z, sh_ell_b), sh_r_b), sh_o_b)
    g1 = [add1(ell, sh_ell), add1(o, sh_o), add1(ell_p, sh_ell_p),
          add1(o_p, sh_o_p), g1_h, z]
    g2 = [wst.padd(F2, b32, r, sh_r), wst.padd(F2, b32, r_p, sh_r_p)]
    h1 = bn254.g1_points_to_host(_stack(g1))
    h2 = bn254.g2_points_to_host(_stack(g2))
    return PinocchioProof(
        g1_ell=h1[0], g2_r=h2[0], g1_o=h1[1], g1_ell_prime=h1[2],
        g2_r_prime=h2[1], g1_o_prime=h1[3], g1_h=h1[4], g1_z=h1[5])


def verify(proof: PinocchioProof, vk: PinocchioVerificationKey) -> bool:
    """Five pairing-product checks, twelve Miller loops, on the host; each
    equality e(A, B) == e(C, D) runs as e(A, B) * e(-C, D) == 1."""
    one = bn254.pairing_product_is_one
    g1 = bn254.g1_generator()
    g2 = bn254.g2_generator()
    return (
        one([(proof.g1_ell, vk.g2_alpha_ell), (-proof.g1_ell_prime, g2)])
        and one([(vk.g1_alpha_r, proof.g2_r), (-g1, proof.g2_r_prime)])
        and one([(proof.g1_o, vk.g2_alpha_o), (-proof.g1_o_prime, g2)])
        and one([(proof.g1_ell, proof.g2_r), (-proof.g1_h, vk.g2_t_s),
                 (-proof.g1_o, g2)])
        and one([(proof.g1_ell + proof.g1_o, vk.g2_beta_eta),
                 (vk.g1_beta_eta, proof.g2_r), (-proof.g1_z, vk.g2_eta)]))
