"""Groth16 zk-SNARK over the sparse or the dense QAP: setup, prove and
verify.

Counterpart of ``myzkp_tpu/snark/groth16.py`` (setup :67-125, prove
:153-225 with the dense QAP's h :138-150, verify :228-243), on
``arith/sparse.SparseQAP`` or ``arith/qap.QAP`` as the reference is.  The
proving and verifying keys are one fixed-base batch per group (3m + 4 G1
points, m + 3 G2 points); the prover is four G1 MSMs and one G2 MSM over the
assignment and h, with the [r]/[s]/[rs] delta shifts on the same
``msm_many`` calls, then one ladder for [s]A and [r]B1; the verifier's
product of four pairings runs on the host (``native/``).  Randomness is drawn
from ``rng`` in the reference's order, so the same seeded ``random.Random``
and the same key give the reference's proof, point for point.

Conventions: witness index 0 is the constant one-wire; indices
[0, num_public) are the public inputs, the rest are private.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

from ..arith.qap import QAP
from ..arith.sparse import SparseQAP
from ..curves import bn254, msm as _msm, weierstrass as wst
from ..fields.fp import Fp
from ..fields.host import PyPoint
from ..ops import ntt as _ntt
from ..utils.metrics import span
from .pinocchio import _cat, _g_multi, _mesh_axis, _msms, _single, _split, _stack, _std


@dataclass
class Groth16ProvingKey:
    g1_alpha: wst.Point  # (1,) batches for the shift terms
    g1_beta: wst.Point
    g1_delta: wst.Point
    g2_beta: wst.Point
    g2_delta: wst.Point
    g1_xj: wst.Point      # (m,)  [x^j]G1, j = 0..m-1
    g2_xj: wst.Point      # (m,)  [x^j]G2
    g1_k_priv: wst.Point  # (d - num_public,)  [(beta u_i + alpha v_i + w_i)/delta]G1
    g1_ht: wst.Point      # (m-1,) [x^j t(x)/delta]G1, j = 0..m-2
    num_public: int


@dataclass
class Groth16VerifyingKey:
    g1_alpha: PyPoint
    g2_beta: PyPoint
    g2_gamma: PyPoint
    g2_delta: PyPoint
    g1_k_pub: wst.Point  # (num_public,) [(beta u_i + alpha v_i + w_i)/gamma]G1
    num_public: int


@dataclass
class Groth16Proof:
    a: PyPoint  # G1
    b: PyPoint  # G2
    c: PyPoint  # G1


def setup(qap: SparseQAP | QAP, num_public: int, rng=None
          ) -> tuple[Groth16ProvingKey, Groth16VerifyingKey]:
    """Trusted setup with toxic waste alpha, beta, gamma, delta, x (drawn
    from ``rng`` in that order).  The G1 scalars are [alpha, beta, delta] ||
    x^j (m) || K_priv / delta (d - num_public) || x^j t(x) / delta (m - 1) ||
    K_pub / gamma (num_public), K_i = beta u_i(x) + alpha v_i(x) + w_i(x);
    the G2 scalars [beta, gamma, delta] || x^j (m)."""
    rng = rng or _random
    R = bn254.R
    alpha, beta, gamma, delta = (rng.randrange(1, R) for _ in range(4))
    x = rng.randrange(1, R)
    spec, m, d = qap.spec, qap.m, qap.d
    if not 0 < num_public <= d:
        raise ValueError(f"num_public = {num_public} outside (0, {d}]")

    u_x, v_x, w_x, t_x_fp = qap.eval_all_at(x)  # (d,) each
    t_x = int(t_x_fp.to_int())
    dev = u_x.device
    gamma_inv, delta_inv = pow(gamma, -1, R), pow(delta, -1, R)
    mk = lambda v: Fp.from_int(spec, v, dev)
    k_all = u_x * mk(beta) + v_x * mk(alpha) + w_x
    k_pub = k_all[:num_public] * mk(gamma_inv)
    k_priv = k_all[num_public:] * mk(delta_inv)
    x_pows = _ntt.geometric_series(spec, x, m, dev)
    ht = x_pows[:m - 1] * mk(t_x * delta_inv % R)

    g1_all = _g_multi("g1", _std(_cat(mk([alpha, beta, delta]), x_pows, k_priv,
                                      ht, k_pub)))
    g2_all = _g_multi("g2", _std(_cat(mk([beta, gamma, delta]), x_pows)))
    g1_abd, g1_xj, g1_kpriv, g1_ht, g1_kpub = _split(
        g1_all, [3, m, d - num_public, m - 1, num_public])
    g2_bgd, g2_xj = _split(g2_all, [3, m])
    g1s = _split(g1_abd, [1, 1, 1])
    g2s = _split(g2_bgd, [1, 1, 1])
    h2 = bn254.g2_points_to_host(g2_bgd)

    pk = Groth16ProvingKey(
        g1_alpha=g1s[0], g1_beta=g1s[1], g1_delta=g1s[2],
        g2_beta=g2s[0], g2_delta=g2s[2],
        g1_xj=g1_xj, g2_xj=g2_xj, g1_k_priv=g1_kpriv, g1_ht=g1_ht,
        num_public=num_public,
    )
    vk = Groth16VerifyingKey(
        g1_alpha=bn254.g1_points_to_host(g1s[0])[0],
        g2_beta=h2[0], g2_gamma=h2[1], g2_delta=h2[2],
        g1_k_pub=g1_kpub, num_public=num_public,
    )
    return pk, vk


@span("quotient")
def _uvh(qap: SparseQAP | QAP, assignment: Fp) -> tuple:
    """u and v's (m,) coefficients, and h = (u v - w) / t's first m - 1
    (zero-padded): one batched INTT and the quotient stage for the sparse
    QAP; ``QAP.combine`` and ``QAP.h_poly`` for the dense one."""
    m = qap.m
    if isinstance(qap, QAP):
        u, v, _ = (poly.coef for poly in qap.combine(assignment))
        h = qap.h_poly(assignment).coef.pad_to(m - 1)
    else:
        coef = qap.combine_batched(assignment)  # (3, m): u, v, w
        u, v, h = coef[0], coef[1], qap.quotient(coef)
    return u, v, h[:m - 1]


def prove(assignment: Fp, pk: Groth16ProvingKey, qap: SparseQAP | QAP,
          rng=None, mesh=None) -> Groth16Proof:
    """A = alpha + u(x) + r delta;  B = beta + v(x) + s delta;
    C = (sum_priv a_i K_i + h(x) t(x))/delta + s A + r B1 - r s delta,
    with r, s drawn from ``rng`` in that order.

    u, v, w come from one batched INTT and h = (u v - w) / t from the
    quotient stage (sparse QAP), or from ``QAP.combine`` and ``QAP.h_poly``
    (dense QAP); h is taken as its first m - 1 coefficients, zero-padded
    (deg h <= m - 2 for a satisfying witness).  Each group's MSMs and its delta shifts go through
    one ``msm_many`` call; [s]A and [r]B1 share one more ladder.

    With ``mesh`` (a 1-D ``parallel/mesh`` mesh; called on every rank with
    the same whole inputs and ``rng`` state) the five MSMs over the
    assignment and h run split over its ranks (``pinocchio._msms``)
    and the rest on every rank: the same proof on each, for either QAP and
    any m."""
    if mesh is not None:
        _mesh_axis(mesh)
    rng = rng or _random
    R = bn254.R
    r_rand, s_rand = rng.randrange(1, R), rng.randrange(1, R)
    dev = assignment.device
    npub = pk.num_public
    u, v, h = _uvh(qap, assignment)
    u_std, v_std, h_std = _std(u), _std(v), _std(h)
    a_priv = _std(assignment)[:, npub:]
    sc = lambda k: _msm.scalars_from_int(bn254.r_spec(), [k], dev)

    F1, b31 = bn254.g1_ops(), bn254.g1_b3((), dev)
    F2, b32 = bn254.g2_ops(), bn254.g2_b3((), dev)
    u_x, v_x1, c_priv, c_ht, r_dl, s_dl, rs_dl = _msms(F1, b31, [
        (pk.g1_xj, u_std), (pk.g1_xj, v_std), (pk.g1_k_priv, a_priv),
        (pk.g1_ht, h_std)], [(pk.g1_delta, sc(r_rand)), (pk.g1_delta, sc(s_rand)),
                             (pk.g1_delta, sc(r_rand * s_rand % R))], mesh)
    v_x2, s_dl2 = _msms(F2, b32, [(pk.g2_xj, v_std)], [(pk.g2_delta, sc(s_rand))], mesh)

    add1 = lambda a, b: wst.padd(F1, b31, a, b)
    A = add1(add1(u_x, _single(pk.g1_alpha)), r_dl)
    B1 = add1(add1(v_x1, _single(pk.g1_beta)), s_dl)
    B2 = wst.padd(F2, b32, wst.padd(F2, b32, v_x2, _single(pk.g2_beta)), s_dl2)
    s_a, r_b1 = _msm.msm_many(F1, b31, [
        (wst.point_map(lambda a: a[:, None], A), sc(s_rand)),
        (wst.point_map(lambda a: a[:, None], B1), sc(r_rand))])
    C = add1(add1(add1(add1(c_priv, c_ht), s_a), r_b1), wst.pneg(F1, rs_dl))

    h1 = bn254.g1_points_to_host(_stack([A, C]))
    return Groth16Proof(a=h1[0], b=bn254.g2_points_to_host(_stack([B2]))[0],
                        c=h1[1])


def verify(proof: Groth16Proof, vk: Groth16VerifyingKey,
           public_inputs: list[int]) -> bool:
    """e(A, B) == e(alpha, beta) e(D, gamma) e(C, delta) with
    D = sum_pub a_i [K_i/gamma]G1: one product of 4 pairings, one shared
    final exponentiation, on the host.  D is a double-and-add ladder over
    the key's points on their device, as long as the longest input: public
    inputs are host ints, often small."""
    if len(public_inputs) != vk.num_public:
        raise ValueError(f"{len(public_inputs)} public inputs, the key takes "
                         f"{vk.num_public}")
    vals = [v % bn254.R for v in public_inputs]
    dev = wst.leaves(vk.g1_k_pub)[0].device
    F1, b31 = bn254.g1_ops(), bn254.g1_b3((), dev)
    bits = _msm.scalar_bits(_msm.scalars_from_int(bn254.r_spec(), vals, dev),
                            max(1, max(v.bit_length() for v in vals)))
    D_dev = wst.tree_sum(F1, b31, wst.scalar_mul_bits(F1, b31, vk.g1_k_pub, bits))
    D = bn254.g1_points_to_host(_stack([D_dev]))[0]
    return bn254.pairing_product_is_one([
        (-proof.a, proof.b),
        (vk.g1_alpha, vk.g2_beta),
        (D, vk.g2_gamma),
        (proof.c, vk.g2_delta),
    ])
