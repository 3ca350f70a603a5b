"""Tutorial ladder 2: QAP-based SNARK hardening in five steps, each with a
working attack demonstration.

Capability parity with myzkp/src/modules/zksnark/tutorial_snark/:
  P1 single alpha; interchange_attack swaps ell/o    protocol_1.rs:39-110
  P2 separate alpha_ell/alpha_r/alpha_o; the inconsistent-variable attack
     (different assignments per L/R/O) still works   protocol_2.rs:40-128
  P3 adds the beta-checksum term g1_z                protocol_3.rs:45-99
  P4 beta*eta masking                                protocol_4.rs:46-104
  P5 rho_ell/rho_r/rho_o = rho_ell*rho_r shifted generators
                                                     protocol_5.rs:45-117
and the shared helpers of zksnark/utils.rs (generate_challenge_vec :18-27,
generate_alpha_challenge_vec :40-50, generate_s_powers :61-73,
accumulate_curve_points :83-92, accumulate_polynomials :102-112,
get_h = (ell*r - o)/t :127-132).

The port's copy of ``myzkp_tpu/protocols/tutorial_snark.py``.  These are
didactic small-circuit protocols; they run on host BN254 points with the C++
engine's pairing (``bn254.optimal_ate_pairing``) and launch no kernel.  The
production-scale path (device MSMs, NTT h-computation) is
snark/pinocchio.py, which is P5 + prover-side ZK shifts.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, replace

from ..curves import bn254
from ..utils import hostpoly as hp

R = bn254.R


# ---------------------------------------------------------------------------
# Host QAP (int coefficient lists; parity: arithmetization/qap.rs:5-41)
# ---------------------------------------------------------------------------

@dataclass
class HostQAP:
    ell: list  # d coefficient lists
    r: list
    o: list
    t: list
    m: int
    d: int

    @classmethod
    def from_r1cs(cls, left, right, out, p=R) -> "HostQAP":
        m, d = len(left), len(left[0])
        xs = list(range(1, m + 1))
        interp = lambda mat: [
            hp.interpolate(xs, [mat[row][i] % p for row in range(m)], p)
            for i in range(d)
        ]
        return cls(ell=interp(left), r=interp(right), o=interp(out),
                   t=hp.from_monomials(xs, p), m=m, d=d)


def accumulate_polynomials(polys, assignment, p=R):
    """sum_i a_i poly_i (parity: zksnark/utils.rs:102-112)."""
    acc = [0]
    for a, c in zip(assignment, polys):
        acc = hp.add(acc, hp.scale(c, a % p, p), p)
    return acc


def get_h(qap: HostQAP, assignment, p=R):
    """(ell*r - o)/t (parity: zksnark/utils.rs:127-132)."""
    ell = accumulate_polynomials(qap.ell, assignment, p)
    r = accumulate_polynomials(qap.r, assignment, p)
    o = accumulate_polynomials(qap.o, assignment, p)
    num = hp.sub(hp.mul(ell, r, p), o, p)
    q, _ = hp.divmod_poly(num, qap.t, p)
    return q


def generate_challenge_vec(g, polys, s, p=R):
    """[poly_i(s)] * g (parity: zksnark/utils.rs:18-27)."""
    return [g * hp.evaluate(c, s, p) for c in polys]


def generate_alpha_challenge_vec(g, polys, s, alpha, p=R):
    """[alpha * poly_i(s)] * g (parity: zksnark/utils.rs:40-50)."""
    return [g * (alpha * hp.evaluate(c, s, p) % p) for c in polys]


def generate_s_powers(g, s, m, p=R):
    """[s^j] g for j = 0..m (parity: zksnark/utils.rs:61-73)."""
    out, acc = [], 1
    for _ in range(m + 1):
        out.append(g * acc)
        acc = acc * s % p
    return out


def accumulate_curve_points(points, assignment):
    """sum_i a_i P_i (parity: zksnark/utils.rs:83-92)."""
    acc = points[0].curve.infinity()
    for a, pt in zip(assignment, points):
        acc = acc + pt * (a % R)
    return acc


def eval_with_powers_on_curve(coeffs, s_powers):
    """sum_j c_j [s^j]G (parity: polynomial.rs:156-165)."""
    acc = s_powers[0].curve.infinity()
    for c, pt in zip(coeffs, s_powers):
        acc = acc + pt * (c % R)
    return acc


# ---------------------------------------------------------------------------
# Shared proof shape
# ---------------------------------------------------------------------------

@dataclass
class SnarkProof:
    g1_ell: object
    g2_r: object
    g1_o: object
    g1_ell_prime: object
    g2_r_prime: object
    g1_o_prime: object
    g1_h: object
    g1_z: object = None


def _core_prove(pk, qap: HostQAP, assignment) -> SnarkProof:
    return SnarkProof(
        g1_ell=accumulate_curve_points(pk["g1_ell_i"], assignment),
        g2_r=accumulate_curve_points(pk["g2_r_i"], assignment),
        g1_o=accumulate_curve_points(pk["g1_o_i"], assignment),
        g1_ell_prime=accumulate_curve_points(pk["g1_a_ell_i"], assignment),
        g2_r_prime=accumulate_curve_points(pk["g2_a_r_i"], assignment),
        g1_o_prime=accumulate_curve_points(pk["g1_a_o_i"], assignment),
        g1_h=eval_with_powers_on_curve(get_h(qap, assignment), pk["g1_sj"]),
        g1_z=(accumulate_curve_points(pk["g1_checksum"], assignment)
              if "g1_checksum" in pk else None),
    )


def _core_vectors(qap: HostQAP, s, g1b, g2b, a_ell, a_r, a_o, g1, g2):
    """The six challenge vectors + s powers shared by every protocol."""
    return {
        "g1_ell_i": generate_challenge_vec(g1b, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2b, qap.r, s),
        "g1_o_i": None,  # set by caller (generator differs in P5)
        "g1_a_ell_i": generate_alpha_challenge_vec(g1b, qap.ell, s, a_ell),
        "g2_a_r_i": generate_alpha_challenge_vec(g2b, qap.r, s, a_r),
        "g1_a_o_i": None,
        "g1_sj": generate_s_powers(g1, s, qap.m),
    }


def _g():
    return bn254.g1_generator(), bn254.g2_generator()


# ---------------------------------------------------------------------------
# Protocol 1: single alpha -> interchange attack works
# ---------------------------------------------------------------------------

def setup1(qap: HostQAP, rng=None):
    rng = rng or _random
    g1, g2 = _g()
    s, alpha = rng.randrange(1, R), rng.randrange(1, R)
    pk = {
        "g1_ell_i": generate_challenge_vec(g1, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2, qap.r, s),
        "g1_o_i": generate_challenge_vec(g1, qap.o, s),
        "g1_a_ell_i": generate_alpha_challenge_vec(g1, qap.ell, s, alpha),
        "g2_a_r_i": generate_alpha_challenge_vec(g2, qap.r, s, alpha),
        "g1_a_o_i": generate_alpha_challenge_vec(g1, qap.o, s, alpha),
        "g1_sj": generate_s_powers(g1, s, qap.m),
    }
    vk = {"g1_alpha": g1 * alpha, "g2_alpha": g2 * alpha,
          "g2_t_s": g2 * hp.evaluate(qap.t, s, R)}
    return pk, vk


def prove1(pk, qap, assignment):
    return _core_prove(pk, qap, assignment)


def verify1(proof: SnarkProof, vk) -> bool:
    e = bn254.optimal_ate_pairing
    g1, g2 = _g()
    if e(proof.g1_ell, vk["g2_alpha"]) != e(proof.g1_ell_prime, g2):
        return False
    if e(vk["g1_alpha"], proof.g2_r) != e(g1, proof.g2_r_prime):
        return False
    if e(proof.g1_o, vk["g2_alpha"]) != e(proof.g1_o_prime, g2):
        return False
    return (e(proof.g1_ell, proof.g2_r)
            == e(proof.g1_h, vk["g2_t_s"]) * e(proof.g1_o, g2))


def interchange_attack(proof: SnarkProof) -> SnarkProof:
    """Swap the ell and o components (parity: protocol_1.rs:101-110)."""
    return replace(proof, g1_ell=proof.g1_o, g1_ell_prime=proof.g1_o_prime)


# ---------------------------------------------------------------------------
# Protocol 2: separate alphas; inconsistent-variable attack still works
# ---------------------------------------------------------------------------

def setup2(qap: HostQAP, rng=None):
    rng = rng or _random
    g1, g2 = _g()
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    pk = {
        "g1_ell_i": generate_challenge_vec(g1, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2, qap.r, s),
        "g1_o_i": generate_challenge_vec(g1, qap.o, s),
        "g1_a_ell_i": generate_alpha_challenge_vec(g1, qap.ell, s, a_ell),
        "g2_a_r_i": generate_alpha_challenge_vec(g2, qap.r, s, a_r),
        "g1_a_o_i": generate_alpha_challenge_vec(g1, qap.o, s, a_o),
        "g1_sj": generate_s_powers(g1, s, qap.m),
    }
    vk = {"g2_alpha_ell": g2 * a_ell, "g1_alpha_r": g1 * a_r,
          "g2_alpha_o": g2 * a_o, "g2_t_s": g2 * hp.evaluate(qap.t, s, R)}
    return pk, vk


prove2 = prove1


def verify2(proof: SnarkProof, vk) -> bool:
    e = bn254.optimal_ate_pairing
    g1, g2 = _g()
    if e(proof.g1_ell, vk["g2_alpha_ell"]) != e(proof.g1_ell_prime, g2):
        return False
    if e(vk["g1_alpha_r"], proof.g2_r) != e(g1, proof.g2_r_prime):
        return False
    if e(proof.g1_o, vk["g2_alpha_o"]) != e(proof.g1_o_prime, g2):
        return False
    return (e(proof.g1_ell, proof.g2_r)
            == e(proof.g1_h, vk["g2_t_s"]) * e(proof.g1_o, g2))


def inconsistent_variable_attack(pk, qap: HostQAP, a_ell, a_r, a_o
                                 ) -> SnarkProof:
    """Use different assignments for L, R, O (protocol_2.rs:85-128; also the
    attack re-run against protocols 3-5 where it must fail)."""
    ell = accumulate_polynomials(qap.ell, a_ell)
    r = accumulate_polynomials(qap.r, a_r)
    o = accumulate_polynomials(qap.o, a_o)
    num = hp.sub(hp.mul(ell, r, R), o, R)
    h, _ = hp.divmod_poly(num, qap.t, R)
    return SnarkProof(
        g1_ell=accumulate_curve_points(pk["g1_ell_i"], a_ell),
        g2_r=accumulate_curve_points(pk["g2_r_i"], a_r),
        g1_o=accumulate_curve_points(pk["g1_o_i"], a_o),
        g1_ell_prime=accumulate_curve_points(pk["g1_a_ell_i"], a_ell),
        g2_r_prime=accumulate_curve_points(pk["g2_a_r_i"], a_r),
        g1_o_prime=accumulate_curve_points(pk["g1_a_o_i"], a_o),
        g1_h=eval_with_powers_on_curve(h, pk["g1_sj"]),
        g1_z=(accumulate_curve_points(pk["g1_checksum"], a_ell)
              if "g1_checksum" in pk else None),
    )


# ---------------------------------------------------------------------------
# Protocol 3: beta-checksum term z (catches inconsistent assignments)
# ---------------------------------------------------------------------------

def setup3(qap: HostQAP, rng=None):
    rng = rng or _random
    g1, g2 = _g()
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    b_ell, b_r, b_o = (rng.randrange(1, R) for _ in range(3))
    checksum = []
    for i in range(qap.d):
        v = (b_ell * hp.evaluate(qap.ell[i], s, R)
             + b_r * hp.evaluate(qap.r[i], s, R)
             + b_o * hp.evaluate(qap.o[i], s, R)) % R
        checksum.append(g1 * v)
    pk = {
        "g1_ell_i": generate_challenge_vec(g1, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2, qap.r, s),
        "g1_o_i": generate_challenge_vec(g1, qap.o, s),
        "g1_a_ell_i": generate_alpha_challenge_vec(g1, qap.ell, s, a_ell),
        "g2_a_r_i": generate_alpha_challenge_vec(g2, qap.r, s, a_r),
        "g1_a_o_i": generate_alpha_challenge_vec(g1, qap.o, s, a_o),
        "g1_sj": generate_s_powers(g1, s, qap.m),
        "g1_checksum": checksum,
    }
    vk = {"g2_alpha_ell": g2 * a_ell, "g1_alpha_r": g1 * a_r,
          "g2_alpha_o": g2 * a_o, "g2_beta_ell": g2 * b_ell,
          "g1_beta_r": g1 * b_r, "g2_beta_o": g2 * b_o,
          "g2_t_s": g2 * hp.evaluate(qap.t, s, R)}
    return pk, vk


prove3 = prove1


def verify3(proof: SnarkProof, vk) -> bool:
    if not verify2(proof, vk):
        return False
    e = bn254.optimal_ate_pairing
    g2 = bn254.g2_generator()
    lhs = (e(proof.g1_ell, vk["g2_beta_ell"])
           * e(vk["g1_beta_r"], proof.g2_r)
           * e(proof.g1_o, vk["g2_beta_o"]))
    return lhs == e(proof.g1_z, g2)


# ---------------------------------------------------------------------------
# Protocol 4: beta*eta masking
# ---------------------------------------------------------------------------

def setup4(qap: HostQAP, rng=None):
    rng = rng or _random
    g1, g2 = _g()
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    b_ell, b_r, b_o = (rng.randrange(1, R) for _ in range(3))
    eta = rng.randrange(1, R)
    checksum = []
    for i in range(qap.d):
        v = (b_ell * hp.evaluate(qap.ell[i], s, R)
             + b_r * hp.evaluate(qap.r[i], s, R)
             + b_o * hp.evaluate(qap.o[i], s, R)) % R
        checksum.append(g1 * v)
    pk = {
        "g1_ell_i": generate_challenge_vec(g1, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2, qap.r, s),
        "g1_o_i": generate_challenge_vec(g1, qap.o, s),
        "g1_a_ell_i": generate_alpha_challenge_vec(g1, qap.ell, s, a_ell),
        "g2_a_r_i": generate_alpha_challenge_vec(g2, qap.r, s, a_r),
        "g1_a_o_i": generate_alpha_challenge_vec(g1, qap.o, s, a_o),
        "g1_sj": generate_s_powers(g1, s, qap.m),
        "g1_checksum": checksum,
    }
    vk = {"g2_alpha_ell": g2 * a_ell, "g1_alpha_r": g1 * a_r,
          "g2_alpha_o": g2 * a_o,
          "g2_beta_ell_eta": g2 * (b_ell * eta % R),
          "g1_beta_r_eta": g1 * (b_r * eta % R),
          "g2_beta_o_eta": g2 * (b_o * eta % R),
          "g2_t_s": g2 * hp.evaluate(qap.t, s, R), "g2_eta": g2 * eta}
    return pk, vk


prove4 = prove1


def verify4(proof: SnarkProof, vk) -> bool:
    if not verify2(proof, {"g2_alpha_ell": vk["g2_alpha_ell"],
                           "g1_alpha_r": vk["g1_alpha_r"],
                           "g2_alpha_o": vk["g2_alpha_o"],
                           "g2_t_s": vk["g2_t_s"]}):
        return False
    e = bn254.optimal_ate_pairing
    lhs = (e(proof.g1_ell, vk["g2_beta_ell_eta"])
           * e(vk["g1_beta_r_eta"], proof.g2_r)
           * e(proof.g1_o, vk["g2_beta_o_eta"]))
    return lhs == e(proof.g1_z, vk["g2_eta"])


# ---------------------------------------------------------------------------
# Protocol 5: rho-shifted generators (rho_o = rho_ell * rho_r)
# ---------------------------------------------------------------------------

def setup5(qap: HostQAP, rng=None):
    rng = rng or _random
    g1, g2 = _g()
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    beta, eta = rng.randrange(1, R), rng.randrange(1, R)
    rho_ell, rho_r = rng.randrange(1, R), rng.randrange(1, R)
    rho_o = rho_ell * rho_r % R
    g1_ell, g1_r, g2_r = g1 * rho_ell, g1 * rho_r, g2 * rho_r
    g1_o, g2_o = g1 * rho_o, g2 * rho_o
    checksum = []
    for i in range(qap.d):
        checksum.append(
            g1_ell * (beta * hp.evaluate(qap.ell[i], s, R) % R)
            + g1_r * (beta * hp.evaluate(qap.r[i], s, R) % R)
            + g1_o * (beta * hp.evaluate(qap.o[i], s, R) % R))
    pk = {
        "g1_ell_i": generate_challenge_vec(g1_ell, qap.ell, s),
        "g2_r_i": generate_challenge_vec(g2_r, qap.r, s),
        "g1_o_i": generate_challenge_vec(g1_o, qap.o, s),
        "g1_a_ell_i": generate_alpha_challenge_vec(g1_ell, qap.ell, s, a_ell),
        "g2_a_r_i": generate_alpha_challenge_vec(g2_r, qap.r, s, a_r),
        "g1_a_o_i": generate_alpha_challenge_vec(g1_o, qap.o, s, a_o),
        "g1_sj": generate_s_powers(g1, s, qap.m),
        "g1_checksum": checksum,
    }
    vk = {"g2_alpha_ell": g2 * a_ell, "g1_alpha_r": g1 * a_r,
          "g2_alpha_o": g2 * a_o,
          "g1_beta_eta": g1 * (beta * eta % R),
          "g2_beta_eta": g2 * (beta * eta % R),
          "g2_t_s": g2_o * hp.evaluate(qap.t, s, R),
          "g2_eta": g2 * eta}
    return pk, vk


prove5 = prove1


def verify5(proof: SnarkProof, vk) -> bool:
    if not verify2(proof, {"g2_alpha_ell": vk["g2_alpha_ell"],
                           "g1_alpha_r": vk["g1_alpha_r"],
                           "g2_alpha_o": vk["g2_alpha_o"],
                           "g2_t_s": vk["g2_t_s"]}):
        return False
    e = bn254.optimal_ate_pairing
    lhs = (e(proof.g1_ell + proof.g1_o, vk["g2_beta_eta"])
           * e(vk["g1_beta_eta"], proof.g2_r))
    return lhs == e(proof.g1_z, vk["g2_eta"])
