"""Tutorial ladder 1: proving knowledge of p(x) = t(x) h(x) for a single
polynomial, in six hardening steps.

Capability parity with myzkp/src/modules/zksnark/tutorial_single_polynomial/:
  P1 naive all-points check                          protocol_1.rs:56-66
  P2 Schwartz-Zippel random point + malicious prover protocol_2.rs:42-88
  P3 discrete-log-encrypted powers g^{s^i} + attack  protocol_3.rs:76-104
  P4 KEA alpha-shift pairs (u, v, w; u^r = w)        protocol_4.rs:70-84
  P5 ZK via prover delta-mask                        protocol_5.rs:79-90
  P6 non-interactive with BN254 pairings             protocol_6.rs:8-88

The port's copy of ``myzkp_tpu/protocols/tutorial_single_poly.py``.  These
are didactic, tiny-degree protocols: they run on the host on Python ints
(protocols 3-5 work in the multiplicative group of F_p with exponent
arithmetic mod p-1; protocol 6 uses the BN254 pairing of the C++ engine,
``bn254.optimal_ate_pairing``), and launch no kernel.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

from ..curves import bn254
from ..fields.host import PyPoint
from ..utils import hostpoly as hp


# ---------------------------------------------------------------------------
# Protocol 1: naive — verifier checks h(x) t(x) = p(x) at EVERY point
# ---------------------------------------------------------------------------

class Prover1:
    def __init__(self, p_coeffs, t_coeffs, modulus):
        self.p_c, self.t_c, self.m = p_coeffs, t_coeffs, modulus
        self.h_c, rem = hp.divmod_poly(p_coeffs, t_coeffs, modulus)
        if hp.degree(rem, modulus) >= 0:
            raise ValueError("t does not divide p")

    def compute_all_values(self):
        m = self.m
        return ({x: hp.evaluate(self.h_c, x, m) for x in range(m)},
                {x: hp.evaluate(self.p_c, x, m) for x in range(m)})


class Verifier1:
    def __init__(self, known_roots, modulus):
        self.m = modulus
        self.t_c = hp.from_monomials(known_roots, modulus)

    def verify(self, h_values, p_values) -> bool:
        for x, h_x in h_values.items():
            if h_x * hp.evaluate(self.t_c, x, self.m) % self.m != p_values[x]:
                return False
        return True


def naive_protocol(prover: Prover1, verifier: Verifier1) -> bool:
    h_values, p_values = prover.compute_all_values()
    return verifier.verify(h_values, p_values)


# ---------------------------------------------------------------------------
# Protocol 2: Schwartz-Zippel random point; malicious prover defeats it
# ---------------------------------------------------------------------------

class Prover2:
    def __init__(self, p_coeffs, t_coeffs, modulus):
        self.p_c, self.t_c, self.m = p_coeffs, t_coeffs, modulus
        self.h_c, _ = hp.divmod_poly(p_coeffs, t_coeffs, modulus)

    def compute_values(self, s):
        return (hp.evaluate(self.h_c, s, self.m),
                hp.evaluate(self.p_c, s, self.m))


class MaliciousProver2:
    """Picks h' at random and returns p' = h' t(s) (protocol_2.rs:42-59)."""

    def __init__(self, t_coeffs, modulus, rng=None):
        self.t_c, self.m = t_coeffs, modulus
        self.rng = rng or _random

    def compute_malicious_values(self, s):
        h_prime = self.rng.randrange(1, self.m)
        return h_prime, h_prime * hp.evaluate(self.t_c, s, self.m) % self.m


class Verifier2:
    def __init__(self, t_coeffs, modulus, rng=None):
        self.t_c, self.m = t_coeffs, modulus
        self.rng = rng or _random

    def generate_challenge(self):
        return self.rng.randrange(1, self.m)

    def verify(self, s, h, p) -> bool:
        return h * hp.evaluate(self.t_c, s, self.m) % self.m == p % self.m


def schwartz_zippel_protocol(prover, verifier) -> bool:
    s = verifier.generate_challenge()
    h, p = prover.compute_values(s)
    return verifier.verify(s, h, p)


def malicious_schwartz_zippel_protocol(prover: MaliciousProver2,
                                       verifier: Verifier2) -> bool:
    s = verifier.generate_challenge()
    h, p = prover.compute_malicious_values(s)
    return verifier.verify(s, h, p)


# ---------------------------------------------------------------------------
# Protocols 3-5: discrete-log-encrypted challenges in <g> of F_p.
#
# Exponent subtlety (mirrors the reference exactly): the group has order
# p-1, but the polynomial identity p = h*t only holds mod p.  The reference
# works because its BigInt coefficients stay *unreduced small signed
# integers* (field.rs stores value % p which keeps the sign; mod_pow handles
# negative exponents via inverses, utils.rs:108-137), so the identity holds
# over the integers for the didactic examples.  We therefore keep SIGNED
# integer coefficients here and divide exactly over Z (t is monic).
# ---------------------------------------------------------------------------

def _divmod_int_monic(a: list[int], b: list[int]):
    """Exact long division over Z for monic b (signed coefficients)."""
    if b[-1] != 1:
        raise ValueError("the divisor must be monic")
    a = list(a)
    q = [0] * max(1, len(a) - len(b) + 1)
    for da in range(len(a) - 1, len(b) - 2, -1):
        c = a[da]
        if c == 0:
            continue
        q[da - (len(b) - 1)] = c
        for i in range(len(b)):
            a[da - (len(b) - 1) + i] -= c * b[i]
    return q, a


def _pow_signed(base: int, e: int, m: int) -> int:
    """base^e mod m with negative exponents via inverse (utils.rs:108-137)."""
    if e < 0:
        return pow(pow(base, -1, m), -e, m)
    return pow(base, e, m)


def signed_from_monomials(roots: list[int]) -> list[int]:
    """prod (X - r_i) over Z (signed coefficients, unreduced)."""
    coeffs = [1]
    for r in roots:
        nc = [0] * (len(coeffs) + 1)
        for k, c in enumerate(coeffs):
            nc[k] -= c * r
            nc[k + 1] += c
        coeffs = nc
    return coeffs


class Prover3:
    def __init__(self, p_coeffs, t_coeffs, modulus):
        self.p_c, self.t_c, self.m = p_coeffs, t_coeffs, modulus
        self.h_c, rem = _divmod_int_monic(p_coeffs, t_coeffs)
        if any(rem):
            raise ValueError("t must divide p over Z")

    def compute_values(self, s_powers):
        m = self.m
        g_p = _eval_with_powers(self.p_c, s_powers, m)
        g_h = _eval_with_powers(self.h_c, s_powers, m)
        return g_p, g_h


def _eval_with_powers(coeffs, s_powers, m):
    """prod_i (g^{s^i})^{c_i} = g^{p(s)} (parity: polynomial.rs:147-153)."""
    acc = 1
    for c, gp in zip(coeffs, s_powers):
        acc = acc * _pow_signed(gp, c, m) % m
    return acc


class Verifier3:
    def __init__(self, t_coeffs, modulus, generator, rng=None):
        self.t_c, self.m, self.g = t_coeffs, modulus, generator
        rng = rng or _random
        self.s = rng.randrange(1, modulus)

    def generate_challenge(self, max_degree):
        m = self.m
        return [pow(self.g, pow(self.s, i, m - 1), m)
                for i in range(max_degree + 1)]

    def verify(self, u, v) -> bool:
        t_s = hp.eval_m1(self.t_c, self.s, self.m)
        return u == pow(v, t_s, self.m)


class MaliciousProver3:
    """Forges (g^t)^z, g^z without knowing h (protocol_3.rs:55-73)."""

    def __init__(self, t_coeffs, modulus, rng=None):
        self.t_c, self.m = t_coeffs, modulus
        self.rng = rng or _random

    def compute_malicious_values(self, s_powers):
        m = self.m
        g_t = _eval_with_powers(self.t_c, s_powers, m)
        z = self.rng.randrange(1, m)
        return pow(g_t, z, m), pow(s_powers[0], z, m)


def discrete_log_protocol(prover: Prover3, verifier: Verifier3) -> bool:
    s_powers = verifier.generate_challenge(hp.degree(prover.p_c, prover.m))
    u, v = prover.compute_values(s_powers)
    return verifier.verify(u, v)


def malicious_discrete_log_protocol(prover: MaliciousProver3,
                                    verifier: Verifier3) -> bool:
    s_powers = verifier.generate_challenge(hp.degree(prover.t_c, prover.m))
    u, v = prover.compute_malicious_values(s_powers)
    return verifier.verify(u, v)


class Prover4(Prover3):
    def compute_values(self, s_powers, s_prime_powers):
        m = self.m
        return (_eval_with_powers(self.p_c, s_powers, m),
                _eval_with_powers(self.h_c, s_powers, m),
                _eval_with_powers(self.p_c, s_prime_powers, m))


class Verifier4:
    """Adds the KEA alpha-shift check u^r == w (protocol_4.rs:70-84)."""

    def __init__(self, t_coeffs, modulus, generator, rng=None):
        self.t_c, self.m, self.g = t_coeffs, modulus, generator
        rng = rng or _random
        self.s = rng.randrange(1, modulus)
        self.r = rng.randrange(1, modulus)

    def generate_challenge(self, max_degree):
        m = self.m
        s_powers, s_prime_powers = [], []
        for i in range(max_degree + 1):
            gp = pow(self.g, pow(self.s, i, m - 1), m)
            s_powers.append(gp)
            s_prime_powers.append(pow(gp, self.r, m))
        return s_powers, s_prime_powers

    def verify(self, u, v, w) -> bool:
        t_s = hp.eval_m1(self.t_c, self.s, self.m)
        return pow(u, self.r, self.m) == w and u == pow(v, t_s, self.m)


def knowledge_of_exponent_protocol(prover: Prover4, verifier: Verifier4
                                   ) -> bool:
    d = max(hp.degree(prover.p_c, prover.m), hp.degree(prover.h_c, prover.m))
    s_powers, s_prime_powers = verifier.generate_challenge(d)
    u, v, w = prover.compute_values(s_powers, s_prime_powers)
    return verifier.verify(u, v, w)


class Prover5(Prover4):
    """Adds the zero-knowledge delta mask (protocol_5.rs:25-38)."""

    def __init__(self, p_coeffs, t_coeffs, modulus, rng=None):
        super().__init__(p_coeffs, t_coeffs, modulus)
        self.rng = rng or _random

    def compute_values(self, s_powers, s_prime_powers):
        m = self.m
        delta = self.rng.randrange(1, m)
        g_p, g_h, g_p_prime = super().compute_values(s_powers, s_prime_powers)
        return (pow(g_p, delta, m), pow(g_h, delta, m), pow(g_p_prime, delta, m))


Verifier5 = Verifier4  # same checks (protocol_5.rs:40-73)


def zk_protocol(prover: Prover5, verifier) -> bool:
    d = max(hp.degree(prover.p_c, prover.m), hp.degree(prover.h_c, prover.m))
    s_powers, s_prime_powers = verifier.generate_challenge(d + 1)
    u, v, w = prover.compute_values(s_powers, s_prime_powers)
    return verifier.verify(u, v, w)


# ---------------------------------------------------------------------------
# Protocol 6: non-interactive with BN254 pairings (protocol_6.rs:8-88)
# ---------------------------------------------------------------------------

@dataclass
class ProofKey6:
    alpha: list  # [s^i] G1
    alpha_prime: list  # [r s^i] G1


@dataclass
class VerificationKey6:
    g_r: PyPoint  # [r] G2
    g_t_s: PyPoint  # [t(s)] G2


@dataclass
class Proof6:
    u_prime: PyPoint
    v_prime: PyPoint
    w_prime: PyPoint


def setup6(t_coeffs, n, rng=None):
    rng = rng or _random
    R = bn254.R
    s = rng.randrange(1, R)
    r = rng.randrange(1, R)
    g1, g2 = bn254.g1_generator(), bn254.g2_generator()
    alpha, alpha_prime = [], []
    s_power = 1
    for _ in range(n + 1):
        alpha.append(g1 * s_power)
        alpha_prime.append(g1 * (s_power * r % R))
        s_power = s_power * s % R
    return (ProofKey6(alpha, alpha_prime),
            VerificationKey6(g_r=g2 * r,
                             g_t_s=g2 * hp.evaluate(t_coeffs, s, R)))


def _eval_on_curve(coeffs, points):
    acc = points[0].curve.infinity()
    for c, pt in zip(coeffs, points):
        acc = acc + pt * (c % bn254.R)
    return acc


def prove6(p_coeffs, t_coeffs, pk: ProofKey6, rng=None) -> Proof6:
    rng = rng or _random
    R = bn254.R
    h_coeffs, _ = hp.divmod_poly(p_coeffs, t_coeffs, R)
    delta = rng.randrange(1, R)
    g_p = _eval_on_curve(p_coeffs, pk.alpha)
    g_h = _eval_on_curve(h_coeffs, pk.alpha)
    g_p_prime = _eval_on_curve(p_coeffs, pk.alpha_prime)
    return Proof6(u_prime=g_p * delta, v_prime=g_h * delta,
                  w_prime=g_p_prime * delta)


def verify6(proof: Proof6, vk: VerificationKey6) -> bool:
    e = bn254.optimal_ate_pairing
    g2 = bn254.g2_generator()
    if e(proof.u_prime, vk.g_r) != e(proof.w_prime, g2):
        return False
    return e(proof.u_prime, g2) == e(proof.v_prime, vk.g_t_s)
