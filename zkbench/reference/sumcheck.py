"""Plain sumcheck reference: the claimed sum and the round polynomials of a
product of multilinear factors, in closed form over Python ints.

Each factor is a sum of terms c * prod_{v in M} x_v (M a set of variables).
Over the boolean hypercube, the product of three such sums expands into one
term per triple (t1, t2, t3) of their terms, whose sum over y in {0, 1}^n
is c1 c2 c3 2^(n - |M1 u M2 u M3|).  In round j the variables before j are
bound to the challenges, variable j is the round polynomial's X and those
after j are summed, so the triple adds

  c1 c2 c3 * prod over k and v in Mk, v < j of r_v  *  X^#{k : j in Mk}
  * 2^((n - j - 1) - |(M1 u M2 u M3) minus {0..j}|)

to g_j(X).  The challenges come from the same transcript as the prover's:
SHAKE256 over the bincode encoding of the pushed objects (the number of
variables as a u64, then the claimed sum, then each round's coefficients,
each value 32 bytes little-endian), 32 bytes read big-endian, mod p.  No
table is built, so nothing is shared with the table prover under test.

``challenge_bits`` below 256 is the control: each challenge cut to its low
bits, as a prover that draws short challenges would.
"""

from __future__ import annotations

import hashlib
import itertools
import struct


def _bincode(objects: list) -> bytes:
    out = [struct.pack("<Q", len(objects))]
    for obj in objects:
        out.append(struct.pack("<Q", len(obj)))
        for b in obj:
            out.append(struct.pack("<Q", len(b)))
            out.append(b)
    return b"".join(out)


def _mask(exps) -> int:
    return sum(1 << v for v, e in enumerate(exps) if e)


def prove(factors: list, num_vars: int, max_degree: int, p: int,
          challenge_bits: int = 256) -> tuple:
    """factors: lists of (exponent tuple of 0 / 1, coefficient).  Returns
    (claimed sum, [round coefficients, low first, max_degree + 1 each])."""
    for f in factors:
        for exps, _ in f:
            if any(e not in (0, 1) for e in exps) or len(exps) > num_vars:
                raise ValueError("the reference takes multilinear terms in num_vars variables")
    if len(factors) > max_degree:
        raise ValueError("a round polynomial of more factors than max_degree")
    terms = [[(_mask(e), c % p) for e, c in f] for f in factors]
    combos = list(itertools.product(*(range(len(f)) for f in terms)))
    unions = []
    for idx in combos:
        u = 0
        for k, t in enumerate(idx):
            u |= terms[k][t][0]
        unions.append(u)

    def weight_of(idx, weights):
        w = 1
        for k, t in enumerate(idx):
            w = w * weights[k][t] % p
        return w

    # each term's coefficient times the challenges bound so far of its variables
    weights = [[c for _, c in f] for f in terms]
    claimed = 0
    for idx, u in zip(combos, unions):
        claimed = (claimed + weight_of(idx, weights)
                   * pow(2, num_vars - bin(u).count("1"), p)) % p

    objects = [[struct.pack("<Q", num_vars)], [claimed.to_bytes(32, "little")]]
    rounds = []
    cut = (1 << challenge_bits) - 1
    for j in range(num_vars):
        coeffs = [0] * (max_degree + 1)
        above = ~((1 << (j + 1)) - 1)
        for idx, u in zip(combos, unions):
            e = sum((terms[k][t][0] >> j) & 1 for k, t in enumerate(idx))
            free = (num_vars - j - 1) - bin(u & above).count("1")
            coeffs[e] = (coeffs[e] + weight_of(idx, weights) * pow(2, free, p)) % p
        rounds.append(coeffs)
        objects.append([v.to_bytes(32, "little") for v in coeffs])
        digest = hashlib.shake_256(_bincode(objects)).digest(32)
        r = (int.from_bytes(digest, "big") % p) & cut
        for k, f in enumerate(terms):
            for t, (m, _) in enumerate(f):
                if (m >> j) & 1:
                    weights[k][t] = weights[k][t] * r % p
    return claimed, rounds
