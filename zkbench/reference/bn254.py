"""BN254 on the host in plain Python ints, for the references.

The curve as EIP-197 and the Ethereum precompiles define it: F_q, G1 on
y^2 = x^3 + 3 with generator (1, 2), G2 on the twist y^2 = x^3 + 3 / (9 + u)
over F_q2 = F_q[u] / (u^2 + 1) with EIP-197's generator, both of order r.
Points are affine tuples, None for the point at infinity; a G2 coordinate is
a pair (c0, c1) = c0 + c1 u.  Scalar multiplication is a plain
double-and-add, one field inversion a step: slow and plain on purpose.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1 = (1, 2)
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))


class _Fq:
    """F_q as the group law needs it."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def small(k):
        return k % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)


class _Fq2:
    """F_q2 = F_q[u] / (u^2 + 1), elements (c0, c1)."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def small(k):
        return (k % Q, 0)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * n % Q, -a[1] * n % Q)


def _add(F, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if F.add(y1, y2) == F.zero:
            return None
        lam = F.mul(F.mul(F.small(3), F.mul(x1, x1)), F.inv(F.mul(F.small(2), y1)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    return (x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1))


def _mul(F, pt, k: int):
    k %= R
    acc = None
    for bit in bin(k)[2:]:
        acc = _add(F, acc, acc)
        if bit == "1":
            acc = _add(F, acc, pt)
    return acc


def g1_mul(k: int):
    """[k] G1, affine (x, y) ints or None."""
    return _mul(_Fq, G1, k)


def g2_mul(k: int):
    """[k] G2, affine ((x0, x1), (y0, y1)) or None."""
    return _mul(_Fq2, G2, k)


def on_curves() -> bool:
    """The generators satisfy their curve equations (a self-check)."""
    x, y = G1
    if (y * y - x * x * x - 3) % Q:
        return False
    b2 = _Fq2.mul((3, 0), _Fq2.inv((9, 1)))
    x2, y2 = G2
    lhs = _Fq2.mul(y2, y2)
    rhs = _Fq2.add(_Fq2.mul(_Fq2.mul(x2, x2), x2), b2)
    return lhs == rhs
