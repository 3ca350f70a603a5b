"""Small host polynomials over Python ints mod p, low coefficient first.

The port's copy of ``myzkp_tpu/utils/hostpoly.py``: the tutorial protocols'
polynomials have degrees in the single digits, so they stay on host ints and
never pay a device round trip.  The device path for large polynomials is
``ops/poly.py`` and ``ops/ntt.py``.
"""

from __future__ import annotations


def trim(a: list[int], p: int) -> list[int]:
    a = [x % p for x in a]
    while len(a) > 1 and a[-1] == 0:
        a.pop()
    return a


def degree(a: list[int], p: int) -> int:
    for i in range(len(a) - 1, -1, -1):
        if a[i] % p:
            return i
    return -1


def add(a: list[int], b: list[int], p: int) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % p
            for i in range(n)]


def sub(a: list[int], b: list[int], p: int) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % p
            for i in range(n)]


def mul(a: list[int], b: list[int], p: int) -> list[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x % p == 0:
            continue
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def scale(a: list[int], c: int, p: int) -> list[int]:
    return [x * c % p for x in a]


def divmod_poly(a: list[int], b: list[int], p: int):
    """(q, r) with a = q b + r, deg r < deg b."""
    a = [x % p for x in a]
    db = degree(b, p)
    if db < 0:
        raise ZeroDivisionError("division by the zero polynomial")
    inv_lead = pow(b[db] % p, -1, p)
    q = [0] * max(1, len(a) - db)
    while degree(a, p) >= db:
        da = degree(a, p)
        c = a[da] * inv_lead % p
        q[da - db] = c
        for i in range(db + 1):
            a[da - db + i] = (a[da - db + i] - c * b[i]) % p
    return q, a


def evaluate(a: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % p
    return acc


def eval_m1(a: list[int], x: int, p: int) -> int:
    """Horner evaluation mod p - 1: exponent arithmetic in the group of
    F_p's units."""
    m1 = p - 1
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % m1
    return acc


def from_monomials(roots: list[int], p: int) -> list[int]:
    """prod (X - r_i)."""
    coeffs = [1]
    for r in roots:
        nc = [0] * (len(coeffs) + 1)
        for k, c in enumerate(coeffs):
            nc[k] = (nc[k] - c * r) % p
            nc[k + 1] = (nc[k + 1] + c) % p
        coeffs = nc
    return coeffs


def interpolate(xs: list[int], ys: list[int], p: int) -> list[int]:
    """The polynomial of degree < n through (xs, ys): O(n^2) Lagrange."""
    n = len(xs)
    coeffs = [0] * max(1, n)
    for i in range(n):
        denom = 1
        basis = [1]
        for j in range(n):
            if j == i:
                continue
            denom = denom * (xs[i] - xs[j]) % p
            nb = [0] * (len(basis) + 1)
            for k, c in enumerate(basis):
                nb[k] = (nb[k] - c * xs[j]) % p
                nb[k + 1] = (nb[k + 1] + c) % p
            basis = nb
        w = ys[i] * pow(denom, -1, p) % p
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + w * c) % p
    return coeffs
