"""Host golden model: F_q, F_q2, the generic extension field and BN254 G1 /
G2 affine arithmetic on Python ints, and the Miller loop.

The same group law as ``myzkp_tpu/fields/python_field.py`` (``PyField``,
``PyCurve``, ``PyPoint``), with F_q2 = F_q[u]/(u^2 + 1) as a class of its own
for G2, the generic extension field F_p[x]/(m(x)) (``PyExtField``, ``PyExt``,
:134-328; BN254's F_q12 in ``curves/bn254.py``), the Miller loop, its line
function and the Weil and Tate pairings built on it (:405-479), and
the BN254 constants of ``myzkp_tpu/curves/bn254.py:43-82``.  Every device
result of the port is checked against this model; it imports neither torch
nor JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

from .spec import BN254_Q, BN254_R


class PyField:
    """F_p with Python ints. Elements are `PyFp`."""

    def __init__(self, p: int):
        self.p = p

    def __call__(self, v) -> "PyFp":
        return PyFp(self, int(v) % self.p)

    def __eq__(self, other):
        return isinstance(other, PyField) and other.p == self.p


class PyFp:
    __slots__ = ("f", "v")

    def __init__(self, f: PyField, v: int):
        self.f = f
        self.v = v % f.p

    def _c(self, other):
        if isinstance(other, PyFp):
            return other
        if isinstance(other, int):
            return PyFp(self.f, other)
        return NotImplemented

    def __add__(self, o):
        return PyFp(self.f, self.v + self._c(o).v)

    def __sub__(self, o):
        return PyFp(self.f, self.v - self._c(o).v)

    def __mul__(self, o):
        return PyFp(self.f, self.v * self._c(o).v)

    __rmul__ = __mul__

    def __neg__(self):
        return PyFp(self.f, -self.v)

    def __pow__(self, e: int):
        return PyFp(self.f, pow(self.v, int(e), self.f.p))

    def inv(self):
        return PyFp(self.f, pow(self.v, -1, self.f.p))

    def __truediv__(self, o):
        return self * self._c(o).inv()

    def __eq__(self, o):
        if isinstance(o, int):
            return self.v == o % self.f.p
        return isinstance(o, PyFp) and o.f == self.f and o.v == self.v

    def __repr__(self):
        return f"{self.v}"

    def __int__(self):
        return self.v


class PyExtField:
    """F_p[x]/(m(x)), m normalized to monic; elements are ``PyExt`` with a
    tuple of deg PyFp coefficients, low first."""

    def __init__(self, base: PyField, modulus_coeffs):
        self.base = base
        inv_lead = pow(modulus_coeffs[-1] % base.p, -1, base.p)
        self.mod = [c * inv_lead % base.p for c in modulus_coeffs]
        self.deg = len(self.mod) - 1

    def __call__(self, coeffs) -> "PyExt":
        if isinstance(coeffs, PyExt):
            return coeffs
        if isinstance(coeffs, (int, PyFp)):
            coeffs = [coeffs]
        ints = [c.v if isinstance(c, PyFp) else int(c) for c in coeffs]
        return PyExt(self, tuple(self._reduce(ints)))

    def _reduce(self, ints) -> list:
        """A low-first coefficient list reduced by the monic modulus."""
        p = self.base.p
        cs = [c % p for c in ints]
        while len(cs) > self.deg:
            lead = cs.pop()
            if lead:
                k = len(cs) - self.deg  # x^len(cs) = x^k x^deg
                for i in range(self.deg):
                    cs[k + i] = (cs[k + i] - lead * self.mod[i]) % p
        cs += [0] * (self.deg - len(cs))
        return [self.base(c) for c in cs]

    def one(self) -> "PyExt":
        return self([1])

    def __eq__(self, o):
        return isinstance(o, PyExtField) and o.base == self.base and o.mod == self.mod

    def __hash__(self):
        return hash(("PyExtField", self.base.p, tuple(self.mod)))


class PyExt:
    __slots__ = ("ef", "c")

    def __init__(self, ef: PyExtField, coeffs):
        self.ef = ef
        self.c = tuple(coeffs)

    def _c2(self, o):
        if isinstance(o, PyExt):
            return o
        if isinstance(o, (int, PyFp)):
            return self.ef([o])
        return NotImplemented

    def __add__(self, o):
        o = self._c2(o)
        return PyExt(self.ef, tuple(a + b for a, b in zip(self.c, o.c)))

    __radd__ = __add__

    def __sub__(self, o):
        o = self._c2(o)
        return PyExt(self.ef, tuple(a - b for a, b in zip(self.c, o.c)))

    def __rsub__(self, o):
        return self._c2(o) - self

    def __neg__(self):
        return PyExt(self.ef, tuple(-a for a in self.c))

    def __mul__(self, o):
        o = self._c2(o)
        prod = [0] * (2 * self.ef.deg - 1)
        for i, a in enumerate(self.c):
            if a.v:
                for j, b in enumerate(o.c):
                    prod[i + j] += a.v * b.v
        return PyExt(self.ef, tuple(self.ef._reduce(prod)))

    __rmul__ = __mul__

    def __pow__(self, e: int):
        e = int(e)
        if e < 0:
            return self.inv() ** (-e)
        result, base = self.ef.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """By the extended Euclid over F_p[x]; raises on zero."""
        p = self.ef.base.p
        g, s = _poly_ext_euclid([c.v for c in self.c], list(self.ef.mod), p)
        if _poly_deg(g, p) != 0:
            raise ZeroDivisionError("not invertible")
        c_inv = pow(g[0], -1, p)
        return PyExt(self.ef, tuple(self.ef._reduce([v * c_inv % p for v in s])))

    def __truediv__(self, o):
        return self * self._c2(o).inv()

    def __eq__(self, o):
        if isinstance(o, int):
            return self == self.ef([o])
        return isinstance(o, PyExt) and o.ef == self.ef and o.c == self.c

    def __hash__(self):
        return hash((self.ef.base.p, tuple(v.v for v in self.c)))

    def __repr__(self):
        return f"Ext{[v.v for v in self.c]}"


def _poly_deg(a, p) -> int:
    for i in range(len(a) - 1, -1, -1):
        if a[i] % p:
            return i
    return -1


def _poly_divmod(a, b, p):
    """Long division of low-first int coefficient lists over F_p."""
    a = [x % p for x in a]
    db = _poly_deg(b, p)
    if db < 0:
        raise ZeroDivisionError("division by the zero polynomial")
    inv_lead = pow(b[db], -1, p)
    q = [0] * max(1, len(a) - db)
    while _poly_deg(a, p) >= db:
        da = _poly_deg(a, p)
        c = a[da] * inv_lead % p
        q[da - db] = c
        for i in range(db + 1):
            a[da - db + i] = (a[da - db + i] - c * b[i]) % p
    return q, a


def _poly_ext_euclid(a, b, p):
    """(g, s) with s a = g (mod b), g = gcd(a, b), over F_p[x]."""
    r0, r1 = [x % p for x in a], [x % p for x in b]
    s0, s1 = [1], [0]
    while _poly_deg(r1, p) >= 0:
        q, r = _poly_divmod(r0, r1, p)
        r0, r1 = r1, r
        qs1 = [0] * (len(q) + len(s1))
        for i, qq in enumerate(q):
            if qq:
                for j, ss in enumerate(s1):
                    qs1[i + j] = (qs1[i + j] + qq * ss) % p
        n = max(len(s0), len(qs1))
        s0, s1 = s1, [((s0[i] if i < len(s0) else 0) - (qs1[i] if i < len(qs1) else 0)) % p
                      for i in range(n)]
    return r0, s0


@dataclass(frozen=True)
class PyCurve:
    """Short Weierstrass y^2 = x^3 + a x + b over a PyField."""

    a: object
    b: object

    def point(self, x, y) -> "PyPoint":
        return PyPoint(self, x, y, False)

    def infinity(self) -> "PyPoint":
        return PyPoint(self, None, None, True)


class PyPoint:
    __slots__ = ("curve", "x", "y", "inf")

    def __init__(self, curve, x, y, inf=False):
        self.curve = curve
        self.x = x
        self.y = y
        self.inf = inf

    def __eq__(self, o):
        if not isinstance(o, PyPoint):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf and o.inf
        return self.x == o.x and self.y == o.y

    def __neg__(self):
        if self.inf:
            return self
        return PyPoint(self.curve, self.x, -self.y)

    def __add__(self, o):
        # chord/tangent
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x and self.y == -o.y:
            return self.curve.infinity()
        if self == o:
            lam = (3 * self.x * self.x + self.curve.a) / (2 * self.y)
        else:
            lam = (o.y - self.y) / (o.x - self.x)
        x3 = lam * lam - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return PyPoint(self.curve, x3, y3)

    def __mul__(self, k: int):
        k = int(k)
        if k < 0:
            return (-self) * (-k)
        acc = self.curve.infinity()
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add + add
            k >>= 1
        return acc

    def __repr__(self):
        return "O" if self.inf else f"({self.x}, {self.y})"


def line_slope(p: PyPoint, q: PyPoint):
    """The chord's (or the tangent's, at P = Q) slope."""
    if p.x == q.x and p.y == q.y:
        return (3 * p.x * p.x + p.curve.a) / (2 * p.y)
    return (q.y - p.y) / (q.x - p.x)


def get_lambda(p: PyPoint, q: PyPoint, r: PyPoint):
    """The Miller line function: the line through P and Q over the vertical
    through P + Q, evaluated at R; one where a point is at infinity."""
    if p.inf or q.inf or r.inf:
        for pt in (p, q, r):
            if not pt.inf:
                return pt.x ** 0
        raise ValueError("all points at infinity")
    if (p == q and p.y == 0) or (p != q and p.x == q.x):
        return r.x - p.x
    slope = line_slope(p, q)
    numerator = (r.y - p.y) - slope * (r.x - p.x)
    denominator = r.x + p.x + q.x - slope * slope
    return numerator / denominator


def miller(p: PyPoint, q: PyPoint, m: int):
    """(f_{m,P}(Q), [m]P) by the Miller loop over m's bits."""
    if p.inf or q.inf:
        return None, p.curve.infinity()
    if p == q:
        return p.x ** 0, p
    f, t = p.x ** 0, p
    for bit in bin(int(m))[3:]:
        f = f * f * get_lambda(t, t, q)
        t = t + t
        if bit == "1":
            f = f * get_lambda(t, p, q)
            t = t + p
    return f, t


def weil_pairing(p: PyPoint, q: PyPoint, m: int, s: PyPoint):
    """e(P, Q) by Weil reciprocity with the auxiliary point S."""
    if p.inf or q.inf:
        return s.x ** 0
    fp_qs, _ = miller(p, q + s, m)
    fp_s, _ = miller(p, s, m)
    fq_ps, _ = miller(q, p + (-s), m)
    fq_s, _ = miller(q, -s, m)
    return (fp_qs / fp_s) / (fq_ps / fq_s)


def tate_pairing(p: PyPoint, q: PyPoint, ell: int, k: int, field_order: int):
    """The reduced Tate pairing f_{ell,P}(Q)^((field_order^k - 1) / ell)."""
    if p.inf or q.inf:
        return None
    f, _ = miller(p, q, ell)
    return f ** ((field_order ** k - 1) // ell)


def general_tate_pairing(p: PyPoint, q: PyPoint, ell: int, k: int, field_order: int,
                         s: PyPoint):
    """The Tate pairing with the auxiliary point S: f_P(Q + S) / f_P(S),
    reduced."""
    if p.inf or q.inf:
        return None
    fp_qs, _ = miller(p, q + s, ell)
    fp_s, _ = miller(p, s, ell)
    return (fp_qs / fp_s) ** ((field_order ** k - 1) // ell)


Q = BN254_Q  # base field modulus
R = BN254_R  # group order (scalar field)
G1_X, G1_Y = 1, 2
G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)
Fq = PyField(Q)


class PyFq2:
    """c0 + c1 u in F_q[u]/(u^2 + 1); ``c`` holds the two PyFp coefficients,
    low first, as the reference's ``PyExt`` does."""

    __slots__ = ("c",)

    def __init__(self, c0, c1):
        self.c = (Fq(c0), Fq(c1))

    @staticmethod
    def _c(o) -> "PyFq2":
        return o if isinstance(o, PyFq2) else PyFq2(int(o), 0)

    def __add__(self, o):
        o = self._c(o)
        return PyFq2(self.c[0] + o.c[0], self.c[1] + o.c[1])

    __radd__ = __add__

    def __sub__(self, o):
        o = self._c(o)
        return PyFq2(self.c[0] - o.c[0], self.c[1] - o.c[1])

    def __neg__(self):
        return PyFq2(-self.c[0], -self.c[1])

    def __mul__(self, o):
        o = self._c(o)
        a0, a1, b0, b1 = self.c[0].v, self.c[1].v, o.c[0].v, o.c[1].v
        return PyFq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def inv(self):
        """(c0 - c1 u) / (c0^2 + c1^2)."""
        a0, a1 = self.c[0].v, self.c[1].v
        ninv = pow((a0 * a0 + a1 * a1) % Q, -1, Q)
        return PyFq2(a0 * ninv, -a1 * ninv)

    def __truediv__(self, o):
        return self * self._c(o).inv()

    def __eq__(self, o):
        o = self._c(o)
        return self.c[0] == o.c[0] and self.c[1] == o.c[1]

    def __repr__(self):
        return f"Fq2({self.c[0].v}, {self.c[1].v})"


def Fq2(coeffs) -> PyFq2:
    """An int (embedded F_q) or a [c0, c1] list -> PyFq2."""
    if isinstance(coeffs, (list, tuple)):
        return PyFq2(*coeffs)
    return PyFq2(int(coeffs), 0)


B2 = Fq2(3) / Fq2([9, 1])  # G2 twist: y^2 = x^3 + 3 / (9 + u)
curve_g1 = PyCurve(Fq(0), Fq(3))  # y^2 = x^3 + 3
curve_g2 = PyCurve(Fq2(0), B2)


def g1_generator() -> PyPoint:
    return curve_g1.point(Fq(G1_X), Fq(G1_Y))


def g2_generator() -> PyPoint:
    return curve_g2.point(Fq2(list(G2_X)), Fq2(list(G2_Y)))
