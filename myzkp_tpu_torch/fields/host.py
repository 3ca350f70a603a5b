"""Host golden model: F_q, F_q2 and BN254 G1 / G2 affine arithmetic on
Python ints.

The same group law as ``myzkp_tpu/fields/python_field.py`` (``PyField``,
``PyCurve``, ``PyPoint``) restricted to what G1 and G2 need, with F_q2 =
F_q[u]/(u^2 + 1) as a class of its own (the reference's generic ``PyExt`` of
degree 2), and the BN254 constants of ``myzkp_tpu/curves/bn254.py:43-82``.
Every device result of the port is checked against this model; it imports
neither torch nor JAX.
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
