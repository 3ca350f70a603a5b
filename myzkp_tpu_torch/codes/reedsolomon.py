"""Reed-Solomon codes over GF(2^8): systematic encode, BM / Chien / Forney
decode, 1D and 2D.

Counterpart of ``myzkp_tpu/codes/reedsolomon.py`` (the reference's
``reedsolomon.rs``).  The host part is a copy: ``GF256`` (log / antilog
tables, modulus 0x11D, generator 2), the generic ``ReedSolomon`` over field
objects with its decoders, ``ReedSolomon2D`` and the byte wrappers
``setup_rs1d`` / ``setup_rs2d`` / ``encode_rs*`` / ``decode_rs*``.

The bulk encode of the data-availability models runs on the device as torch
ops on uint8 tensors: ``gf_mul_bytes`` is two gathers from the log / antilog
tables kept on the tensors' device, and ``encode_rs1d_batch`` is a GF(2^8)
vector-matrix product by the parity matrix, its XOR reduction a halving
tree of ``bitwise_xor``.  ``encode_rs2d_batch`` gives ``ReedSolomon2D.encode``'s
layout: the message at the top coefficients, rows first, then columns, then
the transpose.  The parity matrix is built on the host from the successive
remainders x^(d+i) mod g, one shift-and-reduce a row.  Where n > 255 the
evaluation points g^i repeat (g = 2 has order 255); the codeword is still
the same linear map, so the bytes equal the JAX package's, and ``decode``
returns what the reference's does there, ``None`` included.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _ext

# ---------------------------------------------------------------------------
# GF(2^8) tables (modulus 0x11D, generator alpha = x = 2)
# ---------------------------------------------------------------------------

_POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


_EXP, _LOG = _build_tables()


class GF256:
    """GF(2^8) element; arithmetic via log/antilog tables.  ``v`` is the
    reference's u8 cast (bit i = coefficient of x^i)."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = int(v) & 0xFF

    def __add__(self, o):
        return GF256(self.v ^ o.v)

    __sub__ = __add__
    __radd__ = __add__

    def __neg__(self):
        return self

    def __mul__(self, o):
        if isinstance(o, int):
            o = GF256(o)
        if self.v == 0 or o.v == 0:
            return GF256(0)
        return GF256(_EXP[_LOG[self.v] + _LOG[o.v]])

    __rmul__ = __mul__

    def inv(self):
        assert self.v != 0
        return GF256(_EXP[255 - _LOG[self.v]])

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        if self.v == 0:
            return GF256(1) if e == 0 else GF256(0)
        return GF256(_EXP[(_LOG[self.v] * (e % 255)) % 255])

    def __eq__(self, o):
        if isinstance(o, int):
            return self.v == o
        return isinstance(o, GF256) and self.v == o.v

    def __hash__(self):
        return hash(("GF256", self.v))

    def is_zero(self):
        return self.v == 0

    def __repr__(self):
        return f"GF256({self.v})"

    @staticmethod
    def zero():
        return GF256(0)

    @staticmethod
    def one():
        return GF256(1)


# ---------------------------------------------------------------------------
# Generic RS coder (elements: any objects with field operators)
# ---------------------------------------------------------------------------

class ReedSolomon:
    """RS(n, k) with d = n - k parity symbols and evaluation points g^i."""

    def __init__(self, n: int, k: int, g):
        assert n >= k, "n must be at least k"
        self.n, self.k, self.d = n, k, n - k
        self.g = g

    def evaluation_points(self, el: int):
        return [self.g ** i for i in range(el)]

    def generator_polynomial(self):
        """prod_{i<d} (X - g^i), low-first coefficient list."""
        coeffs = [self.g ** 0]
        for pt in self.evaluation_points(self.d):
            coeffs = _mul_linear(coeffs, pt)
        return coeffs

    def encode(self, message: list):
        """Systematic: codeword = m(X) X^d - (m X^d mod g); the message
        occupies the TOP coefficients."""
        assert len(message) <= self.k
        zero = GF_ZERO_OF(self.g)
        shifted = [zero] * self.d + list(message)
        gpoly = self.generator_polynomial()
        rem = _poly_mod(shifted, gpoly)
        rem = rem + [zero] * (len(shifted) - len(rem))
        return [a - b for a, b in zip(shifted, rem)]

    def compute_syndromes(self, received: list):
        pts = self.evaluation_points(self.n)
        out = []
        for j in range(self.d):
            s = GF_ZERO_OF(self.g)
            for i, r in enumerate(received):
                s = s + r * (pts[i] ** j)
            out.append(s)
        return out

    def _berlekamp_massey(self, syndromes: list):
        one = self.g ** 0
        zero = GF_ZERO_OF(self.g)
        sigma = [one]
        bb = [one]
        el, m, b = 0, 1, one
        for n_iter in range(len(syndromes)):
            d = syndromes[n_iter]
            for i in range(1, el + 1):
                if i < len(sigma):
                    d = d + sigma[i] * syndromes[n_iter - i]
            if d == zero:
                m += 1
            else:
                t = list(sigma)
                factor = d / b
                x_m_b = [zero] * m + list(bb)
                prod = [c * factor for c in x_m_b]
                sigma = [
                    (sigma[i] if i < len(sigma) else zero)
                    - (prod[i] if i < len(prod) else zero)
                    for i in range(max(len(sigma), len(prod)))
                ]
                if 2 * el <= n_iter:
                    el = n_iter + 1 - el
                    bb, b, m = t, d, 1
                else:
                    m += 1
        return sigma

    def _find_error_locations(self, sigma: list):
        pts = self.evaluation_points(self.n)
        zero = GF_ZERO_OF(self.g)
        out = []
        for i, pt in enumerate(pts):
            if _poly_eval(sigma, pt.inv()) == zero:
                out.append(i)
        return out

    def correct_errors(self, received: list):
        """The corrected word, or None where the decoder fails."""
        assert len(received) <= self.n
        zero = GF_ZERO_OF(self.g)
        syndromes = self.compute_syndromes(received)
        if all(s == zero for s in syndromes):
            return list(received)
        sigma = self._berlekamp_massey(syndromes)
        error_positions = self._find_error_locations(sigma)
        num_errors = _poly_degree(sigma, zero)
        if len(error_positions) != num_errors:
            return None
        # error evaluator omega = (sigma * S) mod x^{2t}
        t2 = 2 * ((self.n - self.k) // 2)
        omega = _poly_mul(sigma, syndromes, zero)[: t2 or 1]
        sigma_deriv = [c * _int_embed(i + 1, self.g) for i, c in
                       enumerate(sigma[1:])]
        corrected = list(received)
        pts = self.evaluation_points(self.n)
        for pos in error_positions:
            xi = pts[pos]
            xi_inv = xi.inv()
            om = _poly_eval(omega, xi_inv)
            sd = _poly_eval(sigma_deriv, xi_inv)
            if sd == zero:
                return None
            error_mag = -(xi * om) / sd
            corrected[pos] = corrected[pos] - error_mag
        return corrected

    def decode(self, received: list):
        corrected = self.correct_errors(received)
        if corrected is None or len(corrected) < self.d:
            return None
        return corrected[self.d:]


# small helpers over generic field objects --------------------------------

def GF_ZERO_OF(g):
    """The zero of g's field (g - g), for any field element g."""
    return g - g


def _int_embed(n: int, g):
    """n * 1 in the field of g (char-2 fields collapse to parity)."""
    one = g ** 0
    acc = GF_ZERO_OF(g)
    for _ in range(n % 2 if isinstance(g, GF256) else n):
        acc = acc + one
    return acc


def _mul_linear(coeffs: list, root):
    """coeffs(X) * (X - root)."""
    zero = GF_ZERO_OF(root)
    out = [zero] * (len(coeffs) + 1)
    for i, c in enumerate(coeffs):
        out[i + 1] = out[i + 1] + c
        out[i] = out[i] - c * root
    return out


def _poly_degree(a: list, zero) -> int:
    for i in range(len(a) - 1, -1, -1):
        if not a[i] == zero:
            return i
    return 0


def _poly_eval(a: list, x):
    acc = GF_ZERO_OF(x)
    for c in reversed(a):
        acc = acc * x + c
    return acc


def _poly_mul(a: list, b: list, zero):
    out = [zero] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = out[i + j] + x * y
    return out


def _poly_mod(a: list, b: list):
    """a mod b for monic-leading b (generic field objects)."""
    zero = GF_ZERO_OF(b[-1])
    a = list(a)
    db = _poly_degree(b, zero)
    lead_inv = b[db].inv()
    for da in range(len(a) - 1, db - 1, -1):
        if a[da] == zero:
            continue
        c = a[da] * lead_inv
        for i in range(db + 1):
            a[da - db + i] = a[da - db + i] - c * b[i]
    return a[:db]


# ---------------------------------------------------------------------------
# 2D RS
# ---------------------------------------------------------------------------

class ReedSolomon2D:
    def __init__(self, col_codeword_len: int, row_codeword_len: int,
                 message_len: int, g):
        size = math.isqrt(message_len - 1) + 1 if message_len else 0  # ceil(sqrt)
        self.size = size
        self.col_coder = ReedSolomon(col_codeword_len, size, g)
        self.row_coder = ReedSolomon(row_codeword_len, size, g)
        self.message_len = message_len
        self.g = g

    def _matrix(self, data: list):
        size = math.isqrt(len(data) - 1) + 1 if data else 0
        zero = GF_ZERO_OF(self.g)
        m = [[zero] * size for _ in range(size)]
        for i, v in enumerate(data):
            m[i // size][i % size] = v
        return m

    @staticmethod
    def _transpose(m):
        return [list(row) for row in zip(*m)]

    def encode(self, data: list):
        matrix = self._matrix(data)
        enc_rows = [self.row_coder.encode(row) for row in matrix]
        enc_cols = [self.col_coder.encode(col)
                    for col in self._transpose(enc_rows)]
        return self._transpose(enc_cols)

    def decode(self, received):
        cols = self._transpose(received)
        col_dec = []
        for c in cols:
            d = self.col_coder.decode(c)
            if d is None:
                return None
            col_dec.append(d)
        rows = self._transpose(col_dec)
        row_dec = []
        for r in rows:
            d = self.row_coder.decode(r)
            if d is None:
                return None
            row_dec.append(d)
        size = self.size
        zero = GF_ZERO_OF(self.g)
        flat = [zero] * (size * size)
        for i, row in enumerate(row_dec):
            for j, v in enumerate(row):
                flat[i * size + j] = v
        return flat[: self.message_len]


# ---------------------------------------------------------------------------
# Byte wrappers
# ---------------------------------------------------------------------------

def setup_rs1d(codeword_len: int, message_len: int) -> ReedSolomon:
    return ReedSolomon(codeword_len, message_len, GF256(2))


def setup_rs2d(col_codeword_len: int, row_codeword_len: int,
               message_len: int) -> ReedSolomon2D:
    return ReedSolomon2D(col_codeword_len, row_codeword_len, message_len,
                         GF256(2))


def encode_rs1d(message: bytes | list, rs: ReedSolomon) -> list:
    return [c.v for c in rs.encode([GF256(m) for m in message])]


def decode_rs1d(code: list, rs: ReedSolomon):
    out = rs.decode([GF256(c) for c in code])
    return None if out is None else [c.v for c in out]


def encode_rs2d(message: bytes | list, rs: ReedSolomon2D) -> list:
    return [[c.v for c in row] for row in rs.encode([GF256(m) for m in message])]


def decode_rs2d(code: list, rs: ReedSolomon2D):
    out = rs.decode([[GF256(c) for c in row] for row in code])
    return None if out is None else [c.v for c in out]


# ---------------------------------------------------------------------------
# Bulk encode on the device (uint8 tensors)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The antilog table (512 uint8, so a sum of two logs needs no mod) and
    the log table (256 int64) on ``device``."""
    return (torch.from_numpy(_EXP).to(device),
            torch.from_numpy(_LOG.astype(np.int64)).to(device))


def gf_mul_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) product of uint8 tensors (broadcasting), on their device."""
    exp, log = _tables(a.device)
    out = exp[log[a.long()] + log[b.long()]]
    return out.masked_fill_((a == 0) | (b == 0), 0)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over ``dim`` as a halving tree of ``bitwise_xor``."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        head = torch.bitwise_xor(x.narrow(dim, 0, h), x.narrow(dim, h, h))
        x = torch.cat([head, x.narrow(dim, 2 * h, 1)], dim) if n % 2 else head
    return x.squeeze(dim)


def _gf_mul_np(a: np.ndarray, c: int) -> np.ndarray:
    """GF(2^8) product of a uint8 array by one byte c (host)."""
    if c == 0:
        return np.zeros_like(a)
    out = _EXP[_LOG[a.astype(np.int64)] + _LOG[c]]
    return np.where(a == 0, np.uint8(0), out)


@functools.lru_cache(maxsize=16)
def _parity_host(n: int, k: int, g: int) -> np.ndarray:
    """The (k, d) parity matrix of RS(n, k) over points g^i, as uint8: row i
    is x^(d+i) mod gen(x), gen = prod_{i<d} (X - g^i)."""
    d = n - k
    if d == 0:
        return np.zeros((k, 0), dtype=np.uint8)
    roots = [int(_EXP[(int(_LOG[g]) * (i % 255)) % 255]) if g else int(i == 0)
             for i in range(d)]
    gen = np.ones(1, dtype=np.uint8)  # low first, monic
    for r in roots:
        nxt = np.zeros(len(gen) + 1, dtype=np.uint8)
        nxt[1:] ^= gen
        nxt[:-1] ^= _gf_mul_np(gen, r)
        gen = nxt
    low = gen[:d]  # x^d = -low = low (characteristic 2)
    P = np.zeros((k, d), dtype=np.uint8)
    cur = low.copy()
    for i in range(k):
        P[i] = cur
        top = int(cur[-1])
        cur = np.concatenate([np.zeros(1, dtype=np.uint8), cur[:-1]])
        cur ^= _gf_mul_np(low, top)
    return P


def rs1d_parity_matrix(rs: ReedSolomon, device=None) -> torch.Tensor:
    """(k, d) uint8 matrix P with parity = msg @ P over GF(2^8), on the card
    unless ``device`` names another device: row i is the parity of the
    unit message e_i, x^(d+i) mod the generator polynomial."""
    if not isinstance(rs.g, GF256):
        raise TypeError("the byte path takes a coder over GF256")
    return torch.tensor(_parity_host(rs.n, rs.k, rs.g.v), device=_ext.resolve_device(device))


def encode_rs1d_batch(messages: torch.Tensor, rs: ReedSolomon) -> torch.Tensor:
    """uint8 messages (..., k) -> codewords (..., n) on the messages'
    device: parity = msg x P (one gather product and a XOR tree), then
    the message."""
    if messages.shape[-1] != rs.k:
        raise ValueError(f"messages of {messages.shape[-1]} symbols, the code takes {rs.k}")
    parity = rs1d_parity_matrix(rs, messages.device)
    par = _xor_reduce(gf_mul_bytes(messages.unsqueeze(-1), parity), -2)
    return torch.cat([par, messages], dim=-1)


def encode_rs2d_batch(data: torch.Tensor, rs: ReedSolomon2D) -> torch.Tensor:
    """A uint8 message of ``rs.message_len`` bytes -> the
    (col_codeword_len, row_codeword_len) square of ``ReedSolomon2D.encode``,
    on the message's device: the size x size matrix (row-major, zero
    padded), every row encoded, then every column, then transposed."""
    if data.numel() != rs.message_len:
        raise ValueError(f"{data.numel()} bytes, the code takes {rs.message_len}")
    size = rs.size
    m = torch.zeros(size * size, dtype=torch.uint8, device=data.device)
    m[:data.numel()] = data.reshape(-1)
    rows = encode_rs1d_batch(m.reshape(size, size), rs.row_coder)
    cols = encode_rs1d_batch(rows.T.contiguous(), rs.col_coder)
    return cols.T.contiguous()
