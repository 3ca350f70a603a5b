"""Number-theoretic transform over limb tensors: the radix-2 Stockham NTT, its
four-step recursion, the coset transforms and the product of polynomials
(``fast_multiply``).

Counterpart of ``myzkp_tpu/ops/ntt.py:36-483`` with the same decomposition:
below ``_FOURSTEP_MIN_N`` points one Stockham pass of log2(n) stages, one
launch of kernel K5 each; from there up a recursive four-step split n = m1 * m2
whose length-m1 (<= ``_LEAF_M``) transforms are single launches of kernel K6,
with one twiddle product (K1) and one transpose per level.  Stockham
autosorts, so results are in natural order without a bit-reversal gather.
The values are exact whatever the split; the reference's split keeps the
launch counts comparable.

Twiddle tables are built once per (spec, size, direction, device) and cached:
the Stockham stage rows on the host, the four-step level tables (L, m1, m2) on
the device by one Montgomery product of two small host tables.  Coset offsets
[1, c, c^2, ...] are built on the device by log-doubling.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _ext
from ..fields import limb, ntt_kernels
from ..fields.fp import Fp
from ..fields.spec import FieldSpec

_FOURSTEP_MIN_N = 1 << 14  # from here up: four-step recursion over K6 leaves
_LEAF_M = 128  # longest leaf: one K6 launch


# ---------------------------------------------------------------------------
# Roots of unity (host)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def two_adicity(p: int) -> int:
    return ((p - 1) & -(p - 1)).bit_length() - 1


@functools.lru_cache(maxsize=None)
def max_root_of_unity(p: int) -> int:
    """A primitive 2^k-th root of unity for the largest k (host int)."""
    k = two_adicity(p)
    odd = (p - 1) >> k
    for g in range(2, 1000):
        r = pow(g, odd, p)
        if pow(r, 1 << (k - 1), p) != 1:
            return r
    raise ValueError(f"no generator found for {p}")


@functools.lru_cache(maxsize=None)
def nth_root_of_unity(p: int, n: int) -> int:
    """Primitive n-th root of unity, n a power of two."""
    if n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    k = n.bit_length() - 1
    adic = two_adicity(p)
    if k > adic:
        raise ValueError(f"field 2-adicity {adic} < log2(n) = {k}")
    return pow(max_root_of_unity(p), 1 << (adic - k), p)


def _root(spec: FieldSpec, n: int, inverse: bool) -> int:
    w = nth_root_of_unity(spec.p, n)
    return pow(w, -1, spec.p) if inverse else w


# ---------------------------------------------------------------------------
# Twiddle tables
# ---------------------------------------------------------------------------

def _mont_np(spec: FieldSpec, values) -> np.ndarray:
    """Host ints -> (L, n) int32 Montgomery limbs."""
    nb = 2 * spec.L
    buf = b"".join(spec.to_mont_int(v).to_bytes(nb, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, spec.L).T.astype(np.int32)


def _powers(w: int, n: int, p: int) -> list:
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * w % p
    return out


@functools.lru_cache(maxsize=None)
def _twiddle_table(spec: FieldSpec, n: int, inverse: bool) -> np.ndarray:
    """(L, max(1, n/2)) Montgomery table [1, w, ..., w^(n/2 - 1)]."""
    return _mont_np(spec, _powers(_root(spec, n, inverse), max(1, n // 2), spec.p))


@functools.lru_cache(maxsize=None)
def _stage_twiddle(spec: FieldSpec, m: int, s: int, inverse: bool) -> np.ndarray:
    """Stage-s Stockham twiddles (L, h): [w_c^0 .. w_c^(h-1)], c = m >> s."""
    h = m >> (s + 1)
    return np.ascontiguousarray(_twiddle_table(spec, m, inverse)[:, ::1 << s][:, :h])


@functools.lru_cache(maxsize=None)
def _stage_twiddle_dev(spec: FieldSpec, m: int, s: int, inverse: bool,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_stage_twiddle(spec, m, s, inverse)).to(device)


@functools.lru_cache(maxsize=None)
def _leaf_twiddles(spec: FieldSpec, m: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """K6's table (L, m - 1): the stage rows of a length-m transform."""
    rows = [_stage_twiddle(spec, m, s, inverse) for s in range(m.bit_length() - 1)]
    return torch.from_numpy(np.concatenate(rows, axis=1)).to(device)


def _outer_twiddle_np(spec: FieldSpec, w: int, n1: int, cols: int) -> np.ndarray:
    """(L, n1, cols) Montgomery table with entry [k1, j] = w^(k1 * j)."""
    p = spec.p
    vals = [v for k1 in range(n1) for v in _powers(pow(w, k1, p), cols, p)]
    return _mont_np(spec, vals).reshape(spec.L, n1, cols)


def _fourstep_split(m: int) -> tuple[int, int]:
    m1 = min(_LEAF_M, 1 << (m.bit_length() // 2))
    return m1, m // m1


def _fourstep_splits(m: int) -> list[tuple[int, int, int]]:
    """(m, m1, m2) of every level of the recursion for length m, top first."""
    out = []
    while m > _LEAF_M:
        m1, m2 = _fourstep_split(m)
        out.append((m, m1, m2))
        m = m2
    return out


@functools.lru_cache(maxsize=None)
def fourstep_tables(spec: FieldSpec, n: int, inverse: bool,
                    device: torch.device) -> tuple:
    """Device twiddle tables (L, m1, m2), entry [k1, i2] = w_m^(k1 * i2), one
    per recursion level of an n-point transform.  Each is one Montgomery
    product of two host tables: w^(k1 * i2) = w^(k1 * a) * (w^A)^(k1 * b)
    with i2 = a + A * b."""
    tabs = []
    for m, m1, m2 in _fourstep_splits(n):
        w = _root(spec, m, inverse)
        A = 1 << -(-(m2.bit_length() - 1) // 2)
        Bc = m2 // A
        wa = torch.from_numpy(_outer_twiddle_np(spec, w, m1, A)).to(device)
        wb = torch.from_numpy(_outer_twiddle_np(spec, pow(w, A, spec.p), m1, Bc)
                              ).to(device)
        full = limb.mont_mul(spec, wa[:, :, None, :].expand(-1, -1, Bc, -1),
                             wb[:, :, :, None].expand(-1, -1, -1, A))
        tabs.append(full.reshape(spec.L, m1, m2))
    return tuple(tabs)


# ---------------------------------------------------------------------------
# Core transforms (limb tensors; the transform axis is -2, batch B last)
# ---------------------------------------------------------------------------

def _stockham_axis(spec: FieldSpec, x, m: int, inverse: bool):
    """Natural-order NTT over axis -2 of x (L, *lead, m, B): log2(m) DIF
    Stockham stages, one K5 launch each."""
    if m == 1:
        return x
    shape = x.shape
    R = math.prod(shape[1:-2])
    y = x.reshape(spec.L, R, 1, m, shape[-1]).contiguous()
    for s in range(m.bit_length() - 1):
        y = ntt_kernels.butterfly(
            spec, y, _stage_twiddle_dev(spec, m, s, inverse, x.device))
    return y.reshape(shape)


def _ntt_core_small(spec: FieldSpec, a, inverse: bool):
    n = a.shape[-1]
    return _stockham_axis(spec, a.unsqueeze(-1), n, inverse).squeeze(-1)


def _leaf_ntt(spec: FieldSpec, x, inverse: bool):
    """Length-m (m <= _LEAF_M) NTT over axis -2 of (L, *lead, m, B): one K6
    launch."""
    shape = x.shape
    m = shape[-2]
    if m == 1:
        return x
    x4 = x.reshape((spec.L, -1) + tuple(shape[-2:])).contiguous()
    tw = _leaf_twiddles(spec, m, inverse, x.device)
    return ntt_kernels.ntt_leaf(spec, x4, tw).reshape(shape)


def _ntt_axis(spec: FieldSpec, x, inverse: bool, tables=()):
    """Natural-order NTT over axis -2 of (L, *lead, m, B), recursive four-step.

    m = m1 * m2: transform the length-m1 axis (a free reshape merges (m2, B)
    into its batch), multiply by the level's table w_m^(k1 * i2), transpose
    once to (m2, m1, B), transform the m2 axis; (k2, k1) flattens row-major
    to the natural index k = k2 * m1 + k1.  ``tables`` are
    fourstep_tables(...), consumed top-down."""
    m = x.shape[-2]
    if m <= _LEAF_M:
        return _leaf_ntt(spec, x, inverse)
    lead, B = tuple(x.shape[:-2]), x.shape[-1]
    m1, m2 = _fourstep_split(m)
    x = _leaf_ntt(spec, x.reshape(lead + (m1, m2 * B)), inverse)
    x = x.reshape(lead + (m1, m2, B))
    tab = tables[0].reshape((spec.L,) + (1,) * (len(lead) - 1) + (m1, m2, 1))
    x = limb.mont_mul(spec, x, tab)
    x = x.transpose(-3, -2).contiguous()  # (lead, m2, m1, B): the one copy
    x = _ntt_axis(spec, x.reshape(lead + (m2, m1 * B)), inverse, tables[1:])
    return x.reshape(lead + (m, B))


def _ntt_natural(spec: FieldSpec, a, inverse: bool):
    """Natural-order NTT over the last axis of a (L, ..., n) limb tensor."""
    n = a.shape[-1]
    if n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    if n == 1:
        return a
    if n < _FOURSTEP_MIN_N:
        return _ntt_core_small(spec, a, inverse)
    tables = fourstep_tables(spec, n, inverse, a.device)
    return _ntt_axis(spec, a.unsqueeze(-1), inverse, tables).squeeze(-1)


def _scale_by_n_inv(spec: FieldSpec, a):
    n = a.shape[-1]
    c = limb.const(spec, spec.to_mont_int(pow(n, -1, spec.p)), (1,) * (a.dim() - 1),
                   a.device)
    return limb.mont_mul(spec, a, c)


# ---------------------------------------------------------------------------
# Public API over Fp (the coefficient axis is the last batch axis)
# ---------------------------------------------------------------------------

def ntt(a: Fp) -> Fp:
    """Forward NTT, natural order in and out: evaluations at w^i."""
    return Fp(a.spec, _ntt_natural(a.spec, a.mont, False))


def intt(a: Fp) -> Fp:
    """Inverse NTT, natural order in and out."""
    out = _ntt_natural(a.spec, a.mont, True)
    return Fp(a.spec, _scale_by_n_inv(a.spec, out))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def fast_multiply(a: Fp, b: Fp, out_len: int | None = None) -> Fp:
    """Polynomial product by the NTT: a (..., na) and b (..., nb) low-first,
    zero-padded to the next power of two past na + nb - 1, transformed, multiplied
    pointwise and transformed back.  Returns na + nb - 1 coefficients, or
    ``out_len`` (cut or zero-padded)."""
    spec = a.spec
    full = a.shape[-1] + b.shape[-1] - 1
    n = _next_pow2(full)
    fa = _ntt_natural(spec, a.pad_to(n).mont, False)
    fb = _ntt_natural(spec, b.pad_to(n).mont, False)
    out = _scale_by_n_inv(spec, _ntt_natural(spec, limb.mont_mul(spec, fa, fb), True))
    res = Fp(spec, out[..., :full])
    if out_len is not None:
        res = res.pad_to(out_len) if out_len >= full else res[..., :out_len]
    return res


def _geometric_mont(spec: FieldSpec, c: int, n: int, device) -> torch.Tensor:
    """[1, c, c^2, ..., c^(n-1)] as Montgomery limbs (L, n), by log-doubling
    on the device: g_2k = [g_k, g_k * c^k]."""
    c %= spec.p
    g = limb.one_mont(spec, (1,), device)
    k = 1
    while k < n:
        step = limb.const(spec, spec.to_mont_int(pow(c, k, spec.p)), (1,), device)
        g = torch.cat([g, limb.mont_mul(spec, g, step)], dim=-1)
        k *= 2
    return g[:, :n]


def geometric_series(spec: FieldSpec, c: int, n: int, device=None) -> Fp:
    return Fp(spec, _geometric_mont(spec, c, n, _ext.resolve_device(device)))


def coset_evaluate(a: Fp, offset: int, n: int) -> Fp:
    """Evaluations of the polynomial a on the coset offset * <w_n>."""
    spec = a.spec
    a = a.pad_to(n)
    offs = _geometric_mont(spec, offset, n, a.device)
    return ntt(Fp(spec, limb.mont_mul(spec, a.mont, offs)))


def coset_interpolate(evals: Fp, offset: int) -> Fp:
    """Inverse of coset_evaluate: coefficients from coset evaluations."""
    spec = evals.spec
    n = evals.shape[-1]
    coeffs = intt(evals)
    offs = _geometric_mont(spec, pow(offset, -1, spec.p), n, evals.device)
    return Fp(spec, limb.mont_mul(spec, coeffs.mont, offs))
