"""Batched 16-bit-limb prime-field arithmetic in PyTorch.

Layout: an element batch is an ``int32`` tensor of shape ``(L, *batch)`` holding
little-endian 16-bit limbs, the same integers as the uint32 arrays of
``myzkp_tpu/fields/limb.py``.  Every function returns canonical values (< p),
so results agree with the reference limb for limb.

The plain versions compute in int64: PyTorch on the CPU lacks uint32 ``+``,
``-``, ``>>`` and ``>``, and int64 leaves room for whole 32-bit limb products
in a column, so the Montgomery product needs no lo/hi split.

``mont_mul`` is kernel K1 (csrc/mont_mul.cu) for CUDA tensors and
``mont_mul_ref`` for CPU tensors (the rule of ``_ext.use_kernel``);
``pow_const`` (and so ``inv`` and ``batch_inv``'s inversion) is K1's chain
``mont_pow``, one launch, for CUDA tensors and ``mont_pow_ref`` for CPU ones.
Both kernels come at L = 16 limbs (BN254), L = 8 (M128: ``mont_mul_l8``,
``mont_pow_l8``) and L = 4 (M64: ``mont_mul_l4``, ``mont_pow_l4``), picked by
``_ext.kernel_name``; a CUDA tensor of any other field raises.  The plain
versions hold at every L: at L = 4 the Montgomery sum T < 2p passes R = 2^64
(M64 > R / 2), and ``_carry`` returns that bit as the carry-out that
``_cond_sub_p`` takes.
Add, sub and the rest were plain array code in the reference too and stay
plain here.
The constructors (``from_int``, ``const``, ``zeros``, ``one_mont``) make their
tensors on the card unless the caller names a device (``_ext.resolve_device``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _ext
from .spec import MASK, W, FieldSpec

I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------

def from_int(spec: FieldSpec, x, device=None) -> torch.Tensor:
    """Python int / nested list of ints -> limb tensor (standard domain)."""
    xs = np.asarray(x, dtype=object)
    flat = xs.reshape(-1)
    nb = 2 * spec.L
    p = spec.p
    buf = b"".join((int(v) % p).to_bytes(nb, "little") for v in flat.tolist())
    out = np.frombuffer(buf, dtype="<u2").reshape(flat.size, spec.L).T
    out = torch.from_numpy(out.astype(np.int32)).reshape((spec.L,) + xs.shape)
    return out.to(_ext.resolve_device(device))


def to_int(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Limb tensor (standard domain) -> numpy object array of Python ints."""
    arr = a.detach().cpu().numpy().reshape(spec.L, -1)
    raw = np.ascontiguousarray(arr.T.astype("<u2")).tobytes()
    w = 2 * spec.L
    out = np.empty(arr.shape[1], dtype=object)
    for k in range(arr.shape[1]):
        out[k] = int.from_bytes(raw[k * w:(k + 1) * w], "little") % spec.p
    return out.reshape(tuple(a.shape[1:]))


def to_bytes_batch(spec: FieldSpec, a: torch.Tensor) -> list:
    """Canonical standard-domain limbs (L, n) -> n little-endian byte
    strings of 2L bytes (Merkle leaves)."""
    arr = a.detach().cpu().numpy().reshape(spec.L, -1)
    raw = np.ascontiguousarray(arr.T.astype("<u2")).tobytes()
    w = 2 * spec.L
    return [raw[i:i + w] for i in range(0, len(raw), w)]


def from_bytes(spec: FieldSpec, bs: list, device=None) -> torch.Tensor:
    """Inverse of ``to_bytes_batch``: n strings of 2L little-endian bytes ->
    (L, n) limbs on ``device`` (the card unless the caller names one)."""
    arr = np.frombuffer(b"".join(bs), dtype="<u2").reshape(len(bs), spec.L)
    out = torch.from_numpy(np.ascontiguousarray(arr.T).astype(np.int32))
    return out.to(_ext.resolve_device(device))


def _limb_column(limbs, ndim: int, device, dtype=I32) -> torch.Tensor:
    col = torch.tensor(limbs, dtype=dtype, device=_ext.resolve_device(device))
    return col.reshape((len(limbs),) + (1,) * ndim)


def const(spec: FieldSpec, x: int, batch_shape=(), device=None) -> torch.Tensor:
    """Broadcast a host constant (standard domain) to a limb tensor."""
    col = _limb_column(spec.to_limbs(x), len(batch_shape), device)
    return col.expand((spec.L,) + tuple(batch_shape))


def zeros(spec: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((spec.L,) + tuple(batch_shape), dtype=I32,
                       device=_ext.resolve_device(device))


def one_mont(spec: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    col = _limb_column(spec.one_limbs, len(batch_shape), device)
    return col.expand((spec.L,) + tuple(batch_shape))


def _broadcast_pair(L: int, a: torch.Tensor, b: torch.Tensor):
    """Right-aligned batch broadcast of two (L, *batch) limb tensors."""
    bshape = torch.broadcast_shapes(tuple(a.shape[1:]), tuple(b.shape[1:]))

    def bc(x):
        bx = tuple(x.shape[1:])
        x = x.reshape((L,) + (1,) * (len(bshape) - len(bx)) + bx)
        return x.expand((L,) + tuple(bshape))

    return bc(a), bc(b)


# ---------------------------------------------------------------------------
# int64 carry machinery (plain versions)
# ---------------------------------------------------------------------------

# The plain versions' constant columns, made once per shape and device: at
# the small batches of the tests, making them anew was a tenth of a product.

@functools.lru_cache(maxsize=None)
def _shifts(L: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(L, device=device).reshape((L,) + (1,) * ndim)


@functools.lru_cache(maxsize=None)
def _p64(spec: FieldSpec, ndim: int, device) -> torch.Tensor:
    return _limb_column(spec.p_limbs, ndim, device, I64)


@functools.lru_cache(maxsize=None)
def _neg_p64(spec: FieldSpec, ndim: int, device) -> torch.Tensor:
    return _complement(_p64(spec, ndim, device))


def _limb_shifts(t: torch.Tensor) -> torch.Tensor:
    return _shifts(t.shape[0], t.dim() - 1, t.device)


def _resolve(s: torch.Tensor):
    """Carry-resolve limbs s_0 < 2^17, s_i <= 2^17 - 2 (i > 0): returns
    (limbs < 2^16, carry-out).

    Carries are then 0 or 1, so the carry into every limb comes from one
    binary addition over per-element bit masks (bit i of G: limb i generates
    a carry; bit i of X: it generates or propagates one) instead of a limb
    by limb loop."""
    sh = _limb_shifts(s)
    g = s >> W
    r = s & MASK
    G = (g << sh).sum(0)
    X = G | ((r == MASK).long() << sh).sum(0)
    C = (X + G) ^ X ^ G  # bit i: carry into limb i
    return (r + ((C.unsqueeze(0) >> sh) & 1)) & MASK, C >> s.shape[0]


def _carry(t: torch.Tensor):
    """Propagate carries of lazy nonnegative limbs below 2^40; returns
    (limbs, carry-out).  Three folding passes bring every limb below 2^17."""
    top = torch.zeros_like(t[0])
    for _ in range(3):
        hi = t >> W
        t = t & MASK
        t[1:] += hi[:-1]
        top = top + hi[-1]
    out, c = _resolve(t)
    return out, top + c


def _complement(b: torch.Tensor) -> torch.Tensor:
    """2^(16L) - b as limbs, unresolved: (MASK - b_i), plus 1 in limb 0."""
    nb = MASK - b
    nb[0] += 1
    return nb


def _cond_sub_p(spec: FieldSpec, a: torch.Tensor, top=None) -> torch.Tensor:
    """a - p where a >= p or top > 0, else a (canonical limbs, a < 2p)."""
    d, no_borrow = _resolve(a + _neg_p64(spec, a.dim() - 1, a.device))
    need = no_borrow > 0
    if top is not None:
        need = need | (top > 0)
    return torch.where(need, d, a)


def _add64(spec: FieldSpec, a, b):
    t, c = _resolve(a + b)
    return _cond_sub_p(spec, t, top=c)


def _sub64(spec: FieldSpec, a, b):
    d, no_borrow = _resolve(a + _complement(b))
    plus, _ = _resolve(d + _p64(spec, a.dim() - 1, a.device))
    return torch.where(no_borrow > 0, d, plus)


def _mont_mul64(spec: FieldSpec, a, b):
    """Column-lazy Montgomery product on int64 limbs (same shapes)."""
    L = spec.L
    t = torch.zeros((2 * L,) + tuple(a.shape[1:]), dtype=I64, device=a.device)
    for i in range(L):  # columns < L * 2^32 + carries: far below 2^63
        t[i:i + L].addcmul_(a[i], b)
    p = _p64(spec, a.dim() - 1, a.device)
    for i in range(L):
        # column i < 2^38 (2L products below 2^32, plus carries), so
        # t[i] * n0 < 2^54 needs no masking first
        m = (t[i] * spec.n0) & MASK
        t[i:i + L].addcmul_(m, p)
        # column i is now 0 mod 2^16; fold its carry upward
        t[i + 1] += t[i] >> W
    res, c = _carry(t[L:])
    return _cond_sub_p(spec, res, top=c)


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a, b):
    a, b = _broadcast_pair(spec.L, a, b)
    return _add64(spec, a.long(), b.long()).int()


def sub(spec: FieldSpec, a, b):
    a, b = _broadcast_pair(spec.L, a, b)
    return _sub64(spec, a.long(), b.long()).int()


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def reduce_below_p(spec: FieldSpec, a):
    """a mod p for canonical limbs a < R = 2^(16L), by one conditional
    subtraction of p per whole multiple of p below R."""
    t = a.long()
    for _ in range(((1 << (W * spec.L)) - 1) // spec.p):
        t = _cond_sub_p(spec, t)
    return t.int()


def is_zero(spec: FieldSpec, a):
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a, b):
    """Equality of canonical elements: equal limbs."""
    return (a == b).all(dim=0)


def select(mask, a, b):
    """where(mask, a, b) with mask over the batch dims."""
    return torch.where(mask.unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Montgomery multiplication: kernel K1 and its plain version
# ---------------------------------------------------------------------------

def mont_mul_ref(spec: FieldSpec, a, b):
    """Plain version of K1: a * b * R^-1 mod p, computed in int64."""
    a, b = _broadcast_pair(spec.L, a, b)
    return _mont_mul64(spec, a.long(), b.long()).int()


def mont_mul_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Launch K1 (csrc/mont_mul.cu, the instance of spec's width) on
    contiguous CUDA tensors: a (L, *batch)
    and b holding nb elements, nb dividing a's n; element i of a is
    multiplied by element i mod nb of b (b of a's shape: nb = n)."""
    _ext.require(a, "a", I32)
    _ext.require(b, "b", I32)
    if a.shape[0] != spec.L or b.shape[0] != spec.L:
        raise ValueError(f"limb axes {a.shape[0]}, {b.shape[0]}, expected {spec.L}")
    n, nb = a.numel() // spec.L, b.numel() // spec.L
    if n and (nb < 1 or n % nb):
        raise ValueError(f"b's {nb} elements do not divide a's {n}")
    out = torch.empty_like(a)
    if n:
        _ext.launch(_ext.kernel_name("mont_mul", spec), a.device, _ext.ptr(a), _ext.ptr(b),
                    _ext.ptr(out), n, nb, _ext.consts_ptr(spec))
    return out


def _leading_period(b: torch.Tensor, shape: tuple):
    """The period nb at which b (L, *bs) repeats when broadcast to batch
    ``shape``, if it is broadcast along leading batch axes only (bs, padded
    with 1s on the left, is 1 on a prefix of the axes and equal to ``shape``
    on the rest); else None."""
    bs = (1,) * (len(shape) - b.dim() + 1) + tuple(b.shape[1:])
    k = len(shape)
    while k and bs[k - 1] == shape[k - 1]:
        k -= 1
    return math.prod(shape[k:]) if all(d == 1 for d in bs[:k]) else None


def mont_mul(spec: FieldSpec, a, b):
    """(a * b * R^-1) mod p for canonical Montgomery-domain inputs < p.

    On the card an operand broadcast along leading batch axes only is read
    in place with a period (K1's nb); any other broadcast is copied out to
    the full shape first."""
    if not _ext.use_kernel(a, b):
        return mont_mul_ref(spec, a, b)
    shape = tuple(torch.broadcast_shapes(tuple(a.shape[1:]), tuple(b.shape[1:])))
    if tuple(a.shape[1:]) != shape:
        a, b = b, a  # the product commutes; put the full-shape operand first
    nb = _leading_period(b, shape) if tuple(a.shape[1:]) == shape else None
    if nb is None:
        a, b = _broadcast_pair(spec.L, a, b)
        return mont_mul_cuda(spec, a.contiguous(), b.contiguous())
    return mont_mul_cuda(spec, a.contiguous(), b.reshape(spec.L, nb).contiguous())


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a):
    r2 = _limb_column(spec.r2_limbs, a.dim() - 1, a.device)
    return mont_mul(spec, a, r2)


def from_mont(spec: FieldSpec, a):
    one = _limb_column((1,) + (0,) * (spec.L - 1), a.dim() - 1, a.device)
    return mont_mul(spec, a, one)


# ---------------------------------------------------------------------------
# Exponentiation / inversion (Montgomery domain)
# ---------------------------------------------------------------------------

def mont_pow_ref(spec: FieldSpec, a, e: int):
    """Plain version of K1's chain: a^e (Montgomery in and out), LSB-first
    square-and-multiply over mont_mul_ref; e is known on the host, so zero
    bits skip their multiply instead of selecting it away."""
    acc = one_mont(spec, tuple(a.shape[1:]), a.device)
    base = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = mont_mul_ref(spec, acc, base)
        if i + 1 < e.bit_length():
            base = mont_mul_ref(spec, base, base)
    return acc.contiguous()


def mont_pow_cuda(spec: FieldSpec, a: torch.Tensor, e: int):
    """Launch K1's chain (csrc/mont_mul.cu: mont_pow) on a contiguous CUDA
    tensor (L, *batch): a^e elementwise in one launch."""
    _ext.require(a, "a", I32)
    if a.shape[0] != spec.L:
        raise ValueError(f"limb axis {a.shape[0]}, expected {spec.L}")
    ex = _ext.exponent(e)
    out = torch.empty_like(a)
    n = a.numel() // spec.L
    if n:
        _ext.launch(_ext.kernel_name("mont_pow", spec), a.device, _ext.ptr(a), _ext.ptr(out), n,
                    ctypes.c_void_p(ctypes.addressof(ex)), _ext.consts_ptr(spec))
    return out


def pow_const(spec: FieldSpec, a, e: int):
    """a^e for a host exponent 0 <= e < 2^256 (Montgomery in and out);
    a^0 = 1.  One launch of K1's chain on the card."""
    _ext.exponent_words(e)  # the range check, on both devices
    if not _ext.use_kernel(a):
        return mont_pow_ref(spec, a, e)
    return mont_pow_cuda(spec, a.contiguous(), e)


def inv(spec: FieldSpec, a):
    """Fermat inverse a^(p-2); inv(0) = 0."""
    return pow_const(spec, a, spec.p - 2)


def pow_dyn(spec: FieldSpec, a, e_bits):
    """a^e elementwise for exponents given as bits (Montgomery in and out):
    ``e_bits`` (nbits, *batch) of 0 / 1, LSB first, broadcast against a's
    batch.  LSB-first square-and-multiply: each bit takes one product acc *
    base, kept where the bit is set by a select, and one squaring of the base
    (two K1 launches on the card).  No bits give 1."""
    acc = one_mont(spec, tuple(a.shape[1:]), a.device)
    base = a
    for bit in e_bits:
        acc = select(bit > 0, mont_mul(spec, acc, base), acc)
        base = mont_sqr(spec, base)
    return acc.contiguous()


def _prefix_mul(spec: FieldSpec, x, dim: int):
    """Inclusive prefix product along a batch dim (Hillis-Steele, log2 n
    full-width products)."""
    n = x.shape[dim]
    d = 1
    while d < n:
        ones = one_mont(spec, tuple(x.shape[1:]), x.device).narrow(dim, 0, d)
        shifted = torch.cat([ones, x.narrow(dim, 0, n - d)], dim=dim)
        x = mont_mul(spec, x, shifted)
        d *= 2
    return x


def batch_inv(spec: FieldSpec, a, axis: int = -1):
    """Montgomery-trick batch inversion along a batch axis (limb axis is 0):
    inv(a[i]) = prefix[i-1] * suffix[i+1] * inv(total).  Zeros map to zero.
    The prefix and suffix scans run side by side, one product a level."""
    dim = axis if axis >= 0 else a.dim() + axis
    if dim < 1:
        raise ValueError("axis must be a batch axis (the limb axis is 0)")
    n = a.shape[dim]
    bshape = tuple(a.shape[1:])
    zmask = is_zero(spec, a)
    one_full = one_mont(spec, bshape, a.device)
    safe = select(zmask, one_full, a)
    scans = _prefix_mul(spec, torch.stack([safe, safe.flip(dim)], 1), dim + 1)
    prefix, suffix = scans[:, 0], scans[:, 1].flip(dim)
    total_inv = inv(spec, prefix.narrow(dim, n - 1, 1))
    one1 = one_full.narrow(dim, 0, 1)
    left = torch.cat([one1, prefix.narrow(dim, 0, n - 1)], dim=dim)
    right = torch.cat([suffix.narrow(dim, 1, n - 1), one1], dim=dim)
    out = mont_mul(spec, mont_mul(spec, left, right), total_inv)
    return select(zmask, zeros(spec, bshape, a.device), out)


# ---------------------------------------------------------------------------
# Segment sums (sparse matrix products)
# ---------------------------------------------------------------------------

def segment_sum_mod(spec: FieldSpec, vals, seg_ids, num_segments: int):
    """Field sum of the columns of ``vals`` (L, nnz) by segment: (L, nseg).

    Whole 16-bit limbs are summed in int64 with ``index_add_`` (exact in any
    order of the device's atomics; fewer than 2^24 entries keep every limb
    sum below the 2^40 that ``_carry`` takes), carried to canonical limbs s plus a carry-out c, and reduced:
    s + c * R = s * (R mod p) * R^-1 + c * R^2 * R^-1 (mod p), two Montgomery
    products of operands that Montgomery reduction takes as they are
    (s < R and c < 2^32 against constants < p).  Linear, so it serves
    Montgomery- and standard-domain inputs alike."""
    L = spec.L
    dev = vals.device
    if L < 2:
        raise ValueError("segment_sum_mod needs at least two limbs for its carry")
    if vals.shape[1] >= 1 << 24:
        raise ValueError(f"{vals.shape[1]} entries: limb sums could pass 2^40")
    sums = torch.zeros((L, num_segments), dtype=I64, device=dev)
    sums.index_add_(1, seg_ids.long(), vals.long())
    canon, carry = _carry(sums)
    c = torch.zeros_like(canon)
    c[0] = carry & MASK
    c[1] = carry >> W
    r_mod_p = _limb_column(spec.one_limbs, 1, dev)
    r2 = _limb_column(spec.r2_limbs, 1, dev)
    return add(spec, mont_mul(spec, canon.int(), r_mod_p),
               mont_mul(spec, c.int(), r2))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def random(spec: FieldSpec, gen: torch.Generator, batch_shape=(), device=None):
    """Near-uniform elements (standard domain), as the reference samples
    them: 2L random 16-bit limbs x = lo + hi * R in [0, R^2) give lo + hi * R
    mod p (lo and hi reduced below p by conditional subtractions, hi * R by
    to_mont).  The limbs are drawn from ``gen`` on its device; the result
    goes to ``device`` (the card unless the caller names one)."""
    shape = (2 * spec.L,) + tuple(batch_shape)
    wide = torch.randint(0, 1 << W, shape, generator=gen, device=gen.device,
                         dtype=I32).to(_ext.resolve_device(device))
    lo, hi = reduce_below_p(spec, wide[:spec.L]), reduce_below_p(spec, wide[spec.L:])
    return add(spec, lo, to_mont(spec, hi))
