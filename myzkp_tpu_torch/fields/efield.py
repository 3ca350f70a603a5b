"""Generic extension fields F_p[x]/(m(x)) on batched limb tensors.

Counterpart of ``myzkp_tpu/fields/efield.py`` (the reference's
``define_extension_field!``): a degree-k extension over any limb
``FieldSpec``, m(x) monic and fixed per ``ExtFieldSpec``.  An element batch is
one int32 tensor of shape ``(k, L, *batch)``: k coefficients, each L 16-bit
limbs in the Montgomery domain, the JAX package's layout and integers.

``mul`` is the schoolbook convolution followed by the reduction of columns
k .. 2k - 2 through the reduction rows x^(k+i) = sum_j R[i][j] x^j.  The
k^2 products of the convolution run as one K1 launch on stacked operands,
and the products of those columns by the rows' nonzero constants as one
more, the constants read in place with a period: two launches a ``mul``
(one at k = 1).  The column sums are plain adds.  ``pow_const`` knows its
exponent on the host: LSB first, a set bit's multiply and the square of
the base run as one ``mul`` on the pair stacked along a batch axis, a zero
bit squares only, and the first set bit takes the base as it is.  So a^e
costs 2 * bit_length(e) launches when bit 0 of e is set:
``inv`` of the M64 cubic (e = p^3 - 2, 192 bits) is 384 K1 launches.
``inv(0) = 0``, as in the JAX package.

BN254's Fq2 has its dedicated Karatsuba path (``curves/field_ops.Fq2Ops``);
``bn254_fq2`` is the same field through this generic machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from . import limb
from .spec import BN254_Q, M64, FieldSpec


class ExtFieldSpec:
    """Static description of F_p[x]/(m(x)), m monic of degree k.

    ``modulus_coeffs``: the k ints (c_0 .. c_{k-1}) of
    m(x) = x^k + c_{k-1} x^{k-1} + ... + c_0.  One instance per (base,
    modulus); its reduction constants are put on each device once."""

    _cache: dict = {}

    def __new__(cls, base: FieldSpec, modulus_coeffs: tuple):
        key = (base, tuple(int(c) % base.p for c in modulus_coeffs))
        inst = cls._cache.get(key)
        if inst is None:
            inst = super().__new__(cls)
            inst._init(*key)
            cls._cache[key] = inst
        return inst

    def _init(self, base: FieldSpec, modulus_coeffs: tuple):
        self.base = base
        self.m = modulus_coeffs
        self.k = len(modulus_coeffs)
        # x^(k+i) = sum_j red_rows[i][j] x^j for i = 0 .. k - 2 (host ints)
        p, k = base.p, self.k
        rows = []
        cur = [(-c) % p for c in modulus_coeffs]  # x^k
        rows.append(tuple(cur))
        for _ in range(k - 2):
            top = cur[-1]
            cur = [0] + cur[:-1]
            cur = [(cur[j] + top * rows[0][j]) % p for j in range(k)]
            rows.append(tuple(cur))
        self.red_rows = tuple(rows)
        # the (i, j) of every nonzero row entry: the reduction's products
        self.red_terms = tuple((i, j) for i, row in enumerate(rows[:k - 1])
                               for j, c in enumerate(row) if c)
        self._red_dev = {}

    def __hash__(self):
        return hash((self.base, self.m))

    def __eq__(self, other):
        return self is other

    def red_consts(self, device) -> torch.Tensor:
        """The constants of ``red_terms`` in the Montgomery domain, as one
        (L, len(red_terms)) limb tensor on ``device`` (made once a device)."""
        device = torch.device(device)
        if device not in self._red_dev:
            vals = [self.base.to_mont_int(self.red_rows[i][j]) for i, j in self.red_terms]
            self._red_dev[device] = limb.from_int(self.base, vals, device).contiguous()
        return self._red_dev[device]


# ---------------------------------------------------------------------------
# Element construction (elements: int32 (k, L, *batch), Montgomery domain)
# ---------------------------------------------------------------------------

def from_int_coeffs(es: ExtFieldSpec, coeff_lists, device=None) -> torch.Tensor:
    """Host ints [[c_0 .. c_{k-1}], ...] -> (k, L, *batch) Montgomery limbs,
    on the card unless ``device`` names another device."""
    moved = np.moveaxis(np.asarray(coeff_lists, dtype=object), -1, 0)  # (k, ...)
    std = limb.from_int(es.base, moved, device)  # (L, k, ...)
    return limb.to_mont(es.base, std).transpose(0, 1).contiguous()


def to_int_coeffs(es: ExtFieldSpec, a: torch.Tensor) -> np.ndarray:
    """(k, L, *batch) -> numpy object array (*batch, k) of Python ints."""
    ints = limb.to_int(es.base, limb.from_mont(es.base, a.transpose(0, 1)))  # (k, ...)
    return np.moveaxis(ints, 0, -1)


def zeros(es: ExtFieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((es.k, es.base.L) + tuple(batch_shape), dtype=limb.I32,
                       device=_ext.resolve_device(device))


def one(es: ExtFieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    out = zeros(es, batch_shape, device)
    out[0] = limb.one_mont(es.base, tuple(batch_shape), out.device)
    return out


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _last(a: torch.Tensor) -> torch.Tensor:
    """(k, L, *batch) -> (L, *batch, k): the coefficient axis last, so that
    batch axes broadcast right-aligned as they do coefficient by
    coefficient."""
    return a.movedim(0, -1)


def _first(t: torch.Tensor) -> torch.Tensor:
    return t.movedim(-1, 0).contiguous()


def add(es: ExtFieldSpec, a, b):
    return _first(limb.add(es.base, _last(a), _last(b)))


def sub(es: ExtFieldSpec, a, b):
    return _first(limb.sub(es.base, _last(a), _last(b)))


def neg(es: ExtFieldSpec, a):
    return _first(limb.neg(es.base, _last(a)))


def mul(es: ExtFieldSpec, a, b):
    """Schoolbook convolution (one K1 launch for its k^2 products) and
    reduction by m(x) (one K1 launch for the products by the reduction
    rows' nonzero constants)."""
    k, bs = es.k, es.base
    shape = torch.broadcast_shapes(tuple(a.shape[2:]), tuple(b.shape[2:]))
    lead = (bs.L,) + tuple(shape) + (k, k)
    ai = _last(a).unsqueeze(-1)  # (L, *batch_a, k, 1): a_i
    bj = _last(b).unsqueeze(-2)  # (L, *batch_b, 1, k): b_j
    ai = ai.reshape((bs.L,) + (1,) * (len(lead) - ai.dim()) + tuple(ai.shape[1:]))
    bj = bj.reshape((bs.L,) + (1,) * (len(lead) - bj.dim()) + tuple(bj.shape[1:]))
    prod = limb.mont_mul(bs, ai.expand(lead), bj.expand(lead))  # (L, *batch, k, k)
    cols = [None] * (2 * k - 1)
    for i in range(k):
        for j in range(k):
            t = prod[..., i, j]
            cols[i + j] = t if cols[i + j] is None else limb.add(bs, cols[i + j], t)
    out = cols[:k]
    if es.red_terms:
        hi = torch.stack([cols[k + i] for i, _ in es.red_terms], dim=-1)
        red = limb.mont_mul(bs, hi, es.red_consts(hi.device))  # (L, *batch, terms)
        for t, (_, j) in enumerate(es.red_terms):
            out[j] = limb.add(bs, out[j], red[..., t])
    return torch.stack(out, dim=0)


def sqr(es: ExtFieldSpec, a):
    return mul(es, a, a)


def eq(es: ExtFieldSpec, a, b):
    return (a == b).flatten(0, 1).all(dim=0)


def is_zero(es: ExtFieldSpec, a):
    return (a == 0).flatten(0, 1).all(dim=0)


def select(mask, a, b):
    return torch.where(mask[None, None], a, b)


def scale(es: ExtFieldSpec, a, s):
    """Multiply by a base-field element batch s (L, *batch): one K1 launch,
    s read in place with a period where it broadcasts along leading axes."""
    return limb.mont_mul(es.base, a.transpose(0, 1), s).transpose(0, 1).contiguous()


def pow_const(es: ExtFieldSpec, a, e: int):
    """a^e for a host exponent e >= 0 (Montgomery in and out); a^0 = 1.
    LSB first: a set bit's product and the square run as one ``mul`` of
    the stacked pair, a zero bit squares only."""
    if e < 0:
        raise ValueError("the exponent must be nonnegative")
    if e == 0:
        return one(es, tuple(a.shape[2:]), a.device)
    acc, base = None, a
    nbits = e.bit_length()
    for i in range(nbits):
        last = i + 1 == nbits
        if not (e >> i) & 1:
            base = sqr(es, base)  # never the last bit: the top bit is set
        elif acc is None:
            acc = base
            if not last:
                base = sqr(es, base)
        elif last:
            acc = mul(es, acc, base)
        else:
            both = mul(es, torch.stack([acc, base], dim=2), torch.stack([base, base], dim=2))
            acc, base = both[:, :, 0], both[:, :, 1]
    return acc.clone() if acc is a else acc.contiguous()


def inv(es: ExtFieldSpec, a):
    """Fermat inverse a^(p^k - 2); inv(0) = 0."""
    return pow_const(es, a, es.base.p ** es.k - 2)


# ---------------------------------------------------------------------------
# Reference instantiations
# ---------------------------------------------------------------------------

def m64_cubic() -> ExtFieldSpec:
    """The Goldilocks cubic extension of the reference's FRI challenges:
    m(x) = x^3 - x + 1, coefficients (1, p - 1, 0)."""
    return ExtFieldSpec(FieldSpec.make(M64), (1, M64 - 1, 0))


def bn254_fq2() -> ExtFieldSpec:
    """Fq2 = Fq[u]/(u^2 + 1) through the generic machinery."""
    return ExtFieldSpec(FieldSpec.make(BN254_Q), (1, 0))
