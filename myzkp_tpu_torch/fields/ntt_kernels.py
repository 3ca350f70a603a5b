"""NTT kernels K5 (one radix-2 Stockham stage) and K6 (a whole NTT of length
m <= 128 along one axis), each beside its plain PyTorch version.

Counterparts of ``butterfly_pallas`` (DIF) and ``ntt_leaf_pallas`` in
``myzkp_tpu/fields/limb_pallas.py``.  The wrappers (``butterfly``,
``ntt_leaf``) launch the CUDA kernel (csrc/ntt.cu) for CUDA tensors and run
the plain version (``*_ref``, int64 inside) for CPU tensors.

A stage, as ``ops/ntt.py`` runs it: x (L, R, Bk, 2h, B) splits its third axis
in halves u, v; the output (L, R, 2 Bk, h, B) holds u + v in its first Bk
blocks and (u - v) * tw[j] in the last Bk, with tw an (L, h) Montgomery row.
"""

from __future__ import annotations

import torch

from .. import _ext
from . import limb
from .spec import FieldSpec

I32 = torch.int32
MAX_LEAF = 128  # csrc/ntt.cu: kMaxLeaf


# ---------------------------------------------------------------------------
# Plain versions (int64)
# ---------------------------------------------------------------------------

def _stage64(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    h = x.shape[3] // 2
    u, v = x[:, :, :, :h], x[:, :, :, h:]
    w = tw.long().reshape(spec.L, 1, 1, h, 1).expand_as(u)
    su = limb._add64(spec, u, v)
    sv = limb._mont_mul64(spec, limb._sub64(spec, u, v), w)
    return torch.cat([su, sv], dim=2)


def butterfly_ref(spec: FieldSpec, x, tw):
    """Plain version of K5: one DIF Stockham stage (contract above)."""
    return _stage64(spec, x.long(), tw).int()


def ntt_leaf_ref(spec: FieldSpec, x, tw):
    """Plain version of K6: the length-m NTT along axis 2 of x (L, E, m, B),
    natural order in and out; tw (L, m - 1) holds the stage rows of
    half-widths m/2, m/4, ..., 1, concatenated."""
    L, E, m, B = x.shape
    y = x.long().reshape(L, E, 1, m, B)
    off, h = 0, m // 2
    while h >= 1:
        y = _stage64(spec, y, tw[:, off:off + h])
        off, h = off + h, h // 2
    return y.reshape(L, E, m, B).int()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def butterfly(spec: FieldSpec, x, tw):
    """K5: one DIF Stockham stage.  x (L, R, Bk, 2h, B) int32 contiguous,
    tw (L, h) int32; returns (L, R, 2 Bk, h, B)."""
    if not _ext.use_kernel(x, tw):
        return butterfly_ref(spec, x, tw)
    L, R, Bk, c, B = x.shape
    h = c // 2
    if L != spec.L or c != 2 * h:
        raise ValueError(f"stage input of shape {tuple(x.shape)}")
    _ext.require(x, "x", I32)
    _ext.require(tw, "tw", I32, (L, h))
    out = torch.empty((L, R, 2 * Bk, h, B), dtype=I32, device=x.device)
    if out.numel():
        _ext.launch("butterfly", x.device, _ext.ptr(x), _ext.ptr(tw),
                    _ext.ptr(out), R, Bk, h, B, _ext.consts_ptr(spec))
    return out


def ntt_leaf(spec: FieldSpec, x, tw):
    """K6: the length-m NTT (m a power of two, 2 <= m <= 128) along axis 2
    of x (L, E, m, B) int32 contiguous, natural order; tw (L, m - 1)."""
    if not _ext.use_kernel(x, tw):
        return ntt_leaf_ref(spec, x, tw)
    L, E, m, B = x.shape
    if L != spec.L or not 2 <= m <= MAX_LEAF or m & (m - 1):
        raise ValueError(f"leaf input of shape {tuple(x.shape)}")
    _ext.require(x, "x", I32)
    _ext.require(tw, "tw", I32, (L, m - 1))
    out = torch.empty_like(x)
    if out.numel():
        _ext.launch("ntt_leaf", x.device, _ext.ptr(x), _ext.ptr(tw),
                    _ext.ptr(out), E, m, B, _ext.consts_ptr(spec))
    return out
