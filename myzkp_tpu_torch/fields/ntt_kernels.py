"""NTT kernels K5 (up to log2 r consecutive radix-2 Stockham stages, r =
``k5_radix()``), K5's pair form (one butterfly on elementwise triples, DIF
or DIT) and K6 (a whole NTT of length m <= 128 along one axis), each beside
its plain PyTorch version.

Counterparts of ``butterfly_pallas`` and ``ntt_leaf_pallas`` in
``myzkp_tpu/fields/limb_pallas.py``: the NTT's path runs K5's Stockham passes
(DIF); ``butterfly_pair`` keeps the TPU kernel's own contract in both modes.
The wrappers (``butterfly``, ``butterfly_pair``, ``ntt_leaf``) launch the
CUDA kernel (csrc/ntt.cu; its instance at L = 16 limbs, ``*_l8`` at L = 8
for M128, and for the pair form ``butterfly_pair_l4`` at L = 4 for M64) for
CUDA tensors and run the plain version (``*_ref``, int64 inside) for CPU
tensors.

A stage, as ``ops/ntt.py`` runs it: x (L, R, Bk, 2h, B) splits its third axis
in halves u, v; the output (L, R, 2 Bk, h, B) holds u + v in its first Bk
blocks and (u - v) * tw[j] in the last Bk, with tw an (L, h) Montgomery row.
A pass of s stages takes (L, R, Bk, c, B) to (L, R, 2^s Bk, c / 2^s, B) and
its twiddles as the s stage rows (half-widths c/2, c/4, ..., c / 2^s)
concatenated, (L, c - c / 2^s): K6's table is the pass of all log2 m stages.
"""

from __future__ import annotations

import torch

from .. import _ext
from . import limb
from .spec import FieldSpec

I32 = torch.int32
MAX_LEAF = 128  # csrc/ntt.cu: kMaxLeaf
K5_RADIX = 8  # csrc/ntt.cu: MYZKP_K5_RADIX's default


def k5_radix() -> int:
    """r, the most elements a K5 thread holds: a launch runs 1 to log2 r
    stages.  The -D value of the library in use (``_ext.use_defines``), else
    the source's default; the plain version follows the same value."""
    return _ext.defined("MYZKP_K5_RADIX", K5_RADIX)


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


def _check_stages(c: int, stages: int) -> None:
    if stages < 1 or c % (1 << stages):
        raise ValueError(f"stages = {stages}: a length-{c} block runs 1 to "
                         f"{(c & -c).bit_length() - 1} stages")


def butterfly_ref(spec: FieldSpec, x, tw, stages: int = 1):
    """Plain version of K5: ``stages`` DIF Stockham stages, one after
    another (contract above)."""
    c = x.shape[3]
    _check_stages(c, stages)
    y = x.long()
    off, h = 0, c // 2
    for _ in range(stages):
        y = _stage64(spec, y, tw[:, off:off + h])
        off, h = off + h, h // 2
    return y.int()


def butterfly_pair_ref(spec: FieldSpec, u, v, tw, dit: bool):
    """Plain version of K5's pair form: (u + v, (u - v) tw) (DIF) or
    (u + v tw, u - v tw) (DIT) elementwise."""
    u, v, tw = u.long(), v.long(), tw.long()
    if dit:
        t = limb._mont_mul64(spec, v, tw)
        su, sv = limb._add64(spec, u, t), limb._sub64(spec, u, t)
    else:
        su = limb._add64(spec, u, v)
        sv = limb._mont_mul64(spec, limb._sub64(spec, u, v), tw)
    return su.int(), sv.int()


def _leaf_stages(m: int, stages) -> int:
    log_m = m.bit_length() - 1
    s = log_m if stages is None else stages
    if not 1 <= s <= log_m:
        raise ValueError(f"stages = {stages}: a length-{m} leaf runs 1 to {log_m}")
    return s


def ntt_leaf_ref(spec: FieldSpec, x, tw, stages=None):
    """Plain version of K6: the length-m NTT along axis 2 of x (L, E, m, B),
    natural order in and out; tw (L, m - 1) holds the stage rows of
    half-widths m/2, m/4, ..., 1, concatenated.  ``stages`` (default log2 m)
    runs only the first that many Stockham stages."""
    L, E, m, B = x.shape
    s = _leaf_stages(m, stages)
    y = butterfly_ref(spec, x.reshape(L, E, 1, m, B), tw, s)
    return y.reshape(L, E, m, B)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def butterfly(spec: FieldSpec, x, tw, stages: int = 1):
    """K5: ``stages`` (1 to log2 ``k5_radix()``) DIF Stockham stages in one
    launch.  x (L, R, Bk, c, B) int32 contiguous, tw (L, c - c / 2^stages)
    int32, the stage rows concatenated; returns (L, R, 2^stages Bk,
    c / 2^stages, B)."""
    if not _ext.use_kernel(x, tw):
        return butterfly_ref(spec, x, tw, stages)
    L, R, Bk, c, B = x.shape
    if L != spec.L:
        raise ValueError(f"stage input of shape {tuple(x.shape)}")
    _check_stages(c, stages)
    _ext.require(x, "x", I32)
    _ext.require(tw, "tw", I32, (L, c - (c >> stages)))
    out = torch.empty((L, R, Bk << stages, c >> stages, B), dtype=I32, device=x.device)
    if out.numel():
        _ext.launch(_ext.kernel_name("butterfly", spec), x.device, _ext.ptr(x), _ext.ptr(tw),
                    _ext.ptr(out), R, Bk, c, B, stages, _ext.consts_ptr(spec))
    return out


def butterfly_pair(spec: FieldSpec, u, v, tw, dit: bool):
    """K5's pair form, ``butterfly_pallas``'s contract: one radix-2
    butterfly on elementwise triples of Montgomery limb tensors u, v, tw of
    one shape (L, *batch), int32; returns (su, sv): (u + v, (u - v) tw)
    (DIF) or (u + v tw, u - v tw) (DIT)."""
    if not (u.shape == v.shape == tw.shape and u.dim() >= 1 and u.shape[0] == spec.L):
        raise ValueError(f"butterfly inputs of shapes {tuple(u.shape)}, {tuple(v.shape)}, "
                         f"{tuple(tw.shape)}: one shape (L = {spec.L}, *batch)")
    if not _ext.use_kernel(u, v, tw):
        return butterfly_pair_ref(spec, u, v, tw, dit)
    u, v, tw = u.contiguous(), v.contiguous(), tw.contiguous()
    for t, name in ((u, "u"), (v, "v"), (tw, "tw")):
        _ext.require(t, name, I32)
    su, sv = torch.empty_like(u), torch.empty_like(u)
    n = u.numel() // spec.L
    if n:
        _ext.launch(_ext.kernel_name("butterfly_pair", spec), u.device, _ext.ptr(u),
                    _ext.ptr(v), _ext.ptr(tw), _ext.ptr(su), _ext.ptr(sv), n, int(dit),
                    _ext.consts_ptr(spec))
    return su, sv


def ntt_leaf(spec: FieldSpec, x, tw, stages=None):
    """K6: the length-m NTT (m a power of two, 2 <= m <= 128) along axis 2
    of x (L, E, m, B) int32 contiguous, natural order; tw (L, m - 1), each
    stage row starting with 1 (R mod p): the kernel skips the products by
    it.  ``stages`` as in ntt_leaf_ref."""
    if not _ext.use_kernel(x, tw):
        return ntt_leaf_ref(spec, x, tw, stages)
    L, E, m, B = x.shape
    if L != spec.L or not 2 <= m <= MAX_LEAF or m & (m - 1):
        raise ValueError(f"leaf input of shape {tuple(x.shape)}")
    s = _leaf_stages(m, stages)
    _ext.require(x, "x", I32)
    _ext.require(tw, "tw", I32, (L, m - 1))
    out = torch.empty_like(x)
    if out.numel():
        _ext.launch(_ext.kernel_name("ntt_leaf", spec), x.device, _ext.ptr(x), _ext.ptr(tw),
                    _ext.ptr(out), E, m, s, B, _ext.consts_ptr(spec))
    return out
