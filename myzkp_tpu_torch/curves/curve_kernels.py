"""Curve kernels, each beside its plain PyTorch version: G1 K2 (complete
add, optional select), K3 (complete double), K4 (the MSM bucket scan) and K9
(mixed add, optional select); G2 K7 (complete add over F_q2, optional
select), K8 (complete double), K10 (mixed add, optional select) and K4's G2
instance (the bucket scan over F_q2).

Counterparts of ``padd_fused`` / ``padd_sel_fused``, ``pdbl_fused``,
``bucket_scan_rows``, ``padd_mixed_fused`` / ``padd_mixed_sel_fused``,
``padd2_fused`` / ``padd2_sel_fused``, ``pdbl2_fused`` and
``padd_mixed2_fused`` / ``padd_mixed2_sel_fused`` in
``myzkp_tpu/curves/curve_pallas.py``; the G2 scan replaces the reference's
``lax.scan`` of ``padd2_sel_fused`` (``myzkp_tpu/curves/msm.py:215``).  The
wrappers (``padd``, ``pdbl``, ``bucket_scan_rows``, ``padd_mixed``,
``padd2``, ``pdbl2``, ``padd_mixed2``, ``bucket_scan_rows2``)
launch the CUDA kernel for CUDA tensors and run the plain version (``*_ref``,
int64 inside) for CPU tensors.  One formula text each (``_padd64``,
``_padd_mixed64``, ``_pdbl64``) serves both groups through an ops triple, and
replays ``weierstrass.py``'s formulas step for step, so the kernels agree with
it limb for limb.  A G2 coordinate is a ``(c0, c1)`` pair of limb tensors; its
b3 is the pair 3 * B2.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..fields import limb
from ..fields.spec import FieldSpec

I32 = torch.int32

# ---------------------------------------------------------------------------
# Plain versions (int64)
# ---------------------------------------------------------------------------

def _ops64(spec: FieldSpec):
    """(add, sub, mul) over F_q on int64 limbs."""
    return (lambda a, b: limb._add64(spec, a, b),
            lambda a, b: limb._sub64(spec, a, b),
            lambda a, b: limb._mont_mul64(spec, a, b))


def _ops64_fq2(spec: FieldSpec):
    """(add, sub, mul) over F_q2 on int64 limbs stacked as (L, 2, *batch),
    c0 and c1 along axis 1, so that an add or sub is one base call.  Karatsuba
    mul: the three base products a0 b0, a1 b1, (a0 + a1)(b0 + b1) in one
    Montgomery product call."""
    add, sub, mul = _ops64(spec)

    def mul2(a, b):
        # s = (a0 + a1, b0 + b1); t = (a0 b0, a1 b1, s0 s1);
        # (c0, c1) = (t0 - t1, t2 - (t0 + t1))
        s = add(torch.stack([a[:, 0], b[:, 0]], 1), torch.stack([a[:, 1], b[:, 1]], 1))
        t = mul(torch.cat([a, s[:, :1]], 1), torch.cat([b, s[:, 1:]], 1))
        return sub(torch.stack([t[:, 0], t[:, 2]], 1),
                   torch.stack([t[:, 1], add(t[:, 0], t[:, 1])], 1))

    return add, sub, mul2


def _b3_like(b3: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return b3.long().reshape((-1,) + (1,) * (a.dim() - 1)).expand_as(a)


# Operands up to this many int64 elements share one plain call in _each;
# wider ones (the card's bitchecks at millions of lanes) take one call each,
# which keeps the int64 temporaries of the plain product at one operand's size.
_EACH_MAX = 1 << 21


def _each(f, *pairs):
    """f over independent operand pairs, in one call with the pairs stacked
    on a new last axis where they are small: at small batches a plain call
    costs about the same whatever its width, so the formulas below take their
    independent products and sums together."""
    if pairs[0][0].numel() > _EACH_MAX:
        return tuple(f(a, b) for a, b in pairs)
    return f(torch.stack([a for a, _ in pairs], -1),
             torch.stack([b for _, b in pairs], -1)).unbind(-1)


def _padd64(ops, b3, p, q):
    """Complete addition, a = 0 (RCB16 Algorithm 7), with ops = (add, sub,
    mul) of _ops64 or _ops64_fq2: weierstrass.py's formula (padd :60-83),
    each round of independent products or sums in one call."""
    add, sub, mul = ops
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    sxy1, sxy2, syz1, syz2, sxz1, sxz2 = _each(
        add, (X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
    t0, t1, t2, t3, t4, X3 = _each(
        mul, (X1, X2), (Y1, Y2), (Z1, Z2), (sxy1, sxy2), (syz1, syz2), (sxz1, sxz2))
    u01, u12, u02, X3d = _each(add, (t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, Y3 = _each(sub, (t3, u01), (t4, u12), (X3, u02))
    t0 = add(X3d, t0)
    t2, Y3 = _each(mul, (b3, t2), (b3, Y3))
    Z3, t1 = add(t1, t2), sub(t1, t2)
    a, b, c, d, e, f = _each(
        mul, (t4, Y3), (t3, t1), (Y3, t0), (t1, Z3), (t0, t3), (Z3, t4))
    Y3, Z3 = _each(add, (d, c), (f, e))
    return sub(b, a), Y3, Z3


def _padd_mixed64(ops, b3, p, qx, qy):
    """Mixed addition P + (qx, qy, 1), a = 0 (RCB16 Algorithm 8), with ops as
    _padd64: weierstrass.py's formula (padd_mixed :113-132), t2 = Z1 for
    free, 13 products.  Q must not be infinity."""
    add, sub, mul = ops
    X1, Y1, Z1 = p
    sxy1, sq = _each(add, (X1, Y1), (qx, qy))
    t0, t1, t3, zqy, zqx, t2 = _each(
        mul, (X1, qx), (Y1, qy), (sxy1, sq), (Z1, qy), (Z1, qx), (b3, Z1))
    u01, t4, Y3, X3d, Z3 = _each(
        add, (t0, t1), (zqy, Y1), (zqx, X1), (t0, t0), (t1, t2))
    t3, t1 = _each(sub, (t3, u01), (t1, t2))
    t0 = add(X3d, t0)
    Y3 = mul(b3, Y3)
    a, b, c, d, e, f = _each(
        mul, (t4, Y3), (t3, t1), (Y3, t0), (t1, Z3), (t0, t3), (Z3, t4))
    Y3, Z3 = _each(add, (d, c), (f, e))
    return sub(b, a), Y3, Z3


def _pdbl64(ops, b3, p):
    """Complete doubling, a = 0 (RCB16 Algorithm 9), with ops as _padd64:
    weierstrass.py's formula (pdbl :154-173), each round of independent
    products or sums in one call."""
    add, sub, mul = ops
    X, Y, Z = p
    t0, t1, t2, xy = _each(mul, (Y, Y), (Y, Z), (Z, Z), (X, Y))
    Z3 = add(t0, t0)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    t2 = mul(b3, t2)
    Y3, t2d = _each(add, (t0, t2), (t2, t2))
    t0 = sub(t0, add(t2d, t2))
    X3, Z3, Y3, X3b = _each(mul, (t2, Z3), (t1, Z3), (t0, Y3), (t0, xy))
    Y3, X3 = _each(add, (X3, Y3), (X3b, X3b))
    return X3, Y3, Z3


def padd_ref(spec: FieldSpec, b3, p, q, h=None):
    """Plain version of K2: P + Q, or Q where ``h`` is set."""
    p64 = tuple(c.long() for c in p)
    q64 = tuple(c.long() for c in q)
    r = _padd64(_ops64(spec), _b3_like(b3, p64[0]), p64, q64)
    if h is not None:
        r = tuple(limb.select(h, qi, ri) for qi, ri in zip(q64, r))
    return tuple(c.int() for c in r)


def pdbl_ref(spec: FieldSpec, b3, p):
    """Plain version of K3: 2P."""
    p64 = tuple(c.long() for c in p)
    return tuple(c.int() for c in _pdbl64(_ops64(spec), _b3_like(b3, p64[0]), p64))


def padd_mixed_ref(spec: FieldSpec, b3, p, qx, qy, h=None):
    """Plain version of K9: P + (qx, qy, 1), or (qx, qy, 1) where ``h`` is
    set."""
    p64 = tuple(c.long() for c in p)
    q64 = (qx.long(), qy.long())
    r = _padd_mixed64(_ops64(spec), _b3_like(b3, p64[0]), p64, *q64)
    if h is not None:
        one = limb.one_mont(spec, tuple(qx.shape[1:]), qx.device).long()
        r = tuple(limb.select(h, qi, ri) for qi, ri in zip((*q64, one), r))
    return tuple(c.int() for c in r)


def _stack2(pt) -> tuple:
    """((x0, x1), (y0, y1), (z0, z1)) -> three (L, 2, *batch) int64 tensors."""
    return tuple(torch.stack(e, 1).long() for e in pt)


def _unstack2(pt) -> tuple:
    return tuple(tuple(e.int().unbind(1)) for e in pt)


def _b3_like2(b3, a: torch.Tensor) -> torch.Tensor:
    return torch.stack(b3, 1).long().reshape(
        a.shape[:2] + (1,) * (a.dim() - 2)).expand_as(a)


def padd2_ref(spec: FieldSpec, b3, p, q, h=None):
    """Plain version of K7: P + Q over F_q2, or Q where ``h`` is set."""
    p64, q64 = _stack2(p), _stack2(q)
    r = _padd64(_ops64_fq2(spec), _b3_like2(b3, p64[0]), p64, q64)
    if h is not None:
        r = tuple(limb.select(h, qe, re) for qe, re in zip(q64, r))
    return _unstack2(r)


def pdbl2_ref(spec: FieldSpec, b3, p):
    """Plain version of K8: 2P over F_q2."""
    p64 = _stack2(p)
    return _unstack2(_pdbl64(_ops64_fq2(spec), _b3_like2(b3, p64[0]), p64))


def padd_mixed2_ref(spec: FieldSpec, b3, p, qx, qy, h=None):
    """Plain version of K10: P + (qx, qy, 1) over F_q2, or (qx, qy, 1) where
    ``h`` is set; the one is (R mod q, 0)."""
    p64, q64 = _stack2(p), _stack2((qx, qy))
    r = _padd_mixed64(_ops64_fq2(spec), _b3_like2(b3, p64[0]), p64, *q64)
    if h is not None:
        one = limb.one_mont(spec, tuple(qx[0].shape[1:]), qx[0].device)
        one = torch.stack([one, torch.zeros_like(one)], 1).long()
        r = tuple(limb.select(h, qe, re) for qe, re in zip((*q64, one), r))
    return _unstack2(r)


def bucket_scan_rows_ref(spec: FieldSpec, rows, tag, tgt, b3, buckets, K: int):
    """Plain version of K4 (G1, b3 one (L,) tensor) and of its G2 instance
    (b3 a (c0, c1) pair): contract in csrc/bucket_scan.cu.  Writes the real
    flushes into ``buckets`` in place and returns acc (C, N)."""
    e = 2 if isinstance(b3, tuple) else 1  # base-field components a coordinate
    L = spec.L
    C = 3 * e * L
    N = rows.shape[0] // K
    r = rows.reshape(K, N, -1)
    t, g = tag.reshape(K, N), tgt.reshape(K, N)
    ops = _ops64_fq2(spec) if e == 2 else _ops64(spec)
    # coordinates as (L, e, N) int64, component j of a G2 coordinate at [:, j]
    zero = torch.zeros((L, e, N), dtype=torch.int64, device=rows.device)
    one = zero.clone()
    one[:, 0] = limb.one_mont(spec, (N,), rows.device)
    acc = (zero, one, zero)
    b3e = (torch.stack(b3, 1) if e == 2 else b3[:, None]).long()[..., None].expand_as(zero)

    def planes(pt):  # (L, e, N) coordinates -> (C, N), rows' limb order
        return torch.cat([a.transpose(0, 1).reshape(e * L, N) for a in pt])

    for k in range(K):
        q = [r[k, :, i * e * L:(i + 1) * e * L].reshape(N, e, L).permute(2, 1, 0).long()
             for i in range(3)]
        q[1] = torch.where((t[k] & 1) > 0, limb._sub64(spec, torch.zeros_like(q[1]), q[1]),
                           q[1])
        real = g[k] >= 0
        buckets[g[k][real], :C] = planes(acc)[:, real].T.int()
        s = _padd64(ops, b3e, acc, q)
        head = (t[k] & 2) > 0
        acc = tuple(torch.where(head, qi, si) for qi, si in zip(q, s))
    return planes(acc).int()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _launch_group_law(kernel: str, spec: FieldSpec, b3s, pts, h=None) -> tuple:
    """Check the inputs of K2, K3, K7, K8, K9 or K10 and launch it.  pts: one
    tuple of flat coordinate tensors per input point (3 for G1, 6 for G2, and
    2 or 4 for a mixed add's affine Q; two points for an add, which also
    passes the optional mask h); b3s: b3's tensors (one for G1, c0 and c1 for
    G2).  Returns the flat output coordinates, as many as the first point's."""
    shape = tuple(pts[0][0].shape)
    for name, pt in zip("pq", pts):
        for i, c in enumerate(pt):
            _ext.require(c, f"{name}[{i}]", I32, shape)
    for i, c in enumerate(b3s):
        _ext.require(c, f"b3[{i}]", I32, (spec.L,))
    if h is not None:
        _ext.require(h, "h", torch.bool, shape[1:])
    out = tuple(torch.empty_like(pts[0][0]) for _ in pts[0])
    n = pts[0][0].numel() // spec.L
    if n:
        P = _ext.ptr
        mask = (P(h),) if len(pts) == 2 else ()
        _ext.launch(kernel, pts[0][0].device, *(P(c) for pt in pts for c in pt),
                    *mask, *map(P, b3s), *map(P, out), n, _ext.consts_ptr(spec))
    return out


def padd(spec: FieldSpec, b3, p, q, h=None):
    """K2: complete add P + Q; with ``h``, Q where h is set and P + Q
    elsewhere.  Coordinates (L, *batch) int32; b3 (L,); h (*batch,) bool."""
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*p, *q, b3, *extra):
        return padd_ref(spec, b3, p, q, h)
    return _launch_group_law("padd", spec, (b3,), (tuple(p), tuple(q)), h)


def pdbl(spec: FieldSpec, b3, p):
    """K3: complete double 2P.  Coordinates (L, *batch) int32; b3 (L,)."""
    if not _ext.use_kernel(*p, b3):
        return pdbl_ref(spec, b3, p)
    return _launch_group_law("pdbl", spec, (b3,), (tuple(p),))


def padd_mixed(spec: FieldSpec, b3, p, qx, qy, h=None):
    """K9: mixed add P + (qx, qy, 1); with ``h``, (qx, qy, 1) where h is set
    and the sum elsewhere.  Coordinates (L, *batch) int32; b3 (L,); h
    (*batch,) bool.  Q must not be infinity."""
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*p, qx, qy, b3, *extra):
        return padd_mixed_ref(spec, b3, p, qx, qy, h)
    return _launch_group_law("padd_mixed", spec, (b3,), (tuple(p), (qx, qy)), h)


def _leaves2(pt) -> tuple:
    """((x0, x1), (y0, y1), (z0, z1)) -> the six coordinate tensors."""
    return tuple(c for e in pt for c in e)


def _pairs(flat) -> tuple:
    """Inverse of _leaves2."""
    return tuple(flat[i:i + 2] for i in (0, 2, 4))


def padd2(spec: FieldSpec, b3, p, q, h=None):
    """K7: complete add P + Q over F_q2; with ``h``, Q where h is set and
    P + Q elsewhere.  Coordinates are (c0, c1) pairs of (L, *batch) int32
    tensors; b3 a pair of (L,); h (*batch,) bool."""
    pl, ql = _leaves2(p), _leaves2(q)
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*pl, *ql, *b3, *extra):
        return padd2_ref(spec, b3, p, q, h)
    return _pairs(_launch_group_law("padd2", spec, b3, (pl, ql), h))


def pdbl2(spec: FieldSpec, b3, p):
    """K8: complete double 2P over F_q2.  Coordinates as padd2."""
    pl = _leaves2(p)
    if not _ext.use_kernel(*pl, *b3):
        return pdbl2_ref(spec, b3, p)
    return _pairs(_launch_group_law("pdbl2", spec, b3, (pl,)))


def padd_mixed2(spec: FieldSpec, b3, p, qx, qy, h=None):
    """K10: mixed add P + (qx, qy, 1) over F_q2; with ``h``, (qx, qy, 1)
    where h is set and the sum elsewhere.  Coordinates as padd2; qx, qy
    (c0, c1) pairs.  Q must not be infinity."""
    pl, ql = _leaves2(p), (*qx, *qy)
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*pl, *ql, *b3, *extra):
        return padd_mixed2_ref(spec, b3, p, qx, qy, h)
    return _pairs(_launch_group_law("padd_mixed2", spec, b3, (pl, ql), h))


def _scan(kernel: str, spec: FieldSpec, rows, tag, tgt, b3s, buckets, K: int):
    """Check the inputs of K4 or its G2 instance and launch it; b3s: b3's
    tensors (one for G1, c0 and c1 for G2).  Returns acc."""
    total = rows.shape[0]
    if K < 1 or total % K:
        raise ValueError(f"{total} rows do not split into K = {K} steps")
    C = 3 * len(b3s) * spec.L
    W = -(-C // 64) * 64
    _ext.require(rows, "rows", I32, (total, W))
    _ext.require(tag, "tag", I32, (total,))
    _ext.require(tgt, "tgt", I32, (total,))
    _ext.require(buckets, "buckets", I32, (buckets.shape[0], W))
    for i, b in enumerate(b3s):
        _ext.require(b, f"b3[{i}]", I32, (spec.L,))
    if rows.data_ptr() % 16 or buckets.data_ptr() % 16:
        raise ValueError("rows and buckets must be 16-byte aligned")
    N = total // K
    acc = torch.empty((C, N), dtype=I32, device=rows.device)
    if N:
        P = _ext.ptr
        _ext.launch(kernel, rows.device, P(rows), P(tag), P(tgt), *map(P, b3s),
                    P(acc), P(buckets), N, K, _ext.consts_ptr(spec))
    return acc


def bucket_scan_rows(spec: FieldSpec, rows, tag, tgt, b3, buckets, K: int):
    """K4: the G1 segmented bucket scan over step-major point rows, flushes
    written into the bucket table in place (contract in csrc/bucket_scan.cu).

    rows (K * N, 64) int32, tag and tgt (K * N,) int32, b3 (L,), buckets
    (S, 64) int32.  Returns acc (48, N); any N >= 1 is accepted."""
    if not _ext.use_kernel(rows, tag, tgt, b3, buckets):
        return bucket_scan_rows_ref(spec, rows, tag, tgt, b3, buckets, K)
    return _scan("bucket_scan_rows", spec, rows, tag, tgt, (b3,), buckets, K)


def bucket_scan_rows2(spec: FieldSpec, rows, tag, tgt, b3, buckets, K: int):
    """K4's G2 instance: rows (K * N, 128) int32, b3 a (c0, c1) pair of (L,),
    buckets (S, 128) int32, the rest as bucket_scan_rows.  Returns acc
    (96, N)."""
    if not _ext.use_kernel(rows, tag, tgt, *b3, buckets):
        return bucket_scan_rows_ref(spec, rows, tag, tgt, b3, buckets, K)
    return _scan("bucket_scan_rows2", spec, rows, tag, tgt, tuple(b3), buckets, K)
