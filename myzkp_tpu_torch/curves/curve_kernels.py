"""Curve kernels, each beside its plain PyTorch version: G1 K2 (complete
add, optional select), K3 (a chain of complete doublings), K4 (the MSM bucket
scan) and K9 (mixed add, optional select); G2 K7 (complete add over F_q2,
optional select), K8 (a chain of complete doublings), K10 (mixed add,
optional select) and K4's G2 instance (the bucket scan over F_q2); in both
groups one level of the lane merge's segmented scan (``padd_seg_level``,
``padd2_seg_level``) on the complete add's body, and the moves between a
row-major point table and a point's limb planes: K14 (``gather_planes``, rows
by index into planes) and K16 (``scatter_rows``, planes into rows at targets).

Counterparts of ``padd_fused`` / ``padd_sel_fused``, ``pdbl_fused``,
``bucket_scan_rows``, ``padd_mixed_fused`` / ``padd_mixed_sel_fused``,
``padd2_fused`` / ``padd2_sel_fused``, ``pdbl2_fused`` and
``padd_mixed2_fused`` / ``padd_mixed2_sel_fused`` in
``myzkp_tpu/curves/curve_pallas.py``; the G2 scan replaces the reference's
``lax.scan`` of ``padd2_sel_fused`` (``myzkp_tpu/curves/msm.py:215``), and
the levels the rolls, selects and add of one level of its ``_seg_scan_hs``
(``myzkp_tpu/curves/msm.py:335-357``); K14 and K16 replace the probes
``tools/exp_gather_pallas.py:33`` and ``tools/exp_transpose.py:78`` and the
reference's ``jnp.take`` and transposes around its row tables
(``myzkp_tpu/curves/msm.py:190-212``).  The wrappers (``padd``, ``pdbl``,
``bucket_scan_rows``, ``padd_mixed``, ``padd2``, ``pdbl2``, ``padd_mixed2``,
``bucket_scan_rows2``, ``gather_planes``, ``scatter_rows``) launch the CUDA
kernel for CUDA tensors and run the plain version (``*_ref``, int64 inside
for the arithmetic) for CPU tensors.  One formula text each (``_padd64``,
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
from ..utils.metrics import span

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


def _check_chain(n: int) -> None:
    if n < 1:
        raise ValueError(f"a chain of doublings takes n >= 1 steps, not {n}")


def _chain64(ops, b3, p64, n: int, steps: bool, fin):
    """n doublings of p64 with _pdbl64; fin turns an int64 point into the
    output's form.  Returns fin(2^n P), or with steps the coordinates of
    fin(2P), ..., fin(2^n P) stacked on a new leading axis."""
    _check_chain(n)
    out = []
    for _ in range(n):
        p64 = _pdbl64(ops, b3, p64)
        if steps:
            out.append(fin(p64))
    if not steps:
        return fin(p64)
    return _stack_steps(out)


def _stack_steps(pts):
    """Points with the same nesting of coordinate tensors -> one point whose
    tensors stack theirs on a new leading axis."""
    if torch.is_tensor(pts[0]):
        return torch.stack(pts)
    return tuple(_stack_steps(cs) for cs in zip(*pts))


def pdbl_ref(spec: FieldSpec, b3, p, n: int = 1, steps: bool = False):
    """Plain version of K3: 2^n P, n >= 1; with ``steps``, the n points 2P,
    4P, ..., 2^n P, each coordinate (n, L, *batch) with step i at [i]."""
    p64 = tuple(c.long() for c in p)
    return _chain64(_ops64(spec), _b3_like(b3, p64[0]), p64, n, steps,
                    lambda q: tuple(c.int() for c in q))


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


def pdbl2_ref(spec: FieldSpec, b3, p, n: int = 1, steps: bool = False):
    """Plain version of K8: 2^n P over F_q2, n >= 1; with ``steps`` the n
    points as pdbl_ref gives them, coordinates (c0, c1) pairs."""
    p64 = _stack2(p)
    return _chain64(_ops64_fq2(spec), _b3_like2(b3, p64[0]), p64, n, steps, _unstack2)


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


def _seg_shift(flags, d: int):
    """(valid, flags of lane - d): valid = lane >= d along the last axis."""
    valid = torch.arange(flags.shape[-1], device=flags.device) >= d
    return valid, torch.roll(flags, d, dims=-1) & valid


def padd_seg_level_ref(spec: FieldSpec, b3, x, flags, d: int):
    """Plain version of the G1 lane-merge level: the reference's rolls and
    selects around padd_ref.  x: (x, y, z) of (L, *rows, B) int32; flags
    (*rows, B) bool.  Returns (out, flags') with out = x where flags is set,
    else (x at lane - d, or O below lane d) + x, and flags' = flags | (the
    flag at lane - d where lane >= d)."""
    valid, shifted = _seg_shift(flags, d)
    one = limb.one_mont(spec, tuple(flags.shape), flags.device)
    inf = (torch.zeros_like(one), one, torch.zeros_like(one))
    xs = tuple(torch.where(valid, torch.roll(a, d, dims=-1), o) for a, o in zip(x, inf))
    return padd_ref(spec, b3, xs, x, flags), flags | shifted


def padd2_seg_level_ref(spec: FieldSpec, b3, x, flags, d: int):
    """Plain version of the G2 lane-merge level, as padd_seg_level_ref over
    padd2_ref; coordinates are (c0, c1) pairs."""
    valid, shifted = _seg_shift(flags, d)
    one = limb.one_mont(spec, tuple(flags.shape), flags.device)
    zero = torch.zeros_like(one)
    inf = ((zero, zero), (one, zero), (zero, zero))
    xs = tuple(tuple(torch.where(valid, torch.roll(a, d, dims=-1), o) for a, o in zip(e, oe))
               for e, oe in zip(x, inf))
    return padd2_ref(spec, b3, xs, x, flags), flags | shifted


def bucket_scan_rows_ref(spec: FieldSpec, table, idx, tag, tgt, b3, buckets, K: int):
    """Plain version of K4 (G1, b3 one (L,) tensor) and of its G2 instance
    (b3 a (c0, c1) pair): contract in csrc/bucket_scan.cu.  Reads the rows
    ``table.index_select(0, idx)`` (which raises on an index out of range),
    writes the real flushes into ``buckets`` in place and returns acc (C, N)."""
    e = 2 if isinstance(b3, tuple) else 1  # base-field components a coordinate
    L = spec.L
    C = 3 * e * L
    N = idx.shape[0] // K
    rows = table.index_select(0, idx)
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


def gather_planes_ref(table, idx, C: int):
    """Plain version of K14: (C, n) limb planes of rows ``idx`` of ``table``
    (every row where idx is None), planes[j, i] = table[idx[i], j]."""
    rows = table if idx is None else table.index_select(0, idx)
    return rows[:, :C].T.contiguous()


def scatter_rows_ref(leaves, out, tgt=None):
    """Plain version of K16: the (16, n) coordinate tensors ``leaves`` as
    rows of ``out`` (S, W), at rows ``tgt`` (rows 0..n-1 where tgt is None),
    columns C..W-1 zero; returns out, written in place."""
    rows = torch.cat(tuple(leaves), dim=0).T
    rows = torch.nn.functional.pad(rows, (0, out.shape[1] - rows.shape[1]))
    if tgt is None:
        out[:rows.shape[0]] = rows
    else:
        out[tgt] = rows
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require_group_law(spec: FieldSpec, b3s, pts, h=None) -> tuple:
    """Check the inputs of a group-law kernel: pts, one tuple of flat
    coordinate tensors per input point, all of one shape (L, *batch); b3s,
    b3's tensors (one for G1, c0 and c1 for G2); the optional mask h.
    Returns the shape."""
    shape = tuple(pts[0][0].shape)
    for name, pt in zip("pq", pts):
        for i, c in enumerate(pt):
            _ext.require(c, f"{name}[{i}]", I32, shape)
    for i, c in enumerate(b3s):
        _ext.require(c, f"b3[{i}]", I32, (spec.L,))
    if h is not None:
        _ext.require(h, "h", torch.bool, shape[1:])
    return shape


def _launch_group_law(kernel: str, spec: FieldSpec, b3s, pts, h=None) -> tuple:
    """Check the inputs of K2, K7, K9 or K10 and launch it.  pts: one tuple
    of flat coordinate tensors per input point (3 for G1, 6 for G2, and 2 or
    4 for a mixed add's affine Q; two points for an add, which also passes
    the optional mask h); b3s as _require_group_law.  Returns the flat output
    coordinates, as many as the first point's."""
    _require_group_law(spec, b3s, pts, h)
    out = tuple(torch.empty_like(pts[0][0]) for _ in pts[0])
    n = pts[0][0].numel() // spec.L
    if n:
        P = _ext.ptr
        mask = (P(h),) if len(pts) == 2 else ()
        _ext.launch(kernel, pts[0][0].device, *(P(c) for pt in pts for c in pt),
                    *mask, *map(P, b3s), *map(P, out), n, _ext.consts_ptr(spec))
    return out


def _launch_chain(kernel: str, spec: FieldSpec, b3s, p, n: int, steps: bool) -> tuple:
    """Check the inputs of K3 or K8 and launch n doublings of the flat
    coordinates p (3 for G1, 6 for G2).  Returns the flat coordinates of
    2^n P, or with ``steps`` the flat (n, L, *batch) steps output, which the
    kernel writes instead."""
    _check_chain(n)
    shape = _require_group_law(spec, b3s, (p,))
    if steps:
        out = tuple(torch.empty((n,) + shape, dtype=I32, device=c.device) for c in p)
        dst = (None,) * len(p) + out
    else:
        out = tuple(torch.empty_like(c) for c in p)
        dst = out + (None,) * len(p)
    points = p[0].numel() // spec.L
    if points:
        P = _ext.ptr
        _ext.launch(kernel, p[0].device, *map(P, p), *map(P, b3s), *map(P, dst), points, n,
                    _ext.consts_ptr(spec))
    return out


def padd(spec: FieldSpec, b3, p, q, h=None):
    """K2: complete add P + Q; with ``h``, Q where h is set and P + Q
    elsewhere.  Coordinates (L, *batch) int32; b3 (L,); h (*batch,) bool."""
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*p, *q, b3, *extra):
        return padd_ref(spec, b3, p, q, h)
    return _launch_group_law("padd", spec, (b3,), (tuple(p), tuple(q)), h)


def pdbl(spec: FieldSpec, b3, p, n: int = 1, steps: bool = False):
    """K3: n >= 1 complete doublings, 2^n P, in one launch.  Coordinates
    (L, *batch) int32; b3 (L,).  With ``steps``, the n points 2P, 4P, ...,
    2^n P: each coordinate (n, L, *batch), step i a contiguous block at [i]."""
    if not _ext.use_kernel(*p, b3):
        return pdbl_ref(spec, b3, p, n, steps)
    return _launch_chain("pdbl", spec, (b3,), tuple(p), n, steps)


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


def pdbl2(spec: FieldSpec, b3, p, n: int = 1, steps: bool = False):
    """K8: n >= 1 complete doublings over F_q2, 2^n P, in one launch; with
    ``steps`` the n points as pdbl gives them.  Coordinates as padd2."""
    pl = _leaves2(p)
    if not _ext.use_kernel(*pl, *b3):
        return pdbl2_ref(spec, b3, p, n, steps)
    return _pairs(_launch_chain("pdbl2", spec, tuple(b3), pl, n, steps))


def padd_mixed2(spec: FieldSpec, b3, p, qx, qy, h=None):
    """K10: mixed add P + (qx, qy, 1) over F_q2; with ``h``, (qx, qy, 1)
    where h is set and the sum elsewhere.  Coordinates as padd2; qx, qy
    (c0, c1) pairs.  Q must not be infinity."""
    pl, ql = _leaves2(p), (*qx, *qy)
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*pl, *ql, *b3, *extra):
        return padd_mixed2_ref(spec, b3, p, qx, qy, h)
    return _pairs(_launch_group_law("padd_mixed2", spec, b3, (pl, ql), h))


def _launch_seg_level(kernel: str, spec: FieldSpec, b3s, x, flags, d: int):
    """Check the inputs of a lane-merge level and launch it; x: the flat
    coordinate tensors (3 for G1, 6 for G2), each (L, *rows, B).  Returns
    (the flat output coordinates, flags')."""
    shape = tuple(x[0].shape)
    if len(shape) < 2 or d < 1:
        raise ValueError(f"a level takes (L, *rows, B) coordinates and d >= 1, not "
                         f"{shape} and d = {d}")
    for i, c in enumerate(x):
        _ext.require(c, f"x[{i}]", I32, shape)
    for i, c in enumerate(b3s):
        _ext.require(c, f"b3[{i}]", I32, (spec.L,))
    _ext.require(flags, "flags", torch.bool, shape[1:])
    out = tuple(torch.empty_like(c) for c in x)
    oflags = torch.empty_like(flags)
    if flags.numel():
        P = _ext.ptr
        _ext.launch(kernel, flags.device, *map(P, x), P(flags), *map(P, b3s), *map(P, out),
                    P(oflags), flags.numel(), shape[-1], d, _ext.consts_ptr(spec))
    return out, oflags


def padd_seg_level(spec: FieldSpec, b3, x, flags, d: int):
    """One level of the G1 lane merge's segmented Hillis-Steele scan in one
    launch, on K2's body: out = x where flags is set, else (x at lane - d, or
    O below lane d) + x along the last axis; flags' = flags | (the flag at
    lane - d where lane >= d).  x: (x, y, z) of (L, *rows, B) int32; b3 (L,);
    flags (*rows, B) bool; d >= 1.  Returns (out, flags'), new tensors."""
    if not _ext.use_kernel(*x, flags, b3):
        return padd_seg_level_ref(spec, b3, x, flags, d)
    return _launch_seg_level("padd_seg_level", spec, (b3,), tuple(x), flags, d)


def padd2_seg_level(spec: FieldSpec, b3, x, flags, d: int):
    """padd_seg_level over G2, on K7's body: coordinates are (c0, c1) pairs of
    (L, *rows, B) int32 tensors, b3 a pair of (L,)."""
    xl = _leaves2(x)
    if not _ext.use_kernel(*xl, flags, *b3):
        return padd2_seg_level_ref(spec, b3, x, flags, d)
    out, oflags = _launch_seg_level("padd2_seg_level", spec, tuple(b3), xl, flags, d)
    return _pairs(out), oflags


def _scan(kernel: str, spec: FieldSpec, table, idx, tag, tgt, b3s, buckets, K: int):
    """Check the inputs of K4 or its G2 instance and launch it; b3s: b3's
    tensors (one for G1, c0 and c1 for G2).  Returns acc."""
    total = idx.shape[0]
    if K < 1 or total % K:
        raise ValueError(f"{total} steps do not split into K = {K}")
    C = 3 * len(b3s) * spec.L
    W = -(-C // 64) * 64
    _ext.require(table, "table", I32, (table.shape[0], W))
    _ext.require(idx, "idx", I32, (total,))
    _ext.require(tag, "tag", I32, (total,))
    _ext.require(tgt, "tgt", I32, (total,))
    _ext.require(buckets, "buckets", I32, (buckets.shape[0], W))
    for i, b in enumerate(b3s):
        _ext.require(b, f"b3[{i}]", I32, (spec.L,))
    if table.data_ptr() % 16 or buckets.data_ptr() % 16:
        raise ValueError("table and buckets must be 16-byte aligned")
    N = total // K
    acc = torch.empty((C, N), dtype=I32, device=table.device)
    if N:
        P = _ext.ptr
        _ext.launch(kernel, table.device, P(table), P(idx), P(tag), P(tgt), *map(P, b3s),
                    P(acc), P(buckets), N, K, _ext.consts_ptr(spec))
    return acc


@span("scan")
def bucket_scan_rows(spec: FieldSpec, table, idx, tag, tgt, b3, buckets, K: int):
    """K4: the G1 segmented bucket scan over the point table read by index in
    step-major order, flushes written into the bucket table in place
    (contract in csrc/bucket_scan.cu).

    table (Nt, 64) int32, idx, tag and tgt (K * N,) int32 (indices may
    repeat and must lie below Nt: the kernel does not check), b3 (L,),
    buckets (S, 64) int32.  Returns acc (48, N); any N >= 1 is accepted."""
    if not _ext.use_kernel(table, idx, tag, tgt, b3, buckets):
        return bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, buckets, K)
    return _scan("bucket_scan_rows", spec, table, idx, tag, tgt, (b3,), buckets, K)


@span("scan")
def bucket_scan_rows2(spec: FieldSpec, table, idx, tag, tgt, b3, buckets, K: int):
    """K4's G2 instance: table (Nt, 128) int32, b3 a (c0, c1) pair of (L,),
    buckets (S, 128) int32, the rest as bucket_scan_rows.  Returns acc
    (96, N)."""
    if not _ext.use_kernel(table, idx, tag, tgt, *b3, buckets):
        return bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, buckets, K)
    return _scan("bucket_scan_rows2", spec, table, idx, tag, tgt, tuple(b3), buckets, K)


# Used limbs of a point row: 3 coordinates of 16 limbs (G1) or 6 (G2).
_ROW_LIMBS = (48, 96)


def _require_rows(table, name: str, C: int) -> int:
    """Check a row table that K14 or K16 takes; returns its width W."""
    if C not in _ROW_LIMBS:
        raise ValueError(f"C = {C}: a point row uses 48 (G1) or 96 (G2) limbs")
    if table.dim() != 2 or table.shape[1] < C or table.shape[1] % 4:
        raise ValueError(f"{name}: shape {tuple(table.shape)}, expected (rows, W) with "
                         f"W >= {C} a multiple of 4")
    _ext.require(table, name, I32)
    if table.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return table.shape[1]


def _index_arg(t, name: str, n: int) -> tuple:
    """(pointer, bytes an entry) of an optional index tensor of n entries,
    int32 or int64; (null, 0) for None."""
    if t is None:
        return _ext.ptr(None), 0
    if t.dtype not in (I32, torch.int64):
        raise TypeError(f"{name}: dtype {t.dtype}, expected int32 or int64")
    _ext.require(t, name, t.dtype, (n,))
    return _ext.ptr(t), t.element_size()


def gather_planes(table, idx, C: int):
    """K14: the (C, n) int32 limb planes of rows ``idx`` of the point table
    (Nt, W), planes[j, i] = table[idx[i], j], in one launch; every row
    (n = Nt) where idx is None.  idx: (n,) int32 or int64; indices may
    repeat and must lie below Nt (the kernel does not check).  C = 48 (G1)
    or 96 (G2)."""
    extra = () if idx is None else (idx,)
    if not _ext.use_kernel(table, *extra):
        return gather_planes_ref(table, idx, C)
    W = _require_rows(table, "table", C)
    n = table.shape[0] if idx is None else idx.numel()
    idx_p, idx_bytes = _index_arg(idx, "idx", n)
    planes = torch.empty((C, n), dtype=I32, device=table.device)
    if n:
        _ext.launch("gather_planes", table.device, _ext.ptr(table), idx_p, idx_bytes,
                    _ext.ptr(planes), n, W, C)
    return planes


def scatter_rows(leaves, out, tgt=None):
    """K16: the (16, n) int32 coordinate tensors ``leaves`` (3 for G1, 6 for
    G2, read in place) as rows of the table ``out`` (S, W), in one launch:
    row tgt[i] gets point i's C used limbs and zeros in columns C..W-1;
    rows 0..n-1 where tgt is None.  tgt: (n,) int32 or int64 below S (the
    kernel does not check); a row that two points target ends up with
    16-byte pieces of either, in no set order.  Returns out, written in
    place."""
    leaves = tuple(leaves)
    extra = () if tgt is None else (tgt,)
    if not _ext.use_kernel(*leaves, out, *extra):
        return scatter_rows_ref(leaves, out, tgt)
    C = 16 * len(leaves)
    W = _require_rows(out, "out", C)
    n = leaves[0].shape[-1]
    for i, c in enumerate(leaves):
        _ext.require(c, f"leaves[{i}]", I32, (16, n))
    if tgt is None and n > out.shape[0]:
        raise ValueError(f"{n} points do not fit a table of {out.shape[0]} rows")
    tgt_p, tgt_bytes = _index_arg(tgt, "tgt", n)
    if n:
        ptrs = [_ext.ptr(c) for c in leaves] + [_ext.ptr(None)] * (6 - len(leaves))
        _ext.launch("scatter_rows", out.device, *ptrs, tgt_p, tgt_bytes, _ext.ptr(out),
                    n, W, C)
    return out
