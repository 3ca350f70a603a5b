"""Curve kernels, each beside its plain PyTorch version: G1 K2 (complete
add, optional select), K3 (complete double) and K4 (the MSM bucket scan);
G2 K7 (complete add over F_q2, optional select) and K8 (complete double).

Counterparts of ``padd_fused`` / ``padd_sel_fused``, ``pdbl_fused``,
``bucket_scan_rows``, ``padd2_fused`` / ``padd2_sel_fused`` and
``pdbl2_fused`` in ``myzkp_tpu/curves/curve_pallas.py``.  The wrappers
(``padd``, ``pdbl``, ``bucket_scan_rows``, ``padd2``, ``pdbl2``) launch the
CUDA kernel for CUDA tensors and run the plain version (``*_ref``, int64
inside) for CPU tensors.  One formula text (``_padd64``, ``_pdbl64``) serves
both groups through an ops triple, and replays ``weierstrass.py``'s formulas
step for step, so the kernels agree with it limb for limb.  A G2 coordinate is
a ``(c0, c1)`` pair of limb tensors; its b3 is the pair 3 * B2.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..fields import limb
from ..fields.spec import FieldSpec

I32 = torch.int32

ROW_LANES = 64  # int32 per G1 point row: x | y | z limbs, padded to 64


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


def _padd64(ops, b3, p, q):
    """Complete addition, a = 0 (RCB16 Algorithm 7), with ops = (add, sub,
    mul) of _ops64 or _ops64_fq2."""
    add, sub, mul = ops
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = mul(add(X1, Y1), add(X2, Y2))
    t3 = sub(t3, add(t0, t1))
    t4 = mul(add(Y1, Z1), add(Y2, Z2))
    t4 = sub(t4, add(t1, t2))
    X3 = mul(add(X1, Z1), add(X2, Z2))
    Y3 = sub(X3, add(t0, t2))
    X3 = add(t0, t0)
    t0 = add(X3, t0)
    t2 = mul(b3, t2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = mul(b3, Y3)
    X3 = mul(t4, Y3)
    X3 = sub(mul(t3, t1), X3)
    Y3 = mul(Y3, t0)
    Y3 = add(mul(t1, Z3), Y3)
    t0 = mul(t0, t3)
    Z3 = add(mul(Z3, t4), t0)
    return X3, Y3, Z3


def _pdbl64(ops, b3, p):
    """Complete doubling, a = 0 (RCB16 Algorithm 9), with ops as _padd64."""
    add, sub, mul = ops
    X, Y, Z = p
    t0 = mul(Y, Y)
    Z3 = add(t0, t0)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    t1 = mul(Y, Z)
    t2 = mul(Z, Z)
    t2 = mul(b3, t2)
    X3 = mul(t2, Z3)
    Y3 = add(t0, t2)
    Z3 = mul(t1, Z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    Y3 = mul(t0, Y3)
    Y3 = add(X3, Y3)
    t1 = mul(X, Y)
    X3 = mul(t0, t1)
    X3 = add(X3, X3)
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


def bucket_scan_rows_ref(spec: FieldSpec, rows, tag, b3, K: int):
    """Plain version of K4 (contract in csrc/bucket_scan.cu)."""
    L = spec.L
    C = 3 * L
    total, lanes = rows.shape
    N = total // K
    r = rows.reshape(K, N, lanes).long()
    t = tag.reshape(K, N)
    zero = torch.zeros((L, N), dtype=torch.int64, device=rows.device)
    one = limb.one_mont(spec, (N,), rows.device).long()
    acc = (zero, one, zero)
    b3e = _b3_like(b3, zero)
    ops = _ops64(spec)
    flush = torch.zeros_like(rows)
    for k in range(K):
        qx, qy, qz = (r[k, :, i * L:(i + 1) * L].T for i in range(3))
        qy = torch.where(((t[k] & 1) > 0).unsqueeze(0),
                         limb._sub64(spec, torch.zeros_like(qy), qy), qy)
        flush[k * N:(k + 1) * N, :C] = torch.cat(acc).T.int()
        s = _padd64(ops, b3e, acc, (qx, qy, qz))
        head = ((t[k] & 2) > 0).unsqueeze(0)
        acc = tuple(torch.where(head, qi, si) for qi, si in zip((qx, qy, qz), s))
    return torch.cat(acc).int(), flush


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require_b3(spec: FieldSpec, b3) -> None:
    _ext.require(b3, "b3", I32, (spec.L,))


def _launch_group_law(kernel: str, spec: FieldSpec, b3s, pts, h=None) -> tuple:
    """Check the inputs of K2, K3, K7 or K8 and launch it.  pts: one tuple of
    flat coordinate tensors per input point (3 for G1, 6 for G2; two points
    for an add, which also passes the optional mask h); b3s: b3's tensors
    (one for G1, c0 and c1 for G2).  Returns the flat output coordinates."""
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


def bucket_scan_rows(spec: FieldSpec, rows, tag, b3, K: int):
    """K4: segmented bucket scan over step-major point rows.

    rows (K * N, 64) int32, tag (K * N,) int32, b3 (L,).  Returns
    (acc (3L, N), flush (K * N, 64)); any N >= 1 is accepted."""
    if not _ext.use_kernel(rows, tag, b3):
        return bucket_scan_rows_ref(spec, rows, tag, b3, K)
    total = rows.shape[0]
    if K < 1 or total % K:
        raise ValueError(f"{total} rows do not split into K = {K} steps")
    _ext.require(rows, "rows", I32, (total, ROW_LANES))
    _ext.require(tag, "tag", I32, (total,))
    _require_b3(spec, b3)
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    N = total // K
    acc = torch.empty((3 * spec.L, N), dtype=I32, device=rows.device)
    flush = torch.empty_like(rows)
    if N:
        P = _ext.ptr
        _ext.launch("bucket_scan_rows", rows.device, P(rows), P(tag), P(b3),
                    P(acc), P(flush), N, K, _ext.consts_ptr(spec))
    return acc, flush
