"""G1 curve kernels K2 (complete add, optional select), K3 (complete double)
and K4 (the MSM bucket scan), each beside its plain PyTorch version.

Counterparts of ``padd_fused`` / ``padd_sel_fused``, ``pdbl_fused`` and
``bucket_scan_rows`` in ``myzkp_tpu/curves/curve_pallas.py``.  The wrappers
(``padd``, ``pdbl``, ``bucket_scan_rows``) launch the CUDA kernel for CUDA
tensors and run the plain version (``*_ref``, int64 inside) for CPU tensors.
The plain versions replay the formulas of ``weierstrass.py`` step for step,
so K2 and K3 agree with them limb for limb.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..fields import limb
from ..fields.spec import FieldSpec

I32 = torch.int32

ROW_LANES = 64  # int32 per point row: x | y | z limbs, padded to 64


# ---------------------------------------------------------------------------
# Plain versions (int64)
# ---------------------------------------------------------------------------

def _ops64(spec: FieldSpec):
    return (lambda a, b: limb._add64(spec, a, b),
            lambda a, b: limb._sub64(spec, a, b),
            lambda a, b: limb._mont_mul64(spec, a, b))


def _b3_like(b3: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return b3.long().reshape((-1,) + (1,) * (a.dim() - 1)).expand_as(a)


def _padd64(spec: FieldSpec, b3, p, q):
    """Complete addition, a = 0 (RCB16 Algorithm 7), on int64 limbs."""
    add, sub, mul = _ops64(spec)
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


def _pdbl64(spec: FieldSpec, b3, p):
    """Complete doubling, a = 0 (RCB16 Algorithm 9), on int64 limbs."""
    add, sub, mul = _ops64(spec)
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
    r = _padd64(spec, _b3_like(b3, p64[0]), p64, q64)
    if h is not None:
        r = tuple(limb.select(h, qi, ri) for qi, ri in zip(q64, r))
    return tuple(c.int() for c in r)


def pdbl_ref(spec: FieldSpec, b3, p):
    """Plain version of K3: 2P."""
    p64 = tuple(c.long() for c in p)
    return tuple(c.int() for c in _pdbl64(spec, _b3_like(b3, p64[0]), p64))


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
    flush = torch.zeros_like(rows)
    for k in range(K):
        qx, qy, qz = (r[k, :, i * L:(i + 1) * L].T for i in range(3))
        qy = torch.where(((t[k] & 1) > 0).unsqueeze(0),
                         limb._sub64(spec, torch.zeros_like(qy), qy), qy)
        flush[k * N:(k + 1) * N, :C] = torch.cat(acc).T.int()
        s = _padd64(spec, b3e, acc, (qx, qy, qz))
        head = ((t[k] & 2) > 0).unsqueeze(0)
        acc = tuple(torch.where(head, qi, si) for qi, si in zip((qx, qy, qz), s))
    return torch.cat(acc).int(), flush


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require_point(name: str, pt, shape) -> None:
    for c, coord in zip(pt, "xyz"):
        _ext.require(c, f"{name}.{coord}", I32, shape)


def _require_b3(spec: FieldSpec, b3) -> None:
    _ext.require(b3, "b3", I32, (spec.L,))


def padd(spec: FieldSpec, b3, p, q, h=None):
    """K2: complete add P + Q; with ``h``, Q where h is set and P + Q
    elsewhere.  Coordinates (L, *batch) int32; b3 (L,); h (*batch,) bool."""
    extra = () if h is None else (h,)
    if not _ext.use_kernel(*p, *q, b3, *extra):
        return padd_ref(spec, b3, p, q, h)
    shape = tuple(p[0].shape)
    _require_point("p", p, shape)
    _require_point("q", q, shape)
    _require_b3(spec, b3)
    if h is not None:
        _ext.require(h, "h", torch.bool, shape[1:])
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    n = p[0].numel() // spec.L
    if n:
        P = _ext.ptr
        _ext.launch("padd", p[0].device, *map(P, p), *map(P, q), P(h), P(b3),
                    *map(P, out), n, _ext.consts_ptr(spec))
    return out


def pdbl(spec: FieldSpec, b3, p):
    """K3: complete double 2P.  Coordinates (L, *batch) int32; b3 (L,)."""
    if not _ext.use_kernel(*p, b3):
        return pdbl_ref(spec, b3, p)
    _require_point("p", p, tuple(p[0].shape))
    _require_b3(spec, b3)
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    n = p[0].numel() // spec.L
    if n:
        P = _ext.ptr
        _ext.launch("pdbl", p[0].device, *map(P, p), P(b3), *map(P, out), n,
                    _ext.consts_ptr(spec))
    return out


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
