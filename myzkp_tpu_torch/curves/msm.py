"""Multi-scalar multiplication: Pippenger over G1 and G2, signed digits by
default.

Counterpart of ``myzkp_tpu/curves/msm.py``.  The points go once into a
row-major table (K16); per group of windows: one stable sort of the window
digits, the bucket scan reading that table by index in step-major order,
then the merge of the lanes' partial sums and, over all windows at once, the
hierarchical weighted bucket sum and the Horner combine.

Both groups take the reference's row-major scan path (its ``_rows_scan``):
the whole K-step scan of a window group is one launch of K4 (G1) or of its G2
instance, which read each step's row from the point table by its index (the
reference gathered them into a step-major copy first), write each segment's
flush straight into the bucket table and accept any lane count.  The
reference ran G2 through a ``lax.scan`` of the select-masked complete add
instead, as its TPU kernel held 3-leaf G1 rows only.
Scalars enter as standard-domain ``(L, n)`` int32 limb tensors; everything
runs on their device.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..fields import limb
from ..fields.spec import FieldSpec
from ..utils.metrics import span
from . import curve_kernels, weierstrass as wst
from .field_ops import Fq2Ops
from .weierstrass import Point, point_map


# ---------------------------------------------------------------------------
# Scalar digit / bit extraction
# ---------------------------------------------------------------------------

def scalar_bits(s_limbs, nbits: int | None = None):
    """(L, n) 16-bit limbs -> (nbits, n) LSB-first int32 bits."""
    nbits = nbits or 16 * s_limbs.shape[0]
    return torch.stack([(s_limbs[b // 16] >> (b % 16)) & 1
                        for b in range(nbits)])


def scalar_digits(s_limbs, c: int):
    """(L, n) 16-bit limbs -> (W, n) int32 window digits, W = ceil(16L/c).

    Digit w is bits [w*c, (w+1)*c).  Requires c <= 31."""
    if not 1 <= c <= 31:
        raise ValueError(f"window {c} outside [1, 31]")
    s = s_limbs.long()
    L = s.shape[0]
    W = (16 * L + c - 1) // c
    out = []
    for w in range(W):
        li, off = divmod(w * c, 16)
        val = s[li] >> off
        have, j = 16 - off, li + 1
        while have < c and j < L:
            val = val | (s[j] << have)
            have += 16
            j += 1
        out.append(val & ((1 << c) - 1))
    return torch.stack(out).int()


def signed_digits(digits, c: int):
    """Unsigned digits (W, n) -> (magnitude, negative) in signed-digit form.

    Each digit is rewritten into [-2^(c-1), 2^(c-1) - 1] with a carry into the
    next window, keeping sum_w d_w 2^(cw).  For scalars < 2^255 the top window
    never carries out."""
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(digits[0])
    out = []
    for d in digits:
        v = d + carry
        over = v >= half
        carry = over.int()
        out.append(torch.where(over, v - full, v))
    signed = torch.stack(out)
    return signed.abs(), signed < 0


# ---------------------------------------------------------------------------
# Window choice
# ---------------------------------------------------------------------------

def _bucket_sum_cost(c: int) -> int:
    """Modelled EC adds of the hierarchical weighted-bucket sum at window c."""
    if c <= _WSUM_BASE_C:
        return c * (1 << c)
    k = c // 2
    return 2 * (1 << c) + _bucket_sum_cost(c - k) + _bucket_sum_cost(k) + k


# Cost ratios measured on a TPU v5e (sort + row gather ~1.6 EC-add units per
# window and point), kept as the reference has them; refitting them on the
# H100 is open work (ROADMAP).
_SORT_GATHER_W = 1.6
_NARROW_W = 1.0


def default_window(n: int, signed: bool = True) -> int:
    """Bucket window size minimising the modelled work in EC-add units
    (signed digits: 2^(c-1) + 1 buckets per window; unsigned: 2^c)."""
    best_c, best_cost = 4, None
    for c in range(4, 20):
        W = -(-256 // c)
        if signed:
            bsum = _bucket_sum_cost(c - 1) + (c - 1) + 1
        else:
            bsum = _bucket_sum_cost(c)
        cost = W * (n * (1 + _SORT_GATHER_W) + _NARROW_W * bsum + 24 * c)
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


# ---------------------------------------------------------------------------
# Row-major point tables
# ---------------------------------------------------------------------------

# Limbs of one coordinate tensor: BN254's F_q takes 16.
_LEAF_LIMBS = 16


def _flat_leaves(pt: Point) -> tuple:
    """The coordinate tensors as contiguous (L, N) tensors."""
    return tuple(a.reshape(a.shape[0], -1).contiguous() for a in wst.leaves(pt))


def _rows_of_point(pt: Point, lanes: int | None = None):
    """(L, N) coordinate tensors -> (N, lanes) int32 rows (one launch of
    K16): all coordinate limbs side by side (x | y | z for G1, C = 48;
    x0 | x1 | y0 | y1 | z0 | z1 for G2, C = 96), zero-padded to a multiple of
    64.  Returns (rows, C)."""
    leaves = _flat_leaves(pt)
    C = _LEAF_LIMBS * len(leaves)
    lanes = lanes or -(-C // 64) * 64
    rows = torch.empty((leaves[0].shape[1], lanes), dtype=torch.int32,
                       device=leaves[0].device)
    return curve_kernels.scatter_rows(leaves, rows), C


def _point_of_rows(rows, C: int, shape, idx=None) -> Point:
    """Inverse of _rows_of_point: rows ``idx`` of an (Nt, lanes) table (every
    row where idx is None) -> Point of (L, *shape), in one launch of K14."""
    planes = curve_kernels.gather_planes(rows, idx, C).reshape((C,) + tuple(shape))
    return wst.from_leaves(planes.split(_LEAF_LIMBS, dim=0))


# ---------------------------------------------------------------------------
# Bucket accumulation
# ---------------------------------------------------------------------------

def _scan_inputs(vsort, dsort, num_buckets: int, K: int):
    """The bucket scan's step-major inputs for G windows of n_pad sorted
    digits each: the point-table row each step reads, the tags (bit 0 negate,
    bit 1 segment head) and the flush targets, rows of a (G * (num_buckets +
    1))-row bucket table or -1.  dsort / vsort: (G, n_pad) sorted digits and
    packed (index << 1 | negate) values; lane l of a window holds its digits
    l * K .. l * K + K - 1."""
    G, n_pad = dsort.shape
    B = n_pad // K
    d2 = dsort.reshape(G, B, K)
    prev = torch.cat([d2[..., :1], d2[..., :-1]], dim=-1)
    head = torch.cat([torch.ones_like(d2[..., :1], dtype=torch.bool),
                      d2[..., 1:] != d2[..., :-1]], dim=-1)
    # A flush hands the segment that ended inside the lane to its bucket.
    # None at step 0: nothing has ended inside the lane yet.  A flush there
    # would write the fresh infinity accumulator of a lane whose first digit
    # continues the previous lane's segment onto that segment's real target
    # (the reference's c = 14 fault, myzkp_tpu/curves/msm.py:321-328).
    flush = head & (prev > 0)
    flush[..., 0] = False
    w_off = torch.arange(G, device=dsort.device)[:, None, None] * (num_buckets + 1)
    tgt = torch.where(flush, prev + w_off, -1)

    def sm(x):  # (G, B, K) -> (K * G * B,) step-major
        return x.permute(2, 0, 1).reshape(-1)

    v2 = vsort.reshape(G, B, K)
    tag = sm(v2 & 1) | (sm(head.int()) << 1)
    return sm(v2 >> 1).contiguous(), tag.contiguous(), sm(tgt).int().contiguous()


@span("scan inputs")
def _bucket_accumulate(F, b3, rows, vsort, dsort, num_buckets: int, K: int) -> Point:
    """Bucket sums of G windows: one bucket-scan launch over G * n / K lanes
    (K4 for G1, its G2 instance for G2) that reads the point table ``rows``
    by index in step-major order and writes the segment flushes into the
    bucket table, and the merge of the lanes' end partials.  dsort / vsort:
    (G, n_pad) sorted digits and packed (index << 1 | negate) values.
    Returns a (G, num_buckets) point batch (bucket 0 unused)."""
    G, n_pad = dsort.shape
    B = n_pad // K
    slots = num_buckets + 1  # +1 per-window dummy slot for the merge, dropped at the end
    idx, tag, tgt = _scan_inputs(vsort, dsort, num_buckets, K)
    bk_rows, _ = _rows_of_point(wst.infinity(F, (G * slots,), rows.device), rows.shape[1])
    if not _ext.use_kernel(tgt):
        _check_unique_targets(tgt[tgt >= 0], num_buckets, slots)
    scan = (curve_kernels.bucket_scan_rows2 if isinstance(F, Fq2Ops)
            else curve_kernels.bucket_scan_rows)
    acc = wst.from_leaves(scan(F.spec, rows, idx, tag, tgt, b3, bk_rows, K).split(_LEAF_LIMBS))
    acc = point_map(lambda a: a.reshape(a.shape[0], G, B), acc)
    return _merge_lane_partials(F, b3, acc, dsort.reshape(G, B, K), bk_rows,
                                num_buckets, slots)


def _seg_scan_hs(F, b3, pts: Point, head) -> Point:
    """Segmented inclusive prefix sum across the lane axis (Hillis-Steele).

    pts: leaves (L, G, B); head: (G, B) segment-head flags.  log2(B) levels,
    each one launch of the level kernel (G1 or G2), which reads lane i - d,
    adds where the flag is clear and carries the flags."""
    level = (curve_kernels.padd2_seg_level if isinstance(F, Fq2Ops)
             else curve_kernels.padd_seg_level)
    B = head.shape[-1]
    x, flags = tuple(point_map(torch.Tensor.contiguous, pts)), head.contiguous()
    d = 1
    while d < B:
        x, flags = level(F.spec, b3, x, flags, d)
        d *= 2
    return Point(*x)


def _check_unique_targets(tgt, num_buckets: int, slots: int) -> None:
    real = tgt[tgt % slots != num_buckets]
    if real.unique().numel() != real.numel():
        raise RuntimeError("two flushes target one bucket")


@span("lane merge")
def _merge_lane_partials(F, b3, acc: Point, d2, bk_rows, num_buckets: int,
                         slots: int) -> Point:
    """Merge the lanes' end partials (segmented sum across lanes in sorted
    order) and add the segment totals to their buckets in bk_rows, the
    (G * slots, lanes) table the scan filled with the mid-lane flushes: the
    current buckets gathered into planes (K14), the adds, the sums scattered
    back as rows (K16), and the whole table into planes (K14).

    The scatter goes through a per-window dummy slot that is sliced off at
    the end: real targets are unique (checked on the plain path), and the
    dummies collide harmlessly however their writes interleave."""
    G, B, _ = d2.shape
    device = d2.device
    C = _LEAF_LIMBS * len(wst.leaves(acc))
    w_off = (torch.arange(G, device=device) * slots)[:, None]
    d_end = d2[..., -1]  # (G, B)
    ones = torch.ones((G, 1), dtype=torch.bool, device=device)
    seg_head = torch.cat([ones, d_end[:, 1:] != d_end[:, :-1]], dim=-1)
    seg_total = _seg_scan_hs(F, b3, acc, seg_head)
    is_end = torch.cat([d_end[:, :-1] != d_end[:, 1:], ones], dim=-1)
    tgt = (torch.where(is_end, d_end, num_buckets) + w_off).reshape(-1)
    if not _ext.use_kernel(tgt):
        _check_unique_targets(tgt, num_buckets, slots)
    cur = _point_of_rows(bk_rows, C, (G, B), tgt)
    merged = wst.padd(F, b3, cur, seg_total)
    curve_kernels.scatter_rows(_flat_leaves(merged), bk_rows, tgt)
    buckets = _point_of_rows(bk_rows, C, (G, slots))
    return point_map(lambda a: a[..., :num_buckets], buckets)


# Below this window size the bit-decomposition base case takes over.
_WSUM_BASE_C = 5


def _weighted_bucket_sum(F, b3, buckets: Point, c: int) -> Point:
    """sum_{b=1}^{2^c-1} b * B_b over a (G, 2^c) bucket batch -> (G,).

    Hierarchical split b = hi * 2^k + lo (k = c // 2): row sums and column
    sums by tree sums, two half-width weighted sums, k doublings.  Bucket 0
    is weighted by zero on every path."""
    L, Gw = wst.leaves(buckets)[0].shape[:2]
    device = wst.leaves(buckets)[0].device
    if c > _WSUM_BASE_C:
        k = c // 2
        hi_n, lo_n = 1 << (c - k), 1 << k
        grid = point_map(lambda a: a.reshape(L, Gw, hi_n, lo_n), buckets)
        rows = wst.tree_sum(F, b3, grid, axis=2)  # (G, hi_n): sum over lo
        cols = wst.tree_sum(F, b3, grid, axis=1)  # (G, lo_n): sum over hi
        s_hi = _weighted_bucket_sum(F, b3, rows, c - k)
        s_lo = _weighted_bucket_sum(F, b3, cols, k)
        return wst.padd(F, b3, wst.pdbl(F, b3, s_hi, k), s_lo)
    num = 1 << c
    idx = torch.arange(num, device=device)
    bitmask = ((idx[None, :] >> torch.arange(c, device=device)[:, None]) & 1) == 1
    stacked = point_map(lambda a: a[:, :, None, :].expand(L, Gw, c, num), buckets)
    inf_wide = wst.infinity(F, (Gw, c, num), device)
    sel = wst.pselect(F, bitmask, stacked, inf_wide)
    totals = wst.tree_sum(F, b3, sel, axis=2)  # (G, c)
    acc = wst.infinity(F, (Gw,), device)
    for j in reversed(range(c)):  # high bit first
        acc = wst.padd(F, b3, wst.pdbl(F, b3, acc),
                       point_map(lambda a: a[..., j], totals))
    return acc


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _group_size(n_pad: int, W: int, slots: int = 0) -> int:
    """Windows per bucket-accumulation pass: caps the scan's step-major
    inputs (index, tag and target of G * n_pad steps) and the bucket table
    at ~2^21 entries each."""
    cap = (1 << 21) // max(n_pad, slots, 1)
    return int(min(W, max(1, cap)))


def msm_pippenger(F, b3, points: Point, s_limbs, c: int | None = None,
                  K: int | None = None, G: int | None = None,
                  signed: bool = True) -> Point:
    """sum_i [s_i] P_i.  points: (n,) batch; s_limbs: (L, n) int32 standard
    domain.  Returns one (unbatched) projective point.

    With ``signed`` (the default) digits lie in [-2^(c-1), 2^(c-1)] and
    negative ones enter the scan negated, which halves the buckets; unsigned
    digits lie in [0, 2^c) over 2^c buckets (bucket 0 dropped), and c < 2
    always runs unsigned.  The points go into one row-major table; the W =
    ceil(256 / c) windows go in groups of G (``_group_size`` unless the
    caller gives G, capped at W) through one stable sort and one K-step
    bucket scan each (G * n / K lanes), which reads that table by index."""
    n = s_limbs.shape[1]
    if c is None:
        c = default_window(n, signed)
    if not 1 <= c <= 31:
        raise ValueError(f"window {c} outside [1, 31]")
    if c < 2:
        signed = False
    num_buckets = (1 << (c - 1)) + 1 if signed else 1 << c
    W = -(-16 * s_limbs.shape[0] // c)
    if G is None:
        G = _group_size(n, W, num_buckets + 1)
    if G < 1:
        raise ValueError(f"G = {G}: a group holds at least one window")
    G = min(G, W)
    if K is None:
        # per-step width G * n / K of ~2^15 lanes: a smaller K costs more
        # lane-merge adds, a larger one narrows each scan step
        K = int(min(n, max(8, _next_pow2(G * n // (1 << 15)))))
    # pad n to a multiple of K with digit 0 (bucket 0 is dropped)
    n_pad = -(-n // K) * K
    if n_pad != n:
        pad = n_pad - n
        points = point_map(lambda a: torch.cat([a, a[:, :1].expand(-1, pad)], dim=1),
                           points)
        s_limbs = torch.nn.functional.pad(s_limbs, (0, pad))

    rows, _ = _rows_of_point(points)
    d_sorted, v_sorted = _sorted_digits(s_limbs, c, -(-W // G) * G, signed)
    groups = [_bucket_accumulate(F, b3, rows, v_sorted[g:g + G],
                                 d_sorted[g:g + G], num_buckets, K)
              for g in range(0, d_sorted.shape[0], G)]
    buckets = point_map(lambda *cs: torch.cat(cs, dim=1), *groups)
    return _horner(F, b3, _window_sums(F, b3, buckets, c, signed), c)


@span("sort")
def _sorted_digits(s_limbs, c: int, W_pad: int, signed: bool = True):
    """Each window's digits (signed-digit magnitudes, or the unsigned digits
    with the negate bit never set) sorted (stably) with their packed (index
    << 1 | negate) values: two (W_pad, n) int32 tensors; the windows past
    the scalars' W are zero-digit fillers at the MSB end, whose sums are
    infinity."""
    n = s_limbs.shape[1]
    digits = scalar_digits(s_limbs, c)  # (W, n)
    if signed:
        digits, dneg = signed_digits(digits, c)
    else:
        dneg = torch.zeros_like(digits, dtype=torch.bool)
    W = digits.shape[0]
    if W_pad != W:
        digits = torch.nn.functional.pad(digits, (0, 0, 0, W_pad - W))
        dneg = torch.nn.functional.pad(dneg, (0, 0, 0, W_pad - W))
    iota = torch.arange(n, dtype=torch.int32, device=s_limbs.device)
    vals = (iota[None] << 1) | dneg.int()
    d_sorted, order = torch.sort(digits, dim=1, stable=True)
    return d_sorted, vals.gather(1, order)


@span("bucket sum")
def _window_sums(F, b3, buckets: Point, c: int, signed: bool = True) -> Point:
    """S_w = sum_b b * B_b per window.  Unsigned: the weighted sum over the
    (W_pad, 2^c) bucket batch.  Signed: magnitudes span [0, half] of a
    (W_pad, 2^(c-1) + 1) batch; the power-of-two weighted sum covers [1,
    half - 1] and the top bucket adds half * B_half."""
    if not signed:
        return _weighted_bucket_sum(F, b3, buckets, c)  # (W_pad,)
    half = 1 << (c - 1)
    main = point_map(lambda a: a[..., :half], buckets)
    top = point_map(lambda a: a[..., half], buckets)
    s_w = _weighted_bucket_sum(F, b3, main, c - 1)
    return wst.padd(F, b3, s_w, wst.pdbl(F, b3, top, c - 1))  # (W_pad,)


@span("horner")
def _horner(F, b3, s_w: Point, c: int) -> Point:
    """sum_w 2^(cw) S_w, most significant window first."""
    res = wst.infinity(F, (), wst.leaves(s_w)[0].device)
    for w in reversed(range(wst.leaves(s_w)[0].shape[1])):
        res = wst.padd(F, b3, wst.pdbl(F, b3, res, c), point_map(lambda a: a[:, w], s_w))
    return res


# Below this size one 256-step double-and-add ladder beats the bucket method.
_PIPPENGER_MIN_N = 128


def msm_many(F, b3, jobs) -> list:
    """[sum_i [s_i] P_i for (P, s) in jobs] over one group: P an (n,) point
    batch, s its (L, n) standard-domain scalars.

    The jobs below _PIPPENGER_MIN_N points share one batched double-and-add
    ladder (256 steps, each one add, one select and one double over all of
    their points), then a tree sum each; the others run msm_pippenger each.
    The Pinocchio prover sends a group's MSMs and its delta shifts (jobs of
    one point) here together."""
    out = [None] * len(jobs)
    small = [k for k, (_, s) in enumerate(jobs) if s.shape[1] < _PIPPENGER_MIN_N]
    if small:
        pts = point_map(lambda *cs: torch.cat(cs, dim=1), *(jobs[k][0] for k in small))
        bits = scalar_bits(torch.cat([jobs[k][1] for k in small], dim=1))
        each = wst.scalar_mul_bits(F, b3, pts, bits)
        off = 0
        for k in small:
            n = jobs[k][1].shape[1]
            out[k] = wst.tree_sum(F, b3, point_map(lambda a: a[:, off:off + n], each))
            off += n
    for k, (pts, s) in enumerate(jobs):
        if out[k] is None:
            out[k] = msm_pippenger(F, b3, pts, s)
    return out


def msm_naive(F, b3, points: Point, s_limbs) -> Point:
    """sum_i [s_i] P_i by one batched double-and-add ladder over all points
    (bases from one steps launch of the doubling chain) and a tree sum."""
    each = wst.scalar_mul_bits(F, b3, points, scalar_bits(s_limbs))
    return wst.tree_sum(F, b3, each)


def msm(F, b3, points: Point, s_limbs, **kw) -> Point:
    """sum_i [s_i] P_i: the double-and-add ladder below _PIPPENGER_MIN_N
    points unless an argument of msm_pippenger (c, K, G, signed) is given,
    else msm_pippenger with those arguments."""
    if kw:
        return msm_pippenger(F, b3, points, s_limbs, **kw)
    return msm_many(F, b3, [(points, s_limbs)])[0]


def scalars_from_int(spec: FieldSpec, values, device=None) -> torch.Tensor:
    """Host ints -> standard-domain (L, n) limb tensor for the MSM."""
    return limb.from_int(spec, list(values), device)
