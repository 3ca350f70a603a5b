"""Port parity: the moves between point rows and limb planes, and the bucket
scan that reads the point table by index.

The plain versions of K14 (gather_planes_ref: rows by index into limb
planes) and K16 (scatter_rows_ref: limb planes into rows at targets) are held
to the JAX package's own layout code, its jnp.take of rows and _point_of_rows
(myzkp_tpu/curves/msm.py:207, 408; fixed_base.py:118-119) and its
_rows_of_point and bk_rows.at[tgt].set (msm.py:190, 411-414); the port's
msm._rows_of_point / _point_of_rows, which route through the wrappers, to
the same.  The indexed scan's plain version is held to the row-major contract
it replaced (the rows gathered first, then read in order) and to a host
segmented scan, on head-dense digits at c = 14 through msm._scan_inputs.
Inputs are random 16-bit limbs from numpy seeds, with the edge values 0, 1,
q - 1 and R mod q in some points.  Tolerance 0: these are integers moved
about, or modular sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import msm as jmsm
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import curve_kernels as ck
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.fields import limb

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

LEAVES = {"g1": 3, "g2": 6}


def _edge_limbs(n: int) -> np.ndarray:
    """(16, n) limbs of 0, 1, q - 1 and R mod q in turn."""
    spec = tbn.q_spec()
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    return limb.from_int(spec, [edges[i % 4] for i in range(n)], DEV).numpy()


def _leaves(rng, group: str, n: int) -> list:
    """The coordinate limb arrays of n points, (16, n) int32 each: random
    16-bit limbs, the first 8 points edge values in every coordinate."""
    out = []
    for _ in range(LEAVES[group]):
        a = rng.integers(0, 1 << 16, (16, n)).astype(np.int32)
        k = min(8, n)
        a[:, :k] = _edge_limbs(k)
        out.append(a)
    return out


def _jax_point(arrays):
    a = [jnp.asarray(x.astype(np.uint32)) for x in arrays]
    if len(a) == 3:
        return jw.Point(*a)
    return jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5]))


def _as_int32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int32)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("kind", ["int32", "int64", "none"])
def test_gather_planes_ref_matches_reference(group, kind):
    """gather_planes_ref and msm._point_of_rows (the plain path of K14) vs
    the JAX package's _point_of_rows of jnp.take(rows, idx): n = 7 * 11
    indices with repeats into a 53-row table, returned as (7, 11) batches as
    the fixed-base path asks; with no indices, every row of a 77-row
    table."""
    rng = np.random.default_rng(140 + LEAVES[group] + len(kind))
    shape = (7, 11)
    n = shape[0] * shape[1]
    nt = 53 if kind != "none" else n
    rows_j, treedef, C = jmsm._rows_of_point(_jax_point(_leaves(rng, group, nt)))
    rows = torch.from_numpy(_as_int32(rows_j))
    if kind == "none":
        idx, taken = None, rows_j
    else:
        ia = rng.integers(0, nt, n)
        ia[:5] = ia[5]  # repeats
        idx = torch.from_numpy(ia).to(getattr(torch, kind))
        taken = jnp.take(rows_j, jnp.asarray(ia), axis=0)
    want = [_as_int32(a) for a in jax.tree_util.tree_leaves(
        jmsm._point_of_rows(taken, treedef, C, shape))]
    planes = ck.gather_planes_ref(rows, idx, C)
    assert planes.shape == (C, n) and planes.is_contiguous()
    np.testing.assert_array_equal(planes.numpy(), np.concatenate(want).reshape(C, n))
    got = tw.leaves(tmsm._point_of_rows(rows, C, shape, idx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scatter_rows_ref_matches_reference(group):
    """scatter_rows_ref and msm._rows_of_point (the plain path of K16) vs the
    JAX package's _rows_of_point at n = 77 (ragged against K16's blocks of
    64 or 32 points), zero pad columns included; then written at targets
    into a table of other values, against bk_rows.at[tgt].set(rows), with
    one target repeated 5 times.  A repeated target's row is left to
    whichever write lands (the MSM repeats only its dropped dummy slot), so
    the tables are compared on every other row."""
    rng = np.random.default_rng(160 + LEAVES[group])
    n, S = 77, 101
    arrays = _leaves(rng, group, n)
    W = 64 if group == "g1" else 128
    rows_j, _, C = jmsm._rows_of_point(_jax_point(arrays))
    leaves = [torch.from_numpy(a) for a in arrays]
    rows, C_port = tmsm._rows_of_point(tw.from_leaves(leaves))
    assert C_port == C and rows.shape == (n, W)
    np.testing.assert_array_equal(rows.numpy(), _as_int32(rows_j))
    assert not rows[:, C:].any()
    fresh = ck.scatter_rows_ref(leaves, torch.full((n, W), -1, dtype=torch.int32))
    np.testing.assert_array_equal(fresh.numpy(), _as_int32(rows_j))

    tgt = rng.permutation(S)[:n]
    tgt[1:6] = tgt[0]
    table = rng.integers(0, 1 << 16, (S, W)).astype(np.int32)
    want = _as_int32(jnp.asarray(table.astype(np.uint32)).at[jnp.asarray(tgt)].set(
        rows_j, mode="drop"))
    for dtype in (torch.int32, torch.int64):
        out = torch.from_numpy(table.copy())
        assert ck.scatter_rows_ref(leaves, out, torch.from_numpy(tgt).to(dtype)) is out
        keep = np.ones(S, dtype=bool)
        keep[tgt[0]] = False
        np.testing.assert_array_equal(out.numpy()[keep], want[keep])
        assert not out[torch.from_numpy(tgt)][:, C:].any()


def test_gather_planes_ref_raises_on_an_index_out_of_range():
    """The kernel does not check its indices; the plain version raises."""
    rows = torch.zeros((10, 64), dtype=torch.int32)
    with pytest.raises(IndexError):
        ck.gather_planes_ref(rows, torch.tensor([3, 10], dtype=torch.int32), 48)
    with pytest.raises(IndexError):
        ck.bucket_scan_rows_ref(tbn.q_spec(), rows, torch.tensor([0, 10], dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32),
                                torch.full((2,), -1, dtype=torch.int32),
                                tbn.g1_b3((), DEV), torch.zeros((4, 64), dtype=torch.int32), 2)


def _head_dense(rng, G: int, n: int, c: int):
    """G windows of n sorted signed-digit magnitudes at window c, drawn from
    a pool of n // 3 values in [0, 2^(c-1)]: nearly every step a segment
    head, with segments that run across lanes.  (dsort, vsort) as
    msm._sorted_digits returns them."""
    pool = rng.choice((1 << (c - 1)) + 1, n // 3, replace=False)
    d = pool[rng.integers(0, len(pool), (G, n))].astype(np.int32)
    neg = rng.integers(0, 2, (G, n)).astype(np.int32)
    order = np.argsort(d, axis=1, kind="stable")
    vsort = (order << 1) | np.take_along_axis(neg, order, 1)
    return (torch.from_numpy(np.take_along_axis(d, order, 1)),
            torch.from_numpy(vsort.astype(np.int32)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_indexed_scan_ref_matches_row_contract_c14(group):
    """The indexed scan's plain version on the scan inputs of head-dense
    digits at c = 14 (the step-0 flush case: lanes whose first digit
    continues the previous lane's segment, no flush at step 0) against the
    row-major contract it replaced, the rows table[idx] gathered first and
    read in order, acc and the whole bucket table exact; and against a host
    segmented scan of the same points, as affine points."""
    rng = np.random.default_rng(14 + LEAVES[group])
    g2 = group == "g2"
    c, G, K = 14, 2, 4
    n = 96 if g2 else 192
    F, b3 = (tbn.g2_ops(), tbn.g2_b3((), DEV)) if g2 else (tbn.g1_ops(), tbn.g1_b3((), DEV))
    gen = tbn.g2_generator() if g2 else tbn.g1_generator()
    to_host = tbn.g2_points_to_host if g2 else tbn.g1_points_to_host
    host = [gen * 7]
    while len(host) < n:  # a walk of host additions: cheap distinct points
        host.append(host[-1] + gen * 1009)
    table, C = tmsm._rows_of_point((tbn.g2_points_to_device if g2
                                    else tbn.g1_points_to_device)(host, DEV))
    num_buckets = (1 << (c - 1)) + 1
    slots = num_buckets + 1
    dsort, vsort = _head_dense(rng, G, n, c)
    idx, tag, tgt = tmsm._scan_inputs(vsort, dsort, num_buckets, K)
    d2 = dsort.reshape(G, n // K, K)
    assert (d2[:, 1:, 0] == d2[:, :-1, -1]).any()  # a segment crosses a lane
    N = G * n // K
    assert (tgt[:N] == -1).all() and (tgt >= 0).sum() > N // 4
    assert idx.dtype == torch.int32 and idx.unique().numel() < idx.numel()  # repeats

    inf = tmsm._rows_of_point(tw.infinity(F, (G * slots,), DEV), table.shape[1])[0]
    t_idx, t_rows = inf.clone(), inf.clone()
    acc = ck.bucket_scan_rows_ref(tbn.q_spec(), table, idx, tag, tgt, b3, t_idx, K)
    gathered = table.index_select(0, idx)
    acc_rows = ck.bucket_scan_rows_ref(tbn.q_spec(), gathered,
                                       torch.arange(K * N, dtype=torch.int32), tag, tgt,
                                       b3, t_rows, K)
    assert torch.equal(acc, acc_rows) and torch.equal(t_idx, t_rows)

    inf_h = (tbn.curve_g2 if g2 else tbn.curve_g1).infinity()
    acc_h, flushed = [inf_h] * N, {}
    for r in range(K * N):
        lane = r % N
        if tgt[r] >= 0:
            flushed[int(tgt[r])] = acc_h[lane]
        q = host[int(idx[r])]
        q = -q if tag[r] & 1 else q
        acc_h[lane] = q if tag[r] & 2 else acc_h[lane] + q
    assert to_host(tw.from_leaves(acc.split(16))) == acc_h
    real = sorted(flushed)
    got = to_host(tmsm._point_of_rows(t_idx, C, (len(real),),
                                      torch.tensor(real, dtype=torch.int64)))
    assert got == [flushed[t] for t in real]


def test_row_moves_dispatch_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions: gather_planes
    equals gather_planes_ref, scatter_rows writes the table it is given in
    place and returns it."""
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(rng.integers(0, 1 << 16, (40, 128)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 40, 33))
    assert torch.equal(ck.gather_planes(rows, idx, 96), ck.gather_planes_ref(rows, idx, 96))
    leaves = [torch.from_numpy(a) for a in _leaves(rng, "g1", 33)]
    out = torch.zeros((50, 64), dtype=torch.int32)
    assert ck.scatter_rows(leaves, out, torch.arange(17, 50)) is out
    assert torch.equal(ck.gather_planes(out, torch.arange(17, 50), 48),
                       torch.cat(leaves)) and not out[:17].any()
