"""Port parity: the Pippenger bucket scan of myzkp_tpu_torch against the JAX
package.

The scan's inputs (row indices, tags, flush targets) are held to a direct
reading of the reference's rules; the G1 scan (plain version of K4) to the
JAX package's Pallas kernel curve_pallas.bucket_scan_rows in interpret mode,
limb for limb; the G2 bucket accumulation (the plain version of K4's G2
instance, its in-scan flushes and the lane merge) to the JAX package's
_bucket_accumulate, the lax.scan of padd_sel that the reference runs for G2,
as affine buckets and against host sums.  Tolerance 0 throughout: these are
modular integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import curve_pallas
from myzkp_tpu.curves import msm as jmsm
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import curve_kernels as ck
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)


def _sorted_windows(rng, G: int, n: int, top: int):
    """G windows of n digits in [0, top] (heavy duplicates) with random
    negate flags, sorted stably as msm_pippenger sorts them: (dsort, vsort)
    as (G, n) int32 tensors, vsort = index << 1 | negate."""
    d = rng.integers(0, top + 1, (G, n)).astype(np.int32)
    neg = rng.integers(0, 2, (G, n)).astype(np.int32)
    order = np.argsort(d, axis=1, kind="stable")
    dsort = np.take_along_axis(d, order, 1)
    vsort = (order << 1) | np.take_along_axis(neg, order, 1)
    return torch.from_numpy(dsort), torch.from_numpy(vsort.astype(np.int32))


def test_scan_inputs_follow_the_reference_rules():
    """Head-dense digits (the pattern of the reference's c = 14 fault): no
    flush at step 0; a flush at every other segment head whose previous digit
    is nonzero, into that digit's row of its window's bucket table; -1
    elsewhere; the real targets unique."""
    G, B, K, top = 3, 16, 4, 40
    num_buckets = top + 1
    dsort, vsort = _sorted_windows(np.random.default_rng(3), G, B * K, top)
    idx, tag, tgt = tmsm._scan_inputs(vsort, dsort, num_buckets, K)
    d, v = dsort.numpy(), vsort.numpy()
    for k in range(K):
        for g in range(G):
            for lane in range(B):
                i, r = lane * K + k, (k * G + g) * B + lane
                head = k == 0 or d[g, i] != d[g, i - 1]
                flush = k > 0 and head and d[g, i - 1] > 0
                assert int(idx[r]) == v[g, i] >> 1
                assert int(tag[r]) == (v[g, i] & 1) | (head << 1)
                assert int(tgt[r]) == (g * (num_buckets + 1) + d[g, i - 1] if flush else -1)
    real = tgt[tgt >= 0]
    assert (tgt[:G * B] == -1).all() and real.numel() > G * B
    assert real.unique().numel() == real.numel()
    tmsm._check_unique_targets(real, num_buckets, num_buckets + 1)


def _walk(start, step, n: int) -> list:
    """n host points start, start + step, ...: cheap distinct points."""
    pts = [start]
    while len(pts) < n:
        pts.append(pts[-1] + step)
    return pts


@pytest.mark.slow
def test_bucket_scan_rows_matches_jax_kernel():
    """The G1 scan's plain version vs curve_pallas.bucket_scan_rows in
    interpret mode (as tests/test_pallas.py:271 runs it; about 45 minutes
    of JAX CPU time), N = 1024 lanes, K = 2: acc limb for limb, and the
    bucket rows at the real targets equal to the JAX kernel's flush rows
    there."""
    rng = np.random.default_rng(29)
    N, K = 1024, 2
    g = tbn.g1_generator()
    pts = interop.point_to_numpy(tbn.g1_points_to_device(_walk(g * 5, g * 77, K * N), DEV))
    rows_j, _, C = jmsm._rows_of_point(jw.Point(*(jnp.asarray(a) for a in pts)))
    tags = rng.integers(0, 4, K * N).astype(np.int32)
    tags[:7] = [0, 1, 2, 3, 2, 1, 0]
    S = K * N + 9
    tgt = np.where(rng.random(K * N) < 0.3, rng.permutation(S)[:K * N], -1).astype(np.int32)
    acc_j, flush_j = curve_pallas.bucket_scan_rows(
        jbn.q_spec(), rows_j, jnp.asarray(tags), jbn.g1_b3(()), K, True)
    rows = torch.from_numpy(np.asarray(rows_j).astype(np.int32))
    table, _ = tmsm._rows_of_point(tw.infinity(tbn.g1_ops(), (S,), DEV), rows.shape[1])
    idx = torch.arange(K * N, dtype=torch.int32)  # the kernel's rows in order
    acc = ck.bucket_scan_rows(tbn.q_spec(), rows, idx, torch.from_numpy(tags),
                              torch.from_numpy(tgt), tbn.g1_b3((), DEV), table, K)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j).astype(np.int32))
    real = np.flatnonzero(tgt >= 0)
    np.testing.assert_array_equal(table[tgt[real], :C].numpy(),
                                  np.asarray(flush_j)[real, :C].astype(np.int32))


def _g2_host(pt) -> list:
    """A G2 point batch with (L, G, nb) leaves -> host points, window-major."""
    L = tbn.q_spec().L
    return tbn.g2_points_to_host(tw.point_map(lambda a: a.reshape(L, -1), pt))


def test_bucket_accumulate_g2_matches_reference():
    """G2 bucket sums of 2 windows of 64 sorted digits (c = 4: buckets 0..8,
    K = 8 steps a lane) through the port's _bucket_accumulate (the G2 scan
    instance's plain version, its in-scan flushes and the lane merge) and
    the JAX package's _bucket_accumulate, as affine buckets, both equal to
    host sums; bucket 0 is unused by both."""
    G, n, K, top = 2, 64, 8, 8
    rng = np.random.default_rng(64)
    g2 = tbn.g2_generator()
    host = _walk(g2 * 3, g2 * 1001, n)
    pts = tbn.g2_points_to_device(host, DEV)
    dsort, vsort = _sorted_windows(rng, G, n, top)
    got = tmsm._bucket_accumulate(tbn.g2_ops(), tbn.g2_b3((), DEV),
                                  tmsm._rows_of_point(pts)[0], vsort, dsort, top + 1, K)
    order, neg = (vsort >> 1).numpy(), (vsort & 1).numpy() > 0
    a = [jnp.take(jnp.asarray(x), jnp.asarray(order), axis=1) for x in interop.point_to_numpy(pts)]
    q = jw.Point((a[0], a[1]), (a[2], a[3]), (a[4], a[5]))
    JF = jbn.g2_ops()
    q = jw.Point(q.x, JF.select(jnp.asarray(neg), JF.neg(q.y), q.y), q.z)
    want = jmsm._bucket_accumulate(JF, jbn.g2_b3(()), q, jnp.asarray(dsort.numpy()), top + 1, K)
    want_pts = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    want_host = _g2_host(tw.from_leaves(interop.limbs_from_numpy(a, DEV) for a in want_pts))
    got_host = _g2_host(got)
    sums = [[tbn.curve_g2.infinity() for _ in range(top + 1)] for _ in range(G)]
    for w in range(G):
        for i in range(n):
            p = host[order[w, i]]
            sums[w][int(dsort[w, i])] += -p if neg[w, i] else p
    nb = top + 1
    for w in range(G):
        for b in range(1, nb):
            assert got_host[w * nb + b] == want_host[w * nb + b] == sums[w][b]
