"""Port parity: fixed-base setup and the Pippenger MSM of myzkp_tpu_torch.

Inputs are made once from numpy seeds and handed to both packages through
interop.  Digits are compared bit for bit; fixed-base and MSM outputs are
compared as affine group elements, because the port's stable sort and halving
tree sums pick other projective representatives than the JAX CPU path.  Every
result is also held to the host golden [sum k_i m_i mod r]G.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import fixed_base as jfb
from myzkp_tpu.curves import msm as jmsm
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import fixed_base as tfb
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw
from test_torch_spans import spans_entered  # noqa: F401  (a fixture)

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

R = tbn.R


def _rand_scalars(rng: np.random.Generator, n: int, low: int = 0) -> list:
    return [low + int.from_bytes(rng.bytes(40), "little") % (R - low)
            for _ in range(n)]


def _affine_of_jax(pt) -> list:
    """A JAX (unbatched or (n,)) point -> host points, via the port."""
    leaves = [np.asarray(a) for a in pt]
    if leaves[0].ndim == 1:
        leaves = [a[:, None] for a in leaves]
    return tbn.g1_points_to_host(tw.Point(*interop.point_from_numpy(leaves, DEV)))


def _affine(pt) -> list:
    if pt.x.dim() == 1:
        pt = tw.Point(*(a[:, None] for a in pt))
    return tbn.g1_points_to_host(pt)


@pytest.fixture(scope="module")
def known_multiples():
    """512 points [m_i]G from the port's fixed-base path, as numpy limbs."""
    rng = np.random.default_rng(512)
    ms = _rand_scalars(rng, 512, low=1)
    pts = tfb.fixed_base_multi("g1", tmsm.scalars_from_int(tbn.r_spec(), ms, DEV))
    return ms, interop.point_to_numpy(pts)


@pytest.mark.parametrize("c", [8, 14, 16])
def test_scalar_digits_match_reference(c):
    rng = np.random.default_rng(c)
    ks = [0, 1, R - 1] + _rand_scalars(rng, 29)
    s_np = np.asarray(jmsm.scalars_from_int(jbn.r_spec(), ks))
    s = interop.limbs_from_numpy(s_np, DEV)
    got, want = tmsm.scalar_digits(s, c), jmsm.scalar_digits(jnp.asarray(s_np), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mag, neg = tmsm.signed_digits(got, c)
    jmag, jneg = jmsm.signed_digits(want, c)
    np.testing.assert_array_equal(mag.numpy(), np.asarray(jmag))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))


def test_default_window_matches_reference():
    for n in (8, 509, 512, 1 << 16, 1 << 20):
        assert tmsm.default_window(n) == jmsm.default_window(n, signed=True)


def test_fixed_base_multi_matches_reference():
    """The 8 edge and random scalars of test_curves.py's fixed-base test."""
    rng = random.Random(31)
    ks = [0, 1, 2, R - 1] + [rng.randrange(R) for _ in range(4)]
    s_np = np.asarray(jmsm.scalars_from_int(jbn.r_spec(), ks))
    got = _affine(tfb.fixed_base_multi("g1", interop.limbs_from_numpy(s_np, DEV)))
    want = _affine_of_jax(jfb.fixed_base_multi("g1", jnp.asarray(s_np)))
    g = tbn.g1_generator()
    assert got == want == [g * k for k in ks]


def test_interop_reads_the_reference_caches(tmp_path):
    """The JAX package's fixed-base table and bench point table, written in
    their own .npz formats, load into the port unchanged; the port's own
    table holds the same integers."""
    leaves = [np.asarray(a) for a in jfb._device_table("g1", tfb._TABLE_C)]
    path = tmp_path / "g1_c8.npz"
    np.savez(path, **{f"l{i}": a for i, a in enumerate(leaves)})
    table = interop.load_fixed_base_table(path, DEV)
    own = tfb._device_table("g1", DEV)
    for got, mine, want in zip(table, own, leaves):
        np.testing.assert_array_equal(interop.limbs_to_numpy(got), want)
        np.testing.assert_array_equal(interop.limbs_to_numpy(mine), want)
    pts = jfb.fixed_base_multi("g1", jmsm.scalars_from_int(jbn.r_spec(), [3, 5]))
    x, y, z = (np.asarray(a) for a in pts)
    np.savez(tmp_path / "pts.npz", x=x, y=y, z=z)
    got = interop.load_bench_points(tmp_path / "pts.npz", DEV)
    for a, want in zip(got, (x, y, z)):
        np.testing.assert_array_equal(interop.limbs_to_numpy(a), want)
    with pytest.raises(ValueError):
        interop.limbs_from_numpy(np.full((16, 2), 1 << 16, dtype=np.uint32))


@pytest.mark.parametrize("n,c,K", [(509, 8, 64), (512, None, None)])
def test_msm_pippenger_matches_reference(known_multiples, n, c, K):
    ms, pts_np = known_multiples
    rng = np.random.default_rng(1000 + n)
    ks = _rand_scalars(rng, n)
    ks[0], ks[1], ks[2] = 0, 5, 5  # zero and duplicate scalars
    exp = tbn.g1_generator() * (sum(k * m for k, m in zip(ks, ms)) % R)
    s_np = np.asarray(jmsm.scalars_from_int(jbn.r_spec(), ks))
    pts = tw.Point(*(a[:, :n] for a in interop.point_from_numpy(pts_np, DEV)))
    got = tmsm.msm_pippenger(tbn.g1_ops(), tbn.g1_b3((), DEV), pts,
                             interop.limbs_from_numpy(s_np, DEV), c=c, K=K)
    jpts = jw.Point(*(jnp.asarray(a[:, :n]) for a in pts_np))
    want = jmsm.msm_pippenger(jbn.g1_ops(), jbn.g1_b3(()), jpts, jnp.asarray(s_np),
                              c=c, K=K)
    assert _affine(got) == _affine_of_jax(want) == [exp]


def _c14_case(known_multiples):
    """512 scalars with a triple duplicate, their limbs and the golden sum."""
    ms, pts_np = known_multiples
    ks = _rand_scalars(np.random.default_rng(14), len(ms))
    ks[3] = ks[4] = ks[5]
    exp = tbn.g1_generator() * (sum(k * m for k, m in zip(ks, ms)) % R)
    return np.asarray(jmsm.scalars_from_int(jbn.r_spec(), ks)), pts_np, exp


def test_msm_pippenger_c14_head_dense_matches_host(known_multiples, spans_entered):
    """c = 14 over 512 points: nearly every digit starts a bucket segment, the
    head-dense stream under which a step-0 flush corrupted buckets in the
    reference (myzkp_tpu/curves/msm.py:321-328).  The MSM runs in the
    Pippenger stages' spans, each once."""
    s_np, pts_np, exp = _c14_case(known_multiples)
    got = tmsm.msm_pippenger(tbn.g1_ops(), tbn.g1_b3((), DEV),
                             tw.Point(*interop.point_from_numpy(pts_np, DEV)),
                             interop.limbs_from_numpy(s_np, DEV), c=14)
    assert sorted(spans_entered) == sorted(["sort", "scan inputs", "scan", "lane merge",
                                            "bucket sum", "horner"])
    assert _affine(got) == [exp]


@pytest.mark.slow
def test_msm_pippenger_c14_matches_reference(known_multiples):
    """The c = 14 case against the JAX msm_pippenger as well; its CPU compile
    alone takes about 100 s, so this runs outside the fast suite."""
    s_np, pts_np, exp = _c14_case(known_multiples)
    got = tmsm.msm_pippenger(tbn.g1_ops(), tbn.g1_b3((), DEV),
                             tw.Point(*interop.point_from_numpy(pts_np, DEV)),
                             interop.limbs_from_numpy(s_np, DEV), c=14)
    want = jmsm.msm_pippenger(jbn.g1_ops(), jbn.g1_b3(()),
                              jw.Point(*(jnp.asarray(a) for a in pts_np)),
                              jnp.asarray(s_np), c=14)
    assert _affine(got) == _affine_of_jax(want) == [exp]


def test_msm_small_n_takes_naive_path():
    """msm() below the Pippenger threshold: zero, tiny, r-1 and duplicate
    scalars through msm_many's double-and-add ladder and a tree sum."""
    g1 = tbn.g1_generator()
    ks = [0, 1, 1, 2, R - 1, 0, 7, 7]
    pts = tbn.g1_points_to_device([g1 * (i + 1) for i in range(8)], DEV)
    exp = g1 * (sum(k * (i + 1) for i, k in enumerate(ks)) % R)
    got = tmsm.msm(tbn.g1_ops(), tbn.g1_b3((), DEV), pts,
                   tmsm.scalars_from_int(tbn.r_spec(), ks, DEV))
    assert _affine(got) == [exp]


def test_duplicate_real_flush_targets_raise():
    slots, num_buckets = 5, 4
    tmsm._check_unique_targets(torch.tensor([1, 4, 4, 9, 9, 2]), num_buckets, slots)
    with pytest.raises(RuntimeError):
        tmsm._check_unique_targets(torch.tensor([1, 2, 1]), num_buckets, slots)
