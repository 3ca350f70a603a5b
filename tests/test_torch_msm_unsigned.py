"""Port parity: ``msm_pippenger`` on unsigned digits, with a caller's G, and
at c = 1 (where c < 2 runs unsigned, as the JAX package does).

The JAX comparison at n = 64, c = 4 comes first: the JAX package's
unsigned Pippenger compiles for about 30 s on the CPU, and the test files
run in parallel.  The other cases (the JAX package's own test cases (509,
8, 64) and (512, 13, None, 3), and c = 14, the window of the step-0 flush
fault) are held to host goldens [sum k_i m_i mod r]G with points m_i G.
MSM results differ from the JAX package's in projective representative, so
points are compared as affine integers; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import msm as jmsm
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import msm as tmsm
from myzkp_tpu_torch.curves import weierstrass as tw

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

R = tbn.R


def _case(group: str, n: int, seed: int):
    """Points [i + 1]G (one host add each), numpy-seeded scalars with a zero
    and a duplicate, their limbs, and the golden sum."""
    gen = tbn.g2_generator() if group == "g2" else tbn.g1_generator()
    hosts, acc = [], gen
    for _ in range(n):
        hosts.append(acc)
        acc = acc + gen
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 5, 5
    exp = gen * (sum(k * (i + 1) for i, k in enumerate(ks)) % R)
    if group == "g2":
        ops = (tbn.g2_ops(), tbn.g2_b3((), DEV), tbn.g2_points_to_device(hosts, DEV))
    else:
        ops = (tbn.g1_ops(), tbn.g1_b3((), DEV), tbn.g1_points_to_device(hosts, DEV))
    return ops, tmsm.scalars_from_int(tbn.r_spec(), ks, DEV), exp


def _affine(group: str, pt) -> list:
    one = tw.point_map(lambda a: a[:, None], pt)
    return (tbn.g2_points_to_host if group == "g2" else tbn.g1_points_to_host)(one)


def _affine_of_jax(pt) -> list:
    return tbn.g1_points_to_host(tw.Point(*interop.point_from_numpy(
        [np.asarray(a)[:, None] for a in pt], DEV)))


@pytest.mark.parametrize("n,c", [(64, 4), (6, 1)])
def test_unsigned_msm_matches_reference(n, c):
    """signed=False at c = 4, and c = 1, which the port refused before: the
    port's point equals the JAX package's and the host golden."""
    (F, b3, pts), s, exp = _case("g1", n, seed=n + c)
    got = tmsm.msm_pippenger(F, b3, pts, s, c=c, signed=False)
    jpts = jw.Point(*(jnp.asarray(a) for a in interop.point_to_numpy(pts)))
    want = jmsm.msm_pippenger(jbn.g1_ops(), jbn.g1_b3(()), jpts,
                              jnp.asarray(interop.limbs_to_numpy(s)), c=c, signed=False)
    assert _affine("g1", got) == _affine_of_jax(want) == [exp]
    if c == 1:  # c < 2 runs unsigned whatever signed says, as the reference
        assert _affine("g1", tmsm.msm_pippenger(F, b3, pts, s, c=1)) == [exp]


def test_default_window_unsigned_matches_reference():
    for n in (8, 509, 512, 1 << 16, 1 << 20):
        for signed in (True, False):
            assert tmsm.default_window(n, signed) == jmsm.default_window(n, signed=signed)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_unsigned_msm_odd_n_matches_host(group):
    """The JAX package's (509, 8, 64) case on unsigned digits: n padded to a
    multiple of K, scatter targets unique; a caller's G above W = 32 capped
    at W; and msm() passes c, K, G and signed through."""
    (F, b3, pts), s, exp = _case(group, 509, seed=509)
    got = tmsm.msm_pippenger(F, b3, pts, s, c=8, K=64, G=64, signed=False)
    assert _affine(group, got) == [exp]
    if group == "g1":
        assert _affine(group, tmsm.msm(F, b3, pts, s, c=8, K=64, signed=False)) == [exp]


def test_unsigned_msm_c14_caller_group_g1_matches_host():
    """c = 14 on unsigned digits (2^14 buckets a window): nearly every digit
    starts a bucket segment, the stream of the reference's step-0 flush
    fault; with a caller's G = 3 over W = 19 windows (W_pad % G != 0, as the
    JAX package's (512, 13, None, 3) case)."""
    (F, b3, pts), s, exp = _case("g1", 512, seed=14)
    got = tmsm.msm_pippenger(F, b3, pts, s, c=14, G=3, signed=False)
    assert _affine("g1", got) == [exp]


@pytest.mark.slow
@pytest.mark.parametrize("group,c,G", [("g1", 13, 3), ("g2", 13, 3), ("g2", 14, 3)])
def test_unsigned_msm_wide_window_matches_host(group, c, G):
    """The JAX package's (512, 13, None, 3) case in both groups, and the G2
    instance of the c = 14 case above (about 30 s in G1 and 100 s in G2 on
    the CPU: the plain group law over 2^13 or 2^14 buckets a window)."""
    (F, b3, pts), s, exp = _case(group, 512, seed=c)
    assert _affine(group, tmsm.msm_pippenger(F, b3, pts, s, c=c, G=G, signed=False)) == [exp]


def test_msm_pippenger_refuses_an_empty_group():
    (F, b3, pts), s, _ = _case("g1", 4, seed=4)
    with pytest.raises(ValueError):
        tmsm.msm_pippenger(F, b3, pts, s, c=4, G=0)
    with pytest.raises(ValueError):
        tmsm.msm_pippenger(F, b3, pts, s, c=0)
