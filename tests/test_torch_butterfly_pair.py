"""Port parity: K5's pair form, ``limb.pow_dyn`` and ``scalar_mul_const``.

``ntt_kernels.butterfly_pair_ref`` (the plain version of K5's pair form) is
held to the JAX package's ``butterfly_pallas`` in interpret mode, both modes,
at L = 16 (F_r), 8 (M128) and 4 (M64), with 0, 1, p - 1, R mod p and the
word edges among the inputs; the wrapper on CPU tensors is the plain version.
``limb.pow_dyn`` (per-element exponent bits) and ``weierstrass.
scalar_mul_const`` (G1 and G2) are held to their JAX counterparts and to host
ints.  Inputs come from numpy seeds; tolerance 0: these are modular integers,
compared limb for limb.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.curves import weierstrass as jw
from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields import limb_pallas
from myzkp_tpu.fields.spec import FieldSpec as JSpec
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
from myzkp_tpu_torch.fields import spec as tspec

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

WIDTHS = {16: tspec.BN254_R, 8: tspec.M128, 4: tspec.M64}


def _word_edges(p: int, words: int) -> list:
    """0, 1, p - 1 and R mod p first, then the values below p whose 32-bit
    words are each 0 or all ones, each value once."""
    out = [sum(0xFFFFFFFF << (32 * k) for k in range(words) if bits >> k & 1)
           for bits in range(1 << words)]
    special = [0, 1, p - 1, (1 << (32 * words)) % p]
    return list(dict.fromkeys(special + [v for v in out if v < p]))


def _rand(rng: np.random.Generator, below: int, n: int) -> list:
    return [int.from_bytes(rng.bytes(40), "little") % below for _ in range(n)]


@pytest.mark.parametrize("dit", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("L", sorted(WIDTHS, reverse=True))
def test_butterfly_pair_matches_butterfly_pallas(L, dit):
    p = WIDTHS[L]
    rng = np.random.default_rng(L + 2 * dit)
    edges = _word_edges(p, L // 2)[:24]
    assert {0, 1, p - 1, (1 << (16 * L)) % p} <= set(edges)
    pairs = list(itertools.product(edges, repeat=2))
    extra = 64 + len(pairs) % 2  # an even n: the batch is (2, n / 2)
    n = len(pairs) + extra
    us = [a for a, _ in pairs] + _rand(rng, p, extra)
    vs = [b for _, b in pairs] + _rand(rng, p, extra)
    tws = [edges[int(k)] for k in rng.integers(0, len(edges), len(pairs))] + _rand(rng, p, extra)
    tspec_ = tspec.FieldSpec.make(p)
    jspec = JSpec.make(p)
    u, v, t = (limb.from_int(tspec_, x, DEV).reshape(L, 2, n // 2) for x in (us, vs, tws))
    su, sv = nk.butterfly_pair(tspec_, u, v, t, dit)
    ref = nk.butterfly_pair_ref(tspec_, u, v, t, dit)
    ju, jv, jt = (jnp.asarray(interop.limbs_to_numpy(x)) for x in (u, v, t))
    want = limb_pallas.butterfly_pallas(jspec, ju, jv, jt, dit, interpret=True)
    for got, r, w in zip((su, sv), ref, want):
        assert got.shape == (L, 2, n // 2)
        np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(w))
        assert torch.equal(got, r)
    # and the host's integers (Montgomery product: x y R^-1)
    rinv = pow(1 << (16 * L), -1, p)
    hu, hv = (limb.to_int(tspec_, x).reshape(-1) for x in (su, sv))
    for k in range(n):
        a, b, w = us[k], vs[k], tws[k]
        if dit:
            bw = b * w * rinv % p
            assert (hu[k], hv[k]) == ((a + bw) % p, (a - bw) % p)
        else:
            assert (hu[k], hv[k]) == ((a + b) % p, (a - b) * w * rinv % p)


def test_butterfly_pair_refuses_mismatched_shapes():
    s = tspec.bn254_r_spec()
    u = limb.zeros(s, (4,), DEV)
    with pytest.raises(ValueError):
        nk.butterfly_pair(s, u, limb.zeros(s, (5,), DEV), u, False)
    with pytest.raises(ValueError):
        nk.butterfly_pair(s, u, u, limb.zeros(s, (1,), DEV), True)


@pytest.mark.parametrize("p", [tspec.BN254_R, tspec.M128])
def test_pow_dyn_matches_reference(p):
    rng = np.random.default_rng(p % 1000)
    spec, jspec = tspec.FieldSpec.make(p), JSpec.make(p)
    nbits = p.bit_length()
    xs = [0, 1, p - 1, (1 << (16 * spec.L)) % p] + _rand(rng, p, 12)
    es = [0, 1, p - 2, (1 << nbits) - 1] + _rand(rng, 1 << nbits, 12)
    bits = np.array([[(e >> i) & 1 for e in es] for i in range(nbits)], dtype=np.uint32)
    a = limb.to_mont(spec, limb.from_int(spec, xs, DEV))
    got = limb.pow_dyn(spec, a, torch.from_numpy(bits.astype(np.int32)))
    ja = jnp.asarray(interop.limbs_to_numpy(a))
    want = jlimb.pow_dyn(jspec, ja, jnp.asarray(bits))
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))
    host = limb.to_int(spec, limb.from_mont(spec, got))
    assert list(host) == [pow(x, e, p) for x, e in zip(xs, es)]
    # no bits: one everywhere, as the reference's empty scan
    one = limb.pow_dyn(spec, a, torch.zeros((0, len(xs)), dtype=torch.int32))
    assert list(limb.to_int(spec, limb.from_mont(spec, one))) == [1] * len(xs)


def _points(group: str, ms: list):
    if group == "g1":
        return (tbn.g1_ops(), tbn.g1_b3((), DEV), tbn.g1_generator(),
                tbn.g1_points_to_device([tbn.g1_generator() * m for m in ms], DEV),
                tbn.g1_points_to_host, jbn.g1_ops(), jbn.g1_b3(()))
    return (tbn.g2_ops(), tbn.g2_b3((), DEV), tbn.g2_generator(),
            tbn.g2_points_to_device([tbn.g2_generator() * m for m in ms], DEV),
            tbn.g2_points_to_host, jbn.g2_ops(), jbn.g2_b3(()))


E254 = (1 << 253) + 0x5EED_C0FFEE_1234_5678_9ABC_DEF0_1357_9BDF_2468_ACE0


def _scalar_mul_case(group: str, e: int, against_jax: bool):
    ms = [1, 7, tbn.R - 1]
    F, b3, gen, pts, to_host, jF, jb3 = _points(group, ms)
    got = tw.scalar_mul_const(F, b3, pts, e)
    assert to_host(got) == [gen * (m * e % tbn.R) for m in ms]
    if against_jax:
        leaves = interop.point_to_numpy(pts)
        jpts = (jw.Point(*(jnp.asarray(a) for a in leaves)) if group == "g1" else
                jw.Point(*((jnp.asarray(leaves[k]), jnp.asarray(leaves[k + 1]))
                           for k in (0, 2, 4))))
        want = jw.scalar_mul_const(jF, jb3, jpts, e)
        flat = [np.asarray(a) for a in (want if group == "g1" else
                                        [c for coord in want for c in coord])]
        for g_, w_ in zip(interop.point_to_numpy(got), flat):
            np.testing.assert_array_equal(g_, w_)


@pytest.mark.parametrize("e", [0, 1, 2, E254], ids=["0", "1", "2", "254bit"])
def test_scalar_mul_const_g1_matches_reference(e):
    _scalar_mul_case("g1", e, True)


@pytest.mark.parametrize("e", [0, E254], ids=["0", "254bit"])
def test_scalar_mul_const_g2_matches_reference(e):
    """The JAX G2 ladder costs ~15-19 s of XLA compile for each exponent
    length, so e = 1 and 2 are held to the host here and to the JAX package
    in the slow test below."""
    _scalar_mul_case("g2", e, True)


@pytest.mark.parametrize("e", [1, 2])
def test_scalar_mul_const_g2_small_matches_host(e):
    _scalar_mul_case("g2", e, False)


@pytest.mark.slow
@pytest.mark.parametrize("e", [1, 2])
def test_scalar_mul_const_g2_small_matches_reference(e):
    _scalar_mul_case("g2", e, True)


def test_scalar_mul_const_refuses_negative_exponent():
    F, b3, _, pts, *_ = _points("g1", [3])
    with pytest.raises(ValueError):
        tw.scalar_mul_const(F, b3, pts, -1)
