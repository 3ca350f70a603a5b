"""Port parity of the extension fields and of K1 at M64's two words:
myzkp_tpu_torch.fields.efield against myzkp_tpu.fields.efield.

The same seeded inputs go through both packages (the JAX package's
Montgomery limb arrays carried across by ``interop.efield_from_numpy``);
outputs must agree limb for limb (modular integers: the tolerance is 0).
On the CPU the port runs K1's plain version at L = 4, held here to the TPU
kernel in interpret mode on every pair of the two-word edges.  Every port
constructor is given an explicit CPU device.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.fields import efield as jefield
from myzkp_tpu.fields import limb_pallas
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import BN254_Q, M64, FieldSpec
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields import efield, limb

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) share the cores
torch.set_num_threads(1)
SPEC, JSPEC = FieldSpec.make(M64), FieldSpec.make(M64)
R = 1 << 64
# the two-word edges (chip_smoke.word_edges(M64, 2)): each 32-bit word 0 or
# all ones below p; p - 1, 1, R mod p; and past R / 2 (M64 has no spare bit)
EDGES = [0, (1 << 32) - 1, R - (1 << 32), M64 - 1, 1, R % M64, 1 << 63, (1 << 63) + 1,
         (1 << 63) + (1 << 32) - 1, M64 - 2]
N = 16


def _mont_np(vals) -> np.ndarray:
    """Host ints -> (4, *shape) uint32 Montgomery limbs, by the JAX package."""
    return np.asarray(JFp.from_int(JSPEC, vals).mont)


def _coeffs(n: int, seed: int, zero_at=()) -> list:
    rng = random.Random(seed)
    out = [[rng.randrange(M64) for _ in range(3)] for _ in range(n)]
    for i in zero_at:
        out[i] = [0, 0, 0]
    return out


@pytest.fixture(scope="module")
def cubic():
    """The M64 cubic in both packages and two seeded batches of N elements
    (element 3 of the first is 0): (port a, b; JAX a, b)."""
    es, jes = efield.m64_cubic(), jefield.m64_cubic()
    ja = jefield.from_int_coeffs(jes, _coeffs(N, 1, zero_at=(3,)))
    jb = jefield.from_int_coeffs(jes, _coeffs(N, 2))
    a = interop.efield_from_numpy(es, np.asarray(ja), DEV)
    b = interop.efield_from_numpy(es, np.asarray(jb), DEV)
    return es, jes, a, b, ja, jb


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))


def test_mont_mul_ref_m64_matches_pallas_interpret():
    """K1's plain version at L = 4 against the TPU kernel in interpret mode
    and the host: every pair of the two-word edges, then random pairs."""
    rng = random.Random(3)
    av = [x for x in EDGES for _ in EDGES] + [rng.randrange(M64) for _ in range(100)]
    bv = [y for _ in EDGES for y in EDGES] + [rng.randrange(M64) for _ in range(100)]
    a, b = _mont_np(av), _mont_np(bv)
    want = limb_pallas.mont_mul_pallas(JSPEC, jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = limb.mont_mul(SPEC, interop.limbs_from_numpy(a, DEV), interop.limbs_from_numpy(b, DEV))
    _same(got, want)
    std = limb.to_int(SPEC, limb.from_mont(SPEC, got))
    assert [int(v) for v in std] == [x * y % M64 for x, y in zip(av, bv)]


def test_pow_const_m64_matches_host():
    """K1's chain's plain version at L = 4 (the base field's pow_const and
    inv, edges included) against the host."""
    xs = EDGES + [random.Random(4).randrange(M64) for _ in range(6)]
    a = interop.limbs_from_numpy(_mont_np(xs), DEV)
    for e in (0, 1, 2, M64 - 2, (1 << 64) + 12345):
        got = limb.to_int(SPEC, limb.from_mont(SPEC, limb.pow_const(SPEC, a, e)))
        assert [int(v) for v in got] == [pow(x, e, M64) for x in xs], e
    assert limb.to_int(SPEC, limb.from_mont(SPEC, limb.inv(SPEC, a)))[0] == 0


def test_ring_ops_match_jax(cubic):
    """add, sub, neg, mul, sqr, scale, eq, is_zero, select at N = 16."""
    es, jes, a, b, ja, jb = cubic
    _same(efield.add(es, a, b), jefield.add(jes, ja, jb))
    _same(efield.sub(es, a, b), jefield.sub(jes, ja, jb))
    _same(efield.neg(es, a), jefield.neg(jes, ja))
    _same(efield.mul(es, a, b), jefield.mul(jes, ja, jb))
    _same(efield.sqr(es, a), jefield.sqr(jes, ja))
    _same(efield.scale(es, a, b[1]), jefield.scale(jes, ja, jb[1]))
    np.testing.assert_array_equal(efield.is_zero(es, a).numpy(),
                                  np.asarray(jefield.is_zero(jes, ja)))
    np.testing.assert_array_equal(efield.eq(es, a, a).numpy(), np.ones(N, dtype=bool))
    mask = efield.is_zero(es, a)
    _same(efield.select(mask, b, a), jefield.select(jnp.asarray(mask.numpy()), jb, ja))


def test_mul_broadcasts_like_jax(cubic):
    """A (k, L) constant times a batch, and a (k, L, 4, 1) batch times a
    (k, L, 3) one."""
    es, jes, a, b, ja, jb = cubic
    _same(efield.mul(es, a[:, :, 5], b), jefield.mul(jes, ja[:, :, 5], jb))
    x, y = a[:, :, :4, None], b[:, :, :3]
    _same(efield.mul(es, x, y), jefield.mul(jes, ja[:, :, :4, None], jb[:, :, :3]))


def test_inv_and_pow_match_jax(cubic):
    """inv (a zero among the inputs: inv(0) = 0) and pow_const at e = 0, 1,
    2, 12345 against the JAX package; a * inv(a) = 1 where a != 0."""
    es, jes, a, b, ja, jb = cubic
    ainv = efield.inv(es, a)
    _same(ainv, jefield.inv(jes, ja))
    assert not ainv[:, :, 3].any()
    prod = efield.to_int_coeffs(es, efield.mul(es, a, ainv))
    assert [list(map(int, r)) for i, r in enumerate(prod) if i != 3] == [[1, 0, 0]] * (N - 1)
    for e in (0, 1, 2, 12345):
        _same(efield.pow_const(es, b, e), jefield.pow_const(jes, jb, e))
    _same(efield.inv(es, efield.zeros(es, (4,), DEV)), np.zeros((3, 4, 4), np.uint32))


def test_inv_launch_plan(cubic, monkeypatch):
    """inv of the M64 cubic is 384 K1 calls (192 bits, two a mul), and a
    mul is two."""
    es, _, a, b, _, _ = cubic
    calls = []
    real = limb.mont_mul
    monkeypatch.setattr(limb, "mont_mul", lambda *args: calls.append(1) or real(*args))
    efield.mul(es, a, b)
    assert len(calls) == 2
    calls.clear()
    efield.inv(es, a[:, :, :2])
    assert len(calls) == 2 * (M64 ** 3 - 2).bit_length() == 384


def test_bn254_fq2_matches_karatsuba():
    """The generic Fq2 = Fq[u]/(u^2 + 1) against the port's Karatsuba
    ``Fq2Ops.mul`` and the JAX package's generic Fq2."""
    es, jes = efield.bn254_fq2(), jefield.bn254_fq2()
    rng = random.Random(5)
    av = [[rng.randrange(BN254_Q) for _ in range(2)] for _ in range(8)]
    bv = [[rng.randrange(BN254_Q) for _ in range(2)] for _ in range(8)]
    a, b = efield.from_int_coeffs(es, av, DEV), efield.from_int_coeffs(es, bv, DEV)
    got = efield.mul(es, a, b)
    ref = bn254.g2_ops().mul((a[0], a[1]), (b[0], b[1]))
    assert torch.equal(got, torch.stack(ref))
    _same(got, jefield.mul(jes, jefield.from_int_coeffs(jes, av),
                           jefield.from_int_coeffs(jes, bv)))


def test_efield_from_numpy_round_trip(cubic):
    """The JAX package's (k, L, n) array carried across and back; the
    port's own constructors and host conversion equal the JAX package's."""
    es, jes, a, _, ja, _ = cubic
    _same(a, ja)
    vals = _coeffs(N, 1, zero_at=(3,))
    _same(efield.from_int_coeffs(es, vals, DEV), ja)
    assert efield.to_int_coeffs(es, a).tolist() == jefield.to_int_coeffs(jes, ja).tolist()
    _same(efield.one(es, (2,), DEV), jefield.one(jes, (2,)))
    with pytest.raises(ValueError):
        interop.efield_from_numpy(efield.bn254_fq2(), np.asarray(ja), DEV)
