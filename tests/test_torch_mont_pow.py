"""Port parity: K1's chain (a^e for a host exponent) and the inversions built
on it, myzkp_tpu_torch against myzkp_tpu.fields.limb.

The same numpy-seeded Montgomery limb arrays go through both packages (via
interop); outputs must agree limb for limb (modular integers: the tolerance
is 0).  On the CPU the port's ``pow_const`` runs the chain's plain version
``mont_pow_ref``; the chain kernel itself runs on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields.spec import BN254_Q, BN254_R, FieldSpec
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import spec as tspec

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

FIELDS = {"q": BN254_Q, "r": BN254_R}
SEED = 8


def _exponents(p: int) -> dict:
    rng = np.random.default_rng(SEED)
    e256 = int.from_bytes(rng.bytes(32), "little") | 1 << 255
    return {"0": 0, "1": 1, "2": 2, "3": 3, "p-2": p - 2, "random256": e256}


def _inputs(p: int, n_random: int = 4):
    """Montgomery limbs (numpy, by the JAX package) of 0, 1, p - 1, R mod p
    and n_random seeded values, and the values themselves."""
    rng = np.random.default_rng(SEED + 1)
    vals = [0, 1, p - 1, (1 << 256) % p] + [
        int.from_bytes(rng.bytes(40), "little") % p for _ in range(n_random)]
    spec = FieldSpec.make(p)
    return np.asarray(jlimb.to_mont(spec, jlimb.from_int(spec, vals))), vals


def _same(got_torch, want_jax):
    np.testing.assert_array_equal(interop.limbs_to_numpy(got_torch),
                                  np.asarray(want_jax))


@pytest.mark.parametrize("e_name", list(_exponents(BN254_Q)))
@pytest.mark.parametrize("field", list(FIELDS))
def test_pow_const_matches_reference(field, e_name):
    """pow_const (the chain's plain version on the CPU) and mont_pow_ref
    against the JAX package's pow_const and the host's pow(x, e, p)."""
    p = FIELDS[field]
    e = _exponents(p)[e_name]
    a_np, vals = _inputs(p)
    spec = tspec.FieldSpec.make(p)
    a = interop.limbs_from_numpy(a_np, DEV)
    want = jlimb.pow_const(FieldSpec.make(p), a_np, e)
    got = tlimb.pow_const(spec, a, e)
    _same(got, want)
    _same(tlimb.mont_pow_ref(spec, a, e), want)
    host = tlimb.to_int(spec, tlimb.from_mont(spec, got))
    assert [int(v) for v in host] == [pow(x, e, p) for x in vals]


@pytest.mark.parametrize("field", list(FIELDS))
def test_inv_and_batch_inv_with_zeros_match_reference(field):
    """inv (one chain) and batch_inv along a batch axis, zeros among the
    inputs (inv(0) = 0), against the JAX package."""
    p = FIELDS[field]
    a_np, vals = _inputs(p, n_random=12)
    a_np = a_np.reshape(16, 2, 8)
    jspec, spec = FieldSpec.make(p), tspec.FieldSpec.make(p)
    a = interop.limbs_from_numpy(a_np, DEV)
    _same(tlimb.inv(spec, a), jlimb.inv(jspec, a_np))
    for axis in (1, -1):
        _same(tlimb.batch_inv(spec, a, axis=axis), jlimb.batch_inv(jspec, a_np, axis=axis))
    inv = tlimb.to_int(spec, tlimb.from_mont(spec, tlimb.inv(spec, a))).reshape(-1)
    assert [int(v) for v in inv] == [pow(x, p - 2, p) for x in vals]


def test_exponent_words_pack_little_endian():
    """The chain's exponent: eight little-endian 32-bit words and the bit
    length, in the layout of struct Exponent (csrc/mont_mul.cu)."""
    assert _ext.exponent_words(0) == ((0,) * 8, 0)
    assert _ext.exponent_words(1) == ((1,) + (0,) * 7, 1)
    assert _ext.exponent_words(1 << 32) == ((0, 1) + (0,) * 6, 33)
    assert _ext.exponent_words((1 << 256) - 1) == ((0xFFFFFFFF,) * 8, 256)
    rng = np.random.default_rng(SEED + 2)
    for _ in range(20):
        e = int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 256))
        words, nbits = _ext.exponent_words(e)
        assert all(0 <= w < 1 << 32 for w in words)
        assert sum(w << (32 * k) for k, w in enumerate(words)) == e
        assert nbits == e.bit_length()
        packed = _ext.exponent(e)
        assert list(packed.w) == list(words) and packed.nbits == nbits


@pytest.mark.parametrize("e", [-1, 1 << 256])
def test_exponent_out_of_range_raises(e):
    spec = tspec.FieldSpec.make(BN254_Q)
    with pytest.raises(ValueError):
        _ext.exponent_words(e)
    with pytest.raises(ValueError):
        tlimb.pow_const(spec, tlimb.one_mont(spec, (2,), DEV), e)


@pytest.mark.parametrize("b_batch,shape,period", [
    ((1, 1), (3, 64), 1),            # the 1/n constant
    ((64,), (3, 64), 64),            # coset offsets against a batch of 3
    ((8, 8, 1), (3, 8, 8, 1), 64),   # the four-step level table against E = 3
    ((1,), (64,), 1),                # to_mont / from_mont columns
    ((), (5,), 1),                   # a scalar operand
    ((3, 64), (3, 64), 192),         # no broadcast: the period is n
    ((8, 8, 1), (3, 8, 8, 4), None),  # broadcast along a trailing axis
    ((1, 64), (3, 64), 64),
    ((3, 1), (3, 64), None),
])
def test_leading_period(b_batch, shape, period):
    """K1 reads b in place with a period exactly when b is broadcast along
    leading batch axes only; any other broadcast is materialized."""
    b = torch.zeros((16,) + b_batch, dtype=torch.int32)
    assert tlimb._leading_period(b, shape) == period
