"""Port parity: the NTT of myzkp_tpu_torch against myzkp_tpu.ops.ntt.

The same numpy-seeded Montgomery limb arrays go through both packages (via
interop); outputs must agree limb for limb (modular integers: the tolerance
is 0).  On the CPU the port runs the plain versions of kernels K5
(``butterfly``: up to log2 r Stockham stages a call, r =
``ntt_kernels.k5_radix()``) and K6 (``ntt_leaf``).  BN254's scalar field r unless a case
says otherwise; the 32-bit prime 3221225473 (L = 2) keeps the JAX package's
four-step compiles short where BN254 would not.
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.fields import limb_pallas
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import BN254_R, FieldSpec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import ntt_kernels as tnk
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops import ntt as tntt

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
P32 = 3221225473


def _mont_np(p: int, vals) -> np.ndarray:
    """Host ints -> (L, *shape) uint32 Montgomery limbs, by the JAX package."""
    return np.asarray(JFp.from_int(FieldSpec.make(p), vals).mont)


def _rand(p: int, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % p
            for _ in range(int(np.prod(shape)))]
    return _mont_np(p, np.asarray(vals, dtype=object).reshape(shape))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))


def test_butterfly_ref_matches_pallas_interpret():
    """K5's plain version against the TPU kernel in interpret mode (DIF) on
    64 pairs, the first 16 the crossed edges 0, 1, r - 1, R mod r."""
    p = BN254_R
    rng = random.Random(5)
    edges = [0, 1, p - 1, (1 << 256) % p]
    uv = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(48)]
    vv = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(48)]
    u, v = _mont_np(p, uv), _mont_np(p, vv)
    tw = _rand(p, (64,), 6)
    su, sv = limb_pallas.butterfly_pallas(FieldSpec.make(p), jnp.asarray(u),
                                          jnp.asarray(v), jnp.asarray(tw), False,
                                          interpret=True)
    x = interop.limbs_from_numpy(np.concatenate([u, v], axis=1), DEV)
    out = tnk.butterfly_ref(tspec.FieldSpec.make(p), x.reshape(16, 1, 1, 128, 1),
                            interop.limbs_from_numpy(tw, DEV))
    _same(out[:, 0, 0, :, 0], su)
    _same(out[:, 0, 1, :, 0], sv)


@pytest.fixture
def radix():
    """Set K5's r (MYZKP_K5_RADIX) for the test, as a build would, and
    restore the definitions after it."""
    before = _ext._defines

    def use(r: int) -> None:
        _ext.use_defines((f"MYZKP_K5_RADIX={r}",))
        assert tnk.k5_radix() == r

    yield use
    _ext.use_defines(before)


def test_k5_radix_default_is_the_sources():
    """ntt_kernels.K5_RADIX, the r of the plain path when no -D sets it, is
    csrc/ntt.cu's own default."""
    src = (Path(tntt.__file__).parents[1] / "csrc" / "ntt.cu").read_text()
    assert int(re.search(r"#define MYZKP_K5_RADIX (\d+)", src).group(1)) == tnk.K5_RADIX
    assert _ext.defined("MYZKP_K5_RADIX", tnk.K5_RADIX) == tnk.K5_RADIX


def _one_stage_chain(spec, y, m: int, s0: int, stages: int, inv: bool):
    for s in range(s0, s0 + stages):
        y = tnk.butterfly_ref(spec, y, tntt._pass_twiddles(spec, m, s, 1, inv, DEV))
    return y


@pytest.mark.parametrize("per", [1, 2, 3])
@pytest.mark.parametrize("m,R,B", [(16, 1, 1), (32, 3, 2), (64, 1, 2), (128, 3, 1),
                                   (256, 1, 1), (512, 3, 2)])
def test_butterfly_ref_passes_equal_one_stage_chain(m, R, B, per):
    """K5's plain version over passes of ``per`` stages (the last pass shorter
    where per does not divide log2 m: m = 2^4, 2^5, 2^7, 2^8 at per = 3)
    equals the one-stage plain versions run one after another over the same
    stage rows, pass by pass, on the pass's concatenated table."""
    spec = tspec.FieldSpec.make(BN254_R)
    y = interop.limbs_from_numpy(_rand(BN254_R, (R, m, B), m * 10 + R + per), DEV)
    y = y.reshape(16, R, 1, m, B)
    total = m.bit_length() - 1
    for s0 in range(0, total, per):
        s = min(per, total - s0)
        tw = tntt._pass_twiddles(spec, m, s0, s, False, DEV)
        c = y.shape[3]
        assert tw.shape == (16, c - (c >> s))
        got = tnk.butterfly_ref(spec, y, tw, s)
        assert torch.equal(got, _one_stage_chain(spec, y, m, s0, s, False))
        assert got.shape == (16, R, y.shape[2] << s, c >> s, B)
        y = got


def test_butterfly_ref_refuses_a_stage_count_the_block_cannot_hold():
    spec = tspec.FieldSpec.make(BN254_R)
    x = interop.limbs_from_numpy(_rand(BN254_R, (1, 1, 8, 1), 3), DEV)
    for bad in (0, 4):
        with pytest.raises(ValueError):
            tnk.butterfly_ref(spec, x, tntt._leaf_twiddles(spec, 8, False, DEV), bad)


@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("m,R,B", [(16, 1, 1), (128, 3, 2), (512, 2, 1)])
def test_stockham_axis_matches_reference(m, R, B, r, radix):
    """The port's Stockham transform (passes of log2 r stages, K5's plain
    version) against the JAX package's per-stage pass on the CPU, forward
    and inverse, with the edge values 0, 1, r - 1 and R mod r among the
    inputs."""
    radix(r)
    p = BN254_R
    x_np = _rand(p, (R, m, B), 7 * m + R).copy()
    edges = _mont_np(p, [0, 1, p - 1, (1 << 256) % p])
    x_np[:, 0, :4, 0] = edges
    x_np[:, R - 1, m - 4:, B - 1] = edges[:, ::-1]
    x = interop.limbs_from_numpy(x_np, DEV)
    spec, jspec = tspec.FieldSpec.make(p), FieldSpec.make(p)
    for inv in (False, True):
        _same(tntt._stockham_axis(spec, x, m, inv),
              jntt._stockham_axis(jspec, jnp.asarray(x_np), m, inv))


@pytest.mark.parametrize("r", [2, 4, 8, 16, 32])
def test_butterfly_calls_per_transform(r, radix, monkeypatch):
    """ntt and intt below the four-step size call ntt_kernels.butterfly
    ceil(log2 m / log2 r) times a transform, each call with the pass's stage
    count: log2 r but the last (r = 8: shifted h at m = 2^12 makes 4 + 5 + 5
    = 14 calls, fast_multiply of 2^8-coefficient inputs 3 x 3 = 9)."""
    radix(r)
    calls = []
    real = tnk.butterfly

    def counted(spec, x, tw, stages=1):
        calls.append(stages)
        return real(spec, x, tw, stages)

    monkeypatch.setattr(tnk, "butterfly", counted)
    spec = tspec.FieldSpec.make(BN254_R)
    per = r.bit_length() - 1
    for log_m in (1, 4, 9, 12, 13):
        a = Fp(spec, interop.limbs_from_numpy(_rand(BN254_R, (1 << log_m,), log_m), DEV))
        for transform in (tntt.ntt, tntt.intt):
            calls.clear()
            transform(a)
            assert len(calls) == -(-log_m // per), (r, log_m, calls)
            assert sum(calls) == log_m and all(s == per for s in calls[:-1])
    assert [len(tntt._stockham_passes(1 << k)) for k in (12, 13, 13, 9)] == (
        [4, 5, 5, 3] if r == 8 else [-(-k // per) for k in (12, 13, 13, 9)])


@pytest.mark.parametrize("m,E,B", [(16, 2, 64), (64, 1, 128), (128, 1, 130)])
def test_ntt_leaf_ref_matches_stockham(m, E, B):
    """K6's plain version against the reference's per-stage Stockham pass
    (the golden path tests/test_pallas.py holds the TPU leaf kernel to),
    forward and inverse."""
    p = BN254_R
    x_np = _rand(p, (E, m, B), m * 1000 + B)
    x = interop.limbs_from_numpy(x_np, DEV)
    spec = tspec.FieldSpec.make(p)
    for inv in (False, True):
        got = tnk.ntt_leaf(spec, x, tntt._leaf_twiddles(spec, m, inv, DEV))
        _same(got, jntt._stockham_axis(FieldSpec.make(p), jnp.asarray(x_np), m, inv))


def test_ntt_leaf_ref_matches_pallas_interpret():
    """K6's plain version against the TPU leaf kernel in interpret mode at the
    32-bit prime (L = 2), m = 16, forward and inverse."""
    m, E, B = 16, 2, 64
    x_np = _rand(P32, (E, m, B), 77)
    spec = tspec.FieldSpec.make(P32)
    for inv in (False, True):
        tw = jnp.asarray(jntt._leaf_twiddles_np(FieldSpec.make(P32), m, inv))
        want = limb_pallas.ntt_leaf_pallas(FieldSpec.make(P32), jnp.asarray(x_np),
                                           tw, m, True)
        got = tnk.ntt_leaf_ref(spec, interop.limbs_from_numpy(x_np, DEV),
                               tntt._leaf_twiddles(spec, m, inv, DEV))
        _same(got, want)


@pytest.mark.parametrize("m", [2, 16, 128])
def test_ntt_leaf_ref_stages_equal_butterfly_stages(m):
    """K6's plain version with stages = s equals s K5 stages (butterfly_ref)
    run one after another on the same table rows, for s = 1 .. log2 m."""
    p, E, B = BN254_R, 2, 3
    spec = tspec.FieldSpec.make(p)
    x = interop.limbs_from_numpy(_rand(p, (E, m, B), 31 + m), DEV)
    tw = tntt._leaf_twiddles(spec, m, False, DEV)
    y, off, h = x.reshape(16, E, 1, m, B), 0, m // 2
    for s in range(1, m.bit_length()):
        y = tnk.butterfly_ref(spec, y, tw[:, off:off + h])
        off, h = off + h, h // 2
        assert torch.equal(tnk.ntt_leaf_ref(spec, x, tw, s), y.reshape(16, E, m, B))
    for bad in (0, m.bit_length()):
        with pytest.raises(ValueError):
            tnk.ntt_leaf_ref(spec, x, tw, bad)


def test_ntt_leaf_ref_all_stages_matches_pallas_interpret():
    """K6's plain version with stages = log2 m named explicitly against the
    TPU leaf kernel in interpret mode, as the test above it runs it."""
    m, E, B = 16, 2, 64
    x_np = _rand(P32, (E, m, B), 78)
    spec = tspec.FieldSpec.make(P32)
    for inv in (False, True):
        tw = jnp.asarray(jntt._leaf_twiddles_np(FieldSpec.make(P32), m, inv))
        want = limb_pallas.ntt_leaf_pallas(FieldSpec.make(P32), jnp.asarray(x_np),
                                           tw, m, True)
        got = tnk.ntt_leaf_ref(spec, interop.limbs_from_numpy(x_np, DEV),
                               tntt._leaf_twiddles(spec, m, inv, DEV), stages=4)
        _same(got, want)


@pytest.mark.parametrize("inv", [False, True])
def test_leaf_twiddle_rows_start_with_one(inv):
    """K6 skips the products by entry j = 0 of every stage row that starts
    with 1 (R mod p, Montgomery): each row of the tables ops/ntt.py gives it
    does, so the paths' leaves skip them all."""
    spec = tspec.FieldSpec.make(BN254_R)
    one = torch.tensor(spec.one_limbs, dtype=torch.int32)
    for m in (2, 4, 8, 16, 32, 64, 128):
        tw = tntt._leaf_twiddles(spec, m, inv, DEV)
        h = m // 2
        while h >= 1:
            assert torch.equal(tw[:, m - 2 * h], one), (m, h)
            h //= 2


def _ntt_case(p: int, shape, seed: int):
    a_np = _rand(p, shape, seed)
    return (Fp(tspec.FieldSpec.make(p), interop.limbs_from_numpy(a_np, DEV)),
            JFp(FieldSpec.make(p), jnp.asarray(a_np)))


@pytest.mark.parametrize("p,shape", [(BN254_R, (1 << 6,)), (BN254_R, (3, 1 << 6)),
                                     (BN254_R, (1 << 14,)), (P32, (2, 1 << 14))],
                         ids=["r-2^6", "r-3x2^6", "r-2^14", "p32-2x2^14"])
def test_ntt_intt_match_reference(p, shape):
    """ntt / intt at the Stockham size (K5 stages) and at the four-step size
    (K6 leaves, tables, transposes), with batched lead dims."""
    a, ja = _ntt_case(p, shape, len(shape) * 100 + shape[-1])
    _same(tntt.ntt(a).mont, jntt.ntt(ja).mont)
    _same(tntt.intt(a).mont, jntt.intt(ja).mont)


def test_coset_transforms_match_reference():
    p = BN254_R
    a, ja = _ntt_case(p, (1 << 5,), 32)
    g = tntt.nth_root_of_unity(p, 1 << 8)
    n = 1 << 6
    ev = tntt.coset_evaluate(a, g, n)
    jev = jntt.coset_evaluate(ja, g, n)
    _same(ev.mont, jev.mont)
    _same(tntt.coset_interpolate(ev, g).mont, jntt.coset_interpolate(jev, g).mont)
    assert [int(v) for v in tntt.coset_interpolate(ev, g).to_int()[:32]] == \
        [int(v) for v in ja.to_int()]
    _same(tntt.geometric_series(tspec.FieldSpec.make(p), 7, 100, DEV).mont,
          jntt.geometric_series(FieldSpec.make(p), 7, 100).mont)


def test_roots_and_tables_match_reference():
    for p in (BN254_R, P32):
        assert tntt.two_adicity(p) == jntt.two_adicity(p)
        assert tntt.nth_root_of_unity(p, 1 << 10) == jntt.nth_root_of_unity(p, 1 << 10)
    spec, jspec = tspec.FieldSpec.make(BN254_R), FieldSpec.make(BN254_R)
    np.testing.assert_array_equal(tntt._stage_twiddle(spec, 64, 2, True),
                                  jntt._stage_twiddle(jspec, 64, 2, True))
    assert tntt._fourstep_splits(1 << 21) == [(1 << 21, 128, 1 << 14), (1 << 14, 128, 128)]
    n = 1 << 15
    for got, want in zip(tntt.fourstep_tables(spec, n, False, DEV),
                         jntt.fourstep_tables(jspec, n, False)):
        _same(got, want)


def test_constructors_default_to_the_card():
    """A constructor called without a device makes a CUDA tensor; where torch
    has no CUDA the call raises instead of falling back to the CPU."""
    spec = tspec.bn254_r_spec()
    assert _ext.default_device() == torch.device("cuda")
    calls = [lambda: tlimb.from_int(spec, [1]), lambda: tlimb.zeros(spec, (2,)),
             lambda: Fp.from_int(spec, [1, 2]),
             lambda: interop.limbs_from_numpy(np.zeros((16, 1), np.uint32))]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    assert tlimb.from_int(spec, [1], DEV).device == DEV
