"""K5 at M128's four words (L = 8 limbs): the split of a Stockham transform
into passes of up to 10 stages (csrc/stockham_plan.cuh), the tiles a pass
takes on the card, and the port's transform on the plain version of K5
against the JAX package.

The tiles are host C++ (the launcher's plan), built here by g++; the split
is ``ntt_kernels.k5_l8_split``, which ``ops/ntt._stockham_passes`` runs on
the card and on the CPU alike, so the plain version runs the same passes as
the card.  The transforms agree with the
JAX package's ``_stockham_axis`` limb for limb (modular integers: the
tolerance is 0).
"""

import ctypes
import functools
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import m128_spec as jm128_spec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import ntt_kernels as tnk
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.fields.spec import m128_spec
from myzkp_tpu_torch.ops import ntt as tntt

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
SPEC = m128_spec()
P = SPEC.p
H100_SMS = 132
SMEM_MAX = 232_448  # bytes of shared memory a block on the H100


def _mont_np(vals) -> np.ndarray:
    """Host ints -> (8, *shape) Montgomery limbs, by the JAX package."""
    return np.asarray(JFp.from_int(jm128_spec(), vals).mont)


def _rand(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(24), "little") % P for _ in range(int(np.prod(shape)))]
    return _mont_np(np.asarray(vals, dtype=object).reshape(shape))


_PLAN_SHIM = """
#include "stockham_plan.cuh"
extern "C" void tile(int64_t R, int64_t Bk, int64_t c, int64_t B, int s, int64_t sms,
                     int64_t* out) {
  const auto t = myzkp_stockham::plan_tile(R, Bk, c, B, s, sms);
  const int64_t v[] = {t.ls, t.lw, t.lq, t.lkq, t.threads, t.pairs, t.tiles_j, t.tiles, t.smem};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
}
extern "C" int tile_max() { return myzkp_stockham::kTileMax; }
extern "C" int threads_max() { return myzkp_stockham::kThreadsMax; }
extern "C" int run() { return myzkp_stockham::kRun; }
"""


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """csrc/stockham_plan.cuh, K5's tiles at L = 8, built by g++ (it is host
    C++)."""
    d = tmp_path_factory.mktemp("stockham_plan")
    (d / "shim.cpp").write_text(_PLAN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_ext.CSRC),
                    "-o", str(d / "plan.so"), str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "plan.so"))
    lib.tile.argtypes = (ctypes.c_int64,) * 4 + (ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
    return lib


def _tile(plan, R, Bk, c, B, s, sms) -> dict:
    out = (ctypes.c_int64 * 9)()
    plan.tile(R, Bk, c, B, s, sms, out)
    keys = ("ls", "lw", "lq", "lkq", "threads", "pairs", "tiles_j", "tiles", "smem")
    return dict(zip(keys, out))


def test_max_stages_is_the_plans():
    """ntt_kernels.K5_L8_MAX_STAGES, which the wrapper and the plain split
    read, is the plan's kMaxStages."""
    src = (_ext.CSRC / "stockham_plan.cuh").read_text()
    assert int(re.search(r"kMaxStages = (\d+);", src).group(1)) == tnk.K5_L8_MAX_STAGES == 10


@pytest.mark.parametrize("log_m", range(1, 14))
def test_split_covers_every_stage_in_two_passes(log_m):
    """Every 2^log_m-point transform of the STARK's subproduct trees (m = 2
    ... 2^13): passes that run stages 0 ... log_m - 1 once each in order, one
    pass up to 2^10 points and two balanced ones above (the longer first);
    ntt._stockham_passes gives the same (first stage, stages)."""
    split = tnk.k5_l8_split(log_m)
    assert sum(split) == log_m and max(split) <= tnk.K5_L8_MAX_STAGES
    assert len(split) == (1 if log_m <= 10 else 2)
    assert split == sorted(split, reverse=True) and split[0] - split[-1] <= 1
    passes = tntt._stockham_passes(1 << log_m, 8)
    assert [s for _, s in passes] == split
    assert [s0 for s0, _ in passes] == [sum(split[:i]) for i in range(len(split))]


def test_split_is_the_plans(plan):
    """The split is the launcher's passes up to 2^20 points: each pass's
    stage count is one the plan tiles (stockham_plan.cuh: at least one tile,
    of whole groups) for one row, the first pass's columns and the last's,
    and ntt._stockham_passes runs it at L = 8; BN254's passes keep log2 r
    stages."""
    for log_m in range(1, 21):
        split = tnk.k5_l8_split(log_m)
        assert len(split) <= 2 and sum(split) == log_m
        assert [s for _, s in tntt._stockham_passes(1 << log_m, 8)] == split
        Bk, c = 1, 1 << log_m
        for s in split:
            t = _tile(plan, 1, Bk, c, 1, s, H100_SMS)
            assert t["ls"] == s and t["tiles"] >= 1 and t["tiles_j"] << t["lw"] >= c >> s
            Bk, c = Bk << s, c >> s
    assert [s for _, s in tntt._stockham_passes(1 << 13)] == [3, 3, 3, 3, 1]


def _prove_passes():
    """(R, Bk, c, s) of every K5 pass of a FastStark prove's subproduct
    trees (B = 1): R m = 2^16 (m = 2 ... 2^13) and R m = 2^17 (m = 4 ...
    2^13)."""
    out = []
    for total, first in ((16, 1), (17, 2)):
        for k in range(first, 14):
            R, Bk, c = 1 << (total - k), 1, 1 << k
            for s in tnk.k5_l8_split(k):
                out.append((R, Bk, c, s))
                Bk, c = Bk << s, c >> s
    return out


@pytest.mark.parametrize("sms", [H100_SMS, 114, 4, 1])
def test_tiles_fill_the_card(plan, sms):
    """At every pass of the prove and at ragged shapes: a tile is whole
    groups (2 pairs a thread and stage times the threads), at most the
    plan's largest tile, within a block's shared memory; the blocks cover
    every group; and a pass gives each SM a block unless its tiles are
    already the smallest the plan takes (kRun neighbouring columns, as many
    as the largest tile holds at 9 and 10 stages, or one group)."""
    shapes = [(R, Bk, c, 1, s) for R, Bk, c, s in _prove_passes()] + [
        (3, 1, 96, 3, 3), (2, 3, 40, 3, 2), (5, 4, 64, 2, 4), (7, 2, 16, 1, 1),
        (1, 1, 256, 5, 5), (9, 2, 8, 6, 3), (1, 1, 1024, 1, 10), (3, 1, 8192, 1, 7),
        (1, 1, 1024, 8, 10), (1, 1, 4096, 1, 9), (1, 1, 1 << 17, 1, 9), (1, 1, 1 << 20, 1, 10)]
    for R, Bk, c, B, s in shapes:
        t = _tile(plan, R, Bk, c, B, s, sms)
        tile = 1 << (s + t["lw"] + t["lq"])
        assert t["ls"] == s and 2 * t["threads"] * t["pairs"] == tile <= plan.tile_max()
        assert t["threads"] <= plan.threads_max() and t["pairs"] in (1, 2, 4)
        assert t["smem"] <= SMEM_MAX
        inner, rows = (c >> s) * B, R * Bk
        assert t["tiles_j"] << t["lw"] >= inner and t["tiles"] << t["lq"] >= rows * t["tiles_j"]
        lin = inner.bit_length() - 1
        lg_max = plan.tile_max().bit_length() - 1 - s
        smallest = t["lq"] == 0 and t["lw"] == min(lin, plan.run().bit_length() - 1, lg_max)
        assert t["tiles"] >= sms or smallest, (R, Bk, c, B, s, t)
        if t["lq"]:  # whole (r, k) blocks a tile: the columns of one in a run
            assert t["lw"] == inner.bit_length() - 1 and inner & (inner - 1) == 0


def test_prove_passes_at_most_two_a_transform():
    """The prove's 114 transforms (78 of the first family, 36 of the second:
    6 and 3 a tree level) make 141 K5 launches: two for m = 2^11 ... 2^13,
    one below."""
    n_a = {k: 6 for k in range(1, 14)}
    n_b = {k: 3 for k in range(2, 14)}
    transforms = sum(n_a.values()) + sum(n_b.values())
    launches = sum(n * len(tnk.k5_l8_split(k)) for d in (n_a, n_b) for k, n in d.items())
    assert (transforms, launches) == (114, 141)


@pytest.mark.parametrize("log_m", [1, 4, 10, 11, 13])
def test_butterfly_calls_per_m128_transform(log_m, monkeypatch):
    """ntt and intt at M128 below the four-step size call
    ntt_kernels.butterfly once a pass of the split, each with the pass's
    stage count."""
    calls = []
    real = tnk.butterfly

    def counted(spec, x, tw, stages=1):
        calls.append(stages)
        return real(spec, x, tw, stages)

    monkeypatch.setattr(tnk, "butterfly", counted)
    a = Fp(SPEC, interop.limbs_from_numpy(_rand((1 << log_m,), log_m), DEV))
    for transform in (tntt.ntt, tntt.intt):
        calls.clear()
        transform(a)
        assert calls == tnk.k5_l8_split(log_m)


@functools.lru_cache(maxsize=None)
def _reference(m: int) -> tuple:
    """A (3, m, 2) input with 0, 1, p - 1 and R mod p at the start of its
    first row and column and at the end of its last, and the JAX package's
    forward and inverse transforms of it.  A transform acts on each (row,
    column) alone, so the cases of fewer rows or columns slice both."""
    x_np = _rand((3, m, 2), 31 * m).copy()
    edges = _mont_np([0, 1, P - 1, (1 << 128) % P])
    k = min(4, m)
    x_np[:, 0, :k, 0] = edges[:, :k]
    x_np[:, 2, m - k:, 1] = edges[:, ::-1][:, :k]
    return x_np, {inv: np.asarray(jntt._stockham_axis(jm128_spec(), jnp.asarray(x_np), m, inv))
                  for inv in (False, True)}


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("m", [2, 4, 1024, 2048, 8192])
def test_stockham_axis_matches_reference_m128(m, R, B):
    """The port's Stockham transform at M128 (the plain version of K5 over
    the split's passes: one pass up to 2^10 points, two above) on R rows and
    B columns against the JAX package's per-stage transform on the M128
    FieldSpec, forward and inverse, exact; 0, 1, p - 1 and R mod p among
    the inputs."""
    x_full, want = _reference(m)
    x_np = np.ascontiguousarray(x_full[:, :R, :, :B])
    x = interop.limbs_from_numpy(x_np, DEV)
    for inv in (False, True):
        got = tntt._stockham_axis(SPEC, x, m, inv)
        np.testing.assert_array_equal(interop.limbs_to_numpy(got), want[inv][:, :R, :, :B])


@pytest.mark.parametrize("stages", [7, 10, 13])
def test_butterfly_ref_long_pass_equals_one_stage_chain(stages):
    """K5's plain version at L = 8 over one pass of 7, 10 and 13 stages (the
    first pass of a 2^13-point transform, the longest pass the kernel runs,
    and a whole 2^13-point transform) equals the one-stage plain versions
    run one after another over the same stage rows."""
    m, R, B = 1 << 13, 2, 1
    y = interop.limbs_from_numpy(_rand((R, m, B), stages), DEV).reshape(8, R, 1, m, B)
    tw = tntt._pass_twiddles(SPEC, m, 0, stages, False, DEV)
    assert tw.shape == (8, m - (m >> stages))
    got = tnk.butterfly_ref(SPEC, y, tw, stages)
    want = y
    for s in range(stages):
        want = tnk.butterfly_ref(SPEC, want, tntt._pass_twiddles(SPEC, m, s, 1, False, DEV))
    assert got.shape == (8, R, 1 << stages, m >> stages, B)
    assert torch.equal(got, want)


def test_butterfly_refuses_more_stages_than_the_plan():
    """The wrapper takes at most K5_L8_MAX_STAGES stages a launch at L = 8,
    on the CPU as on the card (the plain version alone takes any count)."""
    m = 1 << 11
    y = interop.limbs_from_numpy(_rand((1, m, 1), 3), DEV).reshape(8, 1, 1, m, 1)
    for s in (11,):
        with pytest.raises(ValueError, match="at most 10"):
            tnk.butterfly(SPEC, y, tntt._pass_twiddles(SPEC, m, 0, s, False, DEV), s)
    tw = tntt._pass_twiddles(SPEC, m, 0, 10, False, DEV)
    assert torch.equal(tnk.butterfly(SPEC, y, tw, 10), tnk.butterfly_ref(SPEC, y, tw, 10))
