"""K1's chain (a^e for a host exponent) in its two forms: the window form's
host recoding, the launcher's choice of form, and the schedule's arithmetic.

The window form (csrc/mont_mul.cu, one thread an element) runs the schedule
that ``_ext.window_schedule`` recodes e into: odd powers x^(2d + 1) in a
table, then windows of squarings and one product each.  Here the schedule
recomposes to e, a plain run of it over ``mont_mul_ref`` equals
``mont_pow_ref`` and the JAX package's ``pow_const`` limb for limb, and the
launcher's plan (csrc/pow_plan.cuh, host C++ built by g++) picks the lane
pair up to its threshold and the window form past it.  The kernels
themselves run on the card (chip_smoke.py).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields.spec import BN254_Q, M64, M128, FieldSpec
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.stark import rescue_constants

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

FIELDS = {16: BN254_Q, 8: M128, 4: M64}  # limbs L -> the width's prime
ALPHA, ALPHA_INV = rescue_constants.ALPHA, rescue_constants.ALPHA_INV


def _exponents(p: int) -> dict:
    return {"0": 0, "1": 1, "2": 2, "3": 3, "alpha": ALPHA, "alpha^-1": ALPHA_INV,
            "p-2": p - 2, "2^256-1": (1 << 256) - 1}


def _edges(p: int, words: int) -> list:
    """Values below p whose 32-bit words are each 0 or all ones, p - 1, 1,
    R mod p, and where p > R / 2 (M128, M64) values in [R / 2, p)."""
    out = [sum(0xFFFFFFFF << (32 * k) for k in range(words) if bits >> k & 1)
           for bits in range(1 << words)]
    half = 1 << (32 * words - 1)
    top = [half, half + 1, p - 2] if p > half else []
    return [v for v in out if v < p] + [p - 1, 1, (1 << (32 * words)) % p] + top


def _recompose(sched) -> int:
    table, steps, tail = sched
    if not steps:
        return 0
    e = 2 * steps[0][1] + 1
    for s, d in steps[1:]:
        e = (e << s) + 2 * d + 1
    return e << tail


def _run_schedule(spec, a, sched):
    """The window form's arithmetic on the plain product: the table, then
    each window's squarings and product, then the tail's squarings."""
    table, steps, tail = sched
    if not steps:
        return tlimb.one_mont(spec, tuple(a.shape[1:]), a.device).contiguous()
    mul = lambda x, y: tlimb.mont_mul_ref(spec, x, y)
    tab = [a]
    if table > 1:
        x2 = mul(a, a)
        while len(tab) < table:
            tab.append(mul(tab[-1], x2))
    acc = tab[steps[0][1]]
    for s, d in steps[1:]:
        for _ in range(s):
            acc = mul(acc, acc)
        acc = mul(acc, tab[d])
    for _ in range(tail):
        acc = mul(acc, acc)
    return acc


@pytest.mark.parametrize("e_name", list(_exponents(M128)))
@pytest.mark.parametrize("L", list(FIELDS))
def test_window_schedule_recomposes_to_e(L, e_name):
    """The host recoding at each width's table: windows MSB first, each an
    odd digit below the table, at most MAX_WINDOWS, recomposing to e; never
    more products than square-and-multiply (bit length - 1 + popcount)."""
    e = _exponents(FIELDS[L])[e_name]
    sched = _ext.window_schedule(e, _ext.POW_TABLE[L])
    table, steps, tail = sched
    assert _recompose(sched) == e
    assert 1 <= table <= _ext.POW_TABLE[L]
    assert len(steps) <= _ext.MAX_WINDOWS
    assert all(0 <= d < table and 0 <= s <= 255 for s, d in steps) and 0 <= tail <= 255
    assert steps[0][0] == 0 if steps else e == 0
    assert max((d for _, d in steps), default=0) == table - 1
    if e:
        assert _ext.schedule_products(sched) <= e.bit_length() - 1 + bin(e).count("1")


@pytest.mark.parametrize("L", list(FIELDS))
def test_exponent_carries_bits_and_schedule(L):
    """struct Exponent as the kernel reads it: the bits for the lane pair,
    the packed window schedule for the window form."""
    assert ctypes.sizeof(_ext._Exponent) == 4 * 8 + 4 * 4 + 2 * _ext.MAX_WINDOWS
    rng = np.random.default_rng(L)
    for e in (0, 1, ALPHA_INV, FIELDS[L] - 2, (1 << 256) - 1,
              int.from_bytes(rng.bytes(32), "little")):
        x = _ext.exponent(e, L)
        words, nbits = _ext.exponent_words(e)
        table, steps, tail = _ext.window_schedule(e, _ext.POW_TABLE[L])
        assert list(x.w) == list(words) and x.nbits == nbits
        assert (x.table, x.windows, x.tail) == (table, len(steps), tail)
        assert list(x.step[:len(steps)]) == [s << 8 | d for s, d in steps]


def test_window_schedule_takes_the_cheapest_width():
    """alpha^-1 (127 bits, alternating) at four and two words runs 163
    products with 4 odd powers (w = 3), p - 2 at M64 83 with 8 (w = 4): no
    width that fits the table runs fewer."""
    for L, e, want in ((8, ALPHA_INV, (163, 4)), (4, M64 - 2, (83, 8)),
                       (16, BN254_Q - 2, (311, 4))):
        sched = _ext.window_schedule(e, _ext.POW_TABLE[L])
        assert (_ext.schedule_products(sched), sched[0]) == want
        for w in range(1, 6):
            wins, tail = _ext.sliding_windows(e, w)
            if max(v for _, v in wins) // 2 < _ext.POW_TABLE[L]:
                table = max(v for _, v in wins) // 2 + 1
                alt = (table, [(s, v // 2) for s, v in wins], tail)
                assert _ext.schedule_products(alt) >= want[0]


@pytest.mark.parametrize("e_name", ["0", "1", "2", "3", "alpha", "alpha^-1", "p-2"])
@pytest.mark.parametrize("L", list(FIELDS))
def test_schedule_run_matches_mont_pow_ref(L, e_name):
    """The schedule run over mont_mul_ref equals mont_pow_ref (the chain's
    plain version) on the word edges and seeded values."""
    p = FIELDS[L]
    spec = tspec.FieldSpec.make(p)
    e = _exponents(p)[e_name]
    rng = np.random.default_rng(L + 1)
    vals = _edges(p, L // 2) + [int.from_bytes(rng.bytes(40), "little") % p for _ in range(6)]
    a = tlimb.from_int(spec, vals, DEV)
    got = _run_schedule(spec, a, _ext.window_schedule(e, _ext.POW_TABLE[L]))
    assert torch.equal(got, tlimb.mont_pow_ref(spec, a, e))


@pytest.mark.parametrize("e_name", ["3", "alpha^-1", "p-2"])
@pytest.mark.parametrize("L", list(FIELDS))
def test_schedule_run_matches_reference(L, e_name):
    """The schedule run against the JAX package's pow_const on the same
    Montgomery limbs (word edges among them), and against the host."""
    p = FIELDS[L]
    spec, jspec = tspec.FieldSpec.make(p), FieldSpec.make(p)
    e = _exponents(p)[e_name]
    vals = _edges(p, L // 2)
    a_np = np.asarray(jlimb.from_int(jspec, vals))
    a = interop.limbs_from_numpy(a_np, DEV)
    got = _run_schedule(spec, a, _ext.window_schedule(e, _ext.POW_TABLE[L]))
    np.testing.assert_array_equal(interop.limbs_to_numpy(got),
                                  np.asarray(jlimb.pow_const(jspec, a_np, e)))
    R = 1 << (16 * L)
    rinv = pow(R, -1, p)
    assert [int(v) for v in tlimb.to_int(spec, got)] == [
        pow(v * rinv % p, e, p) * R % p for v in vals]


_PLAN_SHIM = """
#include "pow_plan.cuh"
extern "C" int form(int64_t n, int64_t sms) { return myzkp_pow::pow_form(n, sms); }
extern "C" int64_t per_sm() { return myzkp_pow::kPairPerSm; }
"""


@pytest.fixture(scope="module")
def pow_plan(tmp_path_factory):
    """csrc/pow_plan.cuh, the launcher's choice of form, built by g++ (it is
    host C++)."""
    d = tmp_path_factory.mktemp("pow_plan")
    (d / "shim.cpp").write_text(_PLAN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_ext.CSRC),
                    "-o", str(d / "plan.so"), str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "plan.so"))
    lib.form.argtypes = (ctypes.c_int64, ctypes.c_int64)
    lib.per_sm.restype = ctypes.c_int64
    return lib


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_pow_plan_edge(pow_plan, sms):
    """The lane pair up to kPairPerSm elements an SM, the window form past
    it: on either side of the edge, at the H100's 132 SMs and others."""
    edge = sms * pow_plan.per_sm()
    assert pow_plan.per_sm() >= 1
    assert [pow_plan.form(n, sms) for n in (1, 2, edge - 1, edge)] == [0] * 4
    assert [pow_plan.form(n, sms) for n in (edge + 1, 2 * edge, 1 << 20)] == [1] * 3


def test_pow_plan_sends_the_paths_to_their_forms(pow_plan):
    """On the H100: the proofs' inversions (1 or 2 elements) on the lane
    pair, hash_batch's 2^20 S-boxes in the window form."""
    assert pow_plan.form(2, 132) == 0 and pow_plan.form(1, 132) == 0
    assert pow_plan.form(1 << 20, 132) == 1


def test_plain_chain_keeps_the_cpu_path():
    """On the CPU pow_const is mont_pow_ref: no recoding reaches a kernel,
    and a width no kernel takes still runs."""
    spec = tspec.FieldSpec.make(17)
    a = tlimb.to_mont(spec, tlimb.from_int(spec, [3, 5], DEV))
    got = tlimb.from_mont(spec, tlimb.pow_const(spec, a, 13))
    assert [int(v) for v in tlimb.to_int(spec, got)] == [pow(3, 13, 17), pow(5, 13, 17)]
