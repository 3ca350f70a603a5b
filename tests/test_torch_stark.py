"""Port parity: the fast polynomial algebra and both STARK provers of
myzkp_tpu_torch against myzkp_tpu, over M128.

The same seeded inputs go through both packages; coefficients must agree
limb for limb and proofs byte for byte (the tolerance is 0).  On the CPU the
port runs the plain versions of its kernels (K1 and its chain, K5, K6 and
K17, the long division) at L = 8.  The provers run the JAX package's own
squaring AIR (tests/test_stark_e2e.py:50-75: one register, x_(i+1) = x_i^2)
at 8 cycles with random.Random(7), as its test does.  Every port
constructor is given an explicit CPU device.
"""

import dataclasses
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import M128, FieldSpec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu.ops.mpoly import MPoly as JMPoly
from myzkp_tpu.stark import fast_stark as jfast
from myzkp_tpu.stark import stark as jstark
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops import ntt as tntt
from myzkp_tpu_torch.ops.mpoly import MPoly
from myzkp_tpu_torch.stark import fast_stark, stark

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) share the cores
torch.set_num_threads(1)
SPEC, JSPEC = tspec.m128_spec(), FieldSpec.make(M128)
CYCLES, X0 = 8, 123456789
PARAMS = (4, 2, 2, 1, CYCLES, 2)


def _ints(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(M128) for _ in range(n)]


def _both(vals):
    """The same host ints as a port Fp (CPU) and a JAX Fp."""
    return Fp.from_int(SPEC, vals, DEV), JFp.from_int(JSPEC, vals)


def _same(got: Fp, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got.mont), np.asarray(want.mont))


def _host_eval(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % M128
    return acc


@pytest.mark.parametrize("n", [8, 12])
def test_fast_algebra_matches_reference(n):
    """fast_zerofier, fast_evaluate (a polynomial longer than the points, so
    the root's residue first) and fast_interpolate over n seeded points (12:
    chunks of 8 and 4) and two rows of values, limb for limb against the JAX
    package, and against the host."""
    xs, jxs = _both(_ints(n, n))
    coef, jcoef = _both(_ints(n + 5, n + 1))
    ys, jys = _both([_ints(n, n + 2), _ints(n, n + 3)])
    z = tntt.fast_zerofier(xs)
    _same(z, jntt.fast_zerofier(jxs))
    ev = tntt.fast_evaluate(coef, xs)
    _same(ev, jntt.fast_evaluate(jcoef, jxs))
    it = tntt.fast_interpolate(xs, ys)
    _same(it, jntt.fast_interpolate(jxs, jys))
    pts, cs = [int(v) for v in xs.to_int()], [int(v) for v in coef.to_int()]
    assert [int(v) for v in ev.to_int()] == [_host_eval(cs, x) for x in pts]
    assert all(_host_eval([int(v) for v in z.to_int()], x) == 0 for x in pts)
    rows = it.to_int()
    assert [[_host_eval([int(v) for v in row], x) for x in pts] for row in rows] == \
        [[int(v) for v in row] for row in ys.to_int()]


def test_rou_domain_and_coset_divide_match_reference():
    """evaluate_on_rou_domain / interpolate_on_rou_domain, and
    fast_coset_divide of (z q) by z on a 32-point coset, against the JAX
    package; the quotient is q."""
    a, ja = _both(_ints(5, 20))
    ev = tntt.evaluate_on_rou_domain(a, 16)
    _same(ev, jntt.evaluate_on_rou_domain(ja, 16))
    _same(tntt.interpolate_on_rou_domain(ev), jntt.interpolate_on_rou_domain(
        jntt.evaluate_on_rou_domain(ja, 16)))
    z, jz = _both(_ints(6, 21) + [1])
    q_vals = _ints(9, 22)
    q = Fp.from_int(SPEC, q_vals, DEV)
    lhs = tntt.fast_multiply(z, q)
    jlhs = JFp(JSPEC, np.asarray(interop.limbs_to_numpy(lhs.mont)))
    got = tntt.fast_coset_divide(lhs, z, stark.GENERATOR, 32)
    _same(got, jntt.fast_coset_divide(jlhs, jz, stark.GENERATOR, 32))
    assert [int(v) for v in got.to_int()[:9]] == q_vals and not got.mont[:, 9:].any()


def _squaring_air(mpoly_cls, spec):
    trace = [[pow(X0, 1 << i, M128)] for i in range(CYCLES)]
    var = mpoly_cls.variables(spec, 3)  # (cycle, prev, next)
    boundary = [(0, 0, X0), (CYCLES - 1, 0, trace[-1][0])]
    false_boundary = [(0, 0, X0), (CYCLES - 1, 0, (trace[-1][0] + 1) % M128)]
    return trace, [var[1] ** 2 - var[2]], boundary, false_boundary


@pytest.fixture(scope="module")
def fast_case():
    """FastStark on the squaring AIR: the JAX package's preprocess and prove
    (random.Random(7)), and the port's."""
    trace, jair, boundary, _ = _squaring_air(JMPoly, JSPEC)
    js = jfast.initialize_fast_stark_m128(*PARAMS)
    jpre = js.preprocess()
    jproof = js.prove(trace, boundary, jair, preprocessed=jpre, rng=random.Random(7))
    ts = fast_stark.initialize_fast_stark_m128(*PARAMS, device=DEV)
    pre = ts.preprocess()
    proof = ts.prove(trace, boundary, _squaring_air(MPoly, SPEC)[1], preprocessed=pre,
                     rng=random.Random(7))
    return ts, pre, proof, jpre, jproof


def test_fast_stark_proof_matches_reference(fast_case):
    """The preprocessed zerofier (polynomial, codeword, root, leaves) and the
    proof byte for byte; the JAX package's preprocessed state loaded through
    interop gives the same proof."""
    ts, pre, proof, jpre, jproof = fast_case
    _same(pre[0].coef, jpre[0].coef)
    _same(pre[1], jpre[1])
    assert pre[2] == jpre[2] and pre[3] == jpre[3]
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    loaded = interop.stark_preprocessed_from_numpy(
        SPEC, np.asarray(jpre[0].coef.mont), np.asarray(jpre[1].mont), jpre[2], jpre[3], DEV)
    trace, air, boundary, _ = _squaring_air(MPoly, SPEC)
    again = ts.prove(trace, boundary, air, preprocessed=loaded, rng=random.Random(7))
    assert dataclasses.asdict(again) == dataclasses.asdict(jproof)


def test_fast_stark_accepts_and_rejects(fast_case):
    """The port's verifier accepts its proof (and the JAX package's accepts
    it too); a false boundary's proof, a tampered opening and a wrong root
    are rejected."""
    ts, pre, proof, jpre, _ = fast_case
    trace, air, boundary, false_boundary = _squaring_air(MPoly, SPEC)
    assert ts.verify(proof, air, pre[2], boundary)
    jair = _squaring_air(JMPoly, JSPEC)[1]
    js = jfast.initialize_fast_stark_m128(*PARAMS)
    assert js.verify(proof, jair, jpre[2], boundary)
    bad = ts.prove(trace, false_boundary, air, preprocessed=pre, rng=random.Random(8))
    assert not ts.verify(bad, air, pre[2], false_boundary)
    tampered = dataclasses.replace(proof, tzc_points=[b"\0" * 16] + proof.tzc_points[1:])
    assert not ts.verify(tampered, air, pre[2], boundary)
    assert not ts.verify(proof, air, b"\0" * 32, boundary)
    assert not ts.verify(dataclasses.replace(proof, rdc_paths=proof.rdc_paths[1:]), air,
                         pre[2], boundary)


def test_slow_stark_matches_reference():
    """The slow Stark (Lagrange interpolation, poly_divmod quotients) on the
    squaring AIR: the proof equal to the JAX package's byte for byte,
    accepted, and a false boundary's proof rejected."""
    trace, jair, boundary, _ = _squaring_air(JMPoly, JSPEC)
    jproof = jstark.initialize_stark_m128(*PARAMS).prove(trace, boundary, jair,
                                                         rng=random.Random(7))
    ts = stark.initialize_stark_m128(*PARAMS, device=DEV)
    _, air, _, false_boundary = _squaring_air(MPoly, SPEC)
    proof = ts.prove(trace, boundary, air, rng=random.Random(7))
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert ts.verify(proof, air, boundary)
    bad = ts.prove(trace, false_boundary, air, rng=random.Random(8))
    assert not ts.verify(bad, air, false_boundary)


def test_stark_constructors_default_to_the_card():
    """Without a device the STARKs, codeword_from_bytes and the fast algebra's
    inputs are made on the card; without CUDA the call raises rather than
    running on the CPU."""
    assert _ext.default_device() == torch.device("cuda")
    st = fast_stark.initialize_fast_stark_m128(*PARAMS)
    assert st.device == torch.device("cuda")
    from myzkp_tpu_torch.stark import fri

    calls = [lambda: fri.codeword_from_bytes(SPEC, [b"\1" + b"\0" * 15]),
             lambda: st.preprocess(), lambda: Fp.from_int(SPEC, [1, 2])]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    assert stark.initialize_stark_m128(*PARAMS, device=DEV).device == DEV


def test_stark_slice_imports_no_jax():
    """The STARK slice's modules load without jax or the JAX package."""
    mods = ("stark.stark", "stark.fast_stark", "stark.fri", "stark.rescueprime",
            "utils.merkle", "ops.ntt", "ops.poly", "interop")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('myzkp_tpu_torch.' + m)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'myzkp_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
