"""Port parity: myzkp_tpu_torch field arithmetic vs myzkp_tpu.fields.limb.

The same numpy-seeded limb arrays go through both packages (via interop);
outputs must agree limb for limb (modular integers: the tolerance is 0).  On
the CPU the port runs each kernel's plain version.
"""

import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields.spec import BN254_Q, BN254_R, FieldSpec
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import spec as tspec

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

N = 24


def _operands(p: int, seed: int):
    """Two numpy limb arrays (L, N): 0, 1, p-1, R mod p crossed, then random."""
    spec = FieldSpec.make(p)
    rng = random.Random(seed)
    edges = [0, 1, p - 1, (1 << 256) % p]
    av = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(N - 16)]
    bv = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(N - 16)]
    return (np.asarray(jlimb.from_int(spec, av)), np.asarray(jlimb.from_int(spec, bv)),
            av, bv)


def _same(got_torch, want_jax):
    np.testing.assert_array_equal(interop.limbs_to_numpy(got_torch),
                                  np.asarray(want_jax))


def test_field_spec_matches_reference():
    for p in (BN254_Q, BN254_R):
        ref, port = FieldSpec.make(p), tspec.FieldSpec.make(p)
        assert [getattr(port, f) for f in ("p", "L", "n0", "p_limbs", "r2_limbs",
                                           "one_limbs", "r_inv")] == \
               [getattr(ref, f) for f in ("p", "L", "n0", "p_limbs", "r2_limbs",
                                          "one_limbs", "r_inv")]
        assert port.to_mont_int(12345) == ref.to_mont_int(12345)


@pytest.mark.parametrize("p", [BN254_Q, BN254_R], ids=["q", "r"])
def test_from_int_to_int_match_reference(p):
    a_np, _, av, _ = _operands(p, 1)
    t = tlimb.from_int(tspec.FieldSpec.make(p), av, DEV)
    np.testing.assert_array_equal(interop.limbs_to_numpy(t), a_np)
    assert list(tlimb.to_int(tspec.FieldSpec.make(p), t)) == [v % p for v in av]


OPS = ["add", "sub", "neg", "mont_mul", "mont_mul_ref", "to_mont", "from_mont",
       "is_zero"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("p", [BN254_Q, BN254_R], ids=["q", "r"])
def test_limb_op_matches_reference(p, op):
    jspec, tspec_ = FieldSpec.make(p), tspec.FieldSpec.make(p)
    a_np, b_np, av, bv = _operands(p, 2)
    a, b = interop.limbs_from_numpy(a_np, DEV), interop.limbs_from_numpy(b_np, DEV)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    if op in ("add", "sub"):
        got, want = getattr(tlimb, op)(tspec_, a, b), getattr(jlimb, op)(jspec, ja, jb)
    elif op in ("mont_mul", "mont_mul_ref"):
        got, want = getattr(tlimb, op)(tspec_, a, b), jlimb.mont_mul(jspec, ja, jb)
        rinv = pow(1 << 256, -1, p)
        assert list(tlimb.to_int(tspec_, got)) == [x * y * rinv % p
                                                   for x, y in zip(av, bv)]
    elif op == "is_zero":
        got = tlimb.is_zero(tspec_, a).numpy()
        np.testing.assert_array_equal(got, np.asarray(jlimb.is_zero(jspec, ja)))
        return
    else:
        got, want = getattr(tlimb, op)(tspec_, a), getattr(jlimb, op)(jspec, ja)
    _same(got, want)


@pytest.mark.parametrize("p", [BN254_Q, BN254_R], ids=["q", "r"])
def test_inv_and_batch_inv_match_reference(p):
    jspec, tspec_ = FieldSpec.make(p), tspec.FieldSpec.make(p)
    a_np, _, av, _ = _operands(p, 3)
    a = tlimb.to_mont(tspec_, interop.limbs_from_numpy(a_np, DEV))
    ja = jlimb.to_mont(jspec, jnp.asarray(a_np))
    _same(tlimb.inv(tspec_, a), jlimb.inv(jspec, ja))
    got = tlimb.batch_inv(tspec_, a, axis=1)
    _same(got, jlimb.batch_inv(jspec, ja, axis=1))
    want = [pow(v, -1, p) if v % p else 0 for v in av]
    assert list(tlimb.to_int(tspec_, tlimb.from_mont(tspec_, got))) == want


def test_broadcast_and_pow_const():
    spec = tspec.bn254_q_spec()
    rng = random.Random(4)
    vals = [[rng.randrange(spec.p) for _ in range(5)] for _ in range(3)]
    a = tlimb.to_mont(spec, tlimb.from_int(spec, vals, DEV))  # (L, 3, 5)
    c = tlimb.const(spec, spec.to_mont_int(7), (5,), DEV)  # (L, 5) broadcasts
    got = tlimb.to_int(spec, tlimb.from_mont(spec, tlimb.mont_mul(spec, a, c)))
    assert got.tolist() == [[v * 7 % spec.p for v in row] for row in vals]
    got = tlimb.to_int(spec, tlimb.from_mont(spec, tlimb.pow_const(spec, a, 5)))
    assert got.tolist() == [[pow(v, 5, spec.p) for v in row] for row in vals]


def test_dispatch_rule_is_keyed_on_device():
    """CPU tensors take the plain version; anything but CPU or CUDA, or a mix
    of devices, raises instead of falling back."""
    cpu = torch.zeros(16, 2, dtype=torch.int32)
    assert _ext.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        _ext.use_kernel(torch.zeros(16, 2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        _ext.use_kernel(cpu, torch.zeros(16, 2, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):
        _ext.require(cpu.long(), "a", torch.int32)
    with pytest.raises(ValueError):
        _ext.require(cpu.T, "a", torch.int32)
    with pytest.raises(ValueError):
        _ext.field_consts(tspec.FieldSpec.make(17))


def test_field_consts_match_spec():
    spec = tspec.bn254_q_spec()
    c = _ext.field_consts(spec)
    words = list(c.p)
    assert sum(w << (32 * k) for k, w in enumerate(words)) == spec.p
    assert sum(w << (32 * k) for k, w in enumerate(c.one)) == (1 << 256) % spec.p
    assert (c.n0 * spec.p) % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("defines,known", [
    (("MYZKP_K1_EPT=2",), True),
    (("MYZKP_K6_COLS=32", "MYZKP_K2_UNROLL=8"), True),
    (("NDEBUG",), False),
    (("MYZKP_K1_EPT=2", "MYZKP_NO_SUCH_CONSTANT=1"), False),
], ids=["k1", "k6-k2", "system-header", "one-unknown"])
def test_build_definitions_must_name_a_source_constant(defines, known):
    """A -D definition that no csrc/ source or header mentions would be
    compiled into no object while the library's name claims it: use_defines
    and library_path refuse it, and take the others."""
    before = _ext._defines
    try:
        if known:
            _ext.use_defines(defines)
            assert _ext.library_path() == _ext.library_path(defines) != \
                _ext.library_path(())
        else:
            with pytest.raises(ValueError, match="mentions"):
                _ext.use_defines(defines)
            with pytest.raises(ValueError, match="mentions"):
                _ext.library_path(defines)
    finally:
        _ext.use_defines(before)


def test_port_imports_no_jax():
    """Importing every module of the port, those of the NTT, quotient,
    Groth16, KZG / Gemini and sumcheck slices included, leaves jax and the
    JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import myzkp_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, 'myzkp_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'myzkp_tpu' or k.startswith('myzkp_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('myzkp_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    slices = {"fields.limb", "curves.msm", "curves.fixed_base",  # the G1 MSM
              "fields.fp", "fields.ntt_kernels", "ops.ntt", "ops.poly",
              "arith.sparse", "snark.pinocchio", "interop",  # the quotient stage
              "snark.groth16",  # Groth16 on the sparse QAP
              "commit.kzg", "commit.gemini",  # KZG and Gemini on ops.poly
              "utils.fiat_shamir", "stark.fri", "ops.mpoly",  # sumcheck
              "protocols.sumcheck", "protocols.sumcheck_tpu"}
    assert {f"myzkp_tpu_torch.{m}" for m in slices} <= loaded
    assert len(loaded) >= 24
