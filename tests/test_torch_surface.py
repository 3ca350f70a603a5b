"""The port's public surface against the JAX package's, and the last small
pieces of it held to their JAX counterparts.

``test_every_public_name_has_a_counterpart`` reads both packages' sources
with ``ast`` (importing neither) and requires that every public top-level
function and class, and every public method of those classes, of each
``myzkp_tpu/`` module has a counterpart in the port's module of the same
path, or of the path the port renamed it to.  Names the port leaves behind
on purpose are listed below, each with its reason: machinery that exists
only for Pallas, Mosaic, the TPU relay or JAX's tracing.

The check closes the port's surface against the JAX package's for the
port's bring-up; it does not fix the port's API for good.  A name of the
port that no path, entry point or example of the port calls (API kept only
for parity) may later be deleted with its code: the same change adds it to
``LEFT_BEHIND`` with the reason, so the list stays the record of what the
port does not do.

The other tests hold the host helpers, ``FpOps`` / ``Fq2Ops``' ``inv``,
``stack``, ``index`` and ``take``, ``GF_ZERO_OF``, ``limb.from_bytes`` /
``limb.random`` and the C++ GT helpers to the JAX package, with inputs from
numpy seeds; tolerance 0 (modular integers).
"""

import ast
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu import native as jnative
from myzkp_tpu.codes import reedsolomon as jrs
from myzkp_tpu.curves import field_ops as jfo
from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields import python_field as pf
from myzkp_tpu.fields.spec import FieldSpec as JSpec
from myzkp_tpu_torch import interop, native
from myzkp_tpu_torch.codes import reedsolomon as trs
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import field_ops as tfo
from myzkp_tpu_torch.fields import host, limb
from myzkp_tpu_torch.fields import spec as tspec

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "myzkp_tpu", ROOT / "myzkp_tpu_torch"

# JAX module -> the port's module(s) that carry its names.
RENAMED_MODULES = {
    "fields/python_field.py": ("fields/host.py",),
    "curves/curve_pallas.py": ("curves/curve_kernels.py",),
    "fields/limb_pallas.py": ("fields/ntt_kernels.py", "fields/limb.py"),
}
# JAX name -> the port's name for the same function, by JAX module.
RENAMED = {
    "curves/curve_pallas.py": {
        "padd_fused": "padd", "padd_sel_fused": "padd", "pdbl_fused": "pdbl",
        "padd2_fused": "padd2", "padd2_sel_fused": "padd2", "pdbl2_fused": "pdbl2",
        "padd_mixed_fused": "padd_mixed", "padd_mixed_sel_fused": "padd_mixed",
        "padd_mixed2_fused": "padd_mixed2", "padd_mixed2_sel_fused": "padd_mixed2"},
    "fields/limb_pallas.py": {"mont_mul_pallas": "mont_mul_cuda",
                              "butterfly_pallas": "butterfly_pair",
                              "ntt_leaf_pallas": "ntt_leaf"},
    # the optional library's loader; the port's builds it or raises
    "native/__init__.py": {"get_lib": "library"},
}
# Left behind on purpose, by JAX module ("*": the whole module).  A port
# name with no caller in the port may be deleted by listing it here with
# its reason, in the change that deletes it.
LEFT_BEHIND = {
    # the in-kernel field library of the Pallas kernels (TileFp, TileFq2):
    # the port's is csrc/field.cuh, under every CUDA kernel
    "fields/tile_ops.py": {"*"},
    # Pallas dispatch: whether the fused kernels run, in interpret mode or
    # not, and the try_* routes that return None where Mosaic cannot run;
    # the port dispatches on the tensor's device alone (_ext.use_kernel)
    "curves/curve_pallas.py": {"enabled", "force_fused", "forced_mode", "interpret_mode",
                               "no_fuse", "try_padd", "try_padd_mixed", "try_pdbl"},
    "fields/limb.py": {"force_pallas", "pallas_allowed"},
    # a Mosaic relayout workaround of the TPU NTT leaf (K6 needs none)
    "fields/limb_pallas.py": {"ntt_leaf_row_perm"},
    # JAX pytree hooks
    "fields/fp.py": {"Fp.tree_flatten", "Fp.tree_unflatten"},
    # lax.dynamic_index_in_dim for traced indices; the port's index takes any
    "curves/field_ops.py": {"FpOps.dyn_index", "Fq2Ops.dyn_index"},
    # dispatch by the executing mesh's platform (TPU or CPU devices)
    "parallel/mesh.py": {"mesh_dispatch"},
    # whether the optional native library loaded; the port has no Python
    # fallback, so its library() builds the library or raises
    "native/__init__.py": {"available"},
    # a per-stage timer that synchronizes the card, and a Chrome-trace
    # writer: the port marks its stages with spans on the profiler's own
    # clock (utils/metrics.span), and the profiler exports its own traces
    "utils/metrics.py": {"StageMetrics", "StageMetrics.record", "StageMetrics.report",
                         "StageMetrics.reset", "StageMetrics.stage", "reset_metrics", "trace"},
}


def _public_names(path: Path, with_imports: bool = False) -> set:
    """Public top-level functions and classes (and their public methods as
    'Class.method') of a module; with_imports adds the public names it
    binds by import or assignment (re-exports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{b.name}" for b in node.body
                        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not b.name.startswith("_")}
        elif with_imports and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif with_imports and isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def test_every_public_name_has_a_counterpart():
    missing, stale = {}, {}
    for jpath in sorted(JAX_PKG.rglob("*.py")):
        rel = jpath.relative_to(JAX_PKG).as_posix()
        left = LEFT_BEHIND.get(rel, set())
        ports = [PORT_PKG / m for m in RENAMED_MODULES.get(rel, (rel,))]
        if "*" in left:
            assert not any(p.exists() for p in ports), rel
            continue
        have = set().union(*(_public_names(p, True) for p in ports if p.exists()))
        ren = RENAMED.get(rel, {})
        want = _public_names(jpath)
        gone = {n for n in want if ren.get(n, n) not in have} - left
        if gone:
            missing[rel] = sorted(gone)
        if left - (want - have):  # a listed name the port has, or JAX lacks
            stale[rel] = sorted(left - (want - have))
    assert not missing, f"no counterpart in the port: {missing}"
    assert not stale, f"listed as left behind, but ported or gone: {stale}"


def test_host_helpers_match_python_field():
    for p in (tspec.BN254_Q, tspec.M64):
        F, J = host.PyField(p), pf.PyField(p)
        assert int(F.zero()) == int(J.zero()) == 0 and int(F.one()) == int(J.one()) == 1
        assert F.zero().is_zero() and not F.one().is_zero() and F(p).is_zero()
        assert J.zero().is_zero() and not J.one().is_zero()
        assert [int(F.random(random.Random(s))) for s in range(4)] == \
            [int(J.random(random.Random(s))) for s in range(4)]
        for data in (b"", b"\x01", bytes(range(40)), b"\xff" * 33):
            assert int(F.sample(data)) == int(J.sample(data)) == int.from_bytes(data, "big") % p
        E, JE = host.PyExtField(F, [5, 0, 1, 3]), pf.PyExtField(J, [5, 0, 1, 3])
        for a, b in ((E.zero(), JE.zero()), (E.x(), JE.x()),
                     (E.random(random.Random(9)), JE.random(random.Random(9)))):
            assert [c.v for c in a.c] == [c.v for c in b.c]
            assert a.is_zero() == b.is_zero()
        assert E.zero().is_zero() and not E.x().is_zero() and (E.x() - E.x()).is_zero()
    g1, g2 = tbn.g1_generator(), tbn.g2_generator()
    jcurve = pf.PyCurve(pf.PyField(tspec.BN254_Q)(0), pf.PyField(tspec.BN254_Q)(3))
    jf = pf.PyField(tspec.BN254_Q)
    for x, y in ((int(g1.x), int(g1.y)), (int(g1.x), int(g1.y) + 1), (1, 2)):
        assert host.curve_g1.contains(host.Fq(x), host.Fq(y)) == jcurve.contains(jf(x), jf(y))
    assert host.curve_g1.contains(g1.x, g1.y) and not host.curve_g1.contains(g1.x, g1.x)
    assert host.curve_g2.contains(g2.x, g2.y) and not host.curve_g2.contains(g2.x, g2.x)


def test_field_ops_inv_and_indexing_match_reference():
    spec, jspec = tspec.bn254_q_spec(), JSpec.make(tspec.BN254_Q)
    rng = np.random.default_rng(3)
    q = tspec.BN254_Q
    vals = [0, 1, q - 1] + [int.from_bytes(rng.bytes(40), "little") % q for _ in range(9)]
    a = limb.to_mont(spec, limb.from_int(spec, vals, DEV)).reshape(16, 3, 4)
    b = limb.to_mont(spec, limb.from_int(spec, vals[::-1], DEV)).reshape(16, 3, 4)
    ja, jb = (jnp.asarray(interop.limbs_to_numpy(x)) for x in (a, b))
    F, JF = tfo.FpOps(spec), jfo.FpOps(jspec)
    F2, JF2 = tfo.Fq2Ops(spec), jfo.Fq2Ops(jspec)
    np_ = lambda x: interop.limbs_to_numpy(x)
    np.testing.assert_array_equal(np_(F.inv(a)), np.asarray(JF.inv(ja)))
    for got, want in zip(F2.inv((a, b)), JF2.inv((ja, jb))):
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    # inv(a) a = 1 (a != 0), inv(0) = 0 over F_q2 too
    one = F2.mul(F2.inv((a, b)), (a, b))
    nz = ~F2.is_zero((a, b))
    assert (one[0][:, nz] == F.one((), DEV)[:, None]).all() and (one[1][:, nz] == 0).all()
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(np_(F.stack([a, b], axis)),
                                      np.asarray(JF.stack([ja, jb], axis)))
    for idx in (1, (2, 3), (slice(0, 2), 1)):
        np.testing.assert_array_equal(np_(F.index(a, idx)), np.asarray(JF.index(ja, idx)))
        for got, want in zip(F2.index((a, b), idx), JF2.index((ja, jb), idx)):
            np.testing.assert_array_equal(np_(got), np.asarray(want))
    for ind, axis in ((2, 0), ([3, 0, 3], 1), (np.array([[1, 0], [2, 2]]), 0)):
        np.testing.assert_array_equal(np_(F.take(a, ind, axis)),
                                      np.asarray(JF.take(ja, jnp.asarray(ind), axis)))
        for got, want in zip(F2.take((a, b), ind, axis),
                             JF2.take((ja, jb), jnp.asarray(ind), axis)):
            np.testing.assert_array_equal(np_(got), np.asarray(want))
    stacked = F2.stack([(a, b), (b, a)], 1)
    want = JF2.stack([(ja, jb), (jb, ja)], 1)
    for got, w in zip(stacked, want):
        np.testing.assert_array_equal(np_(got), np.asarray(w))


def test_gf_zero_of_matches_reference():
    for v in (0, 1, 7, 0xFF):
        assert trs.GF_ZERO_OF(trs.GF256(v)).v == jrs.GF_ZERO_OF(jrs.GF256(v)).v == 0
    F = host.PyField(tspec.M64)
    assert trs.GF_ZERO_OF(F(12345)) == F.zero()


@pytest.mark.parametrize("p", [tspec.BN254_R, tspec.M128, tspec.M64])
def test_from_bytes_matches_reference(p):
    spec, jspec = tspec.FieldSpec.make(p), JSpec.make(p)
    rng = np.random.default_rng(p % 997)
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(40), "little") % p for _ in range(13)]
    bs = limb.to_bytes_batch(spec, limb.from_int(spec, vals, DEV))
    got = limb.from_bytes(spec, bs, DEV)
    assert got.dtype == torch.int32 and got.device == DEV
    np.testing.assert_array_equal(interop.limbs_to_numpy(got),
                                  np.asarray(jlimb.from_bytes(jspec, bs)))
    assert list(limb.to_int(spec, got)) == vals


def test_random_is_lo_plus_hi_r_mod_p():
    """limb.random draws 2L limbs x = lo + hi R and returns x mod p in the
    standard domain, as the JAX package's random does with its own key."""
    for p in (tspec.BN254_R, tspec.M64):
        spec = tspec.FieldSpec.make(p)
        got = limb.random(spec, torch.Generator().manual_seed(11), (3, 5), DEV)
        assert got.shape == (spec.L, 3, 5)
        wide = torch.randint(0, 1 << 16, (2 * spec.L, 3, 5),
                             generator=torch.Generator().manual_seed(11), dtype=torch.int32)
        words = wide.reshape(2 * spec.L, -1).long().T.tolist()
        want = [sum(w << (16 * k) for k, w in enumerate(row)) % p for row in words]
        assert list(limb.to_int(spec, got).reshape(-1)) == want


def test_gt_coeffs_match_reference():
    g1, g2 = tbn.g1_generator(), tbn.g2_generator()
    e = native.pairing_coeffs(g1, g2)
    for k in (66, 5, -5, 0):
        assert native.gt_pow_coeffs(e, k) == jnative.gt_pow_coeffs(e, k)
    assert native.gt_pow_coeffs(e, 66) == native.pairing_coeffs(g1 * 6, g2 * 11)
    a, b = 0x1234567890ABCDEF, 0xFEDCBA0987654321
    assert native.pairing_coeffs(g1 * a, g2 * b) == native.gt_pow_coeffs(e, a * b)
    one = [1] + [0] * 11
    assert native.gt_mul_coeffs(native.gt_pow_coeffs(e, 5), native.gt_pow_coeffs(e, -5)) == one
    assert native.gt_inv_coeffs(native.gt_pow_coeffs(e, 5)) == native.gt_pow_coeffs(e, -5)
    assert native.gt_mul_coeffs(e, e) == native.gt_pow_coeffs(e, 2) == \
        [int(c) for c in (tbn.Fq12(e) * tbn.Fq12(e)).c]
