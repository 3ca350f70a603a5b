"""Port parity: the sparse QAP and the prover's quotient stage.

``segment_sum_mod``, the sparse matrix products, ``square_chain``, the QAP's
``combine`` / ``h_poly`` and ``get_shifted_h`` of myzkp_tpu_torch are held to
myzkp_tpu limb for limb (the tolerance is 0) on the same circuits, carried
across through interop.  On the CPU the port runs its kernels' plain
versions.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.arith import sparse as jsparse
from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import BN254_R, FieldSpec
from myzkp_tpu.ops.poly import Poly as JPoly
from myzkp_tpu.snark import pinocchio as jpin
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse as tsparse
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops.poly import Poly
from myzkp_tpu_torch.snark import pinocchio as tpin

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
JSPEC, TSPEC = FieldSpec.make(BN254_R), tspec.FieldSpec.make(BN254_R)
P = BN254_R


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))


def _port_matrix(jm: jsparse.SparseMatrix):
    return interop.sparse_matrix_from_numpy(
        TSPEC, np.asarray(jm.rows), np.asarray(jm.cols), np.asarray(jm.vals.mont),
        jm.shape, DEV)


def _port_circuit(jr1cs, jasg):
    mats = [(np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.vals.mont), m.shape)
            for m in (jr1cs.left, jr1cs.right, jr1cs.out)]
    return (interop.sparse_r1cs_from_numpy(TSPEC, mats, DEV),
            interop.fp_from_numpy(TSPEC, np.asarray(jasg.mont), DEV))


@pytest.mark.parametrize("domain", ["standard", "montgomery"])
def test_segment_sum_mod_matches_reference(domain):
    """Segments with many duplicates (sums far above p), empty segments, the
    edge values 0 and r - 1."""
    rng = random.Random(2)
    nnz, nseg = 500, 37
    vals = [rng.randrange(P) for _ in range(nnz - 40)] + [P - 1] * 30 + [0] * 10
    segs = [rng.randrange(nseg - 2) for _ in range(nnz - 40)] + [3] * 30 + [4] * 10
    v_np = np.asarray(jlimb.from_int(JSPEC, vals))
    if domain == "montgomery":
        v_np = np.asarray(jlimb.to_mont(JSPEC, jnp.asarray(v_np)))
    want = jlimb.segment_sum_mod(JSPEC, jnp.asarray(v_np), jnp.asarray(np.array(segs)),
                                 nseg)
    got = tlimb.segment_sum_mod(TSPEC, interop.limbs_from_numpy(v_np, DEV),
                                torch.tensor(segs), nseg)
    _same(got, want)
    if domain == "standard":
        exp = [0] * nseg
        for v, s in zip(vals, segs):
            exp[s] = (exp[s] + v) % P
        assert [int(x) for x in tlimb.to_int(TSPEC, got)] == exp


def test_sparse_matvec_and_col_accumulate_match_reference():
    rng = random.Random(3)
    m, d = 16, 10
    entries = [(rng.randrange(m), rng.randrange(d), rng.randrange(P)) for _ in range(40)]
    entries += [(5, 2, P - 1)] * 3  # duplicates accumulate
    jm = jsparse.SparseMatrix.from_entries(JSPEC, m, d, entries)
    tm = _port_matrix(jm)
    own = tsparse.SparseMatrix.from_entries(TSPEC, m, d, entries, DEV)
    _same(own.vals.mont, jm.vals.mont)
    a = JFp.from_int(JSPEC, [rng.randrange(P) for _ in range(d)])
    w = JFp.from_int(JSPEC, [rng.randrange(P) for _ in range(m)])
    ta, tw = (interop.fp_from_numpy(TSPEC, np.asarray(x.mont), DEV) for x in (a, w))
    np.testing.assert_array_equal(interop.fp_to_numpy(tm.matvec(ta)),
                                  np.asarray(jm.matvec(a).mont))
    _same(own.matvec(ta).mont, jm.matvec(a).mont)
    _same(tm.col_accumulate(tw).mont, jm.col_accumulate(w).mont)


def test_square_chain_matches_reference():
    m = 16
    jr1cs, jasg = jsparse.square_chain(JSPEC, m)
    r1cs, asg = tsparse.square_chain(TSPEC, m, device=DEV)
    _same(asg.mont, jasg.mont)
    for tm, jm in zip((r1cs.left, r1cs.right, r1cs.out),
                      (jr1cs.left, jr1cs.right, jr1cs.out)):
        assert tm.shape == jm.shape
        np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
        np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
        _same(tm.vals.mont, jm.vals.mont)
    assert r1cs.is_satisfied(asg) and jr1cs.is_satisfied(jasg)
    for tu, ju in zip(r1cs.matvecs(asg), jr1cs.matvecs(jasg)):
        _same(tu.mont, ju.mont)
    bad = interop.fp_from_numpy(TSPEC, np.asarray(jasg.mont), DEV)
    bad.mont[:, 3] = asg.mont[:, 4]
    assert not r1cs.is_satisfied(bad)


def test_qap_combine_and_h_poly_match_reference():
    m = 16
    jr1cs, jasg = jsparse.square_chain(JSPEC, m)
    r1cs, asg = _port_circuit(jr1cs, jasg)
    jqap, qap = jsparse.SparseQAP(jr1cs), tsparse.SparseQAP(r1cs)
    for tp, jp in zip(qap.combine(asg), jqap.combine(jasg)):
        _same(tp.coef.mont, jp.coef.mont)
    _same(qap.h_poly(asg).coef.mont, jqap.h_poly(jasg).coef.mont)
    _same(qap.t.mont, jqap.t.mont)


def test_poly_ops_match_reference():
    """Poly's from_int_coeffs, pad_to, scale_const, + and - of unequal
    capacities, carried across interop both ways."""
    rng = random.Random(7)
    a, b = ([rng.randrange(P) for _ in range(k)] for k in (5, 9))
    c = rng.randrange(P)
    ja, jb = JPoly.from_int_coeffs(JSPEC, a), JPoly.from_int_coeffs(JSPEC, b)
    ta = Poly.from_int_coeffs(TSPEC, a, DEV)
    tb = interop.poly_from_numpy(TSPEC, np.asarray(jb.coef.mont), DEV)
    tc, jc = Fp.from_int(TSPEC, c, DEV), JFp.from_int(JSPEC, c)
    for got, want in ((ta.pad_to(7), ja.pad_to(7)), (ta + tb, ja + jb), (tb - ta, jb - ja),
                      (ta.scale_const(tc), ja.scale_const(jc))):
        np.testing.assert_array_equal(interop.poly_to_numpy(got), np.asarray(want.coef.mont))
    assert [int(v) for v in (ta - tb).coef.to_int()] == \
        [(x - y) % P for x, y in zip(a + [0] * 4, b)]


def _shifted_h_case(m: int, seed: int):
    rng = random.Random(seed)
    jr1cs, jasg = jsparse.square_chain(JSPEC, m, x0=rng.randrange(2, P))
    r1cs, asg = _port_circuit(jr1cs, jasg)
    deltas = [rng.randrange(P) for _ in range(3)]
    got = tpin.get_shifted_h(tsparse.SparseQAP(r1cs), asg, *deltas)
    want = jpin.get_shifted_h(jsparse.SparseQAP(jr1cs), jasg, *deltas)
    np.testing.assert_array_equal(interop.poly_to_numpy(got), np.asarray(want.coef.mont))
    return r1cs, asg, deltas, got


def test_get_shifted_h_matches_reference():
    """The slice as a whole at m = 2^4, and the Pinocchio identity
    (ell + d_ell t)(r + d_r t) - (o + d_o t) = H t at a random point."""
    m = 1 << 4
    r1cs, asg, (dl, dr, do), H = _shifted_h_case(m, 16)
    ell, r, o = tsparse.SparseQAP(r1cs).combine(asg)
    s = random.Random(1).randrange(P)
    ev = lambda poly: sum(int(c) * pow(s, i, P) for i, c in
                          enumerate(poly.coef.to_int())) % P
    t = (pow(s, m, P) - 1) % P
    assert ((ev(ell) + dl * t) * (ev(r) + dr * t) - (ev(o) + do * t) - ev(H) * t) % P == 0


@pytest.mark.slow  # about 37 s, most of it the JAX package's CPU compile
def test_get_shifted_h_matches_reference_four_step():
    """m = 2^13: the coset transforms (2^14 points) take the four-step path
    with its tables, the INTTs at m the Stockham path."""
    _shifted_h_case(1 << 13, 13)
