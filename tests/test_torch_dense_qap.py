"""Port parity: the dense R1CS and QAP, and Pinocchio and Groth16 on them.

``R1CS`` (``matvecs``, ``is_satisfied``), ``QAP.from_r1cs`` in both domains
(its ell, r, o, t, ``combine``, ``h_poly``, ``eval_all_at``) and the dense
branch of ``get_shifted_h`` and Groth16's h of myzkp_tpu_torch are held to
myzkp_tpu limb for limb (the tolerance is 0: modular integers) on the
reference's teaching circuit and on square chains, the JAX objects carried across by
``interop.r1cs_from_numpy`` / ``qap_from_numpy``.  On the root-of-unity
domain the dense QAP's keys and proof equal the sparse QAP's under the same
rng; on the natural domain Pinocchio accepts the witness and rejects a wrong
one, and Groth16 accepts its proof and rejects a wrong public input.  On the
CPU the port runs its kernels' plain versions.
"""

import random

import numpy as np
import pytest
import torch

from myzkp_tpu.arith.qap import QAP as JQAP
from myzkp_tpu.arith.r1cs import R1CS as JR1CS
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import BN254_R, FieldSpec
from myzkp_tpu.snark import groth16 as jg16
from myzkp_tpu.snark import pinocchio as jpin
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse as tsparse
from myzkp_tpu_torch.arith.qap import QAP
from myzkp_tpu_torch.arith.r1cs import R1CS
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.snark import groth16 as tg16
from myzkp_tpu_torch.snark import pinocchio as tpin

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
JSPEC, TSPEC = FieldSpec.make(BN254_R), tspec.FieldSpec.make(BN254_R)
P = BN254_R

# tests/test_snark_pipeline.py's circuit: 2 * 3 = 6, 5 * 7 = 35, 6 * 35 = 210
LEFT = [[0, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 1, 0]]
RIGHT = [[0, 0, 0, 1, 0, 0, 0, 0],
         [0, 0, 0, 0, 0, 1, 0, 0],
         [0, 0, 0, 0, 0, 0, 0, 1]]
OUT = [[0, 0, 0, 0, 0, 0, 1, 0],
       [0, 0, 0, 0, 0, 0, 0, 1],
       [0, 1, 0, 0, 0, 0, 0, 0]]
WITNESS = [1, 210, 2, 3, 5, 7, 6, 35]
WRONG = [1, 210, 2, 3, 5, 7, 6, 36]


def _teaching(pad: bool):
    """The teaching circuit, padded to m = 4 by a trivially true row for the
    root-of-unity domain."""
    extra = [[0] * 8] if pad else []
    return (LEFT + extra, RIGHT + extra, OUT + extra), WITNESS, WRONG


def _chain(m: int, x0: int = 3):
    """square_chain(m) as dense matrices: witness [1, x_0, ..., x_m], row k
    x_k * x_k = x_(k+1)."""
    d = m + 2
    mats = tuple([[int(j == k + off) for j in range(d)] for k in range(m)]
                 for off in (1, 1, 2))
    xs = [1, x0]
    for _ in range(m):
        xs.append(xs[-1] * xs[-1] % P)
    wrong = xs[:m // 2 + 1] + [12345] + xs[m // 2 + 2:]
    return mats, xs, wrong


CIRCUITS = {"teaching": lambda: _teaching(False), "teaching4": lambda: _teaching(True),
            "chain4": lambda: _chain(4), "chain8": lambda: _chain(8)}


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))


def _both(name: str):
    """The circuit in both packages: (JAX R1CS, port R1CS carried across,
    port R1CS built from the ints), and the two assignments in each."""
    mats, wit, wrong = CIRCUITS[name]()
    jr = JR1CS.from_ints(JSPEC, *mats)
    tr = interop.r1cs_from_numpy(TSPEC, *(np.asarray(m.mont) for m in
                                          (jr.left, jr.right, jr.out)), DEV)
    own = R1CS.from_ints(TSPEC, *mats, device=DEV)
    jas = [JFp.from_int(JSPEC, w) for w in (wit, wrong)]
    tas = [Fp.from_int(TSPEC, w, DEV) for w in (wit, wrong)]
    return jr, tr, own, jas, tas


@pytest.mark.parametrize("name", ["teaching", "chain4"])
def test_r1cs_matches_reference(name):
    jr, tr, own, (ja, jbad), (ta, tbad) = _both(name)
    for tm, om, jm in zip((tr.left, tr.right, tr.out), (own.left, own.right, own.out),
                          (jr.left, jr.right, jr.out)):
        _same(om.mont, jm.mont)
        _same(tm.mont, jm.mont)
    assert (tr.num_constraints, tr.witness_len) == (jr.num_constraints, jr.witness_len)
    for got, want in zip(tr.matvecs(ta), jr.matvecs(ja)):
        _same(got.mont, want.mont)
    assert own.is_satisfied(ta) and jr.is_satisfied(ja)
    assert not own.is_satisfied(tbad) and not jr.is_satisfied(jbad)


@pytest.mark.parametrize("domain,name", [("natural", "teaching"), ("natural", "chain8"),
                                         ("rou", "teaching4"), ("rou", "chain8")])
def test_qap_matches_reference(domain, name):
    """ell, r, o, t; combine, h_poly, eval_all_at; the dense get_shifted_h;
    the same from a port QAP built of the JAX QAP's arrays."""
    jr, tr, _, (ja, _), (ta, _) = _both(name)
    jq, tq = JQAP.from_r1cs(jr, domain=domain), QAP.from_r1cs(tr, domain=domain)
    for got, want in zip((tq.ell, tq.r, tq.o, tq.t), (jq.ell, jq.r, jq.o, jq.t)):
        _same(got.mont, want.mont)
    carried = interop.qap_from_numpy(TSPEC, *(np.asarray(a.mont) for a in
                                              (jq.ell, jq.r, jq.o, jq.t)), jq.m, jq.d, DEV)
    assert tq._is_rou_target() == (domain == "rou")
    for got, want in zip(tq.combine(ta), jq.combine(ja)):
        _same(got.coef.mont, want.coef.mont)
    want_h = np.asarray(jq.h_poly(ja).coef.mont)
    _same(tq.h_poly(ta).coef.mont, want_h)
    _same(carried.h_poly(ta).coef.mont, want_h)
    s = random.Random(5).randrange(1, P)
    for got, want in zip(tq.eval_all_at(s), jq.eval_all_at(s)):
        _same(got.mont, want.mont)
    deltas = [random.Random(6 + k).randrange(1, P) for k in range(3)]
    _same(tpin.get_shifted_h(tq, ta, *deltas).coef.mont,
          jpin.get_shifted_h(jq, ja, *deltas).coef.mont)
    _same(tg16._uvh(tq, ta)[2].mont, jg16._h_coeffs(jq, ja).mont)


def test_natural_domain_row_batches(monkeypatch):
    """The natural domain's interpolation in batches of rows (the bound on
    its (rows, m, m) product) gives the one-batch coefficients."""
    from myzkp_tpu_torch.arith import qap as tqap

    tr = R1CS.from_ints(TSPEC, *_chain(4)[0], device=DEV)
    whole = QAP.from_r1cs(tr)
    monkeypatch.setattr(tqap, "_LAGRANGE_ELEMS", 4 * 4 * 4)  # 4 rows a batch of d = 6
    batched = QAP.from_r1cs(tr)
    for got, want in zip((batched.ell, batched.r, batched.o), (whole.ell, whole.r, whole.o)):
        assert torch.equal(got.mont, want.mont)


def _leaves(pk) -> list:
    return [t for v in vars(pk).values() if isinstance(v, tw.Point) for t in tw.leaves(v)]


def test_dense_rou_keys_and_proof_equal_sparse():
    """square_chain(8) as a dense root-of-unity QAP and as the sparse QAP:
    both interpolate over the same roots, so the keys are equal batch for
    batch and the proofs point for point; the verifier accepts."""
    mats, wit, _ = _chain(8)
    dense = QAP.from_r1cs(R1CS.from_ints(TSPEC, *mats, device=DEV), domain="rou")
    r1cs, asg = tsparse.square_chain(TSPEC, 8, device=DEV)
    sparse = tsparse.SparseQAP(r1cs)
    assert [int(v) for v in asg.to_int()] == wit
    (dpk, dvk), (spk, svk) = (tpin.setup(q, random.Random(21)) for q in (dense, sparse))
    assert dvk == svk
    for a, b in zip(_leaves(dpk), _leaves(spk), strict=True):
        assert torch.equal(a, b)
    deltas = (3, 5, 7)
    _same(tpin.get_shifted_h(dense, asg, *deltas).coef.mont,
          tpin.get_shifted_h(sparse, asg, *deltas).coef.mont.numpy())
    proof = tpin.prove(asg, dpk, dense, random.Random(22))
    assert proof == tpin.prove(asg, spk, sparse, random.Random(22))
    assert tpin.verify(proof, dvk)


def test_pinocchio_natural_domain_accept_reject():
    (mats, wit, wrong) = _teaching(False)
    qap = QAP.from_r1cs(R1CS.from_ints(TSPEC, *mats, device=DEV))
    pk, vk = tpin.setup(qap, random.Random(3))
    good, bad = (tpin.prove(Fp.from_int(TSPEC, w, DEV), pk, qap, random.Random(4))
                 for w in (wit, wrong))
    assert tpin.verify(good, vk)
    assert not tpin.verify(bad, vk)


def test_groth16_natural_domain_accept_reject():
    """Two public inputs (the one-wire and the output 210): the proof is
    accepted, and rejected under a wrong public input."""
    (mats, wit, _) = _teaching(False)
    qap = QAP.from_r1cs(R1CS.from_ints(TSPEC, *mats, device=DEV))
    pk, vk = tg16.setup(qap, 2, random.Random(8))
    proof = tg16.prove(Fp.from_int(TSPEC, wit, DEV), pk, qap, random.Random(9))
    assert tg16.verify(proof, vk, wit[:2])
    assert not tg16.verify(proof, vk, [1, 211])
