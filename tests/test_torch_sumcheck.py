"""Port parity: both sumcheck provers of myzkp_tpu_torch
(protocols/sumcheck.py, protocols/sumcheck_tpu.py) against myzkp_tpu.

The symbolic sumcheck (round polynomials g_j, their transcript bytes, the
fold, the coefficient vector) is pure Python in the JAX package, so it is
compared at every round on seeded polynomials with exponents above 1, short
exponent tuples and a constant term.  The table prover (CPU plain versions
of its products) is held to the JAX package's device prover at num_vars 3
and to its pure-host mirror at 1, 3, 4, 6 and 8: the claimed sum and every
round polynomial equal (tolerance 0), the verifier accepting, and rejecting
a changed claimed sum or round coefficient.  The Gemini-tied sumcheck runs
at el = 3 on one degree-16 SRS from a known s: its commitments equal
[f_i(s)]G1 of the host folds, and the verifier accepts it and rejects a
changed h or g_j.  The whole proof against the JAX package's
``prove_sumcheck`` on one SRS needs the JAX package's KZG compiles
(minutes on the CPU), so it is marked ``slow``.
"""

import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.ops.mpoly import MPoly as JMPoly
from myzkp_tpu.protocols import sumcheck as jsc
from myzkp_tpu.protocols import sumcheck_tpu as jst
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.commit import kzg
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.fields.spec import bn254_r_spec
from myzkp_tpu_torch.ops.mpoly import MPoly
from myzkp_tpu_torch.protocols import sumcheck as sc
from myzkp_tpu_torch.protocols import sumcheck_tpu as st
from test_torch_mpoly import _ints, both, random_dict

DEV = "cpu"
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
R = jbn.R
JSPEC, SPEC = jbn.r_spec(), bn254_r_spec()
S = 0x1F2E3D4C5B6A798897A6B5C4D3E2F10123456789ABCDEF  # the toxic waste
G1 = bn254.g1_generator()


# ---------------------------------------------------------------------------
# The symbolic sumcheck
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    """fn's value, or the type of what it raised (a g_j that zero
    challenges cut below j + 1 variables has no x_j to fold)."""
    try:
        return fn(*args)
    except IndexError as e:
        return type(e)


@pytest.mark.parametrize("el, max_exp, ragged", [(1, 1, False), (4, 1, False),
                                                  (5, 3, True), (6, 2, True)])
def test_build_gj_from_prefix_matches_jax(el, max_exp, ragged):
    """Every round's g_j (dict and transcript bytes) equal to the JAX
    package's literal loop, at random challenges and at 0 and 1; then
    sumcheck_fold of each."""
    rng = np.random.default_rng(100 + el)
    g, jg = both(random_dict(rng, el, 7, max_exp, ragged))
    for rs_all in (_ints(el, rng), [0, 1] * el, [R + 3] * el):
        for j in range(el):
            got, want = sc.build_gj_from_prefix(g, rs_all[:j]), \
                jsc.build_gj_from_prefix(jg, rs_all[:j])
            assert got.d == want.d
            assert sc._mpoly_bytes(got) == jsc._mpoly_bytes(want)
            assert _outcome(sc.sumcheck_fold, got, j) == _outcome(jsc.sumcheck_fold, want, j)
    with pytest.raises(AssertionError):
        sc.build_gj_from_prefix(g, [1] * el)


def test_build_gj_constant_and_cancelling_terms():
    """A constant-only g over padded keys, terms whose contributions cancel
    and the zero polynomial's fold: equal to the JAX package's."""
    d = {(0, 0, 0): 5, (1, 1): 3, (1,): R - 6, (0, 1, 1): 2, (0, 0, 1): R - 4}
    g, jg = both(d)
    for rs in ([], [7], [7, 2]):
        got, want = sc.build_gj_from_prefix(g, rs), jsc.build_gj_from_prefix(jg, rs)
        assert got.d == want.d and sc._mpoly_bytes(got) == jsc._mpoly_bytes(want)
    zero, jzero = both({})
    assert sc._mpoly_bytes(zero) == jsc._mpoly_bytes(jzero)


def test_coefs_in_order_matches_jax():
    """get_coefs_in_order (keys of length el with 0 / 1 exponents only, as
    the JAX package's lookup finds them) and the device coefficient vector
    equal to Fp.from_int of that list."""
    rng = np.random.default_rng(110)
    for d in (random_dict(rng, 5, 8), random_dict(rng, 4, 6, 2, True)):
        g, jg = both(d)
        coefs = sc.get_coefs_in_order(g)
        assert coefs == jsc.get_coefs_in_order(jg)
        assert torch.equal(sc._coef_vector(g, DEV).mont, Fp.from_int(SPEC, coefs, DEV).mont)
    assert list(sc.bit_combinations(3, 5)) == list(jsc.bit_combinations(3, 5))


# ---------------------------------------------------------------------------
# The table prover
# ---------------------------------------------------------------------------

def _factors(rng, num_vars: int, k: int = 3, terms: int = 6) -> list:
    return [random_dict(rng, num_vars, terms) for _ in range(k)]


def _check_verifier(proof, factors) -> None:
    """Accepts the proof; rejects a changed claimed sum and a changed
    round coefficient."""
    v = st.SumCheckVerifier(SPEC)
    assert v.verify(proof, factors)
    bad = st.ProductSumcheckProof(proof.el, (proof.claimed_sum + 1) % R, proof.round_polys)
    assert not v.verify(bad, factors)
    rp = [list(c) for c in proof.round_polys]
    rp[-1][1] = (rp[-1][1] + 1) % R
    assert not v.verify(st.ProductSumcheckProof(proof.el, proof.claimed_sum, rp), factors)


def test_table_prover_matches_jax_device_prover():
    """num_vars = 3 (the JAX tests' size): the table ops and the proof equal
    to the JAX package's SumCheckProverTPU."""
    rng = np.random.default_rng(45)
    ds = _factors(rng, 3)
    factors, jfactors = zip(*(both(d) for d in ds))
    tabs = [st.eval_all_binary_combinations(g, 3, DEV) for g in factors]
    jtabs = [jst.eval_all_binary_combinations(g, 3) for g in jfactors]
    for t, jt in zip(tabs, jtabs):
        np.testing.assert_array_equal(interop.fp_to_numpy(t), np.asarray(jt.mont))
    r = _ints(1, rng)[0]
    from myzkp_tpu.fields.fp import Fp as JFp

    pairs = [(st.fold_factors_pointwise(tabs), jst.fold_factors_pointwise(jtabs)),
             (st.fold_into_half(tabs[0], r), jst.fold_into_half(jtabs[0], JFp.from_int(JSPEC, r))),
             (st.eval_folded_poly(tabs[1], Fp.from_int(SPEC, 3, DEV)),
              jst.eval_folded_poly(jtabs[1], JFp.from_int(JSPEC, 3))),
             (st.table_sum(tabs[2]), jst.table_sum(jtabs[2]))]
    for got, want in pairs:
        np.testing.assert_array_equal(interop.fp_to_numpy(got), np.asarray(want.mont))
    proof = st.SumCheckProverTPU(SPEC, 3, DEV).prove(list(factors), 3)
    want = jst.SumCheckProverTPU(JSPEC, 3).prove(list(jfactors), 3)
    assert (proof.el, proof.claimed_sum, proof.round_polys) == \
        (want.el, want.claimed_sum, want.round_polys)
    _check_verifier(proof, list(factors))
    assert jst.SumCheckVerifier(JSPEC).verify(want, list(jfactors))


@pytest.mark.parametrize("num_vars", [1, 3, 4, 6, 8])
def test_table_prover_matches_host_mirror(num_vars):
    """The claimed sum and every round polynomial equal to the JAX
    package's pure-host mirror (and to the port's), at degree 3 and at
    degree 2 on two factors with 8 terms each."""
    rng = np.random.default_rng(200 + num_vars)
    for k, terms in ((3, 6), (2, 8)):
        ds = _factors(rng, num_vars, k, terms)
        factors, jfactors = [MPoly(SPEC, d) for d in ds], [JMPoly(JSPEC, d) for d in ds]
        proof = st.SumCheckProverTPU(SPEC, k, DEV).prove(factors, num_vars)
        want = jst.SumCheckProverHost(JSPEC, k).prove(jfactors, num_vars)
        host = st.SumCheckProverHost(SPEC, k).prove(factors, num_vars)
        for p in (proof, host):
            assert (p.el, p.claimed_sum, p.round_polys) == \
                (want.el, want.claimed_sum, want.round_polys)
        _check_verifier(proof, factors)


# ---------------------------------------------------------------------------
# The Gemini-tied sumcheck
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srs():
    return kzg.setup(16, s=S, full_g2=True, device=DEV)


def _ev(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + int(c)) % R
    return acc


def _challenges(proof) -> list:
    """The rs of a proof, replayed from its transcript."""
    stream = sc._transcript(proof.el, proof.h)
    return [sc._round_challenge(SPEC, stream, g_j) for g_j in proof.gs]


def _tampered(proof, **kw):
    return sc.SumCheckProof(**{**proof.__dict__, **kw})


def test_prove_verify_sumcheck_gemini(srs):
    """el = 3: h from the hypercube sum; c_g equal to [f_i(s)]G1 of the
    host folds of get_coefs_in_order(g) at the proof's rs; g_j equal to
    the JAX package's at those rs; the verifier accepts, and rejects a
    changed h and a changed g_j (the proof tampered, not re-proved)."""
    rng = np.random.default_rng(103)
    g, jg = both(random_dict(rng, 3, 4))
    h = sc.sum_over_boolean_hypercube(g, DEV)
    assert h == sum(g.evaluate(c) for c in sc.bit_combinations(3)) % R
    proof = sc.prove_sumcheck(g, h, srs)
    rs = _challenges(proof)
    assert [x.d for x in proof.gs] == \
        [jsc.build_gj_from_prefix(jg, rs[:j]).d for j in range(3)]
    folds = [sc.get_coefs_in_order(g)]
    for rho in rs:
        f = folds[-1]
        folds.append([(f[2 * i] + rho * f[2 * i + 1]) % R for i in range(len(f) // 2)])
    assert proof.c_g == [G1 * _ev(f, S) for f in folds]
    assert sc.verify_sumcheck(proof, srs)
    assert not sc.verify_sumcheck(_tampered(proof, h=(h + 1) % R), srs)
    gs = list(proof.gs)
    gs[1] = gs[1] + MPoly.constant(SPEC, 1)
    assert not sc.verify_sumcheck(_tampered(proof, gs=gs), srs)


def _affine(pt) -> tuple:
    if pt.inf:
        return None
    if hasattr(pt.x, "c"):
        return tuple(int(c.v) for c in pt.x.c), tuple(int(c.v) for c in pt.y.c)
    return int(pt.x), int(pt.y)


@pytest.mark.slow
def test_prove_sumcheck_matches_jax():
    """The whole SumCheckProof equal to the JAX package's prove_sumcheck on
    one SRS (the JAX key's powers carried by interop.kzg_pk_from_numpy):
    h, g_j, c_g and Gemini's proof; both verifiers accept it and reject a
    changed h."""
    import jax

    from myzkp_tpu.commit import kzg as jkzg

    jpk = jkzg.setup(8, s=S, full_g2=True)
    leaves = lambda pt: [np.asarray(a) for a in jax.tree_util.tree_leaves(pt)]
    pk = interop.kzg_pk_from_numpy(leaves(jpk.powers1), leaves(jpk.powers2), DEV)
    rng = np.random.default_rng(104)
    d = random_dict(rng, 3, 4)
    g, jg = interop.mpoly_from_dict(SPEC, d), JMPoly(JSPEC, d)
    h = jsc.sum_over_boolean_hypercube(jg)
    proof, want = sc.prove_sumcheck(g, h, pk), jsc.prove_sumcheck(jg, h, jpk)
    assert (proof.h, proof.el) == (want.h, want.el)
    assert [x.d for x in proof.gs] == [x.d for x in want.gs]
    assert list(map(_affine, proof.c_g)) == list(map(_affine, want.c_g))
    assert [(ys, _affine(w)) for ys, w in proof.pi.es] == \
        [(ys, _affine(w)) for ys, w in want.pi.es]
    assert list(map(_affine, proof.pi.degree_proofs)) == \
        list(map(_affine, want.pi.degree_proofs))
    assert sc.verify_sumcheck(proof, pk) and jsc.verify_sumcheck(want, jpk)
    bad, jbad = _tampered(proof, h=(h + 1) % R), jsc.SumCheckProof(
        **{**want.__dict__, "h": (h + 1) % R})
    assert not sc.verify_sumcheck(bad, pk) and not jsc.verify_sumcheck(jbad, jpk)
