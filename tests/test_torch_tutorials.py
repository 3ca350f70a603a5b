"""Port parity: the tutorial ladders, host polynomials and the GT pairing.

The nine cases of tests/test_tutorial_protocols.py run on the port's
``protocols/tutorial_single_poly.py`` and ``protocols/tutorial_snark.py``
(honest provers accepted, wrong witnesses rejected, each attack succeeding
or failing as in the reference), and the JAX package runs each beside it from
the same ``random.Random`` seeds: the values, keys and proofs (host ints and
host points) are equal.  ``utils/hostpoly`` equals the JAX copy on a handful
of inputs, and the port's pairing by its C++ engine equals the pure-Python
loop ``optimal_ate_pairing_ref`` and the JAX package's pairing, coefficient
for coefficient, and is bilinear; the host Miller loop gives the Weil and
Tate pairings' known vectors on tests/test_curves.py's toy curve.  Host code
only: no kernel runs.
"""

import random

import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.protocols import tutorial_single_poly as jtsp
from myzkp_tpu.protocols import tutorial_snark as jts
from myzkp_tpu.utils import hostpoly as jhp
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields import host
from myzkp_tpu_torch.protocols import tutorial_single_poly as tsp
from myzkp_tpu_torch.protocols import tutorial_snark as ts
from myzkp_tpu_torch.utils import hostpoly as hp

# one intra-op thread: the test processes (pytest-xdist) already share the
# cores (nothing here runs on tensors, but the modules import torch)
torch.set_num_threads(1)
R = bn254.R


def _ints(v):
    """Host points of either package, in any nesting of lists, dicts and
    dataclasses -> the same structure of ints (None at infinity)."""
    if hasattr(v, "inf"):
        if v.inf:
            return None
        if hasattr(v.x, "c"):
            return tuple(tuple(c.v for c in e.c) for e in (v.x, v.y))
        return int(v.x), int(v.y)
    if isinstance(v, dict):
        return {k: _ints(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_ints(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return {k: _ints(getattr(v, k)) for k in v.__dataclass_fields__}
    return v


def test_hostpoly_matches_reference():
    rng = random.Random(1)
    a, b = ([rng.randrange(R) for _ in range(k)] for k in (7, 3))
    xs, ys = [1, 2, 5, 9], [rng.randrange(R) for _ in range(4)]
    for name, args in (("trim", (a + [0, 0], R)), ("degree", (a, R)), ("add", (a, b, R)),
                       ("sub", (b, a, R)), ("mul", (a, b, R)), ("scale", (a, 12345, R)),
                       ("divmod_poly", (a, b, R)), ("evaluate", (a, 77, R)),
                       ("eval_m1", (a, 77, R)), ("from_monomials", (xs, R)),
                       ("interpolate", (xs, ys, R))):
        assert getattr(hp, name)(*args) == getattr(jhp, name)(*args), name
    assert hp.degree([0, 0], R) == -1
    with pytest.raises(ZeroDivisionError):
        hp.divmod_poly(a, [0], R)


def test_pairing_matches_reference_and_is_bilinear():
    rng = random.Random(2)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    p, q = bn254.g1_generator() * a, bn254.g2_generator() * b
    e = bn254.optimal_ate_pairing(p, q)
    assert e == bn254.optimal_ate_pairing_ref(p, q)
    want = jbn.optimal_ate_pairing(jbn.g1_generator() * a, jbn.g2_generator() * b)
    assert [c.v for c in e.c] == [c.v for c in want.c]
    assert e == bn254.optimal_ate_pairing(bn254.g1_generator(), bn254.g2_generator()) ** (a * b)
    one = bn254.Fq12([1])
    assert bn254.optimal_ate_pairing(bn254.curve_g1.infinity(), q) == one
    assert e != one


def test_weil_and_tate_pairings_known_vectors():
    """tests/test_curves.py's toy curve over F_631 (the reference's
    curve.rs:429-556 vectors) through the port's host Miller loop."""
    F = host.PyField(631)
    curve = host.PyCurve(F(30), F(34))
    P, Q, S = curve.point(F(36), F(60)), curve.point(F(121), F(387)), curve.point(F(0), F(36))
    fp_qs, fp_s = host.miller(P, Q + S, 5)[0], host.miller(P, S, 5)[0]
    assert (int(fp_qs), int(fp_s), int(fp_qs / fp_s)) == (103, 219, 473)
    fq_ps, fq_s = host.miller(Q, P + (-S), 5)[0], host.miller(Q, -S, 5)[0]
    assert (int(fq_ps), int(fq_s), int(fq_ps / fq_s)) == (284, 204, 88)
    w = host.weil_pairing(P, Q, 5, S)
    Pp, Qp = curve.point(F(617), F(5)), curve.point(F(121), F(244))
    assert int(w) == 242 and P * 3 == Pp and Q * 4 == Qp
    assert int(host.weil_pairing(Pp, Qp, 5, S)) == 512 == int(w ** 12)
    assert int(host.weil_pairing(Pp, Pp, 5, S)) == 1
    assert host.general_tate_pairing(P, Q, 5, 1, 631, S) ** 12 == \
        host.general_tate_pairing(Pp, Qp, 5, 1, 631, S)
    assert host.tate_pairing(P, Q, 5, 1, 631) ** 12 == host.tate_pairing(Pp, Qp, 5, 1, 631)


# ---------------------------------------------------------------------------
# Ladder 1: single polynomial
# ---------------------------------------------------------------------------

def test_p1_naive():
    roots = [1, 2, 3, 4, 5]
    p31, t31 = hp.from_monomials(roots, 31), hp.from_monomials(roots[:3], 31)
    values = []
    for mod in (tsp, jtsp):
        prover = mod.Prover1(p31, t31, 31)
        assert mod.naive_protocol(prover, mod.Verifier1(roots[:3], 31))
        values.append(prover.compute_all_values())
    assert values[0] == values[1]
    with pytest.raises(ValueError):
        tsp.Prover1(t31, p31, 31)  # p does not divide t


def test_p2_schwartz_zippel_and_attack():
    pR, tR = hp.from_monomials([1, 2, 3], R), hp.from_monomials([1, 2], R)
    runs = []
    for mod in (tsp, jtsp):
        vf = mod.Verifier2(tR, R, rng=random.Random(0))
        s = vf.generate_challenge()
        honest = mod.Prover2(pR, tR, R).compute_values(s)
        forged = mod.MaliciousProver2(tR, R, rng=random.Random(1)).compute_malicious_values(s)
        assert vf.verify(s, *honest) and vf.verify(s, *forged)
        runs.append((s, honest, forged))
    assert runs[0] == runs[1]


def test_p3_discrete_log_and_attack():
    pS, tS = tsp.signed_from_monomials([1, 2, 3]), tsp.signed_from_monomials([1, 2])
    assert (pS, tS) == (jtsp.signed_from_monomials([1, 2, 3]), jtsp.signed_from_monomials([1, 2]))
    runs = []
    for mod in (tsp, jtsp):
        vf = mod.Verifier3(tS, R, 5, rng=random.Random(0))
        powers = vf.generate_challenge(2)
        honest = mod.Prover3(pS, tS, R).compute_values(vf.generate_challenge(3))
        forged = mod.MaliciousProver3(tS, R, rng=random.Random(1)).compute_malicious_values(powers)
        assert vf.verify(*honest) and vf.verify(*forged)
        assert mod.discrete_log_protocol(mod.Prover3(pS, tS, R), vf)
        runs.append((powers, honest, forged))
    assert runs[0] == runs[1]


def test_p4_p5_kea_zk():
    pS, tS = tsp.signed_from_monomials([1, 2, 3]), tsp.signed_from_monomials([1, 2])
    runs = []
    for mod in (tsp, jtsp):
        v4 = mod.Verifier4(tS, R, 5, rng=random.Random(0))
        assert mod.knowledge_of_exponent_protocol(mod.Prover4(pS, tS, R), v4)
        v5 = mod.Verifier5(tS, R, 5, rng=random.Random(3))
        challenge = v5.generate_challenge(4)
        proof = mod.Prover5(pS, tS, R, rng=random.Random(2)).compute_values(*challenge)
        assert v5.verify(*proof)
        runs.append((v4.s, v4.r, challenge, proof))
    assert runs[0] == runs[1]


def test_p6_non_interactive_pairing():
    pR, tR = hp.from_monomials([1, 2, 3], R), hp.from_monomials([1, 2], R)
    runs = []
    for mod in (tsp, jtsp):
        pk, vk = mod.setup6(tR, 3, rng=random.Random(0))
        proof = mod.prove6(pR, tR, pk, rng=random.Random(1))
        assert mod.verify6(proof, vk)
        runs.append(_ints((pk, vk, proof)))
    assert runs[0] == runs[1]
    # t does not divide p = (X - 1)(X - 3)(X - 4): the pairing check fails
    pk, vk = tsp.setup6(tR, 3, rng=random.Random(0))
    bad = tsp.prove6(hp.from_monomials([1, 3, 4], R), tR, pk, rng=random.Random(1))
    assert not tsp.verify6(bad, vk)


# ---------------------------------------------------------------------------
# Ladder 2: QAP SNARKs (reference example: 2*3=6, 5*7=35, 6*35=210)
# ---------------------------------------------------------------------------

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
# inconsistent per-matrix assignments (protocol_2.rs:278-309)
V_ELL = [1, 210, 2, 3, 5, 7, 6, 35]
V_R = [1, 1, 1, 1, 1, 1, 1, 1]
V_O = [1, 6, 0, 0, 0, 0, 2, 5]


@pytest.fixture(scope="module")
def qaps():
    """The port's and the JAX package's host QAP of the circuit."""
    tq, jq = ts.HostQAP.from_r1cs(LEFT, RIGHT, OUT), jts.HostQAP.from_r1cs(LEFT, RIGHT, OUT)
    assert (tq.ell, tq.r, tq.o, tq.t, tq.m, tq.d) == (jq.ell, jq.r, jq.o, jq.t, jq.m, jq.d)
    assert ts.get_h(tq, WITNESS) == jts.get_h(jq, WITNESS)
    return {ts: tq, jts: jq}


def _both(qaps, run):
    """run(module, qap) in both packages; their host ints must agree."""
    got, want = (_ints(run(mod, q)) for mod, q in qaps.items())
    assert got == want


def test_snark_p2_accept_reject_and_attack_succeeds(qaps):
    def run(mod, q):
        pk, vk = mod.setup2(q, rng=random.Random(5))
        proof = mod.prove2(pk, q, WITNESS)
        assert mod.verify2(proof, vk)
        wrong = mod.prove2(pk, q, WRONG)
        assert not mod.verify2(wrong, vk)
        bogus = mod.inconsistent_variable_attack(pk, q, V_ELL, V_R, V_O)
        assert mod.verify2(bogus, vk), "P2 attack must succeed"
        return pk, vk, proof, wrong, bogus
    _both(qaps, run)


def test_snark_p3_attack_fails(qaps):
    def run(mod, q):
        pk, vk = mod.setup3(q, rng=random.Random(6))
        proof = mod.prove3(pk, q, WITNESS)
        assert mod.verify3(proof, vk)
        bogus = mod.inconsistent_variable_attack(pk, q, V_ELL, V_R, V_O)
        assert not mod.verify3(bogus, vk), "P3 checksum must catch the attack"
        return pk, vk, proof, bogus
    _both(qaps, run)


def test_snark_p1_accept_reject(qaps):
    def run(mod, q):
        pk, vk = mod.setup1(q, rng=random.Random(7))
        proof = mod.prove1(pk, q, WITNESS)
        assert mod.verify1(proof, vk)
        assert not mod.verify1(mod.prove1(pk, q, WRONG), vk)
        swapped = mod.interchange_attack(proof)
        assert swapped.g1_ell == proof.g1_o and swapped.g1_ell_prime == proof.g1_o_prime
        return pk, vk, proof
    _both(qaps, run)


def test_snark_p4_p5_accept(qaps):
    def run(mod, q):
        rng = random.Random(8)
        pk4, vk4 = mod.setup4(q, rng=rng)
        proof4 = mod.prove4(pk4, q, WITNESS)
        assert mod.verify4(proof4, vk4)
        pk5, vk5 = mod.setup5(q, rng=rng)
        proof5 = mod.prove5(pk5, q, WITNESS)
        assert mod.verify5(proof5, vk5)
        bogus = mod.inconsistent_variable_attack(pk5, q, V_ELL, V_R, V_O)
        assert not mod.verify5(bogus, vk5), "P5 must reject the attack"
        return pk4, vk4, proof4, pk5, vk5, proof5
    _both(qaps, run)
