"""Port parity: Pinocchio setup, prove and verify of myzkp_tpu_torch on
square_chain(8), on the CPU.

One reference setup (myzkp_tpu.snark.pinocchio with a seeded random.Random)
is shared by the module and saved with myzkp_tpu.utils.serialize.  The port's
setup under the same seed gives the same keys as affine points.  One fresh
process, which never loads JAX, reads the saved keys through interop and
proves the witness with them, and runs the port's own setup and proves a
wrong witness with its key.  The first proof equals, point for point, the
proof computed on the host from the same toxic waste and deltas with Python
ints, and both packages' verifiers accept it; both reject the second.  The
comparison with the reference's own prove is marked slow (its CPU compile
alone takes about a minute).  Tolerance 0 throughout: modular integers.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from myzkp_tpu.arith import sparse as jsparse
from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.snark import pinocchio as jpin
from myzkp_tpu.utils import serialize
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse as tsparse
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.ops import ntt as tntt
from myzkp_tpu_torch.snark import pinocchio as tpin

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
M = 8  # constraints; witness [1, x_0, ..., x_8], d = 10
SEED = 11  # setup's rng; prove draws from random.Random(SEED + 1)
PROOF_FIELDS = ("g1_ell", "g2_r", "g1_o", "g1_ell_prime", "g2_r_prime",
                "g1_o_prime", "g1_h", "g1_z")
PK_FIELDS = tuple(f.name for f in dataclasses.fields(tpin.PinocchioProofKey))
R = tbn.R


def _ints(p):
    """A host point of either package -> None, (x, y) or ((x0, x1), (y0, y1))."""
    if p.inf:
        return None
    if hasattr(p.x, "c"):
        return tuple((e.c[0].v, e.c[1].v) for e in (p.x, p.y))
    return int(p.x), int(p.y)


def _key_ints(leaves_of) -> dict:
    """Affine ints of every point of a proving key, two batch inversions in
    all: the G1 fields (3 coordinate arrays) and the G2 fields (6) each go to
    the host as one batch.  leaves_of(field) -> the field's numpy arrays."""
    out = {}
    for to_host, nleaves in ((tbn.g1_points_to_host, 3), (tbn.g2_points_to_host, 6)):
        fields = [f for f in PK_FIELDS if len(leaves_of(f)) == nleaves]
        cat = [np.concatenate(a, axis=1) for a in zip(*map(leaves_of, fields))]
        pts = iter(to_host(interop.point_from_numpy(cat, DEV)))
        for f in fields:
            out[f] = [_ints(next(pts)) for _ in range(leaves_of(f)[0].shape[1])]
    return out


def _jax_leaves(pt) -> list:
    """A JAX point batch's coordinate arrays, in the order the port reads."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(pt)]


def _to_reference(p):
    """Port host point -> the JAX package's host point (for its verifier)."""
    v = _ints(p)
    if isinstance(v[0], tuple):
        return jbn.curve_g2.point(jbn.Fq2(list(v[0])), jbn.Fq2(list(v[1])))
    return jbn.curve_g1.point(jbn.Fq(v[0]), jbn.Fq(v[1]))


def _reference_proof(proof):
    return jpin.PinocchioProof(**{f: _to_reference(getattr(proof, f))
                                  for f in PROOF_FIELDS})


def _port_proof(coords: dict):
    """{field: None, (x, y) or ((x0, x1), (y0, y1))} -> the port's proof."""
    def point(f, v):
        curve = tbn.curve_g2 if f.startswith("g2") else tbn.curve_g1
        if v is None:
            return curve.infinity()
        if f.startswith("g2"):
            return curve.point(tbn.Fq2(v[0]), tbn.Fq2(v[1]))
        return curve.point(tbn.Fq(v[0]), tbn.Fq(v[1]))
    return tpin.PinocchioProof(**{f: point(f, coords[f]) for f in PROOF_FIELDS})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's setup on square_chain(M), its keys saved to disk."""
    r1cs, asg = jsparse.square_chain(jbn.r_spec(), M)
    qap = jsparse.SparseQAP(r1cs)
    pk, vk = jpin.setup(qap, rng=random.Random(SEED))
    d = tmp_path_factory.mktemp("keys")
    serialize.save_pinocchio_pk(str(d / "pk.npz"), pk)
    serialize.save_pinocchio_vk(str(d / "vk.json"), vk)
    return qap, asg, pk, vk, d


@pytest.fixture(scope="module")
def port_circuit():
    r1cs, asg = tsparse.square_chain(tbn.r_spec(), M, device=DEV)
    return tsparse.SparseQAP(r1cs), asg


_PORT_ALONE = """
import json, random, sys
from pathlib import Path
import torch
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.snark import pinocchio as pin

m, seed, keys = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
cpu = torch.device("cpu")
r1cs, asg = sparse.square_chain(bn254.r_spec(), m, device=cpu)
qap = sparse.SparseQAP(r1cs)
pk = interop.load_key(keys / "pk.npz", pin.PinocchioProofKey, cpu)
vk = interop.load_pinocchio_vk(keys / "vk.json")
good = pin.prove(asg, pk, qap, rng=random.Random(seed + 1))
own_pk, own_vk = pin.setup(qap, rng=random.Random(seed))
mont = asg.mont.clone()
mont[:, m // 2] = Fp.from_int(asg.spec, 12345, cpu).mont  # x_{m/2 - 1} changed
bad = pin.prove(Fp(asg.spec, mont), own_pk, qap, rng=random.Random(seed + 1))

def ints(p):
    if p.inf:
        return None
    if hasattr(p.x, "c"):
        return [[e.c[0].v, e.c[1].v] for e in (p.x, p.y)]
    return [int(p.x), int(p.y)]

print(json.dumps({"accepted": pin.verify(good, vk), "bad_accepted": pin.verify(bad, own_vk),
                  "jax": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "myzkp_tpu")),
                  "proof": {f: ints(v) for f, v in vars(good).items()},
                  "bad": {f: ints(v) for f, v in vars(bad).items()}}))
"""


@pytest.fixture(scope="module")
def port_alone(reference):
    """The port in a fresh process, which never loads jax or the JAX package:
    the proof of the witness with the reference's keys read through interop,
    the port's own setup, and the proof of a wrong witness (one x_k changed)
    with its key; each verified by the port."""
    out = subprocess.run([sys.executable, "-c", _PORT_ALONE, str(M), str(SEED),
                          str(reference[4])],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1],
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _golden_proof() -> dict:
    """The proof from the toxic waste and deltas, with Python ints:
    A_k = k(s) + delta_k t(s) for k = ell, r, o, and H(s) = (A_ell A_r -
    A_o) / t(s) (square_chain: u_j = v_j = x_j, w_j = x_{j+1})."""
    rng = random.Random(SEED)
    s = rng.randrange(1, R)
    a_ell, a_r, a_o = (rng.randrange(1, R) for _ in range(3))
    beta, _eta = rng.randrange(1, R), rng.randrange(1, R)
    rho_ell, rho_r = rng.randrange(1, R), rng.randrange(1, R)
    rho_o = rho_ell * rho_r % R
    prng = random.Random(SEED + 1)
    d_ell, d_r, d_o = (prng.randrange(1, R) for _ in range(3))
    xs = [3]
    for _ in range(M):
        xs.append(xs[-1] * xs[-1] % R)
    w = tntt.nth_root_of_unity(R, M)
    t = (pow(s, M, R) - 1) % R
    lam = [pow(w, j, R) * t * pow(M * (s - pow(w, j, R)), -1, R) % R for j in range(M)]
    ell = sum(x * v for x, v in zip(xs, lam)) % R
    o = sum(x * v for x, v in zip(xs[1:], lam)) % R
    A_l, A_r, A_o = ((v + dl * t) % R for v, dl in ((ell, d_ell), (ell, d_r), (o, d_o)))
    H = (A_l * A_r - A_o) * pow(t, -1, R) % R
    g1, g2 = tbn.g1_generator(), tbn.g2_generator()
    return {
        "g1_ell": g1 * (rho_ell * A_l), "g2_r": g2 * (rho_r * A_r),
        "g1_o": g1 * (rho_o * A_o), "g1_ell_prime": g1 * (a_ell * rho_ell * A_l),
        "g2_r_prime": g2 * (a_r * rho_r * A_r), "g1_o_prime": g1 * (a_o * rho_o * A_o),
        "g1_h": g1 * H, "g1_z": g1 * (beta * (rho_ell * A_l + rho_r * A_r + rho_o * A_o)),
    }


def test_setup_matches_reference(reference, port_circuit):
    _, _, jpk, jvk, _ = reference
    pk, vk = tpin.setup(port_circuit[0], rng=random.Random(SEED))
    port = lambda f: interop.point_to_numpy(getattr(pk, f))
    assert _key_ints(port) == _key_ints(lambda f: _jax_leaves(getattr(jpk, f)))
    assert {f: _ints(v) for f, v in vars(vk).items()} == \
        {f: _ints(v) for f, v in vars(jvk).items()}


def test_interop_loads_the_reference_keys(reference):
    _, _, jpk, jvk, keys = reference
    pk = interop.load_key(keys / "pk.npz", tpin.PinocchioProofKey, DEV)
    for f in PK_FIELDS:
        got = [interop.limbs_to_numpy(a) for a in tw.leaves(getattr(pk, f))]
        want = _jax_leaves(getattr(jpk, f))
        assert len(got) == len(want) and all((g == w).all() for g, w in zip(got, want)), f
    vk = interop.load_pinocchio_vk(keys / "vk.json")
    assert {f: _ints(v) for f, v in vars(vk).items()} == \
        {f: _ints(v) for f, v in vars(jvk).items()}


def test_prove_matches_the_host_golden(port_alone):
    proof = _port_proof(port_alone["proof"])
    golden = _golden_proof()
    assert {f: _ints(getattr(proof, f)) for f in PROOF_FIELDS} == \
        {f: _ints(golden[f]) for f in PROOF_FIELDS}


def test_both_verifiers_accept_the_port_proof(port_alone, reference):
    proof = _port_proof(port_alone["proof"])
    assert port_alone["accepted"] is True
    assert tpin.verify(proof, interop.load_pinocchio_vk(reference[4] / "vk.json"))
    assert jpin.verify(_reference_proof(proof), reference[3])


def test_port_alone_rejects_a_wrong_witness(port_alone, reference):
    """setup, prove and verify ran without jax; the wrong witness's proof is
    rejected by the port's verifier and by the reference's (the port's key
    under SEED is the reference's, test_setup_matches_reference)."""
    assert port_alone["jax"] == []
    assert port_alone["bad_accepted"] is False
    assert not jpin.verify(_reference_proof(_port_proof(port_alone["bad"])), reference[3])


@pytest.mark.slow
def test_prove_matches_reference(reference, port_alone):
    """The reference's prove with the same key and seed gives the port's
    proof point for point, and each verifier accepts the other's proof."""
    qap, asg, pk, vk, keys = reference
    want = jpin.prove(asg, pk, qap, rng=random.Random(SEED + 1))
    proof = _port_proof(port_alone["proof"])
    assert {f: _ints(getattr(proof, f)) for f in PROOF_FIELDS} == \
        {f: _ints(getattr(want, f)) for f in PROOF_FIELDS}
    port_view = _port_proof({f: _ints(getattr(want, f)) for f in PROOF_FIELDS})
    assert tpin.verify(port_view, interop.load_pinocchio_vk(keys / "vk.json"))
