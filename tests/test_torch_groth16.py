"""Port parity: Groth16 setup, prove and verify of myzkp_tpu_torch on
square_chain(8) with two public inputs, on the CPU.

One reference setup (myzkp_tpu.snark.groth16 with a seeded random.Random) is
shared by the module: its proving key is saved with
myzkp_tpu.utils.serialize.save_point_batches, its verifying key as host ints
plus the g1_k_pub coordinate arrays.  The port's setup under the same seed
gives the same keys as affine points.  One fresh process, which never loads
JAX, reads the saved keys through interop, proves the witness and a wrong
witness (one x_k changed) with them, and verifies both proofs and the first
under a wrong public input.  The first proof equals, point for point, the
proof computed on the host from the same toxic waste and r, s with Python
ints; both packages' verifiers accept it and reject the other two cases.
Tolerance 0 throughout: modular integers.
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
from myzkp_tpu.snark import groth16 as jg16
from myzkp_tpu.utils import serialize
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse as tsparse
from myzkp_tpu_torch.curves import bn254 as tbn
from myzkp_tpu_torch.ops import ntt as tntt
from myzkp_tpu_torch.snark import groth16 as tg16

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
M = 8  # constraints; witness [1, x_0, ..., x_8], d = 10
NPUB = 2  # public inputs: the one-wire and x_0
SEED = 11  # setup's rng; prove draws from random.Random(SEED + 1)
PK_POINTS = tuple(f.name for f in dataclasses.fields(tg16.Groth16ProvingKey)
                  if f.name != "num_public")
VK_HOST = ("g1_alpha", "g2_beta", "g2_gamma", "g2_delta")
PROOF_FIELDS = ("a", "b", "c")
R = tbn.R


def _ints(p):
    """A host point of either package -> None, (x, y) or ((x0, x1), (y0, y1))."""
    if p.inf:
        return None
    if hasattr(p.x, "c"):
        return tuple((e.c[0].v, e.c[1].v) for e in (p.x, p.y))
    return int(p.x), int(p.y)


def _jax_leaves(pt) -> list:
    """A JAX point batch's coordinate arrays, in the order the port reads."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(pt)]


def _key_ints(leaves_of, fields) -> dict:
    """Affine ints of the named point batches, two batch inversions in all:
    the G1 batches (3 coordinate arrays) and the G2 batches (6) each go to the
    host as one batch.  leaves_of(field) -> the field's numpy arrays."""
    out = {}
    for to_host, nleaves in ((tbn.g1_points_to_host, 3), (tbn.g2_points_to_host, 6)):
        group = [f for f in fields if len(leaves_of(f)) == nleaves]
        cat = [np.concatenate(a, axis=1) for a in zip(*map(leaves_of, group))]
        pts = iter(to_host(interop.point_from_numpy(cat, DEV)) if group else ())
        for f in group:
            out[f] = [_ints(next(pts)) for _ in range(leaves_of(f)[0].shape[1])]
    return out


def _host_proof(coords: dict, module):
    """{a, b, c: affine ints} -> ``module.Groth16Proof`` of host points."""
    bn = jbn if module is jg16 else tbn

    def point(f, v):
        curve = bn.curve_g2 if f == "b" else bn.curve_g1
        if v is None:
            return curve.infinity()
        if f == "b":
            return curve.point(bn.Fq2(list(v[0])), bn.Fq2(list(v[1])))
        return curve.point(bn.Fq(v[0]), bn.Fq(v[1]))

    return module.Groth16Proof(**{f: point(f, coords[f]) for f in PROOF_FIELDS})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's setup on square_chain(M); the proving key saved with
    save_point_batches, the verifying key as JSON host ints plus the g1_k_pub
    coordinate arrays."""
    r1cs, asg = jsparse.square_chain(jbn.r_spec(), M)
    qap = jsparse.SparseQAP(r1cs)
    pk, vk = jg16.setup(qap, NPUB, rng=random.Random(SEED))
    d = tmp_path_factory.mktemp("keys")
    serialize.save_point_batches(str(d / "pk.npz"), **{
        f.name: getattr(pk, f.name) for f in dataclasses.fields(pk)})
    with open(d / "vk.json", "w") as fh:
        json.dump({f: serialize._py_point_to_ints(getattr(vk, f)) for f in VK_HOST}, fh)
    np.savez(d / "vk_k_pub.npz", *_jax_leaves(vk.g1_k_pub))
    return qap, asg, pk, vk, d


_PORT_ALONE = """
import json, random, sys
from pathlib import Path
import numpy as np
import torch
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.snark import groth16 as g16

m, npub, seed, keys = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
cpu = torch.device("cpu")
r1cs, asg = sparse.square_chain(bn254.r_spec(), m, device=cpu)
qap = sparse.SparseQAP(r1cs)
pk = interop.load_key(keys / "pk.npz", g16.Groth16ProvingKey, cpu)
with open(keys / "vk.json") as fh, np.load(keys / "vk_k_pub.npz") as k_pub:
    vk = interop.groth16_vk_from_host(json.load(fh), [k_pub[f"arr_{i}"] for i in range(3)],
                                      cpu)
public = [int(v) for v in asg.to_int()[:npub]]
wrong_public = public[:-1] + [(public[-1] + 1) % bn254.R]
good = g16.prove(asg, pk, qap, rng=random.Random(seed + 1))
mont = asg.mont.clone()
mont[:, m // 2] = Fp.from_int(asg.spec, 12345, cpu).mont  # x_{m/2 - 1} changed
bad = g16.prove(Fp(asg.spec, mont), pk, qap, rng=random.Random(seed + 1))

def ints(p):
    if p.inf:
        return None
    if hasattr(p.x, "c"):
        return [[e.c[0].v, e.c[1].v] for e in (p.x, p.y)]
    return [int(p.x), int(p.y)]

print(json.dumps({"accepted": g16.verify(good, vk, public),
                  "wrong_public_accepted": g16.verify(good, vk, wrong_public),
                  "bad_accepted": g16.verify(bad, vk, public),
                  "public": public, "wrong_public": wrong_public,
                  "jax": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "myzkp_tpu")),
                  "proof": {f: ints(v) for f, v in vars(good).items()},
                  "bad": {f: ints(v) for f, v in vars(bad).items()}}))
"""


@pytest.fixture(scope="module")
def port_alone(reference):
    """The port in a fresh process, which never loads jax or the JAX package:
    the reference's keys read through interop, the proofs of the witness and
    of a wrong witness, and the port's verdicts on them and on the first
    proof under a wrong public input."""
    out = subprocess.run([sys.executable, "-c", _PORT_ALONE, str(M), str(NPUB),
                          str(SEED), str(reference[4])],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1],
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for k in ("proof", "bad"):
        res[k] = {f: None if v is None else tuple(tuple(c) if isinstance(c, list) else c
                                                 for c in v)
                  for f, v in res[k].items()}
    return res


def _golden_proof() -> dict:
    """The proof from the toxic waste and r, s, with Python ints.  On
    square_chain, u(X) = v(X) = sum_j lam_j(X) x_j and w(X) = sum_j lam_j(X)
    x_{j+1}, so u_i = v_i = lam_{i-1} and w_i = lam_{i-2}; with
    K_i = beta u_i + alpha v_i + w_i and h t = u v - w:
    A = alpha + u + r delta, B = beta + v + s delta,
    C = (sum_priv a_i K_i + u v - w) / delta + s A + r B - r s delta."""
    rng = random.Random(SEED)
    alpha, beta, _gamma, delta = (rng.randrange(1, R) for _ in range(4))
    x = rng.randrange(1, R)
    prng = random.Random(SEED + 1)
    r, s = prng.randrange(1, R), prng.randrange(1, R)
    a = [1, 3]
    for _ in range(M):
        a.append(a[-1] * a[-1] % R)
    w = tntt.nth_root_of_unity(R, M)
    t = (pow(x, M, R) - 1) % R
    lam = [pow(w, j, R) * t * pow(M * (x - pow(w, j, R)), -1, R) % R for j in range(M)]
    col = lambda i, off: lam[i - off] if 0 <= i - off < M else 0
    k = [(beta * col(i, 1) + alpha * col(i, 1) + col(i, 2)) % R for i in range(M + 2)]
    u = sum(a[j + 1] * lam[j] for j in range(M)) % R
    wx = sum(a[j + 2] * lam[j] for j in range(M)) % R
    A = (alpha + u + r * delta) % R
    B = (beta + u + s * delta) % R
    priv = sum(a[i] * k[i] for i in range(NPUB, M + 2))
    C = ((priv + u * u - wx) * pow(delta, -1, R) + s * A + r * B - r * s * delta) % R
    g1, g2 = tbn.g1_generator(), tbn.g2_generator()
    return {"a": _ints(g1 * A), "b": _ints(g2 * B), "c": _ints(g1 * C)}


def test_setup_matches_reference(reference):
    """The port's setup under SEED gives the reference's keys as affine
    points: every proving-key batch, the verifying key's host points and its
    g1_k_pub batch."""
    jpk, jvk = reference[2], reference[3]
    r1cs, _ = tsparse.square_chain(tbn.r_spec(), M, device=DEV)
    pk, vk = tg16.setup(tsparse.SparseQAP(r1cs), NPUB, rng=random.Random(SEED))
    port = {**{f: getattr(pk, f) for f in PK_POINTS}, "k_pub": vk.g1_k_pub}
    ref = {**{f: getattr(jpk, f) for f in PK_POINTS}, "k_pub": jvk.g1_k_pub}
    assert _key_ints(lambda f: interop.point_to_numpy(port[f]), list(port)) == \
        _key_ints(lambda f: _jax_leaves(ref[f]), list(ref))
    assert pk.num_public == vk.num_public == jpk.num_public == NPUB
    assert {f: _ints(getattr(vk, f)) for f in VK_HOST} == \
        {f: _ints(getattr(jvk, f)) for f in VK_HOST}


def test_interop_loads_the_reference_keys(reference):
    """The proving key loads limb for limb; the verifying key's host points
    and g1_k_pub come back as the reference holds them."""
    _, _, jpk, jvk, keys = reference
    pk = interop.load_key(keys / "pk.npz", tg16.Groth16ProvingKey, DEV)
    assert pk.num_public == NPUB
    for f in PK_POINTS:
        got = interop.point_to_numpy(getattr(pk, f))
        want = _jax_leaves(getattr(jpk, f))
        assert len(got) == len(want) and all((g == w).all() for g, w in zip(got, want)), f
    with open(keys / "vk.json") as fh:
        vk = interop.groth16_vk_from_host(json.load(fh), _jax_leaves(jvk.g1_k_pub), DEV)
    assert vk.num_public == NPUB
    assert {f: _ints(getattr(vk, f)) for f in VK_HOST} == \
        {f: _ints(getattr(jvk, f)) for f in VK_HOST}
    for g, w in zip(interop.point_to_numpy(vk.g1_k_pub), _jax_leaves(jvk.g1_k_pub)):
        assert (g == w).all()


def test_prove_matches_the_host_golden(port_alone):
    assert port_alone["proof"] == _golden_proof()


def test_both_verifiers_accept_the_port_proof(port_alone, reference):
    """The fresh process ran setup's carried key, prove and verify without
    jax; the reference's verifier accepts the same proof."""
    assert port_alone["jax"] == []
    assert port_alone["accepted"] is True
    assert jg16.verify(_host_proof(port_alone["proof"], jg16), reference[3],
                       port_alone["public"])


def test_both_verifiers_reject_a_wrong_public_input_and_witness(port_alone, reference):
    jvk = reference[3]
    assert port_alone["wrong_public_accepted"] is False
    assert port_alone["bad_accepted"] is False
    assert not jg16.verify(_host_proof(port_alone["proof"], jg16), jvk,
                           port_alone["wrong_public"])
    assert not jg16.verify(_host_proof(port_alone["bad"], jg16), jvk, port_alone["public"])


@pytest.mark.slow
def test_prove_matches_reference(reference, port_alone):
    """The reference's prove with the same key and seed gives the port's
    proof point for point (about 30 s: the JAX package's prove on the CPU)."""
    qap, asg, pk, _, _ = reference
    want = jg16.prove(asg, pk, qap, rng=random.Random(SEED + 1))
    assert port_alone["proof"] == {f: _ints(getattr(want, f)) for f in PROOF_FIELDS}
