"""Port parity: KZG and Gemini of myzkp_tpu_torch (commit/kzg.py,
commit/gemini.py) on the CPU plain versions.

Tier-1 holds every result to host-int goldens computed from the known toxic
waste s, on one degree-16 SRS for the whole module: the SRS [s^i]G1 /
[s^i]G2 as affine points, C = [p(s)]G1, the opening witnesses
[(p(s) - y) / (s - u)]G1 and [(p(s) - I(s)) / Z(s)]G1, the degree proof
[s^(max_d - d) p(s)]G1, the Gemini folds and their commitments at 8 and 16
coefficients (the first fold's bound is the coefficient count, so 16 needs
degree 16), and the verifiers' accept and reject outcomes, malformed input
included (they return False, they do not raise).  These are the values the
JAX package computes; the cases that run the JAX package itself are marked
``slow``: its CPU compiles of the same flow take minutes (setup about 30 s,
each commit or opening 10-15 s, each new Gemini shape more).  They hold KZG
at degree 15 with an 8-coefficient polynomial, the JAX tests' shape
(tests/test_kzg_gemini.py), and Gemini at 8 and 16 coefficients on one
degree-16 SRS of each package.
"""

import random

import numpy as np
import pytest
import torch

from myzkp_tpu_torch.commit import gemini, kzg
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops.poly import Poly

DEV = "cpu"
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
R = bn254.R
S = 0x1F2E3D4C5B6A798897A6B5C4D3E2F10123456789ABCDEF  # the toxic waste
SPEC = bn254.r_spec()
G1, G2 = bn254.g1_generator(), bn254.g2_generator()


def _ints(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def _ev(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + int(c)) % R
    return acc


def _lagrange_at(xs, ys, x: int) -> int:
    """I(x) for the interpolant of (xs, ys), host ints."""
    total = 0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num = num * (x - xj) % R
                den = den * (xi - xj) % R
        total = (total + yi * num * pow(den, -1, R)) % R
    return total


@pytest.fixture(scope="module")
def srs():
    return kzg.setup(16, s=S, full_g2=True, device=DEV)


@pytest.fixture(scope="module")
def kzg16(srs):
    coeffs = _ints(8, 1)
    p = Poly.from_int_coeffs(SPEC, coeffs, DEV)
    return srs, coeffs, p, kzg.commit(srs, p)


def test_setup_srs_matches_host(srs):
    pk = srs
    assert pk.degree == 16 and pk.num_g2 == 17
    assert pk.host_g1() == [G1 * pow(S, i, R) for i in range(17)]
    assert [pk.host_g2(i) for i in (0, 1, 2, 16)] == [G2 * pow(S, i, R) for i in (0, 1, 2, 16)]


def test_setup_draws_s_as_the_reference():
    """s comes from rng.randrange(1, r), as the reference draws it; a minimal
    setup holds two G2 powers."""
    pk = kzg.setup(3, rng=random.Random(5), device=DEV)
    s = random.Random(5).randrange(1, R)
    assert pk.num_g2 == 2
    assert pk.host_g1()[1] == G1 * s and pk.host_g2(1) == G2 * s


def test_commit_open_verify(kzg16):
    pk, coeffs, p, C = kzg16
    ps = _ev(coeffs, S)
    assert C == G1 * ps
    u = 123
    y, w = kzg.open(pk, p, u)
    assert y == _ev(coeffs, u)
    assert w == G1 * ((ps - y) * pow(S - u, -1, R) % R)
    assert kzg.verify(pk, u, y, C, w)
    assert not kzg.verify(pk, u, (y + 1) % R, C, w)
    assert not kzg.verify(pk, u + 1, y, C, w)


def test_batch_open_verify(kzg16):
    pk, coeffs, p, C = kzg16
    us = [2, 5, 9]
    ys, w = kzg.batch_open(pk, p, us)
    assert ys == [_ev(coeffs, u) for u in us]
    z_s = (S - 2) * (S - 5) * (S - 9) % R
    assert w == G1 * ((_ev(coeffs, S) - _lagrange_at(us, ys, S)) * pow(z_s, -1, R) % R)
    assert kzg.batch_verify(pk, us, ys, C, w)
    bad = list(ys)
    bad[0] = (bad[0] + 1) % R
    assert not kzg.batch_verify(pk, us, bad, C, w)


def test_degree_bound(kzg16):
    pk, coeffs, p, C = kzg16
    dp = kzg.prove_degree_bound(pk, p, 8)
    assert dp == G1 * (pow(S, pk.degree - 8, R) * _ev(coeffs, S) % R)
    assert kzg.verify_degree_bound(pk, C, dp, 8)
    assert not kzg.verify_degree_bound(pk, C, dp, 9)


def test_kzg_verify_paths_reject_invalid_structure(kzg16):
    """Structurally invalid input returns False and never raises; the
    prover's misuse raises."""
    pk, coeffs, p, C = kzg16
    assert not kzg.verify_degree_bound(pk, C, C, pk.degree + 1)
    assert not kzg.verify_degree_bound(pk, C, C, -1)
    with pytest.raises(ValueError):
        kzg.prove_degree_bound(pk, p, pk.degree + 5)
    with pytest.raises(ValueError):
        kzg.commit(pk, Poly.from_int_coeffs(SPEC, range(pk.degree + 2), DEV))
    ys = [_ev(coeffs, 2), _ev(coeffs, 5)]
    assert not kzg.batch_verify(pk, [], [], C, C)
    assert not kzg.batch_verify(pk, [2, 2], ys, C, C)
    assert not kzg.batch_verify(pk, [2, 5], ys[:1], C, C)
    assert not kzg.batch_verify(pk, [2, 2 + R], ys, C, C)


def test_kzg_batch_verify_minimal_srs_rejects():
    """A minimal-G2 SRS cannot check a vanishing-polynomial commitment:
    batch_verify rejects, and commit_g2 past its powers raises."""
    pk_min = kzg.setup(7, s=S, full_g2=False, device=DEV)
    assert not kzg.batch_verify(pk_min, [2, 5], [1, 2], G1, G1)
    with pytest.raises(ValueError):
        kzg.commit_g2(pk_min, Poly.from_int_coeffs(SPEC, [1, 2, 3], DEV))


def test_tensor_product():
    tp = gemini.tensor_product(Fp.from_int(SPEC, [1, 2], DEV), Fp.from_int(SPEC, [3, 4], DEV))
    assert [int(v) for v in tp.to_int()] == [3, 6, 4, 8]


def test_split_and_fold_errors():
    with pytest.raises(gemini.SplitFoldError):
        gemini.split_and_fold(Fp.from_int(SPEC, [1, 2, 3], DEV), [1])
    with pytest.raises(gemini.SplitFoldError):
        gemini.split_and_fold(Fp.from_int(SPEC, [1, 2, 3, 4], DEV), [1])


def _host_folds(coeffs, rhos) -> list:
    fs = [list(coeffs)]
    for rho in rhos:
        f = fs[-1]
        fs.append([(f[2 * i] + rho * f[2 * i + 1]) % R for i in range(len(f) // 2)])
    return fs


@pytest.mark.parametrize("levels", [3, 4])
def test_gemini_fold_commit_open_verify(levels, srs):
    """Folds and mu against host ints, every commitment [f_i(s)]G1, every
    opening and degree proof against its golden, the plaintext check, the
    verifier's accept and its rejects of mu + 1 and of a short rho list."""
    pk = srs
    n = 1 << levels
    coeffs, rhos = _ints(n, 10 + levels), _ints(levels, 20 + levels)
    beta = _ints(1, 30 + levels)[0]
    fs = gemini.split_and_fold(Fp.from_int(SPEC, coeffs, DEV), rhos)
    host = _host_folds(coeffs, rhos)
    assert [list(map(int, f.to_int())) for f in fs] == host
    mu = host[-1][0]
    assert gemini.debug_verify(rhos, mu, fs, beta)
    assert not gemini.debug_verify(rhos, (mu + 1) % R, fs, beta)
    cg = gemini.commit_gemini(fs, pk)
    assert cg == [G1 * _ev(f, S) for f in host]
    pi = gemini.open_gemini(fs, beta, pk)
    points = [beta % R, (-beta) % R, beta * beta % R]
    z_s = (S - points[0]) * (S - points[1]) * (S - points[2]) % R
    for f, (ys, w) in zip(host, pi.es):
        assert ys == [_ev(f, x) for x in points]
        want = (_ev(f, S) - _lagrange_at(points, ys, S)) * pow(z_s, -1, R) % R
        assert w == G1 * want
    assert pi.degree_proofs == [G1 * (pow(S, pk.degree - (n >> i), R) * _ev(f, S) % R)
                                for i, f in enumerate(host)]
    assert gemini.verify_gemini(rhos, mu, beta, cg, pi, pk)
    assert not gemini.verify_gemini(rhos, (mu + 1) % R, beta, cg, pi, pk)
    assert not gemini.verify_gemini(rhos[:-1], mu, beta, cg, pi, pk)


# ---------------------------------------------------------------------------
# Against the JAX package (slow: its CPU compiles)
# ---------------------------------------------------------------------------

def _jax_setup(degree: int):
    from myzkp_tpu.commit import kzg as jkzg

    return jkzg.setup(degree, s=S, full_g2=True)


@pytest.fixture(scope="module")
def jax_kzg16():
    return _jax_setup(16)


def _affine(pt) -> tuple:
    """A host point of either package as comparable ints ((x, y) or None)."""
    if pt.inf:
        return None
    if hasattr(pt.x, "c"):
        return tuple(int(c.v) for c in pt.x.c), tuple(int(c.v) for c in pt.y.c)
    return int(pt.x), int(pt.y)


@pytest.mark.slow
def test_kzg_matches_jax():
    """KZG at degree 15 (the JAX tests' shape): the SRS as affine points,
    commit, open, batch open and the degree proof equal to the JAX
    package's; verify outcomes equal, rejections included."""
    from myzkp_tpu.commit import kzg as jkzg
    from myzkp_tpu.curves import bn254 as jbn
    from myzkp_tpu.ops.poly import Poly as JPoly

    pk, jpk = kzg.setup(15, s=S, full_g2=True, device=DEV), _jax_setup(15)
    coeffs = _ints(8, 1)
    p, jp = Poly.from_int_coeffs(SPEC, coeffs, DEV), JPoly.from_int_coeffs(jbn.r_spec(), coeffs)
    assert [_affine(a) for a in pk.host_g1()] == [_affine(a) for a in jpk.host_g1()]
    assert [_affine(pk.host_g2(i)) for i in range(16)] == \
        [_affine(a) for a in jbn.g2_points_to_host(jpk.powers2)]
    C, jC = kzg.commit(pk, p), jkzg.commit(jpk, jp)
    assert _affine(C) == _affine(jC)
    (y, w), (jy, jw) = kzg.open(pk, p, 123), jkzg.open(jpk, jp, 123)
    assert (y, _affine(w)) == (jy, _affine(jw))
    for yy in (jy, (jy + 1) % R):
        assert kzg.verify(pk, 123, yy, C, w) == jkzg.verify(jpk, 123, yy, jC, jw)
    (ys, w), (jys, jw) = kzg.batch_open(pk, p, [2, 5, 9]), jkzg.batch_open(jpk, jp, [2, 5, 9])
    assert (ys, _affine(w)) == (jys, _affine(jw))
    bad = [(jys[0] + 1) % R] + jys[1:]
    for yy in (jys, bad):
        assert kzg.batch_verify(pk, [2, 5, 9], yy, C, w) == \
            jkzg.batch_verify(jpk, [2, 5, 9], yy, jC, jw)
    dp, jdp = kzg.prove_degree_bound(pk, p, 8), jkzg.prove_degree_bound(jpk, jp, 8)
    assert _affine(dp) == _affine(jdp)
    for d in (8, 9, pk.degree + 1, -1):
        assert kzg.verify_degree_bound(pk, C, dp, d) == jkzg.verify_degree_bound(jpk, jC, jdp, d)


@pytest.mark.slow
@pytest.mark.parametrize("levels", [3, 4])
def test_gemini_matches_jax(levels, srs, jax_kzg16):
    """Gemini at 8 and 16 coefficients on one degree-16 SRS of each package:
    folds, commitments, proof and verify outcomes equal to the JAX
    package's."""
    from myzkp_tpu.commit import gemini as jgem
    from myzkp_tpu.curves import bn254 as jbn
    from myzkp_tpu.fields.fp import Fp as JFp

    pk, jpk = srs, jax_kzg16
    coeffs, rhos = _ints(1 << levels, 40 + levels), _ints(levels, 50 + levels)
    beta = _ints(1, 60 + levels)[0]
    fs = gemini.split_and_fold(Fp.from_int(SPEC, coeffs, DEV), rhos)
    jfs = jgem.split_and_fold(JFp.from_int(jbn.r_spec(), coeffs), rhos)
    assert [list(f.to_int()) for f in fs] == [list(f.coef.to_int()) for f in jfs]
    mu = int(fs[-1].to_int()[0])
    cg, jcg = gemini.commit_gemini(fs, pk), jgem.commit_gemini(jfs, jpk)
    assert list(map(_affine, cg)) == list(map(_affine, jcg))
    pi, jpi = gemini.open_gemini(fs, beta, pk), jgem.open_gemini(jfs, beta, jpk)
    assert [(ys, _affine(w)) for ys, w in pi.es] == [(ys, _affine(w)) for ys, w in jpi.es]
    assert list(map(_affine, pi.degree_proofs)) == list(map(_affine, jpi.degree_proofs))
    for m in (mu, (mu + 1) % R):
        assert gemini.verify_gemini(rhos, m, beta, cg, pi, pk) == \
            jgem.verify_gemini(rhos, m, beta, jcg, jpi, jpk)
