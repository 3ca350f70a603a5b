"""Port parity over M128: the field kernels' plain versions, Merkle, FRI and
Rescue-Prime of myzkp_tpu_torch against myzkp_tpu.

The same numpy- or random-seeded inputs go through both packages (as
Montgomery limb arrays via interop, or as host ints); outputs must agree limb
for limb and byte for byte (modular integers and hashes: the tolerance is
0).  On the CPU the port runs the plain versions of kernels K1 (and its
chain), K5 and K6 at L = 8; they are held to the TPU kernels in interpret
mode.  Every port constructor is given an explicit CPU device.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myzkp_tpu.fields import limb as jlimb
from myzkp_tpu.fields import limb_pallas
from myzkp_tpu.fields.fp import Fp as JFp
from myzkp_tpu.fields.spec import M64, M128, FieldSpec
from myzkp_tpu.ops import ntt as jntt
from myzkp_tpu.stark import fri as jfri
from myzkp_tpu.stark.rescueprime import RescuePrime as JRescuePrime
from myzkp_tpu.utils import merkle as jmerkle
from myzkp_tpu_torch import _ext, interop
from myzkp_tpu_torch.fields import limb as tlimb
from myzkp_tpu_torch.fields import ntt_kernels as tnk
from myzkp_tpu_torch.fields import spec as tspec
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.ops import ntt as tntt
from myzkp_tpu_torch.stark import fri as tfri
from myzkp_tpu_torch.stark.rescueprime import RescuePrime
from myzkp_tpu_torch.utils import merkle as tmerkle

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) share the cores
torch.set_num_threads(1)
SPEC, JSPEC = tspec.m128_spec(), FieldSpec.make(M128)
R = 1 << 128
# values at the ends of the four-word carry chains: 32-bit words 0 or all
# ones, and values past R / 2 (M128 has no spare bit)
EDGES = [0, 1, M128 - 1, R % M128, 1 << 127, (1 << 127) + 1, (1 << 127) + (1 << 96) - 1,
         M128 - 2, (1 << 64) - 1, (1 << 96) - 1, ((1 << 32) - 1) << 32]


def _mont_np(vals) -> np.ndarray:
    """Host ints -> (8, *shape) uint32 Montgomery limbs, by the JAX package."""
    return np.asarray(JFp.from_int(JSPEC, vals).mont)


def _rand_ints(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(M128) for _ in range(n)]


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(want))


def test_specs_and_roots_match_reference():
    """M128 and M64 specs, and the roots of unity FRI and the STARKs use."""
    for p, L in ((M128, 8), (M64, 4)):
        a, b = tspec.FieldSpec.make(p), FieldSpec.make(p)
        assert (a.p, a.L, a.n0, a.p_limbs, a.r2_limbs, a.one_limbs) == \
            (b.p, b.L, b.n0, b.p_limbs, b.r2_limbs, b.one_limbs) and a.L == L
    assert tspec.m128_spec() == tspec.FieldSpec.make(M128)
    for n in (2, 1 << 10, 1 << 20, 1 << 119):
        assert tfri.get_nth_root_of_m128(n) == jfri.get_nth_root_of_m128(n)
    assert tfri.get_nth_root_of_m64(1 << 32) == jfri.get_nth_root_of_m64(1 << 32)
    # the reference's 2^119-th root (fri.rs:423-447), pinned as the JAX tests pin it
    assert tntt.nth_root_of_unity(M128, 1 << 119) == jfri.get_nth_root_of_m128(1 << 119)


def test_field_consts_take_both_widths():
    """The kernels' constants at L = 8 and L = 4 (four and two words, p > R / 2
    allowed: M128, M64) and L = 16; at L = 4 only K1 and its chain have an
    instance; any other width raises, a toy prime (L = 1) included."""
    for spec, p, words in ((SPEC, M128, 4), (tspec.m64_spec(), M64, 2)):
        c = _ext.field_consts(spec)
        assert len(c.p) == len(c.one) == words
        assert sum(w << (32 * k) for k, w in enumerate(c.p)) == p
        assert sum(w << (32 * k) for k, w in enumerate(c.one)) == (1 << (32 * words)) % p
        assert (c.n0 * p) % (1 << 32) == (1 << 32) - 1
    assert _ext.kernel_name("mont_mul", SPEC) == "mont_mul_l8"
    assert _ext.kernel_name("mont_mul", tspec.m64_spec()) == "mont_mul_l4"
    assert _ext.kernel_name("mont_pow", tspec.m64_spec()) == "mont_pow_l4"
    assert _ext.kernel_name("ntt_leaf", tspec.bn254_r_spec()) == "ntt_leaf"
    with pytest.raises(ValueError):
        _ext.kernel_name("butterfly", tspec.m64_spec())
    with pytest.raises(ValueError):
        _ext.field_consts(tspec.FieldSpec.make(17))
    with pytest.raises(ValueError):
        _ext.kernel_name("mont_mul", tspec.FieldSpec.make(17))


def test_mont_mul_ref_m128_matches_pallas_interpret():
    """K1's plain version at L = 8 against the TPU kernel in interpret mode:
    every pair of the edges, then random pairs."""
    av = [x for x in EDGES for _ in EDGES] + _rand_ints(100, 1)
    bv = [y for _ in EDGES for y in EDGES] + _rand_ints(100, 2)
    a, b = _mont_np(av), _mont_np(bv)
    want = limb_pallas.mont_mul_pallas(JSPEC, jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = tlimb.mont_mul(SPEC, interop.limbs_from_numpy(a, DEV),
                         interop.limbs_from_numpy(b, DEV))
    _same(got, want)
    assert [int(v) for v in Fp(SPEC, got).to_int()] == [x * y % M128 for x, y in zip(av, bv)]


def test_mont_pow_ref_m128_matches_reference():
    """K1's chain (pow_const, inv, batch_inv) at L = 8 against the JAX
    package: e = 0, 1, 2, p - 2 and Rescue-Prime's alpha^-1."""
    vals = EDGES + _rand_ints(5, 3)
    x_np = _mont_np(vals)
    x, jx = interop.limbs_from_numpy(x_np, DEV), jnp.asarray(x_np)
    for e in (0, 1, 2, M128 - 2, JRescuePrime().alpha_inv):
        _same(tlimb.pow_const(SPEC, x, e), jlimb.pow_const(JSPEC, jx, e))
    _same(tlimb.inv(SPEC, x), jlimb.inv(JSPEC, jx))
    _same(tlimb.batch_inv(SPEC, x), jlimb.batch_inv(JSPEC, jx))
    _same((Fp(SPEC, x) ** 3).mont, (JFp(JSPEC, jx) ** 3).mont)


def test_butterfly_ref_m128_matches_pallas_interpret():
    """K5's plain version at L = 8 against the TPU kernel in interpret mode
    (DIF), 64 pairs, the first 16 crossed edges."""
    e = EDGES[:4]
    u = _mont_np([x for x in e for _ in e] + _rand_ints(48, 4))
    v = _mont_np([y for _ in e for y in e] + _rand_ints(48, 5))
    tw = _mont_np(_rand_ints(64, 6))
    su, sv = limb_pallas.butterfly_pallas(JSPEC, jnp.asarray(u), jnp.asarray(v),
                                          jnp.asarray(tw), False, interpret=True)
    x = interop.limbs_from_numpy(np.concatenate([u, v], axis=1), DEV)
    out = tnk.butterfly_ref(SPEC, x.reshape(8, 1, 1, 128, 1), interop.limbs_from_numpy(tw, DEV))
    _same(out[:, 0, 0, :, 0], su)
    _same(out[:, 0, 1, :, 0], sv)


def test_ntt_leaf_ref_m128_matches_pallas_interpret():
    """K6's plain version at L = 8 against the TPU leaf kernel in interpret
    mode, m = 16, forward and inverse."""
    m, E, B = 16, 2, 8
    x_np = _mont_np(np.asarray(_rand_ints(E * m * B, 7), dtype=object).reshape(E, m, B))
    for inv in (False, True):
        tw = jnp.asarray(jntt._leaf_twiddles_np(JSPEC, m, inv))
        want = limb_pallas.ntt_leaf_pallas(JSPEC, jnp.asarray(x_np), tw, m, True)
        got = tnk.ntt_leaf_ref(SPEC, interop.limbs_from_numpy(x_np, DEV),
                               tntt._leaf_twiddles(SPEC, m, inv, DEV))
        _same(got, want)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_merkle_roots_and_paths_match_reference(n):
    """Roots, every path and verify over leaves of 16 bytes (and of mixed
    lengths), the distributed tree over 2 and 4 shards."""
    rng = random.Random(n)
    for leaves in ([rng.randbytes(16) for _ in range(n)],
                   [rng.randbytes(1 + rng.randrange(40)) for _ in range(n)]):
        tree, jtree = tmerkle.MerkleTree(leaves), jmerkle.MerkleTree(leaves)
        assert tree.root == jtree.root == tmerkle.commit(leaves)
        for i in range(n):
            path = tree.open(i)
            assert path == jtree.open(i) == tmerkle.open(i, leaves)
            assert tmerkle.verify(tree.root, i, path, leaves[i])
            assert jmerkle.verify(tree.root, i, path, leaves[i])
            if n > 1:
                assert not tmerkle.verify(tree.root, i ^ 1, path, leaves[i])
                bad = leaves[i][:-1] + bytes([leaves[i][-1] ^ 1])
                assert not tmerkle.verify(tree.root, i, path, bad)
        for shards in (2, 4):
            if n >= shards:
                dist = tmerkle.DistMerkleTree(leaves, shards)
                assert dist.root == tree.root
                assert [dist.open(i) for i in range(n)] == [tree.open(i) for i in range(n)]
    with pytest.raises(ValueError):
        tmerkle.MerkleTree([b"x"] * 3)


def test_codeword_bytes_round_trip():
    vals = EDGES[:8]
    cw = Fp.from_int(SPEC, vals, DEV)
    leaves = tfri.codeword_bytes(cw)
    assert leaves == jfri.codeword_bytes(JFp.from_int(JSPEC, vals))
    assert leaves == [v.to_bytes(16, "little") for v in vals]
    assert torch.equal(tfri.codeword_from_bytes(SPEC, leaves, DEV).mont, cw.mont)


@pytest.fixture(scope="module")
def fri_case():
    """A 64-point FRI (expansion 4, 2 colinearity tests) over M128 on a
    codeword of degree < 16, proved by both packages."""
    n, expansion = 64, 4
    omega = tntt.nth_root_of_unity(M128, n)
    offset = 85408008396924667383611388730472331217
    coeffs = _rand_ints(n // expansion, 9)
    vals = [tfri._host_eval(coeffs, offset * pow(omega, i, M128) % M128, M128)
            for i in range(n)]
    kw = dict(offset=offset, omega=omega, domain_length=n, expansion_factor=expansion,
              num_colinearity_tests=2)
    fri, jf = tfri.FRI(spec=SPEC, **kw), jfri.FRI(spec=JSPEC, **kw)
    proof = fri.prove(Fp.from_int(SPEC, vals, DEV))
    return fri, jf, proof, jf.prove(JFp.from_int(JSPEC, vals)), vals


def test_fri_proof_matches_reference(fri_case):
    """The proof byte for byte, its exported (index, value) pairs, the fold
    against the reference's, and the verifiers accepting each other's."""
    fri, jf, proof, jproof, vals = fri_case
    assert fri.num_rounds() == jf.num_rounds() and fri.eval_domain() == jf.eval_domain()
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    got, want = [], []
    assert fri.verify(proof, got) and jf.verify(jproof, want)
    assert got == want and all(vals[i] == v for i, v in got)
    cw = _mont_np(vals)
    _same(tfri.fold_codeword(SPEC, interop.limbs_from_numpy(cw, DEV), 12345, fri.offset,
                             fri.omega),
          jfri.fold_codeword(JSPEC, jnp.asarray(cw), 12345, jf.offset, jf.omega))
    assert [tfri.sample_index(bytes([i, 7, 9]), 1000) for i in range(20)] == \
        [jfri.sample_index(bytes([i, 7, 9]), 1000) for i in range(20)]
    assert tfri.sample_indices(b"seed", 64, 8, 5) == jfri.sample_indices(b"seed", 64, 8, 5)


def test_fri_rejects_corrupted_and_malformed(fri_case):
    """A changed value, a changed root, and malformed proofs are rejected,
    never raised on, as the reference's verifier does."""
    fri, _, proof, _, vals = fri_case
    bad_vals = list(vals)
    bad_vals[7] = (bad_vals[7] + 1) % M128
    assert not fri.verify(fri.prove(Fp.from_int(SPEC, bad_vals, DEV)), [])
    broken = [
        dataclasses.replace(proof, merkle_roots=proof.merkle_roots[:-1]),
        dataclasses.replace(proof, merkle_roots=[b"\0" * 32] + proof.merkle_roots[1:]),
        dataclasses.replace(proof, last_codeword=proof.last_codeword[:-1]),
        dataclasses.replace(proof, last_codeword=[b"\1" * 16] + proof.last_codeword[1:]),
        dataclasses.replace(proof, revealed_layers=proof.revealed_layers[1:]),
        dataclasses.replace(proof, revealed_layers=None),
    ]
    layer = proof.revealed_layers[0]
    vals_a, paths_a = layer.a
    broken.append(dataclasses.replace(proof, revealed_layers=[
        dataclasses.replace(layer, a=(vals_a, [p[:-1] for p in paths_a]))]
        + proof.revealed_layers[1:]))
    for b in broken:
        assert fri.verify(b, []) is False


def test_rescue_prime_known_answers_and_air():
    """The reference's known answers (rescueprime.rs:606-619), the trace,
    the AIR equal to the JAX package's and vanishing on the trace."""
    rp, jrp = RescuePrime(), JRescuePrime()
    assert rp.hash(1) == 244180265933090377212304188905974087294
    assert rp.hash(57322816861100832358702415967512842988) == \
        89633745865384635541695204788332415101
    assert rp.trace(1) == jrp.trace(1) and len(rp.trace(1)) == 28
    om = tntt.nth_root_of_unity(M128, 32)
    air, jair = rp.transition_constraints(om), jrp.transition_constraints(om)
    assert [a.d for a in air] == [a.d for a in jair]
    assert rp.boundary_constraints(5) == jrp.boundary_constraints(5)
    tr = rp.trace(1)
    for r in range(rp.n):
        point = [pow(om, r, M128)] + tr[r] + tr[r + 1]
        assert all(a.evaluate(point) == 0 for a in air)


def test_rescue_hash_batch_matches_host():
    """hash_batch (27 rounds of x^3 and x^(alpha^-1) on K1's chain's plain
    version) against the host hash, zero among the inputs."""
    rp = RescuePrime()
    inputs = [1, 2, 57322816861100832358702415967512842988, 0]
    out = rp.hash_batch(Fp.from_int(rp.spec, inputs, DEV))
    assert [int(v) for v in out.to_int()] == [rp.hash(x) for x in inputs]
