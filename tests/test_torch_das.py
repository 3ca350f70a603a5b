"""Port parity of Reed-Solomon and the three data-availability models:
myzkp_tpu_torch.codes / .das against myzkp_tpu.codes / .das.

The same seeded bytes go through both packages; codewords, parity
matrices, Merkle roots and paths must agree byte for byte, and decodes
exactly (the tolerance is 0: GF(2^8) symbols and hashes).  The KZG models'
commitments and openings are held to the host's [p(s)]G1 from a known s
(the JAX package's KZG costs about 35 s a model on the CPU).  On the CPU the
bulk encode runs as torch ops on CPU tensors; every port constructor is
given an explicit CPU device.
"""

import random

import numpy as np
import pytest
import torch

from myzkp_tpu.codes import reedsolomon as jrs
from myzkp_tpu.das import avail as javail
from myzkp_tpu.das import celestia as jcelestia
from myzkp_tpu.das import eigenda as jeigenda
from myzkp_tpu_torch.commit import kzg
from myzkp_tpu_torch.codes import reedsolomon as rs
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.das import cli
from myzkp_tpu_torch.das.avail import Avail, PublicParamsAvail
from myzkp_tpu_torch.das.celestia import Celestia
from myzkp_tpu_torch.das.eigenda import CommitmentEigenDA, EigenDA, PublicParamsEigenDA
from myzkp_tpu_torch.das.utils import SamplePosition, get_metrics, reset_metrics

DEV = torch.device("cpu")
# one intra-op thread: the test processes (pytest-xdist) share the cores
torch.set_num_threads(1)
S = 0x1F2E3D4C5B6A798897A6B5C4D3E2F10123456789ABCDEF  # the toxic waste
# (n, k): small codes, and n > 255, where the points g^i repeat
CODES = ((7, 3), (16, 8), (64, 16), (260, 4))


def _bytes(n: int, seed: int) -> bytes:
    return np.random.RandomState(seed).randint(0, 256, size=n, dtype=np.uint8).tobytes()


def _host_commit(coeffs) -> object:
    """[p(s)]G1 on the host for coefficient ints (low first)."""
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * S + int(c)) % bn254.R
    return bn254.g1_generator() * acc


def test_gf_mul_bytes_matches_jax():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    got = rs.gf_mul_bytes(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, jrs.gf_mul_bytes(a, b))


@pytest.mark.parametrize("n,k", CODES)
def test_parity_matrix_and_batch_encode_match_jax(n, k):
    """rs1d_parity_matrix (successive remainders) equals the JAX package's
    (k unit-message encodes); the batched encode equals both packages'
    batch and object encodes."""
    jc, tc = jrs.setup_rs1d(n, k), rs.setup_rs1d(n, k)
    P = rs.rs1d_parity_matrix(tc, DEV)
    np.testing.assert_array_equal(P.numpy(), jrs.rs1d_parity_matrix(jc))
    msgs = np.frombuffer(_bytes(5 * k, n), dtype=np.uint8).reshape(5, k)
    got = rs.encode_rs1d_batch(torch.from_numpy(msgs.copy()), tc).numpy()
    np.testing.assert_array_equal(got, jrs.encode_rs1d_batch(msgs, jc))
    assert list(got[0]) == jrs.encode_rs1d(list(msgs[0]), jc) == rs.encode_rs1d(list(msgs[0]), tc)


def test_rs1d_systematic_and_correction():
    """1 and 2 errors corrected, 3 beyond the budget (None), as the JAX
    package's decoder does."""
    coder, jcoder = rs.setup_rs1d(7, 3), jrs.setup_rs1d(7, 3)
    msg = [9, 1, 7]
    code = rs.encode_rs1d(msg, coder)
    assert code == jrs.encode_rs1d(msg, jcoder) and code[4:7] == msg
    c1, c2, c3 = list(code), list(code), list(code)
    c1[0] ^= 0x55
    c2[1] ^= 0x21
    c2[5] ^= 0x07
    c3[0] ^= 1
    c3[2] ^= 5
    c3[4] ^= 9
    for word, want in ((code, msg), (c1, msg), (c2, msg), (c3, None)):
        assert rs.decode_rs1d(word, coder) == want == jrs.decode_rs1d(word, jcoder)


def test_rs1d_decode_past_255_points_matches_jax():
    """RS(260, 4): the points g^i repeat; the decoder's answers (a message
    or None) are the JAX package's, error free and with errors."""
    coder, jcoder = rs.setup_rs1d(260, 4), jrs.setup_rs1d(260, 4)
    code = rs.encode_rs1d(list(_bytes(4, 9)), coder)
    rng = random.Random(10)
    for errors in (0, 1, 3):
        word = list(code)
        for pos in rng.sample(range(260), errors):
            word[pos] ^= rng.randrange(1, 256)
        assert rs.decode_rs1d(word, coder) == jrs.decode_rs1d(word, jcoder)


def test_rs2d_roundtrip_matches_jax():
    coder, jcoder = rs.setup_rs2d(4, 4, 3), jrs.setup_rs2d(4, 4, 3)
    msg = [5, 10, 99]
    code = rs.encode_rs2d(msg, coder)
    assert code == jrs.encode_rs2d(msg, jcoder)
    assert rs.encode_rs2d_batch(torch.tensor(msg, dtype=torch.uint8), coder).tolist() == code
    assert rs.decode_rs2d(code, coder) == msg
    bad = [list(r) for r in code]
    bad[0][0] ^= 0xAA
    assert rs.decode_rs2d(bad, coder) == msg == jrs.decode_rs2d(bad, jcoder)


def test_celestia_matches_jax():
    """Side 8 (a 4 x 4 square): the extended square, every row and column
    root, the data root and sample paths byte for byte; samples verified, a
    tampered leaf rejected, the data reconstructed."""
    data = _bytes(16, 11)
    reset_metrics()
    p, jp = Celestia.setup(4, 2.0, 16, device=DEV), jcelestia.Celestia.setup(4, 2.0, 16)
    enc, jenc = Celestia.encode(data, p), jcelestia.Celestia.encode(data, jp)
    assert [[bytes([v]) for v in row] for row in enc.codewords.tolist()] == jenc.codewords
    com, jcom = Celestia.commit(enc, p), jcelestia.Celestia.commit(jenc, jp)
    assert (com.row_roots, com.col_roots, com.data_root) == \
        (jcom.row_roots, jcom.col_roots, jcom.data_root)
    for pos in (SamplePosition(1, 2, True), SamplePosition(1, 2, False),
                SamplePosition(7, 0, False)):
        assert Celestia.verify(pos, enc, com, p)
    assert get_metrics().proof_size == 3 * (32 * 2 + 1)
    bad = type(enc)(codewords=enc.codewords.clone(), data_size=16)
    bad.codewords[7, 0] ^= 1
    assert not Celestia.verify(SamplePosition(7, 0, False), bad, com, p)
    assert Celestia.reconstruct(enc, p) == data
    m = get_metrics()
    assert m.encoded_size == 64 and m.commitment_size == 16 * 32 + 32


def test_avail_matches_jax_and_host():
    """32 bytes, chunk 8, expansion 2: the codewords equal the JAX
    package's; each of the 16 column commitments equals the host's [p(s)]G1;
    a sample verified, the data reconstructed."""
    data = _bytes(32, 12)
    p = PublicParamsAvail(2.0, kzg.setup(4, s=S, device=DEV), 8)
    enc = Avail.encode(data, p)
    jenc = javail.Avail.encode(data, javail.PublicParamsAvail(2.0, None, 8))
    assert enc.codewords.tolist() == jenc.codewords
    com = Avail.commit(enc, p)
    rows = enc.codewords.tolist()
    assert com.commitments == [_host_commit(col) for col in zip(*rows)]
    assert Avail.verify(SamplePosition(0, 3, False), enc, com, p)
    assert Avail.reconstruct(enc, p) == data


def test_eigenda_matches_jax_and_host():
    """32 bytes, expansion 2, chunks of 8: the chunks equal the JAX
    package's; commitments, y = p(5) and the witnesses equal the host's from
    s; samples verified and a changed y rejected; the data reconstructed."""
    data = _bytes(32, 13)
    p = PublicParamsEigenDA(2.0, [kzg.setup(8, s=S, device=DEV)], 8)
    enc = EigenDA.encode(data, p)
    jenc = jeigenda.EigenDA.encode(data, jeigenda.PublicParamsEigenDA(2.0, [], 8))
    assert [c.tolist() for c in enc.codewords] == jenc.codewords
    com = EigenDA.commit(enc, p)
    r = bn254.R
    for chunk, c, (y, w) in zip(jenc.codewords, com.chunk_commitments, com.chunk_proofs):
        ps = sum(v * pow(S, i, r) for i, v in enumerate(chunk)) % r
        y5 = sum(v * 5 ** i for i, v in enumerate(chunk)) % r
        assert c == _host_commit(chunk) and y == y5
        assert w == bn254.g1_generator() * ((ps - y5) * pow(S - 5, -1, r) % r)
    for i in range(2):
        assert EigenDA.verify(SamplePosition(0, i, False), enc, com, p)
    y, w = com.chunk_proofs[0]
    bad = CommitmentEigenDA(com.chunk_commitments, [(y + 1, w)] + com.chunk_proofs[1:], 0)
    assert not EigenDA.verify(SamplePosition(0, 0, False), enc, bad, p)
    assert EigenDA.reconstruct(enc, p) == data


def test_cli_main_celestia_on_cpu(monkeypatch, capsys):
    """The CLI at data size 16 (side 8) on the CPU prints the model's
    heading and its metrics."""
    monkeypatch.setattr(cli, "DATA_SIZES", (16,))
    monkeypatch.setattr(cli, "SQRT_DATA_SIZES", (4,))
    reset_metrics()
    assert cli.main(["celestia", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# Celestia" and out[1].startswith("SystemMetrics(encoding_time=")
    assert "encoded_size=64, commitment_size=544, proof_size=1040)" in out[1]
