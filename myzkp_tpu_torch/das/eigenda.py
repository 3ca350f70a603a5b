"""EigenDA-style data availability: a Reed-Solomon extension of the whole
blob, cut into chunks, with a KZG commitment and a precomputed opening at a
dummy point for each chunk.

Counterpart of ``myzkp_tpu/das/eigenda.py`` (the reference's
``eigenda.rs``): setup (QUORUM_COUNT SRSs of degree chunk_size), encode,
commit (each chunk committed and opened at x = 5), verify (one pairing
check of the sampled chunk, no data access) and reconstruct (the whole
codeword decoded on the host).  The codeword is one batched encode on the
key's device; the chunks' commitments and opening witnesses are one
``kzg.commit_many``, the points the JAX package's per-chunk ``commit`` and
``open`` give.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..codes import reedsolomon as rs
from ..commit import kzg
from . import utils as du

QUORUM_COUNT = 1  # as the reference
OPEN_AT = 5  # the reference's dummy opening point


@dataclass
class PublicParamsEigenDA:
    expansion_factor: float
    quorums: list  # [KZGPublicKey]
    chunk_size: int


@dataclass
class EncodedDataEigenDA:
    codewords: list  # [chunk]: uint8 tensors of chunk_size (the last may be shorter)
    data_size: int


@dataclass
class CommitmentEigenDA:
    chunk_commitments: list
    chunk_proofs: list  # [(y, witness)]
    quorum_id: int


class EigenDA:
    @staticmethod
    def setup(chunk_size: int, expansion_factor: float, data_size: int,
              device=None) -> PublicParamsEigenDA:
        quorums = [kzg.setup(chunk_size, device=device) for _ in range(QUORUM_COUNT)]
        return PublicParamsEigenDA(expansion_factor=expansion_factor, quorums=quorums,
                                   chunk_size=chunk_size)

    @staticmethod
    def encode(data: bytes, params: PublicParamsEigenDA) -> EncodedDataEigenDA:
        dev = params.quorums[0].device
        start = du.clock(dev)
        codeword_size = int(len(data) * math.ceil(params.expansion_factor))
        coder = rs.setup_rs1d(codeword_size, len(data))
        msg = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        encoded = rs.encode_rs1d_batch(msg, coder)
        codewords = list(torch.split(encoded, params.chunk_size))
        result = EncodedDataEigenDA(codewords=codewords, data_size=len(data))
        du.METRICS.encoding_time += du.clock(dev) - start
        du.METRICS.encoded_size += encoded.numel()
        return result

    @staticmethod
    def commit(encoded: EncodedDataEigenDA, params: PublicParamsEigenDA
               ) -> CommitmentEigenDA:
        quorum_id = 0
        pk = params.quorums[quorum_id]
        start = du.clock(pk.device)
        polys = du.byte_polys(encoded.codewords)
        openings = [kzg.open_quotient(p, OPEN_AT) for p in polys]
        points = kzg.commit_many(pk, polys + [q for _, q in openings])
        chunk_commitments = points[:len(polys)]
        chunk_proofs = [(y, w) for (y, _), w in zip(openings, points[len(polys):])]
        du.METRICS.commitment_time += du.clock(pk.device) - start
        du.METRICS.commitment_size += 64 * len(chunk_commitments)
        du.METRICS.proof_size += 96 * len(chunk_proofs)
        return CommitmentEigenDA(chunk_commitments=chunk_commitments,
                                 chunk_proofs=chunk_proofs, quorum_id=quorum_id)

    @staticmethod
    def verify(position: du.SamplePosition, encoded: EncodedDataEigenDA,
               commitment: CommitmentEigenDA, params: PublicParamsEigenDA) -> bool:
        pk = params.quorums[0]
        start = du.clock(pk.device)
        y, w = commitment.chunk_proofs[position.col]
        ok = kzg.verify(pk, OPEN_AT, y, commitment.chunk_commitments[position.col], w)
        du.METRICS.verification_time += du.clock(pk.device) - start
        return ok

    @staticmethod
    def reconstruct(encoded: EncodedDataEigenDA, params: PublicParamsEigenDA) -> bytes:
        dev = params.quorums[0].device
        start = du.clock(dev)
        codeword_size = int(encoded.data_size * math.ceil(params.expansion_factor))
        coder = rs.setup_rs1d(codeword_size, encoded.data_size)
        codeword = torch.cat(encoded.codewords).cpu().tolist()
        out = rs.decode_rs1d(codeword, coder)
        du.METRICS.reconstruction_time += du.clock(dev) - start
        return bytes(out)

    @staticmethod
    def metrics() -> du.SystemMetrics:
        return du.get_metrics()
