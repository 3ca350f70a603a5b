"""Avail-style data availability: a 1D Reed-Solomon extension of each row
chunk and one KZG commitment a column.

Counterpart of ``myzkp_tpu/das/avail.py`` (the reference's ``avail.rs``):
setup (a KZG SRS of degree ceil(data / chunk)), encode, commit (the column
polynomial's coefficients are the column's bytes), verify (an opening of
the sampled column at x = 5) and reconstruct (each row decoded on the
host).  The rows are one batched encode on the key's device; the column
polynomials come from the byte columns with one ``to_mont``, and the
commitments from one ``kzg.commit_many`` (one MSM a column), the points the
JAX package's per-column ``commit`` gives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..codes import reedsolomon as rs
from ..commit import kzg
from . import utils as du

OPEN_AT = 5  # the reference's dummy opening point


@dataclass
class PublicParamsAvail:
    expansion_factor: float
    pk: kzg.KZGPublicKey
    chunk_size: int


@dataclass
class EncodedDataAvail:
    codewords: torch.Tensor  # (chunk rows, codeword size) uint8
    data_size: int


@dataclass
class CommitmentAvail:
    commitments: list  # one PyPoint a column


class Avail:
    @staticmethod
    def setup(chunk_size: int, expansion_factor: float, data_size: int,
              device=None) -> PublicParamsAvail:
        pk = kzg.setup(int(math.ceil(data_size / chunk_size)), device=device)
        return PublicParamsAvail(expansion_factor=expansion_factor, pk=pk,
                                 chunk_size=chunk_size)

    @staticmethod
    def encode(data: bytes, params: PublicParamsAvail) -> EncodedDataAvail:
        dev = params.pk.device
        start = du.clock(dev)
        chunk = params.chunk_size
        codeword_size = int(chunk * math.ceil(params.expansion_factor))
        coder = rs.setup_rs1d(codeword_size, chunk)
        rows = -(-len(data) // chunk)
        msgs = torch.zeros(rows * chunk, dtype=torch.uint8)
        msgs[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        codewords = rs.encode_rs1d_batch(msgs.to(dev).reshape(rows, chunk), coder)
        result = EncodedDataAvail(codewords=codewords, data_size=len(data))
        du.METRICS.encoding_time += du.clock(dev) - start
        du.METRICS.encoded_size += codewords.numel()
        return result

    @staticmethod
    def column_polys(encoded: EncodedDataAvail, cols) -> list:
        """The polynomials of the columns ``cols``: coefficient i is row i's
        byte."""
        return du.byte_polys([encoded.codewords[:, c] for c in cols])

    @staticmethod
    def commit(encoded: EncodedDataAvail, params: PublicParamsAvail) -> CommitmentAvail:
        dev = params.pk.device
        start = du.clock(dev)
        polys = Avail.column_polys(encoded, range(encoded.codewords.shape[1]))
        commitments = kzg.commit_many(params.pk, polys)
        du.METRICS.commitment_time += du.clock(dev) - start
        du.METRICS.commitment_size += 64 * len(commitments)
        return CommitmentAvail(commitments=commitments)

    @staticmethod
    def verify(position: du.SamplePosition, encoded: EncodedDataAvail,
               commitment: CommitmentAvail, params: PublicParamsAvail) -> bool:
        dev = params.pk.device
        start = du.clock(dev)
        proof_start = du.clock(dev)
        poly, = Avail.column_polys(encoded, [position.col])
        y, w = kzg.open(params.pk, poly, OPEN_AT)
        proof_time = du.clock(dev) - proof_start
        ok = kzg.verify(params.pk, OPEN_AT, y, commitment.commitments[position.col], w)
        du.METRICS.verification_time += (du.clock(dev) - start) - proof_time
        du.METRICS.proof_time += proof_time
        du.METRICS.proof_size += 64
        return ok

    @staticmethod
    def reconstruct(encoded: EncodedDataAvail, params: PublicParamsAvail) -> bytes:
        dev = params.pk.device
        start = du.clock(dev)
        coder = rs.setup_rs1d(encoded.codewords.shape[1], params.chunk_size)
        out = []
        for row in encoded.codewords.cpu().tolist():
            out.extend(rs.decode_rs1d(row, coder))
        du.METRICS.reconstruction_time += du.clock(dev) - start
        return bytes(out[: encoded.data_size])

    @staticmethod
    def metrics() -> du.SystemMetrics:
        return du.get_metrics()
