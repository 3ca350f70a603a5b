"""Celestia-style data availability: a 2D Reed-Solomon extension of the data
square, one Merkle root a row and a column, and a root of those roots.

Counterpart of ``myzkp_tpu/das/celestia.py`` (the reference's
``celestia.rs``): setup, encode, commit, verify of one sample by its row or
column path, and reconstruct.  The extended square is a uint8 tensor on the
params' device, encoded in one batched pass (``encode_rs2d_batch``); the
trees are the port's SHA3 Merkle trees over the JAX package's leaves, one
byte a cell, so every root and path is the JAX package's.  Decoding runs on
the host, as in the reference.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _ext
from ..codes import reedsolomon as rs
from ..utils import merkle
from . import utils as du


@dataclass
class PublicParamsCelestia:
    codeword_size: int
    chunk_size: int
    device: torch.device


@dataclass
class EncodedDataCelestia:
    codewords: torch.Tensor  # (side, side) uint8: [row][col], one byte a cell
    data_size: int

    @functools.cached_property
    def cells(self) -> np.ndarray:
        """The square on the host (copied once)."""
        return self.codewords.cpu().numpy()

    def row_leaves(self, row: int) -> list:
        return _leaves(self.cells[row])

    def col_leaves(self, col: int) -> list:
        return _leaves(self.cells[:, col])

    def leaf(self, row: int, col: int) -> bytes:
        return bytes([int(self.cells[row, col])])


@dataclass
class CommitmentCelestia:
    row_roots: list
    col_roots: list
    data_root: bytes


def _leaves(line: np.ndarray) -> list:
    raw = np.ascontiguousarray(line).tobytes()
    return [raw[i:i + 1] for i in range(len(raw))]


class Celestia:
    @staticmethod
    def setup(chunk_size: int, expansion_factor: float, data_size: int,
              device=None) -> PublicParamsCelestia:
        codeword_size = int(chunk_size * math.ceil(expansion_factor))
        return PublicParamsCelestia(codeword_size=codeword_size, chunk_size=chunk_size,
                                    device=_ext.resolve_device(device))

    @staticmethod
    def encode(data: bytes, params: PublicParamsCelestia) -> EncodedDataCelestia:
        start = du.clock(params.device)
        coder = rs.setup_rs2d(params.codeword_size, params.codeword_size, len(data))
        msg = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(params.device)
        result = EncodedDataCelestia(codewords=rs.encode_rs2d_batch(msg, coder),
                                     data_size=len(data))
        du.METRICS.encoding_time += du.clock(params.device) - start
        du.METRICS.encoded_size += result.codewords.numel()
        return result

    @staticmethod
    def commit(encoded: EncodedDataCelestia, params: PublicParamsCelestia
               ) -> CommitmentCelestia:
        start = du.clock(params.device)
        rows, cols = encoded.codewords.shape
        row_roots = [merkle.commit(encoded.row_leaves(i)) for i in range(rows)]
        col_roots = [merkle.commit(encoded.col_leaves(i)) for i in range(cols)]
        data_root = merkle.commit(_pad_pow2(row_roots + col_roots))
        result = CommitmentCelestia(row_roots=row_roots, col_roots=col_roots,
                                    data_root=data_root)
        du.METRICS.commitment_time += du.clock(params.device) - start
        du.METRICS.commitment_size += sum(
            len(r) for r in row_roots + col_roots) + len(data_root)
        return result

    @staticmethod
    def verify(position: du.SamplePosition, encoded: EncodedDataCelestia,
               commitment: CommitmentCelestia, params: PublicParamsCelestia
               ) -> bool:
        start = du.clock(params.device)
        proof_start = du.clock(params.device)
        if position.is_row:
            proof = merkle.open(position.col, encoded.row_leaves(position.row))
        else:
            proof = merkle.open(position.row, encoded.col_leaves(position.col))
        proof_time = du.clock(params.device) - proof_start

        leaf = encoded.leaf(position.row, position.col)
        if position.is_row:
            ok = merkle.verify(commitment.row_roots[position.row],
                               position.col, proof, leaf)
        else:
            ok = merkle.verify(commitment.col_roots[position.col],
                               position.row, proof, leaf)
        du.METRICS.verification_time += (du.clock(params.device) - start) - proof_time
        du.METRICS.proof_time += proof_time
        du.METRICS.proof_size += sum(len(p) for p in proof)
        return ok

    @staticmethod
    def reconstruct(encoded: EncodedDataCelestia,
                    params: PublicParamsCelestia) -> bytes:
        start = du.clock(params.device)
        coder = rs.setup_rs2d(params.codeword_size, params.codeword_size,
                              encoded.data_size)
        out = rs.decode_rs2d(encoded.cells.tolist(), coder)
        du.METRICS.reconstruction_time += du.clock(params.device) - start
        return bytes(out)

    @staticmethod
    def metrics() -> du.SystemMetrics:
        return du.get_metrics()


def _pad_pow2(leaves: list) -> list:
    n = len(leaves)
    n2 = 1 << max(0, (n - 1).bit_length())
    return list(leaves) + [b""] * (n2 - n)
