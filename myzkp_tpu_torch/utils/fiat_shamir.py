"""Fiat-Shamir transcript (proof stream) with SHAKE256 challenges.

Counterpart of ``myzkp_tpu/utils/fiat_shamir.py`` (the reference's
``fiat_shamir.rs:11-70``): push / pull of serialized-object lists, the
prover's challenge SHAKE256 over the whole serialized stream, the verifier's
over the prefix read so far, and (de)serialization of the stream as the
wire-format proof.  The bytes are the bincode encoding of
``Vec<Vec<Vec<u8>>>`` (u64 little-endian length prefixes at every level), so
the same pushes give the same challenge bytes in both packages.  Host only:
hashlib and struct.
"""

from __future__ import annotations

import hashlib
import struct


class FiatShamirTransformer:
    def __init__(self, objects: list[list[bytes]] | None = None):
        self.objects: list[list[bytes]] = objects or []
        self.read_index = 0

    # -- stream ops ----------------------------------------------------------
    def push(self, obj: list[bytes]) -> None:
        self.objects.append(list(obj))

    def pull(self) -> list[bytes]:
        if self.read_index >= len(self.objects):
            raise IndexError("ProofStream: cannot pull object; queue empty.")
        obj = self.objects[self.read_index]
        self.read_index += 1
        return obj

    # -- serialization (bincode) ---------------------------------------------
    @staticmethod
    def _ser(objects: list[list[bytes]]) -> bytes:
        out = [struct.pack("<Q", len(objects))]
        for obj in objects:
            out.append(struct.pack("<Q", len(obj)))
            for b in obj:
                out.append(struct.pack("<Q", len(b)))
                out.append(b)
        return b"".join(out)

    def serialize(self) -> bytes:
        return self._ser(self.objects)

    @classmethod
    def deserialize(cls, bb: bytes) -> "FiatShamirTransformer":
        off = 0

        def read_u64():
            nonlocal off
            (v,) = struct.unpack_from("<Q", bb, off)
            off += 8
            return v

        n = read_u64()
        objects = []
        for _ in range(n):
            m = read_u64()
            obj = []
            for _ in range(m):
                k = read_u64()
                obj.append(bb[off : off + k])
                off += k
            objects.append(obj)
        return cls(objects)

    # -- challenges ----------------------------------------------------------
    def prover_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return hashlib.shake_256(self.serialize()).digest(num_bytes)

    def verifier_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return hashlib.shake_256(self._ser(self.objects[: self.read_index])).digest(
            num_bytes
        )
