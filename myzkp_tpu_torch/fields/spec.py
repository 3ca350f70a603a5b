"""Prime-field specifications for 16-bit-limb Montgomery arithmetic.

A field element of F_p is ``L`` little-endian 16-bit limbs with the limb axis
leading: a tensor of shape ``(L, *batch)``.  All multiplicative arithmetic is
in the Montgomery domain with R = 2^(16*L); for BN254 (L = 16) that is
R = 2^256, the same R as eight 32-bit words, so a CUDA kernel may repack to
32-bit words internally with no change of domain.

Pure Python, the same integers as ``myzkp_tpu/fields/spec.py``.  It is a copy
rather than an import because the JAX package imports ``jax`` on import.
"""

from __future__ import annotations

import dataclasses
import functools

W = 16  # limb width in bits
BASE = 1 << W
MASK = BASE - 1


def _int_to_limbs(x: int, L: int) -> tuple:
    if not 0 <= x < (1 << (W * L)):
        raise ValueError(f"{x} does not fit in {L} limbs")
    return tuple((x >> (W * i)) & MASK for i in range(L))


def _limbs_to_int(limbs) -> int:
    return sum(int(v) << (W * i) for i, v in enumerate(limbs))


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static (hashable) description of a prime field F_p in 16-bit limbs."""

    p: int
    L: int
    n0: int  # -p^{-1} mod 2^16 (Montgomery constant)
    p_limbs: tuple
    r2_limbs: tuple  # R^2 mod p       (to_mont multiplier)
    one_limbs: tuple  # R mod p        (Montgomery representation of 1)
    r_inv: int  # R^{-1} mod p (host-side only)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(p: int, L: int | None = None) -> "FieldSpec":
        if p % 2 == 0 or p <= 2:
            raise ValueError("Montgomery arithmetic needs an odd modulus")
        if L is None:
            L = max(1, (p.bit_length() + W - 1) // W)
        R = 1 << (W * L)
        if p >= R:
            raise ValueError("modulus does not fit in L limbs")
        return FieldSpec(
            p=p,
            L=L,
            n0=(-pow(p, -1, BASE)) % BASE,
            p_limbs=_int_to_limbs(p, L),
            r2_limbs=_int_to_limbs((R * R) % p, L),
            one_limbs=_int_to_limbs(R % p, L),
            r_inv=pow(R, -1, p),
        )

    def to_limbs(self, x: int) -> tuple:
        return _int_to_limbs(x % self.p, self.L)

    def from_limbs(self, limbs) -> int:
        return _limbs_to_int(limbs) % self.p

    def to_mont_int(self, x: int) -> int:
        return (x % self.p) * ((1 << (W * self.L)) % self.p) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x % self.p) * self.r_inv % self.p


# BN254 / alt_bn128 scalar field r (EIP-197), the SNARK field.
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN254 base field q.
BN254_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def bn254_r_spec() -> FieldSpec:
    return FieldSpec.make(BN254_R)


def bn254_q_spec() -> FieldSpec:
    return FieldSpec.make(BN254_Q)
