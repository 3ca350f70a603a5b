"""Generate bn254_constants.h for the host C++ pairing engine (bn254.cpp).

A copy of ``myzkp_tpu/native/gen_constants.py``.  Pure-Python big-int
computation of Montgomery constants, Frobenius gamma tables and exponent bit
strings; run at build time by ``native/__init__.py``.  All values derive from
the BN254 parameters (q, r, the ate loop count |6x + 2|).
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_ORDER = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP_COUNT = 29793968203157093288  # |6x+2|, bn128.rs:26

RR = 1 << 256  # Montgomery radix for 4x64-bit limbs


def limbs(x: int, n: int = 4) -> list[int]:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


def fmt_limbs(x: int, n: int = 4) -> str:
    return "{" + ", ".join(f"0x{v:016x}ull" for v in limbs(x, n)) + "}"


def mont(x: int) -> int:
    return x * RR % Q


def fq2_pow(a: tuple, e: int) -> tuple:
    """(c0, c1) in Fq[u]/(u^2+1), ints."""
    res, base = (1, 0), a
    while e:
        if e & 1:
            res = fq2_mul(res, base)
        base = fq2_mul(base, base)
        e >>= 1
    return res


def fq2_mul(a: tuple, b: tuple) -> tuple:
    c0 = (a[0] * b[0] - a[1] * b[1]) % Q
    c1 = (a[0] * b[1] + a[1] * b[0]) % Q
    return (c0, c1)


def bit_str(e: int) -> str:
    """MSB-first bit list for square-and-multiply."""
    return "{" + ", ".join(bin(e)[2:]) + "}"


def emit() -> str:
    xi = (9, 1)  # Fq6 non-residue xi = 9 + u  (Fq2 = Fq[u]/(u^2+1))
    out = []
    a = out.append
    a("// Auto-generated by gen_constants.py — do not edit.")
    a("#pragma once")
    a("#include <cstdint>")
    a("namespace bn254 {")
    a(f"static const uint64_t Q_LIMBS[4] = {fmt_limbs(Q)};")
    np = (-pow(Q, -1, 1 << 64)) % (1 << 64)
    a(f"static const uint64_t Q_NP = 0x{np:016x}ull;  // -q^-1 mod 2^64")
    a(f"static const uint64_t R2[4] = {fmt_limbs(RR * RR % Q)};")
    a(f"static const uint64_t MONT_ONE[4] = {fmt_limbs(RR % Q)};")
    a(f"static const uint64_t MONT_THREE[4] = {fmt_limbs(mont(3))};")
    a(f"static const uint64_t MONT_NINE[4] = {fmt_limbs(mont(9))};")

    # Frobenius gamma tables: gamma_1[j] = xi^(j*(q-1)/6) in Fq2, j=1..5.
    # Used for Fq12/Fq6 frobenius: (c_j coefficients pick up gamma factors).
    gammas = []
    for j in range(1, 6):
        g = fq2_pow(xi, j * (Q - 1) // 6)
        gammas.append(g)
    for j, g in enumerate(gammas, start=1):
        a(f"static const uint64_t FROB_GAMMA{j}_C0[4] = {fmt_limbs(mont(g[0]))};")
        a(f"static const uint64_t FROB_GAMMA{j}_C1[4] = {fmt_limbs(mont(g[1]))};")

    # Exponent bit strings (MSB first) for Fermat inversion and final exp.
    def emit_bits(name: str, e: int):
        bits = bin(e)[2:]
        a(f"static const int {name}_NBITS = {len(bits)};")
        a(f"static const uint8_t {name}_BITS[{len(bits)}] = "
          + "{" + ",".join(bits) + "};")

    emit_bits("Q_MINUS_2", Q - 2)
    lam = (Q**4 - Q**2 + 1) // R_ORDER
    assert (Q**12 - 1) % R_ORDER == 0
    assert (Q**6 - 1) * (Q**2 + 1) * lam == (Q**12 - 1) // R_ORDER
    emit_bits("FINAL_EXP_HARD", lam)
    emit_bits("ATE_LOOP", ATE_LOOP_COUNT)
    a("}  // namespace bn254")
    a("")
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    path = sys.argv[1] if len(sys.argv) > 1 else "src/bn254_constants.h"
    with open(path, "w") as f:
        f.write(emit())
    print(f"wrote {path}")
