"""Host libraries in C++, bound with ctypes: the BN254 pairing and the
verifier's multi-pairing, and the Merkle tree's SHA3-256 levels.

``bn254.cpp``, ``gen_constants.py`` and ``keccak.cpp`` are the port's copies
of the JAX package's engine (``myzkp_tpu/native/``).  At first use each
library is built with g++ into ``_build/`` (ignored by git; the pairing's
constants header generated first), under a file name that carries a digest of
its sources, so an edited source is never served from a stale build.  There
is no Python fallback: a failed build raises.  This is host code; the card is
not involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import gen_constants

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "bn254.cpp"
_KECCAK = _DIR / "keccak.cpp"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
KECCAK_FLAGS = GXX_FLAGS + ("-pthread",)

_lib = None
_keccak = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    h.update(gen_constants.emit().encode())
    return BUILD_DIR / f"libmyzkp_pairing_{h.hexdigest()[:16]}.so"


def keccak_library_path() -> Path:
    h = hashlib.sha256(" ".join(KECCAK_FLAGS).encode())
    h.update(_KECCAK.read_bytes())
    return BUILD_DIR / f"libmyzkp_keccak_{h.hexdigest()[:16]}.so"


def _gxx(source: Path, out: Path, flags, include=None) -> Path:
    """Compile ``source`` into the library ``out``; raises with the
    compiler's output when g++ fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    inc = ("-I", str(include)) if include else ()
    res = subprocess.run(["g++", *flags, *inc, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Generate the constants header and compile the pairing library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as inc:
        Path(inc, "bn254_constants.h").write_text(gen_constants.emit())
        return _gxx(_SOURCE, library_path(), GXX_FLAGS, inc)


def build_keccak() -> Path:
    """Compile the SHA3 / Merkle library."""
    return _gxx(_KECCAK, keccak_library_path(), KECCAK_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded pairing library, built first if it is missing."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.bn254_multi_pairing.argtypes = (ctypes.c_int, u64p, intp, u64p,
                                            intp, u64p)
        lib.bn254_multi_pairing.restype = None
        lib.bn254_pairing.argtypes = (u64p, ctypes.c_int, u64p, ctypes.c_int, u64p)
        lib.bn254_pairing.restype = None
        _lib = lib
    return _lib


def _u64x4(x: int) -> list:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]


def _pack(pairs) -> tuple:
    """Host (G1, G2) PyPoint pairs -> the C entries' standard-form u64
    coordinate arrays (8 words a G1 point, 16 a G2 point) and infinity
    flags."""
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g2 = (ctypes.c_uint64 * (16 * n))()
    inf1, inf2 = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    for k, (p, q) in enumerate(pairs):
        inf1[k], inf2[k] = int(p.inf), int(q.inf)
        if not p.inf:
            g1[8 * k:8 * (k + 1)] = _u64x4(int(p.x)) + _u64x4(int(p.y))
        if not q.inf:
            g2[16 * k:16 * (k + 1)] = [w for c in (*q.x.c, *q.y.c)
                                       for w in _u64x4(c.v)]
    return g1, inf1, g2, inf2


def _fq12_ints(out) -> list:
    return [sum(int(out[4 * i + j]) << (64 * j) for j in range(4))
            for i in range(12)]


def pairing_coeffs(p_g1, q_g2) -> list:
    """e(P, Q) for a host G1 and G2 PyPoint -> the 12 poly-basis F_q
    coefficients (F_q[w] / (w^12 - 18 w^6 + 82)) as ints."""
    g1, inf1, g2, inf2 = _pack([(p_g1, q_g2)])
    out = (ctypes.c_uint64 * 48)()
    library().bn254_pairing(g1, inf1[0], g2, inf2[0], out)
    return _fq12_ints(out)


def multi_pairing_coeffs(pairs) -> list:
    """prod_i e(P_i, Q_i) for host (G1, G2) PyPoint pairs, one shared final
    exponentiation -> the 12 poly-basis F_q coefficients as ints."""
    g1, inf1, g2, inf2 = _pack(pairs)
    out = (ctypes.c_uint64 * 48)()
    library().bn254_multi_pairing(len(pairs), g1, inf1, g2, inf2, out)
    return _fq12_ints(out)


def keccak_library() -> ctypes.CDLL:
    """The loaded SHA3 / Merkle library, built first if it is missing."""
    global _keccak
    if _keccak is None:
        path = keccak_library_path()
        if not path.exists():
            build_keccak()
        lib = ctypes.CDLL(str(path))
        u8p, szp = ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t)
        lib.myzkp_sha3_256.argtypes = (u8p, ctypes.c_size_t, ctypes.c_void_p)
        lib.myzkp_sha3_256.restype = None
        lib.myzkp_merkle_levels.argtypes = (u8p, szp, ctypes.c_size_t, ctypes.c_int,
                                            ctypes.c_void_p)
        lib.myzkp_merkle_levels.restype = None
        _keccak = lib
    return _keccak


def sha3_256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    keccak_library().myzkp_sha3_256(data, len(data), out)
    return out.raw


def merkle_levels(leaves: list) -> bytes:
    """The interior nodes of the Merkle tree over ``leaves`` (a power of two
    of byte strings, at least 2), 32 bytes each, level by level from the
    leaves' parents to the root: n - 1 nodes."""
    n = len(leaves)
    if n < 2 or n & (n - 1):
        raise ValueError(f"{n} leaves: the tree takes a power of two, at least 2")
    off = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(np.fromiter(map(len, leaves), dtype=np.uint64, count=n), out=off[1:])
    out = ctypes.create_string_buffer(32 * (n - 1))
    keccak_library().myzkp_merkle_levels(
        b"".join(leaves), off.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)), n,
        os.cpu_count() or 1, out)
    return out.raw
