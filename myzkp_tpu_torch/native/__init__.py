"""The verifier's host pairing: a C++ BN254 multi-pairing bound with ctypes.

``bn254.cpp`` and ``gen_constants.py`` are the port's copies of the JAX
package's engine (``myzkp_tpu/native/``).  At first use the constants header
is generated and the library built with g++ into ``_build/`` (ignored by git),
under a file name that carries a digest of the sources, so an edited source
is never served from a stale build.  There is no Python fallback: a failed
build raises.  This is host code; the card is not involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from . import gen_constants

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "bn254.cpp"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    h.update(gen_constants.emit().encode())
    return BUILD_DIR / f"libmyzkp_pairing_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Generate the constants header and compile the library; raises with
    the compiler's output when g++ fails."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as inc:
        Path(inc, "bn254_constants.h").write_text(gen_constants.emit())
        res = subprocess.run(["g++", *GXX_FLAGS, "-I", inc, "-o", str(tmp),
                              str(_SOURCE)], capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SOURCE.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


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
        _lib = lib
    return _lib


def _u64x4(x: int) -> list:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]


def multi_pairing_coeffs(pairs) -> list:
    """prod_i e(P_i, Q_i) for host (G1, G2) PyPoint pairs, one shared final
    exponentiation -> the 12 poly-basis F_q coefficients as ints."""
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
    out = (ctypes.c_uint64 * 48)()
    library().bn254_multi_pairing(n, g1, inf1, g2, inf2, out)
    return [sum(int(out[4 * i + j]) << (64 * j) for j in range(4))
            for i in range(12)]
