"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with nvcc for ``sm_90a`` (one nvcc per
source, in parallel, each object kept and reused while its source, the
headers and its flags are unchanged) and linked into one shared library with
a plain C interface under ``_build/`` (ignored by git) at first use, and
loaded with ctypes.  The library's file name carries a digest of the sources and flags,
so an edited source is never served from a stale build.  A design constant
that a source leaves to the preprocessor (``#ifndef``) can be set for a build
with ``use_defines`` without editing the source; each set of definitions is a
library of its own.

Dispatch is one rule, keyed on the tensors' device: a CUDA tensor goes to the
kernel and a CPU tensor goes to the kernel's plain PyTorch version.  There is
no process-wide backend query and no fallback: a launch that fails raises.
Constructors that take a ``device`` make their tensors on the card unless the
caller names another device (``resolve_device``); without CUDA such a call
raises rather than quietly running on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .fields.spec import FieldSpec

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("mont_mul", "mont_pow", "padd", "pdbl", "bucket_scan_rows", "butterfly",
           "ntt_leaf", "padd2", "pdbl2", "padd_mixed", "padd_mixed2",
           "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
           "scatter_rows", "long_division", "mont_mul_l8", "mont_pow_l8", "butterfly_l8",
           "ntt_leaf_l8", "long_division_l8", "mont_mul_l4", "mont_pow_l4",
           "butterfly_pair", "butterfly_pair_l8", "butterfly_pair_l4")
# The kernels with an instance at each width: "<name>" at L = 16 limbs
# (BN254's fields), "<name>_l8" at L = 8 (M128) (kernel_name).
FIELD_KERNELS = ("mont_mul", "mont_pow", "butterfly", "ntt_leaf", "long_division",
                 "butterfly_pair")
# The kernels with an instance at L = 4 (M64), "<name>_l4": K1, its chain and
# K5's pair form.
L4_KERNELS = ("mont_mul", "mont_pow", "butterfly_pair")

# Launches of each kernel since the last reset_launches().  A wrapper adds one
# where it launches its kernel (launch() below) and nowhere else.
launches = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "mont_mul": (_P, _P, _P, _I64, _I64, _P, _P),
    "mont_pow": (_P, _P, _I64, _P, _P, _P),
    "padd": (_P,) * 11 + (_I64, _P, _P),
    "pdbl": (_P,) * 10 + (_I64, ctypes.c_int, _P, _P),
    "bucket_scan_rows": (_P,) * 7 + (_I64, ctypes.c_int, _P, _P),
    "butterfly": (_P,) * 3 + (_I64,) * 4 + (ctypes.c_int, _P, _P),
    "ntt_leaf": (_P,) * 3 + (_I64, ctypes.c_int, ctypes.c_int, _I64, _P, _P),
    "padd2": (_P,) * 21 + (_I64, _P, _P),
    "pdbl2": (_P,) * 20 + (_I64, ctypes.c_int, _P, _P),
    "padd_mixed": (_P,) * 10 + (_I64, _P, _P),
    "padd_mixed2": (_P,) * 19 + (_I64, _P, _P),
    "bucket_scan_rows2": (_P,) * 8 + (_I64, ctypes.c_int, _P, _P),
    "padd_seg_level": (_P,) * 9 + (_I64,) * 3 + (_P, _P),
    "padd2_seg_level": (_P,) * 16 + (_I64,) * 3 + (_P, _P),
    "gather_planes": (_P, _P, ctypes.c_int, _P, _I64, ctypes.c_int, ctypes.c_int, _P),
    "scatter_rows": (_P,) * 7 + (ctypes.c_int, _P, _I64, ctypes.c_int, ctypes.c_int, _P),
    "long_division": (_P,) * 5 + (_I64,) * 3 + (_P, _P),
    "butterfly_pair": (_P,) * 5 + (_I64, ctypes.c_int, _P, _P),
    "long_division_plan": (_I64,) * 4 + (_P,),  # a query, not a kernel: launches nothing
}
_SIGNATURES.update({f"{k}_l8": _SIGNATURES[k] for k in FIELD_KERNELS})
_SIGNATURES.update({f"{k}_l4": _SIGNATURES[k] for k in L4_KERNELS})

_lib = None
# -D definitions of the library that launches use (use_defines)
_defines: tuple[str, ...] = ()


def default_device() -> torch.device:
    """The device of a constructor called without one: the card."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` if the caller named one, else ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device, False on the CPU.

    Raises on a mix of devices or on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless t has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def use_defines(defines=()) -> None:
    """Make the library built with ``-D`` of each of ``defines`` (``"NAME=value"``
    strings) the one that launches use, built at its first use; ``()`` is the
    sources as they stand.  Raises on a name that no source mentions."""
    global _lib, _defines
    _check_defines(defines)
    _defines, _lib = tuple(defines), None


def defined(name: str, default: int) -> int:
    """The value that the definitions of ``use_defines`` give the constant
    ``name``, else ``default`` (the source's own ``#ifndef`` value)."""
    for d in _defines:
        key, _, value = d.partition("=")
        if key == name:
            return int(value)
    return default


def _sources_text(src: Path) -> bytes:
    """A source and every csrc header it includes, directly or through another
    header, as one byte string: a definition that only another source's
    header mentions does not rebuild this source."""
    text = src.read_bytes()
    headers, todo = set(), [text]
    while todo:
        for name in re.findall(rb'#include "([^"]+)"', todo.pop()):
            f = CSRC / name.decode()
            if f not in headers and f.exists():
                headers.add(f)
                todo.append(f.read_bytes())
    return text + b"".join(f.name.encode() + f.read_bytes() for f in sorted(headers))


def _mentioned(defines, text: bytes) -> tuple[str, ...]:
    return tuple(d for d in defines if d.split("=")[0].encode() in text)


def _check_defines(defines) -> None:
    """Raise unless every definition's name appears in a csrc/ source or
    header: one that none mentions would not be compiled into any object."""
    text = b"".join(_sources_text(src) for src in sorted(CSRC.glob("*.cu")))
    unknown = sorted(set(defines) - set(_mentioned(defines, text)))
    if unknown:
        raise ValueError(f"no source in {CSRC.name}/ mentions {unknown}")


def _flags(defines) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _source_digest(defines) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(defines=None) -> Path:
    """The library of ``defines`` (by default those of ``use_defines``)."""
    d = _defines if defines is None else tuple(defines)
    _check_defines(d)
    return BUILD_DIR / f"libmyzkp_kernels_{_source_digest(d)}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _object_path(src: Path, defines) -> tuple[Path, tuple[str, ...]]:
    """The object file of one source under ``defines``, and the definitions
    it is compiled with: only those whose name the source or a header
    mentions, so that a variant of another source's constant reuses it.  Its
    name is a digest of the source, the headers and those flags."""
    text = _sources_text(src)
    used = _mentioned(defines, text)
    h = hashlib.sha256(" ".join(_flags(used)).encode() + src.name.encode() + text)
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.o", used


_object_locks: dict = {}
_object_locks_guard = threading.Lock()


def _compile(src: Path, obj: Path, used, nvcc: str) -> str | None:
    """Compile src to obj unless obj exists (one thread at a time per obj);
    the compiler's output goes beside it as ``<obj>.log``.  Returns the
    output if nvcc failed, else None."""
    with _object_locks_guard:
        lock = _object_locks.setdefault(obj, threading.Lock())
    with lock:
        if obj.exists():
            return None
        tmp = obj.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.o")
        try:
            run = subprocess.run([nvcc, *_flags(used), "-c", "-o", str(tmp), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            obj.with_suffix(".log").write_text(run.stdout)
            if run.returncode:
                return run.stdout
            os.replace(tmp, obj)
        finally:
            tmp.unlink(missing_ok=True)
    return None


def build(defines=None) -> float:
    """Compile the shared library of ``defines`` (by default those of
    ``use_defines``); returns the seconds taken.

    One nvcc per csrc/*.cu source whose object (``_object_path``) is not
    built yet, all started together; then one link.  The compilers' output
    (register and spill counts from -Xptxas -v) is kept beside the library
    as ``<library>.log``."""
    defines = _defines if defines is None else tuple(defines)
    out = library_path(defines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(src, *_object_path(src, defines)) for src in sorted(CSRC.glob("*.cu"))]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        errors = list(pool.map(lambda j: _compile(*j, nvcc), jobs))
    failed = {src.name: err for (src, _, _), err in zip(jobs, errors) if err is not None}
    if failed:
        raise RuntimeError(f"nvcc failed on {sorted(failed)}:\n"
                           + "\n".join(failed.values())[-4000:])
    tmp = out.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                          capture_output=True, text=True)
    logs = [f"== {src.name}\n{obj.with_suffix('.log').read_text()}" for src, obj, _ in jobs]
    logs.append(f"== link\n{link.stdout}{link.stderr}")
    out.with_suffix(".log").write_text("\n".join(logs))
    if link.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed on link:\n" + "\n".join(logs)[-4000:])
    os.replace(tmp, out)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, f"myzkp_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.myzkp_error_string.argtypes = (ctypes.c_int,)
        lib.myzkp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _field_consts_type(words: int):
    # mirrors struct FieldConstsN<N> in csrc/field.cuh
    return type(f"_FieldConsts{words}", (ctypes.Structure,), {"_fields_": [
        ("p", ctypes.c_uint32 * words), ("one", ctypes.c_uint32 * words),
        ("n0", ctypes.c_uint32)]})


# Limbs L -> the kernels' constants struct at N = L / 2 words.
_FIELD_CONSTS = {16: _field_consts_type(8), 8: _field_consts_type(4), 4: _field_consts_type(2)}


def _check_width(spec: FieldSpec) -> None:
    """The kernels take L = 16 limbs (BN254's fields, p < 2^255: the
    eight-word product keeps its sum in eight words), L = 8 (M128) and
    L = 4 (M64): there the product keeps a carry word, so any odd p below
    R = 2^128 or 2^64."""
    if spec.L not in _FIELD_CONSTS:
        raise ValueError(f"the CUDA kernels take L = 16, 8 or 4 limbs, not {spec.L}")
    if spec.L == 16 and spec.p >> 255:
        raise ValueError("the CUDA kernels take p < 2^255 at L = 16")


@functools.lru_cache(maxsize=None)
def field_consts(spec: FieldSpec):
    """The kernels' constants of ``spec`` (``_check_width``)."""
    _check_width(spec)
    nw = spec.L // 2
    words = lambda x: [(x >> (32 * k)) & 0xFFFFFFFF for k in range(nw)]
    c = _FIELD_CONSTS[spec.L]()
    c.p[:] = words(spec.p)
    c.one[:] = words((1 << (32 * nw)) % spec.p)
    c.n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return c


def kernel_name(name: str, spec: FieldSpec) -> str:
    """The instance of a kernel of FIELD_KERNELS at ``spec``'s width:
    ``name`` at L = 16, ``name_l8`` at L = 8, ``name_l4`` at L = 4 (the
    kernels of L4_KERNELS only); raises at any other L."""
    _check_width(spec)
    if spec.L == 4 and name not in L4_KERNELS:
        raise ValueError(f"{name} has no instance at L = 4")
    return {16: name, 8: f"{name}_l8", 4: f"{name}_l4"}[spec.L]


class _Exponent(ctypes.Structure):
    # mirrors struct Exponent in csrc/mont_mul.cu
    _fields_ = [("w", ctypes.c_uint32 * 8), ("nbits", ctypes.c_int32)]


def exponent_words(e: int) -> tuple[tuple[int, ...], int]:
    """A host exponent 0 <= e < 2^256 as the chain kernel takes it: eight
    little-endian 32-bit words and the bit length."""
    if not 0 <= e < 1 << 256:
        raise ValueError("the exponent must lie in [0, 2^256)")
    return tuple((e >> (32 * k)) & 0xFFFFFFFF for k in range(8)), e.bit_length()


def exponent(e: int) -> _Exponent:
    words, nbits = exponent_words(e)
    x = _Exponent()
    x.w[:] = words
    x.nbits = nbits
    return x


def launch(kernel: str, device: torch.device, *args) -> None:
    """Launch ``kernel`` on the current stream of ``device``; count it.

    ``args`` are the C function's arguments up to, not including, the stream.
    Raises when the launch returns a CUDA error."""
    fn = getattr(library(), f"myzkp_{kernel}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = library().myzkp_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
    launches[kernel] += 1


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def consts_ptr(spec: FieldSpec) -> ctypes.c_void_p:
    return ctypes.c_void_p(ctypes.addressof(field_consts(spec)))
