"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with nvcc for ``sm_90a`` (one nvcc per
source, in parallel) and linked into one shared library with a plain C
interface under ``_build/`` (ignored by git) at first use, and loaded with
ctypes.  The library's file name carries a digest of the sources and flags,
so an edited source is never served from a stale build.

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
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .fields.spec import FieldSpec

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "butterfly",
           "ntt_leaf", "padd2", "pdbl2", "padd_mixed", "padd_mixed2",
           "bucket_scan_rows2")

# Launches of each kernel since the last reset_launches().  A wrapper adds one
# where it launches its kernel (launch() below) and nowhere else.
launches = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "mont_mul": (_P, _P, _P, _I64, _P, _P),
    "padd": (_P,) * 11 + (_I64, _P, _P),
    "pdbl": (_P,) * 7 + (_I64, _P, _P),
    "bucket_scan_rows": (_P,) * 6 + (_I64, ctypes.c_int, _P, _P),
    "butterfly": (_P,) * 3 + (_I64,) * 4 + (_P, _P),
    "ntt_leaf": (_P,) * 3 + (_I64, ctypes.c_int, _I64, _P, _P),
    "padd2": (_P,) * 21 + (_I64, _P, _P),
    "pdbl2": (_P,) * 14 + (_I64, _P, _P),
    "padd_mixed": (_P,) * 10 + (_I64, _P, _P),
    "padd_mixed2": (_P,) * 19 + (_I64, _P, _P),
    "bucket_scan_rows2": (_P,) * 7 + (_I64, ctypes.c_int, _P, _P),
}

_lib = None


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


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmyzkp_kernels_{_source_digest()}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> float:
    """Compile the shared library; returns the seconds taken.

    One nvcc per csrc/*.cu source, all started together, each to an object
    file; then one link.  The compilers' output (register and spill counts
    from -Xptxas -v) is kept beside the library as ``<library>.log``."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    try:
        logs = [f"== {src.name}\n{proc.communicate()[0]}"
                for src, proc in zip(sources, procs)]
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode:
                failed.append("link")
        seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs)[-4000:])
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return seconds


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


class _FieldConsts(ctypes.Structure):
    # mirrors struct FieldConsts in csrc/field.cuh
    _fields_ = [("p", ctypes.c_uint32 * 8), ("one", ctypes.c_uint32 * 8),
                ("n0", ctypes.c_uint32)]


@functools.lru_cache(maxsize=None)
def field_consts(spec: FieldSpec) -> _FieldConsts:
    """The kernels' constants for a 256-bit-R field (L = 16 limbs)."""
    if spec.L != 16:
        raise ValueError(f"the CUDA kernels take L = 16 limbs, not {spec.L}")
    words = lambda x: [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    c = _FieldConsts()
    c.p[:] = words(spec.p)
    c.one[:] = words((1 << 256) % spec.p)
    c.n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return c


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
