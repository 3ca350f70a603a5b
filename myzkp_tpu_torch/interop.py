"""State shared with the JAX package, as numpy arrays and .npz files.

The JAX package holds field elements as ``(L, *batch)`` uint32 arrays of
16-bit limbs; the port holds the same integers as int32 tensors.  These
functions move limb arrays and point batches across, and read the two caches
the JAX side writes: the fixed-base table (``curves/fixed_base.py``, keys
``l0..l2``) and the bench's MSM point table (``bench.py``, keys ``x, y, z``).
The port's own fixed-base cache is written in the same format.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .curves.weierstrass import Point


def limbs_from_numpy(a, device=None) -> torch.Tensor:
    """(L, *batch) array of 16-bit limbs (any integer dtype) -> int32 tensor."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"limb array of dtype {a.dtype}")
    if a.size and (a.min() < 0 or a.max() >= 1 << 16):
        raise ValueError("limb values outside [0, 2^16)")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array, the JAX package's layout."""
    return t.detach().cpu().numpy().astype(np.uint32)


def point_from_numpy(leaves, device=None) -> Point:
    return Point(*(limbs_from_numpy(a, device) for a in leaves))


def point_to_numpy(pt) -> tuple:
    return tuple(limbs_to_numpy(c) for c in pt)


def save_fixed_base_table(path, pt: Point) -> None:
    """Write a table in the fixed-base cache format (keys l0, l1, l2), through
    a temporary file so that a reader never sees half a table."""
    tmp = f"{path}.tmp{os.getpid()}.npz"  # np.savez appends .npz itself
    np.savez(tmp, **{f"l{i}": a for i, a in enumerate(point_to_numpy(pt))})
    os.replace(tmp, path)


def load_fixed_base_table(path, device=None) -> Point:
    """A G1 fixed-base table .npz (keys l0, l1, l2) -> point batch."""
    with np.load(path) as data:
        return point_from_numpy([data[f"l{i}"] for i in range(3)], device)


def load_bench_points(path, device=None) -> Point:
    """The bench's MSM point table .npz (keys x, y, z) -> point batch."""
    with np.load(path) as data:
        return point_from_numpy([data[k] for k in ("x", "y", "z")], device)
