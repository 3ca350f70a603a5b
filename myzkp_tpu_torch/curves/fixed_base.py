"""Fixed-base batched scalar multiplication [x_i]G by windowed tables.

Counterpart of ``myzkp_tpu/curves/fixed_base.py`` for G1 and G2.  The host
builds the table T[j, d] = [d * 2^(c*j)] G (W = ceil(256/c) windows of 2^c
entries) once per group and caches it as .npz under the ignored build
directory, in the JAX package's format (keys l0..l2 for G1, l0..l5 for G2),
and the device holds it as a row-major table (K16); each scalar then costs W
rows gathered into limb planes (K14) and a W -> 1 tree of batched complete
adds (K2 for G1, K7 for G2).
"""

from __future__ import annotations

import functools

import torch

from .. import _ext, interop
from . import bn254, msm as _msm, weierstrass as wst

_TABLE_C = 8  # window bits: W = 32 windows, 2^8 entries each
# Scalars per gather + tree sum: bounds the gathered planes at W points per
# scalar, 1.5 GiB for G1 (48 limbs a point) and 3 GiB for G2 (96).
_CHUNK = 1 << 18
TABLE_DIR = _ext.BUILD_DIR / "fixed_base"
_GROUPS = {
    "g1": (bn254.g1_generator, bn254.g1_points_to_device, bn254.g1_ops, bn254.g1_b3),
    "g2": (bn254.g2_generator, bn254.g2_points_to_device, bn254.g2_ops, bn254.g2_b3),
}


def _group(which: str):
    if which not in _GROUPS:
        raise ValueError(f"fixed-base group {which!r}: expected 'g1' or 'g2'")
    return _GROUPS[which]


def _build_host_table(which: str) -> list:
    """[d * 2^(c*j)]G as host points, row-major (j major, d minor)."""
    c = _TABLE_C
    base = _group(which)[0]()
    rows = []
    for _ in range(-(-256 // c)):
        acc = None  # infinity
        rows.append(None)
        for _ in range((1 << c) - 1):
            acc = base if acc is None else acc + base
            rows.append(acc)
        for _ in range(c):
            base = base + base
    return rows


def table_path(which: str):
    """Where the table's .npz cache lives."""
    return TABLE_DIR / f"{which}_c{_TABLE_C}.npz"


@functools.lru_cache(maxsize=None)
def _device_table(which: str, device: torch.device) -> wst.Point:
    """(W * 2^c,) point batch of the windowed multiples, disk-cached."""
    to_device = _group(which)[1]
    path = table_path(which)
    if path.exists():
        return interop.load_fixed_base_table(path, device)
    pts = to_device(_build_host_table(which), device)
    TABLE_DIR.mkdir(parents=True, exist_ok=True)
    interop.save_fixed_base_table(path, pts)
    return pts


@functools.lru_cache(maxsize=None)
def _table_rows(which: str, device: torch.device):
    """(W * 2^c, lanes) row-major gather table and its used width C."""
    return _msm._rows_of_point(_device_table(which, device))


def fixed_base_multi(which: str, scalars_std) -> wst.Point:
    """[x_i]G for the generator of ``which`` ("g1" or "g2").  scalars_std:
    (L, n) standard-domain limbs; returns a projective (n,) point batch on the
    scalars' device."""
    _, _, ops, b3_of = _group(which)
    device = scalars_std.device
    c = _TABLE_C
    rows, C = _table_rows(which, device)
    F, b3 = ops(), b3_of((), device)
    digits = _msm.scalar_digits(scalars_std, c)  # (W, n)
    W, n = digits.shape
    offsets = (torch.arange(W, dtype=torch.int32, device=device) << c)[:, None]
    outs = []
    for off in range(0, n, _CHUNK):
        d = digits[:, off:off + _CHUNK]
        pts = _msm._point_of_rows(rows, C, tuple(d.shape), (d + offsets).reshape(-1))
        outs.append(wst.tree_sum(F, b3, pts, axis=0))
    return wst.point_map(lambda *cs: torch.cat(cs, dim=1), *outs)
