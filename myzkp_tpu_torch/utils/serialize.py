"""Keys as files: point batches and scalars in one .npz, host points as JSON.

Counterpart of ``myzkp_tpu/utils/serialize.py:23-155``, in the same file
layout, so that a key written by either package loads in the other: a point
batch ``name`` is ``pt:name:n`` (3 coordinate arrays for G1, 6 for G2, in
the order of ``weierstrass.leaves``) and ``pt:name:0`` ..., each an (L, n)
uint32 array of 16-bit Montgomery limbs; any other value is ``arr:name``.
A verification key's host points are JSON entries ``[group, coords]``.
Every write goes through a temporary file and ``os.replace``, so a reader
never sees half a file.  The loaders make their tensors on the card unless
``device`` names another device; ``interop.load_key`` reads keys through
``load_point_batches``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .. import interop
from ..commit.kzg import KZGPublicKey
from ..curves import bn254
from ..curves.weierstrass import Point
from ..fields.host import PyFq2, PyPoint
from ..snark.pinocchio import PinocchioProofKey, PinocchioVerificationKey


def save_point_batches(path: str, **named) -> None:
    """Named point batches (and plain values) to one .npz file."""
    out = {}
    for name, val in named.items():
        if isinstance(val, Point):
            arrays = interop.point_to_numpy(val)
            out[f"pt:{name}:n"] = np.asarray(len(arrays))
            out.update({f"pt:{name}:{i}": a for i, a in enumerate(arrays)})
        else:
            out[f"arr:{name}"] = np.asarray(val)
    tmp = f"{path}.tmp{os.getpid()}.npz"  # np.savez appends .npz itself
    try:
        np.savez(tmp, **out)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_point_batches(path: str, device=None) -> dict:
    """Inverse of save_point_batches: a point batch for each ``pt:`` name
    (3 arrays: G1, 6: G2), a numpy array for each ``arr:`` name."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            kind, name = key.split(":")[:2]
            if kind == "arr":
                out[name] = data[key]
            elif key == f"pt:{name}:n":
                n = int(data[key])
                if n not in (3, 6):
                    raise ValueError(f"{path}: point {name!r} has {n} coordinate arrays")
                out[name] = interop.point_from_numpy(
                    [data[f"pt:{name}:{i}"] for i in range(n)], device)
    return out


def save_kzg_pk(path: str, pk) -> None:
    save_point_batches(path, powers1=pk.powers1, powers2=pk.powers2)


def load_kzg_pk(path: str, device=None) -> KZGPublicKey:
    d = load_point_batches(path, device)
    return KZGPublicKey(powers1=d["powers1"], powers2=d["powers2"])


def save_pinocchio_pk(path: str, pk) -> None:
    save_point_batches(path, **{f.name: getattr(pk, f.name) for f in dataclasses.fields(pk)})


def load_pinocchio_pk(path: str, device=None) -> PinocchioProofKey:
    return PinocchioProofKey(**load_point_batches(path, device))


def host_point_to_json(p: PyPoint) -> list:
    """A host G1 or G2 point -> [group, coords] (coords None at infinity)."""
    grp = "g2" if isinstance(p.curve.b, PyFq2) else "g1"
    if p.inf:
        return [grp, None]
    if grp == "g2":
        return [grp, [[c.v for c in p.x.c], [c.v for c in p.y.c]]]
    return [grp, [p.x.v, p.y.v]]


def host_point_from_json(v) -> PyPoint:
    """[group, coords] -> a host G1 or G2 point."""
    grp, coords = v
    curve = bn254.curve_g2 if grp == "g2" else bn254.curve_g1
    if coords is None:
        return curve.infinity()
    x, y = coords
    if grp == "g2":
        return curve.point(bn254.Fq2([int(c) for c in x]), bn254.Fq2([int(c) for c in y]))
    return curve.point(bn254.Fq(int(x)), bn254.Fq(int(y)))


def save_pinocchio_vk(path: str, vk) -> None:
    out = {f.name: host_point_to_json(getattr(vk, f.name)) for f in dataclasses.fields(vk)}
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, path)


def load_pinocchio_vk(path: str) -> PinocchioVerificationKey:
    with open(path) as fh:
        data = json.load(fh)
    return PinocchioVerificationKey(**{k: host_point_from_json(v) for k, v in data.items()})
