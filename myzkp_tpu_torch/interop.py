"""State shared with the JAX package, as numpy arrays and .npz / JSON files.

The JAX package holds field elements as ``(L, *batch)`` uint32 arrays of
16-bit limbs; the port holds the same integers as int32 tensors.  These
functions move limb arrays, extension-field batches, G1 and G2 point batches
(3 or 6 coordinate arrays, in the order of ``weierstrass.leaves``), ``Fp`` /
``Poly`` values, ``MPoly`` dicts, a KZG key's powers, a FastStark's preprocessed state and
sparse circuits across, and read
what the JAX side writes: the fixed-base
tables (``curves/fixed_base.py``, keys ``l0..l2`` or ``l0..l5``), the bench's
MSM point table (``bench.py``, keys ``x, y, z``), any proving key written
by ``utils/serialize.save_point_batches`` (``load_key``: Pinocchio's,
Groth16's, through the port's ``utils/serialize``), and a Groth16 verifying
key from host ints and its ``g1_k_pub`` arrays.  The
port's own fixed-base cache is written in the same format.  Every loader makes
its tensors on the card unless ``device`` names another device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import _ext
from .arith.qap import QAP
from .arith.r1cs import R1CS
from .arith.sparse import SparseMatrix, SparseR1CS
from .curves.weierstrass import Point, from_leaves, leaves
from .fields.fp import Fp
from .fields.spec import FieldSpec
from .ops.mpoly import MPoly
from .ops.poly import Poly


def limbs_from_numpy(a, device=None) -> torch.Tensor:
    """(L, *batch) array of 16-bit limbs (any integer dtype) -> int32 tensor."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"limb array of dtype {a.dtype}")
    if a.size and (a.min() < 0 or a.max() >= 1 << 16):
        raise ValueError("limb values outside [0, 2^16)")
    return torch.from_numpy(a.astype(np.int32)).to(_ext.resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array, the JAX package's layout."""
    return t.detach().cpu().numpy().astype(np.uint32)


def efield_from_numpy(es, arr, device=None) -> torch.Tensor:
    """The JAX package's extension-field batch, a (k, L, *batch) uint32
    array of Montgomery limbs, as the port's tensor (``fields/efield.py``)."""
    a = np.asarray(arr)
    if a.shape[:2] != (es.k, es.base.L):
        raise ValueError(f"shape {a.shape}: expected (k, L) = {(es.k, es.base.L)} first")
    return limbs_from_numpy(a, device)


def point_from_numpy(arrays, device=None) -> Point:
    """3 coordinate limb arrays (G1) or 6 (G2: x0, x1, y0, y1, z0, z1) ->
    point batch."""
    return from_leaves(limbs_from_numpy(a, device) for a in arrays)


def point_to_numpy(pt) -> tuple:
    return tuple(limbs_to_numpy(c) for c in leaves(pt))


def save_fixed_base_table(path, pt: Point) -> None:
    """Write a table in the fixed-base cache format (keys l0, l1, ...),
    through a temporary file so that a reader never sees half a table."""
    tmp = f"{path}.tmp{os.getpid()}.npz"  # np.savez appends .npz itself
    np.savez(tmp, **{f"l{i}": a for i, a in enumerate(point_to_numpy(pt))})
    os.replace(tmp, path)


def load_fixed_base_table(path, device=None) -> Point:
    """A fixed-base table .npz (keys l0..l2 for G1, l0..l5 for G2) -> point
    batch."""
    with np.load(path) as data:
        return point_from_numpy([data[f"l{i}"] for i in range(len(data.files))],
                                device)


def load_bench_points(path, device=None) -> Point:
    """The bench's MSM point table .npz (keys x, y, z) -> point batch."""
    with np.load(path) as data:
        return point_from_numpy([data[k] for k in ("x", "y", "z")], device)


def fp_from_numpy(spec: FieldSpec, mont, device=None) -> Fp:
    """Montgomery limb array (the JAX ``Fp.mont``) -> Fp."""
    return Fp(spec, limbs_from_numpy(mont, device))


def fp_to_numpy(a: Fp) -> np.ndarray:
    return limbs_to_numpy(a.mont)


def poly_from_numpy(spec: FieldSpec, coef_mont, device=None) -> Poly:
    return Poly(fp_from_numpy(spec, coef_mont, device))


def poly_to_numpy(a: Poly) -> np.ndarray:
    return fp_to_numpy(a.coef)


def stark_preprocessed_from_numpy(spec: FieldSpec, tz_coef_mont, tz_codeword_mont, tz_root,
                                  tz_leaves, device=None) -> tuple:
    """The JAX ``FastStark.preprocess()`` tuple, with its polynomial and
    codeword as Montgomery limb arrays, -> the port's (tz Poly, tz codeword
    Fp, root, leaves)."""
    return (poly_from_numpy(spec, tz_coef_mont, device),
            fp_from_numpy(spec, tz_codeword_mont, device), bytes(tz_root), list(tz_leaves))


def mpoly_from_dict(spec: FieldSpec, d: dict) -> MPoly:
    """The JAX ``MPoly.d`` ({exponent tuple: int coefficient}) -> MPoly."""
    return MPoly(spec, d)


def kzg_pk_from_numpy(powers1_arrays, powers2_arrays, device=None):
    """A ``commit.kzg.KZGPublicKey`` from the JAX key's ``powers1`` (3
    coordinate limb arrays) and ``powers2`` (6) as numpy, so that both
    packages can hold one SRS."""
    from .commit.kzg import KZGPublicKey  # kzg imports this module (via fixed_base)

    return KZGPublicKey(powers1=point_from_numpy(powers1_arrays, device),
                        powers2=point_from_numpy(powers2_arrays, device))


def sparse_matrix_from_numpy(spec: FieldSpec, rows, cols, vals_mont, shape,
                             device=None) -> SparseMatrix:
    """A COO matrix from the JAX ``SparseMatrix``'s rows, cols and
    ``vals.mont`` as numpy arrays."""
    device = _ext.resolve_device(device)
    idx = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
    return SparseMatrix(idx(rows), idx(cols), fp_from_numpy(spec, vals_mont, device),
                        tuple(shape))


def sparse_r1cs_from_numpy(spec: FieldSpec, mats, device=None) -> SparseR1CS:
    """mats: three (rows, cols, vals_mont, shape) tuples, for L, R and O."""
    return SparseR1CS(*(sparse_matrix_from_numpy(spec, *m, device=device)
                        for m in mats))


def r1cs_from_numpy(spec: FieldSpec, left, right, out, device=None) -> R1CS:
    """A dense R1CS from the JAX ``R1CS``'s three (L, m, d) Montgomery limb
    arrays (``left.mont``, ``right.mont``, ``out.mont``)."""
    return R1CS(*(fp_from_numpy(spec, mat, device) for mat in (left, right, out)))


def qap_from_numpy(spec: FieldSpec, ell, r, o, t, m: int, d: int, device=None) -> QAP:
    """A dense QAP from the JAX ``QAP``'s (L, d, m) coefficient arrays ell,
    r, o and its (L, m + 1) target t, all Montgomery limbs."""
    return QAP(*(fp_from_numpy(spec, a, device) for a in (ell, r, o, t)), m, d)


def load_key(path, cls, device=None):
    """A key dataclass ``cls`` (``snark.pinocchio.PinocchioProofKey``,
    ``snark.groth16.Groth16ProvingKey``) from what either package's
    ``utils/serialize.save_point_batches`` writes (``save_pinocchio_pk``
    included), read by the port's ``serialize.load_point_batches``: each
    point field a point batch, each other field an int."""
    from .utils import serialize  # serialize imports this module

    data = serialize.load_point_batches(path, device)
    return cls(**{f.name: data[f.name] if isinstance(data[f.name], Point)
                  else int(data[f.name]) for f in dataclasses.fields(cls)})


def groth16_vk_from_host(points: dict, g1_k_pub, device=None):
    """A Groth16 verifying key from host ints: ``points`` maps g1_alpha,
    g2_beta, g2_gamma and g2_delta to entries in ``save_pinocchio_vk``'s JSON
    form ([group, coords]); ``g1_k_pub`` is the 3 coordinate limb arrays of
    the (num_public,) batch -> ``snark.groth16.Groth16VerifyingKey``."""
    from .snark.groth16 import Groth16VerifyingKey  # groth16 imports this module
    from .utils.serialize import host_point_from_json

    k_pub = point_from_numpy(g1_k_pub, device)
    return Groth16VerifyingKey(**{k: host_point_from_json(v) for k, v in points.items()},
                               g1_k_pub=k_pub, num_public=k_pub.x.shape[1])
