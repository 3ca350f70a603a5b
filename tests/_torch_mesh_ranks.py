"""Rank bodies of tests/test_torch_mesh.py: the port's side of each check,
run inside a world of gloo ranks that ``parallel/mesh.run_ranks`` spawns.

This module imports the port only, never ``jax`` or the JAX package (each
rank checks that neither is loaded), and every result goes back to the test
as numpy arrays, bytes or host ints.  The test holds them against the JAX
package's ``parallel/mesh.py`` and the port's single-rank functions.
"""

import random
import sys

import numpy as np
import torch
import torch.distributed as dist

from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith.qap import QAP
from myzkp_tpu_torch.arith.r1cs import R1CS
from myzkp_tpu_torch.arith.sparse import SparseQAP, square_chain
from myzkp_tpu_torch.curves import bn254, weierstrass as wst
from myzkp_tpu_torch.fields import limb
from myzkp_tpu_torch.fields.spec import FieldSpec
from myzkp_tpu_torch.parallel import mesh as pm
from myzkp_tpu_torch.snark import groth16, pinocchio

DEV = torch.device("cpu")
P32 = 3221225473
MERKLE_INDICES = (0, 1, 7, 8, 33, 63)
PROOF_NAMES = ("g1_ell", "g2_r", "g1_o", "g1_ell_prime", "g2_r_prime", "g1_o_prime", "g1_h",
               "g1_z")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def _ints(p) -> tuple | None:
    """A host point as ints (None for infinity), for pickling."""
    if p.inf:
        return None
    return tuple(tuple(int(c) for c in v.c) if hasattr(v, "c") else int(v) for v in (p.x, p.y))


def _affine(pt: wst.Point) -> tuple | None:
    return _ints(bn254.g1_points_to_host(wst.point_map(lambda a: a[:, None], pt))[0])


def _no_jax() -> None:
    loaded = [m for m in sys.modules if m in ("jax", "myzkp_tpu")
              or m.startswith(("jax.", "myzkp_tpu."))]
    assert not loaded, f"a rank loaded {loaded[:5]}"


def _fields(mesh, data: dict, out: dict) -> None:
    """The NTTs, the FRI fold, the Merkle tree, dist_batch and the sumcheck
    tables over P32 (L = 2), gathered whole."""
    spec = FieldSpec.make(P32)
    for key, inverse in (("ntt", False), ("intt", True)):
        run = pm.dist_intt if inverse else pm.dist_ntt
        blk, (n1, n2) = run(spec, pm.ntt_block(_t(data[key]), mesh), mesh)
        out[key] = _np(pm.dist_ntt_to_natural(spec, blk, n1, n2, mesh))
    mesh2 = pm.make_mesh_2d(2, 2, device="cpu")
    blk, (n1, n2) = pm.dist_ntt(spec, pm.ntt_block(_t(data["ntt2d"]), mesh2, "ici", "dcn"),
                                mesh2, axis="ici", batch_axis="dcn")
    out["ntt2d"] = _np(pm.dist_ntt_to_natural(spec, blk, n1, n2, mesh2, "ici", "dcn"))

    alpha, offset, omega, alpha2 = data["fri_args"]
    f1 = pm.dist_fri_fold(spec, pm.shard(_t(data["fri"]), mesh), mesh, alpha, offset, omega)
    f2 = pm.dist_fri_fold(spec, f1, mesh, alpha2, offset * offset % P32, omega * omega % P32)
    out["fri"] = (_np(pm.gather(f1, mesh)), _np(pm.gather(f2, mesh)))

    tree = pm.dist_merkle_tree(spec, pm.shard(_t(data["merkle"]), mesh), mesh)
    out["merkle"] = (tree.root, tree.n_shards, [tree.open(i) for i in MERKLE_INDICES])

    def square(x):  # (B / D, L, n) instances -> their pointwise squares
        y = x.transpose(0, 1)
        return limb.mont_mul(spec, y, y).transpose(0, 1)

    blk = pm.dist_batch(square, mesh)(pm.shard(_t(data["batch"]), mesh, dim=0))
    out["batch"] = _np(pm.gather(blk, mesh, dim=0))

    table, r = pm.shard(_t(data["table"]), mesh), _t(data["r"])
    out["table_sum"] = _np(pm.dist_table_sum(spec, table, mesh))
    folds = []
    while table.shape[-1] * mesh.size() > 16:
        table = pm.dist_fold_into_half(spec, table, mesh, r)
        folds.append(_np(pm.gather(table, mesh)))
    out["folds"] = folds


def _msms(mesh, data: dict, out: dict) -> None:
    """dist_msm on the G1 points and scalars of the test, affine."""
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), DEV)
    for key, kw in (("msm16", {}), ("msm256", {"c": 8, "K": 8})):
        coords, scalars = data[key]
        pts = wst.point_map(lambda a: pm.shard(a, mesh), interop.point_from_numpy(coords, DEV))
        res = pm.dist_msm(F, b3, pts, pm.shard(_t(scalars), mesh), mesh, **kw)
        out[key] = _affine(res)


def _snarks(mesh, data: dict, out: dict) -> None:
    """Shifted h, the mesh Pinocchio and Groth16 proves at m = 16, their
    single-rank proves (on ranks 1 and 2 in parallel), the verifiers (rank
    3), every rank's mesh proofs, and the mesh prover's refusals."""
    spec = bn254.r_spec()
    rank = mesh.get_local_rank("shard")
    r1cs, asg = square_chain(spec, 16, device=DEV)
    qap = SparseQAP(r1cs)
    deltas = data["deltas"]
    u, v, w = (x.mont for x in r1cs.matvecs(asg))
    out["shifted_h"] = (_np(pm.dist_shifted_h_rou(spec, 16, u, v, w, *deltas, mesh)),
                        _np(pinocchio.get_shifted_h(qap, asg, *deltas).coef.mont))

    pk, vk = pinocchio.setup(qap, rng=random.Random(11))
    gpk, gvk = groth16.setup(qap, 2, rng=random.Random(3))
    pin = pinocchio.prove(asg, pk, qap, rng=random.Random(5), mesh=mesh)
    g16 = groth16.prove(asg, gpk, qap, rng=random.Random(9), mesh=mesh)
    pin_t = tuple(_ints(getattr(pin, k)) for k in PROOF_NAMES)
    g16_t = tuple(_ints(p) for p in (g16.a, g16.b, g16.c))
    extra = {}
    if rank == 1:
        one = pinocchio.prove(asg, pk, qap, rng=random.Random(5))
        extra["pin_single"] = tuple(_ints(getattr(one, k)) for k in PROOF_NAMES)
    if rank == 2:
        one = groth16.prove(asg, gpk, qap, rng=random.Random(9))
        extra["g16_single"] = tuple(_ints(p) for p in (one.a, one.b, one.c))
    if rank == 3:
        pub = [int(x) for x in asg.to_int()[:2]]
        extra["verified"] = (pinocchio.verify(pin, vk), groth16.verify(g16, gvk, pub))
    every = [None] * mesh.size()
    dist.all_gather_object(every, (pin_t, g16_t, extra), group=mesh.get_group("shard"))
    out["pin_mesh"] = [e[0] for e in every]
    out["g16_mesh"] = [e[1] for e in every]
    for e in every:
        out.update(e[2])

    refusals = []
    r1cs8, asg8 = square_chain(spec, 8, device=DEV)
    dense = QAP.from_r1cs(R1CS.from_ints(spec, [[0, 1]], [[0, 1]], [[1, 0]], device=DEV),
                          domain="rou")
    for q, a in ((SparseQAP(r1cs8), asg8), (dense, asg)):
        try:
            pinocchio.prove(a, pk, q, rng=random.Random(5), mesh=mesh)
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals


def checks(mesh, data: dict) -> dict:
    """Every check's port side on this rank; rank 0's dict is the result."""
    _no_jax()
    out = {}
    _fields(mesh, data, out)
    _msms(mesh, data, out)
    _snarks(mesh, data, out)
    _no_jax()
    return out


def fail_on_rank(mesh, bad: int) -> None:
    """Rank ``bad`` raises; the others wait for it in an all-gather."""
    if mesh.get_local_rank("shard") == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    pm.gather(torch.zeros(2, 1, dtype=torch.int32), mesh)
