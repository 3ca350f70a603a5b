"""Mesh parallelism over ``torch.distributed``: the device mesh, a launcher,
and the distributed NTT, MSM, FRI fold, Merkle tree and sumcheck tables.

Counterpart of ``myzkp_tpu/parallel/mesh.py``.  The JAX module is
single-controller: one process holds global arrays and ``shard_map`` cuts
them up.  Here every rank is a process of its own (SPMD): each runs the same
code on its own block, and the collectives move data between ranks.

- ``make_mesh`` / ``make_mesh_2d`` give a ``DeviceMesh`` (the counterpart of
  ``jax.sharding.Mesh``); a collective on one axis runs on
  ``mesh.get_group(axis)``.
- ``run_ranks(fn, D, *args)`` spawns D ranks (or takes them from
  ``torchrun``), and each calls ``fn(mesh, *args)``.
- Block and replica rule: each ``dist_*`` takes and returns, on each rank,
  what the JAX function's ``in_specs`` / ``out_specs`` give that rank's
  device: where the spec shards an axis, the rank's block of it (the
  coordinate-th of D equal pieces); where it is ``P(None)``, the whole
  tensor, the same on every rank.  ``shard`` and ``gather`` convert between
  the two.
- Backend: gloo on the CPU; NCCL where every rank has a card of its own;
  gloo where ranks share a card (NCCL refuses two ranks on one GPU), with
  every collective staged through pinned host memory, since gloo gathers
  and exchanges host tensors only.  The kernels run on the card either
  way.  ``_all_gather``, ``_all_to_all`` and ``_broadcast`` are the only
  places that talk to the backend; they count the bytes each rank sends
  (``traffic``).

Left behind as TPU-only: ``mesh_dispatch`` and ``_mesh_platform`` (the port
dispatches by tensor device), and ``make_mesh``'s fallback to CPU devices
(the port computes on the CPU only when the caller asks for it).
"""

from __future__ import annotations

import datetime
import functools
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import _ext, native
from ..arith.sparse import shifted_h_rou
from ..curves import msm as _msm, weierstrass as wst
from ..fields import limb
from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops import ntt as _ntt
from ..protocols.sumcheck_tpu import fold_into_half, table_sum
from ..stark.fri import fold_codeword
from ..utils.merkle import DistMerkleTree, MerkleTree

# calls and bytes this rank sent to other ranks, by collective
traffic = {k: {"calls": 0, "bytes": 0} for k in ("all_gather", "all_to_all", "broadcast")}


def reset_traffic() -> None:
    for v in traffic.values():
        v["calls"] = v["bytes"] = 0


# ---------------------------------------------------------------------------
# The mesh and the launcher
# ---------------------------------------------------------------------------

def _mesh_type(device) -> str:
    """The mesh's device type: the card unless ``device`` names the CPU."""
    dev = _ext.resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build a CPU mesh")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no mesh on device type {dev.type}")
    return dev.type


def make_mesh(n_devices: int | None = None, axis: str = "shard", device=None) -> DeviceMesh:
    """A 1-D mesh over the ranks of the process group, named ``axis``, on
    the card (each rank's current CUDA device) unless ``device`` names the
    CPU.  ``n_devices``, when given, must be the world size: a rank outside
    the mesh would have nothing to run."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}")
    return init_device_mesh(_mesh_type(device), (world,), mesh_dim_names=(axis,))


def make_mesh_2d(n_dcn: int, n_ici: int, dcn_axis: str = "dcn", ici_axis: str = "ici",
                 device=None) -> DeviceMesh:
    """2-D mesh: the outer axis across hosts, the inner across a host's
    cards.  Rank = dcn * n_ici + ici, so the ranks of one host (torchrun's
    ordering) form one ici row: per-problem collectives (the NTT's
    all_to_all, the MSM's gather) ride the inner axis, and only independent
    problems (``dist_batch``, ``dist_ntt``'s ``batch_axis``) cross the outer
    one."""
    world = dist.get_world_size()
    if n_dcn * n_ici != world:
        raise ValueError(f"a {n_dcn} x {n_ici} mesh in a world of {world}")
    return init_device_mesh(_mesh_type(device), (n_dcn, n_ici),
                            mesh_dim_names=(dcn_axis, ici_axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the CPU, or its current card."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


@dataclass(frozen=True)
class _Plan:
    """Where the ranks of one host run: the backend, the device type and
    the host's card count (0 on the CPU)."""

    backend: str
    device_type: str
    cards: int
    ranks: int

    def device(self, local_rank: int) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", local_rank % self.cards)

    def describe(self) -> str:
        if self.device_type == "cpu":
            return f"mesh: {self.ranks} ranks on the CPU, backend gloo"
        if self.backend == "nccl":
            return f"mesh: {self.ranks} ranks on {self.cards} card(s), backend nccl"
        return (f"mesh: {self.ranks} ranks share {self.cards} card(s), backend gloo, "
                f"collectives staged through pinned host memory")


def _plan(device, ranks_per_host: int) -> _Plan:
    """The backend from the device count and the ranks on this host: NCCL
    when every rank has a card of its own, gloo when ranks share one (NCCL
    refuses two ranks on one card) or run on the CPU."""
    if _mesh_type(device) == "cpu":
        return _Plan("gloo", "cpu", 0, ranks_per_host)
    cards = torch.cuda.device_count()
    return _Plan("nccl" if ranks_per_host <= cards else "gloo", "cuda", cards, ranks_per_host)


def _prebuild(plan: _Plan) -> None:
    """Build the libraries the ranks load, once, before they start: the
    host SHA3 and pairing (g++) and, for the card, the kernels (nvcc)."""
    native.keccak_library()
    native.library()
    if plan.device_type == "cuda":
        _ext.library()


def _rank_body(rank: int, local_rank: int, world: int, plan: _Plan, init_method: str,
               timeout: float, fn, args, build: bool = False):
    """One rank: its card and one intra-op thread first, then the process
    group and ``fn``.  With ``build`` (torchrun, where no caller built the
    libraries), the host's first rank builds them while the others wait."""
    torch.set_num_threads(1)
    dev = plan.device(local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # NCCL binds its communicator to the rank's card (gloo has no device)
    bind = {"device_id": dev} if plan.backend == "nccl" else {}
    dist.init_process_group(plan.backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout),
                            **bind)
    try:
        if build:
            if local_rank == 0:
                _prebuild(plan)
            dist.barrier()
        return fn(make_mesh(world, device=dev.type), *args)
    finally:
        dist.destroy_process_group()


def _rank_entry(q, rank: int, world: int, plan: _Plan, init_method: str, timeout: float,
                fn, args) -> None:
    """A spawned rank: run, then report (rank, True, rank 0's result) or
    (rank, False, the traceback)."""
    try:
        out = _rank_body(rank, rank, world, plan, init_method, timeout, fn, args)
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    q.put((rank, True, out if rank == 0 else None))


def _collect(q, procs) -> object:
    """Rank 0's result once every rank reported; raises on the first
    failure report, or when a rank exits without one."""
    done = {}
    while len(done) < len(procs):
        try:
            rank, ok, payload = q.get(timeout=1.0)
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in done and p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no report")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{payload}")
        done[rank] = payload
    return done[0]


def run_ranks(fn, world_size: int, *args, device=None, timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks over a 1-D mesh
    (axis "shard") and return rank 0's result.

    The ranks compute on the card (rank r on card r mod count) unless
    ``device`` names the CPU.  The backend comes from the card count and the
    world size (``_plan``), and the choice is printed.  Under ``torchrun``
    (RANK and WORLD_SIZE set) nothing is spawned: this process is one rank,
    each host's first rank builds the kernels while the others wait, and
    rank 0 returns its result, the others None.  Otherwise the kernels are
    built here first, then ``world_size`` processes start by ``spawn`` and
    meet through a file store in a temporary directory.  An exception in any rank raises
    here, and the other ranks are stopped; a rank left waiting in a
    collective fails after ``timeout`` seconds.  ``fn`` and ``args`` are
    pickled: ``fn`` must be a module-level function, and results should be
    host values (numpy arrays, ints)."""
    if world_size < 1:
        raise ValueError(f"world size {world_size}")
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        if int(env["WORLD_SIZE"]) != world_size:
            raise ValueError(f"torchrun started {env['WORLD_SIZE']} ranks, not {world_size}")
        local = int(env.get("LOCAL_RANK", env["RANK"]))
        plan = _plan(device, int(env.get("LOCAL_WORLD_SIZE", world_size)))
        if local == 0:
            print(plan.describe(), flush=True)
        rank = int(env["RANK"])
        out = _rank_body(rank, local, world_size, plan, "env://", timeout, fn, args, build=True)
        return out if rank == 0 else None
    plan = _plan(device, world_size)
    print(plan.describe(), flush=True)
    _prebuild(plan)
    store = tempfile.mkdtemp(prefix="myzkp_mesh_")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(q, r, world_size, plan, f"file://{store}/store", timeout,
                               fn, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        return _collect(q, procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(store, ignore_errors=True)


# ---------------------------------------------------------------------------
# Collectives: the only calls into the backend
# ---------------------------------------------------------------------------

def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _staged(t: torch.Tensor, group) -> bool:
    """True for a card's tensor on a gloo group (ranks sharing a card)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(D, *x.shape): every rank's x, in the axis's order."""
    group = mesh.get_group(axis)
    D = _axis_size(mesh, axis)
    x = x.contiguous()
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(D)]
    dist.all_gather(parts, src, group=group)
    traffic["all_gather"]["calls"] += 1
    traffic["all_gather"]["bytes"] += x.nbytes * (D - 1)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def _all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, send=None,
                recv=None) -> torch.Tensor:
    """Exchange along dim 0: ``send[j]`` rows of x (in order) go to rank j
    of the axis, ``recv[j]`` rows come from it, concatenated in rank order;
    D equal pieces each way when the counts are None."""
    group = mesh.get_group(axis)
    D = _axis_size(mesh, axis)
    me = mesh.get_local_rank(axis)
    x = x.contiguous()
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    rows = x.shape[0] if recv is None else sum(recv)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=src.device)
    dist.all_to_all_single(out, src, recv, send, group=group)
    row = x[:1].nbytes
    traffic["all_to_all"]["calls"] += 1
    traffic["all_to_all"]["bytes"] += (x.nbytes * (D - 1) // D if send is None
                                       else row * (sum(send) - send[me]))
    return out.to(x.device) if staged else out


def _broadcast(x: torch.Tensor, src: int, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """x of the axis's rank ``src`` on every rank of the axis."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    staged = _staged(x, group)
    buf = _to_host(x) if staged else x.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    if mesh.get_local_rank(axis) == src:
        traffic["broadcast"]["calls"] += 1
        traffic["broadcast"]["bytes"] += x.nbytes * (_axis_size(mesh, axis) - 1)
    return buf.to(x.device) if staged else buf


def shard(x: torch.Tensor, mesh: DeviceMesh, axis: str = "shard", dim: int = -1):
    """This rank's block of the whole tensor x: the axis coordinate's piece
    of D equal pieces along ``dim`` (a view)."""
    D = _axis_size(mesh, axis)
    n = x.shape[dim]
    if n % D:
        raise ValueError(f"{n} entries along dim {dim} do not split over {D} ranks")
    return x.narrow(dim, mesh.get_local_rank(axis) * (n // D), n // D)


def gather(x_block: torch.Tensor, mesh: DeviceMesh, axis: str = "shard", dim: int = -1):
    """Inverse of ``shard``: the whole tensor, on every rank of the axis
    (one all-gather)."""
    d = dim % x_block.dim()
    parts = _all_gather(x_block, mesh, axis).movedim(0, d)
    shape = list(x_block.shape)
    shape[d] *= parts.shape[d]
    return parts.reshape(shape)


# ---------------------------------------------------------------------------
# The distributed NTT (four-step)
# ---------------------------------------------------------------------------

def _pick_n2(n: int, d: int) -> int:
    """The reference's split n = n1 * n2 with d | n2; raises where d does
    not divide n1 too (n below d^2)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    n2 = 1 << (n.bit_length() // 2)
    while n2 % d:
        n2 *= 2
    if n % n2 or (n // n2) % d:
        raise ValueError(f"{n} points do not split over {d} ranks: the four-step "
                         f"split needs n >= D^2")
    return n2


def ntt_block(a: torch.Tensor, mesh: DeviceMesh, axis: str = "shard",
              batch_axis: str | None = None) -> torch.Tensor:
    """``dist_ntt``'s input block of the whole (L, [B,] n) array: the
    rank's n2 / D columns of the (n1, n2) view (i = i1 n2 + i2), and with
    ``batch_axis`` its B / Db rows of the batch: (L, [B / Db,] n1, n2 / D)."""
    n2 = _pick_n2(a.shape[-1], _axis_size(mesh, axis))
    blk = shard(a.reshape(a.shape[:-1] + (a.shape[-1] // n2, n2)), mesh, axis, -1)
    return blk if batch_axis is None else shard(blk, mesh, batch_axis, 1)


@functools.lru_cache(maxsize=None)
def _twiddle_block(spec: FieldSpec, n: int, n1: int, cols: int, col0: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """(L, n1, cols) Montgomery table w_n^(k1 (col0 + j)): the rank's
    columns of the reference's w_n^(k1 i2).  w^(k1 j) = w^(k1 a) (w^A)^(k1 b)
    for j = a + A b from two host tables of n1 sqrt(cols) entries, times
    w^(k1 col0): two products (K1)."""
    p = spec.p
    w = _ntt._root(spec, n, inverse)
    A = 1 << -(-(cols.bit_length() - 1) // 2)
    Bc = cols // A
    dev = lambda t: torch.from_numpy(t).to(device)
    wa = dev(_ntt._outer_twiddle_np(spec, w, n1, A))
    wb = dev(_ntt._outer_twiddle_np(spec, pow(w, A, p), n1, Bc))
    w0 = dev(_ntt._mont_np(spec, [pow(w, k1 * col0, p) for k1 in range(n1)]))
    full = limb.mont_mul(spec, wa[:, :, None, :].expand(-1, -1, Bc, -1),
                         wb[:, :, :, None].expand(-1, -1, -1, A))
    return limb.mont_mul(spec, full.reshape(spec.L, n1, cols), w0[:, :, None])


def _transpose(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(L, *lead, n1, c) -> (L, *lead, n1 / D, D c) across the axis: row
    block j of every rank goes to rank j, which lays the D column blocks
    side by side in rank order.  One all_to_all."""
    D = _axis_size(mesh, axis)
    n1, c = x.shape[-2], x.shape[-1]
    parts = x.reshape(x.shape[:-2] + (D, n1 // D, c)).movedim(-3, 0)
    got = _all_to_all(parts, mesh, axis)
    return got.movedim(0, -2).reshape(x.shape[:-2] + (n1 // D, D * c))


def dist_ntt(spec: FieldSpec, a: torch.Tensor, mesh: DeviceMesh, axis: str = "shard",
             inverse: bool = False, batch_axis: str | None = None, _scale: int | None = None):
    """Natural-order NTT of an (L, [B,] n) Montgomery array over the mesh.

    ``a`` is the rank's block (L, [B / Db,] n1, n2 / D) of the (n1, n2)
    view i = i1 n2 + i2 (``ntt_block``).  Four steps: the length-n1
    transforms of the rank's columns, the twiddle w_n^(k1 i2) (K1), one
    all_to_all on ``axis`` to (.., n1 / D, n2), the length-n2 transforms
    (``ops/ntt._ntt_natural``: K5 below 2^14 points, K6 leaves above).
    Returns the rank's block (L, [B / Db,] n2, n1 / D) of the (L, [B,] n2,
    n1) output, natural[k1 + n1 k2] = out[.., k2, k1] (``dist_ntt_to_natural``
    gathers it), and (n1, n2).  With ``batch_axis`` (2-D mesh) the batch is
    sharded over that axis, and the all_to_all never crosses it.  ``_scale``
    multiplies the result by a constant on the block (``dist_intt``'s 1/n)."""
    D = _axis_size(mesh, axis)
    n1, cols = a.shape[-2], a.shape[-1]
    n = n1 * cols * D
    if _pick_n2(n, D) != cols * D:
        raise ValueError(f"block {tuple(a.shape)} is not dist_ntt's block of {n} points "
                         f"over {D} ranks (ntt_block makes it)")
    if batch_axis is not None and a.dim() < 4:
        raise ValueError("batch_axis takes an (L, B, n) input")
    x = _ntt._ntt_natural(spec, a.transpose(-1, -2).contiguous(), inverse).transpose(-1, -2)
    col0 = mesh.get_local_rank(axis) * cols
    x = limb.mont_mul(spec, x, _twiddle_block(spec, n, n1, cols, col0, inverse, a.device))
    y = _ntt._ntt_natural(spec, _transpose(x, mesh, axis), inverse)
    if _scale is not None:
        sc = limb.const(spec, spec.to_mont_int(_scale % spec.p), (1,) * (y.dim() - 1),
                        y.device)
        y = limb.mont_mul(spec, y, sc)
    return y.transpose(-1, -2).contiguous(), (n1, cols * D)


def dist_intt(spec: FieldSpec, a: torch.Tensor, mesh: DeviceMesh, axis: str = "shard",
              batch_axis: str | None = None):
    """Inverse NTT with ``dist_ntt``'s blocks and traffic: w^-1, and the
    1/n scaling on the block (the single-rank contract of ``ops/ntt.intt``)."""
    n = a.shape[-2] * a.shape[-1] * _axis_size(mesh, axis)
    return dist_ntt(spec, a, mesh, axis=axis, inverse=True, batch_axis=batch_axis,
                    _scale=pow(n, -1, spec.p))


def dist_ntt_to_natural(spec: FieldSpec, out: torch.Tensor, n1: int, n2: int,
                        mesh: DeviceMesh, axis: str = "shard",
                        batch_axis: str | None = None) -> torch.Tensor:
    """The whole natural-order (L, [B,] n) result, on every rank, from the
    rank's ``dist_ntt`` output block: one all-gather on ``axis`` (and one on
    ``batch_axis``); a row-major flatten of (n2, n1) is natural order."""
    full = gather(out, mesh, axis, -1)
    if batch_axis is not None:
        full = gather(full, mesh, batch_axis, 1)
    return full.reshape(full.shape[:-2] + (n1 * n2,))


def transform_over(mesh: DeviceMesh, axis: str = "shard"):
    """``ops/ntt.transform`` with the work split over the axis: whole
    natural-order (L, [B,] n) Fp in, the whole transform out, on every rank
    (``ntt_block``, ``dist_ntt`` or ``dist_intt``, ``dist_ntt_to_natural``)."""

    def transform(x: Fp, inverse: bool) -> Fp:
        run = dist_intt if inverse else dist_ntt
        out, (n1, n2) = run(x.spec, ntt_block(x.mont, mesh, axis), mesh, axis)
        return Fp(x.spec, dist_ntt_to_natural(x.spec, out, n1, n2, mesh, axis))

    return transform


# ---------------------------------------------------------------------------
# The distributed FRI fold and Merkle tree
# ---------------------------------------------------------------------------

def dist_fri_fold(spec: FieldSpec, cw: torch.Tensor, mesh: DeviceMesh, alpha: int,
                  offset: int, omega: int, axis: str = "shard") -> torch.Tensor:
    """One FRI fold round of a codeword sharded over the axis.

    cw: the rank's contiguous block (L, n / D) of Montgomery limbs; returns
    its block (L, n / 2D) of the folded codeword, which stays sharded for
    the next round.  Output i pairs cw[i] with cw[i + n / 2]: output block r
    takes its left half from rank r // 2 and its right half from rank
    D / 2 + r // 2, so each rank sends its two half blocks to two ranks, in
    one all_to_all (never a gather of the codeword).  Then
    ``stark/fri.fold_codeword``'s formula runs on the block with the
    block's own offset, offset * omega^(r n / 2D).  D is 1 or even."""
    D, r, p = _axis_size(mesh, axis), mesh.get_local_rank(axis), spec.p
    b = cw.shape[-1]
    if b % 2 or (D > 1 and D % 2):
        raise ValueError(f"a block of {b} points over {D} ranks: the fold needs an even "
                         f"block and 1 or an even number of ranks")
    pair = cw
    if D > 1:
        h = b // 2
        send, recv = [0] * D, [0] * D
        send[2 * (r % (D // 2))] = send[2 * (r % (D // 2)) + 1] = h
        recv[r // 2] = recv[D // 2 + r // 2] = h
        pair = _all_to_all(cw.transpose(0, 1), mesh, axis, send, recv).transpose(0, 1)
    return fold_codeword(spec, pair, alpha, offset * pow(omega, r * (b // 2), p) % p, omega)


class MeshMerkleTree(DistMerkleTree):
    """Merkle tree of a codeword sharded over a mesh axis: this rank's
    subtree over its own leaves, and the top tree over the D subtree roots
    (one all-gather), the same on every rank.  ``root`` and every ``open``
    path are the monolithic ``MerkleTree``'s; ``open`` is a collective."""

    def __init__(self, leaves: list, mesh: DeviceMesh, axis: str = "shard"):
        sub = MerkleTree(leaves)
        root = torch.frombuffer(bytearray(sub.root), dtype=torch.uint8)
        roots = _all_gather(root.to(mesh_device(mesh)), mesh, axis).cpu().numpy()
        self._join({mesh.get_local_rank(axis): sub}, [row.tobytes() for row in roots])
        self.mesh, self.axis = mesh, axis

    def open(self, index: int) -> list:
        """Auth path, leaf level first: the owner's subtree path, broadcast
        to every rank, then the top tree's path."""
        shard, local = divmod(index, self.shard_size)
        levels = self.shard_size.bit_length() - 1
        if not levels:
            return self.top.open(shard)
        width = len(next(iter(self.subtrees.values())).leaves[0])
        size = width + 32 * (levels - 1)
        mine = self.subtrees.get(shard)
        raw = b"".join(mine.open(local)) if mine is not None else bytes(size)
        buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        raw = _broadcast(buf.to(mesh_device(self.mesh)), shard, self.mesh,
                         self.axis).cpu().numpy().tobytes()
        path = [raw[:width]] + [raw[k:k + 32] for k in range(width, size, 32)]
        return path + self.top.open(shard)


def dist_merkle_tree(spec: FieldSpec, cw_std: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "shard") -> MeshMerkleTree:
    """Merkle tree of a codeword sharded over the axis: each rank hashes
    only its own leaves (``cw_std``, its (L, n / D) block of standard-domain
    limbs; 2L little-endian bytes a leaf)."""
    return MeshMerkleTree(limb.to_bytes_batch(spec, cw_std), mesh, axis)


# ---------------------------------------------------------------------------
# The distributed shifted h (Pinocchio's quotient stage)
# ---------------------------------------------------------------------------

def dist_shifted_h_rou(spec: FieldSpec, m: int, u: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, d_ell: int, d_r: int, d_o: int, mesh: DeviceMesh,
                       axis: str = "shard") -> torch.Tensor:
    """Shifted h over the root-of-unity domain (t = X^m - 1) with every
    transform split over the axis: the (m + 1) Montgomery coefficients of
    h + ell d_r + r d_ell + t d_ell d_r - d_o, (L, m + 1), on every rank.

    u, v, w: the whole (L, m) constraint evaluations, on every rank.  The
    single-rank pipeline (``arith/sparse.shifted_h_rou``: the batched INTT,
    the coset LDE at 2m, the division by t's two coset values, the coset
    interpolation, the delta shifts) with ``transform_over``'s transforms,
    each a ``dist_ntt`` / ``dist_intt`` (its all_to_all on the axis) and an
    all-gather to natural order; the elementwise stages run whole on every
    rank.  Needs m >= D^2 (the four-step split)."""
    uvw = Fp(spec, torch.stack([u, v, w], dim=1))
    if uvw.shape[-1] != m:
        raise ValueError(f"evaluations of {uvw.shape[-1]} points, not m = {m}")
    return shifted_h_rou(uvw, d_ell, d_r, d_o, transform_over(mesh, axis)).coef.mont


# ---------------------------------------------------------------------------
# The distributed MSM
# ---------------------------------------------------------------------------

def _sum_over(F, b3, parts: list, mesh: DeviceMesh, axis: str) -> list:
    """Each of this rank's partial points summed over the axis: one
    all-gather of every coordinate tensor of every part (G2 has six a
    point), then a tree sum of each part's D copies, on every rank."""
    per = len(wst.leaves(parts[0]))
    got = _all_gather(torch.stack([t for p in parts for t in wst.leaves(p)]), mesh, axis)
    return [wst.tree_sum(F, b3, wst.from_leaves(got[:, j * per + i].transpose(0, 1)
                                                for i in range(per)))
            for j in range(len(parts))]


def dist_msm(F, b3, points: wst.Point, s_limbs: torch.Tensor, mesh: DeviceMesh,
             axis: str = "shard", c: int | None = None, K: int | None = None) -> wst.Point:
    """Data-parallel MSM: sum_i [s_i] P_i over every rank's block.

    points: the rank's (n / D,) block; s_limbs its (L, n / D) standard-domain
    scalars.  Each rank runs ``msm_pippenger`` (when ``c`` or ``K`` is
    given, or from ``msm._PIPPENGER_MIN_N`` points a block) or the naive
    ladder on its block; one all-gather collects the D partial points, and
    a tree sum gives the result, an unbatched point on every rank."""
    if c is not None or K is not None or s_limbs.shape[1] >= _msm._PIPPENGER_MIN_N:
        part = _msm.msm_pippenger(F, b3, points, s_limbs, c=c, K=K)
    else:
        part = _msm.msm_naive(F, b3, points, s_limbs)
    return _sum_over(F, b3, [part], mesh, axis)[0]


def dist_msm_many(F, b3, jobs, mesh: DeviceMesh, axis: str = "shard", local=()) -> list:
    """``dist_msm`` of each (points block, scalars block) in ``jobs`` (the
    default window), and the MSM of each whole job in ``local`` on every
    rank: one ``msm_many`` call on the rank (the small blocks and the local
    jobs share one ladder) and one all-gather for all of ``jobs``.  Returns
    the results of ``jobs`` then of ``local``, on every rank."""
    jobs = list(jobs)
    parts = _msm.msm_many(F, b3, jobs + list(local))
    return _sum_over(F, b3, parts[:len(jobs)], mesh, axis) + parts[len(jobs):]


# ---------------------------------------------------------------------------
# Batch data parallelism and the sumcheck tables
# ---------------------------------------------------------------------------

def dist_batch(fn, mesh: DeviceMesh, axis: str = "shard"):
    """fn over the leading batch axis sharded over the mesh: the wrapper
    takes the rank's blocks (B / D, ...) of each argument and returns fn's
    block of the result.  Every rank already holds its instances, so no
    data moves; the arguments must be blocks of one batch."""

    def wrapped(*blocks):
        if len({b.shape[0] for b in blocks}) > 1:
            raise ValueError(f"blocks of {sorted({b.shape[0] for b in blocks})} instances")
        return fn(*blocks)

    return wrapped


def dist_fold_into_half(spec: FieldSpec, table: torch.Tensor, mesh: DeviceMesh,
                        r: torch.Tensor, axis: str = "shard") -> torch.Tensor:
    """Bind the lowest hypercube variable of a sharded table to r.

    table: the rank's contiguous block (L, n / D) of Montgomery limbs; r:
    the (L,) Montgomery scalar, the same on every rank.  Returns the block
    (L, n / 2D) of the folded table.  The low bit pairs (2k, 2k + 1), which
    never leave a block (``protocols/sumcheck_tpu.fold_into_half``'s rule),
    so no data moves."""
    if table.shape[-1] % 2:
        raise ValueError(f"a block of {table.shape[-1]} entries: the fold takes whole "
                         f"(even, odd) pairs")
    return fold_into_half(Fp(spec, table), Fp(spec, r.reshape(spec.L, 1))).mont


def dist_table_sum(spec: FieldSpec, table: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "shard") -> torch.Tensor:
    """Field sum of a sharded table, (L,), on every rank: the block's sum
    by halving, one all-gather of the D partial sums, and their sum."""
    part = table_sum(Fp(spec, table)).mont
    return Fp(spec, _all_gather(part, mesh, axis).transpose(0, 1)).sum(axis=0).mont
