"""Port parity: serialize, checkpoint and the two module entry points.

Keys written by ``myzkp_tpu.utils.serialize`` load in the port's
``utils/serialize`` (and through ``interop.load_key``) with the same limbs,
and keys written by the port load in the JAX package with the same limbs and
host points; ``utils/checkpoint.msm_resumable`` stopped after two of three
chunks resumes to the host's sum and removes its file (tests/test_curves.py's
crash-and-resume test); and
``snark.cli`` / ``protocols.sumcheck_cli`` run to exit 0 on the CPU at tiny
sizes, ``snark.cli --mesh 2`` over two gloo ranks (spawned, and under
torchrun), while ``--g2 naive`` is refused.  On the CPU the port
runs its kernels' plain versions.
"""

import dataclasses
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from myzkp_tpu.curves import bn254 as jbn
from myzkp_tpu.utils import serialize as jser
from myzkp_tpu_torch import interop
from myzkp_tpu_torch.arith import sparse as tsparse
from myzkp_tpu_torch.commit import kzg as tkzg
from myzkp_tpu_torch.curves import bn254, msm
from myzkp_tpu_torch.curves import weierstrass as tw
from myzkp_tpu_torch.protocols import sumcheck_cli
from myzkp_tpu_torch.snark import cli as snark_cli
from myzkp_tpu_torch.snark import groth16 as tg16
from myzkp_tpu_torch.snark import pinocchio as tpin
from myzkp_tpu_torch.utils import checkpoint as ckpt
from myzkp_tpu_torch.utils import serialize

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
R = bn254.R


def _jax_arrays(pt) -> list:
    """A JAX point batch's coordinate arrays, in the port's leaf order."""
    leaves = [pt.x, pt.y, pt.z]
    if isinstance(pt.x, tuple):
        leaves = [c for coord in leaves for c in coord]
    return [np.asarray(a) for a in leaves]


def _same_point(got: tw.Point, want) -> None:
    for a, b in zip(interop.point_to_numpy(got), _jax_arrays(want), strict=True):
        np.testing.assert_array_equal(a, b)


def _host_ints(p):
    if p.inf:
        return None
    if hasattr(p.x, "c"):
        return tuple(tuple(c.v for c in e.c) for e in (p.x, p.y))
    return int(p.x), int(p.y)


def test_keys_written_by_the_jax_package_load_in_the_port(tmp_path):
    rng = random.Random(3)
    g1 = [jbn.g1_generator() * rng.randrange(1, R) for _ in range(5)] + [
        jbn.curve_g1.infinity()]
    g2 = [jbn.g2_generator() * rng.randrange(1, R) for _ in range(3)]
    jg1, jg2 = jbn.g1_points_to_device(g1), jbn.g2_points_to_device(g2)
    path = str(tmp_path / "pts.npz")
    jser.save_point_batches(path, g1_a=jg1, g2_b=jg2, num_public=np.asarray(2))
    got = serialize.load_point_batches(path, DEV)
    assert sorted(got) == ["g1_a", "g2_b", "num_public"] and int(got["num_public"]) == 2
    _same_point(got["g1_a"], jg1)
    _same_point(got["g2_b"], jg2)
    assert [_host_ints(p) for p in bn254.g1_points_to_host(got["g1_a"])] == \
        [_host_ints(p) for p in g1]
    # a Groth16 proving key of the JAX layout, read by interop.load_key
    fields = {f.name: jg1 for f in dataclasses.fields(tg16.Groth16ProvingKey)}
    fields.update(g2_beta=jg2, g2_delta=jg2, g2_xj=jg2, num_public=2)
    jser.save_point_batches(path, **fields)
    pk = interop.load_key(path, tg16.Groth16ProvingKey, DEV)
    assert pk.num_public == 2
    _same_point(pk.g1_ht, jg1)
    _same_point(pk.g2_xj, jg2)


def test_keys_written_by_the_port_load_in_the_jax_package(tmp_path):
    r1cs, _ = tsparse.square_chain(bn254.r_spec(), 4, device=DEV)
    pk, vk = tpin.setup(tsparse.SparseQAP(r1cs), random.Random(4))
    serialize.save_pinocchio_pk(str(tmp_path / "pk.npz"), pk)
    serialize.save_pinocchio_vk(str(tmp_path / "vk.json"), vk)
    jpk = jser.load_pinocchio_pk(str(tmp_path / "pk.npz"))
    for f in dataclasses.fields(pk):
        _same_point(getattr(pk, f.name), getattr(jpk, f.name))
    jvk = jser.load_pinocchio_vk(str(tmp_path / "vk.json"))
    assert {k: _host_ints(v) for k, v in vars(jvk).items()} == \
        {k: _host_ints(v) for k, v in vars(vk).items()}
    # and back: the JAX package's own writes load in the port unchanged
    jser.save_pinocchio_pk(str(tmp_path / "pk2.npz"), jpk)
    jser.save_pinocchio_vk(str(tmp_path / "vk2.json"), jvk)
    back = serialize.load_pinocchio_pk(str(tmp_path / "pk2.npz"), DEV)
    for f in dataclasses.fields(pk):
        for a, b in zip(tw.leaves(getattr(back, f.name)), tw.leaves(getattr(pk, f.name))):
            assert torch.equal(a, b)
    assert serialize.load_pinocchio_vk(str(tmp_path / "vk2.json")) == vk
    # a KZG key
    srs = tkzg.setup(3, s=12345, device=DEV)
    serialize.save_kzg_pk(str(tmp_path / "srs.npz"), srs)
    jsrs = jser.load_kzg_pk(str(tmp_path / "srs.npz"))
    _same_point(srs.powers1, jsrs.powers1)
    _same_point(srs.powers2, jsrs.powers2)
    own = serialize.load_kzg_pk(str(tmp_path / "srs.npz"), DEV)
    for a, b in zip(tw.leaves(own.powers2), tw.leaves(srs.powers2)):
        assert torch.equal(a, b)


def test_msm_resumable_checkpoint(tmp_path):
    """Chunked MSM with a simulated crash after two chunks, then resumed."""
    rng = random.Random(1)
    n = 37
    ks = [rng.randrange(1, R) for _ in range(n)]
    pts = [bn254.g1_generator() * rng.randrange(1, R) for _ in range(n)]
    want = bn254.curve_g1.infinity()
    for k, p in zip(ks, pts):
        want = want + p * k
    dev_pts = bn254.g1_points_to_device(pts, DEV)
    sl = msm.scalars_from_int(bn254.r_spec(), ks, DEV)
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), DEV)
    path = str(tmp_path / "msm.npz")

    class _Stop(Exception):
        pass

    orig, calls = ckpt._save_state, []

    def hooked(p, i, a):
        orig(p, i, a)
        calls.append(i)
        if len(calls) == 2:
            raise _Stop

    ckpt._save_state = hooked
    try:
        with pytest.raises(_Stop):
            ckpt.msm_resumable(F, b3, dev_pts, sl, path, chunk=16)
    finally:
        ckpt._save_state = orig
    assert calls == [1, 2] and (tmp_path / "msm.npz").exists()
    got = ckpt.msm_resumable(F, b3, dev_pts, sl, path, chunk=16)
    assert bn254.g1_points_to_host(tw.point_map(lambda a: a[:, None], got))[0] == want
    assert not (tmp_path / "msm.npz").exists()


def test_snark_cli(capsys):
    assert snark_cli.main(["1", "--g2", "pippenger", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("m=2^1: circuit ")
    # the mesh prover over two spawned ranks (m = 4 >= D^2): the backend and
    # the mesh's shape are printed, and the proof verifies on every rank
    assert snark_cli.main(["2", "--mesh", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 2 ranks on the CPU, backend gloo" in out
    assert "m=2^2 (mesh=(2,)): circuit " in out
    with pytest.raises(SystemExit) as exc:
        snark_cli.main(["--g2", "naive", "1", "--device", "cpu"])
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err


def test_snark_cli_under_torchrun():
    """Under torchrun (RANK and WORLD_SIZE set) the mesh prover spawns
    nothing: the two ranks come from the launcher, the host's first rank
    builds the libraries while the other waits, and only rank 0 prints."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "myzkp_tpu_torch.snark.cli", "2", "--mesh", "2", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("mesh: 2 ranks on the CPU, backend gloo") == 1
    results = [ln for ln in out.stdout.splitlines() if ln.startswith("m=")]
    assert len(results) == 1 and results[0].startswith("m=2^2 (mesh=(2,)): circuit ")


def test_sumcheck_cli(capsys, monkeypatch):
    monkeypatch.setenv("SUMCHECK_VARS", "3")
    for args in ([], ["--host"]):
        assert sumcheck_cli.main(args + ["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "vars=3" in out and "verified=True" in out
