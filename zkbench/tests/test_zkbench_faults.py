"""A whole run on the CPU at a small size, past the look for a card, with
the timed path broken underneath: ``correct`` has to come out false for
each fault a cell can have (a step that leaves its state unchanged, half of
the batch left out, an answer altered where it is produced, a job served
from what the prover kept of an earlier job; no cell spans chips, so no
exchange can be left out), and true for the sound program.  A run that
loads JAX by its end prints no result."""

import dataclasses
import sys
import time
import types

import pytest
import torch

from zkbench import harness
from zkbench.traffic import Traffic
from zkbench.reference import bn254 as ref_bn254

CPU = torch.device("cpu")
SEED = 2**32 + 5


def _small(cell_name: str) -> harness.Cell:
    cell = harness.find_cell(cell_name)
    cfg = dict(cell.config)
    if "constraints" in cfg:
        cfg.update(constraints=16, wires=18)
    else:
        cfg["num_vars"] = 6
    # one warm-up job and one traced job keep the CPU run short
    traffic = dict(cell.traffic, warmup_jobs=1, trace_jobs=1)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _run(cell: harness.Cell, entry=None, trace=False) -> dict:
    result, lines = harness.execute(cell, SEED, 0.0, trace, CPU, time.perf_counter(),
                                    log=lambda *_: None, entry=entry)
    assert result is not None and lines
    return result


def _with_program(entry_module, run):
    """The entry module with ``Program.run`` replaced by ``run(program,
    job, original)``."""
    base = entry_module.Program

    class Broken(base):
        def run(self, job):
            return run(self, job, super().run)

    return types.SimpleNamespace(**{**vars(entry_module), "Program": Broken})


def _stale(program, job, original):
    """The answer of the job before: a step that returns its state
    unchanged."""
    fresh = original(job)
    out, program._last = getattr(program, "_last", fresh), fresh
    return out


def _g16_altered(program, job, original):
    a, b, c = original(job)
    return a, b, ref_bn254._add(ref_bn254._Fq, c, ref_bn254.G1)


def _sc_altered(program, job, original):
    claimed, rounds = original(job)
    rounds = [list(r) for r in rounds]
    rounds[-1][0] = (rounds[-1][0] + 1) % ref_bn254.R
    return claimed, rounds


@pytest.fixture(scope="module")
def g16():
    cell = _small("g16-sq22-prove")
    return cell, harness.load_entry(cell.config)


@pytest.fixture(scope="module")
def sc():
    cell = _small("sc-v24-prove")
    return cell, harness.load_entry(cell.config)


def test_sound_runs_are_correct(g16, sc):
    for cell, _ in (g16, sc):
        r = _run(cell)
        assert r["correct"] and r["attempted"] == 1 and r["failed"] == 0
        assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())
    r = _run(sc[0], trace=True)
    assert r["correct"] and "breakdown" in r and "window_s" in r["device"]


def test_answers_altered_where_produced_fail(g16, sc):
    for (cell, entry), altered in ((g16, _g16_altered), (sc, _sc_altered)):
        assert _run(cell, _with_program(entry, altered))["correct"] is False


def test_groth16_stale_proof_fails(g16):
    # each job has its own r and s, so the last job's proof is wrong for this
    # one; the sumcheck's state is its tables, whose unbound fold is below
    assert _run(g16[0], _with_program(g16[1], _stale))["correct"] is False


def _cached(name, traffic):
    """A prover that serves the job from what it kept of the job two
    before: it proves that job's statement (Groth16: its witness, with this
    job's r and s; the sumcheck: its factors), as a cache keyed by a pool
    of two statements would."""
    def run(program, job, original):
        kept = getattr(program, name)
        earlier = traffic.job(job.k - 2)
        setattr(program, name, lambda j: kept(earlier))
        try:
            return original(job)
        finally:
            setattr(program, name, kept)

    return run


def test_a_statement_served_from_an_earlier_job_fails(g16, sc):
    for (cell, entry), name in ((g16, "witness"), (sc, "factors")):
        cached = _cached(name, Traffic(cell.traffic, SEED))
        assert _run(cell, _with_program(entry, cached))["correct"] is False


def test_a_forbidden_module_loaded_after_the_window_gives_no_result(sc, tmp_path, monkeypatch):
    """A metric's reader that loads a module named jax: the run prints no
    result, though every job was correct."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "zkbench" / "metrics").mkdir(parents=True)
    (tmp_path / "zkbench" / "metrics" / "jax_probe.py").write_text(
        "import jax\n\n\ndef read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    load = harness.load_reader
    monkeypatch.setattr(harness, "load_reader", lambda name, root=harness.ROOT: load(
        name, tmp_path if name == "jax_probe" else root))
    cell, _ = sc
    probe = {"name": "jax_probe", "unit": "x", "better": "lower", "source": "host_clock"}
    cell = dataclasses.replace(cell, metrics={0: cell.metrics[0] + [probe], 1: cell.metrics[1]})
    try:
        result, lines = harness.execute(cell, SEED, 0.0, False, CPU, time.perf_counter(),
                                        log=lambda *_: None)
    finally:
        sys.modules.pop("jax", None)
    assert result is None and lines == []


def test_groth16_msms_over_half_the_points_fail(g16, monkeypatch):
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.snark import groth16

    original = groth16._msms

    def half(F, b3, jobs, shifts, mesh):
        cut = []
        for pts, sc in jobs:
            n = sc.shape[-1] // 2
            cut.append((wst.point_map(lambda a: a[:, :n], pts), sc[:, :n]))
        return original(F, b3, cut, shifts, mesh)

    monkeypatch.setattr(groth16, "_msms", half)
    assert _run(g16[0])["correct"] is False


def test_sumcheck_faults_under_the_prover_fail(sc, monkeypatch):
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.protocols import sumcheck_tpu

    fold, tsum = sumcheck_tpu.fold_into_half, sumcheck_tpu.table_sum

    def unbound(table, r):  # a challenge's fold leaves the table as it was
        if isinstance(r, int) and r > 3:
            return Fp(table.spec, table.mont[..., 0::2])
        return fold(table, r)

    monkeypatch.setattr(sumcheck_tpu, "fold_into_half", unbound)
    assert _run(sc[0])["correct"] is False
    monkeypatch.setattr(sumcheck_tpu, "fold_into_half", fold)

    def half_sum(table):  # half of the table left out, the rest counted twice
        kept = tsum(Fp(table.spec, table.mont[..., : max(1, table.shape[0] // 2)]))
        return kept + kept

    monkeypatch.setattr(sumcheck_tpu, "table_sum", half_sum)
    assert _run(sc[0])["correct"] is False
