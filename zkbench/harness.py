"""Run one cell of the benchmark once: set-up, the measured window, the
check against the plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json`` and ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, the
entry module that the configuration names in ``entries/<entry>.py`` (which
alone touches the program under test), and each metric's reader in
``metrics/<metric>.py``.  A later cell, configuration, traffic or metric is
new files, with no edit here.

An entry module provides:
  load_library(device)                   the program's kernels, built or loaded
  make_inputs(config, traffic) -> dict   set-up's inputs and secrets
  Program(config, inputs, device, phase)
      .run(job) -> answer                one job through the program
      .release()                         free the program's state
  Reference(config, inputs, device)
      .answer(job, control=False)        the plain reference's answer
  compare(answers, expected, limits) -> [(name, value, limit)]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from . import devtrace, importcheck
from .traffic import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: dict  # trace (0 / 1) -> [metric entries of BENCHMARK.json]


@dataclass
class RunRecord:
    setup_s: float = 0.0
    phases: dict = field(default_factory=dict)
    jobs: list = field(default_factory=list)  # (k, start, end, ok)
    setup_peak_bytes: int = 0
    window_peak_bytes: int = 0


@dataclass
class Context:
    """What a metric's reader reads: the run's record and, in a traced run,
    the trace's summary (``devtrace.TraceSummary``)."""
    run: RunRecord
    trace: object = None


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_metrics(bench: dict, cell: str) -> dict:
    """The end-to-end metrics this cell reports (trace 0) and its per-layer
    ones (trace 1), by the rules of ``BENCHMARK.json``'s ``workloads``
    keys."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]
    return {0: e2e, 1: layer}


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = root / "zkbench"
    wl = load_json(here / "workloads" / f"{name}.json")
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json and BENCHMARK.json name other "
                         f"configurations or traffic")
    config = load_json(here / "configs" / f"{wl['config']}.json")
    traffic = load_json(here / "traffic" / f"{wl['traffic']}.json")
    return Cell(name, int(entry["chips"]), config, traffic, cell_metrics(bench, name))


def load_entry(config: dict):
    return importlib.import_module(f"{__package__}.entries.{config['entry']}")


def load_reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py as a module; its ``read(ctx)`` gives the value
    or None."""
    path = root / "zkbench" / "metrics" / f"{metric}.py"
    name = "zkbench_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def phase(record: RunRecord, name: str, log):
    t = time.perf_counter()
    yield
    record.phases[name] = time.perf_counter() - t
    log(f"# setup {name} {record.phases[name]} s")


def _card_line(log) -> None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        log(f"# card {out.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as exc:
        log(f"# card: nvidia-smi gave nothing ({exc})")


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            log=print, entry=None) -> tuple:
    """One run.  Returns (result dict or None, check lines); None when a
    forbidden module was loaded.  ``entry`` replaces the configuration's
    entry module (tests)."""
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rec = RunRecord()
    with phase(rec, "import", log):
        entry = entry or load_entry(cell.config)
    with phase(rec, "library", log):
        entry.load_library(device)
    traffic = Traffic(cell.traffic, seed)
    inputs = entry.make_inputs(cell.config, traffic)
    program = entry.Program(cell.config, inputs, device, lambda name: phase(rec, name, log))
    with phase(rec, "warm-up", log):
        for job in traffic.warmup():
            program.run(job)
        sync()
    rec.setup_s = time.perf_counter() - t0
    log(f"# setup total {rec.setup_s} s")
    bad = importcheck.forbidden_loaded()
    if bad:
        print(f"zkbench: forbidden modules loaded after set-up: {bad}", file=sys.stderr)
        return None, []
    if cuda:
        rec.setup_peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    collector = (devtrace.Collector(traffic.trace_jobs, devtrace.load_stages(HERE / "stages.json"))
                 if trace else None)

    answers, failed, k = {}, 0, 0
    start = time.perf_counter()
    while k == 0 or time.perf_counter() - start < seconds:
        job = traffic.job(k)
        # the profiler starts and stops outside a job's time
        with collector.job(k) if collector else contextlib.nullcontext():
            t_a = time.perf_counter()
            try:
                answers[k] = program.run(job)
                sync()
                ok = True
            except Exception:  # a job that fails is counted, and the loop goes on
                traceback.print_exc()
                failed, ok = failed + 1, False
            rec.jobs.append((k, t_a, time.perf_counter(), ok))
        k += 1
    if collector:
        collector.close()
    if cuda:
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(device)
    log(f"# jobs {len(rec.jobs)}: " + json.dumps([[j[0], j[2] - j[1]] for j in rec.jobs]))

    ctx = Context(rec, collector.summary if collector else None)
    metrics = {}
    for m in cell.metrics[int(trace)]:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    program.release()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.Reference(cell.config, inputs, device)
    expected = {k_: ref.answer(traffic.job(k_)) for k_ in answers}
    checks = entry.compare(answers, expected, cell.config["limits"])
    violations = importcheck.reference_violations(HERE / "reference")
    if violations:
        print(f"zkbench: the reference imports the program or JAX: {violations}",
              file=sys.stderr)
        return None, []
    log(f"# reference {time.perf_counter() - t_ref} s over {len(expected)} answers")

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips,
           "memory_peak_bytes": max(rec.setup_peak_bytes, rec.window_peak_bytes)}
    result = {"correct": failed == 0 and bool(answers) and all(v <= lim for _, v, lim in checks),
              "attempted": len(rec.jobs), "failed": failed, "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_us / 1e6
        dev["window_s"] = ctx.trace.window_us / 1e6
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    lines = [f"check {name} {v} limit {lim}" for name, v, lim in checks]
    # last, once the metrics' readers, the reference and the comparison have
    # run: whatever any of them loaded is in sys.modules by now
    bad = importcheck.forbidden_loaded()
    if bad:
        print(f"zkbench: forbidden modules loaded by the end of the run: {bad}",
              file=sys.stderr)
        return None, []
    return result, lines


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"zkbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    print(f"# zkbench {args.workload} seed {args.seed} seconds {args.seconds} "
          f"trace {args.trace}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _card_line(print)
    result, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), t0)
    if result is None:
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
