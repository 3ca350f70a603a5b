"""The harness on the CPU: cells, configurations and metrics found by name,
a cell added as new files, the rules of BENCHMARK.json, the import
check, the traffic, and the arithmetic of the trace's reduction."""

import hashlib
import json
import re
import shutil
import statistics
from pathlib import Path

import pytest

from zkbench import devtrace, harness, importcheck
from zkbench.traffic import Traffic

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = harness.find_cell(cell)
    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == wl["config"] and c.chips == wl["chips"]
    assert (ROOT / "zkbench" / "entries" / f"{c.config['entry']}.py").exists()
    assert (ROOT / "zkbench" / "reference" / f"{c.config['reference']}.py").exists()
    assert c.metrics[0] and c.metrics[1]
    assert "setup_s" in {m["name"] for m in c.metrics[0]}
    for m in c.metrics[0] + c.metrics[1]:
        assert callable(harness.load_reader(m["name"]).read)
    Traffic(c.traffic, 1)


def test_per_layer_metrics_follow_their_workloads_key():
    got = {w["name"]: {m["name"] for m in harness.cell_metrics(BENCH, w["name"])[1]}
           for w in BENCH["workloads"]}
    assert "msm_device_ms" in got["g16-sq22-prove"]
    assert "msm_device_ms" not in got["sc-v24-prove"]
    for names in got.values():
        assert {"device_idle_share", "kernels_per_proof", "k1_device_ms",
                "elementwise_device_ms"} <= names


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "zkbench")
    z = tmp_path / "zkbench"
    (z / "configs" / "groth16-bn254-sq16.json").write_text(json.dumps(
        {**json.loads((z / "configs" / "groth16-bn254-sq22.json").read_text()),
         "name": "groth16-bn254-sq16", "constraints": 65536, "wires": 65538}))
    (z / "traffic" / "closed-warm3.json").write_text(json.dumps(
        {"warmup_jobs": 3, "trace_jobs": 4}))
    (z / "workloads" / "g16-sq16-prove.json").write_text(json.dumps(
        {"config": "groth16-bn254-sq16", "traffic": "closed-warm3"}))
    (z / "metrics" / "jobs_per_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run.jobs))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "groth16-bn254-sq16", "source": "test",
                             "file": "zkbench/configs/groth16-bn254-sq16.json",
                             "reduced": ["constraints"], "why": "test"})
    bench["workloads"].append({"name": "g16-sq16-prove", "config": "groth16-bn254-sq16",
                               "traffic": "closed-warm3", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "jobs_per_window", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "prove_s", "workloads": ["g16-sq16-prove"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("g16-sq16-prove", root=tmp_path)
    assert cell.config["constraints"] == 65536
    assert len(Traffic(cell.traffic, 5).warmup()) == 3
    assert [m["name"] for m in cell.metrics[1]][-1] == "jobs_per_window"
    reader = harness.load_reader("jobs_per_window", root=tmp_path)
    ctx = harness.Context(harness.RunRecord(jobs=[(0, 0.0, 1.0, True)] * 3))
    assert reader.read(ctx) == 3.0
    after = _digests(z)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zkbench"] and BENCH["command"][1].startswith("zkbench/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    one_line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"]) and one_line(c["source"])
        assert c["file"] == f"zkbench/configs/{c['name']}.json" and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        used.add(w["config"])
    assert used == names
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "zkbench" / "metrics" / f"{m['name']}.py").exists()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_import_check_compares_whole_top_level_names(tmp_path):
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "myzkp_tpu",
              "myzkp_tpu.fields.limb", "myzkp_tpu_torch", "myzkp_tpu_torch.fields",
              "jaxtyping", "torch"]
    assert importcheck.forbidden_loaded(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "myzkp_tpu",
         "myzkp_tpu.fields.limb"])
    assert importcheck.reference_violations(ROOT / "zkbench" / "reference") == []
    (tmp_path / "a.py").write_text("import torch\nimport myzkp_tpu_torch.fields.limb as l\n")
    (tmp_path / "b.py").write_text("from jax import numpy\nfrom . import a\n")
    (tmp_path / "c.py").write_text("import myzkp_tpu_torchx\n")
    assert importcheck.reference_violations(tmp_path) == [
        ("a.py", "myzkp_tpu_torch.fields.limb"), ("b.py", "jax")]


def test_traffic_is_the_seeds():
    params = json.loads((ROOT / "zkbench" / "traffic" / "closed-fresh.json").read_text())
    a, b = Traffic(params, 2**33 + 7), Traffic(params, 2**33 + 7)
    assert a.job(3).rng().random() == b.job(3).rng().random() == a.job(3).rng().random()
    assert a.job(3).rng().random() != a.job(4).rng().random()
    assert a.inputs_rng().random() == b.inputs_rng().random()
    assert a.inputs_rng().random() != Traffic(params, 8).inputs_rng().random()
    assert [j.k for j in a.warmup()] == [-1]
    assert not {j.key for j in a.warmup()} & {a.job(k).key for k in range(100)}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_job_proves_a_statement_of_its_own(cell):
    """No two jobs of a run, warm-up included, get the same statement, so
    no prover can serve a job from what it kept of another."""
    c = harness.find_cell(cell)
    entry, traffic = harness.load_entry(c.config), Traffic(c.traffic, 2**32 + 9)
    jobs = traffic.warmup() + [traffic.job(k) for k in range(300)]
    if "statements" in c.config:
        from zkbench.entries import groth16_prove

        keys = [groth16_prove.chain_shift(c.config, j) for j in jobs]
    else:
        keys = [repr(entry.job_factors(c.config, j)) for j in jobs]
    assert len(set(keys)) == len(jobs)


def _trace():
    host = [("zkbench:job", 0.0, 100.0), ("zkbench:msm", 10.0, 60.0),
            ("zkbench:scan", 20.0, 30.0), ("zkbench:job", 100.0, 200.0),
            ("zkbench:ladder", 150.0, 190.0)]
    device = [("void (anonymous namespace)::bucket_scan_kernel<myzkp::Fe2>(int const*)", 20.0, 30.0),
              ("void at::native::vectorized_elementwise_kernel<4>()", 25.0, 40.0),
              ("(anonymous namespace)::mont_mul_kernel(int const*)", 50.0, 55.0),
              ("Memcpy DtoH (Device -> Pinned)", 195.0, 199.0),
              ("mont_pow_wide_kernel(int const*)", 120.0, 150.0),
              ("early_kernel", -10.0, 5.0)]
    return devtrace.summarize(device, host)


def test_trace_reduction_arithmetic():
    t = _trace()
    assert t.jobs == 2 and t.window_us == 200.0
    # union: [0, 5], [20, 40], [50, 55], [120, 150], [195, 199]
    assert t.busy_us == 5 + 20 + 5 + 30 + 4
    assert t.kernels["early_kernel"] == [1, 5.0]
    assert "Memcpy DtoH (Device -> Pinned)" in t.copies
    # gaps (5, 20) in msm, (40, 50) in msm, (55, 120) mid 87.5 in job,
    # (150, 195) mid 172.5 in ladder, (199, 200) in job
    assert t.idle_by_host == {"msm": 15.0 + 10.0, "job": 65.0 + 1.0, "ladder": 45.0}
    assert t.match((r"\bmont_(mul|pow)\w*_kernel\b",)) == (2, 35.0)
    assert t.match((r"\bmul_kernel\b",)) == (0, 0.0)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["mont_pow_wide_kernel(int const*)", 30.0 / 1e6]
    assert bd["idle_gaps"][0] == ["job", 66.0 / 1e6]


def test_per_layer_readers_on_a_trace():
    ctx = harness.Context(harness.RunRecord(), _trace())
    read = lambda name: harness.load_reader(name).read(ctx)
    assert read("device_idle_share") == pytest.approx(1 - 64.0 / 200.0)
    assert read("kernels_per_proof") == 5 / 2
    assert read("k1_device_ms") == pytest.approx(35.0 / 1e3 / 2)
    assert read("msm_device_ms") == pytest.approx(10.0 / 1e3 / 2)
    assert read("elementwise_device_ms") == pytest.approx(15.0 / 1e3 / 2)
    empty = harness.Context(harness.RunRecord(),
                            devtrace.summarize([("Memcpy HtoD", 1.0, 2.0)],
                                               [("zkbench:job", 0.0, 10.0)]))
    for name in ("kernels_per_proof", "k1_device_ms", "msm_device_ms", "elementwise_device_ms"):
        assert harness.load_reader(name).read(empty) is None
    assert harness.load_reader("device_idle_share").read(harness.Context(harness.RunRecord())) is None


def test_end_to_end_readers():
    rec = harness.RunRecord(setup_s=12.5, window_peak_bytes=3 * 2**30,
                            jobs=[(0, 10.0, 11.5, True), (1, 11.5, 12.5, True),
                                  (2, 12.5, 14.0, True)])
    ctx = harness.Context(rec)
    assert harness.load_reader("prove_s").read(ctx) == pytest.approx(4.0 / 3)
    assert harness.load_reader("prove_peak_gib").read(ctx) == 3.0
    assert harness.load_reader("setup_s").read(ctx) == 12.5
    rec.jobs[1] = (1, 11.5, 12.5, False)
    assert harness.load_reader("prove_s").read(ctx) == pytest.approx(4.0 / 2)
    assert harness.load_reader("prove_s").read(harness.Context(harness.RunRecord())) is None


def test_spread_reads_correct_runs_only(tmp_path):
    from zkbench import spread

    for i, (v, ok) in enumerate([(1.0, True), (1.1, True), (1.2, True), (1.3, True),
                                 (1.4, True), (1.5, True), (9.0, False)]):
        result = {"correct": ok, "metrics": {"prove_s": {"value": v, "unit": "s"}}}
        (tmp_path / f"{i}.out").write_text(
            f"# zkbench g16-sq22-prove seed {i} seconds 20.0 trace 0\n# card x\n"
            + json.dumps(result) + "\n")
    values = spread.table(sorted(tmp_path.glob("*.out")))["g16-sq22-prove"]["prove_s"]
    assert sorted(values) == [1.0, 1.1, 1.2, 1.3, 1.4, 1.5]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread.spread(values) == pytest.approx((1.425 - 1.075) / 1.25) == (q3 - q1) / 1.25
