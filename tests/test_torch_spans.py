"""The port's stage spans (``utils/metrics.span``) and the span table that
``profile_paths.py`` reads from them, on the CPU.

With no profiler recording, a span opens no range.  Under a CPU
``torch.profiler`` it opens ``myzkp:<name>`` ranges that nest, as a context
manager and as a decorator on functions and methods, and that are plain
host ranges, not user annotations (which kineto mirrors onto the device's
timeline).  The profiler's flag that a span reads is pinned, so that a torch
that renames it fails here.  A Groth16 prove at m = 16 and a sumcheck prove
on 6 variables enter every span of their paths, with 4 and 1 + (d + 1) v
host reads: the ``spans_entered`` fixture notes each entry in place of a
profiler, which would record every int64 op of the plain field arithmetic.
The span table is checked on synthetic events.
"""

import contextlib
import random
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import profiler as tprof

import profile_paths
from myzkp_tpu_torch.arith import sparse
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.ops.mpoly import MPoly
from myzkp_tpu_torch.protocols.sumcheck_tpu import SumCheckProverTPU
from myzkp_tpu_torch.snark import groth16
from myzkp_tpu_torch.utils import metrics
from myzkp_tpu_torch.utils.metrics import span

DEV = torch.device("cpu")  # the port's constructors default to the card
# one intra-op thread: the test processes (pytest-xdist) already share
# the cores, and spinning pool threads slow small int64 batches badly
torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]

GROTH16_SPANS = {"quotient", "ladder", "to affine", "host read"}
SUMCHECK_SPANS = {"table build", "hypercube", "round", "evaluate", "bind", "transcript",
                  "host read"}


@pytest.fixture
def spans_entered(monkeypatch) -> list:
    """The names of the spans entered while the test runs, in order: the
    spans see a profiler recording, and each range they open is only noted."""
    names = []

    def noted(label):
        names.append(label[len(metrics.PREFIX):])
        return contextlib.nullcontext()

    monkeypatch.setattr(metrics, "_profiler", SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(metrics, "_Range", noted)
    return names


def _spans(prof) -> list:
    """(name, start ns, end ns, user annotation) of the ``myzkp:`` ranges."""
    return [(ev.name()[len(metrics.PREFIX):], ev.start_ns(), ev.end_ns(),
             ev.is_user_annotation())
            for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(metrics.PREFIX)]


@span("square")
def _square(x):
    """x squared."""
    return x * x


class _Shape:
    @span("area")
    def area(self, x):
        with span("side"):
            side = _square(x)
        return side.sum()


def test_profiler_flag_pin():
    assert tprof._is_profiler_enabled is False
    with torch.profiler.profile(activities=CPU):
        assert tprof._is_profiler_enabled is True
    assert tprof._is_profiler_enabled is False
    assert metrics._Range is torch._C._profiler._RecordFunctionFast


def test_span_off_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "_Range", lambda label: opened.append(label))
    assert span("side") is span("side")  # one object a name: no allocation an entry
    assert _Shape().area(torch.arange(4)).item() == 14
    assert opened == []


def test_span_ranges_nest_under_profiler():
    assert (_square.__name__, _square.__doc__) == ("_square", "x squared.")
    with torch.profiler.profile(activities=CPU) as prof:
        with span("outer"):
            _Shape().area(torch.arange(4))
    got = _spans(prof)
    assert [n for n, *_ in sorted(got, key=lambda r: r[1])] == ["outer", "area", "side",
                                                                "square"]
    ranges = {n: (s, e) for n, s, e, _ in got}
    for inner, outer in (("area", "outer"), ("side", "area"), ("square", "side")):
        assert ranges[outer][0] <= ranges[inner][0] <= ranges[inner][1] <= ranges[outer][1]
    assert not any(user for *_, user in got)  # host ranges: no device-timeline mirror


def test_groth16_prove_spans(spans_entered):
    """At m = 16 every MSM is below the Pippenger threshold (a ladder);
    tests/test_torch_msm.py checks the Pippenger spans."""
    spec = bn254.r_spec()
    r1cs, asg = sparse.square_chain(spec, 16, 3, DEV)
    qap = sparse.SparseQAP(r1cs)
    pk, _ = groth16.setup(qap, 2, random.Random(5))
    spans_entered.clear()
    groth16.prove(asg, pk, qap, random.Random(6))
    assert set(spans_entered) == GROTH16_SPANS
    # the proof's points to the host: limbs and infinity flags of A, C, then of B
    assert spans_entered.count("host read") == 4
    assert spans_entered.count("quotient") == 1


def test_sumcheck_prove_spans(spans_entered):
    spec, v, d = bn254.r_spec(), 6, 3
    rng = random.Random(7)
    factors = [MPoly(spec, {tuple(rng.randint(0, 1) for _ in range(v)): rng.randrange(spec.p)
                            for _ in range(8)}) for _ in range(d)]
    SumCheckProverTPU(spec, d, DEV).prove(factors, v)
    assert set(spans_entered) == SUMCHECK_SPANS
    # the claimed sum, then each round's d + 1 evaluations
    assert spans_entered.count("host read") == 1 + (d + 1) * v
    assert (spans_entered.count("round"), spans_entered.count("evaluate"),
            spans_entered.count("bind")) == (v, (d + 1) * v, v)


def test_span_table_synthetic():
    # spans a [0, 100] holding b [10, 40] and c [50, 90]; launches of
    # correlations 1-4 at 5 (a), 20 (b), 60 (c) and 95 (a); correlation 9
    # has no launch call
    spans = [("a", 0.0, 100.0), ("b", 10.0, 40.0), ("c", 50.0, 90.0), ("b", 92.0, 94.0)]
    launches = [(1, 5.0), (2, 20.0), (3, 60.0), (4, 95.0)]
    device = [("k1", 10.0, 20.0, 1), ("k2", 25.0, 35.0, 2), ("k3", 60.0, 80.0, 3),
              ("k4", 96.0, 110.0, 4), ("memcpy", 30.0, 45.0, 9)]
    table, unmatched = profile_paths.span_table(device, spans, launches, (0.0, 100.0))
    # busy [10, 20] [25, 45] [60, 80] [96, 100]; gaps [0, 10] (a), [20, 25] (b),
    # [45, 60] (mid 52.5: c), [80, 96] (mid 88: c)
    want = {"a": (1, 100, 14, 10, 2), "b": (2, 32, 10, 5, 1), "c": (1, 40, 20, 31, 1)}
    assert set(table) == set(want)
    us = 1e-3
    for name, (calls, host, dev, idle, n) in want.items():
        assert table[name] == {"calls": calls, "host_ms": pytest.approx(host * us),
                               "device_ms": pytest.approx(dev * us),
                               "idle_ms": pytest.approx(idle * us), "launches": n}
    assert unmatched == pytest.approx(15 * us)
    # a launch and a gap outside every span
    table, unmatched = profile_paths.span_table(
        [("k", 10.0, 20.0, 1)], [("a", 30.0, 40.0)], [(1, 5.0)], (0.0, 40.0))
    assert table["(none)"] == {"calls": 0, "host_ms": 0.0, "device_ms": pytest.approx(10 * us),
                               "idle_ms": pytest.approx(10 * us), "launches": 1}
    assert table["a"]["idle_ms"] == pytest.approx(20 * us) and unmatched == 0
