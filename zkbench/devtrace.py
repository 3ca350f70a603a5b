"""The traced run: torch.profiler over a few whole jobs, reduced in memory.

Collection: ``Collector`` profiles CPU and CUDA activity over the jobs it is
told about, with ``record_function`` ranges named ``zkbench:<name>`` around
each job and around the program's stage functions (``stages.json``, wrapped
by name for the traced jobs only).  Nothing is written to disk.

Reduction (``summarize``, plain data in and out, so it is tested without a
card): device events are (name, start_us, end_us); host ranges are
(name, start_us, end_us) and nest.  The traced window runs from the first
job range's start to the last one's end.  Busy time is the union of the
device events inside it, so overlapping events count once; the idle gaps
between them are put on the innermost host range that holds each gap's
midpoint.  Kernels are the device events that are not copies or memsets.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
import sys
import warnings
from dataclasses import dataclass, field
from pathlib import Path

PREFIX = "zkbench:"
JOB = PREFIX + "job"
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class TraceSummary:
    jobs: int
    window_us: float
    busy_us: float
    kernels: dict = field(default_factory=dict)  # name -> [count, us]
    copies: dict = field(default_factory=dict)   # name -> [count, us]
    idle_by_host: dict = field(default_factory=dict)  # host range -> us

    def match(self, patterns) -> tuple:
        """(launches, device us) of the kernels whose name matches any of
        the regular expressions ``patterns`` (``re.search``)."""
        rx = [re.compile(p) for p in patterns]
        n, us = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if any(r.search(name) for r in rx):
                n += c
                us += t
        return n, us

    def breakdown(self, top: int = 10) -> dict:
        ops = {**self.copies, **self.kernels}
        dev = sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], t / 1e6] for name, (_, t) in dev],
                "idle_gaps": [[name, t / 1e6] for name, t in gaps]}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(device_events, host_ranges) -> TraceSummary:
    jobs = [(s, e) for n, s, e in host_ranges if n == JOB]
    if not jobs:
        return TraceSummary(0, 0.0, 0.0)
    w0, w1 = min(s for s, _ in jobs), max(e for _, e in jobs)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    copies = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for name, s, e in device_events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        bucket = copies if name.startswith(NOT_KERNELS) else kernels
        bucket[name][0] += 1
        bucket[name][1] += e - s
    busy = _union(spans)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return TraceSummary(len(jobs), w1 - w0, sum(e - s for s, e in busy),
                        dict(kernels), dict(copies), _attribute(gaps, host_ranges))


def _attribute(gaps, host_ranges) -> dict:
    """{innermost host range at each gap's midpoint: idle us}."""
    ranges = sorted(((s, e, n[len(PREFIX):] if n.startswith(PREFIX) else n)
                     for n, s, e in host_ranges), key=lambda r: (r[0], -r[1]))
    out = collections.defaultdict(float)
    stack, i = [], 0
    for s, e in sorted(gaps):
        mid = (s + e) / 2
        while i < len(ranges) and ranges[i][0] <= mid:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "(outside the jobs)"] += e - s
    return dict(out)


# ---------------------------------------------------------------------------
# Collection (on the card)
# ---------------------------------------------------------------------------

def load_stages(path: Path) -> list:
    return [tuple(s) for s in json.loads(Path(path).read_text())["stages"]]


@contextlib.contextmanager
def stage_ranges(stages):
    """Wrap each stage function of a module already loaded in a
    ``zkbench:<stage>`` range while the block runs; the originals come back
    after it.  Modules the run has not loaded are left alone."""
    import torch

    saved = []
    try:
        for stage, module, attr in stages:
            owner = sys.modules.get(module)
            if owner is None:
                continue
            *path, name = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            fn = owner.__dict__[name]

            def wrapped(*a, _fn=fn, _label=PREFIX + stage, **k):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            saved.append((owner, name, fn))
            setattr(owner, name, wrapped)
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def events_of(prof) -> tuple:
    """(device events, host ranges) of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                host.append((name, start, end))
        elif ev.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            device.append((name, start, end))
    return device, host


class Collector:
    """Profiles jobs 0 .. n - 1 of the window; ``summary`` after the last."""

    def __init__(self, n_jobs: int, stages):
        self.n_jobs = n_jobs
        self.stages = stages
        self.summary = None
        self._prof = None
        self._ranges = None

    @contextlib.contextmanager
    def job(self, k: int):
        """Around job k: the profiler starts before job 0 and stops after
        job n - 1; each traced job runs in a ``zkbench:job`` range."""
        import torch

        if k == 0:
            self._ranges = stage_ranges(self.stages)
            self._ranges.__enter__()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with warnings.catch_warnings():  # one cycle, whose events are read once
                warnings.filterwarnings("ignore", message=".*Profiler clears events")
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
        if self._prof is None:
            yield
            return
        with torch.profiler.record_function(JOB):
            yield
        if k == self.n_jobs - 1:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            prof.__exit__(None, None, None)
        self._ranges.__exit__(None, None, None)
        self.summary = summarize(*events_of(prof))
