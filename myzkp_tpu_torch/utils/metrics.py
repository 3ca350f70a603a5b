"""Per-stage wall-clock metrics and a torch.profiler trace.

Counterpart of ``myzkp_tpu/utils/metrics.py``: a ``StageMetrics`` registry
whose ``stage`` span synchronizes the card on the tensors it is given before
it closes, so that a span measures the device's work and not its launch;
``trace`` records the enclosed block with ``torch.profiler`` (host and CUDA
activities) and writes a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StageMetrics:
    """Accumulated wall-clock seconds and hit counts per named stage."""

    seconds: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def record(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()

    def report(self) -> str:
        width = max((len(k) for k in self.seconds), default=0)
        return "\n".join(
            f"{k:<{width}}  {self.seconds[k] * 1e3:10.2f} ms  x{self.counts[k]}"
            for k in sorted(self.seconds, key=self.seconds.get, reverse=True))

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors: torch.Tensor):
        """Time a stage; before the span closes, the device of each CUDA
        tensor given is synchronized (CPU tensors need nothing)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {t.device for t in sync_tensors if t.is_cuda}:
                torch.cuda.synchronize(dev)
            self.record(name, time.perf_counter() - t0)


METRICS = StageMetrics()


def reset_metrics() -> None:
    METRICS.reset()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the enclosed block (CPU activity, and CUDA where
    the card is present); its Chrome trace is written to
    ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
