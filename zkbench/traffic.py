"""The one traffic generator: a traffic file's parameters -> the jobs.

A traffic file (``traffic/<name>.json``) holds parameters only: how many
warm-up jobs set-up runs (``warmup_jobs``) and how many jobs a traced run
profiles (``trace_jobs``).  The loop is closed with one client: job k is
sent when job k - 1 has returned.  Each job is a statement of its own: the
entry draws job k's statement and randomness from ``job.rng()``, or takes
them from k, so the same seed gives the same jobs in the same order and no
two jobs of a run prove the same statement.  Warm-up jobs are numbered -1,
-2, ..., so their statements are ones no measured job proves.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Job:
    k: int
    key: str  # seeds this job's own statement and randomness

    def rng(self) -> random.Random:
        """A fresh stream of this job's randomness: the same values on every
        call, for the program and the reference alike."""
        return random.Random(self.key)


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.warmup_jobs = int(params["warmup_jobs"])
        self.trace_jobs = int(params["trace_jobs"])
        if self.warmup_jobs < 1 or self.trace_jobs < 1:
            raise ValueError("traffic needs warmup_jobs >= 1 and trace_jobs >= 1")
        self.seed = int(seed)

    def inputs_rng(self) -> random.Random:
        """The stream that set-up's inputs and secrets come from."""
        return random.Random(f"zkbench/{self.seed}/inputs")

    def job(self, k: int) -> Job:
        return Job(k, f"zkbench/{self.seed}/job/{k}")

    def warmup(self) -> list:
        return [self.job(-1 - i) for i in range(self.warmup_jobs)]
