"""The cell mesh-g16-sq25-4chip through the benchmark's harness on the CPU
at m = 2^6 over 2 gloo ranks, in a process of its own: a rank pool's rank 0
holds its process's one process group, and a run checks its own process's
modules for JAX.

    python tests/_torch_pool_cell.py [--bad-rank R]

Prints one JSON line last: the run's result, and each job's answer (the two
warm-up jobs' too) beside the plain reference's.  With ``--bad-rank``, rank
R's key block is made again from other toxic waste than the run's, after
the entry's set-up and before its warm-up.
"""

import argparse
import dataclasses
import json
import os
import random
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from myzkp_tpu_torch.snark import groth16  # noqa: E402
from zkbench import harness  # noqa: E402
from zkbench.entries.groth16_prove import Scripted  # noqa: E402
from zkbench.reference import bn254 as ref_bn254  # noqa: E402
from zkbench.traffic import Traffic  # noqa: E402

CELL = "mesh-g16-sq25-4chip"
SEED = 2**32 + 7
CPU = torch.device("cpu")


def small_cell() -> harness.Cell:
    """The cell at m = 2^6 over 2 ranks, two warm-up jobs and one in the
    window."""
    cell = harness.find_cell(CELL)
    cfg = dict(cell.config, constraints=64, wires=66, ranks=2, statements=8)
    return dataclasses.replace(cell, config=cfg, traffic=dict(cell.traffic, warmup_jobs=2))


def rekey(mesh, state, bad: int, num_public: int, toxic: tuple) -> None:
    """A rank-pool job: rank ``bad`` makes its key block again from
    ``toxic``."""
    if mesh.get_local_rank("shard") == bad:
        state["pk"], _ = groth16.setup(state["qap"], num_public, Scripted(toxic), mesh=mesh)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bad-rank", type=int, default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    cell = small_cell()
    entry = harness.load_entry(cell.config)
    answers = {}

    class Recorded(entry.Program):
        def __init__(self, config, inputs, device, phase):
            super().__init__(config, inputs, device, phase)
            if args.bad_rank is not None:
                other = random.Random(SEED + 1)
                toxic = tuple(other.randrange(1, ref_bn254.R) for _ in range(5))
                self.pool.run(rekey, args.bad_rank, int(config["num_public"]), toxic)

        def run(self, job):
            answers[job.k] = super().run(job)
            return answers[job.k]

    program = types.SimpleNamespace(**{**vars(entry), "Program": Recorded})
    result, _ = harness.execute(cell, SEED, 0.0, False, CPU, time.perf_counter(),
                                log=lambda *_: None, entry=program)
    traffic = Traffic(cell.traffic, SEED)
    ref = entry.Reference(cell.config, entry.make_inputs(cell.config, traffic), CPU)
    print(json.dumps({"result": result,
                      "answers": [[k, answers[k], ref.answer(traffic.job(k))]
                                  for k in sorted(answers)]}))


if __name__ == "__main__":
    main()
