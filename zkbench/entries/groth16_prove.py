"""Entry: Groth16 proofs over the square chain, by
``myzkp_tpu_torch.snark.groth16.prove``.

Set-up makes the circuit with ``arith/sparse.square_chain`` and the keys with
``groth16.setup``, from toxic waste drawn from the seed.  Each job proves a
statement of its own with its own r and s: job k's witness is the chain
started at x_j = x0^(2^j), j = k mod ``statements``, that is wires [1, x_j,
..., x_(j + m)] of one chain x_0, x_1, ... of m + ``statements`` squarings
made once at set-up, so no two jobs of a run share a witness.  The program
draws its randomness from an ``rng`` argument, so both the toxic waste and
each job's (r, s) are handed to it through ``Scripted``, which gives back
the benchmark's own values in the order the program asks.  An answer is the
proof's three points as plain ints.
"""

from __future__ import annotations

from myzkp_tpu_torch import _ext
from myzkp_tpu_torch.arith import sparse
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.fields.fp import Fp
from myzkp_tpu_torch.snark import groth16

from ..reference import bn254 as ref_bn254
from ..reference.groth16 import Groth16Reference

R = ref_bn254.R


class Scripted:
    """An ``rng`` whose ``randrange`` returns preset values in turn."""

    def __init__(self, values):
        self.values = list(values)

    def randrange(self, lo: int, hi: int) -> int:
        if not self.values:
            raise RuntimeError("the program drew more randomness than the benchmark gave")
        v = self.values.pop(0)
        if not lo <= v < hi:
            raise ValueError(f"preset value outside [{lo}, {hi})")
        return v


def load_library(device) -> None:
    if device.type == "cuda":
        _ext.library()


def make_inputs(config: dict, traffic) -> dict:
    rng = traffic.inputs_rng()
    toxic = tuple(rng.randrange(1, R) for _ in range(5))  # alpha, beta, gamma, delta, x
    return {"toxic": toxic, "x0": rng.randrange(2, R)}


def chain_shift(config: dict, job) -> int:
    """Where job k's witness starts on the chain: x_j with j = k mod
    ``statements`` (warm-up jobs, k < 0, take the chain's far end)."""
    return job.k % int(config["statements"])


def job_randomness(job) -> tuple:
    """(r, s) of a job: the same for the program and the reference."""
    rng = job.rng()
    return rng.randrange(1, R), rng.randrange(1, R)


def _g1(pt):
    return None if pt.inf else (int(pt.x.v), int(pt.y.v))


def _g2(pt):
    return None if pt.inf else (tuple(int(c.v) for c in pt.x.c),
                                tuple(int(c.v) for c in pt.y.c))


class Program:
    def __init__(self, config: dict, inputs: dict, device, phase):
        self.config, self.m = config, int(config["constraints"])
        spec, x0 = bn254.r_spec(), inputs["x0"]
        with phase("inputs"):
            r1cs, first = sparse.square_chain(spec, self.m, x0, device)
            # x_(m + 1) ... x_(m + statements - 1) after the first witness's x_m
            x, more = pow(x0, pow(2, self.m, R - 1), R), []
            for _ in range(int(config["statements"]) - 1):
                x = x * x % R
                more.append(x)
            self.one = first[:1]
            self.chain = first[1:].concat(Fp.from_int(spec, more, device))
            self.qap = sparse.SparseQAP(r1cs)
        with phase("keys"):
            self.pk, _ = groth16.setup(self.qap, int(config["num_public"]),
                                       Scripted(inputs["toxic"]))

    def witness(self, job):
        j = chain_shift(self.config, job)
        return self.one.concat(self.chain[j:j + self.m + 1])

    def run(self, job):
        proof = groth16.prove(self.witness(job), self.pk, self.qap,
                              Scripted(job_randomness(job)))
        return _g1(proof.a), _g2(proof.b), _g1(proof.c)

    def release(self) -> None:
        self.one = self.chain = self.pk = self.qap = None


class Reference:
    def __init__(self, config: dict, inputs: dict, device):
        self.config = config
        self.ref = Groth16Reference(config, inputs["toxic"], inputs["x0"], device)
        self.control_bits = int(config["control"]["scalar_bits"])

    def answer(self, job, control: bool = False):
        r, s = job_randomness(job)
        return self.ref.proof(chain_shift(self.config, job), r, s,
                              self.control_bits if control else 256)


def compare(answers: dict, expected: dict, limits: dict) -> list:
    """Points of the proofs unequal to the reference's (A, B and C each
    count one), over every answer of the window."""
    bad = sum(sum(a != b for a, b in zip(answers[k], expected[k])) for k in answers)
    return [("mismatched_points", bad, limits["mismatched_points"])]
