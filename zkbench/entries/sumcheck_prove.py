"""Entry: the table sumcheck prover,
``myzkp_tpu_torch.protocols.sumcheck_tpu.SumCheckProverTPU.prove``.

Each job proves a statement of its own: a factor set drawn from the job's
randomness, each factor a multilinear polynomial of ``terms`` terms in
``num_vars`` variables, every term a distinct set of variables (each
variable in with probability 1/2) and a nonzero coefficient, as the
upstream example draws them.  A job proves the sum over the hypercube of
the product of its factors.  An answer is the claimed sum and the round
polynomials' coefficients as plain ints.
"""

from __future__ import annotations

from myzkp_tpu_torch import _ext
from myzkp_tpu_torch.curves import bn254
from myzkp_tpu_torch.ops.mpoly import MPoly
from myzkp_tpu_torch.protocols.sumcheck_tpu import SumCheckProverTPU

from ..reference import bn254 as ref_bn254
from ..reference import sumcheck as ref_sumcheck

R = ref_bn254.R


def load_library(device) -> None:
    if device.type == "cuda":
        _ext.library()


def make_inputs(config: dict, traffic) -> dict:
    return {}


def job_factors(config: dict, job) -> list:
    """The job's factor set: a list of factors, a factor a list of
    (exponent tuple, coefficient).  The same for the program and the
    reference."""
    rng, n = job.rng(), int(config["num_vars"])
    factors = []
    for _ in range(int(config["factors"])):
        masks = []
        while len(masks) < int(config["terms"]):
            mask = rng.getrandbits(n)
            if mask not in masks:
                masks.append(mask)
        factors.append([(tuple((mask >> v) & 1 for v in range(n)), rng.randrange(1, R))
                        for mask in masks])
    return factors


class Program:
    def __init__(self, config: dict, inputs: dict, device, phase):
        self.config, self.num_vars = config, int(config["num_vars"])
        self.spec = bn254.r_spec()
        self.prover = SumCheckProverTPU(self.spec, int(config["max_degree"]), device)

    def factors(self, job) -> list:
        return job_factors(self.config, job)

    def run(self, job):
        polys = [MPoly(self.spec, dict(f)) for f in self.factors(job)]
        proof = self.prover.prove(polys, self.num_vars)
        return int(proof.claimed_sum), [[int(c) for c in rp] for rp in proof.round_polys]

    def release(self) -> None:
        self.prover = None


class Reference:
    def __init__(self, config: dict, inputs: dict, device):
        self.config = config
        self.num_vars, self.max_degree = int(config["num_vars"]), int(config["max_degree"])
        self.control_bits = int(config["control"]["challenge_bits"])

    def answer(self, job, control: bool = False):
        return ref_sumcheck.prove(job_factors(self.config, job), self.num_vars,
                                  self.max_degree, R,
                                  self.control_bits if control else 256)


def compare(answers: dict, expected: dict, limits: dict) -> list:
    """Field elements of the proofs (the claimed sum and every round
    coefficient) unequal to the reference's, over every answer of the
    window; a round or coefficient missing or extra counts as unequal."""
    bad = 0
    for k, (claimed, rounds) in answers.items():
        e_claimed, e_rounds = expected[k]
        bad += claimed != e_claimed
        bad += abs(len(rounds) - len(e_rounds))
        for got, want in zip(rounds, e_rounds):
            bad += abs(len(got) - len(want)) + sum(a != b for a, b in zip(got, want))
    return [("mismatched_elements", bad, limits["mismatched_elements"])]
