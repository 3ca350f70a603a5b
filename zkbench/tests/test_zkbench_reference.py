"""The plain references on the CPU: their field vectors against Python
ints, each reference against the port at a small size (Groth16 at m = 2^4,
the sumcheck at 6 variables), one corrupted value failing the comparison,
and each cell's control coming out as not correct."""

import contextlib
import dataclasses
import random

import pytest
import torch

from zkbench import harness
from zkbench.reference import bn254 as ref_bn254
from zkbench.reference.fieldvec import PrimeField
from zkbench.traffic import Traffic

R, Q = ref_bn254.R, ref_bn254.Q
CPU = torch.device("cpu")


@pytest.mark.parametrize("p", [R, Q])
def test_field_vectors_match_python_ints(p):
    rng = random.Random(p % 1000)
    F = PrimeField(p, CPU)
    xs = [0, 1, p - 1, p - 2, 2**255 % p] + [rng.randrange(p) for _ in range(59)]
    ys = [p - 1, 1, p - 1, 3, 5] + [rng.randrange(p) for _ in range(59)]
    a, b = F.to_mont(F.from_ints(xs)), F.to_mont(F.from_ints(ys))
    assert F.to_ints(F.from_mont(a)) == xs
    assert F.to_ints(F.from_mont(F.mul(a, b))) == [x * y % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.sub(F.from_ints(xs), F.from_ints(ys))) == [(x - y) % p for x, y in zip(xs, ys)]
    assert F.sum_mont(a) == sum(xs) % p
    nz = [x or 7 for x in xs]
    inv = F.batch_inverse(F.to_mont(F.from_ints(nz)))
    assert F.to_ints(F.from_mont(inv)) == [pow(x, -1, p) for x in nz]
    with pytest.raises(ZeroDivisionError):
        F.batch_inverse(F.to_mont(F.from_ints([3, 0])))


def test_curves_are_bn254():
    assert ref_bn254.on_curves()
    assert ref_bn254.g1_mul(R) is None and ref_bn254.g2_mul(R) is None
    assert ref_bn254.g1_mul(R + 5) == ref_bn254.g1_mul(5)


def _small(cell_name: str) -> harness.Cell:
    cell = harness.find_cell(cell_name)
    cfg = dict(cell.config)
    if "constraints" in cfg:
        cfg.update(constraints=16, wires=18)
    else:
        cfg["num_vars"] = 6
    return dataclasses.replace(cell, config=cfg)


def _program_and_reference(cell, seed, jobs):
    entry = harness.load_entry(cell.config)
    traffic = Traffic(cell.traffic, seed)
    inputs = entry.make_inputs(cell.config, traffic)
    program = entry.Program(cell.config, inputs, CPU, lambda name: contextlib.nullcontext())
    answers = {k: program.run(traffic.job(k)) for k in range(jobs)}
    ref = entry.Reference(cell.config, inputs, CPU)
    return entry, traffic, ref, answers


def test_sumcheck_reference_agrees_with_the_port_and_catches_a_corruption():
    cell = _small("sc-v24-prove")
    entry, traffic, ref, answers = _program_and_reference(cell, 2**32 + 11, 3)
    expected = {k: ref.answer(traffic.job(k)) for k in answers}
    limits = cell.config["limits"]
    assert entry.compare(answers, expected, limits) == [("mismatched_elements", 0, 0)]
    claimed, rounds = answers[1]
    rounds = [list(r) for r in rounds]
    rounds[4][2] = (rounds[4][2] + 1) % R
    bad = {**answers, 1: (claimed, rounds)}
    assert entry.compare(bad, expected, limits) == [("mismatched_elements", 1, 0)]
    assert entry.compare({**answers, 2: (claimed + 1, answers[2][1])}, expected,
                         limits)[0][1] == 1


def test_groth16_reference_agrees_with_the_port_and_catches_a_corruption():
    cell = _small("g16-sq22-prove")
    entry, traffic, ref, answers = _program_and_reference(cell, 2**31 + 3, 3)
    expected = {k: ref.answer(traffic.job(k)) for k in answers}
    limits = cell.config["limits"]
    assert entry.compare(answers, expected, limits) == [("mismatched_points", 0, 0)]
    a, b, c = answers[0]
    moved = ref_bn254._add(ref_bn254._Fq, c, ref_bn254.G1)
    assert entry.compare({0: (a, b, moved)}, expected, limits) == [("mismatched_points", 1, 0)]


@pytest.mark.parametrize("cell_name, jobs", [("g16-sq22-prove", 8), ("sc-v24-prove", 3)])
def test_the_control_is_not_correct(cell_name, jobs):
    from zkbench import control

    cell = _small(cell_name)
    for seed in (1, 2**33 + 1, 77):
        checks = control.readings(cell, seed, jobs, CPU)
        assert any(v > lim for _, v, lim in checks), (seed, checks)
