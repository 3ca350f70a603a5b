"""Dense R1CS: three (m, d) field matrices.

Counterpart of ``myzkp_tpu/arith/r1cs.py:15-59``: row i of the system holds
when <L_i, a> <R_i, a> = <O_i, a>, and ``matvecs`` computes the three row
products as one Montgomery product (K1) per matrix, the assignment read with
a period, and a field sum over the witness axis.
"""

from __future__ import annotations

import torch

from ..fields.fp import Fp
from ..fields.spec import FieldSpec


class R1CS:
    """Constraint system: for every row i, <L_i, a> * <R_i, a> == <O_i, a>."""

    __slots__ = ("left", "right", "out")

    def __init__(self, left: Fp, right: Fp, out: Fp):
        if not left.shape == right.shape == out.shape or len(left.shape) != 2:
            raise ValueError(f"matrices of shapes {left.shape}, {right.shape}, "
                             f"{out.shape}: expected three of one (m, d)")
        self.left = left
        self.right = right
        self.out = out

    @classmethod
    def from_ints(cls, spec: FieldSpec, left, right, out, device=None) -> "R1CS":
        """From three (m, d) nested lists of ints, on the card unless
        ``device`` names another device."""
        return cls(*(Fp.from_int(spec, mat, device) for mat in (left, right, out)))

    @property
    def spec(self) -> FieldSpec:
        return self.left.spec

    @property
    def num_constraints(self) -> int:
        return self.left.shape[0]

    @property
    def witness_len(self) -> int:
        return self.left.shape[1]

    def matvecs(self, assignment: Fp):
        """(<L_i, a>, <R_i, a>, <O_i, a>) for all rows i, as (m,) Fp each."""
        return tuple((mat * assignment).sum(axis=-1)
                     for mat in (self.left, self.right, self.out))

    def is_satisfied(self, assignment: Fp) -> bool:
        ell, r, o = self.matvecs(assignment)
        return bool(torch.equal((ell * r).mont, o.mont))
