"""Rescue-Prime hash over M128 and its AIR (trace, transition and boundary
constraints).

Counterpart of ``myzkp_tpu/stark/rescueprime.py`` (the reference's
``rescueprime.rs``): the parameter set m = 2, rate = 1, capacity = 1,
N = 27, alpha = 3 (``rescue_constants``); ``hash`` and ``trace`` on host
ints (27 sequential rounds on a two-element state); ``hash_batch`` the same
permutation over a batch of inputs on the inputs' device, its S-boxes x^3 and
x^(alpha^-1) one launch each of K1's chain at M128 (``Fp.__pow__``); the AIR:
the round constants interpolated over omicron^r and lifted to MPolys in the
cycle variable, the transition constraints MDS(prev^a) + C1(x) =
(MDS^-1 (next - C2(x)))^a and the boundary [(0, 1, 0), (N, 0, output)].
"""

from __future__ import annotations

from ..fields.fp import Fp
from ..fields.spec import FieldSpec
from ..ops.mpoly import MPoly
from . import rescue_constants as C
from .fri import _host_interpolate


class RescuePrime:
    def __init__(self):
        self.p = C.P
        self.m = C.M
        self.rate = C.RATE
        self.capacity = C.CAPACITY
        self.n = C.N_ROUNDS
        self.alpha = C.ALPHA
        self.alpha_inv = C.ALPHA_INV
        self.mds = C.MDS
        self.mds_inv = C.MDS_INV
        self.round_constants = C.ROUND_CONSTANTS
        self.spec = FieldSpec.make(self.p)

    # -- permutation (host ints) ---------------------------------------------
    def _round(self, state: list, r: int) -> list:
        p, m = self.p, self.m
        # forward half-round
        state = [pow(s, self.alpha, p) for s in state]
        state = [sum(self.mds[i][j] * state[j] for j in range(m)) % p for i in range(m)]
        state = [(state[i] + self.round_constants[2 * r * m + i]) % p for i in range(m)]
        # backward half-round
        state = [pow(s, self.alpha_inv, p) for s in state]
        state = [sum(self.mds[i][j] * state[j] for j in range(m)) % p for i in range(m)]
        state = [(state[i] + self.round_constants[2 * r * m + m + i]) % p
                 for i in range(m)]
        return state

    def hash(self, input_element: int) -> int:
        state = [input_element % self.p] + [0] * (self.m - 1)
        for r in range(self.n):
            state = self._round(state, r)
        return state[0]

    def trace(self, input_element: int) -> list:
        """All N + 1 states."""
        state = [input_element % self.p] + [0] * (self.m - 1)
        out = [list(state)]
        for r in range(self.n):
            state = self._round(state, r)
            out.append(list(state))
        return out

    # -- batched device permutation ------------------------------------------
    def hash_batch(self, inputs: Fp) -> Fp:
        """The permutation over a batch of inputs, on their device."""
        spec, dev = self.spec, inputs.device
        m = self.m
        state = [inputs] + [Fp.zeros(spec, inputs.shape, dev) for _ in range(m - 1)]
        for r in range(self.n):
            state = [s ** self.alpha for s in state]
            state = self._mds_mul(state, self.mds)
            state = [state[i] + Fp.from_int(spec, self.round_constants[2 * r * m + i], dev)
                     for i in range(m)]
            state = [s ** self.alpha_inv for s in state]
            state = self._mds_mul(state, self.mds)
            state = [state[i]
                     + Fp.from_int(spec, self.round_constants[2 * r * m + m + i], dev)
                     for i in range(m)]
        return state[0]

    def _mds_mul(self, state: list, mat) -> list:
        spec, dev = self.spec, state[0].device
        out = []
        for i in range(self.m):
            acc = state[0] * Fp.from_int(spec, mat[i][0], dev)
            for j in range(1, self.m):
                acc = acc + state[j] * Fp.from_int(spec, mat[i][j], dev)
            out.append(acc)
        return out

    # -- AIR ------------------------------------------------------------------
    def round_constants_polynomials(self, omicron: int):
        """The first- and second-half constants interpolated over
        omicron^r, lifted to MPolys in variable 0 (the cycle variable)."""
        p = self.p
        domain = [pow(omicron, r, p) for r in range(self.n)]
        first, second = [], []
        for i in range(self.m):
            vals = [self.round_constants[2 * r * self.m + i] for r in range(self.n)]
            first.append(MPoly.lift(_host_interpolate(domain, vals, p), self.spec, 0))
        for i in range(self.m):
            vals = [self.round_constants[2 * r * self.m + self.m + i] for r in range(self.n)]
            second.append(MPoly.lift(_host_interpolate(domain, vals, p), self.spec, 0))
        return first, second

    def transition_constraints(self, omicron: int) -> list:
        """MDS(prev^a) + C1(x) - (MDS^-1 (next - C2(x)))^a per register."""
        first, second = self.round_constants_polynomials(omicron)
        variables = MPoly.variables(self.spec, 1 + 2 * self.m)
        prev = variables[1:1 + self.m]
        nxt = variables[1 + self.m:1 + 2 * self.m]
        air = []
        for i in range(self.m):
            lhs = MPoly.constant(self.spec, 0)
            for k in range(self.m):
                lhs = lhs + MPoly.constant(self.spec, self.mds[i][k]) * (prev[k] ** self.alpha)
            lhs = lhs + first[i]
            rhs = MPoly.constant(self.spec, 0)
            for k in range(self.m):
                rhs = rhs + MPoly.constant(self.spec, self.mds_inv[i][k]) * (nxt[k] - second[k])
            rhs = rhs ** self.alpha
            air.append(lhs - rhs)
        return air

    def boundary_constraints(self, output_element: int) -> list:
        """[(cycle, register, value)]."""
        return [(0, 1, 0), (self.n, 0, output_element % self.p)]
