"""Plain Groth16 reference: the proof's three points from the scalars that
define them.

With toxic waste (alpha, beta, gamma, delta, x), a witness a and the
randomness (r, s), a Groth16 proof over the QAP of an R1CS (A, B, C) on the
m-point root-of-unity domain is

  A = [a] G1,  a = alpha + U + r delta
  B = [b] G2,  b = beta + V + s delta
  C = [c] G1,  c = (beta U' + alpha V' + W' + U V - W) / delta + s a + r b - r s delta

where U = sum_i a_i u_i(x) and u_i is column i of A interpolated over the
domain (V, W likewise for B, C), and the primed sums run over the private
wires only.  U V - W = h(x) t(x) for a satisfying witness, so the quotient
polynomial h never has to be formed.  u_i(x) = sum_j A[j, i] lam_j(x) with
the Lagrange basis lam_j(x) = w^j (x^m - 1) / (m (x - w^j)), so U is one
sum over A's entries: A[j, i] lam_j(x) a_i.

A job's witness is the square chain from x_j = x0^(2^j): wires [1, x_j, ...,
x_(j + m)] of one chain x_0, x_1, ... (x_(i + 1) = x_i^2).  Each matrix of
the square chain holds row k's one entry at wire k + off, so its sum is
S(t) = sum_k lam_k(x) v_k x_(t + k) with t = j + off - 1, and jobs share
these sums: A's at job j + 1 is C's at job j.  The O(m) part (the chain, the
basis, the sums) runs on ``fieldvec`` vectors, on the card in a run; the
points are three host scalar multiplications a proof.

Nothing here is taken from the program: the chain is recomputed from x0,
the circuit from its definition, and the key's scalars from the toxic
waste.  ``scalar_bits`` below 256 is the control: every scalar cut to its
low bits before the multiplication, as a prover that drops the top of the
scalar would.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bn254
from .fieldvec import PrimeField

R = bn254.R


def square_chain_r1cs(m: int):
    """The circuit x_{k+1} = x_k * x_k over the wires [1, x_0, ..., x_m]:
    each of A, B, C as (rows, cols, values) with one entry a row."""
    rows = np.arange(m, dtype=np.int64)
    ones = np.ones(m, dtype=np.int64)
    return {"A": (rows, rows + 1, ones), "B": (rows, rows + 1, ones),
            "C": (rows, rows + 2, ones)}


def square_chain_values(F: PrimeField, n: int, x0: int, block: int = 512) -> torch.Tensor:
    """x0, x0^2, x0^4, ..., x0^(2^(n - 1)), Montgomery form (16, n): blocks
    of ``block`` squarings side by side, each block starting from
    x0^(2^(b block)) by one host power (the exponent reduced mod p - 1, x0
    being nonzero)."""
    p = F.p
    if x0 % p == 0:
        raise ValueError("the chain's x0 is 0")
    block = min(block, n)
    blocks = -(-n // block)
    starts = [pow(x0, pow(2, b * block, p - 1), p) * F.R % p for b in range(blocks)]
    cur = F.from_ints(starts)
    out = torch.empty((16, blocks, block), dtype=torch.int64, device=F.device)
    for i in range(block):
        out[:, :, i] = cur
        cur = F.mul(cur, cur)
    return out.reshape(16, -1)[:, :n].contiguous()


def _small_ints(F: PrimeField, values: np.ndarray) -> torch.Tensor:
    """Values below 2^16 as (16, n) Montgomery limbs."""
    if values.min() < 0 or values.max() >= 1 << 16:
        raise ValueError("the circuit's coefficients here lie in [0, 2^16)")
    limbs = torch.zeros((16, values.shape[0]), dtype=torch.int64, device=F.device)
    limbs[0] = torch.from_numpy(values).to(F.device)
    return F.to_mont(limbs)


def lagrange_basis(F: PrimeField, m: int, x: int, generator: int) -> torch.Tensor:
    """lam_j(x) for j < m over the domain of w = generator^((r - 1) / m),
    Montgomery form (16, m)."""
    p = F.p
    if m & (m - 1) or (p - 1) % m:
        raise ValueError(f"no {m}-point root-of-unity domain")
    w = pow(generator, (p - 1) // m, p)
    if pow(w, m // 2, p) != p - 1:
        raise ValueError("the domain generator gives no primitive root")
    if pow(x, m, p) == 1:
        raise ValueError("x lies on the domain")
    k_lo = (m.bit_length() - 1) // 2
    lo_n, hi_n = 1 << k_lo, m >> k_lo
    lo = F.from_ints([pow(w, b, p) * F.R % p for b in range(lo_n)])
    w_hi = pow(w, lo_n, p)
    hi = F.from_ints([pow(w_hi, a, p) * F.R % p for a in range(hi_n)])
    wj = F.mul(hi.repeat_interleave(lo_n, dim=1), lo.repeat(1, hi_n))
    denom = F.sub(F.const(x), wj)
    scale = (pow(x, m, p) - 1) * pow(m, -1, p) % p
    return F.mul(F.mul(wj, F.batch_inverse(denom)), F.const(scale))


class Groth16Reference:
    """The proofs of one key (toxic waste) over the square-chain witnesses
    of one x0, at m constraints: ``statements`` of them, the witness of
    shift j starting at x_j."""

    def __init__(self, config: dict, toxic: tuple, x0: int, device):
        self.m, self.num_public = int(config["constraints"]), int(config["num_public"])
        if config["circuit"] != "square_chain":
            raise ValueError(f"no reference for circuit {config['circuit']!r}")
        self.alpha, self.beta, self.gamma, self.delta, self.x = toxic
        self.F = F = PrimeField(R, device)
        self.chain = square_chain_values(F, self.m + int(config["statements"]), x0)
        lam = lagrange_basis(F, self.m, self.x, int(config["domain_generator"]))
        # each matrix as (its weights lam_k v_k, its offset); equal weights shared
        self.mats, weights = {}, {}
        for name, (rows, cols, vals) in square_chain_r1cs(self.m).items():
            off = cols - rows
            if not (rows == np.arange(self.m)).all() or (off != off[0]).any() or off[0] < 1:
                raise ValueError("the reference takes one entry a row, at wire row + off >= 1")
            key = vals.tobytes()
            if key not in weights:
                weights[key] = F.mul(lam, _small_ints(F, vals))
            self.mats[name] = (key, int(off[0]))
        self.weights = weights
        self._sums = {}

    def _sum(self, key: bytes, t: int) -> tuple:
        """(S(t), its first num_public terms) as standard-form ints."""
        if (key, t) not in self._sums:
            terms = self.F.mul(self.weights[key], self.chain[:, t:t + self.m])
            head = self.F.to_ints(self.F.from_mont(terms[:, :self.num_public]))
            self._sums[key, t] = (self.F.sum_mont(terms), head)
        return self._sums[key, t]

    def sums(self, shift: int) -> dict:
        """{matrix: (sum over all wires, over the private wires)} of the
        witness that starts at x_shift."""
        out = {}
        for name, (key, off) in self.mats.items():
            total, head = self._sum(key, shift + off - 1)
            public = sum(head[:max(0, self.num_public - off)])
            out[name] = (total, (total - public) % R)
        return out

    def scalars(self, shift: int, r: int, s: int) -> tuple:
        sums = self.sums(shift)
        (U, Up), (V, Vp), (W, Wp) = (sums[k] for k in "ABC")
        al, be, de = self.alpha, self.beta, self.delta
        a = (al + U + r * de) % R
        b = (be + V + s * de) % R
        c = ((be * Up + al * Vp + Wp + U * V - W) * pow(de, -1, R)
             + s * a + r * b - r * s * de) % R
        return a, b, c

    def proof(self, shift: int, r: int, s: int, scalar_bits: int = 256) -> tuple:
        """(A, B, C) affine, as ``bn254`` writes points."""
        cut = (1 << scalar_bits) - 1
        a, b, c = (k & cut for k in self.scalars(shift, r, s))
        return bn254.g1_mul(a), bn254.g2_mul(b), bn254.g1_mul(c)
