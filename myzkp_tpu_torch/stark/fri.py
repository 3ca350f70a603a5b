"""FRI low-degree test over any prime field.

Counterpart of ``myzkp_tpu/stark/fri.py`` (the reference's ``fri.rs``):
index sampling by Blake2b(seed || counter) (``sample_index``,
``sample_indices``), bytes -> field element (``sample_field``), the codeword
fold on the device (``fold_codeword``: one vector expression a round over
Montgomery limb tensors), ``FRI`` with ``commit`` (Merkle root -> Fiat-Shamir
alpha -> fold), ``prove`` (commit, then the a / b / c points and their paths
for each colinearity test) and ``verify`` (challenges recomputed, the last
codeword's degree by host Lagrange, colinearity, Merkle paths; malformed
proofs are rejected, never raised on), and the M128 / M64 roots of unity.
Merkle hashing and the transcript stay on the host over the canonical
little-endian bytes of each element, so every root, path and proof is the
JAX package's byte for byte.

One change of structure, not of values: ``commit`` keeps each round's
Merkle tree, and the query phase opens those trees, where the reference
builds each tree again from its leaves (once in ``commit`` and twice in
``_reveal``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import _ext
from ..fields import limb
from ..fields.fp import Fp
from ..fields.spec import M64, M128, FieldSpec
from ..ops import ntt as _ntt
from ..utils import merkle
from ..utils.fiat_shamir import FiatShamirTransformer
from ..utils.metrics import span

# ---------------------------------------------------------------------------
# Index sampling
# ---------------------------------------------------------------------------


def sample_index(byte_array: bytes, size: int) -> int:
    acc = 0
    for b in byte_array:
        acc = ((acc << 8) ^ b) & ((1 << 256) - 1)
    return acc % size


def sample_indices(seed: bytes, size: int, reduced_size: int, number: int) -> list:
    """``number`` indices below ``size`` whose residues mod ``reduced_size``
    are distinct, from Blake2b(seed || counter)."""
    if number > reduced_size:
        raise ValueError("cannot sample more indices than available")
    indices, reduced_seen = [], []
    counter = 0
    while len(indices) < number:
        h = hashlib.blake2b(seed + counter.to_bytes(8, "little"), digest_size=32).digest()
        index = sample_index(h, size)
        reduced = index % reduced_size
        counter += 1
        if reduced not in reduced_seen:
            indices.append(index)
            reduced_seen.append(reduced)
    return indices


def sample_field(spec: FieldSpec, data: bytes) -> int:
    """Hash bytes -> field element: big-endian, reduced mod p."""
    return int.from_bytes(data, "big") % spec.p


# ---------------------------------------------------------------------------
# Codeword <-> bytes
# ---------------------------------------------------------------------------

def codeword_bytes(cw: Fp) -> list:
    """Codeword -> its elements' canonical little-endian bytes (2L each)."""
    return limb.to_bytes_batch(cw.spec, limb.from_mont(cw.spec, cw.mont))


def codeword_from_bytes(spec: FieldSpec, bs: list, device=None) -> Fp:
    """Inverse of codeword_bytes, on the card unless ``device`` names
    another device."""
    arr = np.frombuffer(b"".join(bs), dtype="<u2").reshape(len(bs), spec.L)
    limbs = torch.from_numpy(np.ascontiguousarray(arr.T.astype(np.int32)))
    return Fp(spec, limb.to_mont(spec, limbs.to(_ext.resolve_device(device))))


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------

def fold_codeword(spec: FieldSpec, cw_mont, alpha: int, offset: int, omega: int):
    """cw' = 1/2 [(1 + a / (o w^i)) cw_i + (1 - a / (o w^i)) cw_(i + n/2)]:
    Montgomery limbs (L, n) -> (L, n/2), on cw_mont's device."""
    n = cw_mont.shape[-1]
    half = n // 2
    p = spec.p
    dev = cw_mont.device
    inv_od = _ntt.geometric_series(spec, pow(omega, -1, p), half, dev) * Fp.from_int(
        spec, pow(offset, -1, p), dev)
    factor = inv_od * Fp.from_int(spec, alpha, dev)  # alpha / (offset w^i)
    one = Fp.ones(spec, (half,), dev)
    left = Fp(spec, cw_mont[..., :half])
    right = Fp(spec, cw_mont[..., half:])
    half_inv = Fp.from_int(spec, pow(2, -1, p), dev)
    out = ((one + factor) * left + (one - factor) * right) * half_inv
    return out.mont


# ---------------------------------------------------------------------------
# FRI proper
# ---------------------------------------------------------------------------

@dataclass
class FriQueryLayer:
    a: tuple  # (values: list[bytes], paths: list[list[bytes]])
    b: tuple
    c: tuple


@dataclass
class FriProof:
    top_level_indices: list
    last_codeword: list  # list[bytes]
    merkle_roots: list
    revealed_layers: list


@dataclass
class FRI:
    offset: int
    omega: int
    domain_length: int
    expansion_factor: int
    num_colinearity_tests: int
    spec: FieldSpec

    def num_rounds(self) -> int:
        """Halve until the codeword is no longer than the expansion factor
        or 4 * tests reach its length."""
        codeword_length = self.domain_length
        n = 0
        while (codeword_length > self.expansion_factor
               and 4 * self.num_colinearity_tests < codeword_length):
            codeword_length //= 2
            n += 1
        return n

    def eval_domain(self) -> list:
        """[offset * omega^i] as host ints."""
        p = self.spec.p
        out, acc = [], self.offset % p
        for _ in range(self.domain_length):
            out.append(acc)
            acc = acc * self.omega % p
        return out

    def _fold(self, cw: Fp, alpha: int, offset: int, omega: int) -> Fp:
        return Fp(self.spec, fold_codeword(self.spec, cw.mont, alpha, offset, omega))

    # -- commit phase --------------------------------------------------------
    def commit(self, codeword: Fp, proof_stream: FiatShamirTransformer):
        """Returns (codewords, the Merkle tree of every round, the leaves of
        every round)."""
        omega, offset = self.omega, self.offset
        codewords, trees, leaves_all = [], [], []
        rounds = self.num_rounds()
        for r in range(rounds):
            leaves = codeword_bytes(codeword)
            tree = merkle.MerkleTree(leaves)
            trees.append(tree)
            proof_stream.push([tree.root])
            if r == rounds - 1:
                break
            alpha = sample_field(self.spec, proof_stream.prover_fiat_shamir(32))
            codewords.append(codeword)
            leaves_all.append(leaves)
            codeword = self._fold(codeword, alpha, offset, omega)
            omega = omega * omega % self.spec.p
            offset = offset * offset % self.spec.p
        last_leaves = codeword_bytes(codeword)
        proof_stream.push(last_leaves)
        codewords.append(codeword)
        leaves_all.append(last_leaves)
        return codewords, trees, leaves_all

    # -- query phase ---------------------------------------------------------
    @staticmethod
    def _reveal(cur_tree, next_tree, c_indices):
        """The a, b (c + n/2) and c points of a round with their paths."""
        cur, nxt = cur_tree.leaves, next_tree.leaves
        half = len(cur) // 2
        a_idx = list(c_indices)
        b_idx = [i + half for i in c_indices]
        a = ([cur[i] for i in a_idx], [cur_tree.open(i) for i in a_idx])
        b = ([cur[i] for i in b_idx], [cur_tree.open(i) for i in b_idx])
        c = ([nxt[i] for i in c_indices], [next_tree.open(i) for i in c_indices])
        return FriQueryLayer(a=a, b=b, c=c)

    @span("FRI")
    def prove(self, codeword: Fp) -> FriProof:
        if codeword.shape[-1] != self.domain_length:
            raise ValueError(f"codeword of {codeword.shape[-1]} points, "
                             f"domain of {self.domain_length}")
        proof_stream = FiatShamirTransformer()
        _, trees, leaves_all = self.commit(codeword, proof_stream)
        top_level_indices = sample_indices(
            proof_stream.prover_fiat_shamir(32),
            len(leaves_all[1]) if len(leaves_all) > 1 else len(leaves_all[0]),
            len(leaves_all[-1]),
            self.num_colinearity_tests,
        )
        indices = list(top_level_indices)
        revealed = []
        for i in range(len(leaves_all) - 1):
            indices = [idx % (len(leaves_all[i]) // 2) for idx in indices]
            revealed.append(self._reveal(trees[i], trees[i + 1], indices))
        return FriProof(top_level_indices=top_level_indices, last_codeword=leaves_all[-1],
                        merkle_roots=[t.root for t in trees], revealed_layers=revealed)

    # -- verification --------------------------------------------------------
    def _well_formed(self, proof: FriProof) -> bool:
        """Structural validation, so that a malformed proof is rejected
        instead of crashing the verifier."""
        rounds = self.num_rounds()
        if not isinstance(proof.merkle_roots, (list, tuple)) or \
                len(proof.merkle_roots) != rounds:
            return False
        if not all(isinstance(r, bytes) and len(r) == 32 for r in proof.merkle_roots):
            return False
        leaf_w = 2 * self.spec.L
        nlast = self.domain_length >> (rounds - 1)
        if not isinstance(proof.last_codeword, (list, tuple)) or \
                len(proof.last_codeword) != nlast:
            return False
        if not all(isinstance(b, bytes) and len(b) == leaf_w for b in proof.last_codeword):
            return False
        if not isinstance(proof.revealed_layers, (list, tuple)) or \
                len(proof.revealed_layers) != rounds - 1:
            return False
        t = self.num_colinearity_tests
        for layer in proof.revealed_layers:
            for side in (layer.a, layer.b, layer.c):
                if len(side) != 2:
                    return False
                vals, paths = side
                if len(vals) != t or len(paths) != t:
                    return False
                if not all(isinstance(v, bytes) and len(v) == leaf_w for v in vals):
                    return False
                if not all(_path_ok(pp, leaf_w) for pp in paths):
                    return False
        return True

    def verify(self, proof: FriProof, polynomial_values: list) -> bool:
        """Appends the (index, value) pairs of the top-level codeword that the
        proof opens to polynomial_values.  A malformed proof returns False."""
        try:
            if not self._well_formed(proof):
                return False
        except (TypeError, AttributeError):
            return False
        p = self.spec.p
        proof_stream = FiatShamirTransformer()
        omega, offset = self.omega, self.offset

        alphas = []
        for r in proof.merkle_roots:
            proof_stream.push([r])
            alphas.append(sample_field(self.spec, proof_stream.prover_fiat_shamir(32)))

        proof_stream.push(list(proof.last_codeword))
        if proof.merkle_roots[-1] != merkle.commit(list(proof.last_codeword)):
            return False

        # low-degree check of the last codeword (host Lagrange on ints)
        nlast = len(proof.last_codeword)
        degree = (nlast // self.expansion_factor) - 1
        last_omega, last_offset = omega, offset
        for _ in range(self.num_rounds() - 1):
            last_omega = last_omega * last_omega % p
            last_offset = last_offset * last_offset % p
        # omega must have order exactly nlast
        if last_omega % p == 0 or pow(last_omega, nlast, p) != 1:
            return False
        rest, q, prime_facs = nlast, 2, set()
        while q * q <= rest:
            while rest % q == 0:
                prime_facs.add(q)
                rest //= q
            q += 1
        if rest > 1:
            prime_facs.add(rest)
        if any(pow(last_omega, nlast // f, p) == 1 for f in prime_facs):
            return False
        xs, acc = [], last_offset
        for _ in range(nlast):
            xs.append(acc)
            acc = acc * last_omega % p
        ys = [_int_from_le(b) for b in proof.last_codeword]
        coeffs = _host_interpolate(xs, ys, p)
        for x, y in zip(xs, ys):
            if _host_eval(coeffs, x, p) != y:
                return False
        actual_deg = max([i for i, c in enumerate(coeffs) if c] or [0])
        if any(coeffs) and actual_deg > degree:
            return False

        top_level_indices = sample_indices(
            proof_stream.prover_fiat_shamir(32),
            self.domain_length >> 1,
            self.domain_length >> (self.num_rounds() - 1),
            self.num_colinearity_tests,
        )

        for r in range(self.num_rounds() - 1):
            half = self.domain_length >> (r + 1)
            c_indices = [i % half for i in top_level_indices]
            a_indices = list(c_indices)
            b_indices = [i + half for i in c_indices]
            layer = proof.revealed_layers[r]

            for s in range(self.num_colinearity_tests):
                ay = _int_from_le(layer.a[0][s])
                by = _int_from_le(layer.b[0][s])
                cy = _int_from_le(layer.c[0][s])
                if r == 0:
                    polynomial_values.append((a_indices[s], ay))
                    polynomial_values.append((b_indices[s], by))
                ax = offset * pow(omega, a_indices[s], p) % p
                bx = offset * pow(omega, b_indices[s], p) % p
                cx = alphas[r]
                # colinearity: (cy - ay)(bx - ax) == (by - ay)(cx - ax)
                if (cy - ay) * (bx - ax) % p != (by - ay) * (cx - ax) % p:
                    return False

            for i in range(self.num_colinearity_tests):
                if not merkle.verify(proof.merkle_roots[r], a_indices[i],
                                     layer.a[1][i], layer.a[0][i]):
                    return False
                if not merkle.verify(proof.merkle_roots[r], b_indices[i],
                                     layer.b[1][i], layer.b[0][i]):
                    return False
                if not merkle.verify(proof.merkle_roots[r + 1], c_indices[i],
                                     layer.c[1][i], layer.c[0][i]):
                    return False

            omega = omega * omega % p
            offset = offset * offset % p

        return True


def _path_ok(path, leaf_w: int) -> bool:
    """A Merkle auth path: the sibling leaf first (2L bytes), then 32-byte
    interior digests."""
    if not isinstance(path, (list, tuple)):
        return False
    if not all(isinstance(s, bytes) for s in path):
        return False
    if path and len(path[0]) != leaf_w:
        return False
    return all(len(s) == 32 for s in path[1:])


def _int_from_le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _host_interpolate(xs: list, ys: list, p: int) -> list:
    """O(n^2) Lagrange on host ints (verifier-side, tiny n); coefficients
    low first."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        # basis poly prod_{j!=i} (X - x_j) / (x_i - x_j)
        denom = 1
        basis = [1]
        for j in range(n):
            if j == i:
                continue
            denom = denom * (xs[i] - xs[j]) % p
            nb = [0] * (len(basis) + 1)
            for k, c in enumerate(basis):
                nb[k] = (nb[k] - c * xs[j]) % p
                nb[k + 1] = (nb[k + 1] + c) % p
            basis = nb
        w = ys[i] * pow(denom, -1, p) % p
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + w * c) % p
    return coeffs


def _host_eval(coeffs: list, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


# ---------------------------------------------------------------------------
# Roots of unity of the STARK fields
# ---------------------------------------------------------------------------

def get_nth_root_of_m128(n: int) -> int:
    """Primitive n-th root of unity in M128 = 1 + 407 * 2^119."""
    return _ntt.nth_root_of_unity(M128, n)


def get_nth_root_of_m64(n: int) -> int:
    """Primitive n-th root of unity in Goldilocks."""
    return _ntt.nth_root_of_unity(M64, n)
