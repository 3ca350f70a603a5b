"""SHA3-256 Merkle tree with stored levels.

Counterpart of ``myzkp_tpu/utils/merkle.py`` (the reference's
``merkle.rs:15-66``), with the same node semantics: leaves are used raw (the
commit of a single leaf is the leaf itself) and an interior node is
SHA3-256(left || right), so ``verify`` accepts the same (root, index, path,
leaf) tuples and every root and path is byte for byte the JAX package's.
The tree stores all levels when it is built, so every open is log2(n)
lookups.

Every hash runs in the port's C++ SHA3 (``native/keccak.cpp``, the copy of
the JAX package's ``native/src/keccak.cpp``): the levels in one call, split
over the host's threads.  There is no second implementation beside it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from .. import native
from .metrics import span


def _check_count(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} leaves: the count must be a power of two")


class MerkleTree:
    """Stored-level Merkle tree over a power-of-two list of byte leaves."""

    @span("merkle")
    def __init__(self, leaves: list):
        n = len(leaves)
        _check_count(n)
        self.leaves = list(leaves)
        # interior nodes, 32 bytes each, level by level up to the root
        self._nodes = native.merkle_levels(self.leaves) if n > 1 else b""

    @property
    def root(self) -> bytes:
        return self._nodes[-32:] if self._nodes else self.leaves[0]

    def open(self, index: int) -> list:
        """Auth path, leaf level first: the sibling leaf, then the sibling
        node of each interior level below the root."""
        n = len(self.leaves)
        if n == 1:
            return []
        path = [self.leaves[index ^ 1]]
        start, m = 0, n // 2
        index >>= 1
        while m > 1:
            k = start + (index ^ 1)
            path.append(self._nodes[32 * k:32 * (k + 1)])
            start, m, index = start + m, m // 2, index >> 1
        return path


class DistMerkleTree:
    """Merkle tree built as ``n_shards`` independent subtrees over contiguous
    power-of-two chunks of the leaves, plus a top tree over their roots (the
    layout of a codeword sharded over devices).  The root and every path are
    the monolithic tree's.  ``subtrees`` maps a shard to its subtree: every
    shard here, a rank's own on a mesh (``parallel/mesh.MeshMerkleTree``)."""

    def __init__(self, leaves: list, n_shards: int, parallel: bool = True):
        n = len(leaves)
        _check_count(n)
        _check_count(n_shards)
        if n % n_shards:
            raise ValueError(f"{n_shards} shards do not divide {n} leaves")
        size = n // n_shards
        chunks = [leaves[i * size:(i + 1) * size] for i in range(n_shards)]
        if parallel and n_shards > 1:
            with ThreadPoolExecutor(max_workers=min(n_shards, 8)) as ex:
                subtrees = list(ex.map(MerkleTree, chunks))
        else:
            subtrees = [MerkleTree(c) for c in chunks]
        self._join(dict(enumerate(subtrees)), [t.root for t in subtrees])

    def _join(self, subtrees: dict, roots: list) -> None:
        """The subtrees at hand, by shard, and the top tree over every
        shard's subtree root."""
        _check_count(len(roots))
        self.subtrees = subtrees
        self.n_shards = len(roots)
        self.shard_size = len(next(iter(subtrees.values())).leaves)
        self.n = self.n_shards * self.shard_size
        self.top = MerkleTree(list(roots))

    @property
    def root(self) -> bytes:
        return self.top.root

    def open(self, index: int) -> list:
        """Auth path, leaf level first, as a monolithic tree's."""
        shard, local = divmod(index, self.shard_size)
        return self.subtrees[shard].open(local) + self.top.open(shard)


def commit(leaves: list) -> bytes:
    """One-shot root."""
    return MerkleTree(leaves).root


def open(index: int, leaves: list) -> list:  # noqa: A001 - the reference's name
    """One-shot auth path."""
    return MerkleTree(leaves).open(index)


def verify(root: bytes, index: int, path: list, leaf: bytes) -> bool:
    """True when ``path`` leads from ``leaf`` at ``index`` to ``root``."""
    cur = leaf
    for sib in path:
        cur = native.sha3_256(cur + sib) if index % 2 == 0 else native.sha3_256(sib + cur)
        index >>= 1
    return cur == root
