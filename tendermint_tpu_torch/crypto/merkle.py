"""RFC-6962 Merkle roots and inclusion proofs (crypto/merkle/tree.go,
hash.go, proof.go).

The root and proof part of ``tendermint_tpu/crypto/merkle.py``: SHA-256,
leaf prefix 0x00, inner prefix 0x01, split point the largest power of
two strictly less than n, and SHA256("") for the empty tree. The light
client checks ``Header.hash`` and ``ValidatorSet.hash`` with it; a
block's ``PartSet`` proves each part with a :class:`Proof`. The proof
operators and ``hash_from_map`` (the RPC's proofs) are left out.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"
HASH_SIZE = 32


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def empty_hash() -> bytes:
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def get_split_point(n: int) -> int:
    """Largest power of two strictly less than n (crypto/merkle/tree.go:94)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    k = 1 << (n.bit_length() - 1)
    if k == n:
        k >>= 1
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """crypto/merkle.HashFromByteSlices."""
    if not items:
        return empty_hash()
    return _hash_level([leaf_hash(item) for item in items])


def _hash_level(hashes: List[bytes]) -> bytes:
    n = len(hashes)
    if n == 1:
        return hashes[0]
    k = get_split_point(n)
    return inner_hash(_hash_level(hashes[:k]), _hash_level(hashes[k:]))


@dataclass
class Proof:
    """Merkle inclusion proof (crypto/merkle/proof.go:22-103)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    MAX_AUNTS = 100

    def verify(self, root_hash: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or len(self.aunts) > self.MAX_AUNTS:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = self.compute_root_hash()
        return computed is not None and computed == root_hash

    def compute_root_hash(self) -> Optional[bytes]:
        return _compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)


def _compute_hash_from_aunts(index: int, total: int, leaf: bytes, aunts: List[bytes]) -> Optional[bytes]:
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        return None if aunts else leaf
    if not aunts:
        return None
    k = get_split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, leaf, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]) -> Tuple[bytes, List[Proof]]:
    """Root hash and a proof an item (crypto/merkle/proof.go ProofsFromByteSlices)."""
    n = len(items)
    if n == 0:
        return empty_hash(), []
    leaf_hashes = [leaf_hash(item) for item in items]
    proofs = [Proof(total=n, index=i, leaf_hash=leaf_hashes[i]) for i in range(n)]

    def build(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            return leaf_hashes[lo]
        k = get_split_point(hi - lo)
        left = build(lo, lo + k)
        right = build(lo + k, hi)
        for i in range(lo, lo + k):
            proofs[i].aunts.append(right)
        for i in range(lo + k, hi):
            proofs[i].aunts.append(left)
        return inner_hash(left, right)

    return build(0, n), proofs
