"""RFC-6962 Merkle roots (crypto/merkle/tree.go, hash.go).

The root part of ``tendermint_tpu/crypto/merkle.py``: SHA-256, leaf
prefix 0x00, inner prefix 0x01, split point the largest power of two
strictly less than n, and SHA256("") for the empty tree. The light
client checks ``Header.hash`` and ``ValidatorSet.hash`` with it.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

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
