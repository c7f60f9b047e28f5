"""RFC-6962 Merkle roots over SHA-256: the tree hash of
tendermint_tpu/crypto/merkle.py (reference crypto/merkle/hash.go, tree.go).

Leaves hash as H(0x00 || leaf), inner nodes as H(0x01 || left || right),
the empty tree as H(""), and n leaves split at the largest power of two
strictly below n. Proofs are not ported yet.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def empty_hash() -> bytes:
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    if n < 2:
        raise ValueError("split_point requires n >= 2")
    return 1 << (n - 1).bit_length() - 1


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:]))
