"""RFC-6962 Merkle trees over SHA-256: the port's copy of
tendermint_tpu/crypto/merkle.py (reference crypto/merkle/hash.go, tree.go,
proof.go).

Leaves hash as H(0x00 || leaf), inner nodes as H(0x01 || left || right),
the empty tree as H(""), and n leaves split at the largest power of two
strictly below n. A Proof carries (total, index, leaf_hash, aunts), the
aunts from the leaf's sibling up to the root's child.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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


@dataclass
class Proof:
    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def compute_root_hash(self) -> Optional[bytes]:
        return _compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root_hash: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        return self.compute_root_hash() == root_hash


def _compute_hash_from_aunts(index: int, total: int, lh: bytes,
                             aunts: List[bytes]) -> Optional[bytes]:
    """The root from a leaf hash and its aunts, or None when the aunts do
    not fit (index, total)."""
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        return None if aunts else lh
    if not aunts:
        return None
    k = split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, lh, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, lh, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]) -> Tuple[bytes, List[Proof]]:
    """The root hash and a proof for each item."""
    trails, root = _trails_from_byte_slices(list(items))
    return root.hash, [Proof(total=len(items), index=i, leaf_hash=t.hash,
                             aunts=t.flatten_aunts()) for i, t in enumerate(trails)]


class _Node:
    """A node of the proof trail: its hash, its parent and its sibling."""

    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent: Optional[_Node] = None
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None

    def flatten_aunts(self) -> List[bytes]:
        aunts: List[bytes] = []
        node: Optional[_Node] = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            elif node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(items: List[bytes]) -> Tuple[List[_Node], _Node]:
    n = len(items)
    if n == 0:
        return [], _Node(empty_hash())
    if n == 1:
        node = _Node(leaf_hash(items[0]))
        return [node], node
    k = split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root
