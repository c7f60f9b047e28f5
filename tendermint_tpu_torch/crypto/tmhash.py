"""Hash helpers — SHA-256 and its 20-byte truncated variant.

Mirrors the reference's crypto/tmhash/hash.go: Sum = SHA-256,
SumTruncated = first 20 bytes of SHA-256 (used for addresses).
"""

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
