"""Core identifiers: BlockID, PartSetHeader, timestamps, enums.

The port's copy of tendermint_tpu/types/basic.py (reference types/block.go
BlockID, types/part_set.go PartSetHeader, SignedMsgType, BlockIDFlag).
Timestamps are integer nanoseconds since the Unix epoch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

NANOS = 1_000_000_000


def ts_seconds_nanos(ts_ns: int) -> tuple[int, int]:
    return divmod(ts_ns, NANOS)


class SignedMsgType(enum.IntEnum):
    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


class BlockIDFlag(enum.IntEnum):
    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def key(self) -> bytes:
        return (
            self.hash
            + self.part_set_header.hash
            + (self.part_set_header.total & (2**64 - 1)).to_bytes(8, "big")
        )

