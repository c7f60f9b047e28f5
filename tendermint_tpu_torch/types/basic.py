"""Core identifiers: BlockID, PartSetHeader, timestamps, enums.

The port's copy of tendermint_tpu/types/basic.py (reference types/block.go
BlockID, types/part_set.go PartSetHeader, SignedMsgType, BlockIDFlag), with
the wire codecs and validate_basic the light client's headers need.
Timestamps are integer nanoseconds since the Unix epoch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import protowire as pw

NANOS = 1_000_000_000

# Block part size and the block-size cap (reference types/params.go); a
# decoded part total above MAX_PART_SET_TOTAL fails validate_basic.
BLOCK_PART_SIZE_BYTES = 65536
MAX_BLOCK_SIZE_BYTES = 104_857_600
MAX_PART_SET_TOTAL = (MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES) + 1


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

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        if self.total > MAX_PART_SET_TOTAL:
            raise ValueError(f"Total {self.total} exceeds maximum {MAX_PART_SET_TOTAL}")
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("wrong Hash size")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.total)
        w.bytes_field(2, self.hash)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        total, h = 0, b""
        for f, _, v in pw.Reader(data):
            if f == 1:
                total = v
            elif f == 2:
                h = v
        return cls(total=total, hash=h)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("wrong Hash size")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        return (
            self.hash
            + self.part_set_header.hash
            + (self.part_set_header.total & (2**64 - 1)).to_bytes(8, "big")
        )

    def encode(self) -> bytes:
        w = pw.Writer()
        w.bytes_field(1, self.hash)
        w.message_field(2, self.part_set_header.encode(), always=True)  # non-nullable
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        h, psh = b"", PartSetHeader()
        for f, _, v in pw.Reader(data):
            if f == 1:
                h = v
            elif f == 2:
                psh = PartSetHeader.decode(v)
        return cls(hash=h, part_set_header=psh)

