"""State sync wire messages (reference: proto/tendermint/statesync/types.proto,
statesync/messages.go). Envelope: oneof field per variant, carried on the
snapshot channel 0x60 (SnapshotsRequest/Response) and chunk channel 0x61
(ChunkRequest/Response).

The port's copy of tendermint_tpu/statesync/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.libs import protowire as pw

# reference: statesync/reactor.go:18-20
SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

# reference: statesync/messages.go:16-17
SNAPSHOT_MSG_SIZE = 4 * 1024 * 1024
CHUNK_MSG_SIZE = 16 * 1024 * 1024


@dataclass(frozen=True)
class SnapshotsRequest:
    FIELD = 1

    def encode_body(self) -> bytes:
        return b""

    @classmethod
    def decode_body(cls, data: bytes) -> "SnapshotsRequest":
        return cls()


@dataclass(frozen=True)
class SnapshotsResponse:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes

    FIELD = 2

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.format)
        w.varint_field(3, self.chunks)
        w.bytes_field(4, self.hash)
        w.bytes_field(5, self.metadata)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "SnapshotsResponse":
        height = fmt = chunks = 0
        h = meta = b""
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                fmt = v
            elif f == 3:
                chunks = v
            elif f == 4:
                h = v
            elif f == 5:
                meta = v
        return cls(height, fmt, chunks, h, meta)

    def validate_basic(self) -> None:
        if self.height <= 0:
            raise ValueError("snapshot height must be positive")
        if self.chunks <= 0:
            raise ValueError("snapshot must have at least one chunk")
        if self.chunks > 1 << 20:
            raise ValueError("too many chunks")
        if not self.hash or len(self.hash) > 64:
            raise ValueError("bad snapshot hash")


@dataclass(frozen=True)
class ChunkRequest:
    height: int
    format: int
    index: int

    FIELD = 3

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.format)
        w.varint_field(3, self.index)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "ChunkRequest":
        height = fmt = index = 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                fmt = v
            elif f == 3:
                index = v
        return cls(height, fmt, index)


@dataclass(frozen=True)
class ChunkResponse:
    height: int
    format: int
    index: int
    chunk: bytes
    missing: bool = False

    FIELD = 4

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.format)
        w.varint_field(3, self.index)
        w.bytes_field(4, self.chunk)
        w.varint_field(5, 1 if self.missing else 0)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "ChunkResponse":
        height = fmt = index = 0
        chunk = b""
        missing = False
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                fmt = v
            elif f == 3:
                index = v
            elif f == 4:
                chunk = v
            elif f == 5:
                missing = bool(v)
        return cls(height, fmt, index, chunk, missing)


_TYPES = {c.FIELD: c for c in (SnapshotsRequest, SnapshotsResponse, ChunkRequest, ChunkResponse)}


def encode_message(msg) -> bytes:
    w = pw.Writer()
    w.message_field(msg.FIELD, msg.encode_body(), always=True)
    return w.bytes()


def decode_message(data: bytes):
    for f, _, v in pw.Reader(data):
        cls = _TYPES.get(f)
        if cls is not None:
            return cls.decode_body(v)
    raise ValueError("unknown statesync message")
