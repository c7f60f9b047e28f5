"""Block sync wire messages (reference: blockchain/v0/reactor.go +
proto/tendermint/blockchain). Envelope: oneof field per variant.

The port's copy of tendermint_tpu/blocksync/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.block import Block


@dataclass(frozen=True)
class BlockRequest:
    height: int

    FIELD = 1

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "BlockRequest":
        height = 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
        return cls(height)


@dataclass(frozen=True)
class NoBlockResponse:
    height: int

    FIELD = 2

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "NoBlockResponse":
        height = 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
        return cls(height)


@dataclass(frozen=True)
class BlockResponse:
    block: Block

    FIELD = 3

    def encode_body(self) -> bytes:
        return self.block.encode()

    @classmethod
    def decode_body(cls, data: bytes) -> "BlockResponse":
        return cls(Block.decode(data))


@dataclass(frozen=True)
class StatusRequest:
    FIELD = 4

    def encode_body(self) -> bytes:
        return b""

    @classmethod
    def decode_body(cls, data: bytes) -> "StatusRequest":
        return cls()


@dataclass(frozen=True)
class StatusResponse:
    height: int
    base: int

    FIELD = 5

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.base)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "StatusResponse":
        height = base = 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                base = pw.int64_from_varint(v)
        return cls(height, base)


_TYPES = {c.FIELD: c for c in (BlockRequest, NoBlockResponse, BlockResponse, StatusRequest, StatusResponse)}


def encode_message(msg) -> bytes:
    w = pw.Writer()
    w.message_field(msg.FIELD, msg.encode_body(), always=True)
    return w.bytes()


def decode_message(data: bytes):
    for f, _, v in pw.Reader(data):
        cls = _TYPES.get(f)
        if cls is not None:
            return cls.decode_body(v)
    raise ValueError("unknown blocksync message")
