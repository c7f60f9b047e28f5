"""Minimal protobuf wire-format writer/reader.

The consensus-critical sign-bytes (CanonicalVote / CanonicalProposal) must be
deterministic, byte-exact protobuf. Rather than depending on generated code for
these tiny messages, we emit the wire format directly. Semantics mirror the
reference's gogoproto marshaller (reference:
proto/tendermint/types/canonical.pb.go MarshalToSizedBuffer): fields emitted in
ascending field-number order, scalar fields at their zero value omitted,
embedded messages omitted when nil but emitted (even if empty) when
non-nullable.

Wire types: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


# Single-byte varints (0..127) cover almost every tag and most scalar values
# on the vote hot path; a table lookup beats rebuilding the bytes object.
_VARINT1 = tuple(bytes((i,)) for i in range(0x80))


def encode_varint(v: int) -> bytes:
    """Unsigned LEB128 varint. Negative ints are encoded as 64-bit two's complement
    (10 bytes), matching protobuf int64/int32 semantics."""
    if 0 <= v < 0x80:
        return _VARINT1[v]
    if v < 0:
        v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_varint(buf: bytes, pos: int = 0) -> Tuple[int, int]:
    """Returns (value, new_pos). Raises ValueError on truncation/overlong input."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result >= 1 << 64:
                raise ValueError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


class Writer:
    """Appends protobuf fields; caller is responsible for ascending field order.

    Backed by ONE growable bytearray instead of a list of small bytes objects:
    the vote hot path (WAL frames, gossip encodes, sign-bytes) builds millions
    of these and the per-field list append + final join churn was measurable.
    (Pre-sizing the bytearray was measured and does NOT help on CPython —
    resize-to-zero reallocs — so the buffer simply grows.)"""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def varint_field(self, field: int, value: int, emit_zero: bool = False) -> "Writer":
        if value != 0 or emit_zero:
            buf = self._buf
            buf += tag(field, VARINT)
            buf += encode_varint(value)
        return self

    def sfixed64_field(self, field: int, value: int, emit_zero: bool = False) -> "Writer":
        if value != 0 or emit_zero:
            buf = self._buf
            buf += tag(field, FIXED64)
            buf += struct.pack("<q", value)
        return self

    def fixed64_field(self, field: int, value: int, emit_zero: bool = False) -> "Writer":
        if value != 0 or emit_zero:
            buf = self._buf
            buf += tag(field, FIXED64)
            buf += struct.pack("<Q", value)
        return self

    def bytes_field(self, field: int, value: bytes, emit_empty: bool = False) -> "Writer":
        if value or emit_empty:
            buf = self._buf
            buf += tag(field, BYTES)
            buf += encode_varint(len(value))
            buf += value
        return self

    def string_field(self, field: int, value: str, emit_empty: bool = False) -> "Writer":
        return self.bytes_field(field, value.encode("utf-8"), emit_empty)

    def message_field(self, field: int, msg: bytes | None, always: bool = False) -> "Writer":
        """Embedded message. msg=None omits; always=True emits even when empty
        (gogoproto non-nullable semantics)."""
        if msg is None and not always:
            return self
        body = msg or b""
        buf = self._buf
        buf += tag(field, BYTES)
        buf += encode_varint(len(body))
        buf += body
        return self

    def bytes(self) -> bytes:
        return bytes(self._buf)


_TS_TAG1 = bytes((0x08,))  # tag(1, VARINT)
_TS_TAG2 = bytes((0x10,))  # tag(2, VARINT)


def encode_timestamp(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp body: seconds int64 (field 1), nanos int32
    (field 2). Direct concat — this runs once per vote encode AND once per
    sign-bytes on the hot path."""
    out = b""
    if seconds:
        out = _TS_TAG1 + encode_varint(seconds)
    if nanos:
        out += _TS_TAG2 + encode_varint(nanos)
    return out


def length_delimited(msg: bytes) -> bytes:
    """Varint length prefix + message — the reference's protoio.MarshalDelimited
    framing used for sign-bytes (reference: types/vote.go VoteSignBytes)."""
    return encode_varint(len(msg)) + msg


def read_length_delimited(buf: bytes, pos: int = 0) -> Tuple[bytes, int]:
    n, pos = decode_varint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("truncated length-delimited message")
    return buf[pos : pos + n], pos + n


class Reader:
    """Iterates (field_number, wire_type, value) triples of a serialized message.

    value is an int for VARINT/FIXED64/FIXED32 (unsigned) and bytes for BYTES.
    """

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos >= len(self.buf):
            raise StopIteration
        key, self.pos = decode_varint(self.buf, self.pos)
        field, wt = key >> 3, key & 7
        if wt == VARINT:
            val, self.pos = decode_varint(self.buf, self.pos)
        elif wt == FIXED64:
            if self.pos + 8 > len(self.buf):
                raise ValueError("truncated fixed64")
            val = struct.unpack_from("<Q", self.buf, self.pos)[0]
            self.pos += 8
        elif wt == BYTES:
            val, self.pos = read_length_delimited(self.buf, self.pos)
        elif wt == FIXED32:
            if self.pos + 4 > len(self.buf):
                raise ValueError("truncated fixed32")
            val = struct.unpack_from("<I", self.buf, self.pos)[0]
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        return field, wt, val


def sfixed64_from_unsigned(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def int64_from_varint(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v
