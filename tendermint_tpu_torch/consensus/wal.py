"""Consensus write-ahead log (reference: consensus/wal.go).

Every message (peer msg, internal msg, timeout) is written before processing;
self-generated messages are fsynced (WriteSync). Framing: crc32(IEEE) ‖
length ‖ protobuf body (reference: consensus/wal.go:290 WALEncoder), with
rotating files via a size-capped group (reference: libs/autofile/group.go).
EndHeightMessage marks a completed height for crash replay
(reference: consensus/wal.go:42,231).

The port's copy of tendermint_tpu/consensus/wal.py, the same encodings byte for byte.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

from tendermint_tpu_torch.consensus.messages import decode_message, encode_message
from tendermint_tpu_torch.libs import hotstats as _hotstats
from tendermint_tpu_torch.libs import protowire as pw

MAX_MSG_SIZE_BYTES = 1024 * 1024  # 1MB (reference: consensus/wal.go:32)
DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # autofile group head limit
DEFAULT_GROUP_TOTAL_LIMIT = 1024 * 1024 * 1024


@dataclass(frozen=True)
class EndHeightMessage:
    height: int


@dataclass(frozen=True)
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int


@dataclass(frozen=True)
class MsgInfo:
    msg: object  # a consensus message
    peer_id: str = ""


@dataclass(frozen=True)
class EventRoundState:
    height: int
    round: int
    step: int


WALMessage = Union[EndHeightMessage, TimeoutInfo, MsgInfo, EventRoundState]


# Precomputed tags for the flattened MsgInfo fast path below (byte-identical
# to the Writer-built form; pinned by test_wal_repair round-trips and the
# group-commit byte-identity test).
_TAG_PEER = pw.tag(1, pw.BYTES)
_TAG_INNER = pw.tag(2, pw.BYTES)
_TAG_MSGINFO = pw.tag(3, pw.BYTES)


def _encode_wal_message(msg: WALMessage) -> bytes:
    if isinstance(msg, MsgInfo):
        # The hot variant (one per gossiped vote): assemble with precomputed
        # tags and direct concat — three nested Writer objects per vote were
        # a measurable slice of the receive loop's WAL cost.
        enc = pw.encode_varint
        inner = encode_message(msg.msg)
        peer = msg.peer_id.encode()
        body = (
            (_TAG_PEER + enc(len(peer)) + peer if peer else b"")
            + _TAG_INNER + enc(len(inner)) + inner
        )
        return _TAG_MSGINFO + enc(len(body)) + body
    w = pw.Writer()
    if isinstance(msg, EndHeightMessage):
        w.varint_field(1, msg.height, emit_zero=True)
    elif isinstance(msg, TimeoutInfo):
        body = pw.Writer()
        body.varint_field(1, int(msg.duration_s * 1e9))
        body.varint_field(2, msg.height)
        body.varint_field(3, msg.round)
        body.varint_field(4, msg.step)
        w.message_field(2, body.bytes(), always=True)
    elif isinstance(msg, EventRoundState):
        body = pw.Writer()
        body.varint_field(1, msg.height)
        body.varint_field(2, msg.round)
        body.varint_field(3, msg.step)
        w.message_field(4, body.bytes(), always=True)
    else:
        raise TypeError(f"unknown WAL message {type(msg)}")
    return w.bytes()


def _decode_wal_message(data: bytes) -> WALMessage:
    for f, _, v in pw.Reader(data):
        if f == 1:
            return EndHeightMessage(pw.int64_from_varint(v))
        if f == 2:
            vals = [0, 0, 0, 0]
            for ff, _, vv in pw.Reader(v):
                if 1 <= ff <= 4:
                    vals[ff - 1] = pw.int64_from_varint(vv)
            return TimeoutInfo(vals[0] / 1e9, vals[1], vals[2], vals[3])
        if f == 3:
            peer = ""
            inner = None
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    peer = vv.decode()
                elif ff == 2:
                    inner = decode_message(vv)
            return MsgInfo(inner, peer)
        if f == 4:
            vals = [0, 0, 0]
            for ff, _, vv in pw.Reader(v):
                if 1 <= ff <= 3:
                    vals[ff - 1] = pw.int64_from_varint(vv)
            return EventRoundState(*vals)
    raise ValueError("empty WAL message")


class CorruptedWALError(Exception):
    pass


def wal_files(path: str) -> List[str]:
    """All files of a rotated WAL group, oldest first (….000, …, head)."""
    files = []
    idx = 0
    while os.path.exists(f"{path}.{idx:03d}"):
        files.append(f"{path}.{idx:03d}")
        idx += 1
    if os.path.exists(path):
        files.append(path)
    return files


def iter_wal_messages(path: str, strict: bool = False) -> Iterator[WALMessage]:
    """Decode all messages across a WAL group WITHOUT opening it for append
    (the WAL class constructor writes an EndHeight(0) anchor into fresh
    files — a read-only consumer like tools/wal_inspect.py must never do
    that to a post-mortem artifact). Non-strict mode stops at the first
    corrupted frame (torn write at crash)."""
    for fname in wal_files(path):
        with open(fname, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            if pos + 8 > len(data):
                if strict:
                    raise CorruptedWALError("truncated frame header")
                return
            crc, length = struct.unpack_from(">II", data, pos)
            if length > MAX_MSG_SIZE_BYTES:
                if strict:
                    raise CorruptedWALError("frame too large")
                return
            if pos + 8 + length > len(data):
                if strict:
                    raise CorruptedWALError("truncated frame body")
                return
            body = data[pos + 8 : pos + 8 + length]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                if strict:
                    raise CorruptedWALError("crc mismatch")
                return
            try:
                yield _decode_wal_message(body)
            except ValueError:
                if strict:
                    raise CorruptedWALError("undecodable message")
                return
            pos += 8 + length


class WAL:
    """Size-rotated WAL. Files: <path>, <path>.000, <path>.001 … (rotated
    heads); head is always <path>.

    Group-commit mode (`group_commit=True`): `write()` appends frames to an
    in-memory buffer instead of the file; `flush_buffered()` lands the whole
    buffer as ONE buffered file write. The consensus receive loop calls it
    once per queue drain, so a 512-vote storm batch pays one write syscall
    instead of 512 write+tell round trips (the LMAX/Aurora-style write
    coalescing — CometBFT's v0.38 vote-extension work hit the same per-vote
    wall; note BufferedWriter.tell() in append mode forces a flush, so the
    old per-message `write()` was a hidden syscall per vote).

    fsync policy: `group_commit_max_latency` bounds the AGE of any
    un-fsynced write — a drain whose oldest pending byte has aged past the
    bound fsyncs; younger data rides until a later drain, write_sync, or
    close. On a storm cadence (drains spaced wider than the bound) that is
    exactly one buffered write + one fsync per drain; on dense drains the
    fsyncs coalesce further. The reference's WAL is looser still — plain
    Write never fsyncs and durability comes from a 2s flush ticker
    (reference: consensus/wal.go flushAndSyncTicker). Against MACHINE
    crashes the aged fsync strictly improves on the pre-batching writer
    (which never fsynced peer messages); against a hard PROCESS kill the
    in-process buffer can lose up to one drain of peer frames that the old
    per-message write would have left in the OS page cache — a replay-
    completeness window (bounded by the drain size and the latency bound),
    never a safety one, since self-generated messages fsync inline.

    Remaining semantics are PRESERVED relative to the non-batched writer:
    - `write_sync()` (self-generated messages, EndHeight markers) flushes
      any buffered frames first — ordering is exact — and fsyncs before
      returning, so a self-generated message is never processed un-durably.
    - frames are CRC-framed, so a crash mid-flush tears at a frame boundary
      at worst — replay recovers the clean prefix exactly as before.
    """

    def __init__(
        self,
        path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_GROUP_TOTAL_LIMIT,
        group_commit: bool = False,
        group_commit_max_latency: float = 0.02,
    ):
        self.path = path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self.group_commit = group_commit
        self.group_commit_max_latency = group_commit_max_latency
        self._buf = bytearray()  # frames awaiting the next flush (group mode)
        # perf_counter of the OLDEST write not yet fsynced (buffered in
        # memory or sitting in OS cache) — drives the max-latency bound
        self._dirty_since: Optional[float] = None
        # counts of fsyncs and write calls, for a per-stage breakdown
        self.fsync_count = 0
        self.write_calls = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._fh = open(path, "ab")
        self._flushed = True
        if fresh and len(self._all_files()) <= 1:
            # Empty WAL: mark "height 0 done" so catchup replay after a crash
            # mid-height-1 finds its search anchor (reference: consensus/wal.go
            # OnStart writes EndHeightMessage{0} into an empty group).
            self.write_end_height(0)

    # -- writing ------------------------------------------------------------

    def _frame(self, msg: WALMessage) -> bytes:
        body = _encode_wal_message(msg)
        if len(body) > MAX_MSG_SIZE_BYTES:
            raise ValueError(f"msg is too big: {len(body)} bytes")
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return struct.pack(">II", crc, len(body)) + body

    def write(self, msg: WALMessage) -> None:
        """(reference: consensus/wal.go:184 Write — async, no fsync)"""
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        if hs is None:
            return self._write(msg)
        t0 = _hotstats.perf_counter()
        self._write(msg)
        hs.add("wal", _hotstats.perf_counter() - t0)

    def _write(self, msg: WALMessage) -> None:
        self.write_calls += 1
        frame = self._frame(msg)
        if self.group_commit:
            now = time.perf_counter()
            if self._dirty_since is None:
                self._dirty_since = now
            self._buf += frame
            # bound both staleness and memory: aged un-synced data or an
            # oversized buffer flushes inline instead of waiting for the
            # drain boundary
            if (
                now - self._dirty_since > self.group_commit_max_latency
                or len(self._buf) >= self.head_size_limit
            ):
                # untimed variant: write()'s own hotstats wrapper already
                # covers this inline flush — the timed public method here
                # would double-count the flush into the 'wal' stage
                self._flush_buffered()
            return
        self._fh.write(frame)
        self._flushed = False
        self._maybe_rotate()

    def write_sync(self, msg: WALMessage) -> None:
        """(reference: consensus/wal.go:201 WriteSync — fsync before returning).
        In group-commit mode any buffered frames land first (exact ordering),
        in the same write+fsync."""
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        t0 = _hotstats.perf_counter() if hs is not None else 0.0
        self.write_calls += 1
        frame = self._frame(msg)
        if self.group_commit:
            self._buf += frame
        else:
            self._fh.write(frame)
        self.flush_and_sync()
        self._maybe_rotate()
        if hs is not None:
            hs.add("wal", _hotstats.perf_counter() - t0)

    def flush_buffered(self) -> None:
        """Group-commit boundary (called once per receive-loop queue drain):
        land all buffered frames in ONE buffered write, and fsync iff the
        oldest un-synced write has aged past the max-latency bound. No-op
        when nothing is pending (so callers can invoke it unconditionally
        per queue drain, in either mode)."""
        if self._dirty_since is None and not self._buf:
            return
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        if hs is None:
            return self._flush_buffered()
        t0 = _hotstats.perf_counter()
        self._flush_buffered()
        hs.add("wal", _hotstats.perf_counter() - t0, n=0)

    def _flush_buffered(self) -> None:
        if (
            self._dirty_since is not None
            and time.perf_counter() - self._dirty_since >= self.group_commit_max_latency
        ):
            self.flush_and_sync()
        else:
            self._drain_buffer()
            self._fh.flush()
        self._maybe_rotate()

    def _drain_buffer(self) -> None:
        if self._buf:
            self._fh.write(self._buf)
            del self._buf[:]
            self._flushed = False

    def flush_and_sync(self) -> None:
        self._drain_buffer()
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.fsync_count += 1
        self._dirty_since = None
        self._flushed = True

    def write_end_height(self, height: int) -> None:
        self.write_sync(EndHeightMessage(height))

    def _maybe_rotate(self) -> None:
        if self._fh.tell() < self.head_size_limit:
            return
        self.flush_and_sync()
        self._fh.close()
        # shift: find next rotation index
        idx = 0
        while os.path.exists(f"{self.path}.{idx:03d}"):
            idx += 1
        os.replace(self.path, f"{self.path}.{idx:03d}")
        self._fh = open(self.path, "ab")
        self._enforce_total_limit(idx)

    def _enforce_total_limit(self, latest_idx: int) -> None:
        files = [f"{self.path}.{i:03d}" for i in range(latest_idx + 1)]
        files = [f for f in files if os.path.exists(f)]
        total = sum(os.path.getsize(f) for f in files)
        for f in files:
            if total <= self.total_size_limit:
                break
            total -= os.path.getsize(f)
            os.unlink(f)

    def close(self) -> None:
        try:
            self.flush_and_sync()
        finally:
            self._fh.close()

    # -- reading ------------------------------------------------------------

    def _all_files(self) -> List[str]:
        return wal_files(self.path)

    def iter_messages(self, strict: bool = False) -> Iterator[WALMessage]:
        """Decode all messages across rotated files. Non-strict mode stops at
        the first corrupted frame (torn write at crash). Frames still in the
        group-commit buffer are written through first (no fsync — reading
        back our own writes needs file content, not durability)."""
        self._drain_buffer()
        self._fh.flush()
        yield from iter_wal_messages(self.path, strict=strict)

    def search_for_end_height(self, height: int) -> Optional[List[WALMessage]]:
        """Returns messages AFTER EndHeightMessage(height), or None if the
        marker is absent (reference: consensus/wal.go:231)."""
        found = False
        out: List[WALMessage] = []
        for msg in self.iter_messages():
            if isinstance(msg, EndHeightMessage) and msg.height == height:
                found = True
                out = []
                continue
            if found:
                out.append(msg)
        return out if found else None
