"""Merlin transcripts over STROBE-128 / keccak-f[1600], for sr25519.

The port's own copy of tendermint_tpu/crypto/merlin.py: keccak_f1600,
Strobe128 and Transcript, written from the public Merlin and STROBE
specifications (schnorrkel binds its signatures with merlin transcripts).
Only the operations sr25519 verification and signing need are implemented:
meta-AD, AD and PRF. BatchTranscript runs N transcripts in lockstep with
numpy, for the sr25519 challenges of the one-MSM mixed flush
(crypto/batch.py).
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# keccak-f[1600]
# ---------------------------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    lanes = list(struct.unpack("<25Q", state))
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & _MASK & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    out = [a[x][y] for y in range(5) for x in range(5)]
    state[:] = struct.pack("<25Q", *out)


# ---------------------------------------------------------------------------
# STROBE-128
# ---------------------------------------------------------------------------

STROBE_R = 166  # sponge rate for 128-bit security over keccak-f[1600]

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        self.state[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        self.state[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continuation")
            return
        if flags & _FLAG_T:
            raise ValueError("transport not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c


class Transcript:
    """Merlin transcript (public spec; merlin.cool)."""

    def __init__(self, label: bytes, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n)

    def clone(self) -> "Transcript":
        return Transcript(b"", _strobe=self.strobe.clone())


# ---------------------------------------------------------------------------
# Batched transcripts: N independent STROBE states advanced in lockstep with
# numpy (a vectorized keccak-f[1600]). Valid when every row runs the same
# operation sequence with the same lengths: the sr25519 challenge derivation,
# where the per-row data (message, key, R) varies but the labels and, grouped
# by message length, the sizes do not.


def keccak_f1600_batch(lanes: np.ndarray) -> np.ndarray:
    """lanes: (N, 25) uint64 -> permuted (N, 25); column x + 5*y."""

    def rotl(v, n):
        if n == 0:
            return v
        return (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    a = [lanes[:, i].copy() for i in range(25)]
    for rc in _ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], _ROTC[x][y])
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
        a[0] ^= np.uint64(rc)
    return np.stack(a, axis=1)


class BatchStrobe128:
    """N STROBE-128 states in lockstep (position and flags shared)."""

    def __init__(self, protocol_label: bytes, n: int):
        self.n = n
        init = bytearray(200)
        init[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        init[6:18] = b"STROBEv1.0.2"
        keccak_f1600(init)
        self.state = np.tile(np.frombuffer(bytes(init), dtype=np.uint8), (n, 1))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[:, self.pos] ^= self.pos_begin
        self.state[:, self.pos + 1] ^= 0x04
        self.state[:, STROBE_R + 1] ^= 0x80
        lanes = self.state.view(np.uint64).reshape(self.n, 25)
        self.state = keccak_f1600_batch(lanes).view(np.uint8).reshape(self.n, 200).copy()
        self.pos = 0
        self.pos_begin = 0

    def _as_rows(self, data) -> np.ndarray:
        """bytes (shared by every row) or an (N, L) uint8 array -> (N, L)."""
        if isinstance(data, (bytes, bytearray)):
            return np.tile(np.frombuffer(bytes(data), np.uint8), (self.n, 1))
        return data

    def _absorb(self, data) -> None:
        rows = self._as_rows(data)
        off = 0
        total = rows.shape[1]
        while off < total:
            k = min(STROBE_R - self.pos, total - off)
            self.state[:, self.pos : self.pos + k] ^= rows[:, off : off + k]
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n_bytes: int) -> np.ndarray:
        out = np.empty((self.n, n_bytes), dtype=np.uint8)
        off = 0
        while off < n_bytes:
            k = min(STROBE_R - self.pos, n_bytes - off)
            out[:, off : off + k] = self.state[:, self.pos : self.pos + k]
            self.state[:, self.pos : self.pos + k] = 0
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()
        return out

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continuation")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n_bytes: int, more: bool = False) -> np.ndarray:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n_bytes)


class BatchTranscript:
    """Merlin transcripts in lockstep; the rows of one message share its
    length."""

    def __init__(self, label: bytes, n: int):
        self.strobe = BatchStrobe128(b"Merlin v1.0", n)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, messages) -> None:
        """messages: bytes shared by every row, or an (N, L) uint8 array."""
        rows = self.strobe._as_rows(messages)
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", rows.shape[1]), True)
        self.strobe.ad(rows, False)

    def challenge_bytes(self, label: bytes, n_bytes: int) -> np.ndarray:
        """-> (N, n_bytes) uint8."""
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n_bytes), True)
        return self.strobe.prf(n_bytes)
