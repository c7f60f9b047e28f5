"""Authenticated encryption channel upgrade (reference:
p2p/conn/secret_connection.go:92 MakeSecretConnection).

Same construction as the reference's STS protocol: ephemeral X25519 ECDH →
HKDF-SHA256 → two ChaCha20-Poly1305 AEADs (one per direction, chosen by
ephemeral-key sort order) → challenge signed with the node's long-term ed25519
key. Framing: 1024-byte sealed chunks with incrementing 96-bit little-endian
nonces (reference: secret_connection.go:453).

Divergence (documented): the reference binds the handshake with a merlin
(STROBE) transcript; we bind with SHA-256 over a domain-separated transcript
of the same values. Wire compatibility with Go peers is not a goal — the
security properties (key confirmation, MITM binding of the challenge to both
ephemerals and the shared secret) are preserved.

The port's copy of tendermint_tpu/p2p/conn/secret_connection.py, the same
construction byte for byte, so a port node and a reference node handshake
with each other.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives import serialization
    from cryptography.exceptions import InvalidTag

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # minimal containers: plaintext transport only
    # The module stays importable so the transport/switch layer (which only
    # needs SecretConnection for isinstance checks and the opt-in encrypted
    # upgrade) works in plaintext mode (`use_secret_conn=False`) without the
    # wheel, so in-process plaintext nets run everywhere.
    HAVE_CRYPTOGRAPHY = False
    X25519PrivateKey = X25519PublicKey = ChaCha20Poly1305 = serialization = None

    class InvalidTag(Exception):  # type: ignore[no-redef]
        pass


from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
AEAD_TAG_SIZE = 16
TOTAL_FRAME_SIZE = DATA_LEN_SIZE + DATA_MAX_SIZE
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE


class HandshakeError(Exception):
    pass


def _hkdf(secret: bytes) -> tuple[bytes, bytes, bytes]:
    """HKDF-SHA256 -> (recv_secret, send_secret, challenge) for the low party;
    mirrored for the high party (reference: secret_connection.go:343)."""
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    from cryptography.hazmat.primitives import hashes

    okm = HKDF(
        algorithm=hashes.SHA256(),
        length=96,
        salt=None,
        info=b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN",
    ).derive(secret)
    return okm[0:32], okm[32:64], okm[64:96]


@dataclass
class _Nonce:
    """96-bit little-endian counter nonce, incremented per frame."""

    counter: int = 0

    def use(self) -> bytes:
        n = struct.pack("<Q", self.counter) + b"\x00\x00\x00\x00"
        self.counter += 1
        if self.counter >= 1 << 64:
            raise OverflowError("nonce exhausted")
        return n


class SecretConnection:
    """Wraps an asyncio (reader, writer) pair after the handshake."""

    def __init__(self, reader, writer, send_aead, recv_aead, remote_pubkey: Ed25519PubKey):
        self._reader = reader
        self._writer = writer
        self._send = send_aead
        self._recv = recv_aead
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""

    # -- handshake ---------------------------------------------------------

    @classmethod
    async def upgrade(cls, reader, writer, priv_key: Ed25519PrivKey) -> "SecretConnection":
        """(reference: secret_connection.go:92 MakeSecretConnection)"""
        if not HAVE_CRYPTOGRAPHY:
            raise ImportError(
                "secret connection requires the `cryptography` wheel "
                "(use plaintext transport for in-process tests)"
            )
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )

        writer.write(struct.pack(">I", len(eph_pub)) + eph_pub)
        await writer.drain()
        hdr = await reader.readexactly(4)
        (ln,) = struct.unpack(">I", hdr)
        if ln != 32:
            raise HandshakeError("bad ephemeral key length")
        remote_eph = await reader.readexactly(32)

        try:
            # cryptography raises on an all-zero shared secret (low-order /
            # small-subgroup ephemeral — an evil peer forcing a known key)
            shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(remote_eph))
        except ValueError as e:
            raise HandshakeError(f"bad ephemeral point: {e}") from e

        low_is_us = eph_pub < remote_eph
        lo, hi = (eph_pub, remote_eph) if low_is_us else (remote_eph, eph_pub)
        recv_secret, send_secret, challenge_lo = _hkdf(shared + lo + hi)
        if low_is_us:
            send_key, recv_key = send_secret, recv_secret
        else:
            send_key, recv_key = recv_secret, send_secret

        # Transcript binding: challenge covers both ephemerals + shared secret.
        transcript = hashlib.sha256(
            b"TMTPU_SECRET_CONNECTION_TRANSCRIPT" + lo + hi + challenge_lo
        ).digest()

        conn = cls(
            reader, writer, ChaCha20Poly1305(send_key), ChaCha20Poly1305(recv_key), None
        )

        # Exchange authenticated (pubkey, sig-over-transcript) over the
        # now-encrypted channel (reference: secret_connection.go shareAuthSignature).
        local_pub = priv_key.pub_key()
        sig = priv_key.sign(transcript)
        await conn.write_msg(local_pub.bytes() + sig)
        auth = await conn.read_msg()
        if len(auth) != 32 + 64:
            raise HandshakeError("bad auth message size")
        remote_pub = Ed25519PubKey(auth[:32])
        if not remote_pub.verify(transcript, auth[32:]):
            raise HandshakeError("challenge signature verification failed")
        conn.remote_pubkey = remote_pub
        return conn

    # -- framed encrypted I/O ----------------------------------------------

    async def write(self, data: bytes) -> None:
        """Split into <=1024B frames, seal each (reference: :453 Write)."""
        off = 0
        out = bytearray()
        while True:
            chunk = data[off : off + DATA_MAX_SIZE]
            frame = struct.pack("<I", len(chunk)) + chunk
            frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
            out += self._send.encrypt(self._send_nonce.use(), bytes(frame), None)
            off += DATA_MAX_SIZE
            if off >= len(data):
                break
        self._writer.write(bytes(out))
        await self._writer.drain()

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        try:
            frame = self._recv.decrypt(self._recv_nonce.use(), sealed, None)
        except InvalidTag as e:
            raise HandshakeError("frame decryption failed") from e
        (ln,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if ln > DATA_MAX_SIZE:
            raise HandshakeError("frame length too large")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + ln]

    async def read(self, n: int) -> bytes:
        """Read exactly n plaintext bytes."""
        while len(self._recv_buf) < n:
            self._recv_buf += await self._read_frame()
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    # -- length-prefixed messages over the frames --------------------------

    async def write_msg(self, msg: bytes) -> None:
        await self.write(struct.pack(">I", len(msg)) + msg)

    async def read_msg(self, max_size: int = 1 << 22) -> bytes:
        hdr = await self.read(4)
        (ln,) = struct.unpack(">I", hdr)
        if ln > max_size:
            raise HandshakeError("message too large")
        return await self.read(ln)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


class SyncSecretConnection:
    """Blocking-socket variant of SecretConnection — same STS construction,
    same framing — for threaded endpoints (the privval remote signer). One
    instance is NOT thread-safe; serialize calls externally."""

    def __init__(self, sock, send_aead, recv_aead, remote_pubkey):
        self._sock = sock
        self._send = send_aead
        self._recv = recv_aead
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""

    @classmethod
    def upgrade(cls, sock, priv_key: Ed25519PrivKey) -> "SyncSecretConnection":
        if not HAVE_CRYPTOGRAPHY:
            raise ImportError(
                "secret connection requires the `cryptography` wheel"
            )
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        sock.sendall(struct.pack(">I", len(eph_pub)) + eph_pub)
        (ln,) = struct.unpack(">I", _recv_exact(sock, 4))
        if ln != 32:
            raise HandshakeError("bad ephemeral key length")
        remote_eph = _recv_exact(sock, 32)

        try:
            # see async upgrade: low-order ephemeral -> all-zero shared secret
            shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(remote_eph))
        except ValueError as e:
            raise HandshakeError(f"bad ephemeral point: {e}") from e
        low_is_us = eph_pub < remote_eph
        lo, hi = (eph_pub, remote_eph) if low_is_us else (remote_eph, eph_pub)
        recv_secret, send_secret, challenge_lo = _hkdf(shared + lo + hi)
        if low_is_us:
            send_key, recv_key = send_secret, recv_secret
        else:
            send_key, recv_key = recv_secret, send_secret
        transcript = hashlib.sha256(
            b"TMTPU_SECRET_CONNECTION_TRANSCRIPT" + lo + hi + challenge_lo
        ).digest()

        conn = cls(sock, ChaCha20Poly1305(send_key), ChaCha20Poly1305(recv_key), None)
        local_pub = priv_key.pub_key()
        conn.write_msg(local_pub.bytes() + priv_key.sign(transcript))
        auth = conn.read_msg()
        if len(auth) != 32 + 64:
            raise HandshakeError("bad auth message size")
        remote_pub = Ed25519PubKey(auth[:32])
        if not remote_pub.verify(transcript, auth[32:]):
            raise HandshakeError("challenge signature verification failed")
        conn.remote_pubkey = remote_pub
        return conn

    def write(self, data: bytes) -> None:
        off = 0
        out = bytearray()
        while True:
            chunk = data[off : off + DATA_MAX_SIZE]
            frame = struct.pack("<I", len(chunk)) + chunk
            frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
            out += self._send.encrypt(self._send_nonce.use(), bytes(frame), None)
            off += DATA_MAX_SIZE
            if off >= len(data):
                break
        self._sock.sendall(bytes(out))

    def read(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            sealed = _recv_exact(self._sock, SEALED_FRAME_SIZE)
            try:
                frame = self._recv.decrypt(self._recv_nonce.use(), sealed, None)
            except InvalidTag as e:
                raise HandshakeError("frame decryption failed") from e
            (ln,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
            if ln > DATA_MAX_SIZE:
                raise HandshakeError("frame length too large")
            self._recv_buf += frame[DATA_LEN_SIZE : DATA_LEN_SIZE + ln]
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    def write_msg(self, msg: bytes) -> None:
        self.write(struct.pack(">I", len(msg)) + msg)

    def read_msg(self, max_size: int = 1 << 22) -> bytes:
        (ln,) = struct.unpack(">I", self.read(4))
        if ln > max_size:
            raise HandshakeError("message too large")
        return self.read(ln)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise HandshakeError("connection closed during secret handshake")
        buf += chunk
    return buf
