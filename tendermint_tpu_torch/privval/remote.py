"""Remote signer: PrivValidator over a socket; the port's copy of
tendermint_tpu/privval/remote.py, byte-compatible on the wire with it.

reference: privval/signer_client.go:16 (SignerClient), signer_server.go:18
(SignerServer), msgs.go (message envelope), signer_endpoint.go (framing),
proto/tendermint/privval/types.proto.

Framing: 4-byte big-endian length prefix + protowire envelope. The client is
deliberately BLOCKING (the reference's SignerClient is too): consensus signs
at most one vote/proposal at a time, and the loopback round-trip is far below
the consensus step timeouts. The server runs in its own thread (standing in
for the external signer process, e.g. a tmkms-style HSM host).

Authentication: when the server has an authorized-keys allowlist, every
connection is upgraded to a SyncSecretConnection (X25519+HKDF+
ChaCha20-Poly1305, ed25519 transcript signatures — the same STS construction
the reference wraps tcp:// privval in). The session is MAC'd end to end, so
an on-path attacker can neither splice the handshake nor inject sign
requests into an authenticated stream.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Optional

from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.privval.file_pv import DoubleSignError, FilePV
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

logger = logging.getLogger("tendermint_tpu_torch.privval")

# envelope fields (reference: proto/tendermint/privval/types.proto Message)
F_PUBKEY_REQ = 1
F_PUBKEY_RESP = 2
F_SIGN_VOTE_REQ = 3
F_SIGNED_VOTE_RESP = 4
F_SIGN_PROPOSAL_REQ = 5
F_SIGNED_PROPOSAL_RESP = 6
F_PING_REQ = 7
F_PING_RESP = 8

# RemoteSignerError codes (reference: privval/errors.go)
ERR_DOUBLE_SIGN = 1
ERR_GENERIC = 2


class RemoteSignerError(Exception):
    def __init__(self, code: int, description: str):
        self.code = code
        self.description = description
        super().__init__(f"remote signer error (code {code}): {description}")


def _err_body(code: int, description: str) -> bytes:
    w = pw.Writer()
    w.varint_field(1, code)
    w.string_field(2, description)
    return w.bytes()


def _parse_err(data: bytes) -> RemoteSignerError:
    code = 0
    desc = ""
    for f, _, v in pw.Reader(data):
        if f == 1:
            code = v
        elif f == 2:
            desc = v.decode("utf-8", "replace")
    return RemoteSignerError(code, desc)


def _envelope(field: int, body: bytes) -> bytes:
    w = pw.Writer()
    w.message_field(field, body, always=True)
    payload = w.bytes()
    return struct.pack(">I", len(payload)) + payload


class _RawIO:
    """Plain-socket transport."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def sendall(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("privval connection closed")
            buf += chunk
        return buf


class _SecretIO:
    """SyncSecretConnection transport (authenticated + MAC'd). Stream-level
    failures surface as ConnectionError so the caller's reconnect logic
    treats them like any dropped socket."""

    def __init__(self, sconn):
        self.sconn = sconn

    def sendall(self, data: bytes) -> None:
        self.sconn.write(data)

    def recv_exact(self, n: int) -> bytes:
        from tendermint_tpu_torch.p2p.conn.secret_connection import HandshakeError

        try:
            return self.sconn.read(n)
        except HandshakeError as e:
            raise ConnectionError(str(e)) from e


def _read_frame(io) -> bytes:
    hdr = io.recv_exact(4)
    (n,) = struct.unpack(">I", hdr)
    if n > 1 << 20:
        raise ValueError(f"privval frame too large: {n}")
    return io.recv_exact(n)


def _decode_envelope(payload: bytes):
    for f, _, v in pw.Reader(payload):
        return f, v
    raise ValueError("empty privval message")


class SignerServer:
    """Serves a FilePV over a listening socket in a background thread
    (reference: privval/signer_server.go:18 + signer_listener_endpoint; the
    dial direction is inverted — we listen, the node dials — matching the
    reference's tcp:// SignerListenerEndpoint topology from the node's view).

    All signing serializes on one lock: FilePV's double-sign guard is
    check-then-act, so concurrent connections must never race it.

    authorized_keys: optional list of client PubKeys. When set, each
    connection is upgraded to a SyncSecretConnection and the client's
    transcript-signing key must be on the allowlist — this closes the
    signing-oracle hole when the socket is reachable beyond loopback.
    identity_key: the server's ed25519 identity for the handshake (NOT the
    validator key; generated if omitted)."""

    def __init__(self, pv: FilePV, chain_id: str, host: str = "127.0.0.1", port: int = 0,
                 authorized_keys=None, identity_key=None):
        self.pv = pv
        self.chain_id = chain_id
        self.authorized_keys = list(authorized_keys or [])
        if identity_key is None:
            from tendermint_tpu_torch.crypto.keys import gen_ed25519

            identity_key = gen_ed25519()
        self.identity_key = identity_key
        if not self.authorized_keys and host not in ("127.0.0.1", "::1", "localhost"):
            logger.warning(
                "privval signer listening on %s WITHOUT client authentication — "
                "anyone who can reach this port can request signatures", host
            )
        self._lock = threading.Lock()
        self._listener = socket.create_server((host, port))
        self.addr = self._listener.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True, name="signer-server")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            io = self._upgrade(conn)
            if io is None:
                return
            while not self._stop.is_set():
                try:
                    payload = _read_frame(io)
                except (ConnectionError, OSError, ValueError) as e:
                    if not isinstance(e, ConnectionError):
                        logger.info("privval connection error: %s", e)
                    return
                try:
                    resp = self._dispatch(payload)
                except Exception as e:  # never kill the loop on one bad msg
                    logger.exception("signer dispatch failed")
                    # report in the response type matching the request so the
                    # client surfaces the description instead of a field error
                    try:
                        field, _ = _decode_envelope(payload)
                    except ValueError:
                        field = F_PING_REQ
                    resp_field = {
                        F_SIGN_VOTE_REQ: F_SIGNED_VOTE_RESP,
                        F_SIGN_PROPOSAL_REQ: F_SIGNED_PROPOSAL_RESP,
                        F_PUBKEY_REQ: F_PUBKEY_RESP,
                    }.get(field, F_PING_RESP)
                    resp = _envelope(resp_field, self._err_resp(ERR_GENERIC, e))
                try:
                    io.sendall(resp)
                except OSError:
                    return

    def _upgrade(self, conn: socket.socket):
        """Plain transport, or a SecretConnection whose remote key must be on
        the allowlist (reference: tcp:// privval wraps in SecretConnection)."""
        if not self.authorized_keys:
            return _RawIO(conn)
        from tendermint_tpu_torch.p2p.conn.secret_connection import (
            HandshakeError,
            SyncSecretConnection,
        )

        try:
            sconn = SyncSecretConnection.upgrade(conn, self.identity_key)
        except (HandshakeError, ConnectionError, OSError) as e:
            logger.warning("privval secret handshake failed: %s", e)
            return None
        allowed = {k.bytes() for k in self.authorized_keys}
        if sconn.remote_pubkey.bytes() not in allowed:
            logger.warning("privval client key not on the allowlist")
            return None
        return _SecretIO(sconn)

    def _dispatch(self, payload: bytes) -> bytes:
        with self._lock:
            return self._dispatch_locked(payload)

    def _dispatch_locked(self, payload: bytes) -> bytes:
        field, body = _decode_envelope(payload)
        if field == F_PING_REQ:
            return _envelope(F_PING_RESP, b"")
        if field == F_PUBKEY_REQ:
            pub = self.pv.get_pub_key()
            w = pw.Writer()
            w.string_field(1, pub.type_name())
            w.bytes_field(2, pub.bytes())
            return _envelope(F_PUBKEY_RESP, w.bytes())
        if field == F_SIGN_VOTE_REQ:
            vote = chain_id = None
            for f, _, v in pw.Reader(body):
                if f == 1:
                    vote = Vote.decode(v)
                elif f == 2:
                    chain_id = v.decode("utf-8")
            # Reject chain-ID mismatches outright (reference:
            # privval/signer_requestHandler.go:46): signing with a
            # client-supplied chain ID would turn the signer into a
            # cross-chain signing oracle, since the double-sign guard keys
            # only on HRS + sign-bytes.
            if chain_id is not None and chain_id != self.chain_id:
                return _envelope(
                    F_SIGNED_VOTE_RESP,
                    self._err_resp(
                        ERR_GENERIC, f"want chainID: {self.chain_id}, got chainID: {chain_id}"
                    ),
                )
            try:
                signed = self.pv.sign_vote(self.chain_id, vote)
            except DoubleSignError as e:
                return _envelope(F_SIGNED_VOTE_RESP, self._err_resp(ERR_DOUBLE_SIGN, e))
            except Exception as e:
                return _envelope(F_SIGNED_VOTE_RESP, self._err_resp(ERR_GENERIC, e))
            w = pw.Writer()
            w.message_field(1, signed.encode(), always=True)
            return _envelope(F_SIGNED_VOTE_RESP, w.bytes())
        if field == F_SIGN_PROPOSAL_REQ:
            prop = chain_id = None
            for f, _, v in pw.Reader(body):
                if f == 1:
                    prop = Proposal.decode(v)
                elif f == 2:
                    chain_id = v.decode("utf-8")
            if chain_id is not None and chain_id != self.chain_id:
                return _envelope(
                    F_SIGNED_PROPOSAL_RESP,
                    self._err_resp(
                        ERR_GENERIC, f"want chainID: {self.chain_id}, got chainID: {chain_id}"
                    ),
                )
            try:
                signed = self.pv.sign_proposal(self.chain_id, prop)
            except DoubleSignError as e:
                return _envelope(F_SIGNED_PROPOSAL_RESP, self._err_resp(ERR_DOUBLE_SIGN, e))
            except Exception as e:
                return _envelope(F_SIGNED_PROPOSAL_RESP, self._err_resp(ERR_GENERIC, e))
            w = pw.Writer()
            w.message_field(1, signed.encode(), always=True)
            return _envelope(F_SIGNED_PROPOSAL_RESP, w.bytes())
        raise ValueError(f"unknown privval request field {field}")

    @staticmethod
    def _err_resp(code: int, e: Exception) -> bytes:
        w = pw.Writer()
        w.message_field(2, _err_body(code, str(e)), always=True)
        return w.bytes()


class SignerClient:
    """PrivValidator that signs via a remote SignerServer
    (reference: privval/signer_client.go:16).

    auth_key: node PrivKey identifying this client in the secret-connection
    handshake, required when the server runs an authorized-keys allowlist.
    server_pubkey: optional expected server identity (pinning).
    dial_retry: keep retrying the INITIAL dial for this many seconds (the
    signer process may come up after the node — reference:
    createAndStartPrivValidatorSocketClient retry loop). Reconnects after a
    broken pipe are single-shot so a dead signer fails fast."""

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 auth_key=None, server_pubkey=None, dial_retry: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.auth_key = auth_key
        self.server_pubkey = server_pubkey
        self.dial_retry = dial_retry
        self._io = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._pub_key = None
        self._connected_once = False

    def _connect(self):
        if self._io is None:
            import time as _time

            retry_window = 0.0 if self._connected_once else self.dial_retry
            deadline = _time.monotonic() + retry_window
            while True:
                try:
                    self._sock = socket.create_connection(
                        (self.host, self.port), timeout=self.timeout
                    )
                    break
                except OSError:
                    if _time.monotonic() >= deadline:
                        raise
                    _time.sleep(0.25)
            self._connected_once = True
            if self.auth_key is not None:
                from tendermint_tpu_torch.p2p.conn.secret_connection import (
                    HandshakeError,
                    SyncSecretConnection,
                )

                try:
                    sconn = SyncSecretConnection.upgrade(self._sock, self.auth_key)
                except HandshakeError as e:
                    self.close()
                    raise ConnectionError(f"privval secret handshake failed: {e}") from e
                if (
                    self.server_pubkey is not None
                    and sconn.remote_pubkey.bytes() != self.server_pubkey.bytes()
                ):
                    self.close()
                    raise ConnectionError("privval server identity mismatch")
                self._io = _SecretIO(sconn)
            else:
                self._io = _RawIO(self._sock)
        return self._io

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._io = None

    def _call(self, field: int, body: bytes, want: int) -> bytes:
        with self._lock:
            for attempt in (0, 1):  # one reconnect on a broken pipe
                try:
                    io = self._connect()
                    io.sendall(_envelope(field, body))
                    payload = _read_frame(io)
                    break
                except ValueError:
                    # framing/MAC violation (HandshakeError subclasses
                    # ValueError-adjacent paths raise here too): the stream is
                    # desynchronized — never reuse this socket
                    self.close()
                    raise
                except (ConnectionError, OSError):
                    self.close()
                    if attempt:
                        raise
                except Exception:
                    self.close()
                    raise
        got, resp = _decode_envelope(payload)
        if got != want:
            raise RemoteSignerError(ERR_GENERIC, f"unexpected response field {got}, want {want}")
        return resp

    def ping(self) -> None:
        self._call(F_PING_REQ, b"", F_PING_RESP)

    # -- PrivValidator interface -------------------------------------------

    def get_pub_key(self):
        if self._pub_key is None:
            resp = self._call(F_PUBKEY_REQ, b"", F_PUBKEY_RESP)
            type_name = "ed25519"
            data = b""
            for f, _, v in pw.Reader(resp):
                if f == 1:
                    type_name = v.decode("utf-8")
                elif f == 2:
                    data = v
            self._pub_key = pubkey_from_type_and_bytes(type_name, data)
        return self._pub_key

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        w = pw.Writer()
        w.message_field(1, vote.encode(), always=True)
        w.string_field(2, chain_id)
        resp = self._call(F_SIGN_VOTE_REQ, w.bytes(), F_SIGNED_VOTE_RESP)
        signed = err = None
        for f, _, v in pw.Reader(resp):
            if f == 1:
                signed = Vote.decode(v)
            elif f == 2:
                err = _parse_err(v)
        if err is not None:
            if err.code == ERR_DOUBLE_SIGN:
                raise DoubleSignError(err.description)
            raise err
        if signed is None:
            raise RemoteSignerError(ERR_GENERIC, "empty sign response")
        return signed

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        w = pw.Writer()
        w.message_field(1, proposal.encode(), always=True)
        w.string_field(2, chain_id)
        resp = self._call(F_SIGN_PROPOSAL_REQ, w.bytes(), F_SIGNED_PROPOSAL_RESP)
        signed = err = None
        for f, _, v in pw.Reader(resp):
            if f == 1:
                signed = Proposal.decode(v)
            elif f == 2:
                err = _parse_err(v)
        if err is not None:
            if err.code == ERR_DOUBLE_SIGN:
                raise DoubleSignError(err.description)
            raise err
        if signed is None:
            raise RemoteSignerError(ERR_GENERIC, "empty sign response")
        return signed
