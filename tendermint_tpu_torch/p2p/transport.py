"""MultiplexTransport: listen/dial TCP + connection upgrade
(reference: p2p/transport.go:135,190,208,246).

upgrade = secret-connection handshake (unless plaintext is configured for
in-process tests) + NodeInfo exchange + compatibility/identity filters
(reference: p2p/transport.go:389-429).

The port's copy of tendermint_tpu/p2p/transport.py.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

from tendermint_tpu_torch.p2p.conn.secret_connection import SecretConnection
from tendermint_tpu_torch.p2p.conn.connection import StreamTransport
from tendermint_tpu_torch.p2p.key import NodeKey, pubkey_to_id
from tendermint_tpu_torch.p2p.node_info import NodeInfo, parse_addr

logger = logging.getLogger("tendermint_tpu_torch.p2p")

HANDSHAKE_TIMEOUT = 20.0


class TransportError(Exception):
    pass


@dataclass
class Connection:
    """An upgraded connection ready to be wrapped in an MConnection."""

    transport: object  # SecretConnection or StreamTransport
    node_info: NodeInfo
    outbound: bool
    socket_addr: str


class MultiplexTransport:
    def __init__(self, node_key: NodeKey, node_info: NodeInfo, use_secret_conn: bool = True,
                 fuzz_config=None):
        self.node_key = node_key
        self.node_info = node_info
        self.use_secret_conn = use_secret_conn
        # adversarial I/O injection for tests (reference: p2p/fuzz.go wired
        # via config TestFuzz); wraps every upgraded stream when set
        self.fuzz_config = fuzz_config
        # per-connection ordinal for deterministic fuzz: with a seeded
        # FuzzConfig the i-th upgraded connection always gets the SAME rng
        # stream (seed*M + i), so a fuzz run replays from its seed even
        # with several concurrent connections (each has its own rng)
        self._fuzz_conn_ordinal = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._accept_queue: asyncio.Queue = asyncio.Queue(maxsize=64)
        self.listen_addr = ""

    # -- listening ---------------------------------------------------------

    async def listen(self, host: str, port: int) -> str:
        async def on_conn(reader, writer):
            peername = writer.get_extra_info("peername")
            addr = f"{peername[0]}:{peername[1]}" if peername else "?"
            try:
                conn = await asyncio.wait_for(
                    self._upgrade(reader, writer, outbound=False, expect_id=""),
                    HANDSHAKE_TIMEOUT,
                )
                conn.socket_addr = addr
                await self._accept_queue.put(conn)
            except Exception as e:
                logger.debug("inbound upgrade from %s failed: %s", addr, e)
                writer.close()

        self._server = await asyncio.start_server(on_conn, host, port)
        sock = self._server.sockets[0].getsockname()
        self.listen_addr = f"{sock[0]}:{sock[1]}"
        return self.listen_addr

    async def accept(self) -> Connection:
        return await self._accept_queue.get()

    async def close(self) -> None:
        if self._server:
            self._server.close()
            try:
                # Python 3.12 wait_closed blocks until every connection is
                # closed; peers may still be tearing down — bound the wait.
                await asyncio.wait_for(self._server.wait_closed(), 1.0)
            except Exception:
                pass

    # -- dialing -----------------------------------------------------------

    async def dial(self, addr: str) -> Connection:
        """addr: 'id@host:port' (id optional but checked when present)."""
        expect_id, host, port = parse_addr(addr)
        reader, writer = await asyncio.open_connection(host, port)
        try:
            conn = await asyncio.wait_for(
                self._upgrade(reader, writer, outbound=True, expect_id=expect_id),
                HANDSHAKE_TIMEOUT,
            )
        except Exception:
            writer.close()
            raise
        conn.socket_addr = f"{host}:{port}"
        return conn

    # -- upgrade -----------------------------------------------------------

    async def _upgrade(self, reader, writer, outbound: bool, expect_id: str) -> Connection:
        if self.use_secret_conn:
            sc = await SecretConnection.upgrade(reader, writer, self.node_key.priv_key)
            transport = sc
            authenticated_id = pubkey_to_id(sc.remote_pubkey)
        else:
            transport = StreamTransport(reader, writer)
            authenticated_id = ""

        # NodeInfo exchange: one length-prefixed message each way.
        ni_bytes = self.node_info.encode()
        await _write_msg(transport, ni_bytes)
        peer_ni = NodeInfo.decode(await _read_msg(transport))
        peer_ni.validate_basic()

        if authenticated_id and peer_ni.node_id != authenticated_id:
            raise TransportError(
                f"peer NodeInfo id {peer_ni.node_id} != authenticated id {authenticated_id}"
            )
        if expect_id and peer_ni.node_id != expect_id:
            raise TransportError(f"dialed {expect_id} but got {peer_ni.node_id}")
        if peer_ni.node_id == self.node_info.node_id:
            raise TransportError("connected to self")
        self.node_info.compatible_with(peer_ni)
        if self.fuzz_config is not None:
            import random

            from tendermint_tpu_torch.p2p.fuzz import FuzzedConnection

            rng = None
            if getattr(self.fuzz_config, "seed", 0):
                self._fuzz_conn_ordinal += 1
                # int-derived seed (NOT a tuple: tuple seeding goes through
                # PYTHONHASHSEED-randomized hash() and would not replay)
                rng = random.Random(
                    self.fuzz_config.seed * 1_000_003 + self._fuzz_conn_ordinal
                )
            transport = FuzzedConnection(transport, self.fuzz_config, rng=rng)
        return Connection(transport, peer_ni, outbound, "")


async def _write_msg(transport, msg: bytes) -> None:
    if isinstance(transport, SecretConnection):
        await transport.write_msg(msg)
    else:
        await transport.write(struct.pack(">I", len(msg)) + msg)


async def _read_msg(transport, max_size: int = 1 << 20) -> bytes:
    if isinstance(transport, SecretConnection):
        return await transport.read_msg(max_size)
    hdr = await transport.read(4)
    (ln,) = struct.unpack(">I", hdr)
    if ln > max_size:
        raise TransportError("message too large")
    return await transport.read(ln)
