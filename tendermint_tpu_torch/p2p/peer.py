"""Peer: a connected remote node (reference: p2p/peer.go), and PeerSet
(reference: p2p/peer_set.go).

The port's copy of tendermint_tpu/p2p/peer.py, with one difference that
follows Go (p2p/peer.go Send / TrySend, hasChannel): a message on a channel
the peer's NodeInfo does not list is not sent (False), since the far side's
MConnection stops the connection on an unknown channel. The reference sends
it, so its active statesync reactor drops every peer without channel 0x60
(ROADMAP C).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from tendermint_tpu_torch.p2p.conn.connection import MConnection
from tendermint_tpu_torch.p2p.node_info import NodeInfo


class Peer:
    def __init__(
        self,
        node_info: NodeInfo,
        mconn: MConnection,
        outbound: bool,
        persistent: bool = False,
        socket_addr: str = "",
        metrics=None,
    ):
        self.metrics = metrics
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr
        self._data: Dict[str, object] = {}  # reactor-attached state (PeerState)

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def has_channel(self, chan_id: int) -> bool:
        """True when the peer advertises chan_id (a NodeInfo with no channel
        list, as in tests, accepts any)."""
        chans = self.node_info.channels
        return not chans or chan_id in chans

    async def send(self, chan_id: int, msg: bytes) -> bool:
        if not self.has_channel(chan_id):
            return False
        if self.metrics is not None:
            self.metrics.peer_send_bytes_total.labels(f"{chan_id:#x}").inc(len(msg))
        return await self.mconn.send(chan_id, msg)

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if not self.has_channel(chan_id):
            return False
        return self.mconn.try_send(chan_id, msg)

    def status(self) -> dict:
        """Per-connection flowrate/queue snapshot (reference: p2p/peer.go
        Status -> ConnectionStatus); surfaced in net_info."""
        return self.mconn.status()

    def clock_skew(self):
        """Estimated remote-minus-local wall-clock offset (seconds) from the
        connection's timestamped ping/pong, or None before the first sample."""
        return self.mconn.clock_skew()

    def set(self, key: str, value) -> None:
        self._data[key] = value

    def get(self, key: str):
        return self._data.get(key)

    async def stop(self) -> None:
        await self.mconn.stop()

    def __repr__(self) -> str:
        return f"Peer({self.id[:10]}, {'out' if self.outbound else 'in'})"


class PeerSet:
    def __init__(self):
        self._peers: Dict[str, Peer] = {}

    def add(self, peer: Peer) -> None:
        if peer.id in self._peers:
            raise ValueError(f"duplicate peer {peer.id}")
        self._peers[peer.id] = peer

    def has(self, peer_id: str) -> bool:
        return peer_id in self._peers

    def get(self, peer_id: str) -> Optional[Peer]:
        return self._peers.get(peer_id)

    def remove(self, peer_id: str) -> Optional[Peer]:
        return self._peers.pop(peer_id, None)

    def list(self) -> List[Peer]:
        return list(self._peers.values())

    def size(self) -> int:
        return len(self._peers)
