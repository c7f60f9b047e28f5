"""Reactor interface (reference: p2p/base_reactor.go:15).

A reactor owns a set of channels; the Switch routes each received message to
the reactor registered for its channel. Lifecycle: set_switch -> start ->
(add_peer/receive/remove_peer)* -> stop.

The port's copy of tendermint_tpu/p2p/base_reactor.py.
"""

from __future__ import annotations

from typing import List

from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor


class Reactor:
    def __init__(self, name: str):
        self.name = name
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        raise NotImplementedError

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    async def add_peer(self, peer) -> None:
        """Called after the peer is started and registered."""

    async def remove_peer(self, peer, reason) -> None:
        """Called when the peer is stopped (error or disconnect)."""

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        """One complete message from a peer on one of our channels."""
