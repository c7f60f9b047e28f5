"""Switch: owns reactors and peers, routes channels, handles the peer
lifecycle (reference: p2p/switch.go:68).

accept_routine takes upgraded connections from the transport; add_peer wires
an MConnection whose on_receive dispatches to the reactor registered for the
channel (reference: p2p/switch.go:157 AddReactor, :788 addPeer). Persistent
peers are re-dialed with exponential backoff (reference: :379 reconnectToPeer).

The port's copy of tendermint_tpu/p2p/switch.py.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Dict, List, Optional

from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.node_info import parse_addr
from tendermint_tpu_torch.p2p.peer import Peer, PeerSet
from tendermint_tpu_torch.p2p.transport import Connection, MultiplexTransport

logger = logging.getLogger("tendermint_tpu_torch.p2p")

RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_DELAY = 0.5


class Switch:
    def __init__(
        self,
        transport: MultiplexTransport,
        max_peers: int = 50,
        metrics=None,
        trust_store_path: str | None = None,
        recv_limit=None,
    ):
        from tendermint_tpu_torch.p2p.behaviour import Reporter, TrustStore

        self.metrics = metrics
        # trust metrics survive restarts when a store path is configured
        # (reference: p2p/trust/store.go; saved periodically + on stop)
        self.reporter = Reporter(
            self, store=TrustStore(trust_store_path) if trust_store_path else None
        )
        self.transport = transport
        self.peers = PeerSet()
        self.reactors: Dict[str, Reactor] = {}
        self._chan_to_reactor: Dict[int, Reactor] = {}
        self._channel_descs: List[ChannelDescriptor] = []
        self.max_peers = max_peers
        self.persistent_addrs: Dict[str, str] = {}  # peer id -> addr
        self._tasks: List[asyncio.Task] = []
        # Reconnect routines tracked SEPARATELY (peer id -> task): they sleep
        # up to 0.5*2^6 s between attempts, so stop() must cancel AND await
        # them (a bare fire-and-forget task would outlive the switch and dial
        # from a stopped node). One task per peer id — a flapping peer must
        # not accumulate concurrent reconnect loops.
        self._reconnect_tasks: Dict[str, asyncio.Task] = {}
        self._running = False
        self._dialing: set[str] = set()
        # Partition hook: when set, a peer id this predicate rejects can
        # neither be dialed nor accepted (a test partitions an in-process
        # net by installing group filters).
        self._conn_filter = None
        # Inbound admission control (p2p/conn/connection.py RecvRateLimit):
        # applied to every peer MConnection's sheddable channels. None
        # disables per-channel rate limiting.
        self.recv_limit = recv_limit

    @property
    def node_info(self):
        return self.transport.node_info

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        """(reference: p2p/switch.go:157 AddReactor)"""
        for desc in reactor.get_channels():
            if desc.id in self._chan_to_reactor:
                raise ValueError(f"channel {desc.id:#x} already registered")
            self._chan_to_reactor[desc.id] = reactor
            self._channel_descs.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        # advertise channels in NodeInfo
        self.transport.node_info.channels = bytes(
            sorted(self._chan_to_reactor.keys())
        )
        return reactor

    TRUST_SAVE_INTERVAL = 60.0  # reference: p2p/trust/store.go saves each minute
    FLOWRATE_SAMPLE_INTERVAL = 2.0  # p2p gauge refresh (EWMA window is 1s)

    async def start(self) -> None:
        self._running = True
        for reactor in self.reactors.values():
            await reactor.start()
        self._tasks.append(asyncio.create_task(self._accept_routine(), name="sw-accept"))
        if self.reporter.store is not None:
            self._tasks.append(
                asyncio.create_task(self._trust_save_routine(), name="sw-trust-save")
            )
        if self.metrics is not None:
            self._tasks.append(
                asyncio.create_task(self._flowrate_routine(), name="sw-flowrate")
            )

    async def _trust_save_routine(self) -> None:
        while self._running:
            await asyncio.sleep(self.TRUST_SAVE_INTERVAL)
            self.reporter.save()

    async def _flowrate_routine(self) -> None:
        """Periodically fold every peer MConnection's flowrate Monitors and
        send-queue depths into the p2p gauges — the Monitors existed for
        rate limiting but were never read for observability."""
        while self._running:
            self.update_flow_metrics()
            await asyncio.sleep(self.FLOWRATE_SAMPLE_INTERVAL)

    def update_flow_metrics(self) -> None:
        if self.metrics is None:
            return
        send_rate = recv_rate = 0.0
        pending = 0
        skews = {}
        for peer in self.peers.list():
            try:
                st = peer.status()
            except Exception:
                continue
            send_rate += st["send_rate_bytes"]
            recv_rate += st["recv_rate_bytes"]
            pending += sum(c["pending_messages"] for c in st["channels"])
            if st.get("clock_skew_s") is not None:
                skews[(peer.id[:10],)] = st["clock_skew_s"]
        # replace, don't accumulate: a departed peer's series must drop out
        # (peer ids are remote-controlled label cardinality)
        self.metrics.clock_skew_seconds.replace_series(skews)
        self.metrics.send_rate_bytes.set(send_rate)
        self.metrics.recv_rate_bytes.set(recv_rate)
        self.metrics.pending_send_messages.set(pending)

    def clock_skew(self, node_id: str):
        """Remote-minus-local clock-skew estimate for a DIRECTLY connected
        peer (seconds), or None when the peer is unknown or unsampled. The
        chain observatory's propagation latencies subtract this before they
        are recorded, so cross-node deltas are honest."""
        peer = self.peers.get(node_id)
        if peer is None:
            return None
        try:
            return peer.clock_skew()
        except Exception:
            return None

    def set_conn_filter(self, fn) -> None:
        """Install (or clear, with None) a peer-id connection filter. Applies
        to dials, inbound upgrades, and reconnect attempts."""
        self._conn_filter = fn

    def _conn_allowed(self, peer_id: str) -> bool:
        return self._conn_filter is None or not peer_id or self._conn_filter(peer_id)

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        reconnects = list(self._reconnect_tasks.values())
        for t in reconnects:
            t.cancel()
        if reconnects:
            await asyncio.gather(*reconnects, return_exceptions=True)
        self._reconnect_tasks.clear()
        for peer in self.peers.list():
            await self._stop_and_remove_peer(peer, None)
        for reactor in self.reactors.values():
            await reactor.stop()
        self.reporter.save()
        await self.transport.close()

    # -- peer lifecycle ----------------------------------------------------

    async def _accept_routine(self) -> None:
        while self._running:
            try:
                conn = await self.transport.accept()
            except asyncio.CancelledError:
                return
            except Exception as e:
                logger.error("accept error: %s", e)
                continue
            if self.peers.size() >= self.max_peers:
                conn.transport.close()
                continue
            try:
                await self._add_peer(conn)
            except Exception as e:
                logger.info("failed to add inbound peer: %s", e)

    async def dial_peer(self, addr: str, persistent: bool = False) -> Optional[Peer]:
        """Dial 'id@host:port' and add the peer."""
        peer_id, _, _ = parse_addr(addr)
        if not self._conn_allowed(peer_id):
            raise ConnectionError(f"dial to {peer_id[:10]} blocked by conn filter")
        if peer_id and (self.peers.has(peer_id) or peer_id in self._dialing):
            return self.peers.get(peer_id)
        self._dialing.add(peer_id)
        try:
            conn = await self.transport.dial(addr)
            if persistent:
                self.persistent_addrs[conn.node_info.node_id] = addr
            return await self._add_peer(conn, persistent=persistent)
        finally:
            self._dialing.discard(peer_id)

    async def dial_peers_async(self, addrs: List[str], persistent: bool = False) -> None:
        async def _one(a):
            try:
                await self.dial_peer(a, persistent=persistent)
            except Exception as e:
                logger.info("dial %s failed: %s", a, e)
                if persistent:
                    pid, _, _ = parse_addr(a)
                    self._spawn_reconnect(a, pid)

        await asyncio.gather(*(_one(a) for a in addrs))

    async def _add_peer(self, conn: Connection, persistent: bool = False) -> Peer:
        ni = conn.node_info
        if not self._conn_allowed(ni.node_id):
            conn.transport.close()
            raise ConnectionError(f"peer {ni.node_id[:10]} blocked by conn filter")
        if self.peers.has(ni.node_id):
            conn.transport.close()
            raise ValueError(f"duplicate peer {ni.node_id}")
        persistent = persistent or ni.node_id in self.persistent_addrs

        peer_holder: List[Peer] = []

        async def on_receive(chan_id: int, msg: bytes) -> None:
            reactor = self._chan_to_reactor.get(chan_id)
            if reactor is None:
                raise ValueError(f"no reactor for channel {chan_id:#x}")
            if self.metrics is not None:
                self.metrics.peer_receive_bytes_total.labels(f"{chan_id:#x}").inc(len(msg))
            try:
                await reactor.receive(chan_id, peer_holder[0], msg)
            except Exception as e:
                # full report: records bad conduct AND applies the trust
                # threshold (the peer is usually also stopped by on_error)
                from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE, PeerBehaviour

                await self.reporter.report(
                    PeerBehaviour(peer_holder[0].id, BAD_MESSAGE, str(e))
                )
                raise
            self.reporter.metric(peer_holder[0].id).record_good(0.05)

        async def on_error(e: Exception) -> None:
            await self.stop_peer_for_error(peer_holder[0], e)

        async def on_rate_limit_exceeded() -> None:
            # persistent flooding past the per-channel budgets: record bad
            # conduct; repeated reports push the trust score under the
            # threshold and the Reporter disconnects the peer
            from tendermint_tpu_torch.p2p.behaviour import RATE_LIMIT, PeerBehaviour

            if self.metrics is not None:
                self.metrics.rate_limit_disconnects.inc()
            await self.reporter.report(
                PeerBehaviour(
                    peer_holder[0].id, RATE_LIMIT, "inbound recv budget exceeded"
                )
            )

        mconn = MConnection(
            conn.transport, self._channel_descs, on_receive, on_error,
            recv_limit=self.recv_limit, metrics=self.metrics,
            on_rate_limit_exceeded=on_rate_limit_exceeded,
        )
        peer = Peer(ni, mconn, conn.outbound, persistent, conn.socket_addr,
                    metrics=self.metrics)
        peer_holder.append(peer)
        self.peers.add(peer)
        mconn.start()
        for reactor in self.reactors.values():
            await reactor.add_peer(peer)
        logger.info("added peer %s (%s)", ni.node_id[:10], ni.moniker)
        if self.metrics is not None:
            self.metrics.peers.set(self.peers.size())
        return peer

    async def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """(reference: p2p/switch.go:324 StopPeerForError)"""
        if not self.peers.has(peer.id):
            return
        logger.info("stopping peer %s: %s", peer.id[:10], reason)
        await self._stop_and_remove_peer(peer, reason)
        if peer.persistent and self._running:
            addr = self.persistent_addrs.get(peer.id) or (
                f"{peer.id}@{peer.socket_addr}" if peer.outbound else None
            )
            if addr:
                self._spawn_reconnect(addr, peer.id)

    async def _stop_and_remove_peer(self, peer: Peer, reason) -> None:
        self.peers.remove(peer.id)
        # keep bad reputations (reconnecting with the same id stays scored),
        # drop good ones so the metrics map doesn't grow with peer churn
        if self.reporter.score(peer.id) > 0.8:
            self.reporter.metrics.pop(peer.id, None)
        if self.metrics is not None:
            self.metrics.peers.set(self.peers.size())
        await peer.stop()
        for reactor in self.reactors.values():
            try:
                await reactor.remove_peer(peer, reason)
            except Exception:
                logger.exception("reactor remove_peer failed")

    def _spawn_reconnect(self, addr: str, peer_id: str) -> None:
        """Track one reconnect routine per peer id; done tasks self-evict so
        the map doesn't grow with peer churn (the old bare create_task +
        append-to-_tasks leaked a completed task per flap and left sleepers
        alive across stop())."""
        existing = self._reconnect_tasks.get(peer_id)
        if existing is not None and not existing.done():
            return
        task = asyncio.create_task(
            self._reconnect_routine(addr, peer_id), name=f"sw-reconnect-{peer_id[:8]}"
        )
        self._reconnect_tasks[peer_id] = task

        def _evict(t, pid=peer_id):
            if self._reconnect_tasks.get(pid) is t:
                del self._reconnect_tasks[pid]

        task.add_done_callback(_evict)

    async def _reconnect_routine(self, addr: str, peer_id: str) -> None:
        """Exponential backoff reconnect (reference: p2p/switch.go:379)."""
        for attempt in range(RECONNECT_ATTEMPTS):
            if not self._running or self.peers.has(peer_id):
                return
            delay = RECONNECT_BASE_DELAY * (2 ** min(attempt, 6)) * (0.5 + random.random())
            await asyncio.sleep(delay)
            if not self._running or self.peers.has(peer_id):
                return
            if self.metrics is not None:
                self.metrics.reconnect_attempts.inc()
            try:
                await self.dial_peer(addr, persistent=True)
                return
            except Exception as e:
                logger.debug("reconnect %s attempt %d failed: %s", addr, attempt, e)

    async def disconnect_peer(self, peer_id: str, reason: str = "disconnect") -> None:
        """Drop a live peer connection WITHOUT spawning a reconnect routine
        (a partition cuts links; healing re-dials explicitly)."""
        peer = self.peers.get(peer_id)
        if peer is not None:
            logger.info("disconnecting peer %s: %s", peer_id[:10], reason)
            await self._stop_and_remove_peer(peer, reason)

    # -- broadcast ---------------------------------------------------------

    async def broadcast(self, chan_id: int, msg: bytes) -> None:
        """Async send to every peer (reference: p2p/switch.go:263)."""
        await asyncio.gather(
            *(p.send(chan_id, msg) for p in self.peers.list()),
            return_exceptions=True,
        )

    async def broadcast_many(self, chan_id: int, msgs: List[bytes]) -> None:
        """Coalesced broadcast: each peer receives the whole batch in order
        with ONE task per peer, instead of one gather round per message.
        Used by the consensus reactor's per-drain HasVote batches."""
        if not msgs:
            return
        if len(msgs) == 1:
            await self.broadcast(chan_id, msgs[0])
            return

        async def _send_all(p: Peer) -> None:
            for m in msgs:
                await p.send(chan_id, m)

        await asyncio.gather(
            *(_send_all(p) for p in self.peers.list()),
            return_exceptions=True,
        )

    def num_peers(self) -> int:
        return self.peers.size()
