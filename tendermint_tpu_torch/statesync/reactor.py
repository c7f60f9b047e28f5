"""State sync reactor: serves snapshots to peers + drives the local syncer.

reference: statesync/reactor.go — channels (:18-20), Receive (:98), Sync
(:248), recentSnapshots (:73).

The port's copy of tendermint_tpu/statesync/reactor.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.statesync.chunks import Chunk
from tendermint_tpu_torch.statesync.messages import (
    CHUNK_CHANNEL,
    CHUNK_MSG_SIZE,
    SNAPSHOT_CHANNEL,
    SNAPSHOT_MSG_SIZE,
    ChunkRequest,
    ChunkResponse,
    SnapshotsRequest,
    SnapshotsResponse,
    decode_message,
    encode_message,
)
from tendermint_tpu_torch.statesync.snapshots import Snapshot
from tendermint_tpu_torch.statesync.syncer import Syncer
from tendermint_tpu_torch.types.block import Commit

logger = logging.getLogger("tendermint_tpu_torch.statesync")

RECENT_SNAPSHOTS = 10  # reference: statesync/reactor.go:73


class StatesyncReactor(Reactor):
    # concurrent load_snapshot_chunk calls served to peers: a mass-rejoin
    # storm queues behind this bound in executor threads instead of
    # monopolizing the event loop the consensus reactor shares
    SERVE_CONCURRENCY = 2

    def __init__(self, conn_snapshot, conn_query, active: bool = False, metrics=None,
                 checkpoint_path: Optional[str] = None):
        super().__init__("STATESYNC")
        self.conn_snapshot = conn_snapshot
        self.conn_query = conn_query
        self.active = active  # True = we are syncing; False = serve only
        self.metrics = metrics  # StateSyncMetrics or None
        self.checkpoint_path = checkpoint_path  # crash-resume file (node path)
        self.syncer: Optional[Syncer] = None
        # serving-fault hook (the reference's chaos/catchup.ServeFaults, or
        # any object with take_chunk_corrupt / corrupt_chunk): serve
        # corrupted chunks on schedule so a test exercises the syncing
        # side's punish paths
        self.serve_faults = None
        self._serve_sem: Optional[asyncio.Semaphore] = None

    def get_channels(self) -> List[ChannelDescriptor]:
        # both channels SHEDDABLE: snapshot/chunk serving rides the
        # per-peer recv token buckets, so a thousand rejoining
        # nodes hammering one serving validator shed pre-dispatch instead
        # of starving its vote path (consensus channels have no bucket)
        return [
            ChannelDescriptor(
                SNAPSHOT_CHANNEL, priority=5,
                send_queue_capacity=10, recv_message_capacity=SNAPSHOT_MSG_SIZE,
                sheddable=True,
            ),
            ChannelDescriptor(
                CHUNK_CHANNEL, priority=3,
                send_queue_capacity=4, recv_message_capacity=CHUNK_MSG_SIZE,
                sheddable=True,
            ),
        ]

    # ----------------------------------------------------------------- peers

    async def add_peer(self, peer) -> None:
        """Ask every new peer for its snapshots while syncing
        (reference: reactor.go:221 AddPeer)."""
        if self.active:
            await peer.send(SNAPSHOT_CHANNEL, encode_message(SnapshotsRequest()))

    async def remove_peer(self, peer, reason) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    # --------------------------------------------------------------- receive

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            msg = decode_message(msg_bytes)
        except Exception as e:
            await self.switch.stop_peer_for_error(peer, e)
            return

        if isinstance(msg, SnapshotsRequest):
            # serve our app's recent snapshots (reference: reactor.go:110)
            for s in self._recent_snapshots(RECENT_SNAPSHOTS):
                await peer.send(
                    SNAPSHOT_CHANNEL,
                    encode_message(
                        SnapshotsResponse(s.height, s.format, s.chunks, s.hash, s.metadata)
                    ),
                )
        elif isinstance(msg, SnapshotsResponse):
            if self.syncer is not None:
                try:
                    msg.validate_basic()
                except ValueError as e:
                    await self.switch.stop_peer_for_error(peer, e)
                    return
                self.syncer.add_snapshot(
                    peer.id,
                    Snapshot(msg.height, msg.format, msg.chunks, msg.hash, msg.metadata),
                )
        elif isinstance(msg, ChunkRequest):
            # load from the app (reference: reactor.go:151) — in an executor
            # behind a small semaphore: chunk loads can be multi-MB reads,
            # and a rejoin storm must never block the consensus event loop
            if self._serve_sem is None:
                self._serve_sem = asyncio.Semaphore(self.SERVE_CONCURRENCY)
            async with self._serve_sem:
                resp = await asyncio.get_running_loop().run_in_executor(
                    None,
                    self.conn_snapshot.load_snapshot_chunk,
                    abci.RequestLoadSnapshotChunk(msg.height, msg.format, msg.index),
                )
            chunk = resp.chunk
            if chunk and self.serve_faults is not None and self.serve_faults.take_chunk_corrupt():
                chunk = self.serve_faults.corrupt_chunk(chunk)
            await peer.send(
                CHUNK_CHANNEL,
                encode_message(
                    ChunkResponse(
                        msg.height, msg.format, msg.index,
                        chunk, missing=not chunk,
                    )
                ),
            )
        elif isinstance(msg, ChunkResponse):
            if self.syncer is not None and not msg.missing:
                # torn-chunk guard: an empty non-missing payload is a wire
                # tear, not a chunk — treat as missing so the fetcher's
                # timeout/retry ladder re-sources it
                if not msg.chunk:
                    return
                self.syncer.add_chunk(
                    Chunk(msg.height, msg.format, msg.index, msg.chunk, peer.id)
                )

    def _recent_snapshots(self, n: int) -> List[Snapshot]:
        resp = self.conn_snapshot.list_snapshots()
        snaps = sorted(
            resp.snapshots, key=lambda s: (-s.height, -s.format)
        )[:n]
        return [
            Snapshot(s.height, s.format, s.chunks, s.hash, s.metadata) for s in snaps
        ]

    # ------------------------------------------------------------------ sync

    async def sync(self, state_provider, discovery_time: float,
                   chunk_fetchers: int = 4, chunk_timeout: float = 120.0,
                   chunk_retries: int = 8, chunk_backoff: float = 0.25,
                   ) -> Tuple[State, Commit]:
        """Run the full state sync (reference: reactor.go:248 Sync)."""
        if self.syncer is not None:
            raise RuntimeError("a state sync is already in progress")
        from tendermint_tpu_torch.statesync.checkpoint import RestoreCheckpoint

        self.syncer = Syncer(
            state_provider,
            self.conn_snapshot,
            self.conn_query,
            self._request_chunk,
            chunk_fetchers=chunk_fetchers,
            chunk_timeout=chunk_timeout,
            metrics=self.metrics,
            chunk_retries=chunk_retries,
            chunk_backoff=chunk_backoff,
            punish_peer=self._punish_peer,
            checkpoint=RestoreCheckpoint(self.checkpoint_path),
        )
        if self.metrics is not None:
            self.metrics.syncing.set(1)
        try:
            # ask everyone already connected (late peers hit add_peer)
            await self.switch.broadcast(
                SNAPSHOT_CHANNEL, encode_message(SnapshotsRequest())
            )
            return await self.syncer.sync_any(discovery_time)
        finally:
            self.syncer = None
            if self.metrics is not None:
                self.metrics.syncing.set(0)

    async def _request_chunk(self, peer_id: str, height: int, fmt: int, index: int) -> None:
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            await peer.send(CHUNK_CHANNEL, encode_message(ChunkRequest(height, fmt, index)))

    async def _punish_peer(self, peer_id: str, reason: str) -> None:
        """Syncer punish hook: route misconduct (corrupt chunks, app-
        rejected senders) into the trust scorer — repeated offenses
        disconnect via the reporter's threshold, one bad chunk does not."""
        if self.switch is None or getattr(self.switch, "reporter", None) is None:
            return
        from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE, PeerBehaviour

        await self.switch.reporter.report(
            PeerBehaviour(peer_id, BAD_MESSAGE, reason)
        )
