"""Syncer: restores state machine snapshots via ABCI + verifies via light client.

reference: statesync/syncer.go — syncer (:38), AddSnapshot (:78), SyncAny
(:130), Sync (:217), offerSnapshot (:276), applyChunks (:312), fetchChunks
(:369), requestChunk (:402), verifyApp (:423).

The port's copy of tendermint_tpu/statesync/syncer.py. One difference
(ROADMAP D1): the reference turns any exception of the state provider into
ErrVerifyFailed, so a failed device flush inside a light check would read as
a bad snapshot and the next one would be tried. Here an error that came out
of device work (crypto/batch.is_device_error) propagates unchanged; provider
and protocol failures keep the reference's ladder.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Dict, Optional, Set, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto.batch import is_device_error
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.statesync.checkpoint import RestoreCheckpoint
from tendermint_tpu_torch.statesync.chunks import Chunk, ChunkQueue, ChunkQueueClosed
from tendermint_tpu_torch.statesync.snapshots import Snapshot, SnapshotPool
from tendermint_tpu_torch.statesync.stateprovider import StateProvider
from tendermint_tpu_torch.types.block import Commit

logger = logging.getLogger("tendermint_tpu_torch.statesync")

# reference: statesync/syncer.go:21-35. CHUNK_TIMEOUT is only the
# no-config default: the node path passes [statesync] chunk_request_timeout
# through StatesyncReactor.sync (node/node.py _run_state_sync).
CHUNK_TIMEOUT = 2 * 60.0
MIN_SNAPSHOT_PEERS = 1
# retry-ladder defaults (the [statesync] chunk_retries / chunk_backoff
# knobs override these on the node path)
CHUNK_RETRIES = 8
CHUNK_BACKOFF = 0.25
CHUNK_BACKOFF_MAX = 30.0


class SyncError(Exception):
    pass


class ErrNoSnapshots(SyncError):
    """reference: statesync/syncer.go errNoSnapshots."""


class ErrAbort(SyncError):
    """App returned ABORT (reference: errAbort)."""


class ErrRejectSnapshot(SyncError):
    pass


class ErrRejectFormat(SyncError):
    pass


class ErrRejectSender(SyncError):
    pass


class ErrVerifyFailed(SyncError):
    """App hash or height mismatch after restore (reference: errVerifyFailed)."""


class ErrChunkFetchFailed(SyncError):
    """A chunk exhausted its retry budget (timeouts across peers, or no
    snapshot peers left). The structured terminus of the retry ladder: the
    snapshot is rejected, and when no snapshot remains sync_any raises
    ErrNoSnapshots — which the node turns into the blocksync-from-genesis
    fallback."""


class Syncer:
    """reference: statesync/syncer.go:38.

    request_chunk(peer_id, height, format, index) is an async callback into
    the reactor; conn_snapshot/conn_query are ABCI clients (snapshot + query
    connections of the 4-conn proxy)."""

    def __init__(
        self,
        state_provider: StateProvider,
        conn_snapshot,
        conn_query,
        request_chunk: Callable,
        chunk_fetchers: int = 4,
        chunk_timeout: float = CHUNK_TIMEOUT,
        metrics=None,
        chunk_retries: int = CHUNK_RETRIES,
        chunk_backoff: float = CHUNK_BACKOFF,
        punish_peer: Optional[Callable] = None,
        checkpoint: Optional[RestoreCheckpoint] = None,
    ):
        self.state_provider = state_provider
        self.conn_snapshot = conn_snapshot
        self.conn_query = conn_query
        self.request_chunk = request_chunk
        self.chunk_fetchers = chunk_fetchers
        self.chunk_timeout = chunk_timeout
        self.metrics = metrics  # StateSyncMetrics or None
        # retry ladder: every chunk gets chunk_retries re-requests with
        # exponential backoff (chunk_backoff * 2^k), each routed to a
        # different peer than the last when one exists
        self.chunk_retries = int(chunk_retries)
        self.chunk_backoff = float(chunk_backoff)
        # punish_peer(peer_id, reason) -> awaitable: behaviour report into
        # the trust scorer (reactor wiring); None = no punishment side channel
        self.punish_peer = punish_peer
        self.checkpoint = checkpoint or RestoreCheckpoint(None)
        self.snapshots = SnapshotPool()
        self.chunk_queue: Optional[ChunkQueue] = None
        self._processing: Optional[Snapshot] = None
        self._chunk_attempts: Dict[int, int] = {}
        self._last_sender: Dict[int, str] = {}
        self._applied: Set[int] = set()

    # ---------------------------------------------------------------- intake

    def add_snapshot(self, peer_id: str, snapshot: Snapshot) -> bool:
        """reference: syncer.go:78 AddSnapshot."""
        added = self.snapshots.add(peer_id, snapshot)
        if added:
            if self.metrics is not None:
                self.metrics.snapshots_discovered_total.inc()
            logger.info(
                "discovered snapshot height=%d format=%d chunks=%d from %s",
                snapshot.height, snapshot.format, snapshot.chunks, peer_id[:10],
            )
        return added

    def add_chunk(self, chunk: Chunk) -> bool:
        """reference: syncer.go:110 AddChunk."""
        q = self.chunk_queue
        if q is None or self._processing is None:
            return False
        if chunk.height != self._processing.height or chunk.format != self._processing.format:
            return False
        return q.add(chunk)

    def remove_peer(self, peer_id: str) -> None:
        self.snapshots.remove_peer(peer_id)

    # ------------------------------------------------------------------ sync

    async def sync_any(self, discovery_time: float) -> Tuple[State, Commit]:
        """Try snapshots best-first until one restores
        (reference: syncer.go:130 SyncAny)."""
        if discovery_time > 0:
            logger.info("discovering snapshots for %.1fs", discovery_time)
            await asyncio.sleep(discovery_time)
        while True:
            snapshot = self.snapshots.best()
            if snapshot is None:
                raise ErrNoSnapshots("no viable snapshots found")
            try:
                return await self.sync(snapshot)
            except ErrRejectSnapshot:
                logger.info("snapshot height=%d rejected; trying next", snapshot.height)
                self.snapshots.reject(snapshot)
                self.checkpoint.clear()
            except ErrRejectFormat:
                logger.info("snapshot format %d rejected; trying next", snapshot.format)
                self.snapshots.reject_format(snapshot.format)
                self.checkpoint.clear()
            except ErrRejectSender:
                logger.info("snapshot senders rejected; trying next")
                for peer_id in self.snapshots.get_peers(snapshot):
                    self.snapshots.reject_peer(peer_id)
                self.snapshots.reject(snapshot)
                self.checkpoint.clear()
            except ErrChunkFetchFailed as e:
                logger.warning(
                    "snapshot height=%d abandoned: %s; trying next",
                    snapshot.height, e,
                )
                self.snapshots.reject(snapshot)
                self.checkpoint.clear()
            except ErrVerifyFailed:
                logger.warning("snapshot height=%d failed verification; trying next", snapshot.height)
                self.snapshots.reject(snapshot)
                # the checkpointed applied-set proved unreliable (the app's
                # side of those applies evidently did not survive): clear so
                # the next attempt starts fresh
                self.checkpoint.clear()
            finally:
                if self.chunk_queue is not None:
                    self.chunk_queue.close()
                self.chunk_queue = None
                self._processing = None

    async def sync(self, snapshot: Snapshot) -> Tuple[State, Commit]:
        """Restore one snapshot (reference: syncer.go:217 Sync)."""
        # fetch the trusted app hash BEFORE offering (reference: :226).
        # A provider failure here is a property of THIS snapshot (e.g. the
        # newest snapshot's height+2 light verification needs blocks the
        # chain hasn't committed yet) — reject it and let sync_any try the
        # next-best one instead of killing the whole state sync
        try:
            app_hash = await self.state_provider.app_hash(snapshot.height)
        except asyncio.CancelledError:
            raise
        except SyncError:
            raise
        except Exception as e:
            if is_device_error(e):
                raise  # not a property of the snapshot (ROADMAP D1)
            raise ErrVerifyFailed(
                f"state provider failed for snapshot height "
                f"{snapshot.height}: {e}"
            ) from e
        snapshot = Snapshot(
            snapshot.height, snapshot.format, snapshot.chunks,
            snapshot.hash, snapshot.metadata, trusted_app_hash=app_hash,
        )
        self._processing = snapshot
        self.chunk_queue = ChunkQueue(snapshot)
        self._chunk_attempts = {}
        self._last_sender = {}
        self._applied = set()
        if self.metrics is not None:
            self.metrics.snapshot_height.set(snapshot.height)
            self.metrics.snapshot_chunks_total.set(snapshot.chunks)

        await self._offer_snapshot(snapshot)

        # crash-resume: the snapshot was re-offered above; skip
        # the chunks a previous life already applied
        resumed = self.checkpoint.load(snapshot)
        if resumed:
            for index in sorted(resumed):
                self.chunk_queue.mark_applied(index)
            self._applied = set(resumed)
            if self.metrics is not None:
                self.metrics.resume_events_total.inc()
            logger.info(
                "resuming snapshot restore at height %d: %d/%d chunks "
                "already applied before the crash",
                snapshot.height, len(resumed), snapshot.chunks,
            )

        fetchers = [
            asyncio.create_task(self._fetch_chunks(), name=f"ss-fetch-{i}")
            for i in range(self.chunk_fetchers)
        ]
        # concurrently: build verified state via light client + apply chunks;
        # gather surfaces the FIRST failure immediately so a dead light
        # client aborts the sync instead of waiting out slow chunk peers
        state_task = asyncio.create_task(self.state_provider.state(snapshot.height))
        commit_task = asyncio.create_task(self.state_provider.commit(snapshot.height))
        apply_task = asyncio.create_task(self._apply_chunks(self.chunk_queue))
        try:
            _, state, commit = await asyncio.gather(apply_task, state_task, commit_task)
        except BaseException as e:
            for t in (apply_task, state_task, commit_task):
                t.cancel()
            if not isinstance(e, (SyncError, asyncio.CancelledError)) and not is_device_error(e):
                # light-provider/transport failures are snapshot-scoped too:
                # reject this snapshot, try the next (sync_any's ladder)
                raise ErrVerifyFailed(
                    f"state/commit verification failed for snapshot height "
                    f"{snapshot.height}: {e}"
                ) from e
            raise
        finally:
            for f in fetchers:
                f.cancel()

        await self._verify_app(snapshot, state)
        self.checkpoint.clear()
        logger.info("snapshot restored at height %d", snapshot.height)
        return state, commit

    async def _offer_snapshot(self, snapshot: Snapshot) -> None:
        """reference: syncer.go:276 offerSnapshot."""
        resp = self.conn_snapshot.offer_snapshot(
            abci.RequestOfferSnapshot(
                snapshot=abci.Snapshot(
                    height=snapshot.height,
                    format=snapshot.format,
                    chunks=snapshot.chunks,
                    hash=snapshot.hash,
                    metadata=snapshot.metadata,
                ),
                app_hash=snapshot.trusted_app_hash,
            )
        )
        r = resp.result
        if r == abci.OFFER_SNAPSHOT_ACCEPT:
            logger.info("snapshot height=%d format=%d accepted", snapshot.height, snapshot.format)
        elif r == abci.OFFER_SNAPSHOT_ABORT:
            raise ErrAbort("app aborted state sync")
        elif r == abci.OFFER_SNAPSHOT_REJECT:
            raise ErrRejectSnapshot("app rejected snapshot")
        elif r == abci.OFFER_SNAPSHOT_REJECT_FORMAT:
            raise ErrRejectFormat("app rejected format")
        elif r == abci.OFFER_SNAPSHOT_REJECT_SENDER:
            raise ErrRejectSender("app rejected senders")
        else:
            raise SyncError(f"unknown OfferSnapshot result {r}")

    def _bump_attempts(self, index: int, q: ChunkQueue, reason: str) -> bool:
        """Count one failed fetch attempt; True while the retry budget
        holds, False after failing the queue (ladder exhausted)."""
        n = self._chunk_attempts.get(index, 0) + 1
        self._chunk_attempts[index] = n
        if n > self.chunk_retries:
            q.fail(ErrChunkFetchFailed(
                f"chunk {index}: {reason} after {n - 1} retries"
            ))
            return False
        return True

    async def _fetch_chunks(self) -> None:
        """One fetcher worker (reference: syncer.go:369 fetchChunks), with
        the retry ladder: exponential backoff per attempt, each
        re-request routed to a different peer than the last when one
        exists, budget capped at chunk_retries before the snapshot is
        abandoned through ChunkQueue.fail."""
        import random

        q = self.chunk_queue
        snapshot = self._processing
        try:
            while True:
                index = q.allocate()
                if index is None:
                    if q.done():
                        return
                    await asyncio.sleep(0.05)
                    continue
                attempt = self._chunk_attempts.get(index, 0)
                if attempt > 0:
                    if self.metrics is not None:
                        self.metrics.chunk_retries_total.inc()
                    await asyncio.sleep(min(
                        self.chunk_backoff * (2 ** (attempt - 1)),
                        CHUNK_BACKOFF_MAX,
                    ))
                peers = self.snapshots.get_peers(snapshot)
                if not peers:
                    # all snapshot peers gone/rejected: bounded patience
                    # through the same budget, then the structured failure
                    if not self._bump_attempts(index, q, "no snapshot peers"):
                        return
                    q.retry(index)
                    await asyncio.sleep(self.chunk_backoff)
                    continue
                # random peer per request so a silent-but-connected peer
                # can't pin a chunk forever (reference: syncer.go:402) —
                # but never the SAME peer twice in a row when another exists
                avoid = self._last_sender.get(index)
                candidates = [p for p in peers if p != avoid] or peers
                peer_id = random.choice(candidates)
                self._last_sender[index] = peer_id
                await self.request_chunk(peer_id, snapshot.height, snapshot.format, index)
                # wait for it to arrive; retry on timeout (reference: :390)
                deadline = asyncio.get_event_loop().time() + self.chunk_timeout
                while not q.has(index) and index not in q._returned:
                    if asyncio.get_event_loop().time() > deadline:
                        if not self._bump_attempts(index, q, "fetch timeout"):
                            return
                        q.retry(index)
                        break
                    await asyncio.sleep(0.05)
        except (asyncio.CancelledError, ChunkQueueClosed):
            pass

    async def _punish(self, peer_id: str, reason: str) -> None:
        if not peer_id or self.punish_peer is None:
            return
        try:
            await self.punish_peer(peer_id, reason)
        except Exception:
            logger.exception("punishing statesync peer %s failed", peer_id[:10])

    async def _apply_chunks(self, q: ChunkQueue) -> None:
        """reference: syncer.go:312 applyChunks, plus: corrupt
        chunks punish their sender and re-queue (from a different peer —
        the fetcher's avoid-last-sender routing), and every ACCEPT is
        checkpointed so a crash mid-restore resumes past it."""
        while True:
            if q.done():
                return  # crash-resume may have marked every chunk applied
            chunk = await q.next()
            resp = self.conn_snapshot.apply_snapshot_chunk(
                abci.RequestApplySnapshotChunk(
                    index=chunk.index, chunk=chunk.chunk, sender=chunk.sender
                )
            )
            # punishment lists apply regardless of result (reference: :330)
            for peer_id in resp.reject_senders:
                self.snapshots.reject_peer(peer_id)
                q.discard_sender(peer_id)
                await self._punish(peer_id, "app rejected snapshot sender")
            for index in resp.refetch_chunks:
                q.retry(index)
                self._applied.discard(index)
            if resp.refetch_chunks:
                # keep the on-disk applied-set honest: a crash before the
                # refetched chunk lands must not resume past it
                self.checkpoint.save(self._processing, self._applied)

            r = resp.result
            if r == abci.APPLY_SNAPSHOT_CHUNK_ACCEPT:
                if self.metrics is not None:
                    self.metrics.chunks_applied_total.inc()
                self._applied.add(chunk.index)
                self.checkpoint.save(self._processing, self._applied)
                if q.done():
                    return
            elif r == abci.APPLY_SNAPSHOT_CHUNK_ABORT:
                raise ErrAbort("app aborted chunk apply")
            elif r == abci.APPLY_SNAPSHOT_CHUNK_RETRY:
                # the app refused the bytes (corrupt/torn chunk): punish the
                # sender and re-queue; the fetcher's backoff + peer-switch
                # ladder sources the refetch elsewhere
                if self.metrics is not None:
                    self.metrics.bad_chunks_total.inc()
                await self._punish(chunk.sender, "corrupt snapshot chunk")
                # corrupt serves consume the same retry budget as timeouts:
                # a net where EVERY peer serves corrupt bytes must abandon
                # the snapshot, not loop forever
                self._bump_attempts(chunk.index, q, "corrupt chunk")
                q.retry(chunk.index)
            elif r == abci.APPLY_SNAPSHOT_CHUNK_RETRY_SNAPSHOT:
                q.retry_all()
                self._applied.clear()
                self.checkpoint.save(self._processing, self._applied)
            elif r == abci.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT:
                raise ErrRejectSnapshot("app rejected snapshot during chunk apply")
            else:
                raise SyncError(f"unknown ApplySnapshotChunk result {r}")

    async def _verify_app(self, snapshot: Snapshot, state: State) -> None:
        """The app must now report the trusted hash/height
        (reference: syncer.go:423 verifyApp)."""
        resp = self.conn_query.info(abci.RequestInfo())
        if resp.last_block_app_hash != snapshot.trusted_app_hash:
            raise ErrVerifyFailed(
                f"app hash mismatch: expected {snapshot.trusted_app_hash.hex()}, "
                f"got {resp.last_block_app_hash.hex()}"
            )
        if resp.last_block_height != snapshot.height:
            raise ErrVerifyFailed(
                f"app height mismatch: expected {snapshot.height}, "
                f"got {resp.last_block_height}"
            )
