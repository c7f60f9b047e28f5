"""Fast-sync reactor (v0-shaped): download blocks from peers, verify their
commits in one batched flush, apply, then hand off to consensus (reference
blockchain/v0/reactor.go:104,116,207; channel 0x40 :19). The port's copy of
tendermint_tpu/blocksync/reactor.py.

Catch-up runs as a three-stage pipeline:

  fetch  : BlockPool keeps a window of heights in flight across scored
           peers (blocksync/pool.py);
  verify : a contiguous run of up to VERIFY_BATCH_BLOCKS downloaded blocks
           has all its commit signatures verified as one cross-height flush
           by blocksync/verify.verify_run_batched: the scheduler's catch-up
           lane when the node has one (crypto/scheduler.py), else one
           crypto/batch.verify_batch call on `device`;
  apply  : verified blocks drain through a bounded queue into ABCI replay.

The verify stage runs in an executor thread, so run i+1 is verified on the
card while the event loop replays run i.

Crash safety: the verified-but-unapplied window is persisted in a
CatchupCheckpoint (blocksync/checkpoint.py); a killed node re-enters the
pipeline at its last applied height and applies the checkpointed window
without re-fetching or re-verifying it.

No fallback (ROADMAP D1): the reference's breaker degrade (single-block runs
on the host while its circuit breaker is open) is not here. A catch-up
flush that raises ends the verify stage; the error is kept in
`verify_error`, and node/node.py raises it from wait_for_height and stop.
Nothing is retried on the CPU.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import List, Optional

from tendermint_tpu_torch.blocksync.checkpoint import CatchupCheckpoint
from tendermint_tpu_torch.blocksync.messages import (
    BlockRequest,
    BlockResponse,
    NoBlockResponse,
    StatusRequest,
    StatusResponse,
    decode_message,
    encode_message,
)
from tendermint_tpu_torch.blocksync.pool import BlockPool
from tendermint_tpu_torch.blocksync.verify import verify_run_batched
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE, PeerBehaviour
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.types.basic import BlockID

logger = logging.getLogger("tendermint_tpu_torch.blocksync")

BLOCKSYNC_CHANNEL = 0x40
STATUS_UPDATE_INTERVAL = 2.0
SWITCH_TO_CONSENSUS_INTERVAL = 0.5
# Run cap. The flush planner bounds device memory at its chunk budget
# whatever the flush size (crypto/batch.py max_flush_lanes; the scheduler's
# catch-up lane also splits oversized flushes into planner chunks with a
# vote-preemption point between them), so longer runs amortize per-flush
# prep and give the cross-height batch more rows.
VERIFY_BATCH_BLOCKS = 64
# verified-but-unapplied blocks the pipeline may hold (backpressure bound:
# verify never runs more than ~2 super-batches ahead of apply)
PIPELINE_WINDOW = 2 * VERIFY_BATCH_BLOCKS


class BlocksyncReactor(Reactor):
    def __init__(self, state, block_exec, block_store, consensus_reactor=None,
                 active: bool = True, metrics=None,
                 peer_timeout: float = None, retry_sleep: float = None,
                 scheduler=None, checkpoint_path: Optional[str] = None, device=None):
        super().__init__("BLOCKSYNC")
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.consensus_reactor = consensus_reactor
        self.active = active  # False = serve blocks only (we're not syncing)
        self.metrics = metrics  # BlockSyncMetrics or None
        # global verification scheduler (crypto/scheduler.py): catch-up
        # verification rides the CATCHUP lane — it soaks idle device
        # capacity and yields to votes/light/admission (paused entirely at
        # overload pressure level 2)
        self.scheduler = scheduler
        # where a flush verifies when there is no scheduler (verify_batch's
        # device: None routes as the reference does, the card from 256 rows)
        self.device = device
        # a catch-up flush that raised: the verify stage stops, node/node.py
        # raises it (no fallback, ROADMAP D1)
        self.verify_error: Optional[BaseException] = None
        self.checkpoint = CatchupCheckpoint(checkpoint_path)
        # serving-fault hook (the reference's chaos/catchup.ServeFaults, or
        # any object with block_stalled / take_block_lie / corrupt_block):
        # when installed, the SERVING side of this reactor misbehaves on
        # schedule (stalls block requests or serves commit-tampered blocks)
        # so a test can exercise the syncing side's peer scoring and redo
        self.serve_faults = None
        # [fastsync] peer_timeout / retry_sleep (None = pool defaults)
        from tendermint_tpu_torch.blocksync.pool import PEER_TIMEOUT, RETRY_SLEEP

        self.peer_timeout = PEER_TIMEOUT if peer_timeout is None else peer_timeout
        self.retry_sleep = RETRY_SLEEP if retry_sleep is None else retry_sleep
        self.pool: Optional[BlockPool] = None
        self._tasks: List[asyncio.Task] = []
        self.synced = asyncio.Event()
        self._started_at = 0.0
        # -- pipeline state --------------------------------------------------
        # verified triples (first, parts, second) awaiting apply, in height
        # order; _verified_event wakes the apply stage
        self._verified: deque = deque()
        self._verified_event = asyncio.Event()
        self._verify_cursor = 0  # next height the verify stage examines

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(BLOCKSYNC_CHANNEL, priority=5, send_queue_capacity=1000)]

    async def start(self) -> None:
        if not self.active:
            return
        self._started_at = time.monotonic()
        if self.metrics is not None:
            self.metrics.syncing.set(1)
        self._resume_from_checkpoint()
        self.pool = BlockPool(
            self.state.last_block_height + 1, self._send_request, self._punish_peer,
            metrics=self.metrics,
            peer_timeout=self.peer_timeout, retry_sleep=self.retry_sleep,
        )
        self._verify_cursor = self.pool.height
        self._verified.clear()
        self._verified_event.clear()
        self.pool.start()
        self._tasks = [
            asyncio.create_task(self._verify_routine(), name="bcverify"),
            asyncio.create_task(self._apply_routine(), name="bcapply"),
            asyncio.create_task(self._status_routine(), name="bcstatus"),
        ]

    async def stop(self) -> None:
        if self.pool:
            self.pool.stop()
        for t in self._tasks:
            t.cancel()

    # -- checkpoint resume ---------------------------------------------------

    def _resume_from_checkpoint(self) -> None:
        """Apply the persisted verified-but-unapplied window (crash-mid-
        blocksync resume): the commits were already super-batch verified
        before the crash, so the blocks re-enter at the APPLY stage."""
        blocks = self.checkpoint.load(self.state.last_block_height)
        if len(blocks) < 2:
            return
        # anchor proof: the first resumed block must extend OUR chain
        if (
            self.state.last_block_height > 0
            and blocks[0].header.last_block_id.hash != self.state.last_block_id.hash
        ):
            logger.warning("catch-up checkpoint does not extend our chain; discarding")
            self.checkpoint.clear()
            return
        from tendermint_tpu_torch.types.part_set import PartSet

        n = 0
        try:
            for first, second in zip(blocks, blocks[1:]):
                parts = PartSet.from_data(first.encode())
                self._apply(first, parts, second)
                n += 1
        except Exception:
            # a failure the linkage proof can't cover (app lost its
            # post-crash state, validate failure, app blip) must not
            # crash-loop node startup: discard the checkpoint and fall
            # through to normal re-fetch from wherever state stands now
            logger.exception(
                "checkpoint replay failed after %d blocks; discarding "
                "checkpoint and re-fetching", n,
            )
            self.checkpoint.clear()
        if n and self.metrics is not None:
            self.metrics.resume_events_total.inc()
            self.metrics.blocks_applied_total.inc(n)
        if n:
            logger.info(
                "resumed catch-up from checkpoint: %d verified blocks applied "
                "without re-verification (now at height %d)",
                n, self.state.last_block_height,
            )

    def _write_checkpoint(self) -> None:
        """Persist the current verified-but-unapplied window. Called at
        verify-run boundaries and when the window drains — atomic writes,
        so a crash at any point leaves either the old or the new file.
        The window entries carry their already-encoded bytes (computed for
        PartSet.from_data at fetch-drain time), so a rewrite never
        re-encodes the whole window."""
        if not self.checkpoint.enabled:
            return
        blocks = [t[3] for t in self._verified]
        if self._verified:
            blocks.append(self._verified[-1][2].encode())  # trailing commit carrier
        self.checkpoint.save(self.state.last_block_height, blocks)

    async def _send_request(self, peer_id: str, height: int) -> None:
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            await peer.send(BLOCKSYNC_CHANNEL, encode_message(BlockRequest(height)))

    async def _punish_peer(self, peer_id: str, reason: str) -> None:
        """Drop the peer (reference: stop_peer_for_error), after recording
        the misconduct with the switch's trust reporter, so that the peer's
        trust score keeps it (p2p/behaviour.py)."""
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            await self.switch.reporter.report(PeerBehaviour(peer_id, BAD_MESSAGE, reason))
            await self.switch.stop_peer_for_error(peer, reason)

    # -- peers -------------------------------------------------------------

    async def add_peer(self, peer) -> None:
        await peer.send(
            BLOCKSYNC_CHANNEL,
            encode_message(StatusResponse(self.block_store.height, self.block_store.base)),
        )
        if self.active:
            await peer.send(BLOCKSYNC_CHANNEL, encode_message(StatusRequest()))

    async def remove_peer(self, peer, reason) -> None:
        if self.pool:
            self.pool.remove_peer(peer.id)

    # -- receive -----------------------------------------------------------

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            msg = decode_message(msg_bytes)
        except Exception as e:
            await self.switch.stop_peer_for_error(peer, e)
            return
        sf = self.serve_faults
        if isinstance(msg, BlockRequest):
            if sf is not None and sf.block_stalled():
                return  # a stalling peer swallows the request
            block = self.block_store.load_block(msg.height)
            if block is not None:
                if sf is not None and sf.take_block_lie():
                    block = sf.corrupt_block(block)
                await peer.send(BLOCKSYNC_CHANNEL, encode_message(BlockResponse(block)))
            else:
                await peer.send(BLOCKSYNC_CHANNEL, encode_message(NoBlockResponse(msg.height)))
        elif isinstance(msg, StatusRequest):
            await peer.send(
                BLOCKSYNC_CHANNEL,
                encode_message(StatusResponse(self.block_store.height, self.block_store.base)),
            )
        elif isinstance(msg, StatusResponse):
            if self.pool:
                self.pool.set_peer_range(peer.id, msg.base, msg.height)
        elif isinstance(msg, BlockResponse):
            if self.pool:
                self.pool.add_block(peer.id, msg.block)
        elif isinstance(msg, NoBlockResponse):
            logger.debug("peer %s has no block %d", peer.id[:10], msg.height)

    async def switch_to_blocksync(self, state) -> None:
        """Post-state-sync handoff: start syncing blocks from the restored
        height (reference: blockchain/v0/reactor.go:116 SwitchToFastSync)."""
        self.state = state
        self.active = True
        self._started_at = time.monotonic()
        await self.start()
        await self.switch.broadcast(BLOCKSYNC_CHANNEL, encode_message(StatusRequest()))

    # -- sync --------------------------------------------------------------

    async def _status_routine(self) -> None:
        try:
            while True:
                await self.switch.broadcast(BLOCKSYNC_CHANNEL, encode_message(StatusRequest()))
                if self.metrics is not None and self.pool is not None:
                    # per-peer score gauges REPLACED each pass: departed
                    # peers' series drop instead of exposing stale scores
                    self.metrics.peer_score.replace_series({
                        (pid[:10],): st["score"]
                        for pid, st in self.pool.peer_stats().items()
                    })
                await asyncio.sleep(STATUS_UPDATE_INTERVAL)
        except asyncio.CancelledError:
            pass

    def _verify_run_batched(self, run: List[tuple]) -> Optional[int]:
        """One flush over all (first, parts, second, encoded) tuples: first's
        commit is second.last_commit, checked against the CURRENT validator
        set (blocksync/verify.verify_run_batched; reference: VerifyCommitLight
        per block). Returns the index of the first failing tuple, or None.

        Validator sets can change mid-run (H+2 rule); the caller only
        *punishes* when index 0 fails at the exact head of the applied chain
        — later failures may just mean the set changed, and those heights
        are re-verified as the head of the next run against the then-correct
        set."""
        vals = self.state.validators
        if self.metrics is not None:
            rows = sum(
                sum(1 for cs_sig in second.last_commit.signatures if cs_sig.for_block())
                for _first, _parts, second, *_ in run
                if len(second.last_commit.signatures) == vals.size()
            )
            if rows:
                self.metrics.super_batch_rows.observe(rows)
        return verify_run_batched(vals, self.state.chain_id, run, device=self.device,
                                  scheduler=self.scheduler)

    async def _verify_routine(self) -> None:
        """Stage 2: drain contiguous downloaded runs and super-batch verify
        them off-loop, feeding the apply stage's bounded window."""
        from tendermint_tpu_torch.types.part_set import PartSet

        while True:
            try:
                await asyncio.sleep(0.02)
                if self.synced.is_set():
                    return
                # backpressure: never verify more than PIPELINE_WINDOW ahead
                # of the apply stage
                room = PIPELINE_WINDOW - len(self._verified)
                if room <= 0:
                    continue
                cap = min(VERIFY_BATCH_BLOCKS, room)

                run = []
                h = self._verify_cursor
                while len(run) < cap:
                    first = self.pool.get_block(h)
                    second = self.pool.get_block(h + 1)
                    if first is None or second is None:
                        break
                    enc = first.encode()
                    run.append((first, PartSet.from_data(enc), second, enc))
                    h += 1
                if not run:
                    continue

                # batched verification across blocks x validators, one
                # flush for the whole run. Off-loop:
                # the catch-up lane may hold these rows for its idle-soak
                # window (or pause them under overload), and that wait must
                # park an executor thread, never the shared event loop —
                # which is also what overlaps this verify with the apply
                # stage's ABCI replay of the previous run
                _tv0 = time.perf_counter()
                try:
                    bad = await asyncio.get_running_loop().run_in_executor(
                        None, self._verify_run_batched, run
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # the flush itself failed (a device error): no retry
                    # and no host verify; the node raises it
                    logger.exception("catch-up verification failed; blocksync stops")
                    self.verify_error = e
                    return
                if self.metrics is not None:
                    self.metrics.verify_seconds.observe(time.perf_counter() - _tv0)
                n_ok = len(run) if bad is None else bad
                for triple in run[:n_ok]:
                    self._verified.append(triple)
                    self._verify_cursor += 1
                if n_ok:
                    self._verified_event.set()
                    self._write_checkpoint()
                if bad == 0:
                    if self._verify_cursor == self.state.last_block_height + 1:
                        # failed against the verified-CURRENT valset: bad
                        # data. Punish both providers of the offending pair
                        # and refetch
                        bad_height = self._verify_cursor
                        for h2 in (bad_height, bad_height + 1):
                            peer_id = self.pool.redo_request(h2)
                            if peer_id:
                                await self._punish_peer(peer_id, "invalid block/commit")
                    else:
                        # applies are still draining — the valset for this
                        # height may change once they land; re-verify then
                        # instead of punishing on a stale set
                        await asyncio.sleep(0.05)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("verify stage iteration failed; retrying")
                await asyncio.sleep(0.5)

    async def _apply_routine(self) -> None:
        """Stage 3: drain verified blocks into ABCI replay + the block store,
        and run the caught-up handoff check
        (reference: blockchain/v0/reactor.go:207 poolRoutine's apply half)."""
        last_switch_check = 0.0
        while True:
            try:
                now = time.monotonic()
                if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                    last_switch_check = now
                    if not self._verified and self._caught_up():
                        await self._switch_to_consensus()
                        return
                if not self._verified:
                    self._verified_event.clear()
                    try:
                        await asyncio.wait_for(
                            self._verified_event.wait(), SWITCH_TO_CONSENSUS_INTERVAL
                        )
                    except asyncio.TimeoutError:
                        pass
                    continue
                # peek-apply-pop: a transient apply failure (app blip) must
                # leave the triple in the window so the retry below re-applies
                # it — popping first would drop the block and wedge the sync
                first, parts, second, _enc = self._verified[0]
                self._apply(first, parts, second)
                self._verified.popleft()
                self.pool.pop_request()
                if self.metrics is not None:
                    self.metrics.blocks_applied_total.inc()
                if not self._verified:
                    # window drained: record the advanced applied height so a
                    # crash right now resumes without any re-verification
                    self._write_checkpoint()
                # yield so the verify stage / receive loop interleave with a
                # long replay drain
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                return
            except Exception:
                # transient failures (app hiccough, connection blip) must not
                # kill the sync: consensus never starts if this task dies
                logger.exception("apply stage iteration failed; retrying")
                await asyncio.sleep(0.5)

    def _apply(self, block, parts, second) -> None:
        block_id = BlockID(block.hash(), parts.header)
        # the commit FOR this block travels in the next block's last_commit
        # (reference: reactor.go SaveBlock(first, firstParts, second.LastCommit))
        self.block_store.save_block(block, parts, second.last_commit)
        # trust_last_commit: the block's signatures were verified in the
        # super-batch (or the checkpoint proves a pre-crash batch did);
        # skip the per-block re-verification inside ApplyBlock — UNLESS the
        # validator set drifted between verify and apply (H+2 rule landing
        # mid-pipeline), in which case ApplyBlock re-verifies against the
        # now-correct set
        trust = block.header.validators_hash == self.state.validators.hash()
        self.state = self.block_exec.apply_block(
            self.state, block_id, block, trust_last_commit=trust
        )

    def _caught_up(self) -> bool:
        if self.pool.num_peers() == 0 and time.monotonic() - self._started_at < 5.0:
            return False  # give peers a moment to report
        max_h = self.pool.max_peer_height()
        # within one block of the best-known head counts as caught up: the
        # pool can never apply the head itself (it needs head+1's LastCommit),
        # and on a live chain the head keeps moving — consensus catchup gossip
        # closes the final gap after the handoff (reference: v0 pool
        # IsCaughtUp + consensus reactor catchup).
        return self.pool.num_peers() > 0 and self.pool.height + 1 >= max_h

    async def _switch_to_consensus(self) -> None:
        logger.info("fast sync complete at height %d; switching to consensus", self.state.last_block_height)
        if self.metrics is not None:
            self.metrics.syncing.set(0)
        self.pool.stop()
        self.checkpoint.clear()
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()  # stop the verify stage + periodic StatusRequests
        self.synced.set()
        if self.consensus_reactor is not None:
            self.consensus_reactor.cs.state = None  # force update_to_state
            self.consensus_reactor.cs._update_to_state(self.state)
            if self.state.last_block_height > 0:
                self.consensus_reactor.cs._reconstruct_last_commit(self.state)
            await self.consensus_reactor.switch_to_consensus(self.state)
