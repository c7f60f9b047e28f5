"""BlockPool: concurrent per-height block requesters for fast sync
(reference: blockchain/v0/pool.go:62,107).

The pool tracks peers' reported heights, keeps up to `request_window` heights
in flight, assigns each height to a peer, and exposes a sliding window of
downloaded blocks to the reactor (peek_two_blocks / pop_request).

Peer quality is tracked per peer as an EWMA score fed by three signals —
request timeouts, bad blocks (failed commit verification), and response
latency — and drives three decisions:

  * routing: `_pick_peer` weights the random peer choice by score, so a
    slow-but-honest peer keeps serving while a flaky one drains to zero
    traffic instead of being re-picked at uniform odds;
  * backoff: each failure puts the peer in an exponentially growing
    cool-down (reset by the next good block) during which it is not
    assigned new heights;
  * ban: when the score falls below `ban_threshold` the peer is removed
    from the pool and punished through the reactor's punish callback (the
    switch routes that to the trust scorer, which disconnects).

A single timeout therefore does not disconnect a peer: during a mass rejoin every serving peer is slow, and evicting the
whole peer set on first timeout would leave the pool with nobody to sync
from.

The port's copy of tendermint_tpu/blocksync/pool.py.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

logger = logging.getLogger("tendermint_tpu_torch.blocksync")

# Max heights in flight (reference: maxPendingRequests-ish). Sized to feed
# the reactor's 64-block super-batch runs (VERIFY_BATCH_BLOCKS) with
# fetch-ahead to spare — a window smaller than the run cap can never
# assemble a full run, silently shrinking every super-batch.
REQUEST_WINDOW = 96
# defaults for the [fastsync] peer_timeout / retry_sleep config knobs
# (kept as module constants for tests and non-config callers)
PEER_TIMEOUT = 10.0
RETRY_SLEEP = 0.05

# peer-score knobs (module constants: the defaults survived the rejoin soak;
# promote to config only when a deployment actually needs to tune them)
SCORE_ALPHA = 0.25          # EWMA step per observation
BAD_BLOCK_WEIGHT = 2        # a bad block counts this many failure steps
BAN_THRESHOLD = 0.25        # score below this => remove + punish
BACKOFF_BASE = 0.5          # first failure cool-down (seconds)
BACKOFF_MAX = 15.0
MAX_PENDING_PER_PEER = 20


@dataclass
class _PoolPeer:
    peer_id: str
    height: int = 0
    base: int = 0
    pending: int = 0
    # -- quality tracking --------------------------------------------------
    score: float = 1.0           # EWMA of success(1)/failure(0) observations
    latency_s: float = 0.0       # EWMA of block response latency
    failures: int = 0            # consecutive failures (drives backoff)
    backoff_until: float = 0.0   # monotonic deadline; not assignable before
    timeouts: int = 0
    bad_blocks: int = 0
    blocks_served: int = 0

    def record_good(self, latency: float) -> None:
        self.score += SCORE_ALPHA * (1.0 - self.score)
        self.latency_s = (
            latency if self.blocks_served == 0
            else self.latency_s + SCORE_ALPHA * (latency - self.latency_s)
        )
        self.blocks_served += 1
        self.failures = 0
        self.backoff_until = 0.0

    def record_failure(self, weight: int = 1) -> None:
        for _ in range(weight):
            self.score -= SCORE_ALPHA * self.score
        self.failures += 1
        self.backoff_until = time.monotonic() + min(
            BACKOFF_BASE * (2 ** (self.failures - 1)), BACKOFF_MAX
        )

    def banned(self) -> bool:
        return self.score < BAN_THRESHOLD


@dataclass
class _Requester:
    height: int
    peer_id: str = ""
    block: Optional[object] = None
    requested_at: float = field(default_factory=lambda: time.monotonic())


class BlockPool:
    def __init__(self, start_height: int, send_request: Callable, punish_peer: Callable,
                 metrics=None, peer_timeout: float = PEER_TIMEOUT,
                 retry_sleep: float = RETRY_SLEEP):
        """send_request(peer_id, height) -> awaitable; punish_peer(peer_id, reason);
        metrics: an optional BlockSyncMetrics (num_peers / latest_block_height);
        peer_timeout/retry_sleep: [fastsync] knobs (defaults unchanged)."""
        self.height = start_height  # next height to pop
        self.metrics = metrics
        self.peer_timeout = peer_timeout
        self.retry_sleep = retry_sleep
        self._peers: Dict[str, _PoolPeer] = {}
        self._requesters: Dict[int, _Requester] = {}
        self._send_request = send_request
        self._punish_peer = punish_peer
        self._task: Optional[asyncio.Task] = None
        self._running = False

    def start(self) -> None:
        self._running = True
        self._task = asyncio.create_task(self._make_requests_routine(), name="pool-requests")

    def stop(self) -> None:
        self._running = False
        if self._task:
            self._task.cancel()

    # -- peers -------------------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        p = self._peers.get(peer_id)
        if p is None:
            p = self._peers[peer_id] = _PoolPeer(peer_id)
        p.base, p.height = base, height
        if self.metrics is not None:
            self.metrics.num_peers.set(len(self._peers))

    def remove_peer(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)
        if self.metrics is not None:
            self.metrics.num_peers.set(len(self._peers))
        for req in self._requesters.values():
            if req.peer_id == peer_id and req.block is None:
                req.peer_id = ""
                req.requested_at = time.monotonic()

    def max_peer_height(self) -> int:
        return max((p.height for p in self._peers.values()), default=0)

    def num_peers(self) -> int:
        return len(self._peers)

    def peer_stats(self) -> Dict[str, dict]:
        """Per-peer quality snapshot (reactor metrics sampling + /debug)."""
        return {
            pid: {
                "score": round(p.score, 4),
                "latency_ms": round(p.latency_s * 1e3, 3),
                "pending": p.pending,
                "timeouts": p.timeouts,
                "bad_blocks": p.bad_blocks,
                "blocks_served": p.blocks_served,
                "backoff_s": round(max(0.0, p.backoff_until - time.monotonic()), 3),
            }
            for pid, p in self._peers.items()
        }

    # -- blocks ------------------------------------------------------------

    def add_block(self, peer_id: str, block) -> bool:
        req = self._requesters.get(block.header.height)
        if req is None or req.block is not None:
            return False
        if req.peer_id != peer_id:
            # only the assigned requester's peer may fill the slot — otherwise
            # a bad block is unattributable and an attacker can pre-fill
            # heights with junk that is never re-requested (reference:
            # pool.go AddBlock checks the requester's peer)
            return False
        req.block = block
        p = self._peers.get(peer_id)
        if p:
            p.pending = max(0, p.pending - 1)
            p.record_good(time.monotonic() - req.requested_at)
        return True

    def get_block(self, height: int):
        """Downloaded block at height, or None."""
        req = self._requesters.get(height)
        return req.block if req else None

    def pop_request(self) -> None:
        """first block was applied: advance (reference: pool.go PopRequest)."""
        self._requesters.pop(self.height, None)
        self.height += 1
        if self.metrics is not None:
            self.metrics.latest_block_height.set(self.height)

    def _unassign(self, req: _Requester) -> str:
        """Return a request to the unassigned state, keeping the previous
        peer's pending count consistent (a redo that leaked one pending slot
        per redo would eventually wedge the peer at the
        MAX_PENDING_PER_PEER cap with zero real requests in flight)."""
        prev = req.peer_id
        if prev:
            p = self._peers.get(prev)
            if p is not None and req.block is None:
                p.pending = max(0, p.pending - 1)
        req.block = None
        req.peer_id = ""
        req.requested_at = time.monotonic()
        return prev

    def redo_request(self, height: int) -> str:
        """Block failed validation: unassign + requeue the height, record a
        bad block against the sender (reference: pool.go RedoRequest). The
        caller decides whether to punish (only a head-of-window failure is
        attributable — see reactor._verify_run_batched)."""
        req = self._requesters.get(height)
        if req is None:
            return ""
        bad_peer = req.peer_id
        if req.block is not None:
            # the peer's pending slot was already released at add_block; undo
            # the `record_good` optimism with a weighted failure
            p = self._peers.get(bad_peer)
            if p is not None:
                p.bad_blocks += 1
                p.record_failure(BAD_BLOCK_WEIGHT)
            req.block = None
            req.peer_id = ""
            req.requested_at = time.monotonic()
        else:
            # in-flight redo (e.g. the partner height of a failed pair):
            # release the assigned peer's pending slot too
            self._unassign(req)
        if self.metrics is not None:
            self.metrics.redos_total.inc()
        return bad_peer

    # -- request scheduling -------------------------------------------------

    def _pick_peer(self, height: int) -> Optional[_PoolPeer]:
        now = time.monotonic()
        candidates = [
            p for p in self._peers.values()
            if p.base <= height <= p.height
            and p.pending < MAX_PENDING_PER_PEER
            and p.backoff_until <= now
        ]
        if not candidates:
            return None
        # score-weighted routing: a peer at score 1.0 is ~20x likelier than
        # one hovering just above the ban threshold
        weights = [max(p.score, 0.05) for p in candidates]
        return random.choices(candidates, weights=weights, k=1)[0]

    async def _ban_if_bad(self, p: _PoolPeer, reason: str) -> bool:
        if not p.banned():
            return False
        logger.info("blocksync peer %s score %.2f below ban threshold (%s)",
                    p.peer_id[:10], p.score, reason)
        await self._punish_peer(p.peer_id, reason)
        self.remove_peer(p.peer_id)
        return True

    async def _make_requests_routine(self) -> None:
        try:
            while self._running:
                # spawn requesters for the window
                max_h = self.max_peer_height()
                next_h = self.height
                while (
                    len(self._requesters) < REQUEST_WINDOW
                    and next_h <= max_h
                ):
                    if next_h not in self._requesters:
                        self._requesters[next_h] = _Requester(next_h, "")
                    next_h += 1
                # assign unassigned / timed-out requesters
                now = time.monotonic()
                for req in list(self._requesters.values()):
                    if req.block is not None:
                        continue
                    if req.peer_id and now - req.requested_at > self.peer_timeout:
                        if self.metrics is not None:
                            self.metrics.peer_timeouts.inc()
                        p = self._peers.get(req.peer_id)
                        timed_out = self._unassign(req)
                        if p is not None:
                            p.timeouts += 1
                            p.record_failure()
                            # ban only a peer whose EWMA proves a pattern: a
                            # single timeout during a rejoin storm is backoff,
                            # not a disconnect
                            await self._ban_if_bad(
                                p, f"block request timeout (height {req.height})"
                            )
                        else:
                            logger.debug("timeout for departed peer %s", timed_out[:10])
                    if not req.peer_id and req.block is None:
                        peer = self._pick_peer(req.height)
                        if peer is None:
                            continue
                        req.peer_id = peer.peer_id
                        req.requested_at = time.monotonic()
                        peer.pending += 1
                        await self._send_request(peer.peer_id, req.height)
                await asyncio.sleep(self.retry_sleep)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("pool request routine died")
