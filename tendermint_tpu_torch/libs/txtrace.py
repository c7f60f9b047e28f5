"""Transaction lifecycle tracker: the port's copy of
tendermint_tpu/libs/txtrace.py (`TxTracker`, `StageStats`).

A per-tx journey through the serving path's stages:

    received(rpc|gossip)
      -> checked(code, priority)                  [app CheckTx verdict]
      -> admitted | rejected{reason} | evicted | expired   [mempool admission]
      -> first_gossiped                           [first successful peer send]
      -> proposed(height, round)                  [included in a complete
                                                   proposal block]
      -> committed(height, index)                 [block finalized]
      -> delivered(code)                          [ABCI DeliverTx verdict]

Feeders in the port: rpc/server.py (`received` at the RPC edge),
mempool/mempool.py (admission, eviction, TTL, quotas, recheck),
consensus/cs_state.py (proposal inclusion, commit) and state/execution.py
(the deliver path); `first_gossiped` waits for the mempool reactor (ROADMAP
A3). Consumers: `waterfall(hash)` (the `tx_status` and /debug/tx_trace
routes of rpc/server.py),
`tendermint_tx_stage_seconds{stage}` histograms and terminal-outcome
counters (libs/metrics.TxLifecycleMetrics), and the `tx_commit_latency`
SLO budget (libs/slo.py). `StageStats` also serves the light service's
per-request spans and the scheduler's lane waits.

Overhead: recording is gated on the flight recorder's `tracer.enabled`
flag, so with tracing disabled every hook is one attribute read and one
flag check. The ring is bounded (`max_txs`, oldest journey evicted first).

Only txs first seen at ingress (`received`) are tracked: blocks replayed
from elsewhere deliver foreign txs whose journeys never started here.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional

from tendermint_tpu_torch.libs.trace import tracer as _tracer

__all__ = ["TxTracker", "StageStats", "STAGES", "TERMINAL_STAGES"]

# the happy-path stage order (the waterfall renders stages in recorded
# order, which matches this when the journey completes)
STAGES = (
    "received",
    "checked",
    "admitted",
    "first_gossiped",
    "proposed",
    "committed",
    "delivered",
)

# stages that END a journey. A later `received` for the same hash starts a
# fresh journey ONLY for the re-enterable terminals (rejected/evicted/
# expired — mempool admission un-caches those txs exactly so they can
# resubmit); a DELIVERED journey is never reset: the dedup cache blocks a
# committed tx's replay, and a client re-broadcasting one must still get
# the delivered waterfall from tx_status, not a rejected:cache overwrite.
TERMINAL_STAGES = ("rejected", "evicted", "expired", "delivered")
_RESETTABLE_TERMINALS = frozenset(("rejected", "evicted", "expired"))

_KNOWN_STAGES = frozenset(STAGES) | frozenset(TERMINAL_STAGES)

DEFAULT_MAX_TXS = 8192


class StageStats:
    """Bounded per-stage duration reservoirs with percentile summaries.

    Shared by the tx tracker (per-transition latencies) and the light
    service's per-request spans: both need "p50/p99 per stage" served from a
    debug endpoint without unbounded growth. Thread-safe; `observe` is an
    O(1) deque append, percentiles sort only on read (a debug-scrape-rate
    operation)."""

    def __init__(self, maxlen: int = 512):
        self._maxlen = max(8, int(maxlen))
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}
        self._counts: Dict[str, int] = {}
        self._max: Dict[str, float] = {}

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            dq = self._samples.get(stage)
            if dq is None:
                dq = self._samples[stage] = deque(maxlen=self._maxlen)
            dq.append(seconds)
            self._counts[stage] = self._counts.get(stage, 0) + 1
            if seconds > self._max.get(stage, 0.0):
                self._max[stage] = seconds

    def percentiles(self) -> Dict[str, dict]:
        """{stage: {count, p50_ms, p99_ms, max_ms}} over the retained
        reservoir (count is lifetime; percentiles cover the newest
        `maxlen` samples)."""
        with self._lock:
            snap = {k: sorted(dq) for k, dq in self._samples.items() if dq}
            counts = dict(self._counts)
            maxes = dict(self._max)
        out: Dict[str, dict] = {}
        for stage, vals in snap.items():
            def pct(p: float) -> float:
                return vals[min(len(vals) - 1, int(p * len(vals)))]

            out[stage] = {
                "count": counts.get(stage, len(vals)),
                "p50_ms": round(pct(0.50) * 1e3, 3),
                "p99_ms": round(pct(0.99) * 1e3, 3),
                "max_ms": round(maxes.get(stage, vals[-1]) * 1e3, 3),
            }
        return out


class _TxRecord:
    __slots__ = ("stages", "terminal")

    def __init__(self):
        # [(stage, wall_ts, mono_ts, attrs)]
        self.stages: List[tuple] = []
        self.terminal: Optional[str] = None

    def has(self, stage: str) -> bool:
        return any(s[0] == stage for s in self.stages)


class TxTracker:
    """The bounded per-tx journey ring. One per node (node/node.py wires it
    from `[instrumentation] txtrace_*`); thread-safe — feeders run on the
    event loop, executor threads (mempool check_tx), and the consensus
    receive loop."""

    def __init__(self, max_txs: int = DEFAULT_MAX_TXS, metrics=None, slo=None):
        self.max_txs = max(16, int(max_txs))
        self.metrics = metrics  # libs/metrics.TxLifecycleMetrics or None
        self.slo = slo  # libs/slo.SLOEngine or None
        self._lock = threading.Lock()
        self._ring: "OrderedDict[bytes, _TxRecord]" = OrderedDict()
        self.stage_stats = StageStats()
        # lifetime counters (served by stats())
        self.recorded_total = 0
        self.evicted_records = 0  # journeys pushed out of the ring
        self.terminals: Dict[str, int] = {}
        self.stage_counts: Dict[str, int] = {}

    # -- recording ------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """Follows the flight recorder's flag: disabling tracing disables
        the tx observatory with it (one flag, one contract)."""
        return _tracer.enabled

    def record(self, tx_hash: bytes, stage: str, **attrs) -> bool:
        """Record one stage transition for `tx_hash`. Returns True when the
        transition was recorded (False: tracking disabled, unknown tx for a
        non-ingress stage, or duplicate stage). Never raises: a tracker must
        not take down the path it measures."""
        if not _tracer.enabled or stage not in _KNOWN_STAGES:
            return False
        now_w, now_m = time.time(), time.perf_counter()
        with self._lock:
            rec = self._ring.get(tx_hash)
            if rec is None or (
                stage == "received" and rec.terminal in _RESETTABLE_TERMINALS
            ):
                if stage != "received":
                    # only journeys that started at ingress are tracked (see
                    # module docstring: blocksync replay must not flush the
                    # ring with foreign txs)
                    return False
                rec = _TxRecord()
                self._ring[tx_hash] = rec
                self._ring.move_to_end(tx_hash)
                while len(self._ring) > self.max_txs:
                    self._ring.popitem(last=False)
                    self.evicted_records += 1
            else:
                if rec.terminal is not None:
                    # a terminal ENDS the journey: a tx evicted here but
                    # later committed via a peer's block must not overwrite
                    # its terminal or double-count the outcome counters —
                    # only a fresh `received` (handled above) re-opens it
                    return False
                if rec.has(stage):
                    return False  # first occurrence wins (e.g. re-gossip)
            prev_mono = rec.stages[-1][2] if rec.stages else None
            received_mono = rec.stages[0][2] if rec.stages else now_m
            rec.stages.append((stage, now_w, now_m, attrs))
            if stage in TERMINAL_STAGES:
                rec.terminal = stage
                self.terminals[stage] = self.terminals.get(stage, 0) + 1
                reason = attrs.get("reason")
                if reason:
                    key = f"{stage}:{reason}"
                    self.terminals[key] = self.terminals.get(key, 0) + 1
            self.recorded_total += 1
            self.stage_counts[stage] = self.stage_counts.get(stage, 0) + 1
        dur = (now_m - prev_mono) if prev_mono is not None else 0.0
        self.stage_stats.observe(stage, dur)
        m = self.metrics
        if m is not None:
            m.stage_seconds.labels(stage).observe(dur)
            if stage in TERMINAL_STAGES:
                m.terminal_total.labels(stage).inc()
            m.tracked.set(len(self._ring))
        if stage == "committed" and self.slo is not None:
            # the user-facing end-to-end budget: first receipt -> commit
            self.slo.observe("tx_commit_latency", max(0.0, now_m - received_mono))
        return True

    def record_block(
        self, stage: str, height: int, round_: int, txs: Iterable[bytes]
    ) -> None:
        """Stage transition for every tracked tx of a block (proposal
        inclusion / commit). Hashing cost is gated behind `enabled` at the
        call site AND here; an EMPTY ring skips the per-tx hashing entirely
        (blocksync catch-up replays thousands of foreign blocks on a fresh
        node — none of their txs can be tracked)."""
        if not _tracer.enabled or not self._ring:
            return
        from tendermint_tpu_torch.crypto import tmhash

        for i, tx in enumerate(txs):
            self.record(
                tmhash.sum256(tx), stage, height=height, round=round_, index=i
            )

    def record_delivered(self, height: int, txs, responses) -> None:
        """ABCI deliver verdicts for a finalized block's txs (same
        empty-ring fast path as record_block)."""
        if not _tracer.enabled or not self._ring:
            return
        from tendermint_tpu_torch.crypto import tmhash

        for i, (tx, res) in enumerate(zip(txs, responses)):
            self.record(
                tmhash.sum256(tx), "delivered",
                height=height, index=i, code=getattr(res, "code", None),
            )

    # -- introspection --------------------------------------------------------

    def waterfall(self, tx_hash: bytes) -> Optional[dict]:
        """The `tx_status` document: the journey's stages in recorded order
        with wall timestamps, per-stage durations, and offsets from first
        receipt. None when the tx was never tracked (or its journey was
        evicted from the ring)."""
        with self._lock:
            rec = self._ring.get(tx_hash)
            if rec is None:
                return None
            stages = list(rec.stages)
            terminal = rec.terminal
        t0_w, t0_m = stages[0][1], stages[0][2]
        prev_m = t0_m
        out_stages = []
        for stage, wall, mono, attrs in stages:
            out_stages.append(
                {
                    "stage": stage,
                    "ts": round(wall, 6),
                    "offset_ms": round((mono - t0_m) * 1e3, 3),
                    "dur_ms": round((mono - prev_m) * 1e3, 3),
                    **attrs,
                }
            )
            prev_m = mono
        return {
            "hash": tx_hash.hex().upper(),
            "terminal": terminal,
            "complete": terminal == "delivered",
            "first_seen_ts": round(t0_w, 6),
            "total_ms": round((stages[-1][2] - t0_m) * 1e3, 3),
            "stages": out_stages,
        }

    def stats(self) -> dict:
        """The hash-less `GET /debug/tx_trace` document (also captured into
        observatory dumps): ring occupancy, lifetime stage/terminal counts,
        and per-stage latency percentiles."""
        with self._lock:
            tracked = len(self._ring)
            recent = [h.hex().upper() for h in list(self._ring)[-8:]]
        return {
            "enabled": self.enabled,
            "tracked": tracked,
            "max_txs": self.max_txs,
            "recorded_total": self.recorded_total,
            "ring_evictions": self.evicted_records,
            "stage_counts": dict(self.stage_counts),
            "terminals": dict(self.terminals),
            "stage_percentiles": self.stage_stats.percentiles(),
            "recent_tx_hashes": recent,
        }
