"""Per-height/round consensus timeline ring: the port's copy of
tendermint_tpu/consensus/timeline.py, whole.

The distributed-system complement of libs/trace.py's device-side flight
recorder: a bounded, thread-safe record of WHERE each height spent its time
— step entries, round escalations, proposal/vote arrival, commit — kept as
structured per-height records instead of a flat span ring, so one GET of
`/debug/consensus_timeline` answers "why was height H slow?" without
grepping logs. The reference exposes only the *current* round state
(rpc/core/consensus.go DumpConsensusState); history dies with the round.

Two producers share this format:

- the live ConsensusState (consensus/cs_state.py) feeds wall-clock events
  while running (gated on `tracer.enabled`: with tracing off the hot path
  pays only flag checks and the ring stays empty);
- the reference's offline WAL inspector (tools/wal_inspect.py, ported with
  the tooling, ROADMAP A5) replays a node's WAL into the same structure,
  deriving timestamps from the signed vote/proposal times in the messages.

Overhead contract: every record_* call is a few dict/list operations under
one lock; per-round vote arrivals aggregate into a fixed bucket histogram
(VOTE_ARRIVAL_BUCKETS_MS), never an unbounded list.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

DEFAULT_MAX_HEIGHTS = 128

# vote-arrival offsets from round start, cumulative buckets in milliseconds
VOTE_ARRIVAL_BUCKETS_MS = (5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)

# per-hop propagation latencies (skew-corrected), buckets in milliseconds
PROPAGATION_BUCKETS_MS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)

# bounds on remote-supplied cardinality: a peer controls the origin id in a
# trace stamp, so per-origin tables cap out into an "_other" bucket instead
# of growing with whatever a flood invents; reactor-side recording also
# arrives BEFORE consensus validation, so round keys are capped too (a real
# net escalates a handful of rounds; a flood invents millions)
MAX_ORIGINS_PER_ROUND = 64
MAX_PEER_STATS_ORIGINS = 128
MAX_ROUNDS_PER_HEIGHT = 32
OVERFLOW_ORIGIN = "_other"


def _bucketize(buckets, counters: List[int], value_ms: float) -> None:
    for i, b in enumerate(buckets):
        if value_ms <= b:
            counters[i] += 1
            return
    counters[-1] += 1

# default for record_* ts args: "stamp with wall-clock now". The offline WAL
# inspector instead passes an explicit float (derived from signed message
# timestamps) or None ("no time reference yet" — the record is kept, its
# durations stay undefined).
_NOW = object()


class ConsensusTimeline:
    """Bounded ring of per-height consensus records, oldest evicted first."""

    def __init__(self, max_heights: int = DEFAULT_MAX_HEIGHTS):
        self.max_heights = max(1, int(max_heights))
        self._lock = threading.Lock()
        self._heights: "OrderedDict[int, dict]" = OrderedDict()
        # cross-height per-origin propagation aggregates (the per-peer lag
        # ranking the chain observatory merges): origin node id -> per-kind
        # {count, sum_ms, max_ms} plus how many samples were skew-corrected
        self._peer_stats: Dict[str, dict] = {}

    # -- recording ----------------------------------------------------------

    def _rec(self, height: int) -> dict:
        rec = self._heights.get(height)
        if rec is None:
            rec = {
                "height": height,
                "steps": [],  # [{"round", "step", "ts"}] in arrival order
                "round_start": {},  # round -> ts of its first step
                "proposals": [],  # [{"round", "ts"}]
                "votes": {},  # round -> {"prevote", "precommit", "arrival_ms"}
                # round -> cross-node propagation evidence (chain observatory):
                # first-seen proposal latency + origin/hops, and the block-part
                # gossip fan-out window (first..last part receipt)
                "propagation": {},
                "commit": None,  # {"round", "ts", "txs"}
                "end_height_ts": None,
            }
            self._heights[height] = rec
            while len(self._heights) > self.max_heights:
                self._heights.popitem(last=False)
        return rec

    def record_step(self, height: int, round_: int, step: str, ts=_NOW) -> None:
        ts = time.time() if ts is _NOW else ts
        with self._lock:
            rec = self._rec(height)
            rec["steps"].append({"round": round_, "step": step, "ts": ts})
            if ts is not None:
                rec["round_start"].setdefault(round_, ts)

    def record_proposal(self, height: int, round_: int, ts=_NOW) -> None:
        ts = time.time() if ts is _NOW else ts
        with self._lock:
            self._rec(height)["proposals"].append({"round": round_, "ts": ts})

    def record_vote(self, height: int, round_: int, vote_type: str, ts=_NOW) -> None:
        ts = time.time() if ts is _NOW else ts
        key = "prevote" if "PREVOTE" in vote_type.upper() else "precommit"
        with self._lock:
            rec = self._rec(height)
            votes = rec["votes"].get(round_)
            if votes is None:
                votes = rec["votes"][round_] = {
                    "prevote": 0,
                    "precommit": 0,
                    "arrival_ms": [0] * (len(VOTE_ARRIVAL_BUCKETS_MS) + 1),
                }
            votes[key] += 1
            start = rec["round_start"].get(round_)
            if start is not None and ts is not None:
                off_ms = max(0.0, (ts - start) * 1e3)
                _bucketize(VOTE_ARRIVAL_BUCKETS_MS, votes["arrival_ms"], off_ms)

    # -- cross-node propagation (chain observatory, ISSUE 8) ----------------

    def _prop(self, rec: dict, round_: int) -> Optional[dict]:
        prop = rec["propagation"].get(round_)
        if prop is None:
            if len(rec["propagation"]) >= MAX_ROUNDS_PER_HEIGHT:
                return None  # remote-supplied round flood: stop allocating
            prop = rec["propagation"][round_] = {
                # first-seen proposal receipt: skew-corrected latency from
                # the origin's stamp, who proposed it, and over how many hops
                "proposal_first_seen_ms": None,
                "proposal_origin": None,
                "proposal_hops": None,
                "proposal_receipts": 0,
                # block-part gossip fan-out window on THIS node
                "parts": 0,
                "parts_first_ts": None,
                "parts_last_ts": None,
                "part_latency_ms": [0] * (len(PROPAGATION_BUCKETS_MS) + 1),
            }
        return prop

    def record_proposal_propagation(
        self, height: int, round_: int, origin: str, latency_s: float,
        hops: int = 0, ts=_NOW,
    ) -> None:
        """A proposal ARRIVED from a peer: record the first-seen propagation
        latency (seconds, already skew-corrected and clamped >= 0 by the
        caller) for (height, round). Later duplicate receipts only count."""
        with self._lock:
            prop = self._prop(self._rec(height), round_)
            if prop is None:
                return
            prop["proposal_receipts"] += 1
            if prop["proposal_first_seen_ms"] is None:
                prop["proposal_first_seen_ms"] = round(latency_s * 1e3, 3)
                prop["proposal_origin"] = origin
                prop["proposal_hops"] = hops

    def record_block_part(
        self, height: int, round_: int, latency_s: Optional[float] = None, ts=_NOW
    ) -> None:
        """One gossiped block part arrived: widen the fan-out window (the
        dump derives parts_fanout_s = last - first receipt) and histogram
        its per-hop latency when a trace stamp supplied one."""
        ts = time.time() if ts is _NOW else ts
        with self._lock:
            prop = self._prop(self._rec(height), round_)
            if prop is None:
                return
            prop["parts"] += 1
            if ts is not None:
                if prop["parts_first_ts"] is None:
                    prop["parts_first_ts"] = ts
                prop["parts_last_ts"] = ts
            if latency_s is not None:
                _bucketize(
                    PROPAGATION_BUCKETS_MS, prop["part_latency_ms"], latency_s * 1e3
                )

    def record_vote_origin(
        self, height: int, round_: int, vote_type: str, origin: str,
        latency_s: Optional[float] = None,
    ) -> None:
        """Vote arrival attributed to its ORIGIN validator node (from the
        trace stamp; falls back to the direct peer id at the call site):
        per-origin counts + propagation-latency histogram, the evidence for
        'whose votes reach us last'. Origin cardinality is capped."""
        key = "prevote" if "PREVOTE" in vote_type.upper() else "precommit"
        with self._lock:
            rec = self._rec(height)
            votes = rec["votes"].get(round_)
            if votes is None:
                if len(rec["votes"]) >= MAX_ROUNDS_PER_HEIGHT:
                    return  # remote-supplied round flood: stop allocating
                votes = rec["votes"][round_] = {
                    "prevote": 0,
                    "precommit": 0,
                    "arrival_ms": [0] * (len(VOTE_ARRIVAL_BUCKETS_MS) + 1),
                }
            by_origin = votes.setdefault("by_origin", {})
            ent = by_origin.get(origin)
            if ent is None:
                if len(by_origin) >= MAX_ORIGINS_PER_ROUND:
                    origin = OVERFLOW_ORIGIN
                    ent = by_origin.get(origin)
                if ent is None:
                    ent = by_origin[origin] = {
                        "prevote": 0,
                        "precommit": 0,
                        "latency_ms": [0] * (len(PROPAGATION_BUCKETS_MS) + 1),
                        "max_ms": 0.0,
                    }
            ent[key] += 1
            if latency_s is not None:
                ms = latency_s * 1e3
                _bucketize(PROPAGATION_BUCKETS_MS, ent["latency_ms"], ms)
                if ms > ent["max_ms"]:
                    ent["max_ms"] = round(ms, 3)

    def record_hop(
        self, origin: str, kind: str, latency_s: float, skew_corrected: bool = False
    ) -> None:
        """Cross-height per-origin hop-latency aggregate over every traced
        message kind (proposal/block_part/vote/has_vote/round_step) — the
        per-peer lag ranking. Bounded per MAX_PEER_STATS_ORIGINS."""
        with self._lock:
            st = self._peer_stats.get(origin)
            if st is None:
                if len(self._peer_stats) >= MAX_PEER_STATS_ORIGINS:
                    origin = OVERFLOW_ORIGIN
                    st = self._peer_stats.get(origin)
                if st is None:
                    st = self._peer_stats[origin] = {
                        "kinds": {}, "skew_corrected": 0, "uncorrected": 0,
                    }
            k = st["kinds"].get(kind)
            if k is None:
                k = st["kinds"][kind] = {"count": 0, "sum_ms": 0.0, "max_ms": 0.0}
            ms = latency_s * 1e3
            k["count"] += 1
            k["sum_ms"] += ms
            if ms > k["max_ms"]:
                k["max_ms"] = ms
            if skew_corrected:
                st["skew_corrected"] += 1
            else:
                st["uncorrected"] += 1

    def peer_stats(self) -> Dict[str, dict]:
        """Per-origin propagation aggregates with derived means, worst
        origin first (by mean latency over all kinds)."""
        with self._lock:
            snap = {
                o: {
                    "kinds": {
                        k: {
                            "count": v["count"],
                            "mean_ms": round(v["sum_ms"] / v["count"], 3),
                            "max_ms": round(v["max_ms"], 3),
                        }
                        for k, v in st["kinds"].items()
                    },
                    "skew_corrected": st["skew_corrected"],
                    "uncorrected": st["uncorrected"],
                }
                for o, st in self._peer_stats.items()
            }
        for st in snap.values():
            total = sum(k["count"] for k in st["kinds"].values())
            st["count"] = total
            st["mean_ms"] = (
                round(
                    sum(k["mean_ms"] * k["count"] for k in st["kinds"].values())
                    / total,
                    3,
                )
                if total
                else 0.0
            )
        return dict(
            sorted(snap.items(), key=lambda kv: -kv[1]["mean_ms"])
        )

    def record_commit(self, height: int, round_: int, txs: int = 0, ts=_NOW) -> None:
        ts = time.time() if ts is _NOW else ts
        with self._lock:
            self._rec(height)["commit"] = {"round": round_, "ts": ts, "txs": txs}

    def record_end_height(self, height: int, ts=_NOW) -> None:
        ts = time.time() if ts is _NOW else ts
        with self._lock:
            self._rec(height)["end_height_ts"] = ts

    # -- introspection ------------------------------------------------------

    def dump(self, limit: Optional[int] = None) -> List[dict]:
        """Time-ordered per-height records (ascending height; the most
        recent `limit` heights if given). Step durations are derived on the
        way out: each step's `dur_s` is the gap to the next recorded step of
        the same height (the last step stays open-ended)."""
        with self._lock:
            heights = [self._copy_rec(r) for r in self._heights.values()]
        heights.sort(key=lambda r: r["height"])
        if limit is not None and limit >= 0:
            heights = heights[-limit:] if limit else []
        for rec in heights:
            steps = rec["steps"]
            for i, st in enumerate(steps):
                nxt = steps[i + 1]["ts"] if i + 1 < len(steps) else None
                if nxt is not None and st["ts"] is not None:
                    # clamp: WAL-reconstructed timestamps come from different
                    # validators' clocks, so skew could make the gap negative
                    st["dur_s"] = round(max(0.0, nxt - st["ts"]), 6)
            # rounds the state machine actually ENTERED (steps/commit) —
            # votes are excluded: next-round and peer-catchup votes arrive
            # for rounds this node never escalated to, and counting them
            # would fabricate round escalations in the report
            rounds = {s["round"] for s in steps}
            if rec["commit"] is not None:
                rounds.add(rec["commit"]["round"])
            rec["round_count"] = (max(rounds) + 1) if rounds else 0
            commit = rec["commit"]
            start = rec["round_start"].get(0)
            if commit is not None and commit["ts"] is not None and start is not None:
                rec["total_s"] = round(max(0.0, commit["ts"] - start), 6)
            # derived gossip fan-out: first..last block-part receipt window
            for prop in rec.get("propagation", {}).values():
                if prop["parts_first_ts"] is not None and prop["parts_last_ts"] is not None:
                    prop["parts_fanout_s"] = round(
                        max(0.0, prop["parts_last_ts"] - prop["parts_first_ts"]), 6
                    )
            # internal bookkeeping, derivable from steps[] — not API surface
            rec.pop("round_start", None)
        return heights

    def _copy_rec(self, rec: dict) -> dict:
        out = dict(rec)
        out["steps"] = [dict(s) for s in rec["steps"]]
        out["proposals"] = [dict(p) for p in rec["proposals"]]
        votes = {}
        for r, v in rec["votes"].items():
            cv = {**v, "arrival_ms": list(v["arrival_ms"])}
            if "by_origin" in v:
                cv["by_origin"] = {
                    o: {**e, "latency_ms": list(e["latency_ms"])}
                    for o, e in v["by_origin"].items()
                }
            votes[r] = cv
        out["votes"] = votes
        out["propagation"] = {
            r: {
                **p,
                "part_latency_ms": list(p["part_latency_ms"]),
            }
            for r, p in rec.get("propagation", {}).items()
        }
        out["round_start"] = dict(rec["round_start"])
        if rec["commit"] is not None:
            out["commit"] = dict(rec["commit"])
        return out

    def heights(self) -> List[int]:
        with self._lock:
            return sorted(self._heights)

    def clear(self) -> None:
        with self._lock:
            self._heights.clear()
            self._peer_stats.clear()
