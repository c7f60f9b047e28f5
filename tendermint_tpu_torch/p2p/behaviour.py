"""Peer behaviour reporting + trust metric (+ persisted store).

reference: behaviour/reporter.go + peer_behaviour.go (thin indirection for
reactors to report peer conduct -> switch mark/stop), p2p/trust/metric.go
(EWMA-ish trust score per peer), and p2p/trust/store.go (metric store
persisted across restarts so a peer's history survives).

Wiring: the Switch owns a Reporter (switch.reporter); message delivery counts
as good conduct and receive errors as bad, so every peer carries a live trust
score (exposed via /net_info). Reactors can report richer conduct directly.

The port's copy of tendermint_tpu/p2p/behaviour.py.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

logger = logging.getLogger("tendermint_tpu_torch.p2p")

# behaviour kinds (reference: behaviour/peer_behaviour.go)
BAD_MESSAGE = "bad_message"
MESSAGE_OUT_OF_ORDER = "message_out_of_order"
RATE_LIMIT = "rate_limit"  # persistent inbound flooding past the recv budget
CONSENSUS_VOTE = "consensus_vote"
BLOCK_PART = "block_part"

_GOOD = {CONSENSUS_VOTE, BLOCK_PART}


@dataclass(frozen=True)
class PeerBehaviour:
    peer_id: str
    kind: str
    reason: str = ""

    def is_good(self) -> bool:
        return self.kind in _GOOD


class TrustMetric:
    """Exponentially weighted good/bad ratio in [0, 1]
    (reference: p2p/trust/metric.go — proportional + integral terms,
    simplified to a decayed ratio with the same monotonicity)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.good = 1.0  # optimistic prior (reference starts at 100%)
        self.bad = 0.0
        self._last = time.monotonic()

    def _decay_to_now(self) -> None:
        now = time.monotonic()
        steps = now - self._last
        if steps > 0:
            f = self.decay ** min(steps, 60.0)
            self.good *= f
            self.bad *= f
            self._last = now

    def record_good(self, weight: float = 1.0) -> None:
        self._decay_to_now()
        self.good += weight

    def record_bad(self, weight: float = 1.0) -> None:
        self._decay_to_now()
        self.bad += weight

    def score(self) -> float:
        self._decay_to_now()
        total = self.good + self.bad
        return self.good / total if total > 0 else 1.0


class TrustStore:
    """Persists peer trust metrics across restarts (reference:
    p2p/trust/store.go TrustMetricStore — periodic + on-stop JSON snapshot;
    restored scores seed the optimistic prior on reconnect)."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Dict[str, TrustMetric]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}
        out: Dict[str, TrustMetric] = {}
        if not isinstance(raw, dict):
            return out
        for peer_id, entry in raw.items():
            try:
                m = TrustMetric()
                m.good = float(entry["good"])
                m.bad = float(entry["bad"])
            except (KeyError, TypeError, ValueError):
                continue
            out[str(peer_id)] = m
        return out

    def save(self, metrics: Dict[str, TrustMetric]) -> None:
        data = {
            pid: {"good": m.good, "bad": m.bad, "score": m.score()}
            for pid, m in metrics.items()
        }
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".trust-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)  # atomic: no torn store on crash
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


class Reporter:
    """Routes behaviour reports to the switch: repeated bad conduct stops the
    peer (reference: behaviour/reporter.go SwitchReporter)."""

    def __init__(
        self,
        switch=None,
        bad_threshold: float = 0.3,
        history_size: int = 1000,
        store: Optional[TrustStore] = None,
    ):
        self.switch = switch
        self.bad_threshold = bad_threshold
        self.store = store
        self.metrics: Dict[str, TrustMetric] = store.load() if store else {}
        self.history: Deque[PeerBehaviour] = deque(maxlen=history_size)

    def save(self) -> None:
        if self.store is not None:
            self.store.save(self.metrics)

    MAX_TRACKED = 4096  # node ids are attacker-generated; bound the map

    def metric(self, peer_id: str) -> TrustMetric:
        m = self.metrics.get(peer_id)
        if m is None:
            while len(self.metrics) >= self.MAX_TRACKED:
                self.metrics.pop(next(iter(self.metrics)))
            m = self.metrics[peer_id] = TrustMetric()
        return m

    async def report(self, pb: PeerBehaviour) -> None:
        self.history.append(pb)
        m = self.metric(pb.peer_id)
        if pb.is_good():
            m.record_good()
            return
        m.record_bad()
        if self.switch is not None and m.score() < self.bad_threshold:
            peer = self.switch.peers.get(pb.peer_id)
            if peer is not None:
                logger.info(
                    "peer %s trust %.2f below threshold; disconnecting",
                    pb.peer_id[:10], m.score(),
                )
                await self.switch.stop_peer_for_error(
                    peer, f"low trust after {pb.kind}: {pb.reason}"
                )

    def score(self, peer_id: str) -> float:
        m = self.metrics.get(peer_id)
        return m.score() if m is not None else 1.0
