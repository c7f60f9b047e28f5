"""Bounded per-stage duration reservoirs: the port's copy of `StageStats`
from tendermint_tpu/libs/txtrace.py (:80-127). The transaction tracker
that shares the module there waits for the mempool; the light service's
per-request spans and the scheduler's lane waits use this class.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict


class StageStats:
    """Bounded per-stage duration reservoirs with percentile summaries.
    Thread-safe; `observe` is an O(1) deque append, percentiles sort only
    on read."""

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
