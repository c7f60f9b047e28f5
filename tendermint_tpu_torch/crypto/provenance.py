"""Row provenance and suspicion scoring: the port's copy of
tendermint_tpu/crypto/provenance.py.

Every (pubkey, msg, sig) row that enters the batch-verify pipeline may
carry a source tag naming where it came from:

- ``peer:<id>``     gossip rows (votes relayed by a p2p peer)
- ``sender:<id>``   mempool rows (transactions, keyed by sender)
- ``lane:<lane>``   everything else (a scheduler lane, filled in by
                    crypto/scheduler.py when the caller supplied none)

The SuspicionScorer watches per-row verdicts (crypto/batch.py feeds it
after every tagged flush) and keeps a small state machine per source:

    clean ──(fails >= fail_quarantine)──> QUARANTINED
    QUARANTINED ──(clean_streak >= parole_clean)──> clean (parole)
    QUARANTINED ──(offenses >= punish_fails)──> punish callbacks fire

The scheduler routes quarantined sources to its quarantine lane, so their
rows never share a vote, light or admission flush again. Scoring is
advisory and never changes a verdict: punish callbacks are exception-
guarded and `is_quarantined` is a lock-free frozenset lookup. After each
record_rows and reset, the count of quarantined sources is published on
tendermint_batch_verify_poisoned_sources (libs/metrics.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

# How many distinct sources the scorer remembers (LRU-bounded: a flood of
# fabricated source ids must not grow memory without bound).
MAX_SOURCES = 4096


def fill_sources(sources: Optional[Sequence[str]], n: int, lane: str) -> List[str]:
    """A caller's source list as exactly n tags, missing or empty entries
    taking the lane's fallback tag."""
    fallback = f"lane:{lane}"
    if sources is None:
        return [fallback] * n
    out = [s if s else fallback for s in sources]
    if len(out) < n:
        out.extend([fallback] * (n - len(out)))
    return out[:n]


class _SourceState:
    __slots__ = ("fails", "clean_streak", "quarantined", "quarantines", "offenses", "punished")

    def __init__(self):
        self.fails = 0  # recent failed rows (decays 1 per clean row)
        self.clean_streak = 0  # consecutive clean rows (parole gate)
        self.quarantined = False
        self.quarantines = 0  # lifetime quarantine entries
        self.offenses = 0  # failed rows while quarantined (punish gate)
        self.punished = False  # punish callbacks fired this episode


class SuspicionScorer:
    """Per-source suspicion state machine (module docstring).

    fail_quarantine: failed rows before a source is quarantined.
    parole_clean:    consecutive clean rows that parole a quarantined source.
    punish_fails:    failed rows while quarantined before punish callbacks
                     fire.

    Only attributable sources (quarantine_prefixes: peer:/sender:) can be
    quarantined: a ``lane:`` tag covers every consumer of that lane. Their
    failures are still counted."""

    def __init__(self, *, fail_quarantine: int = 3, parole_clean: int = 64,
                 punish_fails: int = 8, max_sources: int = MAX_SOURCES,
                 quarantine_prefixes: tuple = ("peer:", "sender:")):
        self.fail_quarantine = fail_quarantine
        self.parole_clean = parole_clean
        self.punish_fails = punish_fails
        self.max_sources = max_sources
        self.quarantine_prefixes = quarantine_prefixes
        self._lock = threading.Lock()
        self._state: "OrderedDict[str, _SourceState]" = OrderedDict()
        # copy-on-write snapshot read without the lock, rebuilt on transitions
        self._quarantined: frozenset = frozenset()
        self._callbacks: List[Callable[[str, dict], None]] = []
        self._paroles = 0
        self._punished_total = 0

    def record_rows(self, sources: Sequence[str], mask: np.ndarray) -> None:
        """Feed one flush's per-row verdicts: sources[i] tags row i, mask[i]
        is its verdict. Aggregated per source, then each source's state
        machine advances under the lock."""
        if not len(sources):
            return
        agg: Dict[str, list] = {}
        for src, ok in zip(sources, np.asarray(mask, dtype=bool)):
            e = agg.get(src)
            if e is None:
                e = agg[src] = [0, 0]
            e[0 if ok else 1] += 1
        fire: List[tuple] = []
        with self._lock:
            for src, (clean, bad) in agg.items():
                fire.extend(self._advance_locked(src, bad=bad, clean=clean))
        for cb, src, info in fire:
            try:
                cb(src, info)
            except Exception:  # punishment never breaks verification
                pass
        self._publish_gauge()

    def _advance_locked(self, src: str, *, bad: int, clean: int) -> list:
        st = self._state.get(src)
        if st is None:
            st = self._state[src] = _SourceState()
            self._evict_locked()
        else:
            self._state.move_to_end(src)
        fire: list = []
        if bad:
            st.fails += bad
            st.clean_streak = 0
            quarantinable = src.startswith(self.quarantine_prefixes)
            if quarantinable and not st.quarantined and st.fails >= self.fail_quarantine:
                st.quarantined = True
                st.quarantines += 1
                st.offenses = 0
                st.punished = False
                self._rebuild_quarantined_locked()
            elif st.quarantined:
                st.offenses += bad
                if st.offenses >= self.punish_fails and not st.punished:
                    st.punished = True
                    self._punished_total += 1
                    info = {"fails": st.fails, "offenses": st.offenses,
                            "quarantines": st.quarantines}
                    fire.extend((cb, src, info) for cb in self._callbacks)
        if clean and not bad:
            st.clean_streak += clean
            st.fails = max(0, st.fails - clean)  # honest bit-flips decay
            if st.quarantined and st.clean_streak >= self.parole_clean:
                st.quarantined = False
                st.fails = 0
                st.offenses = 0
                st.punished = False
                st.clean_streak = 0
                self._paroles += 1
                self._rebuild_quarantined_locked()
        return fire

    def _evict_locked(self) -> None:
        while len(self._state) > self.max_sources:
            # the oldest non-quarantined source goes first: a quarantined
            # source must not launder its record by flooding fresh ids
            victim = next((k for k, st in self._state.items() if not st.quarantined), None)
            if victim is None:
                victim = next(iter(self._state))
            if self._state.pop(victim).quarantined:
                self._rebuild_quarantined_locked()

    def _rebuild_quarantined_locked(self) -> None:
        self._quarantined = frozenset(k for k, st in self._state.items() if st.quarantined)

    def _publish_gauge(self) -> None:
        try:
            from tendermint_tpu_torch.libs import metrics as _metrics

            _metrics.batch_metrics().poisoned_sources.set(len(self._quarantined))
        except Exception:  # observability never breaks the verify path
            pass

    def is_quarantined(self, source: str) -> bool:
        return source in self._quarantined

    def quarantined_sources(self) -> frozenset:
        return self._quarantined

    def any_quarantined(self, sources: Iterable[str]) -> bool:
        q = self._quarantined
        return bool(q) and any(s in q for s in sources)

    def add_punish_callback(self, cb: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._callbacks.append(cb)

    def remove_punish_callback(self, cb: Callable[[str, dict], None]) -> None:
        with self._lock:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    def stats(self) -> dict:
        with self._lock:
            worst = sorted(self._state.items(), key=lambda kv: (kv[1].quarantined, kv[1].fails),
                           reverse=True)[:8]
            return {
                "sources": len(self._state),
                "quarantined": sorted(self._quarantined),
                "paroles": self._paroles,
                "punished": self._punished_total,
                "worst": [
                    {"source": k, "fails": st.fails, "clean_streak": st.clean_streak,
                     "quarantined": st.quarantined, "quarantines": st.quarantines}
                    for k, st in worst if st.fails or st.quarantined
                ],
            }

    def reset(self) -> None:
        with self._lock:
            self._state.clear()
            self._quarantined = frozenset()
            self._paroles = 0
            self._punished_total = 0
        self._publish_gauge()


_DEFAULT = SuspicionScorer()


def default_scorer() -> SuspicionScorer:
    """The process-global scorer (the crypto pipeline is process-global
    state, as the verified-row memo is)."""
    return _DEFAULT


def set_default(scorer: SuspicionScorer) -> SuspicionScorer:
    """Swap the process-global scorer (tests); returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = scorer
    return prev
