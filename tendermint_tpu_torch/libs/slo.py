"""SLO engine: declared latency budgets and multi-window burn-rate guards.
The port's copy of tendermint_tpu/libs/slo.py.

Every observation is classified good or breach against its objective's
budget (config.SLOConfig), and compliance is an error-budget burn rate over
two windows:

    burn = breach_fraction(window) / (1 - target)

A burn of `burn_rate_trip` (4 by default) or more over both the fast and
the slow window, with `min_samples` in the fast one, trips the objective's
guard; it re-arms when the fast window's burn falls back under the
threshold. `evaluate`, `snapshot` and `assert_budgets` read the state;
`tendermint_slo_*` (libs/metrics.SLOMetrics) carry it when the engine has
metrics.

Feeds in the port: libs/trace.record_flush (`feed_flush`, the
verify_flush_wall of every flush, to the engine registered with
`set_default`: process-global, last registered wins), the scheduler's lane
waits (crypto/scheduler.py `slo=`) and the light service's request
latency (light/service.py `slo=`). The consensus objectives wait for the
node (ROADMAP A10).

Observations and evaluation take explicit timestamps (the monotonic clock's
domain), so tests drive synthetic clocks; omitted, they read
time.monotonic().
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

# objective name -> (SLOConfig budget attribute, what the value measures)
OBJECTIVES = {
    "proposal_propagation": (
        "proposal_propagation",
        "seconds from a proposal's origin stamp to this node's first receipt "
        "(clock-skew corrected)",
    ),
    "prevote_quorum_delay": (
        "prevote_quorum_delay",
        "seconds from the proposal timestamp to +2/3 prevote quorum",
    ),
    "commit_interval": (
        "commit_interval",
        "seconds between consecutive committed block timestamps",
    ),
    "verify_flush_wall": (
        "verify_flush_wall",
        "wall seconds of one batch-verify flush (any backend)",
    ),
    "light_verify_p99": (
        "light_verify_p99",
        "seconds from a light_verify request's admission to its verified "
        "response (cache, coalesced flush, or bisection fallback)",
    ),
    # the serving budgets: with target=0.99 a per-request budget is the
    # p99 bound (>1% of requests over it burns the budget at trip rate)
    "tx_commit_latency": (
        "tx_commit_latency",
        "seconds from a tx's first receipt (rpc or gossip) to its commit "
        "in a finalized block",
    ),
    "rpc_request_p99": (
        "rpc_request_p99",
        "wall seconds of one dispatched RPC request, any method "
        "(all transports + LocalClient)",
    ),
    # per-lane queue-wait budgets of the verification scheduler
    # (crypto/scheduler.py), observed once per combined flush as the oldest
    # queued row's wait in that lane
    "verify_lane_wait_votes": (
        "verify_lane_wait_votes",
        "seconds a queued vote-lane row waited before its flush started "
        "(votes preempt: this is thread-handoff, never bulk-work queueing)",
    ),
    "verify_lane_wait_light": (
        "verify_lane_wait_light",
        "seconds a queued light-lane row waited before its flush started "
        "(the serving coalescing window as actually delivered)",
    ),
    "verify_lane_wait_admission": (
        "verify_lane_wait_admission",
        "seconds a queued admission-lane (CheckTx precheck) row waited "
        "before its flush started",
    ),
    "verify_lane_wait_catchup": (
        "verify_lane_wait_catchup",
        "seconds a queued catch-up-lane (blocksync/evidence) row waited "
        "before its flush started (idle-soak by design; the starvation "
        "floor bounds it)",
    ),
    "verify_lane_wait_quarantine": (
        "verify_lane_wait_quarantine",
        "seconds a queued quarantine-lane row (suspect source, "
        "crypto/provenance.py) waited before its flush started (flushes "
        "alone, only when every other lane is drained; the starvation "
        "floor bounds it)",
    ),
}

# ring bound per objective: a flood cannot grow it past the deque bound
MAX_EVENTS = 8192


class SLOEngine:
    """Budgets + burn-rate evaluation for the declared objectives.

    Thread-safe: observations arrive from the flush path, the scheduler's
    dispatch thread and the light service; evaluation may run anywhere."""

    def __init__(self, config, metrics=None, now=None):
        self.config = config
        self.metrics = metrics  # libs/metrics.SLOMetrics or None
        self.target = min(max(float(config.target), 0.0), 0.9999)
        self.window_fast = float(config.window_fast)
        self.window_slow = max(float(config.window_slow), self.window_fast)
        self.burn_rate_trip = float(config.burn_rate_trip)
        self.min_samples = max(1, int(config.min_samples))
        self.budgets: Dict[str, float] = {
            name: float(getattr(config, attr))
            for name, (attr, _) in OBJECTIVES.items()
        }
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {
            name: deque(maxlen=MAX_EVENTS) for name in OBJECTIVES
        }
        self._totals: Dict[str, list] = {name: [0, 0] for name in OBJECTIVES}  # [good, breach]
        self._worst: Dict[str, float] = {name: 0.0 for name in OBJECTIVES}
        self._tripped: Dict[str, bool] = {name: False for name in OBJECTIVES}
        self._trips: Dict[str, int] = {name: 0 for name in OBJECTIVES}
        self._last_eval: Dict[str, dict] = {}
        if metrics is not None:
            for name, budget in self.budgets.items():
                metrics.budget_seconds.labels(name).set(budget)
        _ = now  # kept for signature stability; observe/evaluate take ts

    # -- recording -----------------------------------------------------------

    def observe(self, name: str, seconds: float, ts: Optional[float] = None) -> bool:
        """Classify one latency observation against its budget; returns True
        when it met the budget. Unknown objective names are ignored (a
        feeder must never crash the path it measures)."""
        budget = self.budgets.get(name)
        if budget is None:
            return True
        ts = time.monotonic() if ts is None else ts
        good = seconds <= budget
        with self._lock:
            self._events[name].append((ts, good))
            self._totals[name][0 if good else 1] += 1
            if seconds > self._worst[name]:
                self._worst[name] = seconds
        if self.metrics is not None:
            self.metrics.observations.labels(
                name, "good" if good else "breach"
            ).inc()
        return good

    # -- evaluation ----------------------------------------------------------

    def _window_burn(self, events: deque, now: float, window: float):
        total = bad = 0
        cutoff = now - window
        for ts, good in reversed(events):
            if ts < cutoff:
                break
            total += 1
            if not good:
                bad += 1
        if total == 0:
            return 0.0, 0, 0
        burn = (bad / total) / max(1.0 - self.target, 1e-9)
        return burn, total, bad

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Recompute per-objective burn rates, update trip state + gauges.
        Trip: burn >= burn_rate_trip in BOTH windows with at least
        min_samples in the fast window. Re-arm: fast burn back under the
        threshold."""
        now = time.monotonic() if now is None else now
        out: Dict[str, dict] = {}
        for name in OBJECTIVES:
            with self._lock:
                events = self._events[name]
                burn_fast, n_fast, bad_fast = self._window_burn(
                    events, now, self.window_fast
                )
                burn_slow, n_slow, bad_slow = self._window_burn(
                    events, now, self.window_slow
                )
                was_tripped = self._tripped[name]
                should_trip = (
                    n_fast >= self.min_samples
                    and burn_fast >= self.burn_rate_trip
                    and burn_slow >= self.burn_rate_trip
                )
                if should_trip and not was_tripped:
                    self._tripped[name] = True
                    self._trips[name] += 1
                    if self.metrics is not None:
                        self.metrics.trips.labels(name).inc()
                elif was_tripped and burn_fast < self.burn_rate_trip:
                    self._tripped[name] = False
                tripped = self._tripped[name]
                good_total, breach_total = self._totals[name]
                worst = self._worst[name]
                trips = self._trips[name]
            verdict = (
                "tripped" if tripped
                else "burning" if burn_fast >= 1.0
                else "ok"
            )
            out[name] = {
                "budget_s": self.budgets[name],
                "description": OBJECTIVES[name][1],
                "observations": good_total + breach_total,
                "breaches": breach_total,
                "worst_s": round(worst, 6),
                "burn_rate": {
                    "fast": {
                        "window_s": self.window_fast,
                        "burn": round(burn_fast, 4),
                        "samples": n_fast,
                        "breaches": bad_fast,
                    },
                    "slow": {
                        "window_s": self.window_slow,
                        "burn": round(burn_slow, 4),
                        "samples": n_slow,
                        "breaches": bad_slow,
                    },
                },
                "tripped": tripped,
                "trips_total": trips,
                "verdict": verdict,
            }
            if self.metrics is not None:
                self.metrics.burn_rate.labels(name, "fast").set(round(burn_fast, 4))
                self.metrics.burn_rate.labels(name, "slow").set(round(burn_slow, 4))
                self.metrics.tripped.labels(name).set(1 if tripped else 0)
        self._last_eval = out
        return out

    def tripped(self, name: str) -> bool:
        return self._tripped.get(name, False)

    def any_tripped(self) -> bool:
        return any(self._tripped.values())

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The SLO document: declared policy + per-objective state.
        Evaluates on the way out (burn rates are always current)."""
        objectives = self.evaluate(now)
        return {
            "enabled": True,
            "target": self.target,
            "burn_rate_trip": self.burn_rate_trip,
            "windows_s": {"fast": self.window_fast, "slow": self.window_slow},
            "min_samples": self.min_samples,
            "any_tripped": self.any_tripped(),
            "objectives": objectives,
        }

    def assert_budgets(self, names=None) -> None:
        """Raise AssertionError naming every objective that is tripped or
        has tripped."""
        snap = self.evaluate()
        names = set(names) if names is not None else set(snap)
        failing = {
            n: o for n, o in snap.items()
            if n in names and (o["tripped"] or o["trips_total"] > 0)
        }
        if failing:
            detail = ", ".join(
                f"{n}: {o['breaches']}/{o['observations']} breaches, "
                f"worst {o['worst_s']:.3f}s vs budget {o['budget_s']:.3f}s, "
                f"fast burn {o['burn_rate']['fast']['burn']}"
                for n, o in failing.items()
            )
            raise AssertionError(f"SLO budgets violated — {detail}")


# -- process-global flush feed -------------------------------------------------
#
# crypto/batch's flush completion (libs/trace.record_flush) is process-global;
# the last engine registered receives the verify_flush_wall observations.

_DEFAULT: Optional[SLOEngine] = None


def set_default(engine: Optional[SLOEngine]) -> None:
    global _DEFAULT
    _DEFAULT = engine


def default_engine() -> Optional[SLOEngine]:
    return _DEFAULT


def feed_flush(seconds: float) -> None:
    """One batch-verify flush completed (called by libs/trace.record_flush
    for every flush on every backend). One None check when no engine is
    registered — safe on the device hot path."""
    eng = _DEFAULT
    if eng is not None:
        eng.observe("verify_flush_wall", seconds)
