"""Flight recorder for the batch-verify pipeline: the port's copy of
tendermint_tpu/libs/trace.py.

Nested spans and point events go into a bounded, thread-safe ring with
JSONL export (`Span`, `Tracer`, the `tracer` singleton), and every flush
of crypto/batch.py is aggregated by `record_flush` into the per-(backend,
path) totals, counters and last-flush breakdown that `verify_stats()`
serves, with the default scheduler's lane state in its `scheduler` block.

Overhead contract, as in the reference: when `tracer.enabled` is False the
instrumented paths make no tracer call beyond one flag read (they hoist
`tracer if tracer.enabled else None`), and the ring never exceeds its size.
TMTPU_TRACE=0 turns it off at import.

Not ported (ROADMAP A9): the Prometheus series that record_flush also
feeds there (libs/metrics.py), the SLO flush feed, device health
(`device_health`, `record_device_init`, `mark_device_call`), compile
accounting (`record_compile`), and verify_stats' `device`, `breaker` and
`mesh` blocks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_RING_SIZE = 4096


class Span:
    """An in-flight span; records one event into the tracer's ring on exit.
    Use as a context manager, or call __enter__/__exit__ explicitly (see
    crypto/batch.py). `set(**attrs)` attaches attributes mid-flight."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = tracer._next_id()
        self.parent_id: Optional[int] = None
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(self.name, self.span_id, self.parent_id, dur, self.attrs)


class Tracer:
    """Thread-safe bounded flight recorder: nested spans + point events."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        self._local = threading.local()
        self._id = 0

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """A zero-duration point event, parented to the current span."""
        stack = self._stack()
        self._record(name, self._next_id(), stack[-1] if stack else None, None, attrs)

    def dump(self, limit: Optional[int] = None) -> List[dict]:
        """Ring contents, oldest first (most recent `limit` if given)."""
        with self._lock:
            events = list(self._ring)
        if limit is not None and limit >= 0:
            events = events[-limit:] if limit else []
        return events

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True) for e in self.dump())

    @staticmethod
    def from_jsonl(text: str) -> List[dict]:
        return [json.loads(line) for line in text.splitlines() if line.strip()]

    @property
    def ring_size(self) -> int:
        return self._ring.maxlen or 0

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def configure(self, enabled: Optional[bool] = None,
                  ring_size: Optional[int] = None) -> None:
        """Shrinking the ring keeps the newest events."""
        with self._lock:
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, int(ring_size)))
        if enabled is not None:
            self.enabled = bool(enabled)

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name, span_id, parent_id, dur_s, attrs) -> None:
        event = {"name": name, "span": span_id, "parent": parent_id, "ts": time.time()}
        if dur_s is not None:
            event["dur_ms"] = round(dur_s * 1e3, 4)
        if attrs:
            event["attrs"] = dict(attrs)
        with self._lock:
            self._ring.append(event)


tracer = Tracer(enabled=os.environ.get("TMTPU_TRACE", "1") != "0")


# ---------------------------------------------------------------------------
# Aggregated per-flush telemetry (verify_stats).

_STATS_LOCK = threading.Lock()
_TOTALS: Dict[tuple, Dict[str, float]] = {}  # (backend, path) -> counters
_LAST_FLUSH: Dict[str, Any] = {}
_COUNTS = {
    "rlc_fallbacks": 0,
    "cache_hits": 0,
    "cache_misses": 0,
    "recovery_flushes": 0,
    "quarantined_rows": 0,
}
_STAGE_SECONDS = {"prep": 0.0, "compile": 0.0, "transfer": 0.0, "total": 0.0}
_FLUSH_SAMPLES: deque = deque(maxlen=128)  # (n, total_s, path) of rlc* flushes


def record_flush(
    *,
    backend: str,
    path: str,
    n: int,
    total_s: float,
    n_valid: Optional[int] = None,
    prep_s: Optional[float] = None,
    compile_s: Optional[float] = None,
    transfer_s: Optional[float] = None,
    jit_bucket: Optional[int] = None,
    padding_lanes: Optional[int] = None,
    cache_hits: Optional[int] = None,
    cache_misses: Optional[int] = None,
    rlc_fallback: bool = False,
    fused: Optional[bool] = None,
    h2d_bytes: Optional[int] = None,
    device_dispatches: Optional[int] = None,
    chunks: Optional[int] = None,
    chunk_lanes: Optional[int] = None,
    prep_overlap_s: Optional[float] = None,
    prep_stages: Optional[dict] = None,
    memo_hits: Optional[int] = None,
    recovery_flushes: Optional[int] = None,
    quarantined: Optional[int] = None,
    tracer_: Optional[Tracer] = None,
) -> None:
    """One batch-verify flush completed (crypto/batch.py calls it for every
    flush on every arm). `tracer_` is the caller's already-resolved tracer,
    or None when tracing is off, so this adds no flag read of its own; with
    one, the flush is also a "batch_verify.flush" event in the ring."""
    last = {"backend": backend, "path": path, "n": n, "total_ms": round(total_s * 1e3, 4)}
    if n_valid is not None:
        last["n_valid"] = n_valid
    if prep_s is not None:
        last["prep_ms"] = round(prep_s * 1e3, 4)
    if compile_s is not None:
        last["compile_ms"] = round(compile_s * 1e3, 4)
    if transfer_s is not None:
        last["transfer_ms"] = round(transfer_s * 1e3, 4)
    if jit_bucket is not None:
        last["jit_bucket"] = jit_bucket
        last["padding_lanes"] = padding_lanes
    if cache_hits is not None or cache_misses is not None:
        hits, misses = cache_hits or 0, cache_misses or 0
        last["pubkey_cache_hits"] = hits
        last["pubkey_cache_misses"] = misses
        if hits + misses:
            last["pubkey_cache_hit_rate"] = round(hits / (hits + misses), 4)
    if rlc_fallback:
        last["rlc_fallback"] = True
    if fused is not None:
        last["fused"] = bool(fused)
    if h2d_bytes is not None:
        last["h2d_bytes"] = h2d_bytes
    if device_dispatches is not None:
        last["device_dispatches"] = device_dispatches
    if chunks is not None:
        last["chunks"] = chunks
    if chunk_lanes is not None:
        last["chunk_lanes"] = chunk_lanes
    if prep_overlap_s is not None:
        last["prep_overlap_ms"] = round(prep_overlap_s * 1e3, 4)
    if prep_stages:
        last["prep_stages_ms"] = {
            k[:-2] if k.endswith("_s") else k: round(v * 1e3, 4) for k, v in prep_stages.items()
        }
    if memo_hits is not None:
        last["memo_hits"] = memo_hits
    if recovery_flushes is not None:
        last["recovery_flushes"] = recovery_flushes
    if quarantined is not None:
        last["quarantined"] = quarantined
    with _STATS_LOCK:
        t = _TOTALS.setdefault((backend, path), {"flushes": 0, "sigs": 0, "seconds": 0.0})
        t["flushes"] += 1
        t["sigs"] += n
        t["seconds"] += total_s
        _COUNTS["cache_hits"] += cache_hits or 0
        _COUNTS["cache_misses"] += cache_misses or 0
        if rlc_fallback:
            _COUNTS["rlc_fallbacks"] += 1
        _COUNTS["recovery_flushes"] += recovery_flushes or 0
        _COUNTS["quarantined_rows"] += quarantined or 0
        _STAGE_SECONDS["prep"] += prep_s or 0.0
        _STAGE_SECONDS["compile"] += compile_s or 0.0
        _STAGE_SECONDS["transfer"] += transfer_s or 0.0
        _STAGE_SECONDS["total"] += total_s
        _LAST_FLUSH.clear()
        _LAST_FLUSH.update(last)
        if path.startswith("rlc"):
            _FLUSH_SAMPLES.append((n, round(total_s, 6), path))
    if tracer_ is not None:
        tracer_.event("batch_verify.flush", **last)


def verify_stats() -> dict:
    """Aggregated flush telemetry: per-(backend, path) totals, the per-stage
    time split, the counters, the last flush's breakdown, the (rows,
    seconds, path) samples of the last rlc* flushes, and the default
    scheduler's `scheduler` block when one is installed. The reference's
    bench-fed slope fit is not ported."""
    with _STATS_LOCK:
        out = {
            "totals": {f"{backend}/{path}": dict(t) for (backend, path), t in _TOTALS.items()},
            "stage_seconds": dict(_STAGE_SECONDS),
            "counters": dict(_COUNTS),
            "last_flush": dict(_LAST_FLUSH),
            "slope_samples": {"flush_samples": [list(s) for s in _FLUSH_SAMPLES]},
        }
    # lazy: crypto/batch imports this module; the scheduler imports batch
    from tendermint_tpu_torch.crypto import scheduler as _scheduler

    sched = _scheduler.default_scheduler()
    if sched is not None:
        out["scheduler"] = sched.stats()
    return out


def reset_stats() -> None:
    """Zero the aggregated flush telemetry (tests)."""
    with _STATS_LOCK:
        _TOTALS.clear()
        _LAST_FLUSH.clear()
        _FLUSH_SAMPLES.clear()
        for k in _COUNTS:
            _COUNTS[k] = 0
        for k in _STAGE_SECONDS:
            _STAGE_SECONDS[k] = 0.0
