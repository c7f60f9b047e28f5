"""Flight recorder for the batch-verify pipeline: the port's copy of
tendermint_tpu/libs/trace.py.

Nested spans and point events go into a bounded, thread-safe ring with
JSONL export (`Span`, `Tracer`, the `tracer` singleton), and every flush
of crypto/batch.py is aggregated by `record_flush` into the per-(backend,
path) totals, counters and last-flush breakdown that `verify_stats()`
serves, with the default scheduler's lane state in its `scheduler` block.
`record_flush` also feeds the flush series of libs/metrics.py
(tendermint_batch_verify_*) and the SLO engine's verify_flush_wall
(libs/slo.feed_flush) on every flush: there is no switch, as in the
reference.

Device health: crypto/batch.py calls `mark_device_call` at each device
round trip (ok, or the error before it re-raises; there is no fallback),
`record_device_init` records the card's first initialization, and
`device_health()` (verify_stats' `device` block) and the
tendermint_device_* gauges read them. Compile accounting: every nvcc build
and every load of a built kernel library (ops/cuda_fe.build_library) is a
`record_compile`; `compile_seconds_total()` lets a flush count the build
seconds it paid. `record_slope_samples` keeps a slope fit's raw (k,
seconds) pairs for verify_stats.

Overhead contract, as in the reference: when `tracer.enabled` is False the
instrumented paths make no tracer call beyond one flag read (they hoist
`tracer if tracer.enabled else None`), and the ring never exceeds its size.
TMTPU_TRACE=0 turns it off at import.

verify_stats' `mesh` block is parallel/telemetry.mesh_stats(), the snapshot
GET /debug/mesh serves. Not ported: its `breaker` block (the port has no
circuit breaker, ROADMAP D1).
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
# A slope fit's raw (k, seconds) pairs (record_slope_samples), and the
# (n, total_s, path) samples of the last rlc* flushes.
_SLOPE_FIT: Dict[str, Any] = {}
_FLUSH_SAMPLES: deque = deque(maxlen=128)

_DEVICE_LOCK = threading.Lock()
_DEVICE: Dict[str, Any] = {
    "up": None,  # None = no device call attempted yet
    "init_seconds": None,
    "last_call_monotonic": None,
    "last_error": None,
}


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
    one, the flush is also a "batch_verify.flush" event in the ring. The
    flush series and the SLO feed move as the reference's do."""
    from tendermint_tpu_torch.libs import metrics as _metrics
    from tendermint_tpu_torch.libs import slo as _slo

    _slo.feed_flush(total_s)
    m = _metrics.batch_metrics()
    m.flushes.labels(backend, path).inc()
    m.sigs.labels(backend, path).inc(n)
    m.batch_size.observe(n)
    m.flush_seconds.labels(path).observe(total_s)
    if prep_s is not None:
        m.prep_seconds.observe(prep_s)
    # compile_s rides only the breakdown: record_compile counted it already
    if transfer_s is not None:
        m.transfer_seconds.inc(transfer_s)
    if jit_bucket is not None:
        m.jit_bucket.set(jit_bucket)
    if padding_lanes is not None:
        m.padding_lanes.set(padding_lanes)
    if cache_hits:
        m.pubkey_cache_hits.inc(cache_hits)
    if cache_misses:
        m.pubkey_cache_misses.inc(cache_misses)
    if rlc_fallback:
        m.rlc_fallbacks.inc()
    if recovery_flushes:
        m.recovery_flushes.inc(recovery_flushes)
    if quarantined:
        m.quarantined_rows.inc(quarantined)
    if chunks is not None:
        m.chunks_per_flush.observe(chunks)
    if prep_overlap_s:
        m.prep_overlap_seconds.inc(prep_overlap_s)
    # memo_hits rides only the breakdown: VerifiedRowMemo.lookup counts it
    if prep_s and prep_overlap_s is not None:
        m.prep_hidden_ratio.set(min(1.0, prep_overlap_s / prep_s))

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


def record_slope_samples(samples, slope_ms: Optional[float] = None,
                         fused: Optional[bool] = None, source: str = "bench") -> None:
    """Keep a slope fit's raw (k, seconds) pairs, so verify_stats serves
    them for re-fitting."""
    with _STATS_LOCK:
        _SLOPE_FIT.clear()
        _SLOPE_FIT.update(samples=[list(s) for s in samples], slope_ms=slope_ms, fused=fused,
                          source=source, recorded_at=time.time())


def verify_stats() -> dict:
    """Aggregated flush telemetry: per-(backend, path) totals, the per-stage
    time split, the counters, the last flush's breakdown, the slope samples
    (the last recorded fit, and the (rows, seconds, path) samples of the
    last rlc* flushes), the `device` block (device_health()), and the
    default scheduler's `scheduler` block when one is installed, and the
    `mesh` block (parallel/telemetry.mesh_stats(), as /debug/mesh)."""
    with _STATS_LOCK:
        out = {
            "totals": {f"{backend}/{path}": dict(t) for (backend, path), t in _TOTALS.items()},
            "stage_seconds": dict(_STAGE_SECONDS),
            "counters": dict(_COUNTS),
            "last_flush": dict(_LAST_FLUSH),
            "slope_samples": {"fit": dict(_SLOPE_FIT) or None,
                              "flush_samples": [list(s) for s in _FLUSH_SAMPLES]},
        }
    out["device"] = device_health()
    from tendermint_tpu_torch.parallel import telemetry as _mesh_tm

    out["mesh"] = _mesh_tm.mesh_stats()
    # lazy: crypto/batch imports this module; the scheduler imports batch
    from tendermint_tpu_torch.crypto import scheduler as _scheduler

    sched = _scheduler.default_scheduler()
    if sched is not None:
        out["scheduler"] = sched.stats()
    return out


def reset_stats() -> None:
    """Zero the aggregated flush telemetry (tests); not the metrics."""
    with _STATS_LOCK:
        _TOTALS.clear()
        _LAST_FLUSH.clear()
        _SLOPE_FIT.clear()
        _FLUSH_SAMPLES.clear()
        for k in _COUNTS:
            _COUNTS[k] = 0
        for k in _STAGE_SECONDS:
            _STAGE_SECONDS[k] = 0.0


# ---------------------------------------------------------------------------
# Device health.


def record_device_init(seconds: float, ok: bool = True, error: str = "") -> None:
    """The card's initialization finished (ok) or failed."""
    from tendermint_tpu_torch.libs import metrics as _metrics

    m = _metrics.batch_metrics()
    with _DEVICE_LOCK:
        _DEVICE["init_seconds"] = seconds
        _DEVICE["up"] = bool(ok)
        _DEVICE["last_error"] = error or None
        if ok:
            _DEVICE["last_call_monotonic"] = time.monotonic()
    m.device_init_seconds.set(seconds)
    m.device_up.set(1.0 if ok else 0.0)
    if ok:
        m.device_last_call_timestamp.set(time.time())
    if tracer.enabled:
        tracer.event("device.init", seconds=round(seconds, 4), ok=bool(ok))


def mark_device_call(ok: bool = True, error: str = "") -> None:
    """A device round trip completed (ok) or failed (not ok): `device_up`."""
    from tendermint_tpu_torch.libs import metrics as _metrics

    m = _metrics.batch_metrics()
    with _DEVICE_LOCK:
        _DEVICE["up"] = bool(ok)
        if ok:
            _DEVICE["last_call_monotonic"] = time.monotonic()
            _DEVICE["last_error"] = None
        else:
            _DEVICE["last_error"] = error or "device call failed"
    m.device_up.set(1.0 if ok else 0.0)
    if ok:
        m.device_last_call_timestamp.set(time.time())


def device_health() -> dict:
    """{"device_up": 0/1/None, "init_seconds", "last_call_age_s",
    "last_error"}; device_up None means no device call was attempted in
    this process."""
    with _DEVICE_LOCK:
        up = _DEVICE["up"]
        last = _DEVICE["last_call_monotonic"]
        return {
            "device_up": None if up is None else int(up),
            "init_seconds": _DEVICE["init_seconds"],
            "last_call_age_s": round(time.monotonic() - last, 3) if last is not None else None,
            "last_error": _DEVICE["last_error"],
        }


# ---------------------------------------------------------------------------
# Compile accounting.

_COMPILE_LOCK = threading.Lock()
_COMPILE_TOTAL = 0.0  # seconds of kernel builds and library loads


def record_compile(name: str, seconds: float, kind: str) -> None:
    """A kernel library's nvcc build ("build") or load ("load") took
    `seconds` (ops/cuda_fe.build_library)."""
    global _COMPILE_TOTAL
    from tendermint_tpu_torch.libs import metrics as _metrics

    with _COMPILE_LOCK:
        _COMPILE_TOTAL += seconds
    _metrics.batch_metrics().compile_seconds.labels(kind).inc(seconds)
    if tracer.enabled:
        tracer.event(f"kernel.{kind}", kernel=name, seconds=round(seconds, 4))


def compile_seconds_total() -> float:
    """Monotonic build-and-load seconds; a flush reads it before and after
    to count what it paid (crypto/batch.verify_batch)."""
    with _COMPILE_LOCK:
        return _COMPILE_TOTAL
