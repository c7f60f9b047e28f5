"""Prometheus-style metrics for the port: counters, gauges and histograms
with labels and text exposition, no external dependency. The port's copy of
tendermint_tpu/libs/metrics.py: the metric core, `parse_exposition`, and
the four families the ported verify path feeds, with the reference's series
names, help text, label names and buckets, so a scrape of the port reads as
a scrape of the reference:

- `BatchVerifyMetrics` (tendermint_batch_verify_*, tendermint_device_*), on
  the process-global registry (`global_registry()`, `batch_metrics()`): fed
  by libs/trace.record_flush on every flush, by crypto/batch.py's
  `record_backend_rows` and the verified-row memo, by the device-health and
  compile calls of libs/trace.py, and by crypto/provenance.py's
  poisoned-sources gauge;
- `SLOMetrics`, `LightServiceMetrics`, `SchedulerMetrics`, `PubSubMetrics`:
  built by their owner on its own registry and handed to
  libs/slo.SLOEngine(metrics=), light/service.LightService(metrics=),
  crypto/scheduler.VerifyScheduler(metrics=) and
  libs/pubsub.PubSubServer(metrics=) (types/event_bus.EventBus(metrics=)).
  The reference keeps its pubsub counter on the global registry; here the
  global registry holds the batch family only.

- `NodeMetrics`: one registry per node (node/node.py) holding the consensus,
  mempool, p2p, state, blocksync, statesync, RPC, overload, SLO, light,
  scheduler and tx-lifecycle families; the node hands each to its owner
  (ConsensusState, Mempool, BlockExecutor, OverloadController,
  VerifyScheduler, LightService, TxTracker). The p2p, blocksync, statesync
  and RPC families are declared so that a node's exposition has the
  reference's series names; nothing of the port feeds them until the p2p,
  RPC and state sync slices (ROADMAP A2-A4). `expose()` is the node's
  series and then the global registry's.

The chaos, fleet, observatory and mesh families wait for the modules that
feed them (ROADMAP A5, A6).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

NAMESPACE = "tendermint"


def _fmt_labels(label_names: Sequence[str], label_values: Tuple[str, ...]) -> str:
    if not label_names:
        return ""
    pairs = ", ".join(
        f'{n}="{v}"' for n, v in zip(label_names, label_values)
    )
    return "{" + pairs + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str) -> "_Bound":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} labels, got {len(values)}"
            )
        return _Bound(self, tuple(str(v) for v in values))

    # unlabeled shortcuts
    def _key(self) -> Tuple[str, ...]:
        return ()

    def replace_series(self, values: Dict[Tuple[str, ...], float]) -> None:
        """Atomically replace EVERY labeled series with `values` (label
        tuple -> value). For gauges sampled from a live membership (e.g.
        per-peer clock skew): departed members' series drop out instead of
        exposing stale values and growing without bound over churn."""
        clean = {
            tuple(str(v) for v in k): float(val) for k, val in values.items()
        }
        for k in clean:
            if len(k) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: expected {len(self.label_names)} labels, got {len(k)}"
                )
        with self._lock:
            self._values = clean

    def expose(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for label_values, v in items:
            out.append(
                f"{self.name}{_fmt_labels(self.label_names, label_values)} {_num(v)}"
            )
        return out


def _num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)


class _Bound:
    __slots__ = ("metric", "values")

    def __init__(self, metric: _Metric, values: Tuple[str, ...]):
        self.metric = metric
        self.values = values

    def inc(self, amount: float = 1.0) -> None:
        with self.metric._lock:
            self.metric._values[self.values] = (
                self.metric._values.get(self.values, 0.0) + amount
            )

    def set(self, value: float) -> None:
        with self.metric._lock:
            self.metric._values[self.values] = float(value)

    def observe(self, value: float) -> None:
        self.metric.observe_labels(self.values, value)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels(...).inc()")
        _Bound(self, ()).inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        _Bound(self, ()).set(value)

    def inc(self, amount: float = 1.0) -> None:
        _Bound(self, ()).inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        _Bound(self, ()).inc(-amount)


class Histogram(_Metric):
    """Cumulative-bucket histogram (prometheus semantics)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float) -> None:
        self.observe_labels((), value)

    def observe_labels(self, label_values: Tuple[str, ...], value: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(label_values, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[label_values] = self._sums.get(label_values, 0.0) + value
            self._totals[label_values] = self._totals.get(label_values, 0) + 1

    def expose(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            items = sorted(self._counts.items())
            for label_values, counts in items:
                names = self.label_names + ("le",)
                for i, b in enumerate(self.buckets):
                    out.append(
                        f"{self.name}_bucket{_fmt_labels(names, label_values + (_num(b),))} {counts[i]}"
                    )
                out.append(
                    f"{self.name}_bucket{_fmt_labels(names, label_values + ('+Inf',))} "
                    f"{self._totals[label_values]}"
                )
                out.append(
                    f"{self.name}_sum{_fmt_labels(self.label_names, label_values)} "
                    f"{_num(self._sums[label_values])}"
                )
                out.append(
                    f"{self.name}_count{_fmt_labels(self.label_names, label_values)} "
                    f"{self._totals[label_values]}"
                )
        return out


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics.append(metric)
        return metric

    def counter(self, name, help_, labels=()) -> Counter:
        return self.register(Counter(name, help_, labels))

    def gauge(self, name, help_, labels=()) -> Gauge:
        return self.register(Gauge(name, help_, labels))

    def histogram(self, name, help_, labels=(), buckets=None) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Compact JSON-able dump of every series that has recorded data:
        {name: {"type", "series": {label_str: value | {"count","sum"}}}}.
        Histograms collapse to count+sum (the bucket layout is an exposition
        concern); series never written are omitted to keep snapshots small."""
        with self._lock:
            metrics = list(self._metrics)
        out: Dict[str, dict] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                with m._lock:
                    series = {
                        _fmt_labels(m.label_names, lv).strip("{}"): {
                            "count": m._totals[lv],
                            "sum": round(m._sums[lv], 6),
                        }
                        for lv in m._totals
                    }
            else:
                with m._lock:
                    series = {
                        _fmt_labels(m.label_names, lv).strip("{}"): v
                        for lv, v in m._values.items()
                    }
            if series:
                out[m.name] = {"type": m.kind, "series": series}
        return out


def parse_exposition(text: str) -> Dict[str, dict]:
    """Strict parser for the Prometheus text format Registry.expose emits:
    {family: {"help", "type", "samples": [(name, labels_dict, value)]}}.
    Sample names carry the _bucket/_sum/_count suffixes."""
    import re as _re

    families: Dict[str, dict] = {}
    sample_re = _re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$")
    label_re = _re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            families.setdefault(name, {"help": None, "type": None, "samples": []})
            families[name]["help"] = help_
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            families.setdefault(name, {"help": None, "type": None, "samples": []})
            families[name]["type"] = kind.strip()
        elif line.startswith("#"):
            raise ValueError(f"unknown comment line: {line!r}")
        else:
            m = sample_re.match(line)
            if m is None:
                raise ValueError(f"unparseable sample line: {line!r}")
            name, _, labels_s, value_s = m.groups()
            labels = dict(label_re.findall(labels_s)) if labels_s else {}
            value = float("inf") if value_s == "+Inf" else float(value_s)
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                base = name[: -len(suffix)] if name.endswith(suffix) else None
                if base and families.get(base, {}).get("type") == "histogram":
                    family = base
                    break
            if family not in families:
                raise ValueError(f"sample {name!r} before HELP/TYPE")
            families[family]["samples"].append((name, labels, value))
    return families


# ------------------------------------------------- per-subsystem metric sets


# ---------------------------------------------------------------------------
# The families the ported verify path feeds


class BatchVerifyMetrics:
    """The batch-verify pipeline's flush series (crypto/batch.py, through
    libs/trace.record_flush), the kernel build and load seconds
    (ops/cuda_fe.build_library) and the device-health gauges, on the
    process-global registry. Help texts are the reference's word for word
    (compile_seconds' kinds here are "build" and "load": an nvcc build and
    the load of a built library). The reference's three breaker_* series
    are not here: the port has no circuit breaker (ROADMAP D1)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_batch_verify"
        self.flushes = reg.counter(
            f"{ns}_flushes_total", "Batch-verify flushes.", ("backend", "path")
        )
        self.sigs = reg.counter(
            f"{ns}_sigs_total", "Signatures submitted per flush path.",
            ("backend", "path"),
        )
        self.batch_size = reg.histogram(
            f"{ns}_batch_size", "Flush batch sizes (signatures per flush).",
            buckets=(1, 8, 64, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536),
        )
        self.flush_seconds = reg.histogram(
            f"{ns}_flush_seconds", "End-to-end flush wall seconds.", ("path",)
        )
        self.prep_seconds = reg.histogram(
            f"{ns}_prep_seconds",
            "Host-prep wall seconds (hashing, scalar math, sorting).",
        )
        self.jit_bucket = reg.gauge(
            f"{ns}_jit_bucket", "Padded jit shape bucket of the last flush."
        )
        self.padding_lanes = reg.gauge(
            f"{ns}_padding_lanes",
            "Pad lanes wasted by shape bucketing in the last flush.",
        )
        self.pubkey_cache_hits = reg.counter(
            f"{ns}_pubkey_cache_hits_total", "Decompressed-pubkey cache hits."
        )
        self.pubkey_cache_misses = reg.counter(
            f"{ns}_pubkey_cache_misses_total", "Decompressed-pubkey cache misses."
        )
        self.rlc_fallbacks = reg.counter(
            f"{ns}_rlc_fallbacks_total",
            "RLC combined-check failures recovered via the per-signature path.",
        )
        # recovery after a failed combined check, and provenance
        self.recovery_flushes = reg.counter(
            f"{ns}_recovery_flushes_total",
            "Device/host flushes spent isolating bad rows after a combined-"
            "check failure (RLC bisection sub-checks + per-sig leaves).",
        )
        self.quarantined_rows = reg.counter(
            f"{ns}_quarantined_rows_total",
            "Rows verified while their source was quarantined (routed "
            "through the scheduler's quarantine lane).",
        )
        self.poisoned_sources = reg.gauge(
            f"{ns}_poisoned_sources",
            "Sources currently quarantined by the suspicion scorer "
            "(peer:/sender:/lane: tags whose rows recently failed).",
        )
        # rows by signature scheme (crypto/batch.record_backend_rows)
        self.backend_rows = reg.counter(
            f"{ns}_backend_rows_total",
            "Verification rows by signature backend (ed25519/sr25519/"
            "bls12_381; an aggregate-commit verify counts each covered "
            "signer as one row).",
            ("backend",),
        )
        self.backend_flushes = reg.counter(
            f"{ns}_backend_flushes_total",
            "Flushes/verifies that carried rows of each signature backend.",
            ("backend",),
        )
        self.aggregate_size = reg.gauge(
            f"{ns}_aggregate_size",
            "Validators covered by the last BLS aggregate-commit "
            "verification (one 96-byte signature regardless of this value).",
        )
        # the streamed flush planner
        self.chunks_per_flush = reg.histogram(
            f"{ns}_chunks_per_flush",
            "Planner chunks per STREAMED flush (unstreamed flushes are not "
            "observed here — count those via flushes_total by path).",
            buckets=(1, 2, 3, 4, 6, 9, 17, 33, 65),
        )
        self.prep_overlap_seconds = reg.counter(
            f"{ns}_prep_overlap_seconds_total",
            "Host-prep seconds overlapped with device execution by the "
            "streamed planner's double buffer.",
        )
        # hidden host prep and the verified-row memo
        self.prep_hidden_ratio = reg.gauge(
            f"{ns}_prep_hidden_ratio",
            "Fraction of the last flush's host-prep wall hidden behind "
            "device/MSM execution (prep_overlap_s / prep_s; streamed, "
            "pipelined and striped host-RLC flushes all feed it).",
        )
        self.memo_hits = reg.counter(
            f"{ns}_memo_hits_total",
            "Rows answered from the cross-flush verified-row memo without "
            "re-verification (deferred-verified commit rows, light/catch-up "
            "re-verifies).",
        )
        self.compile_seconds = reg.counter(
            f"{ns}_compile_seconds_total",
            "Seconds spent tracing/exporting (export) or loading (deserialize) kernels.",
            ("kind",),
        )
        self.transfer_seconds = reg.counter(
            f"{ns}_transfer_seconds_total",
            "Seconds blocked in device result sync/fetch.",
        )
        # device health (libs/trace.mark_device_call, record_device_init)
        self.device_up = reg.gauge(
            f"{NAMESPACE}_device_up",
            "1 when the last device call succeeded, 0 after a failure/stall.",
        )
        self.device_init_seconds = reg.gauge(
            f"{NAMESPACE}_device_init_seconds",
            "Wall seconds of jax device/backend initialization.",
        )
        self.device_last_call_timestamp = reg.gauge(
            f"{NAMESPACE}_device_last_call_timestamp_seconds",
            "Unix time of the last successful device call (age = now - this).",
        )


class SLOMetrics:
    """SLO burn-rate accounting (libs/slo.py): declared budgets,
    good/breach observations, per-window burn rates and guard trips."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_slo"
        self.budget_seconds = reg.gauge(
            f"{ns}_budget_seconds",
            "Declared latency budget per objective ([slo] config).",
            ("slo",),
        )
        self.observations = reg.counter(
            f"{ns}_observations_total",
            "Latency observations classified against their budget.",
            ("slo", "verdict"),
        )
        self.burn_rate = reg.gauge(
            f"{ns}_burn_rate",
            "Error-budget burn rate per objective and window (1.0 consumes "
            "the budget exactly at the target rate).",
            ("slo", "window"),
        )
        self.tripped = reg.gauge(
            f"{ns}_tripped",
            "1 while the objective's multi-window burn-rate guard is tripped.",
            ("slo",),
        )
        self.trips = reg.counter(
            f"{ns}_trips_total",
            "Burn-rate guard trips (armed-to-tripped transitions).",
            ("slo",),
        )


class LightServiceMetrics:
    """Light service accounting (light/service.py): requests by outcome,
    cache hits, coalesced lanes per flush, sheds and conflicting headers."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_light"
        self.requests = reg.counter(
            f"{ns}_requests_total",
            "Light verification requests by outcome (cache/flush/bisection/"
            "shed/conflict/error).",
            ("outcome",),
        )
        self.cache_hits = reg.counter(
            f"{ns}_cache_hits_total",
            "Requests answered from the verified-header cache (includes "
            "single-flight followers).",
        )
        self.coalesced_lanes = reg.histogram(
            f"{ns}_coalesced_lanes_per_flush",
            "Signature lanes accumulated per coalesced cross-height device "
            "flush (many clients x many heights sharing one flush).",
            buckets=(1, 8, 64, 256, 1024, 4096, 16384, 65536),
        )
        self.shed = reg.counter(
            f"{ns}_shed_total",
            "Requests refused by the service-level max_pending backstop "
            "(the RPC LoadGate's sheds are counted separately).",
        )
        self.conflicting_headers = reg.counter(
            f"{ns}_conflicting_headers_total",
            "Conflicting-header detections (client-expected hash or a "
            "second verification path disagreed with the verified header).",
        )


class PubSubMetrics:
    """libs/pubsub.py subscription-buffer health: a full buffer drops its
    oldest event and counts it here."""

    def __init__(self, reg: Registry):
        self.dropped = reg.counter(
            f"{NAMESPACE}_pubsub_dropped_messages_total",
            "Events dropped oldest-first from a slow subscriber's full buffer.",
            ("subscriber",),
        )


class SchedulerMetrics:
    """Verification scheduler accounting (crypto/scheduler.py): per-lane
    queue depth, queue waits, rows per combined flush, and vote-lane
    preemptions of queued bulk work."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_verify_lane"
        self.lane_depth = reg.gauge(
            f"{ns}_depth",
            "Signature rows currently queued per scheduler lane "
            "(votes/light/admission/catchup).",
            ("lane",),
        )
        self.lane_wait = reg.histogram(
            f"{ns}_wait_seconds",
            "Seconds the oldest queued row of a lane waited before its "
            "combined flush started (one sample per flush per lane).",
            ("lane",),
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 1.0, 5.0),
        )
        self.lane_flush_rows = reg.histogram(
            f"{ns}_flush_rows",
            "Rows a lane contributed to each combined flush it rode.",
            ("lane",),
            buckets=(1, 8, 64, 256, 1024, 4096, 16384, 65536),
        )
        self.preemptions = reg.counter(
            f"{ns}_preemptions_total",
            "Vote-lane flushes dispatched while bulk-lane work was queued "
            "(the queued work waited; the votes did not).",
        )


class ConsensusMetrics:
    """reference: consensus/metrics.go:28."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_consensus"
        self.height = reg.gauge(f"{ns}_height", "Height of the chain.")
        self.rounds = reg.gauge(f"{ns}_rounds", "Number of rounds at the latest height.")
        self.validators = reg.gauge(f"{ns}_validators", "Number of validators.")
        self.validators_power = reg.gauge(
            f"{ns}_validators_power", "Total voting power of validators."
        )
        self.missing_validators = reg.gauge(
            f"{ns}_missing_validators", "Validators absent from the last commit."
        )
        self.byzantine_validators = reg.gauge(
            f"{ns}_byzantine_validators", "Validators with evidence this height."
        )
        self.num_txs = reg.gauge(f"{ns}_num_txs", "Transactions in the latest block.")
        self.block_size_bytes = reg.gauge(
            f"{ns}_block_size_bytes", "Size of the latest block."
        )
        self.total_txs = reg.counter(f"{ns}_total_txs", "Total committed transactions.")
        self.block_interval_seconds = reg.histogram(
            f"{ns}_block_interval_seconds", "Time between this and the last block."
        )
        self.commit_verify_seconds = reg.histogram(
            f"{ns}_commit_verify_seconds",
            "Wall time of (batched) commit signature verification.",
        )
        # step/round latency (reference: CometBFT consensus/metrics.go
        # StepDurationSeconds/RoundDurationSeconds, added v0.38)
        step_buckets = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
        self.step_duration_seconds = reg.histogram(
            f"{ns}_step_duration_seconds",
            "Wall seconds spent in each consensus step.",
            ("step",), buckets=step_buckets,
        )
        self.round_duration_seconds = reg.histogram(
            f"{ns}_round_duration_seconds",
            "Wall seconds from round entry to commit or round escalation.",
            buckets=step_buckets,
        )
        self.quorum_prevote_delay = reg.gauge(
            f"{ns}_quorum_prevote_delay",
            "Seconds from the proposal timestamp to +2/3 prevote quorum (last round).",
        )
        self.full_prevote_delay = reg.gauge(
            f"{ns}_full_prevote_delay",
            "Seconds from the proposal timestamp to 100% of prevotes (last round).",
        )
        self.proposal_receive_count = reg.counter(
            f"{ns}_proposal_receive_count",
            "Proposals processed, by outcome.", ("status",)
        )
        self.proposal_create_count = reg.counter(
            f"{ns}_proposal_create_count", "Proposals created by this node."
        )
        self.proposal_timeout_total = reg.counter(
            f"{ns}_proposal_timeout_total",
            "Propose-step timeouts (the node prevoted nil for lack of a proposal).",
        )
        self.late_votes = reg.counter(
            f"{ns}_late_votes_total",
            "Votes received for an earlier height.", ("vote_type",)
        )
        self.duplicate_votes = reg.counter(
            f"{ns}_duplicate_votes_total", "Exact-duplicate votes dropped."
        )
        self.block_parts = reg.counter(
            f"{ns}_block_parts_total",
            "Block parts received from peer gossip.", ("matches_current",)
        )
        self.block_gossip_receive_latency = reg.histogram(
            f"{ns}_block_gossip_receive_latency",
            "Seconds from the proposal timestamp (round start before the "
            "proposal arrives) to each gossiped block part's arrival.",
            buckets=step_buckets,
        )
        # cross-node trace propagation (chain observatory, ISSUE 8): per-hop
        # latencies from the origin stamp carried in the p2p envelope,
        # clock-skew corrected against the direct peer's ping/pong estimate
        self.proposal_propagation_seconds = reg.histogram(
            f"{ns}_proposal_propagation_seconds",
            "Seconds from a proposal's origin stamp to its first local "
            "receipt (skew-corrected).",
            buckets=step_buckets,
        )
        self.vote_propagation_seconds = reg.histogram(
            f"{ns}_vote_propagation_seconds",
            "Seconds from a vote's origin stamp to its local receipt "
            "(skew-corrected).",
            buckets=step_buckets,
        )


class MempoolMetrics:
    """reference: mempool/metrics.go."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_mempool"
        self.size = reg.gauge(f"{ns}_size", "Transactions in the mempool.")
        self.size_bytes = reg.gauge(
            f"{ns}_size_bytes", "Total bytes of transactions in the mempool."
        )
        self.tx_size_bytes = reg.histogram(
            f"{ns}_tx_size_bytes", "Transaction sizes.",
            buckets=(32, 128, 512, 2048, 8192, 65536, 1048576),
        )
        self.failed_txs = reg.counter(f"{ns}_failed_txs", "CheckTx failures.")
        self.recheck_times = reg.counter(f"{ns}_recheck_times", "Recheck runs.")
        # admission control (mempool/mempool.py overload protection)
        self.evicted_txs = reg.counter(
            f"{ns}_evicted_txs_total",
            "Resident txs evicted (LRU/lowest-priority) to admit new ones.",
        )
        self.expired_txs = reg.counter(
            f"{ns}_expired_txs_total", "Txs purged by TTL on the post-commit update."
        )
        self.rejected_txs = reg.counter(
            f"{ns}_rejected_txs_total",
            "Txs refused at admission, by reason (full/cache/quota/too_large).",
            ("reason",),
        )
        self.full = reg.gauge(
            f"{ns}_full", "1 while the mempool is at capacity (the reactor sheds gossip)."
        )


class P2PMetrics:
    """reference: p2p/metrics.go."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_p2p"
        self.peers = reg.gauge(f"{ns}_peers", "Connected peers.")
        self.peer_receive_bytes_total = reg.counter(
            f"{ns}_peer_receive_bytes_total", "Bytes received per channel.", ("chID",)
        )
        self.peer_send_bytes_total = reg.counter(
            f"{ns}_peer_send_bytes_total", "Bytes sent per channel.", ("chID",)
        )
        # flowrate gauges fed from the MConnection Monitors (libs/flowrate.py)
        # by the switch's periodic sampler (p2p/switch.py _flowrate_routine)
        self.send_rate_bytes = reg.gauge(
            f"{ns}_send_rate_bytes",
            "EWMA aggregate send rate across all peers (bytes/s).",
        )
        self.recv_rate_bytes = reg.gauge(
            f"{ns}_recv_rate_bytes",
            "EWMA aggregate receive rate across all peers (bytes/s).",
        )
        self.pending_send_messages = reg.gauge(
            f"{ns}_pending_send_messages",
            "Messages waiting in per-channel send queues, summed over peers.",
        )
        self.reconnect_attempts = reg.counter(
            f"{ns}_reconnect_attempts_total",
            "Persistent-peer reconnect dial attempts (p2p/switch.py backoff loop).",
        )
        # inbound admission control (p2p/conn/connection.py token buckets)
        self.oversized_msgs = reg.counter(
            f"{ns}_oversized_msgs_total",
            "Inbound messages that exceeded their channel's recv_message_capacity.",
            ("chID",),
        )
        self.rate_limited_msgs = reg.counter(
            f"{ns}_rate_limited_msgs_total",
            "Inbound messages shed by a sheddable channel's token bucket.",
            ("chID",),
        )
        self.rate_limit_disconnects = reg.counter(
            f"{ns}_rate_limit_disconnects_total",
            "Peers reported for persistent rate-limit misbehavior.",
        )
        # per-peer wall-clock skew from timestamped ping/pong (conn/
        # connection.py), sampled by the switch's flowrate routine; the
        # correction applied to cross-node propagation latencies
        self.clock_skew_seconds = reg.gauge(
            f"{ns}_clock_skew_seconds",
            "Estimated remote-minus-local wall-clock offset per peer.",
            ("peer",),
        )


class StateMetrics:
    """reference: state/metrics.go."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_state"
        self.block_processing_time = reg.histogram(
            f"{ns}_block_processing_time", "ApplyBlock wall seconds.",
        )


class BlockSyncMetrics:
    """reference: blocksync/metrics.go (Syncing gauge) plus the TPU path's
    batched-verification timing that the reference's serial loop lacks."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_blocksync"
        self.syncing = reg.gauge(
            f"{ns}_syncing", "1 while block sync (fast sync) is running."
        )
        self.num_peers = reg.gauge(
            f"{ns}_num_peers", "Peers the block pool can request from."
        )
        self.blocks_applied_total = reg.counter(
            f"{ns}_blocks_applied_total", "Blocks applied by block sync."
        )
        self.latest_block_height = reg.gauge(
            f"{ns}_latest_block_height", "Next height the pool will fetch."
        )
        self.verify_seconds = reg.histogram(
            f"{ns}_verify_seconds",
            "Wall seconds per batched commit-verification run (blocks x validators).",
        )
        self.peer_timeouts = reg.counter(
            f"{ns}_peer_timeouts_total",
            "Block requests that timed out (blocksync/pool.py; the peer "
            "backs off and is banned only on a sustained pattern).",
        )
        # -- ISSUE 12: pipelined catch-up ---------------------------------
        self.redos_total = reg.counter(
            f"{ns}_redos_total",
            "Heights requeued after a failed validation or in-flight redo "
            "(blocksync/pool.py redo_request).",
        )
        self.peer_score = reg.gauge(
            f"{ns}_peer_score",
            "EWMA quality score per block-sync peer (1.0 = perfect; peers "
            "below the ban threshold are disconnected). Series replaced "
            "each status pass so departed peers drop out.",
            ("peer",),
        )
        self.super_batch_rows = reg.histogram(
            f"{ns}_super_batch_rows",
            "Signature rows per cross-height super-batch verification "
            "(blocks x validators in one catch-up-lane flush).",
        )
        self.resume_events_total = reg.counter(
            f"{ns}_resume_events_total",
            "Crash-resume events: restarts that re-entered the catch-up "
            "pipeline from a checkpointed verified window without "
            "re-verifying it.",
        )
        self.degraded_runs_total = reg.counter(
            f"{ns}_degraded_runs_total",
            "Verify runs shrunk to single-block CPU verification because "
            "the verify circuit breaker was OPEN.",
        )


class StateSyncMetrics:
    """reference: the statesync half of node monitoring (the reference has
    no statesync metrics.go; series names follow its conventions)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_statesync"
        self.syncing = reg.gauge(
            f"{ns}_syncing", "1 while a state sync (snapshot restore) is running."
        )
        self.snapshots_discovered_total = reg.counter(
            f"{ns}_snapshots_discovered_total", "Distinct snapshots offered by peers."
        )
        self.snapshot_height = reg.gauge(
            f"{ns}_snapshot_height", "Height of the snapshot being restored."
        )
        self.snapshot_chunks_total = reg.gauge(
            f"{ns}_snapshot_chunks_total", "Chunk count of the snapshot being restored."
        )
        self.chunks_applied_total = reg.counter(
            f"{ns}_chunks_applied_total", "Snapshot chunks applied via ABCI."
        )
        # -- ISSUE 12: statesync hardening --------------------------------
        self.chunk_retries_total = reg.counter(
            f"{ns}_chunk_retries_total",
            "Chunk fetches re-requested after a timeout or app-demanded "
            "refetch (exponential backoff, different peer).",
        )
        self.bad_chunks_total = reg.counter(
            f"{ns}_bad_chunks_total",
            "Chunks the app refused as corrupt/torn (sender punished, "
            "chunk re-queued from another peer).",
        )
        self.resume_events_total = reg.counter(
            f"{ns}_resume_events_total",
            "Restores resumed from a crash checkpoint (already-applied "
            "chunks skipped on the re-offer).",
        )
        self.fallbacks_total = reg.counter(
            f"{ns}_fallbacks_total",
            "State syncs abandoned for the structured blocksync-from-"
            "genesis fallback (no viable snapshots/peers left).",
        )


class RPCMetrics:
    """rpc/server.py load-shedding gate + per-method request telemetry. No
    reference counterpart — the reference bounds connections at the listener
    (MaxOpenConnections); here the gate is per-request so health/consensus
    routes stay served while broadcast/query traffic sheds, and every
    dispatched request is attributed to its method (ISSUE 10: "why was my
    request slow?"). Method label cardinality is bounded to the declared
    route table — unknown methods fold into `_other` (rpc/server.py
    _method_label)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_rpc"
        self.inflight_requests = reg.gauge(
            f"{ns}_inflight_requests",
            "Sheddable RPC requests currently executing under the gate.",
        )
        self.shed_requests = reg.counter(
            f"{ns}_shed_requests_total",
            "Requests refused with 429 (gate full or overload pressure), by method.",
            ("method",),
        )
        self.request_duration = reg.histogram(
            f"{ns}_request_duration_seconds",
            "Wall seconds from dispatch to response per method (all "
            "transports + LocalClient route through the shared _dispatch).",
            ("method",),
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                     5.0, 10.0),
        )
        self.requests = reg.counter(
            f"{ns}_requests_total",
            "Dispatched RPC requests by method and outcome "
            "(ok/shed/reject/error).",
            ("method", "outcome"),
        )


class OverloadMetrics:
    """node/overload.py pressure controller: sampled queue depths folded
    into a pressure level and shed switches (docs/ROBUSTNESS.md,
    'Overload protection')."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_overload"
        self.pressure_level = reg.gauge(
            f"{ns}_pressure_level",
            "Overload pressure: 0=normal 1=elevated (txs shed) 2=critical "
            "(non-critical gossip shed too). Votes are never shed.",
        )
        self.pressure = reg.gauge(
            f"{ns}_pressure",
            "Saturation [0,1] of each sampled signal.",
            ("signal",),
        )
        self.transitions = reg.counter(
            f"{ns}_transitions_total",
            "Pressure-level changes, by direction (up/down).",
            ("direction",),
        )
        self.shed = reg.counter(
            f"{ns}_shed_total",
            "Work units shed by surface (mempool_gossip/rpc/p2p arrivals "
            "dropped while the corresponding switch was flipped).",
            ("surface",),
        )


class TxLifecycleMetrics:
    """Transaction lifecycle accounting (libs/txtrace.py): per-stage
    transition latencies and terminal outcomes of the tx journey
    received -> checked -> admitted -> gossiped -> proposed -> committed ->
    delivered. No reference counterpart — the reference's tx story ends at
    the mempool gauge; this is the layer that answers "where is my
    transaction?" per hash (the `tx_status` route reads the same ring)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_tx"
        self.stage_seconds = reg.histogram(
            f"{ns}_stage_seconds",
            "Wall seconds spent reaching each lifecycle stage from the "
            "previous one (received/checked/admitted/first_gossiped/"
            "proposed/committed/delivered + terminal rejects).",
            ("stage",),
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                     5.0, 15.0, 60.0),
        )
        self.terminal_total = reg.counter(
            f"{ns}_terminal_total",
            "Tx journeys ended, by outcome (delivered/rejected/evicted/"
            "expired).",
            ("outcome",),
        )
        self.tracked = reg.gauge(
            f"{ns}_tracked",
            "Tx journeys currently held in the lifecycle ring.",
        )


# Process-global registry: the series of the process-global crypto pipeline.
_GLOBAL_LOCK = threading.Lock()
_GLOBAL_REGISTRY: Optional[Registry] = None
_BATCH_METRICS: Optional[BatchVerifyMetrics] = None


def global_registry() -> Registry:
    global _GLOBAL_REGISTRY, _BATCH_METRICS
    with _GLOBAL_LOCK:
        if _GLOBAL_REGISTRY is None:
            _GLOBAL_REGISTRY = Registry()
            _BATCH_METRICS = BatchVerifyMetrics(_GLOBAL_REGISTRY)
        return _GLOBAL_REGISTRY


def batch_metrics() -> BatchVerifyMetrics:
    global_registry()
    return _BATCH_METRICS


class NodeMetrics:
    """One registry + all subsystem metric sets
    (reference: node/node.go:106 DefaultMetricsProvider)."""

    _latest: Optional["NodeMetrics"] = None

    def __init__(self):
        self.registry = Registry()
        self.consensus = ConsensusMetrics(self.registry)
        self.mempool = MempoolMetrics(self.registry)
        self.p2p = P2PMetrics(self.registry)
        self.state = StateMetrics(self.registry)
        self.blocksync = BlockSyncMetrics(self.registry)
        self.statesync = StateSyncMetrics(self.registry)
        self.rpc = RPCMetrics(self.registry)
        self.overload = OverloadMetrics(self.registry)
        self.slo = SLOMetrics(self.registry)
        self.light = LightServiceMetrics(self.registry)
        self.scheduler = SchedulerMetrics(self.registry)
        self.txtrace = TxLifecycleMetrics(self.registry)
        NodeMetrics._latest = self

    @classmethod
    def latest(cls) -> Optional["NodeMetrics"]:
        """Most recently constructed instance (a measurement reads the node
        it ran without plumbing the object out)."""
        return cls._latest

    def snapshot(self) -> dict:
        """Node-local written series only (the process-global batch-verify
        series are libs/trace.verify_stats()'s)."""
        return self.registry.snapshot()

    def expose(self) -> str:
        # node-local series + the process-global batch-verify/device series
        # (every in-process node shares the one crypto pipeline)
        return self.registry.expose() + global_registry().expose()
