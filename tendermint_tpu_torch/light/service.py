"""The light client as a service: the port's copy of
tendermint_tpu/light/service.py (LightService and its errors).

- concurrent `verify_height` requests land here;
- repeat heights are answered from a bounded verified-header cache
  (LightStore) with single-flight semantics: K concurrent requests for the
  same uncached height await one verification, not K;
- distinct-height misses are coalesced: same-tick misses group into one
  batch (light/coalescer.py), every miss submits its commit checks' rows
  through `begin_verify_commit_light_trusting` / `begin_verify_commit_light`
  under the scheduler's light-lane accumulator (crypto/scheduler.py), and
  the lane holds the rows for the coalescing window, so batches fired ticks
  apart, and the node's other consumers, share one combined flush;
- heights the trusted set cannot vouch for (+1/3 missing after a set
  rotation) fall back to the bisection client (light/client.py), whose
  interim headers warm the same cache;
- a `max_pending` backstop sheds misses (ErrLightOverloaded);
- a client-supplied expected hash that disagrees with the verified header
  is a structured conflicting-header error.

Every commit check runs on the service's `device` (None: the card): the
scheduler's flushes, the anchor check and the bisection client's. A
service made without a scheduler owns a private one on that device and
stops it in `close()`.

The service anchors on the earliest header its provider serves, verified
against its own validator set before use. With `metrics=`
(libs/metrics.LightServiceMetrics) it feeds the tendermint_light_* series
(requests by outcome, cache hits, coalesced lanes per flush, sheds,
conflicting headers); with `slo=` (libs/slo.SLOEngine) every request's
latency is a light_verify_p99 observation. `LocalNodeProvider` serves
light blocks from a node's own stores (node/node.py builds the service on
it when `[light_service] enabled`); the RPC server's light_verify,
light_block, light_status and /debug/light routes (rpc/server.py) call it.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs.kvdb import MemDB
from tendermint_tpu_torch.libs.trace import tracer as _tracer
from tendermint_tpu_torch.libs.txtrace import StageStats
from tendermint_tpu_torch.light import verifier
from tendermint_tpu_torch.light.client import Client, ErrConflictingHeaders, TrustOptions
from tendermint_tpu_torch.light.coalescer import Coalescer
from tendermint_tpu_torch.light.provider import ErrLightBlockNotFound, Provider, ProviderError
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.light.verifier import ErrInvalidHeader, LightError
from tendermint_tpu_torch.types.basic import NANOS
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validator_set import (
    CommitVerifyError,
    Fraction,
    NotEnoughVotingPowerError,
)

__all__ = [
    "LightService",
    "LightServiceError",
    "ErrLightOverloaded",
    "ErrConflictingHeader",
    "ErrHeightNotAvailable",
    "ErrVerificationFailed",
    "ErrLightDisabled",
    "ErrBadRequest",
]

# JSON-RPC error codes of the structured light errors, as the reference's
CODE_CONFLICT = -32010
CODE_NOT_AVAILABLE = -32011
CODE_INVALID = -32012
CODE_DISABLED = -32013
CODE_BAD_REQUEST = -32602  # JSON-RPC invalid params


class LightServiceError(Exception):
    """Structured service error: `code` + `data` ride the JSON-RPC error
    object so a client can dispatch on the failure, not parse a string."""

    code = CODE_INVALID

    def __init__(self, message: str, data: Optional[dict] = None):
        super().__init__(message)
        self.data = data or {}


class ErrLightOverloaded(LightServiceError):
    """Service-level admission refusal; the RPC layer translates this to
    HTTP 429 + Retry-After exactly like a LoadGate shed."""

    code = -32005  # same code as RPCShedError's translation


class ErrConflictingHeader(LightServiceError):
    """The verified header disagrees with what the client (or another
    cached verification) expected — possible light-client attack."""

    code = CODE_CONFLICT

    def __init__(self, height: int, verified_hash: bytes, other_hash: bytes):
        super().__init__(
            f"conflicting header at height {height}: verified "
            f"{verified_hash.hex()} vs {other_hash.hex()}",
            {
                "height": height,
                "verified_hash": verified_hash.hex().upper(),
                "conflicting_hash": other_hash.hex().upper(),
            },
        )


class ErrHeightNotAvailable(LightServiceError):
    code = CODE_NOT_AVAILABLE


class ErrVerificationFailed(LightServiceError):
    code = CODE_INVALID


class ErrLightDisabled(LightServiceError):
    """The node runs without a light service ([light_service] enabled =
    false) — a structured refusal, not an internal error + stack trace."""

    code = CODE_DISABLED


class ErrBadRequest(LightServiceError):
    """Unparseable client input (e.g. a non-hex hash parameter)."""

    code = CODE_BAD_REQUEST


class _NeedBisection(Exception):
    """Internal: the fast path can't vouch (trust-level miss / expired or
    missing trusted ancestor); retry through the bisection client."""


@dataclass
class _Job:
    """One coalesced miss: verify `target` from `trusted` (non-adjacent
    skipping check, or adjacent when the heights touch)."""

    height: int
    target: LightBlock
    trusted: LightBlock


class LocalNodeProvider(Provider):
    """Provider reading the serving node's OWN stores: no RPC round trip,
    no re-parse (the reference's light service proxies over HTTP even to
    localhost; here the service lives in the node)."""

    def __init__(self, node):
        self.node = node
        self.calls = 0

    def chain_id(self) -> str:
        return self.node.genesis.chain_id

    def earliest_height(self) -> int:
        return max(self.node.block_store.base, 1)

    async def light_block(self, height: Optional[int]) -> LightBlock:
        # the body is synchronous store-read + parse + hash work: off the
        # shared event loop, so a burst of cache misses never delays
        # consensus
        return await asyncio.get_running_loop().run_in_executor(
            None, self._light_block_sync, height
        )

    def _light_block_sync(self, height: Optional[int]) -> LightBlock:
        from tendermint_tpu_torch.types.light import SignedHeader

        self.calls += 1
        store = self.node.block_store
        if height is None:
            height = store.height
        block = store.load_block(height)
        if block is None:
            raise ErrLightBlockNotFound(f"no block at height {height}")
        commit = None
        nxt = store.load_block(height + 1)
        if nxt is not None and nxt.last_commit.height == height:
            commit = nxt.last_commit
        else:
            commit = store.load_seen_commit(height)
        if commit is None:
            raise ErrLightBlockNotFound(f"no commit at height {height}")
        vals = self.node.state_store.load_validators(height)
        if vals is None:
            raise ErrLightBlockNotFound(f"no validator set at height {height}")
        lb = LightBlock(SignedHeader(block.header, commit), vals)
        lb.validate_basic(self.chain_id())
        return lb


class LightService:
    """The verification-serving subsystem, driven over a Provider (a
    node's LocalNodeProvider, or a MockProvider in tests)."""

    def __init__(
        self,
        chain_id: str,
        provider: Provider,
        config,
        *,
        store: Optional[LightStore] = None,
        metrics=None,
        slo=None,
        trust_level: Optional[Fraction] = None,
        now_ns: Optional[Callable[[], int]] = None,
        scheduler=None,
        own_scheduler_if_missing: bool = True,
        device=None,
    ):
        self.chain_id = chain_id
        self.provider = provider
        self.config = config
        self.store = store or LightStore(MemDB())
        self.metrics = metrics  # libs/metrics.LightServiceMetrics or None
        self.slo = slo  # libs/slo.SLOEngine or None
        self.device = device
        # every batch's commit-check rows ride the scheduler's light lane,
        # whose max_wait is pinned below to this service's coalesce_window;
        # a service given no scheduler owns a private one on `device`, and
        # own_scheduler_if_missing=False makes plain per-batch
        # FlushAccumulator flushes instead (same-tick coalescing only)
        self._owns_scheduler = scheduler is None and own_scheduler_if_missing
        if self._owns_scheduler:
            from tendermint_tpu_torch.crypto.scheduler import VerifyScheduler

            scheduler = VerifyScheduler(device=device)
        self.scheduler = scheduler
        if scheduler is not None:
            scheduler.set_lane_wait("light", float(config.coalesce_window))
        self._seen_flush_seqs: set = set()  # device-flush dedupe (bounded)
        self.trust_level = trust_level or Fraction(
            getattr(config, "trust_level_numerator", 1),
            getattr(config, "trust_level_denominator", 3),
        )
        verifier.validate_trust_level(self.trust_level)
        self._now_ns = now_ns or time.time_ns
        self.trust_period_ns = int(float(config.trust_period) * NANOS)
        self.max_clock_drift_ns = int(
            float(getattr(config, "max_clock_drift", 10.0)) * NANOS
        )
        self.cache_blocks = int(config.cache_blocks)
        self.max_pending = int(config.max_pending)
        self.coalescer = Coalescer(
            self._run_jobs,
            max_jobs=int(config.max_heights_per_flush),
        )
        self._inflight: Dict[int, asyncio.Future] = {}  # single-flight map
        self._pending = 0
        self._anchor_lock = asyncio.Lock()
        self._counter_lock = threading.Lock()
        # hot-path LRU of DESERIALIZED light blocks: the Zipfian workload
        # hits a few heights constantly, and a store hit re-parses the whole
        # block (commit sigs + valset) from bytes per request
        self._hot: "OrderedDict[int, LightBlock]" = OrderedDict()
        self._hot_cap = max(8, min(self.cache_blocks, 256))
        # counters
        self.requests_total = 0
        self.cache_hits = 0
        self.singleflight_waits = 0
        self.flushes = 0
        self.lanes_total = 0
        self.bisections = 0
        self.sheds = 0
        self.conflicts = 0
        self.outcomes: Dict[str, int] = {}
        # per-request stage spans: a slow verify_height p99 is
        # attributable to a STAGE — admission backstop, cache probe,
        # single-flight wait, provider fetch, coalesce-window wait, the
        # shared device flush wall, or the bisection walk — instead of one
        # opaque number. Recording is gated on the tracer flag (disabled
        # costs one flag check per site); percentiles surface in status().
        self.stage_stats = StageStats()

    # -- public API -----------------------------------------------------------

    async def verify_height(
        self, height: int, expected_hash: Optional[bytes] = None
    ) -> Tuple[LightBlock, str]:
        """Verify (or recall) the light block at `height`; returns
        (light_block, source) with source in cache|flush|bisection.
        Raises a structured LightServiceError on refusal/failure."""
        if height <= 0:
            raise ErrHeightNotAvailable(f"height must be positive, got {height}")
        t0 = time.perf_counter()
        self.requests_total += 1
        try:
            lb, source = await self._verify_height_inner(height)
        except ErrLightOverloaded:
            self._count_outcome("shed")
            raise
        except LightServiceError as e:
            self._count_outcome(
                "conflict" if isinstance(e, ErrConflictingHeader) else "error"
            )
            self._observe_latency(time.perf_counter() - t0)
            raise
        if expected_hash and lb.hash() != expected_hash:
            self._record_conflict()
            self._count_outcome("conflict")
            self._observe_latency(time.perf_counter() - t0)
            raise ErrConflictingHeader(height, lb.hash(), expected_hash)
        self._count_outcome(source)
        self._observe_latency(time.perf_counter() - t0)
        return lb, source

    def _hot_get(self, height: int) -> Optional[LightBlock]:
        with self._counter_lock:
            lb = self._hot.get(height)
            if lb is not None:
                self._hot.move_to_end(height)
            return lb

    def _hot_put(self, lb: LightBlock) -> None:
        with self._counter_lock:
            self._hot[lb.height] = lb
            self._hot.move_to_end(lb.height)
            while len(self._hot) > self._hot_cap:
                self._hot.popitem(last=False)

    def _span(self, stage: str, t0: float) -> None:
        """Record one per-request stage duration — one flag check when
        tracing is off (stage taxonomy: admission, cache_probe,
        singleflight_wait, provider_fetch, coalesce_wait, flush_wall,
        bisection)."""
        if _tracer.enabled:
            self.stage_stats.observe(stage, time.perf_counter() - t0)

    async def _verify_height_inner(self, height: int) -> Tuple[LightBlock, str]:
        t_probe = time.perf_counter()
        cached = self._hot_get(height)
        if cached is None:
            cached = self.store.light_block(height)
            if cached is not None:
                self._hot_put(cached)
        self._span("cache_probe", t_probe)
        if cached is not None:
            with self._counter_lock:
                self.cache_hits += 1
            if self.metrics is not None:
                self.metrics.cache_hits.inc()
            return cached, "cache"
        # single-flight: the FIRST requester for an uncached height leads;
        # everyone else awaits its future (one verification, not K)
        fut = self._inflight.get(height)
        if fut is not None:
            with self._counter_lock:
                self.singleflight_waits += 1
            t_wait = time.perf_counter()
            kind, value = await asyncio.shield(fut)
            self._span("singleflight_wait", t_wait)
            if kind == "err":
                raise value
            if kind == "retry":
                # the leader was CANCELLED (its client disconnected) — that
                # must not cascade to the whole cohort; race to lead a fresh
                # verification instead
                return await self._verify_height_inner(height)
            # the follower is answered from the leader's now-cached
            # verification — a cache hit, counted only on success
            with self._counter_lock:
                self.cache_hits += 1
            if self.metrics is not None:
                self.metrics.cache_hits.inc()
            return value, "cache"  # served from the leader's verification
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._inflight[height] = fut
        try:
            result = await self._verify_miss(height)
        except asyncio.CancelledError:
            if not fut.done():
                fut.set_result(("retry", None))
            raise
        except BaseException as e:
            if not fut.done():
                fut.set_result(("err", e))
            raise
        else:
            if not fut.done():
                fut.set_result(("ok", result[0]))
            return result
        finally:
            self._inflight.pop(height, None)

    async def _verify_miss(self, height: int) -> Tuple[LightBlock, str]:
        t_adm = time.perf_counter()
        if self.max_pending > 0 and self._pending >= self.max_pending:
            with self._counter_lock:
                self.sheds += 1
            if self.metrics is not None:
                self.metrics.shed.inc()
            raise ErrLightOverloaded(
                f"light service at max_pending={self.max_pending}"
            )
        self._pending += 1
        try:
            await self._ensure_anchor()
            # the admission span covers the backstop check + anchor wait —
            # on a cold service the first requests pay the anchor
            # verification here, and the span names that
            self._span("admission", t_adm)
            t_fetch = time.perf_counter()
            try:
                target = await self.provider.light_block(height)
            except ErrLightBlockNotFound as e:
                raise ErrHeightNotAvailable(str(e)) from e
            except ProviderError as e:
                raise ErrHeightNotAvailable(f"provider failed: {e}") from e
            finally:
                self._span("provider_fetch", t_fetch)
            try:
                # hashing-heavy for large valsets — off the shared loop
                await asyncio.get_running_loop().run_in_executor(
                    None, target.validate_basic, self.chain_id
                )
            except ValueError as e:
                raise ErrVerificationFailed(f"invalid light block: {e}") from e
            # a concurrent bisection may have verified this exact height
            # while we awaited the provider — serve it instead of verifying
            # against ourselves
            cached = self.store.light_block(height)
            if cached is not None:
                return cached, "cache"
            trusted = self.store.light_block_before(height)
            source = "flush"
            if trusted is None or verifier.header_expired(
                trusted.signed_header, self.trust_period_ns, self._now_ns()
            ):
                lb = await self._bisect_spanned(height)
                source = "bisection"
            else:
                try:
                    t_coal = time.perf_counter()
                    try:
                        lb = await self.coalescer.submit(
                            _Job(height=height, target=target, trusted=trusted)
                        )
                    finally:
                        # window-arm wait + the shared flush, as this request
                        # experienced it (the flush wall alone is recorded
                        # per-window by _run_jobs)
                        self._span("coalesce_wait", t_coal)
                except _NeedBisection:
                    lb = await self._bisect_spanned(height)
                    source = "bisection"
                except (CommitVerifyError, ErrInvalidHeader, LightError) as e:
                    raise ErrVerificationFailed(
                        f"verification failed at height {height}: {e}"
                    ) from e
            self._save_verified(lb)
            return lb, source
        finally:
            self._pending -= 1

    # -- anchoring / fallback -------------------------------------------------

    async def _ensure_anchor(self) -> None:
        """Pin the root of trust: the earliest header the provider serves,
        verified against its own validator set (+2/3), saved as the first
        cache entry. Runs once (or again if the cache was fully pruned)."""
        if self.store.size() > 0:
            return
        async with self._anchor_lock:
            if self.store.size() > 0:
                return
            anchor_h = None
            earliest = getattr(self.provider, "earliest_height", None)
            if callable(earliest):
                anchor_h = earliest()
            try:
                try:
                    lb = await self.provider.light_block(anchor_h or 1)
                except ProviderError:
                    lb = await self.provider.light_block(None)  # latest
            except ProviderError as e:
                # a fresh node with no committed blocks yet: "not ready",
                # never a -32603 internal error
                raise ErrHeightNotAvailable(
                    f"no anchor header available yet: {e}"
                ) from e
            def _check_anchor():
                lb.validate_basic(self.chain_id)
                # the anchor is self-vouching: +2/3 of its own valset
                # signed it
                lb.validator_set.verify_commit_light(
                    self.chain_id,
                    lb.signed_header.commit.block_id,
                    lb.height,
                    lb.signed_header.commit,
                    device=self.device,
                )

            try:
                # signature verification off the shared event loop — the
                # consensus reactor must never wait behind a light anchor
                await asyncio.get_running_loop().run_in_executor(
                    None, _check_anchor
                )
            except (ValueError, CommitVerifyError) as e:
                raise ErrVerificationFailed(f"anchor rejected: {e}") from e
            self.store.save_light_block(lb)

    async def _bisect_spanned(self, height: int) -> LightBlock:
        t0 = time.perf_counter()
        try:
            return await self._bisect(height)
        finally:
            self._span("bisection", t0)

    async def _bisect(self, height: int) -> LightBlock:
        """Bisection fallback (light/client.py) for heights the direct
        skipping check can't vouch for; interim headers land in the shared
        cache and warm future windows. The whole walk — many serial commit
        verifications — runs in a worker thread with its own event loop so
        it never blocks the loop the consensus reactor shares; a FRESH
        Client per call keeps asyncio primitives loop-local (initialize is
        ~free: the anchor is already cached, so it short-circuits on the
        stored hash)."""
        with self._counter_lock:
            self.bisections += 1
        anchor = self.store.first_light_block()
        if anchor is None:
            raise ErrHeightNotAvailable("no trusted anchor")
        now_ns = self._now_ns()

        def _run() -> LightBlock:
            client = Client(
                self.chain_id,
                TrustOptions(self.trust_period_ns, anchor.height, anchor.hash()),
                self.provider,
                [],
                self.store,
                trust_level=self.trust_level,
                max_clock_drift_ns=self.max_clock_drift_ns,
                pruning_size=self.cache_blocks,
                device=self.device,
            )

            async def go():
                await client.initialize(now_ns)
                return await client.verify_light_block_at_height(height, now_ns)

            return asyncio.run(go())

        try:
            return await asyncio.get_running_loop().run_in_executor(None, _run)
        except ErrConflictingHeaders as e:
            self._record_conflict()
            blocks = getattr(e, "conflicting_blocks", [])
            other = blocks[0].hash() if blocks else b""
            raise ErrConflictingHeader(height, b"", other) from e
        except LightError as e:
            raise ErrVerificationFailed(
                f"bisection failed at height {height}: {e}"
            ) from e

    def _save_verified(self, lb: LightBlock) -> None:
        existing = self.store.light_block(lb.height)
        if existing is not None and existing.hash() != lb.hash():
            # two verification paths produced different headers for one
            # height — surface it, never silently overwrite trusted state
            self._record_conflict()
            raise ErrConflictingHeader(lb.height, existing.hash(), lb.hash())
        self.store.save_light_block(lb)
        self._hot_put(lb)
        self.store.prune(self.cache_blocks)

    # -- the coalesced window body (worker thread) ----------------------------

    def _run_jobs(self, jobs: List[_Job]):
        """One coalesced batch: submit every job's commit checks under the
        scheduler's light-lane accumulator, flush ONCE (the rows join the
        node-wide combined flush after at most the lane's coalescing
        window), then settle each job from its own mask slice. Runs in the
        coalescer's worker thread — the lane wait parks this thread, never
        the event loop."""
        from tendermint_tpu_torch.crypto import batch as _batch

        now_ns = self._now_ns()
        prepared: List = []
        t_flush = time.perf_counter()
        acc = (
            self.scheduler.accumulate("light")
            if self.scheduler is not None
            else _batch.FlushAccumulator(device=self.device)
        )
        with _batch.accumulate_flushes(acc):
            for job in jobs:
                try:
                    prepared.append(self._submit_job(job, now_ns))
                except Exception as e:
                    prepared.append(e)
            lanes = acc.lanes
        acc.flush()  # rides the light lane's shared device flush
        # one sample per BATCH (submit phases + lane wait + the shared
        # device flush): the wall every rider of this batch shares
        self._span("flush_wall", t_flush)
        results = []
        for job, fins in zip(jobs, prepared):
            if isinstance(fins, Exception):
                results.append((False, fins))
                continue
            try:
                self._finish_job(fins)
                results.append((True, job.target))
            except Exception as e:
                results.append((False, e))
        with self._counter_lock:
            # `flushes` counts DEVICE flushes our rows rode: batches that
            # merged into one combined flush share a flush_seq and count
            # once. A SET of seen seqs (bounded), not a max-seen watermark:
            # concurrent window bodies riding different flushes can
            # complete out of order. Plain accumulators (no scheduler) and
            # inline fallbacks count their own flushes.
            seq = getattr(acc, "flush_seq", None)
            if seq is None:
                if lanes:
                    self.flushes += getattr(acc, "flush_count", 1)
            elif seq not in self._seen_flush_seqs:
                if len(self._seen_flush_seqs) > 4096:
                    self._seen_flush_seqs.clear()
                self._seen_flush_seqs.add(seq)
                self.flushes += 1
            self.lanes_total += lanes
        if self.metrics is not None:
            self.metrics.coalesced_lanes.observe(lanes)
        return results, {"lanes": lanes, "jobs": len(jobs)}

    def _submit_job(self, job: _Job, now_ns: int):
        """Header checks + SUBMIT phase of the commit verifications (the
        rows accumulate into the shared flush); finishes are deferred to
        after the flush. Mirrors light/verifier.verify_non_adjacent /
        verify_adjacent with the device sync factored out."""
        target, trusted = job.target, job.trusted
        verifier._verify_new_header_and_vals(
            target.signed_header,
            target.validator_set,
            trusted.signed_header,
            now_ns,
            self.max_clock_drift_ns,
        )
        commit = target.signed_header.commit
        if target.height == trusted.height + 1:
            # adjacent: the new valset is pinned by NextValidatorsHash —
            # checked BEFORE any signature rows join the shared flush
            # (verify_adjacent rejects before verifying too)
            if (
                target.header.validators_hash
                != trusted.header.next_validators_hash
            ):
                raise ErrInvalidHeader(
                    "new header's validators do not match the trusted "
                    "header's next validators"
                )
            fin_light = target.validator_set.begin_verify_commit_light(
                self.chain_id, commit.block_id, target.height, commit
            )
            return None, fin_light
        fin_trusting = trusted.validator_set.begin_verify_commit_light_trusting(
            self.chain_id, commit, self.trust_level
        )
        fin_light = target.validator_set.begin_verify_commit_light(
            self.chain_id, commit.block_id, target.height, commit
        )
        return fin_trusting, fin_light

    @staticmethod
    def _finish_job(fins) -> None:
        fin_trusting, fin_light = fins
        if fin_trusting is not None:
            try:
                fin_trusting()
            except NotEnoughVotingPowerError as e:
                # recoverable: the trusted valset can't vouch — bisect
                raise _NeedBisection(str(e)) from e
        fin_light()

    # -- bookkeeping / introspection ------------------------------------------

    def _count_outcome(self, outcome: str) -> None:
        with self._counter_lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        if self.metrics is not None:
            self.metrics.requests.labels(outcome).inc()

    def _record_conflict(self) -> None:
        with self._counter_lock:
            self.conflicts += 1
        if self.metrics is not None:
            self.metrics.conflicting_headers.inc()

    def _observe_latency(self, seconds: float) -> None:
        if self.slo is not None:
            self.slo.observe("light_verify_p99", seconds)

    def status(self) -> dict:
        """Span and policy, no counters (the reference's `light_status`).
        Reads only the store's height index — a scrape must not pay two
        full light-block parses just to report the span."""
        heights = self.store.heights()
        return {
            "enabled": True,
            "chain_id": self.chain_id,
            "trusted_span": {
                "first": heights[0] if heights else 0,
                "last": heights[-1] if heights else 0,
            },
            "cache_size": len(heights),
            "cache_blocks": self.cache_blocks,
            # the coalescing window now lives in the scheduler's light lane
            # (this service pins it from [light_service] coalesce_window)
            "coalesce_window_s": float(self.config.coalesce_window),
            "max_heights_per_flush": self.coalescer.max_jobs,
            "max_pending": self.max_pending,
            "pending": self._pending,
            # per-request stage latency attribution: a slow p99
            # names its stage — cache_probe / singleflight_wait / admission /
            # provider_fetch / coalesce_wait / flush_wall / bisection
            "stage_percentiles": self.stage_stats.percentiles(),
        }

    def stats(self) -> dict:
        """status() with every counter and the coalescer's stats (the
        reference serves it as GET /debug/light)."""
        with self._counter_lock:
            counters = {
                "requests": self.requests_total,
                "cache_hits": self.cache_hits,
                "singleflight_waits": self.singleflight_waits,
                "flushes": self.flushes,
                "lanes_total": self.lanes_total,
                "bisections": self.bisections,
                "sheds": self.sheds,
                "conflicting_headers": self.conflicts,
                "outcomes": dict(self.outcomes),
            }
        out = self.status()
        out.update(counters)
        out["coalescer"] = self.coalescer.stats()
        return out

    def close(self) -> None:
        self.coalescer.close()
        if self._owns_scheduler and self.scheduler is not None:
            self.scheduler.close()
