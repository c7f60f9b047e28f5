"""The node-wide verification scheduler: one device, every consumer, QoS
lanes. The port's copy of tendermint_tpu/crypto/scheduler.py.

Every consumer submits its (pubkey, msg, sig) rows to a `VerifyScheduler`,
which owns the card and drains priority lanes into combined flushes of
crypto/batch.py's `verify_batch`. Lanes, in priority order:

    votes      the live consensus path. Never queues: a vote flush runs at
               once on the caller's thread, alone; bulk rows never ride it.
    light      light-client serving (light/service.py). Rows wait at most
               `light_max_wait` (the service's coalescing window), so many
               clients and heights share one flush.
    admission  transaction signature prechecks: bounded wait and rows.
    catchup    blocksync replay. Soaks idle capacity: it flushes when no
               hotter lane has rows, with a starvation floor.
    quarantine rows from sources the suspicion scorer has quarantined
               (crypto/provenance.py). Flushes alone, only when every other
               lane is empty (plus a starvation floor), so a poisoning flood
               forces recovery only on its own flushes.

`set_pressure` shrinks the admission and catch-up budgets (level 1) and
pauses catch-up (level 2). `stats()` is the `scheduler` block of
libs/trace.verify_stats().

One dispatch thread drains the lanes into combined `verify_batch` calls on
the scheduler's `device` (None: the card, as verify_batch resolves it).
Every route of verify_batch gives the exact per-row mask, so each
consumer's slice equals a standalone verify_batch of its own rows. An
oversized flush splits at `batch.planner_chunk_rows()` with a vote
preemption point between chunks. A flush that raises re-raises in every
ticket of that flush and the thread survives; there is no retry and no
host route (ROADMAP D1: the reference's circuit breaker is not ported).

Consumers integrate three ways:

    mask = sched.verify_rows("catchup", pubkeys, msgs, sigs)     # blocking
    with sched.lane_scope("catchup"):                            # transparent
        ...        # any verify_batch / verify_commit* inside rides the lane
    with batch.accumulate_flushes(sched.accumulate("light")) as acc:
        ...        # submit / finish phases; acc.flush() rides the lane

All three block the calling thread until the lane's flush lands. A closed
scheduler, or a ticket still queued at `wait_timeout`, verifies inline on the
caller's thread (on the same device). A ticket that a running flush already
holds at `wait_timeout` waits one more `wait_timeout` for that flush before
it falls back (the reference falls back at once and verifies the same rows
twice; ROADMAP lists the difference).

With `metrics=` (libs/metrics.SchedulerMetrics) the scheduler feeds the
tendermint_verify_lane_* series (queue depth per lane, each flush's queue
wait and rows per lane, vote preemptions); with `slo=` (libs/slo.SLOEngine)
each flush's lane waits are verify_lane_wait_<lane> observations. The
stats carry the reference's `mesh_ladder` entry: the rung every queued
flush routes through (crypto/batch.mesh_ladder_state).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.libs.txtrace import StageStats

logger = logging.getLogger("tendermint_tpu_torch.crypto.scheduler")

__all__ = ["LANES", "VerifyScheduler", "LaneAccumulator", "Ticket", "set_default",
           "default_scheduler"]

# priority order: index 0 preempts everything below it
LANES = ("votes", "light", "admission", "catchup", "quarantine")

# a starving catch-up (or quarantine) lane flushes anyway after this many
# times its configured wait, unless pressure level 2 pauses it
CATCHUP_STARVATION_FACTOR = 10.0


class Ticket:
    """One submit's claim on a future combined flush: `wait()` blocks until
    the dispatch thread lands the flush and returns this submit's verdict
    slice, or re-raises the flush's error."""

    __slots__ = ("lane", "rows", "enqueued_t", "flush_seq", "wait_s", "_event", "_mask",
                 "_error")

    def __init__(self, lane: str, rows: int):
        self.lane = lane
        self.rows = rows
        self.enqueued_t = time.monotonic()
        self.flush_seq: Optional[int] = None  # the flush this rode
        self.wait_s: Optional[float] = None  # queue wait (enqueue -> flush)
        self._event = threading.Event()
        self._mask: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"verify ticket ({self.lane}, {self.rows} rows) not flushed "
                               f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._mask

    def _resolve(self, mask: Optional[np.ndarray], error: Optional[BaseException]) -> None:
        self._mask = mask
        self._error = error
        self._event.set()


class _LaneState:
    __slots__ = ("name", "queue", "rows", "flushes", "rows_total", "paused")

    def __init__(self, name: str):
        self.name = name
        self.queue: deque = deque()  # of (Ticket, pubkeys, msgs, sigs, key_types, sources)
        self.rows = 0  # queued rows (depth)
        self.flushes = 0  # flushes that carried this lane's rows
        self.rows_total = 0  # rows flushed, lifetime
        self.paused = False  # pressure level 2 (catch-up only)


class _Budgets:
    """Effective per-lane budgets under the current pressure level."""

    __slots__ = ("max_rows", "max_wait")

    def __init__(self, max_rows: int, max_wait: float):
        self.max_rows = max_rows
        self.max_wait = max_wait


class LaneAccumulator:
    """FlushAccumulator-compatible adapter (batch.accumulate_flushes installs
    it unchanged): rows accumulate during the submit phases, and `flush()`
    rides the scheduler lane, so e.g. a whole light window joins the
    node-wide combined flush. A failed flush re-raises at every later
    finish, as FlushAccumulator's does."""

    __slots__ = ("scheduler", "lane", "pubkeys", "msgs", "sigs", "key_types", "_mask",
                 "_flushed", "_error", "flush_count", "flush_seq")

    def __init__(self, scheduler: "VerifyScheduler", lane: str):
        self.scheduler = scheduler
        self.lane = lane
        self.pubkeys: list = []
        self.msgs: list = []
        self.sigs: list = []
        self.key_types: list = []
        self._mask: Optional[np.ndarray] = None
        self._flushed = False
        self._error: Optional[BaseException] = None
        self.flush_count = 0
        self.flush_seq: Optional[int] = None  # the shared flush's id

    @property
    def lanes(self) -> int:
        return len(self.pubkeys)

    def add(self, pubkeys, msgs, sigs, key_types) -> tuple:
        if self._flushed:
            raise RuntimeError("LaneAccumulator already flushed")
        start = len(self.pubkeys)
        self.pubkeys.extend(pubkeys)
        self.msgs.extend(msgs)
        self.sigs.extend(sigs)
        self.key_types.extend(key_types if key_types is not None else ["ed25519"] * len(pubkeys))
        return start, len(self.pubkeys)

    def flush(self) -> np.ndarray:
        if self._flushed:
            if self._error is not None:
                raise self._error
            return self._mask
        self._flushed = True
        if not self.pubkeys:
            self._mask = np.zeros(0, dtype=bool)
            return self._mask
        self.flush_count += 1
        try:
            kt = self.key_types if any(t != "ed25519" for t in self.key_types) else None
            ticket = self.scheduler.submit(self.lane, self.pubkeys, self.msgs, self.sigs,
                                           self.key_types)
            if ticket is None:  # closed: inline on this thread
                self._mask = self.scheduler._inline(self.pubkeys, self.msgs, self.sigs, kt)
                return self._mask
            self._mask = self.scheduler._wait_or_fallback(
                ticket, (self.pubkeys, self.msgs, self.sigs, kt))
            self.flush_seq = ticket.flush_seq
        except BaseException as e:
            self._error = e
            raise
        return self._mask


class VerifyScheduler:
    """The node-wide device coordinator (module docstring)."""

    def __init__(self, config=None, backend: Optional[str] = None, device=None,
                 metrics=None, slo=None):
        """config: config.SchedulerConfig (None: defaults); backend: the
        crypto backend of the combined flushes (None or "": the crypto
        default); device: where they run (None: the card); metrics:
        libs/metrics.SchedulerMetrics or None; slo: libs/slo.SLOEngine or
        None (fed verify_lane_wait_* per flush)."""
        if config is None:
            from tendermint_tpu_torch.config import SchedulerConfig

            config = SchedulerConfig()
        self.config = config
        self.backend = backend or (getattr(config, "backend", "") or None)
        self.device = device
        self.metrics = metrics
        self.slo = slo
        self._lanes: Dict[str, _LaneState] = {n: _LaneState(n) for n in LANES}
        self._base: Dict[str, _Budgets] = {
            "votes": _Budgets(int(config.votes_max_rows), float(config.votes_max_wait)),
            "light": _Budgets(int(config.light_max_rows), float(config.light_max_wait)),
            "admission": _Budgets(int(config.admission_max_rows),
                                  float(config.admission_max_wait)),
            "catchup": _Budgets(int(config.catchup_max_rows), float(config.catchup_max_wait)),
            "quarantine": _Budgets(int(getattr(config, "quarantine_max_rows", 4096)),
                                   float(getattr(config, "quarantine_max_wait", 0.05))),
        }
        self.pressure_level = 0
        self.wait_timeout = float(getattr(config, "wait_timeout", 30.0))
        self._cv = threading.Condition()
        self._closed = False
        self.flush_seq = 0  # flushes issued
        self.preemptions = 0  # vote flushes that jumped queued bulk work
        self.fallbacks = 0  # consumer-side inline fallbacks
        self.wait_stats = StageStats()  # per-lane queue-wait percentiles
        self.flush_rows_last: Dict[str, int] = {}
        # bounded per-flush journal: {"seq", "t" (monotonic, flush start),
        # "wall_s", "rows": {lane: n}, "wait_s": {lane: oldest wait}, "error"}
        self.flush_log: deque = deque(maxlen=4096)
        self._thread = threading.Thread(target=self._run, name="verify-scheduler", daemon=True)
        self._thread.start()
        _install_router()

    # -- budgets / pressure ---------------------------------------------------

    def effective_budget(self, lane: str) -> _Budgets:
        """The lane's budget under the current pressure level: level >= 1
        shrinks admission and catch-up rows by pressure_rows_factor and
        stretches their waits by pressure_wait_factor (votes and light are
        never squeezed); level 2 pauses catch-up (see _plan_locked)."""
        base = self._base[lane]
        if self.pressure_level < 1 or lane in ("votes", "light"):
            return base
        rf = float(getattr(self.config, "pressure_rows_factor", 0.5))
        wf = float(getattr(self.config, "pressure_wait_factor", 2.0))
        return _Budgets(max(1, int(base.max_rows * rf)) if base.max_rows > 0 else 0,
                        base.max_wait * wf)

    def set_pressure(self, level: int) -> None:
        """0 normal, 1 shrink admission and catch-up budgets, 2 also pause
        catch-up."""
        with self._cv:
            if level == self.pressure_level:
                return
            self.pressure_level = int(level)
            self._lanes["catchup"].paused = level >= 2
            self._cv.notify_all()

    def set_lane_wait(self, lane: str, max_wait: float) -> None:
        """Re-pin one lane's coalescing window (light/service.py pins the
        light lane to its coalesce_window)."""
        with self._cv:
            self._base[lane].max_wait = max(0.0, float(max_wait))
            self._cv.notify_all()

    # -- submit side ----------------------------------------------------------

    def submit(self, lane: str, pubkeys: Sequence[bytes], msgs: Sequence[bytes],
               sigs: Sequence[bytes], key_types: Optional[Sequence[str]] = None,
               sources: Optional[Sequence[str]] = None) -> Optional[Ticket]:
        """Queue one consumer's rows on `lane`; returns a Ticket, or None when
        the scheduler is closed (the caller verifies inline then). `sources`
        are the rows' provenance tags; None tags them with the lane at flush
        time."""
        if lane not in self._lanes:
            raise ValueError(f"unknown verify lane {lane!r}")
        n = len(pubkeys)
        if not (n == len(msgs) == len(sigs)):
            raise ValueError("pubkeys/msgs/sigs length mismatch")
        ticket = Ticket(lane, n)
        if n == 0:
            ticket._resolve(np.zeros(0, dtype=bool), None)
            return ticket
        kt = list(key_types) if key_types is not None else None
        src = list(sources) if sources is not None else None
        with self._cv:
            if self._closed:
                return None
            st = self._lanes[lane]
            st.queue.append((ticket, list(pubkeys), list(msgs), list(sigs), kt, src))
            st.rows += n
            if self.metrics is not None:
                self.metrics.lane_depth.labels(lane).set(st.rows)
            self._cv.notify_all()
        return ticket

    def verify_rows(self, lane: str, pubkeys, msgs, sigs, key_types=None,
                    sources=None) -> np.ndarray:
        """Submit and block for the verdict slice: the drop-in for a
        consumer's own verify_batch call. Rows whose source is quarantined
        split off onto the quarantine lane first (the masks merge back in
        row order). The votes lane never queues: its flush runs at once on
        this thread, with the lane's accounting."""
        if lane != "quarantine" and sources is not None:
            from tendermint_tpu_torch.crypto import provenance as _prov

            q = _prov.default_scorer().quarantined_sources()
            if q and any(s in q for s in sources):
                return self._verify_rows_partitioned(lane, pubkeys, msgs, sigs, key_types,
                                                     sources, q)
        if lane == "votes":
            return self._verify_votes_inline(pubkeys, msgs, sigs, key_types, sources)
        ticket = self.submit(lane, pubkeys, msgs, sigs, key_types, sources)
        if ticket is None:
            return self._inline(pubkeys, msgs, sigs, key_types, sources)
        return self._wait_or_fallback(ticket, (pubkeys, msgs, sigs, key_types, sources))

    def _verify_rows_partitioned(self, lane, pubkeys, msgs, sigs, key_types, sources,
                                 quarantined) -> np.ndarray:
        """Suspect rows queue on the quarantine lane first (non-blocking),
        the clean rows flush through their own lane, then this thread waits
        for the quarantine verdict and merges the masks in row order."""
        idx_q = [i for i, s in enumerate(sources) if s in quarantined]
        idx_c = [i for i, s in enumerate(sources) if s not in quarantined]

        def take(seq, idx):
            return [seq[i] for i in idx]

        out = np.zeros(len(pubkeys), dtype=bool)
        q_rows = (take(pubkeys, idx_q), take(msgs, idx_q), take(sigs, idx_q),
                  take(key_types, idx_q) if key_types is not None else None,
                  take(sources, idx_q))
        q_ticket = self.submit("quarantine", *q_rows)
        if idx_c:
            out[idx_c] = self.verify_rows(
                lane, take(pubkeys, idx_c), take(msgs, idx_c), take(sigs, idx_c),
                take(key_types, idx_c) if key_types is not None else None, take(sources, idx_c))
        if q_ticket is None:
            out[idx_q] = self._inline(*q_rows)
        else:
            out[idx_q] = self._wait_or_fallback(q_ticket, q_rows)
        return out

    def _verify_votes_inline(self, pubkeys, msgs, sigs, key_types, sources=None) -> np.ndarray:
        n = len(pubkeys)
        if n == 0:
            return np.zeros(0, dtype=bool)
        t0 = time.monotonic()
        with self._cv:
            if any(self._lanes[name].queue for name in LANES if name != "votes"):
                self.preemptions += 1
                if self.metrics is not None:
                    self.metrics.preemptions.inc()
        mask = self._inline(pubkeys, msgs, sigs, key_types, sources)
        wall = time.monotonic() - t0
        with self._cv:
            self.flush_seq += 1
            st = self._lanes["votes"]
            st.flushes += 1
            st.rows_total += n
            self.flush_rows_last = {"votes": n}
            self.flush_log.append({"seq": self.flush_seq, "t": t0, "wall_s": wall,
                                   "rows": {"votes": n}, "wait_s": {"votes": 0.0},
                                   "error": None})
        self.wait_stats.observe("votes", 0.0)
        if self.metrics is not None:
            self.metrics.lane_wait.labels("votes").observe(0.0)
            self.metrics.lane_flush_rows.labels("votes").observe(n)
        if self.slo is not None:
            self.slo.observe("verify_lane_wait_votes", 0.0)
        return mask

    def _wait_or_fallback(self, ticket: Ticket, rows=None) -> np.ndarray:
        try:
            return ticket.wait(self.wait_timeout)
        except TimeoutError:
            with self._cv:
                # dequeue the abandoned ticket: its consumer verifies inline now
                st = self._lanes[ticket.lane]
                queued = False
                for entry in list(st.queue):
                    if entry[0] is ticket:
                        st.queue.remove(entry)
                        st.rows -= ticket.rows
                        queued = True
                        break
                if queued:
                    self.fallbacks += 1
        if not queued:
            # the dispatch thread already holds the ticket in a running flush:
            # an inline verify would repeat its rows on the same device beside
            # that flush, so wait one more wait_timeout for it to land
            if not ticket.done():
                logger.warning("verify lane %s ticket (%d rows) is in a running flush at the "
                               "%.0fs wait timeout; waiting for that flush", ticket.lane,
                               ticket.rows, self.wait_timeout)
            try:
                return ticket.wait(self.wait_timeout)
            except TimeoutError:
                with self._cv:
                    self.fallbacks += 1
        logger.warning("verify lane %s ticket (%d rows) missed the %.0fs wait timeout; "
                       "verifying inline on the caller's thread", ticket.lane, ticket.rows,
                       self.wait_timeout)
        if rows is None:
            raise TimeoutError(f"verify ticket ({ticket.lane}, {ticket.rows} rows) not flushed "
                               f"within {self.wait_timeout}s")
        return self._inline(*rows)

    def _inline(self, pubkeys, msgs, sigs, key_types, sources=None) -> np.ndarray:
        from tendermint_tpu_torch.crypto import batch as _batch

        if sources is None:
            # the untagged call shape: an untagged flush has nothing to score
            return _batch.verify_batch(pubkeys, msgs, sigs, device=self.device,
                                       key_types=key_types, backend=self.backend)
        return _batch.verify_batch(pubkeys, msgs, sigs, device=self.device, key_types=key_types,
                                   backend=self.backend, sources=sources)

    def accumulate(self, lane: str) -> LaneAccumulator:
        """A FlushAccumulator-compatible adapter whose flush() rides `lane`
        (install with batch.accumulate_flushes(acc))."""
        return LaneAccumulator(self, lane)

    @contextlib.contextmanager
    def lane_scope(self, lane: str):
        """While active on this thread, verify_batch and verify_batch_submit
        (and what is built on them: verify_commit, begin_verify_commit_light*,
        blocksync runs) send their rows through `lane`."""
        if lane not in self._lanes:
            raise ValueError(f"unknown verify lane {lane!r}")
        prev = getattr(_TLS, "scope", None)
        _TLS.scope = (self, lane)
        try:
            yield self
        finally:
            _TLS.scope = prev

    # -- dispatch thread ------------------------------------------------------

    def _plan_locked(self):
        """The next combined flush, decided under the lock: (entries, lanes,
        preempted, timeout_s); no entries means sleep `timeout_s`."""
        now = time.monotonic()
        votes = self._lanes["votes"]
        if votes.queue:
            # the whole votes backlog flushes now, alone
            preempted = any(self._lanes[n].queue for n in LANES if n != "votes")
            entries = list(votes.queue)
            votes.queue.clear()
            votes.rows = 0
            return entries, {"votes"}, preempted, None

        ready: List[str] = []
        next_deadline: Optional[float] = None
        bulk_pending = any(self._lanes[n].queue for n in ("votes", "light", "admission"))
        for lane in ("light", "admission", "catchup"):
            st = self._lanes[lane]
            if not st.queue:
                continue
            eff = self.effective_budget(lane)
            oldest = st.queue[0][0].enqueued_t
            wait = now - oldest
            if lane == "catchup":
                # idle soak; the starvation floor keeps a busy node syncing
                # and bounds the level-2 pause below the consumer's timeout
                floor = eff.max_wait * CATCHUP_STARVATION_FACTOR
                if st.paused:
                    if wait >= floor:
                        ready.append(lane)
                    else:
                        dl = oldest + floor
                        next_deadline = dl if next_deadline is None else min(next_deadline, dl)
                    continue
                if not bulk_pending and (
                        wait >= eff.max_wait or (eff.max_rows > 0 and st.rows >= eff.max_rows)):
                    ready.append(lane)
                elif wait >= floor:
                    ready.append(lane)
                else:
                    dl = oldest + (floor if bulk_pending else eff.max_wait)
                    next_deadline = dl if next_deadline is None else min(next_deadline, dl)
                continue
            if (eff.max_rows > 0 and st.rows >= eff.max_rows) or wait >= eff.max_wait:
                ready.append(lane)
            else:
                dl = oldest + eff.max_wait
                next_deadline = dl if next_deadline is None else min(next_deadline, dl)
        # quarantine: suspect rows flush alone, only when every other lane is
        # drained, with the catch-up starvation floor
        qst = self._lanes["quarantine"]
        if qst.queue:
            eff = self.effective_budget("quarantine")
            oldest = qst.queue[0][0].enqueued_t
            wait = now - oldest
            floor = eff.max_wait * CATCHUP_STARVATION_FACTOR
            others = bulk_pending or bool(self._lanes["catchup"].queue)
            triggered = (not others and not ready) and (
                wait >= eff.max_wait or (eff.max_rows > 0 and qst.rows >= eff.max_rows))
            if triggered or wait >= floor:
                entries = []
                taken_rows = 0
                while qst.queue:
                    if eff.max_rows > 0 and taken_rows >= eff.max_rows:
                        break
                    entry = qst.queue.popleft()
                    qst.rows -= entry[0].rows
                    taken_rows += entry[0].rows
                    entries.append(entry)
                return entries, {"quarantine"}, False, None
            dl = oldest + (floor if (others or ready) else eff.max_wait)
            next_deadline = dl if next_deadline is None else min(next_deadline, dl)
        if not ready:
            timeout = None if next_deadline is None else max(0.0, next_deadline - now)
            return [], set(), False, timeout

        # the trigger lane(s) plus a ride-along drain of the other bulk lanes
        # up to their row budgets; catch-up never rides a flush it did not
        # trigger
        take = set(ready)
        for lane in ("light", "admission"):
            if self._lanes[lane].queue:
                take.add(lane)
        entries = []
        lanes_taken = set()
        for lane in ("light", "admission", "catchup"):
            if lane not in take:
                continue
            st = self._lanes[lane]
            eff = self.effective_budget(lane)
            taken_rows = 0
            while st.queue:
                if eff.max_rows > 0 and taken_rows >= eff.max_rows:
                    break
                entry = st.queue.popleft()
                st.rows -= entry[0].rows
                taken_rows += entry[0].rows
                entries.append(entry)
                lanes_taken.add(lane)
        return entries, lanes_taken, False, None

    def _run(self) -> None:
        while True:
            q_entries: list = []
            with self._cv:
                entries: list = []
                while not self._closed:
                    entries, lanes, preempted, timeout = self._plan_locked()
                    if entries:
                        break
                    self._cv.wait(timeout=timeout)
                if self._closed:
                    # drain what is still queued in one final pass (quarantined
                    # rows still flush on their own)
                    entries = []
                    lanes, preempted = set(), False
                    for lane in LANES:
                        st = self._lanes[lane]
                        if st.queue:
                            if lane == "quarantine":
                                q_entries = list(st.queue)
                            else:
                                lanes.add(lane)
                                entries.extend(st.queue)
                        st.queue.clear()
                        st.rows = 0
                if preempted:
                    self.preemptions += 1
                    if self.metrics is not None:
                        self.metrics.preemptions.inc()
                closed = self._closed
            if entries:
                self._flush(entries, lanes)
            if q_entries:
                self._flush(q_entries, {"quarantine"})
            if closed:
                return

    def _flush(self, entries: list, lanes: set) -> None:
        """One combined flush of `entries` (dispatch thread only), its mask
        sliced back per ticket."""
        t_flush = time.monotonic()
        pubkeys: list = []
        msgs: list = []
        sigs: list = []
        key_types: list = []
        sources: list = []
        slices = []
        lane_rows: Dict[str, int] = {}
        lane_oldest: Dict[str, float] = {}
        for ticket, pk, ms, sg, kt, src in entries:
            start = len(pubkeys)
            pubkeys.extend(pk)
            msgs.extend(ms)
            sigs.extend(sg)
            key_types.extend(kt if kt is not None else ["ed25519"] * len(pk))
            # untagged rows sharing a flush with tagged ones carry their lane
            sources.extend(src if src is not None else [f"lane:{ticket.lane}"] * len(pk))
            slices.append((ticket, start, len(pubkeys)))
            lane_rows[ticket.lane] = lane_rows.get(ticket.lane, 0) + ticket.rows
            prev = lane_oldest.get(ticket.lane)
            if prev is None or ticket.enqueued_t < prev:
                lane_oldest[ticket.lane] = ticket.enqueued_t
        kt_arg = key_types if any(t != "ed25519" for t in key_types) else None
        # an all-untagged flush passes sources=None: nothing to score
        src_arg = sources if any(e[5] is not None for e in entries) else None
        mask: Optional[np.ndarray] = None
        error: Optional[BaseException] = None
        try:
            mask = self._verify_chunked(pubkeys, msgs, sigs, kt_arg, src_arg)
        except BaseException as e:  # the tickets re-raise; the thread survives
            error = e
            logger.exception("scheduler flush failed (%d rows, lanes %s)", len(pubkeys),
                             sorted(lanes))
        wall_s = time.monotonic() - t_flush
        with self._cv:
            self.flush_seq += 1
            seq = self.flush_seq
            self.flush_rows_last = dict(lane_rows)
            self.flush_log.append({
                "seq": seq, "t": t_flush, "wall_s": wall_s, "rows": dict(lane_rows),
                "wait_s": {lane: t_flush - t0 for lane, t0 in lane_oldest.items()},
                "error": repr(error) if error is not None else None,
            })
            for lane in lane_rows:
                st = self._lanes[lane]
                st.flushes += 1
                st.rows_total += lane_rows[lane]
                if self.metrics is not None:
                    self.metrics.lane_depth.labels(lane).set(st.rows)
        for lane, rows in lane_rows.items():
            wait = t_flush - lane_oldest[lane]
            self.wait_stats.observe(lane, wait)
            if self.metrics is not None:
                self.metrics.lane_wait.labels(lane).observe(wait)
                self.metrics.lane_flush_rows.labels(lane).observe(rows)
            if self.slo is not None:
                self.slo.observe(f"verify_lane_wait_{lane}", wait)
        for ticket, start, end in slices:
            ticket.flush_seq = seq
            ticket.wait_s = t_flush - ticket.enqueued_t
            ticket._resolve(mask[start:end] if mask is not None else None, error)

    def _verify_chunked(self, pubkeys, msgs, sigs, kt_arg, sources=None) -> np.ndarray:
        """The dispatch thread's verify body: a combined flush above
        batch.planner_chunk_rows() rows splits into chunks of that many rows,
        each its own verify_batch, with a preemption point between chunks:
        vote rows queued meanwhile flush next, alone. Chunk masks
        concatenate in row order."""
        from tendermint_tpu_torch.crypto import batch as _batch

        def verify(lo, hi):
            kt = kt_arg[lo:hi] if kt_arg is not None else None
            if sources is None:
                return _batch.verify_batch(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi],
                                           device=self.device, key_types=kt,
                                           backend=self.backend)
            return _batch.verify_batch(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi],
                                       device=self.device, key_types=kt, backend=self.backend,
                                       sources=sources[lo:hi])

        chunk = _batch.planner_chunk_rows()
        n = len(pubkeys)
        if n <= chunk:
            return verify(0, n)
        parts = []
        for lo in range(0, n, chunk):
            if lo:
                self._preempt_votes_between_chunks()
            parts.append(verify(lo, min(lo + chunk, n)))
        return np.concatenate(parts)

    def _preempt_votes_between_chunks(self) -> None:
        """Between-chunk preemption point: queued vote rows flush on their
        own before the next bulk chunk."""
        with self._cv:
            st = self._lanes["votes"]
            if not st.queue:
                return
            entries = list(st.queue)
            st.queue.clear()
            st.rows = 0
            self.preemptions += 1
            if self.metrics is not None:
                self.metrics.preemptions.inc()
        self._flush(entries, {"votes"})

    # -- introspection / lifecycle --------------------------------------------

    def stats(self) -> dict:
        """The `scheduler` block of libs/trace.verify_stats()."""
        with self._cv:
            lanes = {}
            for name in LANES:
                st = self._lanes[name]
                eff = self.effective_budget(name)
                base = self._base[name]
                lanes[name] = {
                    "depth_rows": st.rows,
                    "queued_submits": len(st.queue),
                    "flushes": st.flushes,
                    "rows_total": st.rows_total,
                    "paused": st.paused,
                    "budget": {
                        "max_rows": base.max_rows,
                        "max_wait_s": base.max_wait,
                        "effective_max_rows": eff.max_rows,
                        "effective_max_wait_s": eff.max_wait,
                    },
                }
            out = {
                "enabled": True,
                "closed": self._closed,
                "backend": self.backend or "auto",
                "pressure_level": self.pressure_level,
                "flushes": self.flush_seq,
                "preemptions": self.preemptions,
                "inline_fallbacks": self.fallbacks,
                "last_flush_rows": dict(self.flush_rows_last),
                "lanes": lanes,
            }
        out["lane_wait_percentiles"] = self.wait_stats.percentiles()
        from tendermint_tpu_torch.crypto import batch as _batch
        from tendermint_tpu_torch.crypto import provenance as _prov

        out["verified_memo"] = _batch.verified_memo_stats()
        out["mesh_ladder"] = _batch.mesh_ladder_state()
        out["suspicion"] = _prov.default_scorer().stats()
        return out

    def close(self) -> None:
        """Stop the dispatch thread after one final drain; later submits
        return None and consumers verify inline."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)

    @property
    def closed(self) -> bool:
        return self._closed


# -- lane-scope routing (the crypto/batch hook) --------------------------------

_TLS = threading.local()


def _route_rows(pubkeys, msgs, sigs, backend, key_types, sources=None):
    """crypto/batch's lane router: inside a lane_scope on this thread the
    rows go through that lane; None (route normally) outside a scope and
    for a closed scheduler. The scope is cleared around verify_rows, so an
    inline fallback does not re-enter the router."""
    scope = getattr(_TLS, "scope", None)
    if scope is None:
        return None
    sched, lane = scope
    if sched.closed:
        return None
    _TLS.scope = None
    try:
        return sched.verify_rows(lane, pubkeys, msgs, sigs, key_types, sources)
    finally:
        _TLS.scope = scope


_ROUTER_INSTALLED = False


def _install_router() -> None:
    global _ROUTER_INSTALLED
    if _ROUTER_INSTALLED:
        return
    from tendermint_tpu_torch.crypto import batch as _batch

    _batch.set_lane_router(_route_rows)
    _ROUTER_INSTALLED = True


# -- process-global default ----------------------------------------------------
#
# Deep consumers (types/vote_set.py) have no wiring path from a node; they
# read the process-global default, last one installed wins.

_DEFAULT: Optional[VerifyScheduler] = None


def set_default(sched: Optional[VerifyScheduler]) -> None:
    global _DEFAULT
    _DEFAULT = sched


def default_scheduler() -> Optional[VerifyScheduler]:
    """The live process-global scheduler, or None (a closed scheduler reads
    as None)."""
    s = _DEFAULT
    if s is None or s.closed:
        return None
    return s
