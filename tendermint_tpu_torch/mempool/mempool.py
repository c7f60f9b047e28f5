"""Mempool (reference mempool/clist_mempool.go:36): the port's copy of
tendermint_tpu/mempool/mempool.py.

An ordered tx pool: CheckTx on the app's mempool connection, an LRU dedup
cache, ReapMaxBytesMaxGas for proposals, and the post-commit Update with
recheck. Python's dict keeps insertion order, which gives the
concurrent-list order the reference builds from clist; the block executor
holds `lock()` around app Commit and `update`.

Admission control as the reference's: priority eviction (`eviction`, on by
default: a full pool evicts lower- or equal-priority residents, oldest
first), the TTL purge, per-sender quotas for gossiped txs and the
punishment quota, the mempool WAL, the tx tracker and the metrics.

The admission lane: with `sig_precheck` on, signed-tx envelopes
(types/signed_tx.py) are verified in batches on the scheduler's
`admission` lane (crypto/scheduler.py, then crypto/batch.verify_batch: the
card from 256 rows) before the mempool lock, and each verdict rides
RequestCheckTx.sig_precheck to the app. Unlike the reference, a failed
lane flush is not caught and degraded to the app's serial verify: it
raises to the check_tx / check_tx_batch / update caller (ROADMAP D1).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import ABCIClient
from tendermint_tpu_torch.crypto import tmhash


class MempoolError(Exception):
    """Base admission-control rejection. `reason` is machine-readable so the
    RPC layer can return a structured JSON-RPC error instead of a bare
    traceback (full / cache / quota / too_large)."""

    reason = "rejected"


class MempoolFullError(MempoolError):
    reason = "full"

    def __init__(self, detail: str = ""):
        super().__init__(
            "mempool is full" + (f" ({detail})" if detail else "")
        )


class TxInCacheError(MempoolError):
    reason = "cache"

    def __init__(self):
        super().__init__("tx already exists in cache")


class SenderQuotaError(MempoolError):
    reason = "quota"

    def __init__(self, sender: str, quota: int):
        super().__init__(
            f"sender {sender[:10]} exceeds in-flight quota ({quota})"
        )


class TxTooLargeError(MempoolError):
    reason = "too_large"

    def __init__(self, size: int, max_size: int):
        super().__init__(f"tx too large ({size} > {max_size})")


@dataclass
class MempoolTx:
    tx: bytes
    height: int  # height when validated
    gas_wanted: int
    senders: frozenset = frozenset()  # peer IDs that sent us this tx
    priority: int = 0  # app-assigned (ResponseCheckTx.priority); evict lowest first
    time_ns: int = 0  # admission wall time (TTL + oldest-first eviction)
    sender0: str = ""  # the admitting sender, charged against the quota


def iter_mempool_wal(path: str):
    """Yield txs from a mempool WAL (4-byte BE length + tx records),
    stopping at the first torn/truncated record — the clean-prefix
    semantics the consensus WAL's CRC framing gives, minus the CRC (the
    mempool log is forensic, not safety-critical)."""
    if not path:
        return
    try:
        f = open(path, "rb")
    except OSError:
        return
    with f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return
            ln = int.from_bytes(hdr, "big")
            tx = f.read(ln)
            if len(tx) < ln:
                return  # torn tail
            yield tx


class Mempool:
    """(reference: mempool/mempool.go:15 interface + clist_mempool impl)"""

    def __init__(
        self,
        proxy_app: ABCIClient,
        max_txs: int = 5000,
        max_txs_bytes: int = 1024 * 1024 * 1024,
        cache_size: int = 10000,
        keep_invalid_txs_in_cache: bool = False,
        recheck: bool = True,
        metrics=None,
        wal_path: str = "",
        max_tx_bytes: int = 1_048_576,
        ttl_num_blocks: int = 0,
        ttl_seconds: float = 0.0,
        eviction: bool = True,
        max_txs_per_sender: int = 0,
        tx_tracker=None,
        scheduler=None,
        sig_precheck: bool = False,
    ):
        self.metrics = metrics
        # tx lifecycle tracker (libs/txtrace.py): admission is where a tx's
        # journey forks — admitted, rejected{reason}, evicted, or expired.
        # Every hook below is gated on tracker.enabled (the tracer flag).
        self.tx_tracker = tx_tracker
        # device-batched tx admission (crypto/scheduler.py, ISSUE 11): with
        # sig_precheck on, signed-tx envelopes (types/signed_tx.py) are
        # batch-verified through the scheduler's ADMISSION lane BEFORE the
        # mempool lock, and the verdict rides RequestCheckTx.sig_precheck so
        # the app consumes it instead of paying a serial per-tx verify. A
        # flood of concurrent check_tx callers (RPC executor threads, the
        # gossip reactor's batches) coalesces into shared device flushes.
        self.scheduler = scheduler
        self.sig_precheck = bool(sig_precheck) and scheduler is not None
        self.prechecked_total = 0  # envelopes verified through the lane
        self._wal = None
        if wal_path:
            self.init_wal(wal_path)
        self.proxy_app = proxy_app
        self.max_txs = max_txs
        self.max_txs_bytes = max_txs_bytes
        self.max_tx_bytes = max_tx_bytes
        self.recheck = recheck
        self.keep_invalid_txs_in_cache = keep_invalid_txs_in_cache
        # admission control ([mempool] ttl_*/eviction/max_txs_per_sender)
        self.ttl_num_blocks = ttl_num_blocks
        self.ttl_seconds = ttl_seconds
        self.eviction = eviction
        self.max_txs_per_sender = max_txs_per_sender
        self._txs: "OrderedDict[bytes, MempoolTx]" = OrderedDict()  # key: tx hash
        self._cache: "OrderedDict[bytes, None]" = OrderedDict()
        self._cache_size = cache_size
        self._total_bytes = 0
        self._height = 0
        self._lock = threading.RLock()
        self._txs_available_cb: Optional[Callable[[], None]] = None
        self._notified_txs_available = False
        self._sender_counts: Dict[str, int] = {}  # admitting sender -> in-flight txs
        # senders punished for signature poisoning (crypto/provenance.py punish
        # callbacks, wired through node.py): their per-sender quota collapses
        # to PENALIZED_SENDER_QUOTA regardless of max_txs_per_sender
        self._penalized_senders: set = set()
        self.evicted_total = 0
        self.expired_total = 0

    # -- locking around commit (reference: Lock/Unlock in Mempool iface) ----

    def lock(self) -> None:
        self._lock.acquire()

    def unlock(self) -> None:
        self._lock.release()

    # -- size ---------------------------------------------------------------

    def size(self) -> int:
        return len(self._txs)

    def txs_bytes(self) -> int:
        return self._total_bytes

    def is_full(self, tx_len: int) -> bool:
        return len(self._txs) >= self.max_txs or self._total_bytes + tx_len > self.max_txs_bytes

    WAL_MAX_BYTES = 64 * 1024 * 1024  # rotate beyond this (autofile-group role)

    def init_wal(self, path: str) -> None:
        """Append-only tx log for crash forensics (reference:
        mempool/clist_mempool.go InitWAL over libs/autofile; records are
        4-byte big-endian length + tx bytes; one .old generation is kept,
        standing in for the reference's rotating autofile group)."""
        import os as _os

        _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
        self._wal_path = path
        self._wal = open(path, "ab")

    def close_wal(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    def _wal_write(self, tx: bytes) -> None:
        # caller holds self._lock
        if self._wal is None:
            return
        self._wal.write(len(tx).to_bytes(4, "big") + tx)
        self._wal.flush()
        if self._wal.tell() > self.WAL_MAX_BYTES:
            import os as _os

            self._wal.close()
            _os.replace(self._wal_path, self._wal_path + ".old")
            self._wal = open(self._wal_path, "ab")

    def replay_wal(self, path: str = "") -> int:
        """Re-admit the WAL's surviving txs through check_tx (crash
        forensics/recovery; the reference leaves replay to operators — here
        it is a method so tests can pin that an EVICTED tx's WAL record
        still replays cleanly: eviction un-caches, so replay re-admits).
        Returns the number of txs accepted back into the pool."""
        accepted = 0
        # suspend the live WAL while replaying: check_tx would otherwise
        # append every re-admitted tx onto the very file being iterated
        # (doubling it per replay cycle)
        with self._lock:
            wal, self._wal = self._wal, None
        try:
            for tx in iter_mempool_wal(path or getattr(self, "_wal_path", "")):
                try:
                    res = self.check_tx(tx)
                except MempoolError:
                    continue
                if res is not None and res.code == abci.CODE_TYPE_OK:
                    accepted += 1
        finally:
            with self._lock:
                self._wal = wal
        return accepted

    def flush(self) -> None:
        with self._lock:
            self._txs.clear()
            self._cache.clear()
            self._sender_counts.clear()
            self._total_bytes = 0
            # allow the next admitted tx to re-notify consensus — without this
            # a flush between notify and commit stalls proposal creation when
            # create_empty_blocks is off
            self._notified_txs_available = False

    # -- notifications ------------------------------------------------------

    def set_txs_available_callback(self, cb: Callable[[], None]) -> None:
        self._txs_available_cb = cb

    def _notify_txs_available(self) -> None:
        if self._txs_available_cb and not self._notified_txs_available and self._txs:
            self._notified_txs_available = True
            self._txs_available_cb()

    # -- CheckTx ingress ----------------------------------------------------

    def _cache_push(self, key: bytes) -> bool:
        if key in self._cache:
            return False
        self._cache[key] = None
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return True

    def _tt(self):
        """The lifecycle tracker iff recording is on — one attribute read +
        one flag check when disabled (the hotstats contract)."""
        tt = self.tx_tracker
        if tt is None or not tt.enabled:
            return None
        return tt

    def _reject(self, exc: MempoolError, sender: str, key: bytes = b""):
        """Reject a tx at admission: gossiped txs (sender set) drop silently
        (the reference updates sender lists and moves on), locally submitted
        txs raise so the RPC layer can report the structured reason."""
        if self.metrics is not None:
            self.metrics.rejected_txs.labels(exc.reason).inc()
        tt = self._tt()
        if tt is not None and key:
            tt.record(key, "rejected", reason=exc.reason)
        if sender:
            return None
        raise exc

    def _sig_precheck_batch(
        self, txs: List[bytes], keys: Optional[List[bytes]] = None,
        skip_cache_peek: bool = False, sender: str = "",
    ) -> List[int]:
        """Batch-verify the signed-tx envelopes among `txs` through the
        scheduler's admission lane; returns one abci.SIG_PRECHECK_* verdict
        per tx. Runs OUTSIDE the mempool lock — concurrent callers block on
        the lane, not on each other, and their rows share device flushes.

        Skipped rows (verdict NONE, the app verifies itself): non-envelope
        txs, oversized txs (rejected before the app anyway), and txs whose
        hash is already cached (an unlocked peek — a duplicate must not pay
        a device verify; the peek is advisory, a stale answer only costs or
        saves the one verify, never correctness)."""
        from tendermint_tpu_torch.types.signed_tx import decode_signed_tx

        verdicts = [abci.SIG_PRECHECK_NONE] * len(txs)
        if not self.sig_precheck:
            return verdicts
        rows: List[tuple] = []
        idxs: List[int] = []
        for i, tx in enumerate(txs):
            if len(tx) > self.max_tx_bytes:
                continue
            env = decode_signed_tx(tx)
            if env is None:
                continue
            if not skip_cache_peek:
                # advisory duplicate peek; the caller hands us the hash it
                # already computed (ONE sum256 per tx on the whole path)
                key = keys[i] if keys is not None else tmhash.sum256(tx)
                if key in self._cache:
                    continue
            rows.append(env)
            idxs.append(i)
        if not rows:
            return verdicts
        # provenance (crypto/provenance.py): gossiped rows carry their sender
        # so the suspicion scorer can quarantine and punish a poisoning peer;
        # local RPC submissions stay lane-tagged. A failed flush raises here
        # (no degrade to the app's serial verify, ROADMAP D1).
        sources = [f"sender:{sender}"] * len(rows) if sender else None
        mask = self.scheduler.verify_rows(
            "admission",
            [e.pubkey for e in rows],
            [e.sign_bytes for e in rows],
            [e.signature for e in rows],
            sources=sources,
        )
        self.prechecked_total += len(rows)
        for i, ok in zip(idxs, mask):
            verdicts[i] = abci.SIG_PRECHECK_OK if ok else abci.SIG_PRECHECK_BAD
        return verdicts

    PENALIZED_SENDER_QUOTA = 2  # in-flight txs allowed from a punished poisoner

    def penalize_sender(self, sender: str) -> None:
        """Punishment hook for signature poisoning (crypto/provenance.py
        punish callbacks, wired through node.py): collapse the sender's
        per-sender quota to PENALIZED_SENDER_QUOTA. Idempotent; survives
        flush() so a poisoner cannot launder its record through a commit."""
        if not sender:
            return
        with self._lock:
            self._penalized_senders.add(sender)

    def penalized_senders(self) -> frozenset:
        with self._lock:
            return frozenset(self._penalized_senders)

    def check_tx(self, tx: bytes, sender: str = "") -> Optional[abci.ResponseCheckTx]:
        """(reference: mempool/clist_mempool.go:234 CheckTx + resCbFirstTime :404)

        sender: peer ID for gossiped txs (recorded so the reactor does not
        echo the tx back, reference: mempool/reactor.go:41-96). A tx already
        in the cache from a peer returns None instead of raising (the
        reference updates the sender list and drops it silently)."""
        sig_verdict = abci.SIG_PRECHECK_NONE
        key = b""
        if self.sig_precheck:
            key = tmhash.sum256(tx)
            sig_verdict = self._sig_precheck_batch([tx], keys=[key], sender=sender)[0]
        return self._check_tx_admit(tx, sender, sig_verdict, key)

    def check_tx_batch(
        self, txs: List[bytes], sender: str = ""
    ) -> List[Optional[abci.ResponseCheckTx]]:
        """Admit a gossiped batch: ONE admission-lane submit covers every
        envelope's signature (the reactor's per-message path), then each tx
        takes the normal locked admission. Rejections of gossiped txs are
        silent per-tx (the reference's sender-list-and-move-on), so one bad
        tx never drops its batchmates."""
        keys: List[bytes] = []
        if self.sig_precheck:
            keys = [tmhash.sum256(tx) for tx in txs]
        verdicts = self._sig_precheck_batch(txs, keys=keys or None, sender=sender)
        out: List[Optional[abci.ResponseCheckTx]] = []
        for i, (tx, v) in enumerate(zip(txs, verdicts)):
            try:
                out.append(self._check_tx_admit(
                    tx, sender, v, keys[i] if keys else b""
                ))
            except MempoolError:
                if not sender:
                    raise
                out.append(None)
            except Exception:
                # a transient app/ABCI failure on ONE gossiped tx must not
                # drop its batchmates (local submissions still raise — the
                # RPC caller needs the error); the lane has run by now, so
                # no device error reaches this catch
                if not sender:
                    raise
                import logging

                logging.getLogger("tendermint_tpu_torch.mempool").exception(
                    "gossiped tx failed CheckTx; continuing with the batch"
                )
                out.append(None)
        return out

    def _check_tx_admit(
        self, tx: bytes, sender: str, sig_verdict: int, key: bytes = b""
    ) -> Optional[abci.ResponseCheckTx]:
        with self._lock:
            tt = self._tt()
            # hash EARLY only when the tracker is live (the journey needs its
            # key before the early rejects) or the precheck path already
            # computed it (passed in — never a second SHA-256 under the
            # lock); otherwise the hot path hashes at the cache point
            # exactly as before — a flood of oversized/over-quota txs costs
            # no SHA-256 under the lock
            if not key and tt is not None:
                key = tmhash.sum256(tx)
            if tt is not None:
                # journey ingress: dedupe inside the tracker (an RPC hook may
                # have stamped it already; a re-gossip of a live journey is
                # not a second receipt)
                tt.record(key, "received", via="gossip" if sender else "rpc")
            if len(tx) > self.max_tx_bytes:
                return self._reject(TxTooLargeError(len(tx), self.max_tx_bytes), sender, key)
            if sender and sender in self._penalized_senders:
                # punished poisoner: quota collapses even when the operator
                # configured unlimited per-sender admission
                if self._sender_counts.get(sender, 0) >= self.PENALIZED_SENDER_QUOTA:
                    return self._reject(
                        SenderQuotaError(sender, self.PENALIZED_SENDER_QUOTA), sender, key
                    )
            if (
                sender
                and self.max_txs_per_sender > 0
                and self._sender_counts.get(sender, 0) >= self.max_txs_per_sender
            ):
                return self._reject(SenderQuotaError(sender, self.max_txs_per_sender), sender, key)
            if self.is_full(len(tx)) and not self.eviction:
                return self._reject(MempoolFullError(), sender, key)
            if not key:
                key = tmhash.sum256(tx)
            if not self._cache_push(key):
                mtx = self._txs.get(key)
                if mtx is not None:
                    if sender:
                        mtx.senders = mtx.senders | {sender}
                        return None
                    # duplicate local submission of a RESIDENT tx: refuse
                    # the submission but never terminal the live journey —
                    # the tx is still on its way to a block, and tx_status
                    # must keep saying so (key=b"" skips the record)
                    return self._reject(TxInCacheError(), sender, b"")
                return self._reject(TxInCacheError(), sender, key)
            res = self.proxy_app.check_tx(abci.RequestCheckTx(
                tx=tx, type=abci.CHECK_TX_TYPE_NEW, sig_precheck=sig_verdict
            ))
            if tt is not None:
                tt.record(key, "checked", code=res.code, priority=res.priority)
            if res.code == abci.CODE_TYPE_OK:
                # evict only for a genuinely NEW arrival: a duplicate of a
                # resident tx whose hash churned out of the dedup cache must
                # not destroy lower-priority residents to insert nothing
                if key not in self._txs:
                    if self.is_full(len(tx)) and not self._evict_for(len(tx), res.priority):
                        # could not free room below the incoming tx's
                        # priority: drop the NEW tx, and un-cache it so it
                        # may re-enter once the pool drains
                        self._cache.pop(key, None)
                        return self._reject(
                            MempoolFullError("no evictable lower-priority txs"), sender, key
                        )
                    self._txs[key] = MempoolTx(
                        tx=tx, height=self._height, gas_wanted=res.gas_wanted,
                        senders=frozenset({sender}) if sender else frozenset(),
                        priority=res.priority, time_ns=time.time_ns(),
                        sender0=sender,
                    )
                    if sender:
                        self._sender_counts[sender] = self._sender_counts.get(sender, 0) + 1
                    self._total_bytes += len(tx)
                    self._wal_write(tx)
                    if tt is not None:
                        tt.record(key, "admitted", priority=res.priority)
                    self._notify_txs_available()
            else:
                if not self.keep_invalid_txs_in_cache:
                    self._cache.pop(key, None)
                if self.metrics is not None:
                    self.metrics.failed_txs.inc()
                if tt is not None:
                    tt.record(key, "rejected", reason="checktx", code=res.code)
            self._update_size_metrics(len(tx))
            return res

    def _update_size_metrics(self, tx_len: Optional[int] = None) -> None:
        if self.metrics is None:
            return
        self.metrics.size.set(len(self._txs))
        self.metrics.size_bytes.set(self._total_bytes)
        self.metrics.full.set(1 if self.is_full(0) else 0)
        if tx_len is not None:
            self.metrics.tx_size_bytes.observe(tx_len)

    def _remove_tx(self, key: bytes, *, drop_cache: bool) -> Optional[MempoolTx]:
        """Remove a resident tx, keeping byte totals and sender quotas
        consistent. drop_cache also forgets the hash so the tx may be
        resubmitted later (evicted/expired txs must not be poisoned)."""
        mtx = self._txs.pop(key, None)
        if mtx is None:
            return None
        self._total_bytes -= len(mtx.tx)
        if mtx.sender0:
            n = self._sender_counts.get(mtx.sender0, 0) - 1
            if n > 0:
                self._sender_counts[mtx.sender0] = n
            else:
                self._sender_counts.pop(mtx.sender0, None)
        if drop_cache:
            self._cache.pop(key, None)
        return mtx

    def _evict_for(self, tx_len: int, priority: int) -> bool:
        """Make room for an incoming (tx_len, priority) by evicting resident
        txs in (priority asc, admission order) — lowest-priority first,
        oldest first among equals; a resident tx with HIGHER priority than
        the arrival is never evicted for it (reference: the v1 priority
        mempool's CheckTx eviction). Returns False (state untouched) when
        the arrival cannot fit within that constraint."""
        victims = []
        freed_bytes = 0
        freed_slots = 0
        need_slots = len(self._txs) + 1 - self.max_txs
        need_bytes = self._total_bytes + tx_len - self.max_txs_bytes
        # stable sort over insertion order: equal priorities evict oldest
        for key, mtx in sorted(self._txs.items(), key=lambda kv: kv[1].priority):
            if freed_slots >= need_slots and freed_bytes >= need_bytes:
                break
            if mtx.priority > priority:
                return False  # only higher-priority txs left standing
            victims.append(key)
            freed_bytes += len(mtx.tx)
            freed_slots += 1
        if freed_slots < need_slots or freed_bytes < need_bytes:
            return False
        tt = self._tt()
        for key in victims:
            mtx = self._remove_tx(key, drop_cache=True)
            self.evicted_total += 1
            if self.metrics is not None:
                self.metrics.evicted_txs.inc()
            if tt is not None and mtx is not None:
                tt.record(key, "evicted", priority=mtx.priority)
        return True

    def entries(self) -> List[tuple]:
        """Snapshot [(key, tx, senders)] in insertion order (gossip walk)."""
        with self._lock:
            return [(k, m.tx, m.senders) for k, m in self._txs.items()]

    # -- proposals ----------------------------------------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """(reference: mempool/clist_mempool.go:519)"""
        with self._lock:
            out: List[bytes] = []
            total_bytes = 0
            total_gas = 0
            for mtx in self._txs.values():
                # amino/proto overhead per tx in a block: length prefix
                overhead = len(mtx.tx) + 8
                if max_bytes > -1 and total_bytes + overhead > max_bytes:
                    break
                if max_gas > -1 and total_gas + mtx.gas_wanted > max_gas:
                    break
                total_bytes += overhead
                total_gas += mtx.gas_wanted
                out.append(mtx.tx)
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._lock:
            txs = [m.tx for m in self._txs.values()]
            return txs if n < 0 else txs[:n]

    # -- post-commit update -------------------------------------------------

    def update(
        self,
        height: int,
        txs: List[bytes],
        deliver_tx_responses: List[abci.ResponseDeliverTx],
    ) -> None:
        """Remove committed txs, re-check the remainder
        (reference: mempool/clist_mempool.go:570 Update + recheckTxs :632).
        Caller must hold the mempool lock."""
        self._height = height
        self._notified_txs_available = False
        for tx, res in zip(txs, deliver_tx_responses):
            key = tmhash.sum256(tx)
            if res.code == abci.CODE_TYPE_OK:
                self._cache_push(key)  # committed: keep in cache to block replays
            else:
                if not self.keep_invalid_txs_in_cache:
                    self._cache.pop(key, None)
            self._remove_tx(key, drop_cache=False)
        self._purge_expired()
        if self.recheck and self._txs:
            if self.metrics is not None:
                self.metrics.recheck_times.inc()
            self._recheck_txs()
        self._update_size_metrics()
        if self._txs:
            self._notify_txs_available()

    def _purge_expired(self) -> None:
        """TTL purge (reference: v0.35 mempool TTLNumBlocks/TTLDuration):
        drop txs admitted more than ttl_num_blocks blocks ago or older than
        ttl_seconds, un-caching them so a later resubmission is accepted.
        Caller holds the lock; runs on every post-commit update."""
        if self.ttl_num_blocks <= 0 and self.ttl_seconds <= 0:
            return
        now_ns = time.time_ns()
        expired = [
            key
            for key, mtx in self._txs.items()
            if (
                self.ttl_num_blocks > 0
                and self._height - mtx.height >= self.ttl_num_blocks
            )
            or (
                self.ttl_seconds > 0
                and now_ns - mtx.time_ns >= self.ttl_seconds * 1e9
            )
        ]
        tt = self._tt()
        for key in expired:
            self._remove_tx(key, drop_cache=True)
            self.expired_total += 1
            if self.metrics is not None:
                self.metrics.expired_txs.inc()
            if tt is not None:
                tt.record(key, "expired", height=self._height)

    def _recheck_txs(self) -> None:
        tt = self._tt()
        keys = list(self._txs.keys())
        # post-commit recheck is admission-shaped: with the scheduler wired,
        # every resident envelope's signature re-verifies in ONE admission-
        # lane batch (residents are cached by definition, so the duplicate
        # peek is skipped) instead of a serial app-side verify per tx per
        # block — the recheck loop was the last serial verify loop standing
        verdicts = [abci.SIG_PRECHECK_NONE] * len(keys)
        if self.sig_precheck and keys:
            verdicts = self._sig_precheck_batch(
                [self._txs[k].tx for k in keys], skip_cache_peek=True
            )
        for key, verdict in zip(keys, verdicts):
            mtx = self._txs.get(key)
            if mtx is None:
                continue
            res = self.proxy_app.check_tx(
                abci.RequestCheckTx(
                    tx=mtx.tx, type=abci.CHECK_TX_TYPE_RECHECK,
                    sig_precheck=verdict,
                )
            )
            if res.code != abci.CODE_TYPE_OK:
                self._remove_tx(
                    key, drop_cache=not self.keep_invalid_txs_in_cache
                )
                # the journey must not read "admitted" forever after the
                # node silently dropped the tx on a failed recheck
                if tt is not None:
                    tt.record(key, "rejected", reason="recheck", code=res.code)
