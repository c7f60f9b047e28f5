"""Mempool (reference mempool/clist_mempool.go:36): the port's copy of the
core of tendermint_tpu/mempool/mempool.py.

An ordered tx pool: CheckTx on the app's mempool connection, an LRU dedup
cache, the count and bytes limits, ReapMaxBytesMaxGas for proposals, and the
post-commit Update with recheck. Python's dict keeps insertion order, which
gives the concurrent-list order the reference builds from clist; the block
executor holds `lock()` around app Commit and `update`.

Waiting for the node (ROADMAP A10): the admission lane (signed-tx
signature prechecks on the scheduler), the mempool WAL, the TTL purge,
priority eviction (a full pool refuses every new tx, as the reference does
with `eviction` off), per-sender quotas, the tx tracker and the metrics.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import ABCIClient
from tendermint_tpu_torch.crypto import tmhash


class MempoolError(Exception):
    """Base admission rejection. `reason` is machine-readable (full / cache
    / too_large)."""

    reason = "rejected"


class MempoolFullError(MempoolError):
    reason = "full"

    def __init__(self, detail: str = ""):
        super().__init__("mempool is full" + (f" ({detail})" if detail else ""))


class TxInCacheError(MempoolError):
    reason = "cache"

    def __init__(self):
        super().__init__("tx already exists in cache")


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
    priority: int = 0  # app-assigned (ResponseCheckTx.priority)


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
        max_tx_bytes: int = 1_048_576,
    ):
        self.proxy_app = proxy_app
        self.max_txs = max_txs
        self.max_txs_bytes = max_txs_bytes
        self.max_tx_bytes = max_tx_bytes
        self.recheck = recheck
        self.keep_invalid_txs_in_cache = keep_invalid_txs_in_cache
        self._txs: "OrderedDict[bytes, MempoolTx]" = OrderedDict()  # key: tx hash
        self._cache: "OrderedDict[bytes, None]" = OrderedDict()
        self._cache_size = cache_size
        self._total_bytes = 0
        self._height = 0
        self._lock = threading.RLock()
        self._txs_available_cb: Optional[Callable[[], None]] = None
        self._notified_txs_available = False

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

    def flush(self) -> None:
        with self._lock:
            self._txs.clear()
            self._cache.clear()
            self._total_bytes = 0
            # the next admitted tx may notify consensus again: without this a
            # flush between notify and commit stalls proposal creation when
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

    @staticmethod
    def _reject(exc: MempoolError, sender: str):
        """Gossiped txs (sender set) drop silently, as the reference updates
        sender lists and moves on; a local submission raises the structured
        reason."""
        if sender:
            return None
        raise exc

    def check_tx(self, tx: bytes, sender: str = "") -> Optional[abci.ResponseCheckTx]:
        """(reference: mempool/clist_mempool.go:234 CheckTx + resCbFirstTime :404)

        sender: the peer a gossiped tx came from (kept so the tx is not
        echoed back, reference mempool/reactor.go:41-96). A tx already in the
        cache from a peer returns None instead of raising."""
        with self._lock:
            if len(tx) > self.max_tx_bytes:
                return self._reject(TxTooLargeError(len(tx), self.max_tx_bytes), sender)
            if self.is_full(len(tx)):
                return self._reject(MempoolFullError(), sender)
            key = tmhash.sum256(tx)
            if not self._cache_push(key):
                mtx = self._txs.get(key)
                if mtx is not None and sender:
                    mtx.senders = mtx.senders | {sender}
                    return None
                return self._reject(TxInCacheError(), sender)
            res = self.proxy_app.check_tx(abci.RequestCheckTx(tx=tx, type=abci.CHECK_TX_TYPE_NEW))
            if res.code == abci.CODE_TYPE_OK:
                if key not in self._txs:
                    self._txs[key] = MempoolTx(
                        tx=tx, height=self._height, gas_wanted=res.gas_wanted,
                        senders=frozenset({sender}) if sender else frozenset(),
                        priority=res.priority,
                    )
                    self._total_bytes += len(tx)
                    self._notify_txs_available()
            elif not self.keep_invalid_txs_in_cache:
                self._cache.pop(key, None)
            return res

    def _remove_tx(self, key: bytes, *, drop_cache: bool) -> Optional[MempoolTx]:
        """Remove a resident tx and its bytes; drop_cache also forgets its
        hash, so it may be submitted again."""
        mtx = self._txs.pop(key, None)
        if mtx is None:
            return None
        self._total_bytes -= len(mtx.tx)
        if drop_cache:
            self._cache.pop(key, None)
        return mtx

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
            elif not self.keep_invalid_txs_in_cache:
                self._cache.pop(key, None)
            self._remove_tx(key, drop_cache=False)
        if self.recheck and self._txs:
            self._recheck_txs()
        if self._txs:
            self._notify_txs_available()

    def _recheck_txs(self) -> None:
        for key in list(self._txs.keys()):
            mtx = self._txs.get(key)
            if mtx is None:
                continue
            res = self.proxy_app.check_tx(
                abci.RequestCheckTx(tx=mtx.tx, type=abci.CHECK_TX_TYPE_RECHECK))
            if res.code != abci.CODE_TYPE_OK:
                self._remove_tx(key, drop_cache=not self.keep_invalid_txs_in_cache)
