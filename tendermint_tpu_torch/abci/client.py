"""ABCI clients (reference abci/client/client.go:22): the port's copy of
the interface and of `LocalClient` from tendermint_tpu/abci/client.py.

LocalClient calls an in-process Application directly, every connection under
one lock (reference abci/client/local_client.go:15). The socket and gRPC
clients live in abci/socket.py and abci/grpc.py.

ReconnectingClient wraps the NON-consensus connections (mempool, query,
snapshot) of a remote app: on a broken pipe, a dead socket or a per-call
timeout it rebuilds the inner client with exponential backoff and retries,
so an app restart costs a few retries instead of the node. The consensus
connection is never wrapped: its failure stays fatal, as in the reference
(proxy/multi_app_conn.go kills the node when the consensus client dies).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from tendermint_tpu_torch.abci import types as abci

logger = logging.getLogger("tendermint_tpu_torch.abci")


class ABCIClient:
    """Synchronous 17-method client interface. Async pipelining is layered on
    top by callers that need it (the executor batches DeliverTx itself)."""

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def set_option(self, req: abci.RequestSetOption) -> abci.ResponseSetOption:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    def list_snapshots(self) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError

    def echo(self, msg: str) -> str:
        return msg

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class ReconnectingClient(ABCIClient):
    """Delegates every ABCI method to a lazily (re)created inner client;
    transport failures tear the inner client down and retry on a fresh one
    with exponential backoff ([base] abci_reconnect_*). Only transport
    errors are retried — an app-level exception response passes through."""

    # ConnectionError, BrokenPipeError and TimeoutError (the socket client's
    # per-call timeout, concurrent.futures' too on Python >= 3.11) are OSErrors
    RETRIABLE = (OSError,)

    def __init__(
        self,
        creator: Callable[[], "ABCIClient"],
        attempts: int = 5,
        base_delay: float = 0.2,
        max_delay: float = 5.0,
        name: str = "abci",
    ):
        self._creator = creator
        self.attempts = attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.name = name
        self.reconnects = 0  # successful inner-client rebuilds after a failure
        self._client: Optional[ABCIClient] = None
        self._had_failure = False
        self._lock = threading.Lock()

    def _get(self) -> ABCIClient:
        with self._lock:
            c = self._client
            if c is not None and not getattr(c, "is_dead", lambda: False)():
                return c
            if c is not None:
                self._had_failure = True
                try:
                    c.close()
                except Exception:
                    pass
            self._client = self._creator()
            if self._had_failure:
                self.reconnects += 1
                self._had_failure = False
            return self._client

    def _drop(self, client: ABCIClient) -> None:
        with self._lock:
            self._had_failure = True
            if self._client is client:
                self._client = None
        try:
            client.close()
        except Exception:
            pass

    def _call(self, method: str, *args):
        last: Optional[Exception] = None
        for attempt in range(self.attempts + 1):
            if attempt > 0:
                delay = min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)
                logger.warning(
                    "ABCI %s conn %s failed (%s); reconnect attempt %d in %.2fs",
                    self.name, method, last, attempt, delay,
                )
                time.sleep(delay)
            try:
                client = self._get()
            except self.RETRIABLE as e:  # app still down: keep backing off
                last = e
                continue
            try:
                return getattr(client, method)(*args)
            except self.RETRIABLE as e:
                last = e
                self._drop(client)
        raise ConnectionError(
            f"ABCI {self.name} connection failed after "
            f"{self.attempts + 1} attempts: {last}"
        )

    def close(self) -> None:
        with self._lock:
            c, self._client = self._client, None
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    def flush(self) -> None:
        with self._lock:
            c = self._client
        if c is not None:
            try:
                c.flush()
            except self.RETRIABLE:
                self._drop(c)

    def info(self, req):
        return self._call("info", req)

    def set_option(self, req):
        return self._call("set_option", req)

    def query(self, req):
        return self._call("query", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def init_chain(self, req):
        return self._call("init_chain", req)

    def begin_block(self, req):
        return self._call("begin_block", req)

    def deliver_tx(self, req):
        return self._call("deliver_tx", req)

    def end_block(self, req):
        return self._call("end_block", req)

    def commit(self):
        return self._call("commit")

    def list_snapshots(self):
        return self._call("list_snapshots")

    def offer_snapshot(self, req):
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self._call("apply_snapshot_chunk", req)


class LocalClient(ABCIClient):
    """Direct calls to an in-process Application under a shared mutex —
    mirrors the reference's local_client semantics where all connections to
    one app serialize on one lock (reference: abci/client/local_client.go:23)."""

    def __init__(self, app: abci.Application, lock: Optional[threading.RLock] = None):
        self.app = app
        self.lock = lock or threading.RLock()

    def info(self, req):
        with self.lock:
            return self.app.info(req)

    def set_option(self, req):
        with self.lock:
            return self.app.set_option(req)

    def query(self, req):
        with self.lock:
            return self.app.query(req)

    def check_tx(self, req):
        with self.lock:
            return self.app.check_tx(req)

    def init_chain(self, req):
        with self.lock:
            return self.app.init_chain(req)

    def begin_block(self, req):
        with self.lock:
            return self.app.begin_block(req)

    def deliver_tx(self, req):
        with self.lock:
            return self.app.deliver_tx(req)

    def end_block(self, req):
        with self.lock:
            return self.app.end_block(req)

    def commit(self):
        with self.lock:
            return self.app.commit()

    def list_snapshots(self):
        with self.lock:
            return self.app.list_snapshots()

    def offer_snapshot(self, req):
        with self.lock:
            return self.app.offer_snapshot(req)

    def load_snapshot_chunk(self, req):
        with self.lock:
            return self.app.load_snapshot_chunk(req)

    def apply_snapshot_chunk(self, req):
        with self.lock:
            return self.app.apply_snapshot_chunk(req)
