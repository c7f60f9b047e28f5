"""ABCI clients (reference abci/client/client.go:22): the port's copy of
the interface and of `LocalClient` from tendermint_tpu/abci/client.py.

LocalClient calls an in-process Application directly, every connection under
one lock (reference abci/client/local_client.go:15). The reconnecting
wrapper and the socket and gRPC clients wait for the node (ROADMAP A10).
"""

from __future__ import annotations

import threading
from typing import Optional

from tendermint_tpu_torch.abci import types as abci


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
