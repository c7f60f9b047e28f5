"""Multi-connection ABCI proxy (reference: proxy/multi_app_conn.go:21,
proxy/app_conn.go:13-56).

One ClientCreator yields four independent clients — Consensus, Mempool, Query,
Snapshot — so block execution, CheckTx, RPC queries, and state-sync snapshots
proceed concurrently without blocking one another. For the local client they
share one app lock (same as the reference's local mode). The port's copy of
tendermint_tpu/proxy/multi.py; the socket and gRPC creators import their
transport only when called, so a node on the local app imports no grpc."""

from __future__ import annotations

import threading
from typing import Callable

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import ABCIClient, LocalClient, ReconnectingClient

ClientCreator = Callable[[], ABCIClient]


def local_client_creator(app: abci.Application) -> ClientCreator:
    lock = threading.RLock()

    def create() -> ABCIClient:
        return LocalClient(app, lock)

    return create


def socket_client_creator(addr: str, call_timeout: float = 30.0) -> ClientCreator:
    def create() -> ABCIClient:
        from tendermint_tpu_torch.abci.socket import SocketClient

        return SocketClient(addr, call_timeout=call_timeout)

    return create


def grpc_client_creator(addr: str) -> ClientCreator:
    def create() -> ABCIClient:
        from tendermint_tpu_torch.abci.grpc import GrpcClient

        return GrpcClient(addr)

    return create


def default_client_creator(
    proxy_app: str, transport: str, app=None, call_timeout: float = 30.0
) -> ClientCreator:
    """The reference's DefaultClientCreator (proxy/client.go): an address in
    proxy_app selects a remote transport ("socket" default, "grpc"); empty
    means run the in-process app."""
    if proxy_app:
        if transport == "grpc":
            return grpc_client_creator(proxy_app)
        return socket_client_creator(proxy_app, call_timeout=call_timeout)
    if app is None:
        raise ValueError("no proxy_app address and no in-process app")
    return local_client_creator(app)


class AppConns:
    """Four logical connections. With resilient=True (remote apps), the
    mempool/query/snapshot connections survive an app restart via
    ReconnectingClient; the CONSENSUS connection is never wrapped — its
    failure must stay fatal-loud (a node that silently retries block
    execution against a restarted app risks nondeterministic state)."""

    def __init__(
        self,
        creator: ClientCreator,
        resilient: bool = False,
        attempts: int = 5,
        base_delay: float = 0.2,
        max_delay: float = 5.0,
    ):
        self._creator = creator
        self.consensus: ABCIClient = creator()
        if resilient:
            kw = dict(attempts=attempts, base_delay=base_delay, max_delay=max_delay)
            self.mempool: ABCIClient = ReconnectingClient(creator, name="mempool", **kw)
            self.query: ABCIClient = ReconnectingClient(creator, name="query", **kw)
            self.snapshot: ABCIClient = ReconnectingClient(creator, name="snapshot", **kw)
        else:
            self.mempool = creator()
            self.query = creator()
            self.snapshot = creator()

    def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            c.close()
