"""Multi-connection ABCI proxy (reference proxy/multi_app_conn.go:21,
proxy/app_conn.go:13-56): the port's copy of `local_client_creator` and
`AppConns` from tendermint_tpu/proxy/multi.py.

One creator yields four clients, Consensus, Mempool, Query and Snapshot; the
local clients share one app lock, as the reference's local mode does. The
socket, gRPC and default creators and the reconnecting connections wait for
the node (ROADMAP A10).
"""

from __future__ import annotations

import threading
from typing import Callable

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import ABCIClient, LocalClient

ClientCreator = Callable[[], ABCIClient]


def local_client_creator(app: abci.Application) -> ClientCreator:
    lock = threading.RLock()

    def create() -> ABCIClient:
        return LocalClient(app, lock)

    return create


class AppConns:
    """Four logical connections, each its own client from one creator."""

    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self.consensus: ABCIClient = creator()
        self.mempool: ABCIClient = creator()
        self.query: ABCIClient = creator()
        self.snapshot: ABCIClient = creator()

    def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            c.close()
