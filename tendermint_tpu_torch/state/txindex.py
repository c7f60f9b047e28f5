"""Tx indexing (reference: state/txindex/indexer.go + kv/kv.go): the
port's copy of tendermint_tpu/state/txindex.py, whole.

IndexerService subscribes to the event bus and indexes TxResults by hash,
height, and app-emitted composite keys for /tx_search."""

from __future__ import annotations

import asyncio
import json
import struct
from typing import List, Optional

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.types.event_bus import EVENT_TX, EventBus, query_for_event


class TxResult:
    def __init__(self, height: int, index: int, tx: bytes, code: int, data: bytes, log: str, events=None):
        self.height = height
        self.index = index
        self.tx = tx
        self.code = code
        self.data = data
        self.log = log
        self.events = events or []

    def to_json(self) -> str:
        return json.dumps(
            {
                "height": self.height,
                "index": self.index,
                "tx": self.tx.hex(),
                "code": self.code,
                "data": self.data.hex(),
                "log": self.log,
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "TxResult":
        o = json.loads(raw)
        return cls(o["height"], o["index"], bytes.fromhex(o["tx"]), o["code"], bytes.fromhex(o["data"]), o["log"])


class KVTxIndexer:
    def __init__(self, db: KVDB):
        self.db = db

    def index(self, result: TxResult, composite_keys: Optional[dict] = None) -> None:
        h = tmhash.sum256(result.tx)
        self.db.set(b"TX:hash:" + h, result.to_json().encode())
        self.db.set(
            b"TX:height:" + struct.pack(">q", result.height) + struct.pack(">I", result.index),
            h,
        )
        for key, values in (composite_keys or {}).items():
            for v in values:
                self.db.set(
                    b"TX:event:" + key.encode() + b"=" + v.encode() + b":" + h, h
                )

    def get(self, tx_hash: bytes) -> Optional[TxResult]:
        raw = self.db.get(b"TX:hash:" + tx_hash)
        return TxResult.from_json(raw.decode()) if raw else None

    def by_height(self, height: int) -> List[TxResult]:
        out = []
        for _, h in self.db.iterate_prefix(b"TX:height:" + struct.pack(">q", height)):
            r = self.get(h)
            if r:
                out.append(r)
        return out

    def search(self, key: str, value: str) -> List[TxResult]:
        out = []
        for _, h in self.db.iterate_prefix(b"TX:event:" + key.encode() + b"=" + value.encode() + b":"):
            r = self.get(h)
            if r:
                out.append(r)
        return out


class IndexerService(BaseService):
    """(reference: state/txindex/indexer_service.go; lifecycle via
    libs/service.BaseService like the reference's cmn.BaseService)"""

    def __init__(self, indexer: KVTxIndexer, event_bus: EventBus):
        super().__init__("IndexerService")
        self.indexer = indexer
        self.event_bus = event_bus
        self._task: Optional[asyncio.Task] = None
        self._sub = None

    async def on_start(self) -> None:
        self._sub = self.event_bus.subscribe("tx_index", query_for_event(EVENT_TX), out_capacity=1000)
        self._task = asyncio.create_task(self._run(), name="tx-indexer")

    async def _run(self) -> None:
        try:
            while True:
                msg = await self._sub.next()
                data = msg.data  # EventDataTx
                composite = {
                    k: v for k, v in msg.events.items() if k not in ("tm.event",)
                }
                self.indexer.index(
                    TxResult(
                        data.height,
                        data.index,
                        data.tx,
                        data.result.code,
                        data.result.data,
                        data.result.log,
                    ),
                    composite,
                )
        except (asyncio.CancelledError, RuntimeError):
            pass

    async def on_stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        try:
            self.event_bus.unsubscribe_all("tx_index")
        except Exception:
            pass
