"""RPC clients (reference: rpc/client/http + rpc/client/local): the port's
copy of tendermint_tpu/rpc/client.py, whole.

HTTPClient speaks JSON-RPC over HTTP (aiohttp) to any node's RPC server, and
lazily opens a /websocket side-channel for event subscriptions (reference:
rpc/client/http/http.go embeds a WSEvents client); LocalClient calls the
in-process server handlers directly (backs the light client's provider and
tests without a socket, reference: rpc/client/local)."""

from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional

import aiohttp


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(f"RPC error {code}: {message} {data}")
        self.code = code


class HTTPClient:
    """(reference: rpc/client/http/http.go)"""

    def __init__(self, base_url: str):
        if not base_url.startswith("http"):
            base_url = "http://" + base_url.replace("tcp://", "")
        self.base_url = base_url.rstrip("/")
        self._session: Optional[aiohttp.ClientSession] = None
        self._ws: Optional["WSEventClient"] = None
        self._id = 0

    async def _ensure(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._ws is not None:
            await self._ws.close()
            self._ws = None
        if self._session and not self._session.closed:
            await self._session.close()

    # -- websocket subscriptions (reference: rpc/client/http WSEvents) ------

    async def _ws_events(self) -> "WSEventClient":
        if self._ws is None or not self._ws.running:
            if self._ws is not None:
                await self._ws.close()  # release the dead session/socket
            self._ws = WSEventClient(self.base_url)
            await self._ws.start()
        return self._ws

    async def subscribe(self, query: str) -> "WSSubscription":
        """Subscribe to events matching a pubsub query over the websocket
        side-channel; returns a WSSubscription with `next()`."""
        ws = await self._ws_events()
        return await ws.subscribe(query)

    async def unsubscribe_all(self) -> None:
        if self._ws is not None and self._ws.running:
            await self._ws.unsubscribe_all()

    async def wait_for_tx(self, tx_hash: bytes, timeout: float = 30.0) -> dict:
        """Client-side broadcast_tx_commit wait: subscribe to the tx's
        DeliverTx event by hash (the same query the server-side
        broadcast_tx_commit route uses, reference: rpc/core/mempool.go) and
        block until it fires."""
        sub = await self.subscribe(f"tm.event = 'Tx' AND tx.hash = '{tx_hash.hex().upper()}'")
        try:
            return await asyncio.wait_for(sub.next(), timeout)
        finally:
            await sub.unsubscribe()

    async def call(self, method: str, **params):
        session = await self._ensure()
        self._id += 1
        payload = {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        async with session.post(self.base_url + "/", json=payload) as resp:
            body = await resp.json(content_type=None)
        if body.get("error"):
            err = body["error"]
            raise RPCError(err.get("code", -1), err.get("message", ""), err.get("data", ""))
        return body.get("result")

    async def metrics_text(self) -> Optional[str]:
        """Raw Prometheus exposition from the node's /metrics route, or None
        when instrumentation is disabled (404) or the GET fails — scrapers
        like tools/loadtest.py degrade instead of erroring."""
        session = await self._ensure()
        try:
            async with session.get(self.base_url + "/metrics") as resp:
                if resp.status != 200:
                    return None
                return await resp.text()
        except Exception:
            return None

    # convenience wrappers (the route set mirrors rpc/core/routes.go)
    async def status(self):
        return await self.call("status")

    async def health(self):
        return await self.call("health")

    async def block(self, height: Optional[int] = None):
        return await self.call("block", **({"height": height} if height else {}))

    async def block_by_hash(self, block_hash: str):
        return await self.call("block_by_hash", hash=block_hash)

    async def block_results(self, height: Optional[int] = None):
        return await self.call("block_results", **({"height": height} if height else {}))

    async def commit(self, height: Optional[int] = None):
        return await self.call("commit", **({"height": height} if height else {}))

    async def validators(self, height: Optional[int] = None):
        return await self.call("validators", **({"height": height} if height else {}))

    async def genesis(self):
        return await self.call("genesis")

    async def tx(self, tx_hash: str):
        return await self.call("tx", hash=tx_hash)

    async def tx_search(self, query: str, page: int = 1, per_page: int = 30):
        return await self.call("tx_search", query=query, page=page, per_page=per_page)

    async def block_search(self, query: str, page: int = 1, per_page: int = 30):
        return await self.call("block_search", query=query, page=page, per_page=per_page)

    async def broadcast_tx_async(self, tx: bytes):
        return await self.call("broadcast_tx_async", tx="0x" + tx.hex())

    async def broadcast_tx_sync(self, tx: bytes):
        return await self.call("broadcast_tx_sync", tx="0x" + tx.hex())

    async def broadcast_tx_commit(self, tx: bytes):
        return await self.call("broadcast_tx_commit", tx="0x" + tx.hex())

    async def abci_query(self, path: str, data: bytes, height: int = 0, prove: bool = False):
        return await self.call("abci_query", path=path, data=data.hex(), height=height, prove=prove)

    async def net_info(self):
        return await self.call("net_info")

    async def consensus_state(self):
        return await self.call("consensus_state")

    async def consensus_params(self, height=None):
        return await self.call("consensus_params", height=height)

    async def dump_consensus_state(self):
        return await self.call("dump_consensus_state")


class WSSubscription:
    """One active websocket subscription: `next()` yields event payloads
    ({"query": ..., "events": {...}, "data": {...}})."""

    def __init__(self, client: "WSEventClient", sub_id: int, query: str):
        self._client = client
        self._id = sub_id
        self.query = query
        self._queue: asyncio.Queue = asyncio.Queue()
        self._terminal: Optional[Exception] = None

    async def next(self) -> dict:
        # A dead subscription must fail EVERY next() call, not just the one
        # that drained the single enqueued error: later (or concurrent)
        # consumers would otherwise await an empty queue forever.
        if self._terminal is not None and self._queue.empty():
            raise self._terminal
        item = await self._queue.get()
        if isinstance(item, Exception):
            self._terminal = item
            # Re-enqueue the sentinel so consumers ALREADY parked in
            # queue.get() (which never saw the empty-queue precheck above)
            # wake in a chain instead of awaiting forever.
            self._queue.put_nowait(item)
            raise item
        return item

    async def unsubscribe(self) -> None:
        await self._client._drop(self._id)


class WSEventClient:
    """JSON-RPC over one /websocket connection: regular calls plus
    query-indexed event subscriptions (reference: rpc/client/http/http.go
    WSEvents + rpc/jsonrpc/client/ws_client.go).

    Frame routing: responses and subscription events share the request id —
    the first frame for an id resolves the pending call future, every later
    frame with that id is a subscription event routed to its queue."""

    def __init__(self, base_url: str):
        if not base_url.startswith("http"):
            base_url = "http://" + base_url.replace("tcp://", "")
        self._url = base_url.rstrip("/") + "/websocket"
        self._session: Optional[aiohttp.ClientSession] = None
        self._ws: Optional[aiohttp.ClientWebSocketResponse] = None
        self._reader: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._subs: Dict[int, WSSubscription] = {}
        self._id = 0
        self.running = False

    async def start(self) -> None:
        self._session = aiohttp.ClientSession()
        self._ws = await self._session.ws_connect(self._url)
        self.running = True
        self._reader = asyncio.create_task(self._read_loop())

    async def close(self) -> None:
        self.running = False
        if self._reader is not None:
            self._reader.cancel()
            try:
                await self._reader
            except (asyncio.CancelledError, Exception):
                pass
            self._reader = None
        if self._ws is not None and not self._ws.closed:
            await self._ws.close()
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def _read_loop(self) -> None:
        err: Exception = RPCError(-1, "ws connection closed")
        try:
            async for msg in self._ws:
                if msg.type != aiohttp.WSMsgType.TEXT:
                    continue
                try:
                    body = json.loads(msg.data)
                except json.JSONDecodeError:
                    continue
                id_ = body.get("id")
                fut = self._pending.pop(id_, None)
                if fut is not None:
                    if not fut.done():
                        if body.get("error"):
                            e = body["error"]
                            fut.set_exception(
                                RPCError(e.get("code", -1), e.get("message", ""),
                                         e.get("data", ""))
                            )
                        else:
                            fut.set_result(body.get("result"))
                    continue
                sub = self._subs.get(id_)
                if sub is not None and body.get("result"):
                    sub._queue.put_nowait(body["result"])
        except Exception as e:
            err = e
        finally:
            # Reached on BOTH error and clean server close: mark the client
            # dead (so HTTPClient._ws_events reconnects) and fail everything
            # in flight — a pending call or subscription must never await a
            # closed connection forever.
            self.running = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            for sub in self._subs.values():
                sub._queue.put_nowait(err)

    async def call(self, method: str, **params):
        self._id += 1
        id_ = self._id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[id_] = fut
        await self._ws.send_json(
            {"jsonrpc": "2.0", "id": id_, "method": method, "params": params}
        )
        return await fut

    async def subscribe(self, query: str) -> WSSubscription:
        self._id += 1
        id_ = self._id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[id_] = fut
        sub = WSSubscription(self, id_, query)
        # Register BEFORE sending: the ack and the first event can arrive in
        # one read-loop slice, and an event routed while we await the ack
        # must land in the queue, not be dropped.
        self._subs[id_] = sub
        await self._ws.send_json(
            {"jsonrpc": "2.0", "id": id_, "method": "subscribe",
             "params": {"query": query}}
        )
        try:
            await fut  # ack (or RPCError)
        except Exception:
            self._subs.pop(id_, None)
            raise
        return sub

    async def _drop(self, sub_id: int) -> None:
        sub = self._subs.pop(sub_id, None)
        if sub is not None:
            try:
                await self.call("unsubscribe", query=sub.query)
            except Exception:
                pass

    async def unsubscribe_all(self) -> None:
        try:
            await self.call("unsubscribe_all")
        except Exception:
            pass
        self._subs.clear()


class LocalClient:
    """Direct in-process calls against a node's RPC handler table
    (reference: rpc/client/local/local.go)."""

    def __init__(self, node):
        from tendermint_tpu_torch.rpc.server import RPCServer

        self._server = RPCServer(node) if node.rpc_server is None else node.rpc_server

    async def call(self, method: str, **params):
        from tendermint_tpu_torch.rpc.server import RPCShedError

        handler = self._server._routes.get(method)
        if handler is None:
            raise RPCError(-32601, f"method {method} not found")
        try:
            # through the load gate, same as the HTTP transports — a local
            # client must not bypass the node's shed policy
            return await self._server._dispatch(method, handler, params)
        except RPCShedError:
            raise RPCError(-32005, "server overloaded", method)

    def __getattr__(self, name):
        async def _proxy(**params):
            return await self.call(name, **params)

        return _proxy
