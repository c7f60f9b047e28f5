"""JSON-RPC/HTTP/WebSocket server (reference: rpc/jsonrpc/server + rpc/core/routes.go:10-47):
the port's copy of tendermint_tpu/rpc/server.py, whole.

Serves POST JSON-RPC, GET URI style, and /websocket subscriptions against the
node's internals (the reference's rpc/core Environment role), on aiohttp as
the reference does. The routes, JSON shapes, error codes and HTTP statuses
are the reference's, so a client of either package talks to the other.

The light routes call the node's LightService, whose flushes run on the
node's `device`; a failed flush raises out of the handler and the transport
answers it as the route's JSON-RPC error (-32603), with no retry.
/debug/mesh serves parallel/telemetry.mesh_stats(), which the sharded mesh
feeds (parallel/sharded.py); on a single-card node it answers as the
reference does on a single-device node."""

from __future__ import annotations

import asyncio
import heapq
import json
import logging
import time
from typing import Any, Dict, Optional

from aiohttp import web, WSMsgType

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs.pubsub import Query
from tendermint_tpu_torch.light.service import (
    ErrBadRequest,
    ErrLightDisabled,
    ErrLightOverloaded,
    LightServiceError,
)
from tendermint_tpu_torch.mempool.mempool import MempoolError
from tendermint_tpu_torch.types.event_bus import EVENT_TX, TX_HASH_KEY, query_for_event
from tendermint_tpu_torch.types.light import (
    block_id_to_json,
    commit_to_json,
    header_to_json,
    validator_to_json,
)

logger = logging.getLogger("tendermint_tpu_torch.rpc")


def _b64(b: bytes) -> str:
    import base64

    return base64.b64encode(b).decode()


def _result(id_, result) -> dict:
    return {"jsonrpc": "2.0", "id": id_, "result": result}


def _error(id_, code, message, data="") -> dict:
    return {"jsonrpc": "2.0", "id": id_, "error": {"code": code, "message": message, "data": data}}


class RPCShedError(Exception):
    """Raised by the load gate when a sheddable request is refused; the
    transport layers translate it to HTTP 429 + Retry-After (JSON-RPC
    error -32005)."""


# JSON-RPC error codes (implementation-defined range)
ERR_SHED = -32005  # server overloaded, retry later
ERR_MEMPOOL = -32001  # mempool rejected the tx (data carries the reason)

# Methods the gate may refuse under load. Everything else — health, status,
# consensus introspection, net_info, the debug/unsafe routes — bypasses the
# gate: an operator must be able to see INTO an overloaded node, and
# consensus-critical paths are never shed.
SHEDDABLE_METHODS = frozenset({
    "broadcast_tx_async", "broadcast_tx_sync", "broadcast_tx_commit",
    "check_tx", "abci_query", "abci_info",
    "tx", "tx_status", "tx_search", "block_search",
    "block", "blockchain", "block_results", "block_by_hash", "commit",
    "unconfirmed_txs",
    # light-client serving (light/service.py): per-client admission rides
    # this gate (429 + Retry-After) so a light-verification flood can never
    # starve the live vote path; light_status bypasses like status
    "light_verify", "light_block",
})
# Under overload pressure (node/overload.py flips rpc_shed_writes before
# rpc_shed_reads), write-path methods shed first.
WRITE_METHODS = frozenset(
    {"broadcast_tx_async", "broadcast_tx_sync", "broadcast_tx_commit"}
)


class LoadGate:
    """Bounded-concurrency admission gate for sheddable RPC methods
    ([rpc] max_inflight_requests). Refusal is immediate (no queueing): an
    overloaded serving stack must fail fast with Retry-After, not build an
    unbounded backlog. The overload controller may additionally force-shed
    writes (shed_writes) or all sheddable methods (shed_reads)."""

    def __init__(self, max_inflight: int, metrics=None):
        self.max_inflight = max_inflight
        self.metrics = metrics  # RPCMetrics or None
        self.inflight = 0
        self.shed_total = 0
        self.shed_writes = False  # flipped by the overload controller
        self.shed_reads = False

    def admits(self, method: str) -> bool:
        if method not in SHEDDABLE_METHODS:
            return True
        if self.shed_reads:
            return False
        if self.shed_writes and method in WRITE_METHODS:
            return False
        return self.max_inflight <= 0 or self.inflight < self.max_inflight

    def record_shed(self, method: str) -> None:
        self.shed_total += 1
        if self.metrics is not None:
            self.metrics.shed_requests.labels(method).inc()

    def enter(self) -> None:
        self.inflight += 1
        if self.metrics is not None:
            self.metrics.inflight_requests.set(self.inflight)

    def exit(self) -> None:
        self.inflight -= 1
        if self.metrics is not None:
            self.metrics.inflight_requests.set(self.inflight)


class SlowRequestRing:
    """Bounded top-N-by-duration request ring: the structured
    annotations an operator reads at GET /debug/rpc to answer "why was my
    request slow" — method, wall duration, outcome, error detail, and the
    gate pressure (inflight count + shed switches) the request saw at
    dispatch. A min-heap keyed on duration keeps exactly the N slowest;
    offering a faster-than-the-floor request is O(1)."""

    def __init__(self, cap: int = 32):
        self.cap = max(1, int(cap))
        self._heap: list = []  # (duration_s, seq, entry)
        self._seq = 0

    def offer(self, duration_s: float, entry: dict) -> None:
        if len(self._heap) >= self.cap and duration_s <= self._heap[0][0]:
            return
        self._seq += 1
        heapq.heappush(self._heap, (duration_s, self._seq, entry))
        while len(self._heap) > self.cap:
            heapq.heappop(self._heap)

    def snapshot(self) -> list:
        """Slowest first."""
        return [e for _, _, e in sorted(self._heap, key=lambda t: -t[0])]


class RPCServer:
    def __init__(self, node):
        self.node = node
        addr = node.config.rpc.laddr.replace("tcp://", "")
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port) if port else 0  # 0: handler-only (LocalClient)
        self.app = web.Application(client_max_size=node.config.rpc.max_body_bytes)
        self.app.router.add_post("/", self._handle_jsonrpc)
        self.app.router.add_get("/metrics", self._handle_metrics)
        self.app.router.add_get("/websocket", self._handle_websocket)
        # flight-recorder dumps (libs/trace.py); two path segments, so they
        # need explicit routes ahead of the generic /{method} catch-all
        self.app.router.add_get("/debug", self._handle_debug_index)
        self.app.router.add_get("/debug/trace", self._handle_debug_trace)
        self.app.router.add_get("/debug/verify_stats", self._handle_debug_verify_stats)
        self.app.router.add_get(
            "/debug/consensus_timeline", self._handle_debug_consensus_timeline
        )
        self.app.router.add_get("/debug/overload", self._handle_debug_overload)
        self.app.router.add_get("/debug/mesh", self._handle_debug_mesh)
        self.app.router.add_get("/debug/slo", self._handle_debug_slo)
        self.app.router.add_get("/debug/light", self._handle_debug_light)
        self.app.router.add_get("/debug/tx_trace", self._handle_debug_tx_trace)
        self.app.router.add_get("/debug/rpc", self._handle_debug_rpc)
        self.app.router.add_get(
            "/debug/device_profile", self._handle_debug_device_profile
        )
        self.app.router.add_get("/{method}", self._handle_uri)
        self.runner: Optional[web.AppRunner] = None
        # load-shedding gate ([rpc] max_inflight_requests); the overload
        # controller (node/overload.py) reads inflight and flips the
        # shed_writes/shed_reads switches
        rpc_metrics = getattr(getattr(node, "metrics", None), "rpc", None)
        self.gate = LoadGate(
            getattr(node.config.rpc, "max_inflight_requests", 0),
            metrics=rpc_metrics,
        )
        self._routes = {
            "health": self._health,
            "status": self._status,
            "broadcast_tx_async": self._broadcast_tx_async,
            "broadcast_tx_sync": self._broadcast_tx_sync,
            "broadcast_tx_commit": self._broadcast_tx_commit,
            "abci_query": self._abci_query,
            "abci_info": self._abci_info,
            "block": self._block,
            "blockchain": self._blockchain,
            "commit": self._commit,
            "validators": self._validators,
            "genesis": self._genesis,
            "tx": self._tx,
            "unconfirmed_txs": self._unconfirmed_txs,
            "num_unconfirmed_txs": self._num_unconfirmed_txs,
            "consensus_state": self._consensus_state,
            "dump_consensus_state": self._dump_consensus_state,
            "consensus_params": self._consensus_params,
            "net_info": self._net_info,
            "tx_search": self._tx_search,
            "block_search": self._block_search,
            "block_results": self._block_results,
            "block_by_hash": self._block_by_hash,
            "broadcast_evidence": self._broadcast_evidence,
            "check_tx": self._check_tx,
            "dial_peers": self._dial_peers,
            "dial_seeds": self._dial_seeds,
            "unsafe_flush_mempool": self._unsafe_flush_mempool,
            "unsafe_dump_stacks": self._unsafe_dump_stacks,
            "unsafe_dump_heap": self._unsafe_dump_heap,
            "debug_trace": self._debug_trace,
            "debug_verify_stats": self._debug_verify_stats,
            "consensus_timeline": self._consensus_timeline,
            "debug_overload": self._debug_overload,
            "debug_mesh": self._debug_mesh,
            "debug_slo": self._debug_slo,
            "debug_index": self._debug_index,
            "debug_device_profile": self._debug_device_profile,
            # light-client-as-a-service (light/service.py)
            "light_verify": self._light_verify,
            "light_block": self._light_block,
            "light_status": self._light_status,
            "debug_light": self._debug_light,
            # transaction & request observatory (libs/txtrace.py)
            "tx_status": self._tx_status,
            "debug_tx_trace": self._debug_tx_trace,
            "debug_rpc": self._debug_rpc,
        }
        # per-method request telemetry: every transport routes
        # through _dispatch, which observes duration + outcome per method
        # (label cardinality bounded to this route table; unknown methods
        # fold into "_other") and feeds the slowest requests into a bounded
        # top-N ring served at GET /debug/rpc
        self.slow_ring = SlowRequestRing(cap=32)
        self._method_agg: Dict[str, dict] = {}

    # -- load shedding -------------------------------------------------------

    async def _dispatch(self, method: str, handler, params):
        """All transports (JSON-RPC POST, URI GET, websocket; LocalClient
        too) route through the gate here; a refused request raises
        RPCShedError for the transport to translate (HTTP 429 +
        Retry-After). Every dispatched request — admitted or shed — is
        observed once: per-method duration histogram + outcome counter
        (tendermint_rpc_request_*), the rpc_request_p99 SLO budget, and the
        slow-request ring behind GET /debug/rpc."""
        t0 = time.perf_counter()
        inflight0 = self.gate.inflight
        if not self.gate.admits(method):
            self.gate.record_shed(method)
            self._observe_request(
                method, time.perf_counter() - t0, "shed", inflight0,
                error="gate refused (429)",
            )
            raise RPCShedError(method)
        entered = method in SHEDDABLE_METHODS
        if entered:
            self.gate.enter()
        outcome, error = "ok", None
        try:
            return await handler(params)
        except asyncio.CancelledError:
            # client disconnect / shutdown, not a request outcome — don't
            # mint error series or slow-ring entries for aborts
            outcome = None
            raise
        except ErrLightOverloaded as e:
            outcome, error = "shed", f"{e.code}: light overloaded"
            raise
        except MempoolError as e:
            # structured admission refusals are the serving path WORKING,
            # not erroring — attribute them separately from 500s
            outcome, error = "reject", f"mempool {getattr(e, 'reason', '?')}"
            raise
        except LightServiceError as e:
            outcome, error = "reject", f"{e.code}: {type(e).__name__}"
            raise
        except BaseException as e:
            outcome, error = "error", type(e).__name__
            raise
        finally:
            if entered:
                self.gate.exit()
            if outcome is not None:
                self._observe_request(
                    method, time.perf_counter() - t0, outcome, inflight0, error
                )

    def _method_label(self, method: str) -> str:
        """Bound the per-method label space to the declared route table —
        a client probing made-up method names must not mint unbounded
        metric series (they fold into `_other`)."""
        return method if method in self._routes else "_other"

    SLOW_RING_MIN_S = 0.001  # sub-ms requests never displace real evidence

    def _observe_request(
        self,
        method: str,
        seconds: float,
        outcome: str,
        inflight0: int,
        error: Optional[str] = None,
    ) -> None:
        label = self._method_label(method)
        served = outcome != "shed"
        m = self.gate.metrics  # RPCMetrics or None
        if m is not None:
            if served:
                # sheds refuse in microseconds: feeding them into the
                # latency histogram (or the p99 SLO below) would collapse
                # the per-method p99 toward zero exactly while the node is
                # refusing traffic — shed visibility is requests_total
                # {outcome="shed"} + shed_requests_total, never latency
                m.request_duration.labels(label).observe(seconds)
            m.requests.labels(label, outcome).inc()
        slo = getattr(self.node, "slo", None)
        if slo is not None and served:
            slo.observe("rpc_request_p99", seconds)
        agg = self._method_agg.get(label)
        if agg is None:
            agg = self._method_agg[label] = {
                "count": 0, "ok": 0, "shed": 0, "reject": 0, "error": 0,
                "total_s": 0.0, "max_ms": 0.0,
            }
        agg["count"] += 1
        agg[outcome] = agg.get(outcome, 0) + 1
        if served:
            agg["total_s"] += seconds
            if seconds * 1e3 > agg["max_ms"]:
                agg["max_ms"] = round(seconds * 1e3, 3)
        if seconds >= self.SLOW_RING_MIN_S:
            self.slow_ring.offer(
                seconds,
                {
                    "method": label,
                    "duration_ms": round(seconds * 1e3, 3),
                    "ts": round(time.time(), 3),
                    "outcome": outcome,
                    "error": error,
                    # gate pressure at dispatch: admission is immediate (no
                    # queue wait), so congestion shows as inflight depth and
                    # flipped shed switches rather than waiting time
                    "inflight_at_dispatch": inflight0,
                    "shed_writes": self.gate.shed_writes,
                    "shed_reads": self.gate.shed_reads,
                },
            )

    def _shed_response(self, id_, method: str) -> web.Response:
        retry_after = getattr(self.node.config.rpc, "shed_retry_after", 1.0)
        return web.json_response(
            _error(
                id_, ERR_SHED, "server overloaded",
                {"method": method, "retry_after": retry_after},
            ),
            status=429,
            headers={"Retry-After": f"{retry_after:g}"},
        )

    @staticmethod
    def _mempool_reject(id_, e) -> dict:
        """Structured JSON-RPC error for a mempool admission rejection —
        the reject reason (full/evicted/cache/quota/too_large) is data, not
        a 500 with a bare traceback."""
        return _error(
            id_, ERR_MEMPOOL, "mempool rejected tx",
            {"reason": getattr(e, "reason", "rejected"), "detail": str(e)},
        )

    async def start(self) -> None:
        self.runner = web.AppRunner(self.app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, self.host, self.port)
        await site.start()
        # resolve the bound port (laddr may ask for :0)
        server = site._server
        if server is not None and server.sockets:
            self.port = server.sockets[0].getsockname()[1]
        logger.info("RPC server listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self.runner:
            await self.runner.cleanup()

    # -- transport ----------------------------------------------------------

    async def _handle_jsonrpc(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response(_error(None, -32700, "parse error"))
        id_ = body.get("id")
        method = body.get("method", "")
        params = body.get("params", {}) or {}
        handler = self._routes.get(method)
        if handler is None:
            return web.json_response(_error(id_, -32601, f"method {method} not found"))
        try:
            result = await self._dispatch(method, handler, params)
            return web.json_response(_result(id_, result))
        except RPCShedError:
            return self._shed_response(id_, method)
        except ErrLightOverloaded:
            return self._shed_response(id_, method)
        except MempoolError as e:
            return web.json_response(self._mempool_reject(id_, e))
        except LightServiceError as e:
            return web.json_response(_error(id_, e.code, str(e), e.data))
        except Exception as e:
            logger.exception("rpc error in %s", method)
            return web.json_response(_error(id_, -32603, "internal error", str(e)))

    async def _handle_metrics(self, request: web.Request) -> web.Response:
        """Prometheus text exposition (reference: the :26660 /metrics
        endpoint, node/node.go:861; served on the RPC listener here)."""
        if not self.node.config.instrumentation.prometheus:
            return web.Response(status=404, text="instrumentation disabled")
        return web.Response(
            text=self.node.metrics.expose(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def _handle_debug_trace(self, request: web.Request) -> web.Response:
        params = {k: v for k, v in request.query.items()}
        try:
            return web.json_response(_result(None, await self._debug_trace(params)))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_verify_stats(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_verify_stats({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_consensus_timeline(self, request: web.Request) -> web.Response:
        params = {k: v for k, v in request.query.items()}
        try:
            return web.json_response(
                _result(None, await self._consensus_timeline(params))
            )
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_overload(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_overload({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_mesh(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_mesh({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_slo(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_slo({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_index(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_index({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_light(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_light({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_tx_trace(self, request: web.Request) -> web.Response:
        params = {k: v for k, v in request.query.items()}
        try:
            return web.json_response(
                _result(None, await self._debug_tx_trace(params))
            )
        except LightServiceError as e:  # ErrBadRequest: malformed hash
            return web.json_response(_error(None, e.code, str(e), e.data))
        except ValueError as e:
            return web.json_response(_error(None, -32602, "bad request", str(e)))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_rpc(self, request: web.Request) -> web.Response:
        try:
            return web.json_response(_result(None, await self._debug_rpc({})))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_debug_device_profile(self, request: web.Request) -> web.Response:
        params = {k: v for k, v in request.query.items()}
        try:
            return web.json_response(
                _result(None, await self._debug_device_profile(params))
            )
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_uri(self, request: web.Request) -> web.Response:
        method = request.match_info["method"]
        handler = self._routes.get(method)
        if handler is None:
            return web.json_response(_error(None, -32601, f"method {method} not found"))
        params = {k: v.strip('"') for k, v in request.query.items()}
        try:
            result = await self._dispatch(method, handler, params)
            return web.json_response(_result(None, result))
        except RPCShedError:
            return self._shed_response(None, method)
        except ErrLightOverloaded:
            return self._shed_response(None, method)
        except MempoolError as e:
            return web.json_response(self._mempool_reject(None, e))
        except LightServiceError as e:
            return web.json_response(_error(None, e.code, str(e), e.data))
        except Exception as e:
            return web.json_response(_error(None, -32603, "internal error", str(e)))

    async def _handle_websocket(self, request: web.Request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        subscriber = f"ws-{id(ws)}"
        tasks = []
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    body = json.loads(msg.data)
                except json.JSONDecodeError:
                    await ws.send_json(_error(None, -32700, "parse error"))
                    continue
                id_ = body.get("id")
                method = body.get("method", "")
                params = body.get("params", {}) or {}
                if method == "subscribe":
                    try:
                        q = Query(params.get("query", ""))
                        sub = self.node.event_bus.subscribe(subscriber, q)
                    except Exception as e:
                        await ws.send_json(_error(id_, -32603, "subscribe failed", str(e)))
                        continue
                    await ws.send_json(_result(id_, {}))

                    async def pump(sub=sub, q=q, id_=id_):
                        try:
                            while True:
                                m = await sub.next()
                                await ws.send_json(
                                    _result(
                                        id_,
                                        {
                                            "query": str(q),
                                            "data": {"type": m.events.get("tm.event", [""])[0]},
                                            "events": m.events,
                                        },
                                    )
                                )
                        except Exception:
                            pass

                    tasks.append(asyncio.create_task(pump()))
                elif method == "unsubscribe":
                    # by query, mirroring the reference's /unsubscribe route
                    # (reference: rpc/core/events.go Unsubscribe)
                    try:
                        q = Query(params.get("query", ""))
                        self.node.event_bus.unsubscribe(subscriber, q)
                        await ws.send_json(_result(id_, {}))
                    except Exception as e:
                        await ws.send_json(_error(id_, -32603, "unsubscribe failed", str(e)))
                elif method == "unsubscribe_all":
                    self.node.event_bus.unsubscribe_all(subscriber)
                    await ws.send_json(_result(id_, {}))
                else:
                    handler = self._routes.get(method)
                    if handler is None:
                        await ws.send_json(_error(id_, -32601, f"method {method} not found"))
                    else:
                        try:
                            await ws.send_json(
                                _result(id_, await self._dispatch(method, handler, params))
                            )
                        except (RPCShedError, ErrLightOverloaded):
                            await ws.send_json(
                                _error(id_, ERR_SHED, "server overloaded", {"method": method})
                            )
                        except MempoolError as e:
                            await ws.send_json(self._mempool_reject(id_, e))
                        except LightServiceError as e:
                            await ws.send_json(_error(id_, e.code, str(e), e.data))
                        except Exception as e:
                            await ws.send_json(_error(id_, -32603, "internal error", str(e)))
        finally:
            for t in tasks:
                t.cancel()
            try:
                self.node.event_bus.unsubscribe_all(subscriber)
            except Exception:
                pass
        return ws

    # -- handlers (reference: rpc/core/*.go) --------------------------------

    async def _health(self, params) -> dict:
        return {}

    async def _status(self, params) -> dict:
        node = self.node
        latest_height = node.block_store.height
        latest_block = node.block_store.load_block(latest_height) if latest_height else None
        pub = node.priv_validator.get_pub_key() if node.priv_validator else None
        return {
            "node_info": {
                "network": node.genesis.chain_id,
                "moniker": node.config.base.moniker,
                "version": "0.1.0",
            },
            "sync_info": {
                "latest_block_height": str(latest_height),
                "latest_block_hash": latest_block.hash().hex().upper() if latest_block else "",
                "latest_app_hash": node.state.app_hash.hex().upper() if node.state else "",
                "catching_up": False,
            },
            "validator_info": {
                "address": pub.address().hex().upper() if pub else "",
                "pub_key": {"type": pub.type_name(), "value": _b64(pub.bytes())} if pub else None,
                "voting_power": "0",
            },
        }

    def _decode_tx_param(self, params) -> bytes:
        import base64

        tx = params.get("tx", "")
        if isinstance(tx, str):
            if tx.startswith("0x"):
                return bytes.fromhex(tx[2:])
            try:
                return base64.b64decode(tx)
            except Exception:
                return tx.encode()
        return bytes(tx)

    def _track_received(self, tx_hash: bytes) -> None:
        """Stamp the journey's `received` at the RPC edge — BEFORE the
        executor hop into mempool.check_tx, so the waterfall's first stage
        includes executor queueing (the mempool re-stamp dedupes)."""
        tt = getattr(self.node, "tx_tracker", None)
        if tt is not None and tt.enabled:
            tt.record(tx_hash, "received", via="rpc")

    async def _broadcast_tx_async(self, params) -> dict:
        tx = self._decode_tx_param(params)
        tx_hash = tmhash.sum256(tx)
        self._track_received(tx_hash)
        asyncio.get_event_loop().run_in_executor(None, self.node.mempool.check_tx, tx)
        return {"code": 0, "data": "", "log": "", "hash": tx_hash.hex().upper()}

    async def _broadcast_tx_sync(self, params) -> dict:
        tx = self._decode_tx_param(params)
        self._track_received(tmhash.sum256(tx))
        res = await asyncio.get_event_loop().run_in_executor(None, self.node.mempool.check_tx, tx)
        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "hash": tmhash.sum256(tx).hex().upper(),
        }

    async def _check_tx(self, params) -> dict:
        """Run CheckTx against the app WITHOUT adding the tx to the mempool
        (reference: rpc/core/mempool.go CheckTx, routes.go:26)."""
        tx = self._decode_tx_param(params)
        res = await asyncio.get_event_loop().run_in_executor(
            None, self.node.proxy_app.mempool.check_tx, abci.RequestCheckTx(tx=tx)
        )
        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "gas_wanted": str(res.gas_wanted),
            "gas_used": str(res.gas_used),
        }

    async def _broadcast_tx_commit(self, params) -> dict:
        """CheckTx → wait for DeliverTx event (reference: rpc/core/mempool.go)."""
        tx = self._decode_tx_param(params)
        tx_hash = tmhash.sum256(tx)
        self._track_received(tx_hash)
        q = Query(f"{TX_HASH_KEY} = '{tx_hash.hex().upper()}'")
        subscriber = f"btc-{tx_hash.hex()[:16]}"
        sub = self.node.event_bus.subscribe(subscriber, q)
        try:
            check = await asyncio.get_event_loop().run_in_executor(
                None, self.node.mempool.check_tx, tx
            )
            if check.code != abci.CODE_TYPE_OK:
                return {
                    "check_tx": {"code": check.code, "log": check.log},
                    "deliver_tx": {},
                    "hash": tx_hash.hex().upper(),
                    "height": "0",
                }
            timeout = self.node.config.rpc.timeout_broadcast_tx_commit
            msg = await asyncio.wait_for(sub.next(), timeout=timeout)
            data = msg.data
            return {
                "check_tx": {"code": check.code, "log": check.log},
                "deliver_tx": {
                    "code": data.result.code,
                    "data": _b64(data.result.data),
                    "log": data.result.log,
                },
                "hash": tx_hash.hex().upper(),
                "height": str(data.height),
            }
        finally:
            try:
                self.node.event_bus.unsubscribe_all(subscriber)
            except Exception:
                pass

    async def _abci_query(self, params) -> dict:
        data = params.get("data", "")
        if isinstance(data, str):
            data = bytes.fromhex(data[2:] if data.startswith("0x") else data)
        res = self.node.proxy_app.query.query(
            abci.RequestQuery(
                data=data,
                path=params.get("path", ""),
                height=int(params.get("height", 0)),
                prove=bool(params.get("prove", False)),
            )
        )
        out = {
            "code": res.code,
            "log": res.log,
            "key": _b64(res.key),
            "value": _b64(res.value),
            "height": str(res.height),
        }
        if res.proof_ops:
            out["proofOps"] = {
                "ops": [
                    {"type": op.type, "key": _b64(op.key), "data": _b64(op.data)}
                    for op in res.proof_ops
                ]
            }
        return {"response": out}

    async def _abci_info(self, params) -> dict:
        res = self.node.proxy_app.query.info(abci.RequestInfo())
        return {
            "response": {
                "data": res.data,
                "version": res.version,
                "app_version": str(res.app_version),
                "last_block_height": str(res.last_block_height),
                "last_block_app_hash": _b64(res.last_block_app_hash),
            }
        }

    def _block_to_json(self, block, block_id) -> dict:
        return {
            "block_id": block_id_to_json(block_id),
            "block": {
                "header": header_to_json(block.header),
                "data": {"txs": [_b64(tx) for tx in block.txs]},
                "last_commit": commit_to_json(block.last_commit),
            },
        }

    async def _block(self, params) -> dict:
        height = int(params.get("height") or self.node.block_store.height)
        block = self.node.block_store.load_block(height)
        if block is None:
            raise ValueError(f"block at height {height} not found")
        meta = self.node.block_store.load_block_meta(height)
        return self._block_to_json(block, meta[0])

    async def _blockchain(self, params) -> dict:
        store = self.node.block_store
        max_h = int(params.get("maxHeight") or store.height)
        min_h = int(params.get("minHeight") or max(store.base, max_h - 19))
        metas = []
        for h in range(max_h, min_h - 1, -1):
            meta = store.load_block_meta(h)
            if meta is None:
                continue
            block = store.load_block(h)
            metas.append(
                {
                    "block_id": {"hash": meta[0].hash.hex().upper()},
                    "header": {"height": str(h), "chain_id": block.header.chain_id},
                    "num_txs": str(len(block.txs)),
                }
            )
        return {"last_height": str(store.height), "block_metas": metas}

    async def _commit(self, params) -> dict:
        """Full signed header — backs the light client's HTTPProvider
        (reference: rpc/core/blocks.go Commit). canonical=True when the commit
        comes from the next block's LastCommit, else the seen commit."""
        height = int(params.get("height") or self.node.block_store.height)
        block = self.node.block_store.load_block(height)
        if block is None:
            raise ValueError(f"block at height {height} not found")
        canonical = False
        commit = None
        nxt = self.node.block_store.load_block(height + 1)
        if nxt is not None and nxt.last_commit.height == height:
            commit, canonical = nxt.last_commit, True
        else:
            commit = self.node.block_store.load_seen_commit(height)
        if commit is None:
            raise ValueError(f"commit at height {height} not found")
        return {
            "signed_header": {
                "header": header_to_json(block.header),
                "commit": commit_to_json(commit),
            },
            "canonical": canonical,
        }

    async def _validators(self, params) -> dict:
        height = int(params.get("height") or (self.node.state.last_block_height + 1))
        vals = self.node.state_store.load_validators(height)
        if vals is None:
            raise ValueError(f"no validator set at height {height}")
        return {
            "block_height": str(height),
            "validators": [validator_to_json(v) for v in vals.validators],
            "count": str(len(vals.validators)),
            "total": str(len(vals.validators)),
        }

    async def _genesis(self, params) -> dict:
        return {"genesis": json.loads(self.node.genesis.to_json())}

    async def _tx(self, params) -> dict:
        h = params.get("hash", "")
        if isinstance(h, str):
            tx_hash = bytes.fromhex(h[2:] if h.startswith("0x") else h)
        else:
            tx_hash = bytes(h)
        res = self.node.tx_indexer.get(tx_hash)
        if res is None:
            raise ValueError(f"tx {tx_hash.hex()} not found")
        return {
            "hash": tx_hash.hex().upper(),
            "height": str(res.height),
            "index": res.index,
            "tx_result": {"code": res.code, "data": _b64(res.data), "log": res.log},
            "tx": _b64(res.tx),
        }

    async def _unconfirmed_txs(self, params) -> dict:
        limit = int(params.get("limit", 30))
        txs = self.node.mempool.reap_max_txs(limit)
        return {
            "n_txs": str(len(txs)),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.txs_bytes()),
            "txs": [_b64(tx) for tx in txs],
        }

    async def _num_unconfirmed_txs(self, params) -> dict:
        return {
            "n_txs": str(self.node.mempool.size()),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.txs_bytes()),
        }

    async def _consensus_state(self, params) -> dict:
        return {"round_state": self.node.consensus.rs.round_state_summary()}

    async def _dump_consensus_state(self, params) -> dict:
        """(reference: rpc/core/consensus.go DumpConsensusState)"""
        rs = self.node.consensus.rs
        votes = []
        if rs.votes is not None:
            for r in range(rs.round + 1):
                pv, pc = rs.votes.prevotes(r), rs.votes.precommits(r)
                votes.append(
                    {
                        "round": r,
                        "prevotes": pv.bit_array() if pv else [],
                        "prevotes_power": str(pv.sum_power()) if pv else "0",
                        "precommits": pc.bit_array() if pc else [],
                        "precommits_power": str(pc.sum_power()) if pc else "0",
                    }
                )
        peers = []
        if self.node.switch is not None:
            for p in self.node.switch.peers.list():
                ps = p.get("cs_peer_state")
                peers.append(
                    {
                        "node_address": p.id,
                        "peer_state": {
                            "height": str(ps.height),
                            "round": ps.round,
                            "step": int(ps.step),
                        }
                        if ps
                        else None,
                    }
                )
        return {
            "round_state": {
                "height": str(rs.height),
                "round": rs.round,
                "step": int(rs.step),
                "locked_round": rs.locked_round,
                "valid_round": rs.valid_round,
                "proposal": rs.proposal is not None,
                "proposal_block": rs.proposal_block.hash().hex().upper() if rs.proposal_block else "",
                "height_vote_set": votes,
            },
            "peers": peers,
        }

    async def _consensus_params(self, params) -> dict:
        height = int(params.get("height") or (self.node.state.last_block_height + 1))
        cp = self.node.state.consensus_params
        return {
            "block_height": str(height),
            "consensus_params": {
                "block": {"max_bytes": str(cp.block.max_bytes), "max_gas": str(cp.block.max_gas)},
                "evidence": {
                    "max_age_num_blocks": str(cp.evidence.max_age_num_blocks),
                    "max_age_duration": str(cp.evidence.max_age_duration_ns),
                },
            },
        }

    async def _tx_search(self, params) -> dict:
        """query like "tm.event.key='v'" or "app.creator='x'"; supports
        key=value equality terms (reference: rpc/core/tx.go TxSearch over the
        kv indexer state/txindex/kv/kv.go)."""
        query = params.get("query", "")
        terms = [t.strip() for t in query.split(" AND ") if t.strip()]
        results = None
        for term in terms:
            if "=" not in term:
                raise ValueError(f"bad query term {term!r}")
            key, _, val = term.partition("=")
            key = key.strip()
            val = val.strip().strip("'\"")
            if key == "tx.height":
                found = self.node.tx_indexer.by_height(int(val))
            else:
                found = self.node.tx_indexer.search(key, val)
            keys = {tmhash.sum256(r.tx) for r in found}
            if results is None:
                results = {tmhash.sum256(r.tx): r for r in found}
            else:
                results = {k: v for k, v in results.items() if k in keys}
        results = list((results or {}).values())
        page = int(params.get("page", 1))
        per_page = min(int(params.get("per_page", 30)), 100)
        start = (page - 1) * per_page
        out = results[start : start + per_page]
        return {
            "txs": [
                {
                    "hash": tmhash.sum256(r.tx).hex().upper(),
                    "height": str(r.height),
                    "index": r.index,
                    "tx_result": {"code": r.code, "data": _b64(r.data), "log": r.log},
                    "tx": _b64(r.tx),
                }
                for r in out
            ],
            "total_count": str(len(results)),
        }

    async def _block_search(self, params) -> dict:
        """Search blocks by height range terms, e.g.
        "block.height > 5 AND block.height <= 10"
        (reference: rpc/core/blocks.go BlockSearch)."""
        query = params.get("query", "")
        store = self.node.block_store
        lo, hi = store.base, store.height
        for term in (t.strip() for t in query.split(" AND ") if t.strip()):
            for op in (">=", "<=", ">", "<", "="):
                if op in term:
                    key, _, val = term.partition(op)
                    if key.strip() != "block.height":
                        raise ValueError(f"unsupported block_search key {key.strip()!r}")
                    v = int(val.strip().strip("'\""))
                    if op == ">=":
                        lo = max(lo, v)
                    elif op == ">":
                        lo = max(lo, v + 1)
                    elif op == "<=":
                        hi = min(hi, v)
                    elif op == "<":
                        hi = min(hi, v - 1)
                    else:
                        lo = hi = v
                    break
            else:
                raise ValueError(f"bad query term {term!r}")
        blocks = []
        for h in range(lo, hi + 1):
            block = store.load_block(h)
            meta = store.load_block_meta(h)
            if block is not None and meta is not None:
                blocks.append(self._block_to_json(block, meta[0]))
        page = int(params.get("page", 1))
        per_page = min(int(params.get("per_page", 30)), 100)
        start = (page - 1) * per_page
        return {"blocks": blocks[start : start + per_page], "total_count": str(len(blocks))}

    async def _block_results(self, params) -> dict:
        height = int(params.get("height") or self.node.block_store.height)
        resp = self.node.state_store.load_abci_responses(height)
        if resp is None:
            raise ValueError(f"no ABCI results for height {height}")
        return {
            "height": str(height),
            "txs_results": [
                {"code": r.code, "data": _b64(r.data), "log": r.log, "gas_used": str(r.gas_used)}
                for r in resp.deliver_txs
            ],
            "validator_updates": [
                {"pub_key": {"type": u.pub_key_type, "value": _b64(u.pub_key_bytes)}, "power": str(u.power)}
                for u in (resp.end_block.validator_updates if resp.end_block else [])
            ],
        }

    async def _block_by_hash(self, params) -> dict:
        h = params.get("hash", "")
        block_hash = bytes.fromhex(h[2:] if h.startswith("0x") else h) if isinstance(h, str) else bytes(h)
        block = self.node.block_store.load_block_by_hash(block_hash)
        if block is None:
            raise ValueError(f"block {block_hash.hex()} not found")
        meta = self.node.block_store.load_block_meta(block.header.height)
        return self._block_to_json(block, meta[0])

    async def _broadcast_evidence(self, params) -> dict:
        """(reference: rpc/core/evidence.go)"""
        from tendermint_tpu_torch.types.evidence import decode_evidence

        raw = params.get("evidence", "")
        data = bytes.fromhex(raw[2:] if raw.startswith("0x") else raw) if isinstance(raw, str) else bytes(raw)
        ev = decode_evidence(data)
        self.node.evidence_pool.add_evidence(ev)
        return {"hash": ev.hash().hex().upper()}

    def _require_unsafe(self) -> None:
        if not self.node.config.rpc.unsafe:
            raise ValueError("unsafe RPC routes are disabled (set rpc.unsafe = true)")

    async def _dial_seeds(self, params) -> dict:
        """unsafe route (reference: rpc/core/net.go UnsafeDialSeeds)."""
        self._require_unsafe()
        seeds = params.get("seeds") or []
        if self.node.switch is None:
            raise ValueError("p2p is not enabled")
        await self.node.switch.dial_peers_async(list(seeds), persistent=False)
        return {"log": f"dialing seeds: {seeds}"}

    async def _unsafe_flush_mempool(self, params) -> dict:
        """unsafe route (reference: rpc/core/mempool.go UnsafeFlushMempool)."""
        self._require_unsafe()
        self.node.mempool.flush()
        return {}

    async def _unsafe_dump_stacks(self, params) -> dict:
        """Stack profile: every thread's Python stack plus every asyncio
        task's coroutine stack — the goroutine-profile analog the reference
        debug dump captures (cmd/tendermint/commands/debug/dump.go:117
        dumpProfile("goroutine"))."""
        self._require_unsafe()
        import sys
        import traceback

        threads = {}
        for tid, frame in sys._current_frames().items():
            threads[str(tid)] = "".join(traceback.format_stack(frame))
        tasks = {}
        for i, task in enumerate(asyncio.all_tasks()):
            stack = task.get_stack(limit=16)
            tasks[f"{i}:{task.get_name()}"] = "".join(
                "".join(traceback.format_stack(f)) for f in stack
            ) or repr(task)
        return {"threads": threads, "tasks": tasks}

    async def _unsafe_dump_heap(self, params) -> dict:
        """Heap profile via tracemalloc — the heap-pprof analog
        (cmd/tendermint/commands/debug/dump.go:121 dumpProfile("heap")).
        First call starts tracing and returns a baseline marker; subsequent
        calls return the top allocation sites."""
        self._require_unsafe()
        import tracemalloc

        top_n = int(params.get("top", 50))
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return {"tracing_started": True, "top": []}
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")[:top_n]
        cur, peak = tracemalloc.get_traced_memory()
        return {
            "tracing_started": False,
            "traced_current_bytes": cur,
            "traced_peak_bytes": peak,
            "top": [
                {
                    "file": str(s.traceback[0].filename),
                    "line": s.traceback[0].lineno,
                    "size_bytes": s.size,
                    "count": s.count,
                }
                for s in stats
            ],
        }

    async def _debug_trace(self, params) -> dict:
        """Flight-recorder ring dump (libs/trace.py): the batch-verify
        pipeline's span tree as JSON, newest-last. ?limit=N returns the most
        recent N events. Read-only, served regardless of rpc.unsafe (like
        consensus_state); see docs/OBSERVABILITY.md for the span taxonomy."""
        from tendermint_tpu_torch.libs import trace

        limit = params.get("limit")
        events = trace.tracer.dump(int(limit) if limit is not None else None)
        return {
            "enabled": trace.tracer.enabled,
            "ring_size": trace.tracer.ring_size,
            "count": len(events),
            "events": events,
        }

    async def _debug_verify_stats(self, params) -> dict:
        """Aggregated batch-verify telemetry + device health
        (libs/trace.verify_stats): per-(backend, path) flush totals, the
        per-stage time split, the last flush's breakdown, and the
        device_up/init/last-call-age gauges node liveness reads."""
        from tendermint_tpu_torch.libs import trace

        out = trace.verify_stats()
        svc = getattr(self.node, "light_service", None)
        if svc is not None:
            # the serving subsystem's consumption of the pipeline above —
            # one stats read covers the device AND who it verified for
            out["light"] = svc.stats()
        sched = getattr(self.node, "scheduler", None)
        if sched is not None:
            # THIS node's scheduler, not the process-global default another
            # in-process node may have registered last
            out["scheduler"] = sched.stats()
        return out

    async def _consensus_timeline(self, params) -> dict:
        """Per-height/round consensus timeline ring
        (consensus/timeline.py): time-ordered step entries with derived
        durations, round escalations, proposal/vote arrival and commit per
        height. ?limit=N returns the most recent N heights. Degrades
        gracefully: with tracing disabled (or no timeline wired) it reports
        enabled=false and whatever records exist (none if tracing was never
        on). Read-only; same taxonomy as `wal-inspect`'s offline report."""
        from tendermint_tpu_torch.libs import trace

        tl = getattr(self.node.consensus, "timeline", None)
        limit = params.get("limit")
        heights = tl.dump(int(limit) if limit is not None else None) if tl else []
        return {
            "enabled": bool(tl is not None and trace.tracer.enabled),
            "max_heights": tl.max_heights if tl is not None else 0,
            "count": len(heights),
            "heights": heights,
            # cross-height per-origin hop-latency aggregates (the per-peer
            # lag ranking the chain observatory merges across the fleet)
            "propagation_peers": tl.peer_stats() if tl is not None else {},
            "node_id": (
                self.node.node_key.id
                if getattr(self.node, "node_key", None) is not None
                else None
            ),
        }

    async def _debug_overload(self, params) -> dict:
        """Overload-protection snapshot (node/overload.py + the RPC gate +
        mempool admission + per-peer shed counters): the one page an
        operator reads when the node is under pressure. Read-only, served
        regardless of rpc.unsafe (like /debug/verify_stats)."""
        out = {
            "rpc": {
                "max_inflight_requests": self.gate.max_inflight,
                "inflight": self.gate.inflight,
                "shed_total": self.gate.shed_total,
                "shed_writes": self.gate.shed_writes,
                "shed_reads": self.gate.shed_reads,
            }
        }
        ctl = getattr(self.node, "overload", None)
        out["controller"] = ctl.snapshot() if ctl is not None else None
        mp = getattr(self.node, "mempool", None)
        if mp is not None:
            out["mempool"] = {
                "size": mp.size(),
                "max_txs": mp.max_txs,
                "bytes": mp.txs_bytes(),
                "max_bytes": mp.max_txs_bytes,
                "full": mp.is_full(0),
                "evicted_total": getattr(mp, "evicted_total", 0),
                "expired_total": getattr(mp, "expired_total", 0),
            }
        sw = getattr(self.node, "switch", None)
        if sw is not None:
            out["p2p"] = {
                "peers": sw.num_peers(),
                "shed_by_peer": {
                    p.id[:10]: {
                        "shed_msgs_total": p.mconn.shed_msgs,
                        "by_channel": {
                            f"{cid:#x}": n
                            for cid, n in p.mconn.shed_by_channel.items()
                        },
                    }
                    for p in sw.peers.list()
                    if p.mconn.shed_msgs
                },
            }
        return out

    async def _debug_mesh(self, params) -> dict:
        """Multi-device mesh telemetry: parallel/telemetry.mesh_stats(), the
        snapshot that verify_stats' `mesh` block and the observatory's dumps
        read too. Read-only, served regardless of rpc.unsafe."""
        from tendermint_tpu_torch.parallel import telemetry

        return telemetry.mesh_stats()

    # one-line description per debug surface — served by GET /debug so the
    # ~10 endpoints are discoverable from the node itself, not only the docs.
    # The text is the reference's, word for word, so that GET /debug answers
    # the same from either package; the port's capture behind
    # /debug/device_profile is torch.profiler (libs/profiler.py).
    DEBUG_ENDPOINTS = (
        ("/debug", "this index: every debug endpoint with a description", False),
        ("/debug/trace", "flight-recorder ring dump (batch-verify spans + "
         "consensus/breaker/forensics events); ?limit=N", False),
        ("/debug/verify_stats", "aggregated batch-verify telemetry, last "
         "flush breakdown, slope samples, device health", False),
        ("/debug/consensus_timeline", "per-height/round timeline: steps, "
         "proposals, vote arrivals, cross-node propagation; ?limit=N", False),
        ("/debug/overload", "overload-protection snapshot: RPC gate, "
         "pressure controller, mempool admission, per-peer sheds", False),
        ("/debug/mesh", "multi-chip mesh telemetry: shard lanes, pad waste, "
         "all_gather traffic, AOT cache outcomes", False),
        ("/debug/slo", "declared latency budgets, per-window burn rates and "
         "guard trips ([slo] config)", False),
        ("/debug/light", "light-client-as-a-service snapshot: trusted span, "
         "cache/single-flight counters, coalesced flushes, sheds, "
         "conflicting-header detections", False),
        ("/debug/tx_trace", "tx lifecycle observatory: ?hash= returns the "
         "full received→delivered waterfall with per-stage durations; "
         "without, ring stats + per-stage latency percentiles", False),
        ("/debug/rpc", "per-method RPC latency attribution: gate state, "
         "per-method outcome counts + mean/max, top-N slowest requests "
         "with structured annotations", False),
        ("/debug/device_profile", "on-demand jax profiler capture; "
         "?action=start|stop|status (start/stop need rpc.unsafe)", True),
        ("/metrics", "Prometheus exposition (needs instrumentation."
         "prometheus)", False),
    )

    async def _debug_index(self, params) -> dict:
        """GET /debug: machine- and operator-readable catalog of every debug
        endpoint (they number ~10 and were only discoverable via docs)."""
        return {
            "endpoints": [
                {"path": path, "description": desc, "unsafe": unsafe}
                for path, desc, unsafe in self.DEBUG_ENDPOINTS
            ]
        }

    async def _debug_slo(self, params) -> dict:
        """SLO burn-rate snapshot (libs/slo.py): declared budgets, good/
        breach totals, fast+slow window burn rates, tripped guards and
        verdicts per objective. Read-only, served regardless of rpc.unsafe
        (like /debug/verify_stats); enabled=false when the engine is off."""
        eng = getattr(self.node, "slo", None)
        if eng is None:
            return {"enabled": False, "objectives": {}}
        return eng.snapshot()

    # -- light-client-as-a-service (light/service.py) -----------------------

    def _light_service(self):
        svc = getattr(self.node, "light_service", None)
        if svc is None:
            # structured refusal: a deliberately disabled service must not
            # produce -32603 + a stack trace per request
            raise ErrLightDisabled(
                "light service is disabled (set light_service.enabled = true)"
            )
        return svc

    @staticmethod
    def _decode_hash_param(params) -> Optional[bytes]:
        h = params.get("hash", "")
        if not h:
            return None
        try:
            if isinstance(h, str):
                out = bytes.fromhex(h[2:] if h.startswith("0x") else h)
            elif isinstance(h, (bytes, bytearray, list)):
                out = bytes(h)
            else:
                raise TypeError(f"unsupported type {type(h).__name__}")
        except (ValueError, TypeError) as e:
            raise ErrBadRequest(f"invalid hash parameter: {e}") from e
        if len(out) != 32:
            # a short/garbage hash must be a bad request, never a
            # conflicting-header "attack" detection
            raise ErrBadRequest(
                f"invalid hash parameter: want 32 bytes, got {len(out)}"
            )
        return out

    @staticmethod
    def _decode_height_param(params) -> int:
        try:
            return int(params.get("height") or 0)
        except (ValueError, TypeError) as e:
            raise ErrBadRequest(f"invalid height parameter: {e}") from e

    async def _light_verified_result(self, params) -> tuple:
        """Shared body of light_verify/light_block: parse params, verify
        through the service, build the base response. Returns (result,
        light_block) so light_block can append the validator set."""
        svc = self._light_service()
        height = self._decode_height_param(params)
        lb, source = await svc.verify_height(
            height, expected_hash=self._decode_hash_param(params)
        )
        return {
            "height": str(lb.height),
            "hash": lb.hash().hex().upper(),
            "source": source,
            "signed_header": {
                "header": header_to_json(lb.header),
                "commit": commit_to_json(lb.signed_header.commit),
            },
            "light_client_verified": True,
        }, lb

    async def _light_verify(self, params) -> dict:
        """Server-side skipping verification (the light-client-as-a-service
        fast path): verify the commit at `height` against the service's
        trusted span — answered from the verified-header cache, a shared
        coalesced device flush, or the bisection fallback. Optional `hash`
        is the client's expected header hash; a mismatch is a structured
        conflicting-header error (code -32010), not a 500. Sheddable under
        the LoadGate (429 + Retry-After) so a light flood never starves
        consensus."""
        result, _lb = await self._light_verified_result(params)
        return result

    async def _light_block(self, params) -> dict:
        """light_verify + the validator set: everything a downstream light
        client needs to extend its own trust from this height."""
        from tendermint_tpu_torch.types.light import validator_set_to_json

        result, lb = await self._light_verified_result(params)
        result["validator_set"] = validator_set_to_json(lb.validator_set)
        return result

    async def _light_status(self, params) -> dict:
        """Service status: trusted span, cache occupancy, window policy,
        current pending load. Bypasses the gate like `status` — a client
        deciding whether to retry must always get an answer."""
        return self._light_service().status()

    async def _debug_light(self, params) -> dict:
        """GET /debug/light: the light service's full counter snapshot
        (requests by outcome, cache hits, single-flight waits, coalesced
        flushes + lanes, bisections, sheds, conflicting headers). Read-only,
        served regardless of rpc.unsafe (like /debug/verify_stats)."""
        svc = getattr(self.node, "light_service", None)
        if svc is None:
            return {"enabled": False}
        return svc.stats()

    # -- transaction & request observatory (libs/txtrace.py) ----------------

    async def _tx_status(self, params) -> dict:
        """Where is my transaction? The full lifecycle waterfall for one tx
        hash: received -> checked -> admitted -> first_gossiped ->
        proposed -> committed -> delivered (or the terminal reject/evict/
        expire), with wall timestamps and per-stage durations. Sheddable
        like `tx` — a status poll must never starve the vote path. A
        disabled tracker and an unknown hash are both structured answers,
        never -32603 + a stack trace per routine poll."""
        tt = getattr(self.node, "tx_tracker", None)
        if tt is None:
            return {
                "enabled": False,
                "found": False,
                "reason": "tx lifecycle tracking is disabled "
                          "(set instrumentation.txtrace_enabled = true)",
            }
        h = params.get("hash", "")
        try:
            if isinstance(h, str):
                tx_hash = bytes.fromhex(h[2:] if h.startswith("0x") else h)
            else:
                tx_hash = bytes(h)
        except (ValueError, TypeError) as e:
            # malformed input is a structured -32602 on every transport,
            # never a -32603 + stack trace
            raise ErrBadRequest(f"invalid hash parameter: {e}") from e
        wf = tt.waterfall(tx_hash)
        if wf is None:
            # the routine polling answer, not an error: clients poll this
            # route for hashes that may never have reached this node (or
            # whose journey aged out of the bounded ring)
            return {
                "hash": tx_hash.hex().upper(),
                "found": False,
                "reason": "not in the lifecycle ring (never received here, "
                          "or the journey aged out)",
                "ring_max_txs": tt.max_txs,
            }
        wf["found"] = True
        # a committed journey gains the indexer's final word when available
        indexer = getattr(self.node, "tx_indexer", None)
        if indexer is not None and wf.get("terminal") == "delivered":
            try:
                res = indexer.get(tx_hash)
            except Exception:
                res = None
            if res is not None:
                wf["indexed"] = {
                    "height": str(res.height),
                    "index": res.index,
                    "code": res.code,
                }
        return wf

    async def _debug_tx_trace(self, params) -> dict:
        """GET /debug/tx_trace: with ?hash= the same waterfall as
        `tx_status`; without, the tracker's ring stats — occupancy, lifetime
        stage counts, terminal outcomes, and per-stage latency percentiles
        (the document the chain observatory merges per node). Read-only,
        served regardless of rpc.unsafe (like /debug/verify_stats)."""
        tt = getattr(self.node, "tx_tracker", None)
        if tt is None:
            return {"enabled": False}
        if params.get("hash"):
            return await self._tx_status(params)
        return tt.stats()

    async def _debug_rpc(self, params) -> dict:
        """GET /debug/rpc: per-method request attribution — the gate state,
        per-method counts/outcomes/mean/max, and the bounded top-N
        slowest-request ring with structured annotations (outcome, error,
        gate pressure at dispatch). Read-only; the histogram form of the
        same data rides /metrics as tendermint_rpc_request_duration_seconds."""
        methods = {}
        for label, agg in sorted(self._method_agg.items()):
            served = agg["count"] - agg["shed"]  # latency covers served only
            methods[label] = {
                **agg,
                "total_s": round(agg["total_s"], 6),
                "mean_ms": round(agg["total_s"] / served * 1e3, 3)
                if served
                else 0.0,
            }
        return {
            "gate": {
                "max_inflight_requests": self.gate.max_inflight,
                "inflight": self.gate.inflight,
                "shed_total": self.gate.shed_total,
                "shed_writes": self.gate.shed_writes,
                "shed_reads": self.gate.shed_reads,
            },
            "methods": methods,
            "slow_ring_cap": self.slow_ring.cap,
            "slow_requests": self.slow_ring.snapshot(),
        }

    async def _debug_device_profile(self, params) -> dict:
        """On-demand device profiler capture (libs/profiler.py over
        torch.profiler): ?action=start begins a capture into a fresh run dir
        under [instrumentation] profile_dir, ?action=stop ends it and lists
        the artifacts (analyze offline with tools/profile_report.py),
        ?action=status (default) reports the session. One capture per
        process; start while active is an error, not a restart."""
        from tendermint_tpu_torch.libs import profiler

        action = params.get("action", "status")
        loop = asyncio.get_running_loop()
        if action == "start":
            # start/stop mutate process-global profiler state and write tens
            # of MB per capture — unsafe-gated like every mutating route;
            # status stays open (read-only, like /debug/mesh)
            self._require_unsafe()
            base = (
                getattr(self.node.config.instrumentation, "profile_dir", "")
                or profiler.default_base_dir()
            )
            return await loop.run_in_executor(None, profiler.start, base)
        if action == "stop":
            self._require_unsafe()
            # stop_trace serializes the whole capture (tens of MB, seconds) —
            # off the event loop so consensus keeps stepping while it writes
            return await loop.run_in_executor(None, profiler.stop)
        if action == "status":
            return profiler.status()
        raise ValueError(
            f"unknown action {action!r} (want start|stop|status)"
        )

    async def _dial_peers(self, params) -> dict:
        """unsafe route (reference: rpc/core/net.go UnsafeDialPeers)."""
        self._require_unsafe()
        if self.node.switch is None:
            raise ValueError("p2p is not enabled")
        peers = params.get("peers", [])
        if isinstance(peers, str):
            peers = [p for p in peers.split(",") if p]
        persistent = bool(params.get("persistent", False))
        await self.node.switch.dial_peers_async(peers, persistent=persistent)
        return {"log": f"dialing {len(peers)} peers"}

    async def _net_info(self, params) -> dict:
        sw = self.node.switch
        if sw is None:
            return {"listening": False, "listeners": [], "n_peers": "0", "peers": []}
        return {
            "listening": True,
            "listeners": [sw.transport.listen_addr],
            "n_peers": str(sw.num_peers()),
            "peers": [
                {
                    "node_info": {
                        "id": p.id,
                        "moniker": p.node_info.moniker,
                        "network": p.node_info.network,
                    },
                    "is_outbound": p.outbound,
                    "remote_ip": p.socket_addr,
                    "trust_score": round(sw.reporter.score(p.id), 4),
                    # flowrate Monitors + send-queue depths (reference:
                    # p2p/peer.go Status → rpc/core/net.go NetInfo)
                    "connection_status": p.status(),
                }
                for p in sw.peers.list()
            ],
        }
