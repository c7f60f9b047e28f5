"""Standalone Prometheus exposition server: the port's copy of
tendermint_tpu/libs/prometheus_server.py, whole.

The reference serves /metrics on its own listener bound to
`instrumentation.prometheus_listen_addr` (node/node.go:1105 startPrometheusServer),
independent of the RPC endpoint. This is that listener: a tiny aiohttp app
that renders the node's metrics Registry. The RPC server's /metrics route
(rpc/server.py) stays as a convenience alias.
"""

from __future__ import annotations

from typing import Optional

from aiohttp import web


class PrometheusServer:
    """Serves GET /metrics (and "/") with the text exposition format."""

    def __init__(self, registry, listen_addr: str):
        self.registry = registry
        host, _, port = listen_addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self.runner: Optional[web.AppRunner] = None

    async def start(self) -> None:
        app = web.Application()
        app.router.add_get("/metrics", self._handle)
        app.router.add_get("/", self._handle)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, self.host, self.port)
        await site.start()
        # resolve the actual port (listen_addr may use :0 in tests)
        server = site._server
        if server is not None and server.sockets:
            self.port = server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self.runner is not None:
            await self.runner.cleanup()
            self.runner = None

    async def _handle(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.registry.expose(),
            content_type="text/plain",
            charset="utf-8",
        )
