"""Light proxy: a local JSON-RPC server whose answers are verified through
the light client before being returned: the port's copy of
tendermint_tpu/light/proxy.py, whole. Its commit checks run on the light
client's `device`.

reference: light/proxy/proxy.go:16 + light/rpc/client.go — `tendermint light`
runs this so wallets can point at localhost and get trust-minimized answers
from an untrusted full node.

Verified routes: commit, validators, block (header pinned to a verified
light block), status, and abci_query (merkle proof operators run against
the verified header's app_hash — light/rpc/client.go:116 +
crypto/merkle/proof_op.go). Everything else is forwarded as-is with a
"light_client_verified": false marker.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from aiohttp import web

from tendermint_tpu_torch.light.client import Client
from tendermint_tpu_torch.types.light import (
    commit_to_json,
    header_to_json,
    validator_to_json,
)

logger = logging.getLogger("tendermint_tpu_torch.light.proxy")


class LightProxy:
    def __init__(self, light_client: Client, backend, host: str = "127.0.0.1", port: int = 0):
        """backend: an rpc client (HTTPClient) pointed at the primary node."""
        self.lc = light_client
        self.backend = backend
        self.host = host
        self.port = port
        self.app = web.Application()
        self.app.router.add_post("/", self._handle)
        self.runner: Optional[web.AppRunner] = None
        self.addr = ""

    async def start(self) -> None:
        await self.lc.initialize()
        self.runner = web.AppRunner(self.app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, self.host, self.port)
        await site.start()
        server = site._server.sockets[0].getsockname()
        self.addr = f"{server[0]}:{server[1]}"
        logger.info("light proxy listening on %s", self.addr)

    async def stop(self) -> None:
        if self.runner:
            await self.runner.cleanup()

    # ---------------------------------------------------------------- serve

    async def _handle(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._err(None, -32700, "parse error")
        id_ = body.get("id")
        method = body.get("method", "")
        params = body.get("params", {}) or {}
        try:
            if method == "commit":
                result = await self._commit(params)
            elif method == "validators":
                result = await self._validators(params)
            elif method == "block":
                result = await self._block(params)
            elif method == "status":
                result = await self._status(params)
            elif method == "abci_query":
                result = await self._abci_query(params)
            else:
                result = await self.backend.call(method, **params)
                if isinstance(result, dict):
                    result = {**result, "light_client_verified": False}
            return web.json_response({"jsonrpc": "2.0", "id": id_, "result": result})
        except Exception as e:
            logger.exception("light proxy error in %s", method)
            return self._err(id_, -32603, "internal error", str(e))

    @staticmethod
    def _err(id_, code, message, data="") -> web.Response:
        return web.json_response(
            {"jsonrpc": "2.0", "id": id_, "error": {"code": code, "message": message, "data": data}}
        )

    async def _verified_block_at(self, params):
        height = params.get("height")
        if height is not None:
            return await self.lc.verify_light_block_at_height(int(height))
        lb = await self.lc.update()
        return lb or self.lc.store.latest_light_block()

    async def _commit(self, params) -> dict:
        lb = await self._verified_block_at(params)
        return {
            "signed_header": {
                "header": header_to_json(lb.header),
                "commit": commit_to_json(lb.signed_header.commit),
            },
            "canonical": True,
            "light_client_verified": True,
        }

    async def _validators(self, params) -> dict:
        lb = await self._verified_block_at(params)
        return {
            "block_height": str(lb.height),
            "validators": [validator_to_json(v) for v in lb.validator_set.validators],
            "count": str(len(lb.validator_set.validators)),
            "total": str(len(lb.validator_set.validators)),
            "light_client_verified": True,
        }

    async def _block(self, params) -> dict:
        """Forward the block but PIN the header to the verified light block
        AND check the payload against the header's DataHash — a lying backend
        cannot substitute headers or transactions
        (reference: light/rpc/client.go Block + Block.ValidateBasic)."""
        import base64

        from tendermint_tpu_torch.types.block import txs_hash

        lb = await self._verified_block_at(params)
        raw = await self.backend.call("block", height=lb.height)
        hdr = raw.get("block", {}).get("header", {})
        verified = header_to_json(lb.header)
        if hdr != verified:
            raise ValueError(
                f"backend header at height {lb.height} does not match the "
                "light-client-verified header"
            )
        txs = [
            base64.b64decode(t)
            for t in raw.get("block", {}).get("data", {}).get("txs", [])
        ]
        if txs_hash(txs).hex().upper() != verified["data_hash"]:
            raise ValueError(
                f"backend block data at height {lb.height} does not hash to "
                "the verified header's DataHash"
            )
        raw["light_client_verified"] = True
        return raw

    async def _abci_query(self, params) -> dict:
        """Proof-verified query: force prove=true, then run the returned
        proof operators from the value up to the app_hash of the VERIFIED
        header at response-height + 1 (AppHash for H lands in header H+1;
        reference: light/rpc/client.go:80-125 ABCIQueryWithOptions)."""
        import base64

        from tendermint_tpu_torch.crypto.proof_ops import (
            KeyPath,
            ProofOp,
            default_proof_runtime,
        )

        raw = await self.backend.call(
            "abci_query",
            path=params.get("path", ""),
            data=params.get("data", ""),
            height=int(params.get("height", 0)),
            prove=True,
        )
        resp = raw.get("response", {})
        if int(resp.get("code", 0)) != 0:
            raise ValueError(f"err response code: {resp.get('code')}")
        key = base64.b64decode(resp.get("key") or "")
        value = base64.b64decode(resp.get("value") or "")
        height = int(resp.get("height") or 0)
        ops_json = (resp.get("proofOps") or {}).get("ops") or []
        if not key or not ops_json:
            raise ValueError("empty tree (no key or no proof ops)")
        if height <= 0:
            raise ValueError("zero or negative query height")

        lb = await self.lc.verify_light_block_at_height(height + 1)
        ops = [
            ProofOp(
                o.get("type", ""),
                base64.b64decode(o.get("key") or ""),
                base64.b64decode(o.get("data") or ""),
            )
            for o in ops_json
        ]
        prt = default_proof_runtime()
        kp = KeyPath().append_key(key)
        if value:
            prt.verify_value(ops, lb.header.app_hash, str(kp), value)
        else:
            prt.verify_absence(ops, lb.header.app_hash, str(kp))
        raw["light_client_verified"] = True
        return raw

    async def _status(self, params) -> dict:
        raw = await self.backend.call("status")
        latest = self.lc.store.latest_light_block()
        raw["light_client"] = {
            "trusted_height": latest.height if latest else 0,
            "trusted_hash": latest.hash().hex().upper() if latest else "",
            "witnesses": len(self.lc.witnesses),
        }
        return raw
