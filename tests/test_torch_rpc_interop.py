"""The port's RPC server and clients against the reference's over real
sockets on 127.0.0.1: the reference's HTTPClient against the port's node,
and the port's HTTPClient against the reference's node. Each direction
runs the same script, and both must give the same answers:

- JSON-RPC POST: status, broadcast_tx_sync, abci_query, an unknown method
  (RPCError -32601);
- URI GET: /block?height=1 and /abci_query?path="/store"&data=...;
- a websocket subscription to tm.event='Tx' that receives the committed tx
  event, and the client-side wait_for_tx on the same connection;
- /metrics (the RPC listener and the Prometheus listener), parsed by the
  client package's parse_exposition, with the per-method request counter
  moved by this script's calls;
- the /debug index and /debug/rpc pages.
"""

import asyncio
import base64

import aiohttp
import pytest

from tests.torch_rpc_util import PORT, REF, make_node, url_of


def _prometheus(cfg):
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"


async def _script(S, C, tmp):
    node = make_node(S, tmp, rpc=True, edit=_prometheus, chain="interop-chain")
    await node.start()
    client = C.client.HTTPClient(url_of(node))
    out = {}
    try:
        await node.wait_for_height(1)
        st = await client.status()
        out["network"] = st["node_info"]["network"]
        sub = await client.subscribe("tm.event = 'Tx'")
        tx = b"interop=%s" % C.which.encode()
        tx_hash = C.tmhash.sum256(tx)
        waiter = asyncio.create_task(client.wait_for_tx(tx_hash, timeout=30))
        await asyncio.sleep(0.05)
        res = await client.broadcast_tx_sync(tx)
        out["sync"] = (res["code"], res["hash"] == tx_hash.hex().upper())
        ev = await asyncio.wait_for(sub.next(), 30)
        out["event"] = (ev["events"]["tm.event"], ev["events"]["tx.hash"] == [tx_hash.hex().upper()],
                        ev["data"]["type"])
        ev2 = await waiter
        out["wait_for_tx"] = ev2["events"]["tx.hash"] == [tx_hash.hex().upper()]
        await sub.unsubscribe()
        q = await client.abci_query("/store", b"interop")
        out["query"] = base64.b64decode(q["response"]["value"])
        with pytest.raises(C.client.RPCError) as ei:
            await client.call("nonexistent_route")
        out["unknown"] = (ei.value.code, "not found" in str(ei.value))
        async with aiohttp.ClientSession() as sess:
            async with sess.get(url_of(node) + "/block", params={"height": "1"}) as resp:
                body = await resp.json()
                out["uri_block"] = (resp.status, body["result"]["block"]["header"]["height"])
            async with sess.get(url_of(node) + "/abci_query",
                                params={"path": '"/store"', "data": b"interop".hex()}) as resp:
                body = await resp.json()
                out["uri_query"] = base64.b64decode(body["result"]["response"]["value"])
            async with sess.get(url_of(node) + "/debug") as resp:
                idx = (await resp.json())["result"]
                out["debug_index"] = len(idx["endpoints"])
            async with sess.get(url_of(node) + "/debug/rpc") as resp:
                doc = (await resp.json())["result"]
                out["debug_rpc"] = {m: a["ok"] for m, a in doc["methods"].items()
                                    if m in ("status", "broadcast_tx_sync", "abci_query")}
            async with sess.get(f"http://127.0.0.1:{node.prometheus_server.port}/metrics") as resp:
                prom = C.metrics.parse_exposition(await resp.text())
        fams = C.metrics.parse_exposition(await client.metrics_text())
        ok = {lab["method"]: v for _, lab, v in fams["tendermint_rpc_requests_total"]["samples"]
              if lab["outcome"] == "ok"}
        out["metrics"] = (ok.get("status"), ok.get("broadcast_tx_sync"),
                          "tendermint_consensus_height" in prom)
    finally:
        await client.close()
        await node.stop()
    return out


@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port")])
def test_http_interop(server, client, tmp_path):
    S, C = (PORT, REF) if server == "port" else (REF, PORT)
    out = asyncio.run(_script(S, C, tmp_path))
    assert out == {
        "network": "interop-chain",
        "sync": (0, True),
        "event": (["Tx"], True, "Tx"),
        "wait_for_tx": True,
        "query": client.encode(),
        "unknown": (-32601, True),
        "uri_block": (200, "1"),
        "uri_query": client.encode(),
        "debug_index": 12,
        "debug_rpc": {"status": 1, "broadcast_tx_sync": 1, "abci_query": 2},
        "metrics": (1.0, 1.0, True),
    }
