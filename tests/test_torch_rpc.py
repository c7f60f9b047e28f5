"""The reference's RPC route tests, run on both packages side by side
(tests/test_rpc.py:29-411, tests/test_overload.py:283-344 and :454,
tests/test_txtrace.py:344-540, tests/test_abci_grpc.py:113, and signed txs
over RPC), with tolerance 0: each script runs once on the reference and once
on the port, and what it observed (codes, messages, HTTP statuses, headers,
JSON shapes, metric deltas read through parse_exposition or the counters)
must be equal. Timing-dependent values (heights, durations) are asserted
on each package and left out of the comparison.
"""

import asyncio
import base64
import dataclasses
import importlib
import json
import time
from types import SimpleNamespace

import aiohttp
import pytest

from tests.torch_rpc_util import BOTH, PORT, REF, make_node, url_of


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, PORT.batch._MEMO = PORT.batch._MEMO, PORT.batch.VerifiedRowMemo(0)
    yield
    PORT.batch._MEMO = prev


def _same(fn, *args):
    """fn(P, *args) on the reference and on the port: both answers, equal."""
    ref, port = (fn(P, *args) for P in BOTH)
    assert port == ref
    return ref


class _FakeRequest:
    def __init__(self, body):
        self._body = body
        self.query = {}

    async def json(self):
        return self._body


def _bare_server(P, mempool=None, max_inflight=2, **node_kw):
    cfg = P.config.test_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.max_inflight_requests = max_inflight
    node = SimpleNamespace(config=cfg, metrics=P.metrics.NodeMetrics(), mempool=mempool,
                           rpc_server=None, switch=None, overload=None, slo=None,
                           tx_tracker=None, **node_kw)
    return P.server.RPCServer(node)


def _reply(resp) -> tuple:
    return resp.status, resp.headers.get("Retry-After"), json.loads(resp.text)


# -- the load gate, the structured rejects, the overload page -----------------

def test_429_with_retry_after_when_gate_full():
    def script(P):
        rpc = _bare_server(P)
        rpc.gate.enter()
        rpc.gate.enter()

        async def go():
            shed = await rpc._handle_jsonrpc(_FakeRequest(
                {"id": 1, "method": "broadcast_tx_sync", "params": {"tx": "00"}}))
            ok = await rpc._handle_jsonrpc(_FakeRequest({"id": 2, "method": "health"}))
            return _reply(shed), _reply(ok)

        out = asyncio.run(go())
        shed_metric = {k: v for k, v in rpc.gate.metrics.shed_requests._values.items()}
        return out, rpc.gate.shed_total, shed_metric

    (shed, ok), total, metric = _same(script)
    assert shed[0] == 429 and shed[1] == "1" and shed[2]["error"]["code"] == -32005
    assert shed[2]["error"]["data"]["method"] == "broadcast_tx_sync"
    assert ok[0] == 200 and total == 1 and metric == {("broadcast_tx_sync",): 1}


@pytest.mark.parametrize("which", ["full", "quota"])
def test_structured_mempool_reject_not_500(which):
    def script(P):
        exc = (P.mempool.MempoolFullError("no evictable lower-priority txs") if which == "full"
               else P.mempool.SenderQuotaError("peerX", 3))

        class Rejecting:
            def check_tx(self, tx, sender=""):
                raise exc

        rpc = _bare_server(P, mempool=Rejecting())
        return _reply(asyncio.run(rpc._handle_jsonrpc(_FakeRequest(
            {"id": 7, "method": "broadcast_tx_sync", "params": {"tx": "00"}}))))

    status, _, body = _same(script)
    assert status == 200 and body["error"]["code"] == -32001
    assert body["error"]["data"]["reason"] == which


def test_debug_overload_shape_and_controller_signals():
    def script(P):
        class Pool:
            max_txs, max_txs_bytes, evicted_total, expired_total = 10, 1000, 2, 1

            def size(self):
                return 3

            def txs_bytes(self):
                return 30

            def is_full(self, n):
                return False

        rpc = _bare_server(P, mempool=Pool())
        page = asyncio.run(rpc._debug_overload({}))
        gate = P.server.LoadGate(10)
        node = SimpleNamespace(mempool=SimpleNamespace(max_txs=100, max_txs_bytes=10 ** 9,
                                                       size=lambda: 0, txs_bytes=lambda: 0),
                               consensus=SimpleNamespace(_queue=asyncio.Queue(maxsize=100)),
                               rpc_server=SimpleNamespace(gate=gate), switch=None,
                               scheduler=None)
        ctl = P.overload.OverloadController(node, P.config.OverloadConfig(),
                                            metrics=P.metrics.OverloadMetrics(P.metrics.Registry()))
        for _ in range(9):
            gate.enter()
        node.consensus._queue.put_nowait(object())
        sig = ctl.sample()
        ctl.level = 2  # critical: the controller flips the gate's switches
        ctl._apply()
        return page, sig, (gate.shed_writes, gate.shed_reads, gate.admits("health"),
                           gate.admits("status"), gate.admits("block"))

    page, sig, gate = _same(script)
    assert page["rpc"]["max_inflight_requests"] == 2 and page["mempool"]["evicted_total"] == 2
    assert page["controller"] is None
    assert sig["rpc_inflight"] == 0.9 and sig["consensus_queue"] == 0.01
    assert gate == (True, True, True, True, False)


# -- per-method telemetry (tests/test_txtrace.py:344-414) ----------------------

def test_dispatch_telemetry_slow_ring_and_slo():
    def script(P):
        rpc = _bare_server(P, max_inflight=0)
        rpc.node.slo = P.slo.SLOEngine(P.config.SLOConfig())

        async def boom(params):
            raise RuntimeError("kaboom")

        async def ok(params):
            return {}

        async def slowpoke(params):
            await asyncio.sleep(0.005)
            return {}

        async def go():
            await rpc._dispatch("health", rpc._routes["health"], {})
            with pytest.raises(RuntimeError):
                await rpc._dispatch("tx", boom, {})
            rpc.gate.max_inflight, rpc.gate.inflight = 1, 1
            with pytest.raises(P.server.RPCShedError):
                await rpc._dispatch("broadcast_tx_sync", boom, {})
            rpc.gate.inflight = 0
            await rpc._dispatch("made_up_method_xyz", ok, {})
            await rpc._dispatch("abci_query", slowpoke, {})

        asyncio.run(go())
        m = rpc.gate.metrics
        doc = asyncio.run(rpc._debug_rpc({}))
        slow = doc["slow_requests"][0]
        fams = P.metrics.parse_exposition(rpc.node.metrics.expose())
        counts = sorted((tuple(sorted(lab.items())), v) for _, lab, v in
                        fams["tendermint_rpc_requests_total"]["samples"])
        ring = P.server.SlowRequestRing(cap=3)
        for ms in (5, 1, 9, 3, 7, 2):
            ring.offer(ms / 1e3, {"method": "m", "duration_ms": float(ms)})
        return (counts, sorted(m.request_duration._totals),
                {k: (a["ok"], a["error"], a["shed"]) for k, a in doc["methods"].items()},
                doc["gate"]["shed_total"], (slow["method"], slow["outcome"], sorted(slow)),
                [e["duration_ms"] for e in ring.snapshot()],
                rpc.node.slo.snapshot()["objectives"]["rpc_request_p99"]["observations"])

    counts, series, methods, shed, slow, ring, observed = _same(script)
    assert (("method", "tx"), ("outcome", "error")) in [c[0] for c in counts]
    assert ("made_up_method_xyz",) not in series and ("_other",) in series
    assert methods["health"] == (1, 0, 0) and shed == 1 and slow[:2] == ("abci_query", "ok")
    assert ring == [9.0, 7.0, 5.0] and observed == 4  # the shed one is not a latency


# -- a node through its LocalClient (tests/test_rpc.py:29-254) -----------------

def _local_routes(P, tmp):
    async def go():
        node = make_node(P, tmp)
        await node.start()
        out = {}
        try:
            client = P.client.LocalClient(node)
            res = await client.broadcast_tx_commit(tx="0x" + b"rpc=local".hex())
            out["commit"] = (res["check_tx"], res["deliver_tx"]["code"])
            height = int(res["height"])
            tx = await client.tx(hash=P.tmhash.sum256(b"rpc=local").hex())
            found = await client.tx_search(query=f"tx.height={height}")
            await node.wait_for_height(height + 1)
            bs = await client.block_search(
                query=f"block.height >= {height} AND block.height <= {height}")
            br = await client.block_results(height=height)
            blk = await client.block(height=height)
            byh = await client.block_by_hash(hash=blk["block_id"]["hash"])
            dcs = await client.dump_consensus_state()
            cp = await client.consensus_params()
            assert int(tx["height"]) == height and int(dcs["round_state"]["height"]) >= height
            assert byh["block"]["header"]["height"] == str(height)
            out["reads"] = (found["total_count"], bs["total_count"], br["txs_results"],
                            sorted(dcs["round_state"]), dcs["peers"],
                            cp["consensus_params"]["block"])
            # check_tx: CheckTx without admission
            ok = await client.call("check_tx", tx="0x" + b"k=v".hex())
            bad = await client.call("check_tx", tx="")
            out["check_tx"] = (ok, bad, node.mempool.size())
            # the unsafe routes are gated
            gated = []
            for method in ("unsafe_flush_mempool", "unsafe_dump_stacks", "dial_seeds"):
                try:
                    await client.call(method)
                except Exception as e:
                    gated.append(str(e))
            # the device profiler route: status open, start gated, a bad action refused
            status = await client.call("debug_device_profile")
            for params in ({"action": "start"}, {"action": "bogus"}):
                try:
                    await client.call("debug_device_profile", **params)
                except Exception as e:
                    gated.append(str(e))
            out["profile"] = (sorted(status), status["active"])
            node.config.rpc.unsafe = True
            node.mempool.check_tx(b"w=1")
            size_before = node.mempool.size()
            await client.call("unsafe_flush_mempool")
            stacks = await client.call("unsafe_dump_stacks")
            first = await client.call("unsafe_dump_heap")
            second = await client.call("unsafe_dump_heap", top=10)
            import tracemalloc

            tracemalloc.stop()
            try:
                await client.call("dial_peers", peers="a,b")
            except Exception as e:
                gated.append(str(e))
            out["unsafe"] = (gated, size_before, node.mempool.size(), bool(stacks["threads"]),
                             bool(stacks["tasks"]), first, second["tracing_started"],
                             len(second["top"]) <= 10, sorted(second))
            # broadcast_evidence: a duplicate vote of the node's own key
            priv = node.priv_validator
            addr = priv.get_pub_key().address()
            psh = P.basic.PartSetHeader(total=1, hash=b"\x41" * 32)

            def mkvote(bid):
                v = P.vote.Vote(type=P.basic.SignedMsgType.PREVOTE, height=node.consensus.rs.height,
                                round=0, block_id=bid, timestamp_ns=1_700_000_000_000_000_000,
                                validator_address=addr, validator_index=0)
                return dataclasses.replace(v, signature=priv.priv_key.sign(v.sign_bytes("rpc-chain")))

            ev = P.evidence.DuplicateVoteEvidence.from_votes(
                mkvote(P.basic.BlockID(b"\x42" * 32, psh)), mkvote(P.basic.BlockID(b"\x43" * 32, psh)),
                1_700_000_000_000_000_000, node.state.validators.total_voting_power(), 10)
            res = await client.broadcast_evidence(evidence="0x" + ev.encode().hex())
            out["evidence"] = (res["hash"] == ev.hash().hex().upper(),
                               len(node.evidence_pool.pending_evidence(-1)))
            out["net_info"] = await client.net_info()
        finally:
            await node.stop()
        return out

    return asyncio.run(go())


def test_routes_via_local_client(tmp_path):
    out = _same(_local_routes, tmp_path)
    assert out["commit"] == ({"code": 0, "log": ""}, 0)
    assert out["check_tx"][0]["code"] == 0 and out["check_tx"][1]["code"] == 1
    assert out["check_tx"][2] == 0
    assert all("unsafe" in g for g in out["unsafe"][0][:4]) and out["unsafe"][2] == 0
    assert "unknown action" in out["unsafe"][0][4] and out["profile"][1] is False
    assert out["evidence"] == (True, 1)


# -- the HTTP client end to end, the debug pages, the websocket client ---------
# (tests/test_rpc.py:70-104, :256-344, :370-411)

def _http_script(P, tmp):
    def edit(cfg):
        cfg.instrumentation.trace_enabled = True

    async def go():
        node = make_node(P, tmp, rpc=True, edit=edit)
        await node.start()
        client = P.client.HTTPClient(url_of(node))
        out = {}
        try:
            st = await client.status()
            res = await client.broadcast_tx_commit(b"rpc=http")
            q = await client.abci_query("/store", b"rpc")
            ni = await client.net_info()
            with pytest.raises(P.client.RPCError) as ei:
                await client.call("nonexistent_route")
            out["http"] = (st["node_info"]["network"], res["deliver_tx"]["code"],
                           base64.b64decode(q["response"]["value"]), ni, str(ei.value))
            # a CPU-backend flush, then the flight recorder and the stats
            priv = node.priv_validator
            pk = priv.get_pub_key().bytes()
            msgs = [b"dbg-%d" % i for i in range(7)]
            sigs = [priv.priv_key.sign(m) for m in msgs]
            assert P.batch.verify_batch([pk] * 7, msgs, sigs, backend="cpu").all()
            async with aiohttp.ClientSession() as sess:
                async with sess.get(url_of(node) + "/debug/trace") as resp:
                    body = (await resp.json())["result"]
                async with sess.get(url_of(node) + "/debug/trace?limit=2") as resp:
                    limited = (await resp.json())["result"]
                async with sess.get(url_of(node) + "/debug/verify_stats") as resp:
                    stats = (await resp.json())["result"]
            flush = next(e for e in body["events"] if e["name"] == "verify_batch"
                         and e.get("attrs", {}).get("n") == 7)
            children = [e["name"] for e in body["events"] if e.get("parent") == flush["span"]]
            out["trace"] = (body["enabled"], body["ring_size"], flush["attrs"]["path"],
                            flush["attrs"]["backend"], "batch_verify.flush" in children,
                            limited["count"] <= 2, stats["totals"]["cpu/cpu"]["flushes"] >= 1,
                            {"backend", "path", "n", "total_ms"} <= set(stats["last_flush"]),
                            "device" in stats and "stage_seconds" in stats)
            local = P.client.LocalClient(node)
            dump = await local.call("debug_trace", limit=5)
            vs = await local.call("debug_verify_stats")
            out["local"] = (dump["count"] <= 5, vs["totals"]["cpu/cpu"]["sigs"] >= 7)
            # websocket: NewBlock events, calls on the same socket, wait_for_tx
            sub = await client.subscribe("tm.event = 'NewBlock'")
            ev = await asyncio.wait_for(sub.next(), 30)
            ws = await client._ws_events()
            st2 = await ws.call("status")
            tx = b"ws=commit"
            waiter = asyncio.create_task(client.wait_for_tx(P.tmhash.sum256(tx), timeout=30))
            await asyncio.sleep(0.05)
            await client.broadcast_tx_sync(tx)
            ev_tx = await waiter
            ev2 = await asyncio.wait_for(sub.next(), 30)
            await sub.unsubscribe()
            out["ws"] = (ev["events"]["tm.event"], st2["node_info"]["network"],
                         ev_tx["events"]["tx.hash"], ev2["events"]["tm.event"])
        finally:
            await client.close()
            await node.stop()
        return out

    return asyncio.run(go())


def test_http_client_debug_pages_and_websocket(tmp_path):
    from tendermint_tpu.libs import trace as rtrace

    try:
        out = _same(_http_script, tmp_path)
    finally:  # both nodes configured the process-global recorders
        rtrace.tracer.configure(enabled=True, ring_size=rtrace.DEFAULT_RING_SIZE)
        PORT.trace.tracer.configure(enabled=True, ring_size=PORT.trace.DEFAULT_RING_SIZE)
    assert out["http"][:3] == ("rpc-chain", 0, b"http") and "not found" in out["http"][4]
    assert out["trace"] == (True, 4096, "cpu", "cpu", True, True, True, True, True)
    assert out["local"] == (True, True)
    assert out["ws"] == (["NewBlock"], "rpc-chain",
                         [REF.tmhash.sum256(b"ws=commit").hex().upper()], ["NewBlock"])


# -- the tx lifecycle routes (tests/test_txtrace.py:454-540) -------------------

def _txtrace_script(P, tmp):
    async def go():
        node = make_node(P, tmp / "on", seed=b"\x10" * 32, chain="txtrace-e2e")
        await node.start()
        client = P.client.LocalClient(node)
        out = {}
        try:
            await node.wait_for_height(1)
            res = await client.call("broadcast_tx_sync", tx="0x" + b"k1=v1".hex())
            deadline = time.monotonic() + 30
            wf = None
            while time.monotonic() < deadline:
                wf = await client.call("tx_status", hash=res["hash"])
                if wf.get("terminal") == "delivered" and "indexed" in wf:
                    break
                await asyncio.sleep(0.05)
            offsets = [s["offset_ms"] for s in wf["stages"]]
            by = {s["stage"]: s for s in wf["stages"]}
            out["waterfall"] = ([s["stage"] for s in wf["stages"]], offsets == sorted(offsets),
                                wf["complete"], wf["found"], by["received"]["via"],
                                by["delivered"]["code"], wf["indexed"]["code"])
            nf = await client.call("tx_status", hash="ab" * 32)
            out["unknown"] = nf
            st = await client.call("debug_tx_trace")
            rpc_doc = await client.call("debug_rpc")
            slo_doc = await client.call("debug_slo")
            text = node.metrics.expose()
            out["docs"] = (st["tracked"] >= 1, st["terminals"].get("delivered", 0) >= 1,
                           "committed" in st["stage_percentiles"],
                           rpc_doc["methods"]["broadcast_tx_sync"]["count"],
                           {"tx_commit_latency", "rpc_request_p99"} <= set(slo_doc["objectives"]),
                           'tendermint_tx_terminal_total{outcome="delivered"} ' in text,
                           'tendermint_rpc_requests_total{method="tx_status", outcome="ok"}' in text)
        finally:
            await node.stop()

        node = make_node(P, tmp / "off", seed=b"\x11" * 32, chain="txtrace-off",
                         edit=lambda cfg: setattr(cfg.instrumentation, "txtrace_enabled", False))
        await node.start()
        client = P.client.LocalClient(node)
        try:
            out["disabled"] = (node.tx_tracker, await client.call("debug_tx_trace"),
                               await client.call("tx_status", hash="ab" * 32))
        finally:
            await node.stop()
        return out

    return asyncio.run(go())


def test_tx_status_waterfall_unknown_hash_and_disabled_tracker(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for d in ("on", "off"):
        (tmp_path / d).mkdir()
    out = _same(_txtrace_script, tmp_path)
    assert out["waterfall"] == (["received", "checked", "admitted", "proposed", "committed",
                                 "delivered"], True, True, True, "rpc", 0, 0)
    assert out["unknown"]["found"] is False and "reason" in out["unknown"]
    assert out["docs"] == (True, True, True, 1, True, True, True)
    assert out["disabled"][0] is None and out["disabled"][1] == {"enabled": False}


# -- the gRPC broadcast API (tests/test_abci_grpc.py:113) ----------------------

def _grpc_script(P, tmp):
    import grpc as grpclib

    grpc_api = importlib.import_module(P.server.__name__.replace("server", "grpc_api"))
    pw = P.protowire

    def edit(cfg):
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"

    async def go():
        node = make_node(P, tmp, seed=b"\x73" * 32, chain="grpcapi-chain", edit=edit)
        await node.start()
        try:
            port = node.grpc_server.port

            def call(tx):
                w = pw.Writer()
                w.bytes_field(1, tx)
                channel = grpclib.insecure_channel(f"127.0.0.1:{port}")
                try:
                    ping = channel.unary_unary(f"/{grpc_api._SERVICE}/Ping",
                                               request_serializer=lambda b: b,
                                               response_deserializer=lambda b: b)
                    stub = channel.unary_unary(f"/{grpc_api._SERVICE}/BroadcastTx",
                                               request_serializer=lambda b: b,
                                               response_deserializer=lambda b: b)
                    return ping(b"", timeout=10), stub(w.bytes(), timeout=30)
                finally:
                    channel.close()

            loop = asyncio.get_running_loop()
            ok = await loop.run_in_executor(None, call, b"gapi=ok")
            bad = await loop.run_in_executor(None, call, b"")  # kvstore refuses an empty tx
            return [(p, [(f, list(pw.Reader(v))) for f, _, v in pw.Reader(raw)])
                    for p, raw in (ok, bad)]
        finally:
            await node.stop()

    return asyncio.run(go())


def test_grpc_broadcast_api(tmp_path):
    (ping, ok), (_, bad) = _same(_grpc_script, tmp_path)
    assert ping == b"" and [f for f, _ in ok] == [1, 2]
    assert all(v != 0 for f, _, v in bad[0][1] if f == 1)  # check_tx's code is set


# -- signed txs over RPC: the mempool's admission lane ---------------------------

def _signed_script(P, tmp, envelopes):
    async def go():
        node = make_node(P, tmp, abci="signed_kvstore")
        await node.start()
        client = P.client.LocalClient(node)
        try:
            await node.wait_for_height(1)
            sync = [await client.call("broadcast_tx_sync", tx="0x" + e.hex())
                    for e in envelopes[:-2]]
            commits = [await client.call("broadcast_tx_commit", tx="0x" + e.hex())
                       for e in envelopes[-2:]]
            # the lane's flushes also recheck what stays in the mempool after
            # each block, so their count depends on block timing: held to
            # at least one row a tx on each package, not compared
            lane = [f["rows"]["admission"] for f in list(node.scheduler.flush_log)
                    if "admission" in f["rows"]]
            assert len(lane) >= 1 and sum(lane) >= len(envelopes)
            assert node.mempool.prechecked_total >= len(envelopes)
            return ([(r["code"], r["log"]) for r in sync],
                    [(r["check_tx"], r["deliver_tx"].get("code")) for r in commits],
                    node.app.serial_verifies)
        finally:
            await node.stop()

    return asyncio.run(go())


def test_signed_txs_over_rpc(tmp_path):
    privs = [REF.keys.gen_ed25519(bytes([k + 1]) * 32) for k in range(4)]
    envs = [REF.signed_tx.encode_signed_tx(privs[i % 4], b"s%d=%d" % (i, i)) for i in range(12)]
    sig_at = len(REF.signed_tx.MAGIC) + REF.signed_tx.PUBKEY_LEN
    for i in (2, 7, 10):  # a flipped signature byte
        raw = bytearray(envs[i])
        raw[sig_at + 5] ^= 1
        envs[i] = bytes(raw)
    sync, commits, serial = _same(_signed_script, tmp_path, envs)
    bad = (11, "invalid tx signature")
    assert sync == [(0, ""), (0, ""), bad, (0, ""), (0, ""), (0, ""), (0, ""), bad, (0, ""), (0, "")]
    assert commits == [({"code": 11, "log": "invalid tx signature"}, None),
                       ({"code": 0, "log": ""}, 0)]
    assert serial == 0  # the app consumed the lane's verdicts and verified nothing itself
