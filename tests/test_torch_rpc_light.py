"""The light routes, HTTPProvider and LightProxy of the port against the
reference's, with tolerance 0 (tests/test_light_service.py:416-666,
tests/test_light.py:303):

- a node's light routes under a tx flood, on each package: every request
  answered (verified or 429), consensus keeps committing, only sheddable
  methods shed, the light SLO observed;
- the structured refusals without a node, and a failed flush under
  light_verify: the same JSON-RPC error from both, the flush tried once (no
  retry on the CPU);
- LightProxy: unverified routes forwarded with the marker, and the verified
  commit, validators, block, status and proof-checked abci_query in front of
  a MerkleKVStoreApplication node;
- the light client over HTTPProvider against a port node whose validator
  set changes, the port's client and the reference's reaching the same
  trusted heights and hashes; over HTTPProvider fed a poisoned commit, one
  bad signature (the rest hold > 2/3 of the power) accepted by both and two
  refused by both with the same invalid-commit error.
"""

import asyncio
import base64
import copy
import threading

import aiohttp
import pytest

from tendermint_tpu_torch import convert
from tests.test_light import CHAIN_ID, NOW, PERIOD, make_chain
from tests.torch_rpc_util import BOTH, PORT, REF, make_node, url_of


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, PORT.batch._MEMO = PORT.batch._MEMO, PORT.batch.VerifiedRowMemo(0)
    yield
    PORT.batch._MEMO = prev


def _same(fn, *args):
    ref, port = (fn(P, *args) for P in BOTH)
    assert port == ref
    return ref


def _chain_of(P, blocks):
    """The reference's chain in package P (carried by its bytes)."""
    if P is REF:
        return dict(blocks)
    return {h: convert.light_block_from_reference_bytes(REF.tlight.light_block_to_bytes(lb))
            for h, lb in blocks.items()}


# -- a node's light routes under a flood (tests/test_light_service.py:416) -----

@pytest.mark.parametrize("which", ["ref", "port"])
def test_node_light_routes_under_flood(which, tmp_path):
    P = REF if which == "ref" else PORT

    def edit(cfg):
        cfg.light_service.coalesce_window = 0.01

    async def go():
        node = make_node(P, tmp_path, seed=b"\x95" * 32, chain="light-svc", edit=edit)
        await node.start()
        stop = threading.Event()

        def flooder(k):  # ~1,000 txs/s a thread, so that a test run stays short
            i = 0
            while not stop.is_set():
                try:
                    node.mempool.check_tx(b"lsf-%d-%d=x" % (k, i))
                except Exception:
                    pass
                i += 1
                stop.wait(0.001)

        threads = [threading.Thread(target=flooder, args=(k,), daemon=True) for k in range(3)]
        try:
            await node.wait_for_height(4, timeout=60)
            client = P.client.LocalClient(node)
            h_start = node.block_store.height
            for t in threads:
                t.start()
            answered = 0
            for _ in range(3):
                # at most 10 heights a round: test_config's chain grows
                # by hundreds of heights a second
                for h in range(2, min(max(3, node.block_store.height), 12)):
                    try:
                        res = await client.call("light_verify", height=h)
                        assert res["light_client_verified"] is True
                        assert res["source"] in ("cache", "flush", "bisection")
                        answered += 1
                    except P.client.RPCError as e:
                        assert e.code == -32005
                await asyncio.sleep(0.15)
            assert answered > 0
            await node.wait_for_height(h_start + 2, timeout=60)
            shed = {labels[0] for labels in node.metrics.rpc.shed_requests._values}
            assert shed <= set(P.server.SHEDDABLE_METHODS)
            blk = await client.call("light_block", height=2)
            assert blk["validator_set"]["validators"]
            st = await client.call("light_status")
            assert st["trusted_span"]["last"] >= 2
            dbg = await client.call("debug_light")
            assert dbg["requests"] >= answered
            vs = await client.call("debug_verify_stats")
            assert vs["light"]["requests"] == dbg["requests"]
            idx = await client.call("debug_index")
            assert any(e["path"] == "/debug/light" for e in idx["endpoints"])
            assert node.slo.snapshot()["objectives"]["light_verify_p99"]["observations"] > 0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
            await node.stop()

    asyncio.run(go())


# -- structured refusals, and a device error under light_verify ---------------

def _refusals(P):
    cfg = P.config.test_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    server = P.server.RPCServer(type("N", (), {"config": cfg, "metrics": None})())
    out = []
    try:
        asyncio.run(server._light_status({}))
    except P.service.ErrLightDisabled as e:
        out.append((type(e).__name__, e.code, str(e)))
    try:
        server._decode_hash_param({"hash": "zz"})
    except P.service.ErrBadRequest as e:
        out.append((type(e).__name__, e.code, str(e)))
    try:
        server._decode_hash_param({"hash": "ab" * 5})
    except P.service.ErrBadRequest as e:
        out.append((type(e).__name__, e.code, str(e)))
    out.append(server._decode_hash_param({}))
    out.append(asyncio.run(server._debug_light({})))
    return out


def test_structured_refusals_without_a_node():
    out = _same(_refusals)
    assert [o[:2] for o in out[:3]] == [("ErrLightDisabled", -32013), ("ErrBadRequest", -32602),
                                        ("ErrBadRequest", -32602)]
    assert out[3] is None and out[4] == {"enabled": False}


def _device_error(P, blocks, monkeypatch):
    """light_verify over a LightService whose verify_batch raises, as a
    failed device flush does: the route's JSON-RPC error and the number of
    verify_batch calls."""
    calls = []

    def broken(*a, **kw):
        calls.append(len(a[0]))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(P.batch, "verify_batch", broken)
    cfg = P.config.test_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    kw = {"device": "cpu"} if P is PORT else {}
    svc = P.service.LightService(CHAIN_ID, P.provider.MockProvider(CHAIN_ID, _chain_of(P, blocks)),
                                 P.config.LightServiceConfig(coalesce_window=0.0),
                                 now_ns=lambda: NOW, **kw)
    node = type("N", (), {"config": cfg, "metrics": None, "light_service": svc, "slo": None})()
    server = P.server.RPCServer(node)

    class Req:
        query = {}

        async def json(self):
            return {"jsonrpc": "2.0", "id": 3, "method": "light_verify", "params": {"height": 4}}

    try:
        resp = asyncio.run(server._handle_jsonrpc(Req()))
    finally:
        svc.close()
    return resp.status, resp.text, calls


def test_device_error_surfaces_as_the_routes_error(monkeypatch):
    blocks = make_chain(5)
    ref = _device_error(REF, blocks, monkeypatch)
    port = _device_error(PORT, blocks, monkeypatch)
    assert port == ref
    assert ref[0] == 200 and '"error"' in ref[1] and "illegal memory access" in ref[1]
    assert len(ref[2]) == 1  # one flush, no retry


# -- LightProxy ---------------------------------------------------------------

def _proxy_forwarding(P, blocks):
    class StubBackend:
        async def call(self, method, **params):
            if method == "net_info":
                return {"n_peers": "3"}
            if method == "health":
                return {}
            if method == "num_unconfirmed_txs":
                return ["not-a-dict"]
            if method == "status":
                return {"node_info": {"network": CHAIN_ID}}
            raise AssertionError(f"unexpected backend call {method}")

    kw = {"device": "cpu"} if P is PORT else {}
    lc = P.light.Client(CHAIN_ID, P.light.TrustOptions(PERIOD, 1, blocks[1].hash()),
                        P.provider.MockProvider(CHAIN_ID, _chain_of(P, blocks)), [],
                        P.store.LightStore(P.kvdb.MemDB()), **kw)

    async def go():
        orig = P.light_client._now_ns
        P.light_client._now_ns = lambda: NOW
        proxy = P.proxy.LightProxy(lc, StubBackend())
        try:
            await proxy.start()
            out = []
            async with aiohttp.ClientSession() as sess:
                for method in ("net_info", "health", "num_unconfirmed_txs", "status"):
                    async with sess.post(f"http://{proxy.addr}/", json={
                            "jsonrpc": "2.0", "id": 1, "method": method, "params": {}}) as resp:
                        out.append(await resp.json())
            return out
        finally:
            P.light_client._now_ns = orig
            await proxy.stop()

    return asyncio.run(go())


def test_proxy_forwards_unverified_with_marker():
    blocks = make_chain(6)
    ni, hl, nd, st = (b["result"] for b in _same(_proxy_forwarding, blocks))
    assert ni == {"n_peers": "3", "light_client_verified": False}
    assert hl == {"light_client_verified": False} and nd == ["not-a-dict"]
    assert "light_client_verified" not in st and st["light_client"]["trusted_height"] >= 1


def _proxy_verified(P, tmp):
    async def go():
        node = make_node(P, tmp, seed=b"\x93" * 32, chain="lp-chain", rpc=True,
                         app=P.kvstore.MerkleKVStoreApplication())
        await node.start()
        backend = P.client.HTTPClient(url_of(node))
        proxy = None
        try:
            node.mempool.check_tx(b"lpk=lpv")
            await node.wait_for_height(5, timeout=60)
            provider = P.provider.HTTPProvider("lp-chain", backend)
            root = await provider.light_block(2)
            kw = {"device": "cpu"} if P is PORT else {}
            lc = P.light.Client("lp-chain", P.light.TrustOptions(PERIOD, 2, root.hash()),
                                provider, [], P.store.LightStore(P.kvdb.MemDB()), **kw)
            proxy = P.proxy.LightProxy(lc, backend)
            await proxy.start()
            out = {}
            async with aiohttp.ClientSession() as sess:
                async def call(method, **params):
                    async with sess.post(f"http://{proxy.addr}/", json={
                            "jsonrpc": "2.0", "id": 1, "method": method, "params": params}) as r:
                        return await r.json()

                com = (await call("commit", height=4))["result"]
                vals = (await call("validators", height=4))["result"]
                blk = (await call("block", height=3))["result"]
                st = (await call("status"))["result"]
                ab = (await call("abci_info"))["result"]
                aq = (await call("abci_query", data=b"lpk".hex()))["result"]
                missing = await call("abci_query", data=b"nosuchkey".hex())
            out = (com["light_client_verified"], com["signed_header"]["header"]["height"],
                   vals["light_client_verified"], len(vals["validators"]),
                   blk["light_client_verified"], blk["block"]["header"]["height"],
                   st["light_client"]["trusted_height"] >= 4, ab["light_client_verified"],
                   aq["light_client_verified"], base64.b64decode(aq["response"]["value"]),
                   [op["type"] for op in aq["response"]["proofOps"]["ops"]],
                   missing["error"]["code"], missing["error"]["data"])
            return out
        finally:
            if proxy is not None:
                await proxy.stop()
            await backend.close()
            await node.stop()

    return asyncio.run(go())


def test_light_proxy_serves_verified_routes(tmp_path):
    out = _same(_proxy_verified, tmp_path)
    assert out == (True, "4", True, 1, True, "3", True, False, True, b"lpv", ["simple:v"],
                   -32603, "empty tree (no key or no proof ops)")


# -- the light client over HTTP -------------------------------------------------

def test_light_client_over_http_with_a_changing_set(tmp_path):
    """A port node (persistent_kvstore) adds a validator of power 1 at
    height ~2; each package's light client on its own HTTPProvider trusts
    height 1 and verifies the last height in one skipping step."""
    new_key = REF.keys.gen_ed25519(b"\x33" * 32).pub_key().bytes().hex()

    async def go():
        node = make_node(PORT, tmp_path, seed=b"\x31" * 32, chain="rot-chain", rpc=True,
                         abci="persistent_kvstore")
        await node.start()
        clients = []
        try:
            await node.wait_for_height(1)
            assert node.mempool.check_tx(b"val:" + new_key.encode() + b"!1").code == 0
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30
            while len(node.state_store.load_validators(node.block_store.height).validators) < 2:
                assert loop.time() < deadline
                await asyncio.sleep(0.02)
            top = node.block_store.height  # a block signed under the larger set
            first = node.block_store.load_block(1).hash()
            out = {}
            for P in BOTH:
                c = P.client.HTTPClient(url_of(node))
                clients.append(c)
                kw = {"device": "cpu"} if P is PORT else {}
                lc = P.light.Client("rot-chain", P.light.TrustOptions(PERIOD, 1, first),
                                    P.provider.HTTPProvider("rot-chain", c), [],
                                    P.store.LightStore(P.kvdb.MemDB()), **kw)
                await lc.initialize()
                lb = await lc.verify_light_block_at_height(top)
                out[P.which] = ({h: lc.store.light_block(h).hash() for h in lc.store.heights()},
                                len(lb.validator_set.validators))
            return out, top, {h: node.block_store.load_block_meta(h)[0].hash for h in (1, top)}
        finally:
            for c in clients:
                await c.close()
            await node.stop()

    out, top, ids = asyncio.run(go())
    assert out["port"] == out["ref"] == (ids, 2)
    assert top > 2  # a skipping step over the set change


class _CommitServer:
    """commit(height) / validators(height) answers built from a chain in
    the reference's JSON, with the height-4 commit poisoned: one byte flipped
    in each of the first `bad` signatures."""

    def __init__(self, blocks, bad: int):
        self.blocks, self.bad = blocks, bad

    async def commit(self, height=None):
        lb = self.blocks[height]
        com = {"signed_header": {"header": REF.tlight.header_to_json(lb.header),
                                 "commit": REF.tlight.commit_to_json(lb.signed_header.commit)},
               "canonical": True}
        if height == 4:
            com = copy.deepcopy(com)
            for s in com["signed_header"]["commit"]["signatures"][:self.bad]:
                raw = bytearray(base64.b64decode(s["signature"]))
                raw[7] ^= 1
                s["signature"] = base64.b64encode(bytes(raw)).decode()
        return com

    async def validators(self, height=None):
        lb = self.blocks[height]
        vs = REF.tlight.validator_set_to_json(lb.validator_set)
        return {"block_height": str(height), "validators": vs["validators"],
                "count": str(len(vs["validators"])), "total": str(len(vs["validators"]))}


def _poisoned(P, blocks, bad):
    kw = {"device": "cpu"} if P is PORT else {}
    lc = P.light.Client(CHAIN_ID, P.light.TrustOptions(PERIOD, 1, blocks[1].hash()),
                        P.provider.HTTPProvider(CHAIN_ID, _CommitServer(blocks, bad)), [],
                        P.store.LightStore(P.kvdb.MemDB()), **kw)

    async def go():
        await lc.initialize(NOW)
        try:
            lb = await lc.verify_light_block_at_height(4, NOW)
            return "accepted", lb.hash().hex()
        except Exception as e:
            return type(e).__name__, str(e)

    return asyncio.run(go())


@pytest.mark.parametrize("bad", [1, 2])
def test_poisoned_commit_over_http_provider(bad):
    blocks = make_chain(6)  # 4 validators of power 10
    out = _same(_poisoned, blocks, bad)
    if bad == 1:  # 30 of 40 still signed: more than 2/3, the step passes
        assert out == ("accepted", blocks[4].hash().hex())
    else:
        assert out[0] == "ErrInvalidHeader" and out[1].startswith("invalid commit")
