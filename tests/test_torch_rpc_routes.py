"""Every read route of the port's RPC server against the reference's, on the
same stores, through each package's LocalClient (tolerance 0: the JSON
equal byte for byte).

A port node (one validator, kvstore app, SQLite stores in tmp_path) commits
a few heights of txs and stops. Each package then opens its own copy of
those files as a full node (no priv validator, so no block is added while
the routes are read): the reference's Node and RPCServer over one copy, the
port's over the other (the port's restart). Both replay the kvstore app to
the last height in their Handshakers.

Fields that carry wall-clock time are named and left out: light_status's
`stage_percentiles` (per-request stage latencies of this process). Every
other field of every route is compared. A second test calls every route of
the table through the port's LocalClient.
"""

import asyncio
import json
import shutil

import pytest

from tests.torch_rpc_util import PORT, REF, make_node

TXS = [b"k%d=v%d" % (i, i) for i in range(6)] + [b"bare-key"]
WALL_CLOCK = {"light_status": ("stage_percentiles",)}


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """The port node's SQLite files after a few heights of txs."""
    tmp = tmp_path_factory.mktemp("rpc-routes")
    root = tmp / "home"
    (root / "data").mkdir(parents=True)

    async def go():
        node = make_node(PORT, tmp, root=root)
        await node.start()
        try:
            await node.wait_for_height(1)
            for tx in TXS:
                assert node.mempool.check_tx(tx).code == 0
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30
            while node.mempool.size() and loop.time() < deadline:
                await asyncio.sleep(0.02)
            await node.wait_for_height(node.block_store.height + 2)
            for _ in range(200):  # the indexer runs behind the commit
                if all(node.tx_indexer.get(PORT.tmhash.sum256(tx)) for tx in TXS):
                    break
                await asyncio.sleep(0.02)
        finally:
            await node.stop()

    asyncio.run(go())
    return root


def _calls(height: int, tx_height: int, block_hash: str) -> list:
    tx_hash = REF.tmhash.sum256(TXS[0]).hex()
    return [
        ("block", {"height": 2}), ("block", {}), ("blockchain", {}),
        ("blockchain", {"minHeight": 1, "maxHeight": 2}),
        ("block_by_hash", {"hash": block_hash}), ("block_results", {"height": tx_height}),
        ("commit", {"height": 2}),  # canonical: block 3 carries it
        ("commit", {"height": height}),  # the seen commit
        ("validators", {}), ("validators", {"height": 1}), ("genesis", {}),
        ("tx", {"hash": tx_hash}), ("tx_search", {"query": f"tx.height={tx_height}"}),
        ("tx_search", {"query": "app.key='k3'"}),
        ("tx_search", {"query": "app.creator='tendermint_tpu'", "per_page": 2, "page": 2}),
        ("block_search", {"query": f"block.height >= 2 AND block.height <= {height}"}),
        ("block_search", {"query": "block.height = 1"}),
        ("consensus_params", {}), ("consensus_params", {"height": 1}),
        ("abci_query", {"path": "/store", "data": b"k3".hex()}),
        ("abci_query", {"path": "/store", "data": b"missing".hex()}),
        ("abci_info", {}), ("num_unconfirmed_txs", {}), ("unconfirmed_txs", {}),
        ("light_block", {"height": 1}), ("light_verify", {"height": height}),
        ("light_verify", {"height": 2, "hash": block_hash}), ("light_block", {"height": 2}),
        ("light_status", {}), ("debug_mesh", {}), ("debug_index", {}), ("status", {}),
        ("health", {}), ("net_info", {}),
    ]


async def _answers(P, node, calls):
    client = P.client.LocalClient(node)
    out = []
    for method, params in calls:
        res = await client.call(method, **params)
        for field in WALL_CLOCK.get(method, ()):
            res.pop(field)
        out.append((method, json.dumps(res, sort_keys=False)))
    # an error's code and message from the same route
    for method, params in (("block", {"height": 999}), ("light_verify", {"hash": "zz"}),
                           ("tx", {"hash": "ab" * 32})):
        try:
            await client.call(method, **params)
            out.append((method, "no error"))
        except Exception as e:  # the handler's exception, as _dispatch re-raises it
            out.append((method, f"{type(e).__name__}: {e} {getattr(e, 'code', '')}"))
    return out


def test_read_routes_equal_on_the_same_stores(home, tmp_path, monkeypatch):
    # the reference's /debug/mesh reads process-global mesh telemetry and
    # health: a fresh, single-device state, as a node process starts with
    from tendermint_tpu.parallel import health, telemetry

    telemetry.reset()
    monkeypatch.setattr(health, "MESH_HEALTH", health.MeshHealthManager())
    roots = {}
    for P in (REF, PORT):
        roots[P.which] = tmp_path / P.which
        shutil.copytree(home, roots[P.which])

    async def read(P):
        node = make_node(P, tmp_path, root=roots[P.which], priv=False)
        height = node.block_store.height
        tx_height = next(h for h in range(1, height + 1)
                         if TXS[0] in node.block_store.load_block(h).txs)
        block_hash = node.block_store.load_block(2).hash().hex().upper()
        await node.start()
        try:
            assert node.block_store.height == height >= 4
            return height, await _answers(P, node, _calls(height, tx_height, block_hash))
        finally:
            await node.stop()

    ref_h, ref = asyncio.run(read(REF))
    port_h, port = asyncio.run(read(PORT))
    assert port_h == ref_h
    assert [m for m, _ in port] == [m for m, _ in ref]
    for (method, want), (_, got) in zip(ref, port):
        assert got == want, method


def test_every_route_answers_through_the_local_client(home, tmp_path, monkeypatch):
    """The port's route table is the reference's, name for name, and every
    route answers through the port's LocalClient: a result, or (dial_seeds,
    dial_peers, on a node without p2p) the reference's structured refusal."""
    monkeypatch.chdir(tmp_path)
    shutil.copytree(home, tmp_path / "port")
    params = {
        "broadcast_tx_async": {"tx": "0x" + b"r=1".hex()},
        "broadcast_tx_sync": {"tx": "0x" + b"r=2".hex()},
        "check_tx": {"tx": "0x" + b"r=3".hex()},
        "tx": {"hash": PORT.tmhash.sum256(TXS[0]).hex()},
        "tx_search": {"query": "app.key='k1'"}, "block_search": {"query": "block.height = 2"},
        "block_by_hash": {"hash": ""}, "tx_status": {"hash": "ab" * 32},
        "broadcast_evidence": {"evidence": ""}, "light_verify": {"height": 2},
        "light_block": {"height": 2}, "abci_query": {"path": "/store", "data": b"k1".hex()},
    }
    refused = {"dial_seeds": "p2p is not enabled", "dial_peers": "p2p is not enabled",
               "broadcast_evidence": "", "block_by_hash": "not found"}

    async def go():
        node = make_node(PORT, tmp_path, root=tmp_path / "port", priv=False)
        node.config.rpc.unsafe = True
        await node.start()
        try:
            server = PORT.client.LocalClient(node)._server
            ref_cfg = REF.config.test_config()
            ref_cfg.rpc.laddr = "tcp://127.0.0.1:0"
            ref_routes = REF.server.RPCServer(type("N", (), {"config": ref_cfg})())._routes
            assert sorted(server._routes) == sorted(ref_routes)
            out = {}
            for method in sorted(server._routes):
                if method == "broadcast_tx_commit":
                    continue  # waits for a block, which a full node does not make
                try:
                    res = await PORT.client.LocalClient(node).call(method, **params.get(method, {}))
                    out[method] = isinstance(res, dict)
                except Exception as e:
                    out[method] = refused.get(method) is not None and refused[method] in str(e)
            import tracemalloc

            if tracemalloc.is_tracing():
                tracemalloc.stop()
            return out
        finally:
            await node.stop()

    out = asyncio.run(go())
    assert out and all(out.values()), {m: ok for m, ok in out.items() if not ok}
