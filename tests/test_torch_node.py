"""The port's standalone Node end to end (tests/test_node_e2e.py:49-114), on
the CPU (`device="cpu"`, SQLite stores in tmp_path), held against the JAX
package with tolerance 0:

- a single-validator node produces linked blocks whose commits verify, and
  commits kvstore txs (queried back, indexed, gone from the mempool);
- the reference's BlockExecutor replays the port's committed blocks on a
  fresh reference kvstore app to the port's app hashes and State bytes;
- the reference's StateStore, BlockStore and Handshaker open the port's
  SQLite files at the same height and app hash, and the port's node
  restarts from them and keeps going;
- a `signed_kvstore` node with the scheduler on admits a 300-tx signed
  flood through check_tx_batch (one admission-lane flush; the app consumes
  every verdict and verifies nothing itself), and the txs commit;
- a config that asks for an unported server raises NotImplementedError;
  the RPC server, the gRPC broadcast API and the Prometheus listener each
  start on a free port of 127.0.0.1 and answer; a failed prewarm is raised
  by wait_for_height and stop, not swallowed.
"""

import asyncio
import os

import pytest

from tendermint_tpu_torch.config import test_config
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import gen_ed25519
from tendermint_tpu_torch.node.node import Node
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tests.test_torch_consensus_util import Pkg

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")  # the reference's host arm, as its tests run

REF, PORT = Pkg("ref"), Pkg("port")
CHAIN = "e2e-chain"
SEED32 = b"\x42" * 32
GENESIS_TIME = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _config(root=None, abci="kvstore"):
    cfg = test_config()
    cfg.rpc.laddr = ""  # no RPC server (test_config keeps the reference's 26657)
    cfg.base.abci = abci
    cfg.base.db_backend = "sqlite" if root else "memdb"
    cfg.root_dir = str(root) if root else ""
    cfg.instrumentation.forensics_dir = ""
    return cfg


def _genesis():
    return GenesisDoc(chain_id=CHAIN, genesis_time_ns=GENESIS_TIME,
                      validators=[GenesisValidator(gen_ed25519(SEED32).pub_key(), 10)])


def _node(root=None, abci="kvstore", **kw):
    # a fresh FilePV a node: its last-sign state lives in memory only
    return Node(_config(root, abci), _genesis(), priv_validator=FilePV(gen_ed25519(SEED32)),
                device="cpu", **kw)


async def _until_committed(node, txs, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    want = set(txs)
    while loop.time() < deadline:
        seen = set()
        for h in range(1, node.block_store.height + 1):
            seen.update(node.block_store.load_block(h).txs)
        if want <= seen:
            return
        await asyncio.sleep(0.02)
    raise TimeoutError("txs never committed")


def test_node_produces_blocks_and_commits_txs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    async def run():
        node = _node()
        await node.start()
        try:
            await node.wait_for_height(1)
            assert node.mempool.check_tx(b"name=satoshi").code == 0
            await _until_committed(node, [b"name=satoshi"])
            await node.wait_for_height(3)
            b2, b3 = node.block_store.load_block(2), node.block_store.load_block(3)
            assert b3.header.last_block_id.hash == b2.hash()
            meta = node.block_store.load_block_meta(3)
            node.state_store.load_validators(3).verify_commit(
                CHAIN, meta[0], 3, node.block_store.load_seen_commit(3), device="cpu")
            res = node.proxy_app.query.query(
                PORT.abci.RequestQuery(data=b"name", path="/store"))
            assert res.value == b"satoshi" and node.mempool.size() == 0
            for _ in range(100):
                if node.tx_indexer.get(PORT.tmhash.sum256(b"name=satoshi")) is not None:
                    break
                await asyncio.sleep(0.02)
            assert node.tx_indexer.get(PORT.tmhash.sum256(b"name=satoshi")) is not None
            assert node.consensus.halt_error is None
        finally:
            await node.stop()

    asyncio.run(run())


def _ref_replay(port_blocks, genesis_json):
    """The port's blocks through the reference's BlockExecutor on a fresh
    reference kvstore app; returns (app hash after each block, final State
    JSON)."""
    gen = REF.genesis.GenesisDoc.from_json(genesis_json)
    gen.validate_and_complete()
    state = REF.sm_state.state_from_genesis(gen)
    app = REF.kvstore.KVStoreApplication()
    proxy = REF.multi.AppConns(REF.multi.local_client_creator(app))
    store = REF.state_store.StateStore(REF.kvdb.MemDB())
    bstore = REF.blockstore.BlockStore(REF.kvdb.MemDB())
    state = REF.replay.Handshaker(store, state, bstore, gen).handshake(proxy)
    ex = REF.execution.BlockExecutor(store, proxy.consensus,
                                     REF.mempool.Mempool(proxy.mempool), None,
                                     block_store=bstore)
    hashes = []
    for raw in port_blocks:
        block = REF.block.Block.decode(raw)
        parts = REF.part_set.PartSet.from_data(raw)
        state = ex.apply_block(state, REF.basic.BlockID(block.hash(), parts.header), block)
        hashes.append(state.app_hash)
    return hashes, state.to_json()


def test_reference_replays_and_opens_the_ports_stores(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = tmp_path / "home"
    (root / "data").mkdir(parents=True)
    txs = [b"k%d=v%d" % (i, i) for i in range(6)]

    async def run1():
        node = _node(root)
        await node.start()
        try:
            await node.wait_for_height(1)
            for tx in txs:
                assert node.mempool.check_tx(tx).code == 0
            await _until_committed(node, txs)
            await node.wait_for_height(node.block_store.height + 1)
        finally:
            await node.stop()
        # read back from the files the stopped node left
        dbs = {n: PORT.kvdb.SQLiteDB(str(root / "data" / f"{n}.db")) for n in ("state", "blockstore")}
        try:
            bs = PORT.blockstore.BlockStore(dbs["blockstore"])
            blocks = [bs.load_block(h).encode() for h in range(1, bs.height + 1)]
            state = PORT.state_store.StateStore(dbs["state"]).load().to_json()
        finally:
            for db in dbs.values():
                db.close()
        return blocks, state, node.genesis.to_json()

    blocks, port_state, gen_json = asyncio.run(run1())
    hashes, ref_state = _ref_replay(blocks, gen_json)
    # the app hash after block h is block h+1's header app hash
    assert hashes[:-1] == [REF.block.Block.decode(b).header.app_hash for b in blocks[1:]]
    assert ref_state == port_state

    # the reference opens the port's SQLite files
    dbs = [REF.kvdb.SQLiteDB(str(root / "data" / f"{n}.db")) for n in ("state", "blockstore")]
    try:
        ref_state_store, ref_bstore = REF.state_store.StateStore(dbs[0]), REF.blockstore.BlockStore(dbs[1])
        st = ref_state_store.load()
        assert st.to_json() == port_state
        assert ref_bstore.height == st.last_block_height == len(blocks)
        assert [ref_bstore.load_block(h).encode() for h in range(1, len(blocks) + 1)] == blocks
        gen = REF.genesis.GenesisDoc.from_json(gen_json)
        app = REF.kvstore.KVStoreApplication()
        out = REF.replay.Handshaker(ref_state_store, st, ref_bstore, gen).handshake(
            REF.multi.AppConns(REF.multi.local_client_creator(app)))
        assert out.app_hash == st.app_hash and app.size == len(txs)
    finally:
        for db in dbs:
            db.close()

    async def run2():
        node = _node(root)
        assert node.state.last_block_height == node.block_store.height == len(blocks)
        await node.start()
        try:
            await node.wait_for_height(len(blocks) + 2)
        finally:
            await node.stop()
        return node.app.size

    assert asyncio.run(run2()) == len(txs)


def test_signed_flood_admits_through_the_lane_and_commits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    privs = [REF.keys.gen_ed25519(bytes([k + 1]) * 32) for k in range(16)]
    txs = [REF.signed_tx.encode_signed_tx(privs[i % 16], b"f%d=%d" % (i, i)) for i in range(300)]

    async def run():
        node = _node(abci="signed_kvstore")
        assert node.mempool.sig_precheck and node.scheduler is not None
        await node.start()
        try:
            await node.wait_for_height(1)
            loop = asyncio.get_running_loop()
            res = await loop.run_in_executor(None, node.mempool.check_tx_batch, txs)
            assert [r.code for r in res] == [0] * 300
            await _until_committed(node, txs)
            adm = [f["rows"]["admission"] for f in list(node.scheduler.flush_log)
                   if "admission" in f["rows"]]
            return (adm[0], node.app.serial_verifies, node.app.precheck_consumed >= 300,
                    node.mempool.prechecked_total >= 300, node.consensus.halt_error)
        finally:
            await node.stop()

    assert asyncio.run(run()) == (300, 0, True, True, None)


@pytest.mark.parametrize("key,value", [
    ("p2p.laddr", "tcp://0.0.0.0:26656"),
    ("statesync.enable", True), ("base.proxy_app", "tcp://127.0.0.1:26658"),
    ("base.priv_validator_addr", "tcp://127.0.0.1:26659"),
])
def test_unported_servers_refuse(key, value):
    cfg = _config()
    section, field = key.split(".")
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        Node(cfg, _genesis(), priv_validator=FilePV(gen_ed25519(SEED32)), device="cpu")


@pytest.mark.parametrize("server", ["rpc", "grpc", "prometheus"])
def test_servers_start_and_answer(server, tmp_path, monkeypatch):
    """Each server the config asks for starts with the node on a free port
    of 127.0.0.1 and answers: the RPC server's `health`, the gRPC API's
    Ping, the Prometheus listener's /metrics."""
    import aiohttp

    monkeypatch.chdir(tmp_path)
    cfg = _config()
    if server == "rpc":
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
    elif server == "grpc":
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
    else:
        cfg.instrumentation.prometheus = True
        cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    node = Node(cfg, _genesis(), priv_validator=FilePV(gen_ed25519(SEED32)), device="cpu")

    def ping(port):
        import grpc

        from tendermint_tpu_torch.rpc.grpc_api import _SERVICE

        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            return ch.unary_unary(f"/{_SERVICE}/Ping", request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)(b"", timeout=10)

    async def run():
        await node.start()
        try:
            if server == "grpc":
                return await asyncio.get_running_loop().run_in_executor(
                    None, ping, node.grpc_server.port)
            srv = node.rpc_server if server == "rpc" else node.prometheus_server
            path = "/health" if server == "rpc" else "/metrics"
            async with aiohttp.ClientSession() as sess:
                async with sess.get(f"http://127.0.0.1:{srv.port}{path}") as resp:
                    return resp.status, await resp.text()
        finally:
            await node.stop()

    out = asyncio.run(run())
    if server == "grpc":
        assert out == b""
    elif server == "rpc":
        assert out == (200, '{"jsonrpc": "2.0", "id": null, "result": {}}')
    else:
        assert out[0] == 200 and "tendermint_consensus_height" in out[1]


def test_failed_prewarm_is_raised(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def broken(*a, **kw):
        raise RuntimeError("build failed")

    monkeypatch.setattr(tbatch, "backend_default", lambda: "cuda")
    monkeypatch.setattr(tbatch, "prewarm", broken)

    async def run():
        node = _node()
        await node.start()
        try:
            with pytest.raises(RuntimeError, match="prewarm failed"):
                await node.wait_for_height(50)
        finally:
            with pytest.raises(RuntimeError, match="prewarm failed"):
                await node.stop()
        return node.prewarm_error

    assert isinstance(asyncio.run(run()), RuntimeError)
