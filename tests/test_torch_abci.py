"""The port's ABCI layer, kvstore app, mempool core and pub/sub against the
JAX package's, on the same seeded inputs (tolerance 0): app hashes and
query answers, LocalClient's answers to every method, InitChain's
validators through the Handshaker, the mempool's admission, reaping, update
and recheck, and pub/sub query matching over a table of queries and events.
"""

import asyncio
import dataclasses
import os

import numpy as np
import pytest

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.libs import metrics as tmetrics
from tests.test_torch_consensus_util import Pkg, seeds

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261020


def _txs(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k, v = rng.bytes(int(rng.integers(1, 9))).hex(), rng.bytes(int(rng.integers(0, 12))).hex()
        out.append(f"{k}={v}".encode() if i % 4 else k.encode())
    return out


def _plain(x):
    """A response as plain data, so the two packages' dataclasses compare."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _drive_app(P, txs, queries):
    """Three blocks of txs through a LocalClient, every method called once
    per block; returns each answer as plain data."""
    A = P.abci
    app = P.kvstore.KVStoreApplication(snapshot_interval=2)
    c = P.client.LocalClient(app)
    out = [_plain(c.info(A.RequestInfo(version="0.1.0"))),
           _plain(c.set_option(A.RequestSetOption("k", "v"))), c.echo("hi")]
    for h, block in enumerate((txs[:5], txs[5:11], txs[11:]), start=1):
        out.append(_plain(c.begin_block(A.RequestBeginBlock(hash=b"\x01" * 32))))
        out += [_plain(c.check_tx(A.RequestCheckTx(tx=tx))) for tx in block + [b""]]
        out += [_plain(c.deliver_tx(A.RequestDeliverTx(tx=tx))) for tx in block]
        out.append(_plain(c.end_block(A.RequestEndBlock(height=h))))
        out.append(_plain(c.commit()))
        out += [_plain(c.query(A.RequestQuery(data=q, path=p))) for q in queries
                for p in ("/store", "", "/nope")]
    snaps = c.list_snapshots()
    out.append(_plain(snaps))
    for s in snaps.snapshots:
        out += [_plain(c.load_snapshot_chunk(A.RequestLoadSnapshotChunk(s.height, s.format, i)))
                for i in range(s.chunks + 1)]
    fresh = P.client.LocalClient(P.kvstore.KVStoreApplication())
    s = snaps.snapshots[-1]
    out.append(_plain(fresh.offer_snapshot(A.RequestOfferSnapshot(s, app.app_hash))))
    chunk = c.load_snapshot_chunk(A.RequestLoadSnapshotChunk(s.height, s.format, 0)).chunk
    out.append(_plain(fresh.apply_snapshot_chunk(A.RequestApplySnapshotChunk(0, chunk, ""))))
    out.append(_plain(fresh.info(A.RequestInfo())))
    return out, app.app_hash


def test_kvstore_and_local_client_answers():
    txs = _txs(16, SEED)
    queries = [tx.split(b"=")[0] for tx in txs[::3]] + [b"missing"]
    want, jhash = _drive_app(REF, txs, queries)
    got, phash = _drive_app(PORT, txs, queries)
    assert got == want
    assert phash == jhash == (16).to_bytes(8, "big")


def test_init_chain_validators_through_the_handshaker():
    """An app that answers InitChain with its own validator set: the state
    the Handshaker returns (validators, next validators, app hash, params)
    is the same JSON in both packages."""
    keys = seeds(3, SEED + 1)

    def make(P):
        A = P.abci
        upd = [A.ValidatorUpdate("ed25519", P.keys.gen_ed25519(k).pub_key().bytes(), 7 + i)
               for i, k in enumerate(keys)]

        class InitApp(P.kvstore.KVStoreApplication):
            def init_chain(self, req):
                self.seen = (req.chain_id, req.initial_height, len(req.validators),
                             [v.power for v in req.validators])
                return A.ResponseInitChain(validators=upd, app_hash=b"\x07" * 8)

        app = InitApp()
        gen = P.genesis.GenesisDoc(chain_id="init-chain", initial_height=5, validators=[
            P.genesis.GenesisValidator(P.keys.gen_ed25519(k).pub_key(), 10) for k in seeds(2, SEED)])
        gen.validate_and_complete()
        state = P.sm_state.state_from_genesis(gen)
        store = P.state_store.StateStore(P.kvdb.MemDB())
        bs = P.blockstore.BlockStore(P.kvdb.MemDB())
        out = P.replay.Handshaker(store, state, bs, gen).handshake(
            P.multi.AppConns(P.multi.local_client_creator(app)))
        return out.to_json(), app.seen, sorted(store.db.iterate_prefix(b""))

    assert make(PORT) == make(REF)


@pytest.mark.parametrize("recheck", [True, False])
def test_mempool_core(recheck):
    """Admission (the cache, empty and oversized txs, the count and bytes
    limits), reaping by bytes and gas, the post-commit update and recheck,
    on a MempoolConfig carried across by convert. Both pools run with
    `eviction=False`, so a full pool refuses a new tx; priority eviction,
    the default, is held against the reference in
    tests/test_torch_mempool_eviction.py."""
    txs = _txs(24, SEED + 2)
    jcfg = REF.config.MempoolConfig(size=20, max_txs_bytes=400, cache_size=8, recheck=recheck,
                                    max_tx_bytes=30)
    pcfg = convert.mempool_config_from_reference(jcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)

    def run(P):
        cfg = jcfg if P is REF else pcfg
        app = P.kvstore.KVStoreApplication()
        mp = P.mempool.Mempool(P.client.LocalClient(app), max_txs=cfg.size,
                               max_txs_bytes=cfg.max_txs_bytes, cache_size=cfg.cache_size,
                               recheck=cfg.recheck, max_tx_bytes=cfg.max_tx_bytes,
                               eviction=False)
        notified = []
        mp.set_txs_available_callback(lambda: notified.append(mp.size()))
        out = []
        for tx in txs + txs[:3] + [b"", b"x" * 31]:
            try:
                r = mp.check_tx(tx)
                out.append(("ok", r.code))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        out.append(("gossip-dup", mp.check_tx(txs[0], sender="peer-9")))
        out.append(mp.reap_max_bytes_max_gas(120, -1))
        out.append(mp.reap_max_bytes_max_gas(-1, 5))
        out.append(mp.reap_max_txs(3))
        out.append((mp.size(), mp.txs_bytes(), [e[0] for e in mp.entries()]))
        committed = mp.reap_max_txs(4)
        mp.lock()
        try:
            mp.update(1, committed, [P.abci.ResponseDeliverTx(code=i % 2) for i in range(4)])
        finally:
            mp.unlock()
        out.append((mp.size(), mp.txs_bytes(), mp.reap_max_txs(-1), notified))
        for tx in committed:
            try:
                out.append(("ok", mp.check_tx(tx).code))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        mp.flush()
        out.append((mp.size(), mp.txs_bytes(), mp.check_tx(txs[1]).code))
        return out

    assert run(PORT) == run(REF)


QUERIES = [
    "tm.event = 'Tx'", "tm.event = 'NewBlock'", "tx.height = 5", "tx.height > 4",
    "tx.height >= 6", "tx.height < 5", "tx.height <= 5", "app.key CONTAINS 'ab'",
    "app.key EXISTS", "app.creator = 'tendermint_tpu' AND tx.height = 5",
    "transfer.amount > 10.5", "block.time >= TIME 2013-05-03T14:45:00Z",
    "block.time < TIME 2013-05-03T14:45:00+01:00", "block.date = DATE 2013-05-03",
    "missing.key EXISTS", "app.key = \"abc\"", "",
]
EVENTS = [
    {"tm.event": ["Tx"], "tx.height": ["5"], "app.key": ["abc", "zz"],
     "app.creator": ["tendermint_tpu"], "transfer.amount": ["10.75"]},
    {"tm.event": ["NewBlock"], "block.time": ["2013-05-03T14:45:00Z"],
     "block.date": ["2013-05-03"]},
    {"tm.event": ["Tx"], "tx.height": ["6", "4"], "app.key": ["xyz"],
     "transfer.amount": ["3"]},
    {"block.time": ["2013-05-03T13:00:00Z", "not a time"], "tx.height": ["x"]},
]


def test_pubsub_query_table_and_delivery():
    """Every (query, event) pair of the table matches alike; bad queries
    raise alike; subscriptions deliver the same events, in order, with the
    same drop-oldest count on a full buffer, which the port's server also
    counts on the PubSubMetrics it was given."""
    for q in QUERIES:
        jq, pq = REF.pubsub.Query(q), PORT.pubsub.Query(q)
        assert [pq.matches(e) for e in EVENTS] == [jq.matches(e) for e in EVENTS], q
        assert str(pq) == str(jq)
    for bad in ("tm.event ==", "a = 'x' AND", "tx.height ~ 5"):
        with pytest.raises(ValueError) as je:
            REF.pubsub.Query(bad)
        with pytest.raises(ValueError) as pe:
            PORT.pubsub.Query(bad)
        assert str(pe.value) == str(je.value)

    reg = tmetrics.Registry()
    pmetrics = tmetrics.PubSubMetrics(reg)

    def deliver(P):
        async def main():
            srv = P.pubsub.PubSubServer(**({"metrics": pmetrics} if P is PORT else {}))
            subs = [srv.subscribe(f"c{i}", P.pubsub.Query(q), 2)
                    for i, q in enumerate(QUERIES[:6])]
            for i, e in enumerate(EVENTS * 2):
                srv.publish(i, e)
            srv.publish_many([100, 101, 102], EVENTS[0])
            got = []
            for s in subs:
                items = []
                while not s.queue.empty():
                    items.append(s.queue.get_nowait().data)
                got.append((items, s.dropped))
            return got, srv.num_clients(), srv.has_subscribers("Tx")
        return asyncio.run(main())

    got, want = deliver(PORT), deliver(REF)
    assert got == want
    dropped = {labels["subscriber"]: v for name, labels, v in tmetrics.parse_exposition(
        reg.expose())["tendermint_pubsub_dropped_messages_total"]["samples"]}
    assert dropped == {f"c{i}": float(d) for i, (_, d) in enumerate(got[0]) if d}
