"""The port's mempool admission control against the JAX package's, on the
reference's defaults (`eviction=True`, no `max_txs_per_sender`), tolerance 0.

C5: a full pool evicts lower- or equal-priority residents, oldest first, to
admit an arrival; both packages admit all five txs of the reproduction and
keep the same last three. Then the scenarios of tests/test_mempool_overload.py
(:62-299), each run on both packages and compared step by step: eviction
order, equal-priority LRU, the refusal when only higher-priority residents
are left, bytes freed, the cache after an eviction, the TTL by blocks and by
seconds (one fake clock patched into both mempool modules), sender quotas
(gossip, not RPC) and `penalize_sender`, the too-large and cache reasons,
the full gauge, and the WAL (the port replays a WAL the reference wrote to
the same residents, a torn tail stops both at the same tx, and the bytes
the port writes equal the reference's). Each step records the resident
order, the codes or the error's type and reason, and the end of a scenario
the counters and the metrics exposition (parse_exposition).
"""

import os

import pytest

from tests.test_torch_consensus_util import Pkg

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
T0 = 1_700_000_000_000_000_000


class PrioApp:
    """The reference test's CheckTx stub: b'p7:payload' has priority 7; every
    tx is accepted unless it starts with b'bad'."""

    def __init__(self, P):
        self.abci = P.abci
        self.calls = 0

    def check_tx(self, req):
        self.calls += 1
        tx, prio = req.tx, 0
        if tx.startswith(b"p") and b":" in tx:
            try:
                prio = int(tx[1:tx.index(b":")])
            except ValueError:
                prio = 0
        code = self.abci.CODE_TYPE_OK if not tx.startswith(b"bad") else 1
        return self.abci.ResponseCheckTx(code=code, priority=prio)


class FakeClock:
    """The `time` both mempool modules read (admission stamps and the TTL)."""

    def __init__(self):
        self.now = T0

    def time_ns(self):
        return self.now


class Run:
    """One scenario on one package: a pool over PrioApp with a fresh
    MempoolMetrics registry, and a log of every step's outcome."""

    def __init__(self, P, monkeypatch, **kw):
        self.P = P
        self.clock = FakeClock()
        monkeypatch.setattr(P.mempool, "time", self.clock)
        self.reg = P.metrics.Registry()
        self.mm = P.metrics.MempoolMetrics(self.reg)
        self.app = PrioApp(P)
        self.log = []
        self.mp = self.pool(**kw)

    def pool(self, **kw):
        args = dict(max_txs=3, metrics=self.mm)
        args.update(kw)
        return self.P.mempool.Mempool(self.app, **args)

    def check(self, tx, sender="", mp=None):
        mp = mp or self.mp
        try:
            res = mp.check_tx(tx, sender=sender)
            out = None if res is None else ("ok", res.code, res.priority)
        except self.P.mempool.MempoolError as e:
            out = (type(e).__name__, e.reason, str(e))
        self.log.append((tx, sender, out, self.residents(mp)))
        return out

    def update(self, height, txs=(), codes=(), mp=None):
        mp = mp or self.mp
        mp.lock()
        try:
            mp.update(height, list(txs),
                      [self.P.abci.ResponseDeliverTx(code=c) for c in codes])
        finally:
            mp.unlock()
        self.log.append(("update", height, self.residents(mp)))

    def residents(self, mp=None):
        mp = mp or self.mp
        return [m.tx for m in mp._txs.values()]

    def result(self):
        mp = self.mp
        return (self.log, self.residents(), mp.txs_bytes(), mp.evicted_total,
                mp.expired_total, dict(mp._sender_counts), sorted(mp._cache),
                self.P.metrics.parse_exposition(self.reg.expose()))


def _both(monkeypatch, scenario, **kw):
    out = []
    for P in (REF, PORT):
        r = Run(P, monkeypatch, **kw)
        scenario(r)
        out.append(r.result())
    assert out[1] == out[0]
    return out[0]


def test_c5_full_pool_admits_on_reference_defaults():
    """The reproduction of ROADMAP C5: `Mempool(LocalClient(KVStoreApplication()),
    max_txs=3)` and five kvstore txs. Both give code 0 five times and keep
    the last three."""
    out = []
    for P in (REF, PORT):
        mp = P.mempool.Mempool(P.client.LocalClient(P.kvstore.KVStoreApplication()), max_txs=3)
        codes = [mp.check_tx(b"k%d=v" % i).code for i in range(5)]
        out.append((codes, mp.reap_max_txs(-1), mp.evicted_total))
    assert out[0] == ([0] * 5, [b"k2=v", b"k3=v", b"k4=v"], 2)
    assert out[1] == out[0]


def _evict_lowest(r):
    for tx in (b"p5:a", b"p1:b", b"p3:c"):
        r.check(tx)
    r.check(b"p4:d")  # displaces the priority-1 resident


def _evict_lru(r):
    for tx in (b"p0:a", b"p0:b", b"p0:c", b"p0:d", b"p0:e"):
        r.check(tx)


def _refuse_higher(r):
    for tx in (b"p5:a", b"p5:b", b"p5:c"):
        r.check(tx)
    r.check(b"p1:low")  # MempoolFullError, un-cached
    r.check(b"p1:low", sender="peer1")  # gossip: silent
    r.mp.flush()
    r.check(b"p1:low")


def _bytes_freed(r):
    r.mp.max_txs, r.mp.max_txs_bytes = 100, 30
    r.check(b"p0:" + b"a" * 10)
    r.check(b"p0:" + b"b" * 10)
    r.check(b"p0:" + b"c" * 20)  # must evict both residents


def _evicted_returns(r):
    for tx in (b"p0:a", b"p0:b", b"p0:c"):
        r.check(tx)
    r.check(b"p9:big")  # evicts p0:a, un-caches it
    r.check(b"p0:a")  # admitted again (evicts p0:b)
    r.check(b"p0:c")  # resident duplicate: cache reason


def _dup_never_evicts(r):
    for tx in (b"p0:a", b"p0:b", b"p9:c"):
        r.check(tx)
    r.mp._cache.pop(r.P.tmhash.sum256(b"p9:c"))  # resident, churned out of the cache
    r.check(b"p9:c")


def _eviction_off(r):
    r.mp.eviction = False
    for tx in (b"a", b"b", b"c", b"d"):
        r.check(tx)
    r.check(b"e", sender="peer1")


def _ttl_blocks(r):
    r.mp.max_txs, r.mp.ttl_num_blocks = 100, 2
    r.update(10)
    r.check(b"p0:old")
    r.update(11)
    r.check(b"p0:mid")
    r.update(12)  # p0:old is 2 blocks old: purged and un-cached
    r.check(b"p0:old")
    r.update(14)


def _ttl_seconds(r):
    r.mp.max_txs, r.mp.ttl_seconds = 100, 0.5
    r.check(b"p0:young")
    r.clock.now += 300_000_000
    r.check(b"p0:younger")
    r.clock.now += 300_000_000  # young is 0.6 s old, younger 0.3 s
    r.update(1)
    r.clock.now += 200_000_000
    r.update(2)


def _quota_gossip_not_rpc(r):
    r.mp.max_txs, r.mp.max_txs_per_sender = 100, 2
    for tx in (b"p0:a", b"p0:b", b"p0:c"):
        r.check(tx, sender="peerA")
    r.check(b"p0:d", sender="peerB")
    for i in range(5):
        r.check(b"p0:rpc%d" % i)


def _quota_freed(r):
    r.mp.max_txs, r.mp.max_txs_per_sender = 2, 2
    r.check(b"p0:a", sender="peerA")
    r.check(b"p0:b", sender="peerA")
    r.update(1, [b"p0:a"], [0])  # commit frees one quota slot
    r.check(b"p0:c", sender="peerA")
    r.check(b"p9:hi")  # eviction frees the victim's slot


def _penalize(r):
    r.mp.max_txs = 100
    r.mp.penalize_sender("poisoner")
    r.mp.penalize_sender("")
    for i in range(4):
        r.check(b"p0:x%d" % i, sender="poisoner")
    r.check(b"p0:y", sender="honest")
    r.mp.flush()  # a penalty survives a flush
    r.check(b"p0:x9", sender="poisoner")
    r.log.append(sorted(r.mp.penalized_senders()))


def _too_large_and_cache(r):
    r.mp.max_txs, r.mp.max_tx_bytes = 100, 8
    r.check(b"0123456789")
    r.check(b"0123456789", sender="p")
    r.check(b"p0:a")
    r.check(b"p0:a")
    r.check(b"bad:1")  # CheckTx code 1: rejected, un-cached
    r.check(b"bad:1")


def _full_gauge(r):
    for tx in (b"a", b"b", b"c"):
        r.check(tx)
    r.update(1, [b"a"], [0])
    r.update(2, [b"b", b"c"], [0, 1])


SCENARIOS = {
    "evict_lowest_priority": _evict_lowest, "evict_equal_priority_lru": _evict_lru,
    "refuse_when_only_higher_left": _refuse_higher, "evict_frees_bytes": _bytes_freed,
    "evicted_tx_leaves_cache": _evicted_returns, "duplicate_never_evicts": _dup_never_evicts,
    "eviction_off": _eviction_off, "ttl_blocks": _ttl_blocks, "ttl_seconds": _ttl_seconds,
    "quota_gossip_not_rpc": _quota_gossip_not_rpc, "quota_freed": _quota_freed,
    "penalize_sender": _penalize, "too_large_and_cache": _too_large_and_cache,
    "full_gauge": _full_gauge,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_scenario(name, monkeypatch):
    _both(monkeypatch, SCENARIOS[name])


def test_eviction_order_and_counters(monkeypatch):
    """Spot values of the side-by-side runs: the reference's own
    expectations (tests/test_mempool_overload.py:62-99)."""
    out = _both(monkeypatch, _evict_lowest)
    assert out[1] == [b"p5:a", b"p3:c", b"p4:d"] and out[3] == 1
    out = _both(monkeypatch, _refuse_higher)
    assert out[0][3][2][:2] == ("MempoolFullError", "full")
    # the refused RPC submission and the silent gossip drop both count
    assert out[7]["tendermint_mempool_rejected_txs_total"]["samples"] == [
        ("tendermint_mempool_rejected_txs_total", {"reason": "full"}, 2.0)]


def test_wal_bytes_replay_and_torn_tail(tmp_path, monkeypatch):
    """The reference writes a WAL (with an eviction in it); the port writes
    the same admissions to its own: the files are byte-equal. Each package
    replays the other's into a fresh pool to the same residents; a torn
    tail stops both readers at the same tx."""
    paths, outs = {}, {}
    for P in (REF, PORT):
        path = str(tmp_path / P.which / "wal")
        r = Run(P, monkeypatch, wal_path=path)
        for tx in (b"p0:a", b"p0:b", b"p0:c", b"p9:vip", b"p3:z"):
            r.check(tx)
        r.mp.close_wal()
        paths[P.which] = path
        outs[P.which] = r.result()
    assert outs["port"] == outs["ref"]
    with open(paths["ref"], "rb") as f:
        ref_bytes = f.read()
    with open(paths["port"], "rb") as f:
        assert f.read() == ref_bytes
    replayed = []
    for P, src in ((PORT, "ref"), (REF, "port")):
        r = Run(P, monkeypatch, max_txs=10)
        replayed.append((r.mp.replay_wal(paths[src]), r.residents()))
    assert replayed[0] == replayed[1] == (5, [b"p0:a", b"p0:b", b"p0:c", b"p9:vip", b"p3:z"])
    torn = str(tmp_path / "torn")
    with open(torn, "wb") as f:
        f.write(ref_bytes + (8).to_bytes(4, "big") + b"xxx")
    assert (list(PORT.mempool.iter_mempool_wal(torn))
            == list(REF.mempool.iter_mempool_wal(torn))
            == [b"p0:a", b"p0:b", b"p0:c", b"p9:vip", b"p3:z"])


def test_wal_replay_does_not_append_to_its_own_wal(tmp_path, monkeypatch):
    out = []
    for P in (REF, PORT):
        path = str(tmp_path / P.which / "wal")
        r = Run(P, monkeypatch, wal_path=path, max_txs=10)
        for tx in (b"p0:a", b"p0:b"):
            r.check(tx)
        r.mp.flush()
        n = r.mp.replay_wal(path)
        r.check(b"p0:new")
        r.mp.close_wal()
        out.append((n, list(P.mempool.iter_mempool_wal(path)), r.result()))
    assert out[1] == out[0]
    assert out[0][:2] == (2, [b"p0:a", b"p0:b", b"p0:new"])
