"""The port's TxTracker against the JAX package's (tests/test_txtrace.py:49-267),
tolerance 0, under one fake clock patched into both packages' txtrace and
mempool modules: every call of perf_counter() moves it 1 ms, and time() reads
the same count, so stage durations and timestamps are equal numbers.

The tracker alone: a full journey, ingress-only tracking, a disabled
tracer, first-stage-wins and the re-entry after a resettable terminal, a
delivered journey kept on re-broadcast, and the ring bound under a
10,000-tx flood. Through the mempool: admitted, rejected (quota, too_large,
checktx, full, cache on a resident duplicate), evicted, expired and
rechecked-out journeys. Compared: each waterfall, stats() and the
TxLifecycleMetrics exposition (parse_exposition).
"""

import os

import pytest

from tests.test_torch_consensus_util import Pkg

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")


class StepClock:
    """perf_counter() advances 1 ms a call; time() and time_ns() read it."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return self.n / 1000.0

    def time(self):
        return 1_700_000_000.0 + self.n / 1000.0

    def time_ns(self):
        return 1_700_000_000_000_000_000 + self.n * 1_000_000


class PrioApp:
    def __init__(self, P):
        self.abci, self.recheck_fails = P.abci, False

    def check_tx(self, req):
        tx, prio = req.tx, 0
        if tx.startswith(b"p") and b":" in tx:
            prio = int(tx[1:tx.index(b":")])
        bad = tx.startswith(b"bad") or (
            self.recheck_fails and req.type == self.abci.CHECK_TX_TYPE_RECHECK)
        return self.abci.ResponseCheckTx(code=1 if bad else self.abci.CODE_TYPE_OK,
                                         priority=prio)


def _tracker(P, monkeypatch, max_txs=512):
    clock = StepClock()
    monkeypatch.setattr(P.txtrace, "time", clock)
    monkeypatch.setattr(P.mempool, "time", clock)
    monkeypatch.setattr(P.trace.tracer, "enabled", True)
    reg = P.metrics.Registry()
    return P.txtrace.TxTracker(max_txs=max_txs, metrics=P.metrics.TxLifecycleMetrics(reg)), reg


def _summary(P, tt, reg, keys):
    return ([tt.waterfall(k) for k in keys], tt.stats(),
            P.metrics.parse_exposition(reg.expose()))


def _both(monkeypatch, scenario):
    out = []
    for P in (REF, PORT):
        tt, reg = _tracker(P, monkeypatch)
        keys = scenario(P, tt)
        out.append(_summary(P, tt, reg, keys))
    assert out[1] == out[0]
    return out[0]


def _h(P, b):
    return P.tmhash.sum256(b)


def _full_journey(P, tt):
    key = _h(P, b"tx-1")
    tt.record(key, "received", via="rpc")
    tt.record(key, "checked", code=0, priority=3)
    tt.record(key, "admitted", priority=3)
    tt.record(key, "first_gossiped", peer="peer0")
    tt.record(key, "proposed", height=5, round=0, index=0)
    tt.record(key, "committed", height=5, round=0, index=0)
    tt.record(key, "delivered", height=5, index=0, code=0)
    return [key]


def _ingress_only(P, tt):
    key = _h(P, b"foreign")
    assert tt.record(key, "committed", height=9, round=0) is False
    tt.record_block("committed", 9, 0, [b"foreign"])  # empty ring: skipped
    return [key]


def _disabled(P, tt):
    P.trace.tracer.enabled = False
    assert tt.record(_h(P, b"x"), "received", via="rpc") is False
    P.trace.tracer.enabled = True
    return [_h(P, b"x")]


def _reenter(P, tt):
    key = _h(P, b"retry")
    tt.record(key, "received", via="gossip")
    tt.record(key, "received", via="rpc")
    tt.record(key, "rejected", reason="full")
    tt.record(key, "committed", height=9, round=0)
    tt.record(key, "delivered", height=9, code=0)
    tt.record(key, "received", via="rpc")
    done = _h(P, b"done")
    tt.record(done, "received", via="rpc")
    tt.record(done, "delivered", height=3, code=0)
    tt.record(done, "received", via="rpc")
    tt.record(done, "rejected", reason="cache")
    return [key, done]


def _block_stages(P, tt):
    txs = [b"a=1", b"b=2", b"c=3"]
    for tx in txs[:2]:
        tt.record(_h(P, tx), "received", via="rpc")
    tt.record_block("proposed", 4, 1, txs)
    tt.record_block("committed", 4, 1, txs)
    tt.record_delivered(4, txs, [P.abci.ResponseDeliverTx(code=c) for c in (0, 1, 0)])
    return [_h(P, tx) for tx in txs]


SCENARIOS = {"full_journey": _full_journey, "ingress_only": _ingress_only,
             "disabled_tracer": _disabled, "terminal_reentry": _reenter,
             "block_stages": _block_stages}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tracker_scenario(name, monkeypatch):
    _both(monkeypatch, SCENARIOS[name])


def test_full_journey_expectations(monkeypatch):
    wfs, st, _ = _both(monkeypatch, _full_journey)
    assert [s["stage"] for s in wfs[0]["stages"]] == list(REF.txtrace.STAGES)
    assert wfs[0]["complete"] and st["terminals"] == {"delivered": 1}


def test_ring_bound_under_flood(monkeypatch):
    out = []
    for P in (REF, PORT):
        tt, reg = _tracker(P, monkeypatch, max_txs=256)
        for i in range(10_000):
            tt.record(_h(P, b"flood-%d" % i), "received", via="rpc")
        last = _h(P, b"flood-9999")
        ok = tt.record(last, "checked", code=0, priority=0)
        out.append((ok, _summary(P, tt, reg, [_h(P, b"flood-0"), last])))
    assert out[1] == out[0]
    st = out[0][1][1]
    assert (st["tracked"], st["ring_evictions"]) == (256, 10_000 - 256)
    assert out[0][1][0][0] is None


def _pool_run(P, monkeypatch, steps, **kw):
    tt, reg = _tracker(P, monkeypatch)
    app = PrioApp(P)
    args = dict(max_txs=3, tx_tracker=tt)
    args.update(kw)
    mp = P.mempool.Mempool(app, **args)
    txs = steps(P, mp, app)
    return _summary(P, tt, reg, [_h(P, tx) for tx in txs])


def _admit_evict(P, mp, app):
    for tx in (b"p7:a", b"p5:b", b"p1:c", b"p3:d"):  # p1:c evicted
        mp.check_tx(tx)
    return [b"p7:a", b"p1:c", b"p3:d"]


def _reasons(P, mp, app):
    mp.max_txs_per_sender, mp.max_tx_bytes = 1, 12
    mp.check_tx(b"p0:s1", sender="peerA")
    mp.check_tx(b"p0:s2", sender="peerA")  # quota
    mp.check_tx(b"p0:way-too-large", sender="peerA")  # too_large
    mp.check_tx(b"bad-tx")  # checktx
    try:
        mp.check_tx(b"p0:s1")  # resident duplicate: the journey stays live
    except P.mempool.MempoolError:
        pass
    return [b"p0:s1", b"p0:s2", b"p0:way-too-large", b"bad-tx"]


def _full(P, mp, app):
    mp.eviction = False
    for tx in (b"p0:a", b"p0:b", b"p0:c"):
        mp.check_tx(tx)
    mp.check_tx(b"p0:d", sender="peerB")
    return [b"p0:d"]


def _expire_recheck(P, mp, app):
    mp.max_txs, mp.ttl_num_blocks = 10, 3
    for tx in (b"p0:old", b"p0:keep"):
        mp.check_tx(tx)
    with mp._lock:
        mp.update(1, [], [])
    mp.check_tx(b"p0:young")
    app.recheck_fails = True
    with mp._lock:
        mp.update(3, [], [])  # p0:old and p0:keep expire, p0:young is rechecked out
    return [b"p0:old", b"p0:keep", b"p0:young"]


POOL_SCENARIOS = {"admitted_and_evicted": _admit_evict, "rejection_reasons": _reasons,
                  "full_without_eviction": _full, "expired_and_rechecked_out": _expire_recheck}


@pytest.mark.parametrize("name", sorted(POOL_SCENARIOS))
def test_mempool_journeys(name, monkeypatch):
    out = [_pool_run(P, monkeypatch, POOL_SCENARIOS[name]) for P in (REF, PORT)]
    assert out[1] == out[0]
    if name == "expired_and_rechecked_out":
        assert [w["terminal"] for w in out[0][0]] == ["expired", "expired", "rejected"]
    if name == "rejection_reasons":
        assert out[0][1]["terminals"] == {"rejected": 3, "rejected:quota": 1,
                                          "rejected:too_large": 1, "rejected:checktx": 1}
