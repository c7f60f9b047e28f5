"""The node's services in the port against the JAX package's, tolerance 0:

- forensics (tests/test_forensics.py): a heartbeat ring one package wrote
  is read by the other to the same beats; stale rings of dead pids are
  swept alike; a capture names the wedged phase; the watchdog fires and
  can be cancelled; the port's device round trips stamp their site
  (`persig` from a card-arm flush on the plain kernels);
- the tx indexer: the same index keys, values and search results for the
  same blocks' txs, directly and through IndexerService over the event bus;
- the overload controller (tests/test_overload.py:411-454): the same
  pressure-level sequence, shed switches, scheduler pressure calls,
  snapshot and metrics exposition for the same sampled signals;
- libs/service.BaseService's lifecycle errors and libs/log's level specs.
"""

import asyncio
import json
import os
import subprocess
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu_torch.crypto import batch as tbatch
from tests.test_torch_consensus_util import Pkg

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261023


@pytest.fixture(autouse=True)
def _forensics_off_after():
    yield
    REF.forensics.configure(None)
    PORT.forensics.configure(None)


def _beats(P, path):
    return [{k: v for k, v in b.items() if k != "age_s"} for b in P.forensics.Heartbeat.read(path)]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_heartbeat_ring_read_across_packages(writer, tmp_path):
    W = REF if writer == "ref" else PORT
    path = str(tmp_path / "hb.bin")
    for i in range(10):  # a 4-slot ring wraps, keeping the newest
        W.forensics.Heartbeat(path, slots=4).beat(f"p{i}")
    assert _beats(PORT, path) == _beats(REF, path)
    assert [b["phase"] for b in _beats(PORT, path)] == ["p6", "p7", "p8", "p9"]
    assert [b["seq"] for b in _beats(REF, path)] == [7, 8, 9, 10]
    assert PORT.forensics.Heartbeat.read(path, limit=2) != []


def test_stale_rings_swept_alike(tmp_path):
    child = subprocess.Popen(["true"])
    child.wait()
    out = []
    for P in (REF, PORT):
        d = tmp_path / P.which
        d.mkdir()
        (d / f"heartbeat_{child.pid}.bin").write_bytes(b"stale ring")
        (d / f"heartbeat_{os.getpid()}.bin").write_bytes(b"live ring")
        (d / "not_a_heartbeat.bin").write_bytes(b"keep me")
        removed = [os.path.basename(p) for p in P.forensics.sweep_stale_heartbeats(str(d))]
        out.append((removed, sorted(os.listdir(d))))
    assert out[1] == out[0]
    assert out[0][0] == [f"heartbeat_{child.pid}.bin"]


def test_capture_names_the_wedged_phase(tmp_path):
    docs = []
    for P in (REF, PORT):
        d = str(tmp_path / P.which)
        P.forensics.configure(d)
        P.forensics.beat("rlc_submit")
        P.forensics.beat("rlc_finish")
        path = P.forensics.capture("unit test", kind="manual", probe_devices=False)
        with open(path) as f:
            doc = json.load(f)
        assert path in P.forensics.find_captures(d)
        docs.append(doc)
        P.forensics.configure(None)
    keys = ("reason", "kind", "wedged_phase", "pid")
    assert [docs[1][k] for k in keys] == [docs[0][k] for k in keys]
    assert docs[1]["wedged_phase"] == "rlc_finish"
    assert ([b["phase"] for b in docs[1]["heartbeat"]]
            == [b["phase"] for b in docs[0]["heartbeat"]])
    assert "thread" in docs[1]["threads"].lower()
    assert docs[1]["cuda"] == {"skipped": True}
    assert isinstance(docs[1]["machine_fingerprint"], str)
    probed = PORT.forensics._probe_cuda_devices()
    assert probed.get("backend") in ("cpu", "cuda")


def test_watchdog_fires_and_cancel_suppresses(tmp_path):
    fired = threading.Event()
    wd = PORT.forensics.Watchdog(0.2, "unit hang", out_dir=str(tmp_path),
                                 on_fire=lambda w: fired.set()).start()
    assert fired.wait(20)
    assert wd.fired and os.path.exists(wd.capture_path)
    with open(wd.capture_path) as f:
        assert json.load(f)["kind"] == "watchdog"
    wd2 = PORT.forensics.Watchdog(0.3, "cancelled", out_dir=str(tmp_path))
    with wd2:
        pass
    time.sleep(0.5)
    assert not wd2.fired


def test_device_round_trip_stamps_its_site(tmp_path):
    """A card-arm flush (plain kernels on the CPU) beats `persig` before it
    touches the device, as the reference's `_device_fault` site does."""
    privs = [REF.keys.gen_ed25519(bytes([i + 1]) * 32) for i in range(3)]
    msgs = [b"m%d" % i for i in range(3)]
    pks = [p.pub_key().bytes() for p in privs]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    path = PORT.forensics.configure(str(tmp_path))
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    try:
        mask = tbatch.verify_batch(pks, msgs, sigs, backend="cuda", device="cpu")
    finally:
        tbatch._MEMO = prev
    assert list(mask) == [True] * 3
    assert [b["phase"] for b in PORT.forensics.Heartbeat.read(path)] == ["persig"]


def _tx_results(P, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h in range(1, 4):
        for i in range(3):
            tx = b"k%d=%s" % (h * 10 + i, rng.bytes(6).hex().encode())
            out.append((P.txindex.TxResult(h, i, tx, int(rng.integers(0, 2)), rng.bytes(3),
                                           "log-%d" % i),
                        {"app.key": ["k%d" % (h * 10 + i)], "app.parity": [str(i % 2)]}))
    return out


def _index_view(P, idx):
    return (sorted(idx.db.iterate_prefix(b"")),
            [r.to_json() for r in idx.search("app.parity", "1")],
            [r.to_json() for r in idx.by_height(2)],
            idx.get(P.tmhash.sum256(b"missing")))


def test_tx_index_keys_and_searches():
    out = []
    for P in (REF, PORT):
        idx = P.txindex.KVTxIndexer(P.kvdb.MemDB())
        for res, comp in _tx_results(P, SEED):
            idx.index(res, comp)
        out.append(_index_view(P, idx))
    assert out[1] == out[0]
    assert len(out[0][1]) == 3 and len(out[0][2]) == 3


def test_indexer_service_over_the_event_bus():
    async def run(P):
        bus = P.event_bus.EventBus()
        idx = P.txindex.KVTxIndexer(P.kvdb.MemDB())
        svc = P.txindex.IndexerService(idx, bus)
        await svc.start()
        for res, _ in _tx_results(P, SEED + 1):
            events = [P.abci.Event("app", [(b"key", res.tx[:3], True)])]
            bus.publish_tx(res.height, res.index, res.tx,
                           P.abci.ResponseDeliverTx(code=res.code, data=res.data, log=res.log,
                                                    events=events))
        for _ in range(200):
            await asyncio.sleep(0.005)
            if len(list(idx.db.iterate_prefix(b"TX:hash:"))) == 9:
                break
        await svc.stop()
        return _index_view(P, idx)

    assert asyncio.run(run(PORT)) == asyncio.run(run(REF))


class _Pool:
    max_txs, max_txs_bytes = 100, 10 ** 9

    def __init__(self):
        self.n = 0

    def size(self):
        return self.n

    def txs_bytes(self):
        return 0


def test_overload_pressure_sequence():
    fills = [0, 75, 95, 80, 60, 10, 70, 70, 70, 92, 50, 0]
    out = []
    for P in (REF, PORT):
        reg = P.metrics.Registry()
        pool = _Pool()
        gate = SimpleNamespace(inflight=0, max_inflight=10, shed_writes=False, shed_reads=False)
        calls = []
        node = SimpleNamespace(
            mempool=pool, consensus=SimpleNamespace(_queue=asyncio.Queue(maxsize=100)),
            rpc_server=SimpleNamespace(gate=gate), switch=None,
            mempool_reactor=SimpleNamespace(shed=False),
            scheduler=SimpleNamespace(set_pressure=calls.append))
        ctl = P.overload.OverloadController(node, P.config.OverloadConfig(),
                                            metrics=P.metrics.OverloadMetrics(reg))
        seq = []
        for i, n in enumerate(fills):
            pool.n = n
            gate.inflight = i % 4
            node.consensus._queue.put_nowait(i)
            seq.append((ctl.evaluate(), node.mempool_reactor.shed, gate.shed_writes,
                        gate.shed_reads))
        out.append((seq, calls, ctl.snapshot(), P.metrics.parse_exposition(reg.expose())))
    assert out[1] == out[0]
    assert [s[0] for s in out[0][0]] == [0, 1, 2, 2, 1, 0, 1, 1, 1, 2, 0, 0]


def test_base_service_lifecycle_and_log_specs():
    async def run(P):
        svc = P.service.BaseService("svc")
        out = []
        for op in ("stop", "start", "start", "reset", "stop", "stop", "reset", "start"):
            try:
                await getattr(svc, op)()
                out.append((op, "ok", svc.is_running()))
            except P.service.ServiceError as e:
                out.append((op, type(e).__name__, svc.is_running()))
        return out

    assert asyncio.run(run(PORT)) == asyncio.run(run(REF))
    for spec in ("info", "consensus:debug,p2p:none,*:error", "mempool:warn", ""):
        assert PORT.log.parse_level_spec(spec) == REF.log.parse_level_spec(spec)
    with pytest.raises(ValueError):
        PORT.log.parse_level_spec("consensus:loud")
