"""The flight recorder: the port's libs/trace.py (and libs/txtrace.py
StageStats) held against the JAX package's. Span nesting, the ring's bound
and the JSONL round trip give the same events (names, ids, parents,
attributes; not the clock fields); one record_flush sequence gives equal
verify_stats() totals, stage seconds, counters, last flush and rlc flush
samples; and both packages' verify_batch record the same flush for the
same rows on the host arm, tagged or not. Tolerance: zero, except the
clock fields (timestamps and durations), which are not compared.
"""

import threading

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as ref_batch
from tendermint_tpu.crypto import provenance as ref_prov
from tendermint_tpu.crypto.keys import gen_ed25519
from tendermint_tpu.libs import trace as ref_trace
from tendermint_tpu.libs import txtrace as ref_txtrace
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto import provenance as port_prov
from tendermint_tpu_torch.libs import trace as port_trace
from tendermint_tpu_torch.libs import txtrace as port_txtrace

PORTED = ("totals", "stage_seconds", "counters", "last_flush")


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo off, as tests/conftest.py turns the
    reference's off."""
    prev, port_batch._MEMO = port_batch._MEMO, port_batch.VerifiedRowMemo(0)
    yield
    port_batch._MEMO = prev


@pytest.fixture
def clean_stats():
    ref_trace.reset_stats()
    port_trace.reset_stats()
    yield
    ref_trace.reset_stats()
    port_trace.reset_stats()


def _shape(events):
    """Events without their clock fields."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur_ms")} for e in events]


def _drive(mod, ring=8):
    t = mod.Tracer(ring_size=ring)
    with t.span("outer", a=1) as outer:
        with t.span("inner", b=2):
            t.event("point", c=3)
        outer.set(path="rlc")
    try:
        with t.span("fails"):
            raise KeyError("x")
    except KeyError:
        pass
    sp = t.span("manual", n=4)
    sp.__enter__()
    sp.__exit__(None, None, None)
    return t


def test_span_nesting_and_attributes_match():
    ref, port = _drive(ref_trace), _drive(port_trace)
    assert _shape(port.dump()) == _shape(ref.dump())
    got = {e["name"]: e for e in port.dump()}
    assert got["inner"]["parent"] == got["outer"]["span"]
    assert got["point"]["parent"] == got["inner"]["span"]
    assert got["fails"]["attrs"] == {"error": "KeyError"}


@pytest.mark.parametrize("ring,limit", [(1, None), (3, None), (3, 2), (8, 0)])
def test_ring_bound_and_dump_limit(ring, limit):
    ref, port = _drive(ref_trace, ring), _drive(port_trace, ring)
    assert port.ring_size == ref.ring_size == ring
    assert _shape(port.dump(limit)) == _shape(ref.dump(limit))
    for t in (ref, port):
        t.configure(ring_size=2, enabled=False)
    assert _shape(port.dump()) == _shape(ref.dump()) and not port.enabled
    port.clear()
    assert port.dump() == []


def test_jsonl_round_trip():
    ref, port = _drive(ref_trace), _drive(port_trace)
    text = port.to_jsonl()
    assert port_trace.Tracer.from_jsonl(text) == port.dump()
    assert _shape(port_trace.Tracer.from_jsonl(text)) == _shape(
        ref_trace.Tracer.from_jsonl(ref.to_jsonl()))


def test_per_thread_nesting():
    t = port_trace.Tracer()

    def work(i):
        with t.span("w", i=i):
            t.event("e", i=i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert not any(th.is_alive() for th in threads)
    spans = {e["attrs"]["i"]: e["span"] for e in t.dump() if e["name"] == "w"}
    for e in t.dump():
        if e["name"] == "e":
            assert e["parent"] == spans[e["attrs"]["i"]]


FLUSHES = [
    dict(backend="cpu", path="cpu", n=40, total_s=0.01, n_valid=39),
    dict(backend="memo", path="memo", n=12, total_s=0.0005, n_valid=12, memo_hits=12),
    dict(backend="jax", path="rlc", n=2048, total_s=0.07, n_valid=2048, prep_s=0.02,
         fused=True, chunks=1, chunk_lanes=4096, prep_overlap_s=0.0,
         prep_stages={"hash_s": 0.01, "sort": 0.002}),
    dict(backend="jax", path="rlc-bisect", n=512, total_s=0.3, n_valid=510,
         recovery_flushes=5, rlc_fallback=True, quarantined=7, cache_hits=500,
         cache_misses=12, jit_bucket=1024, padding_lanes=512, transfer_s=0.001,
         h2d_bytes=1 << 20, device_dispatches=9, compile_s=0.5),
    dict(backend="jax", path="rlc-async", n=1024, total_s=0.05, n_valid=1024),
]


def test_record_flush_sequence_gives_equal_stats(clean_stats):
    tr = {ref_trace: ref_trace.Tracer(), port_trace: port_trace.Tracer()}
    for f in FLUSHES:
        for mod in (ref_trace, port_trace):
            mod.record_flush(**f, tracer_=tr[mod])
        r, p = ref_trace.verify_stats(), port_trace.verify_stats()
        assert {k: p[k] for k in PORTED} == {k: r[k] for k in PORTED}
        assert p["slope_samples"]["flush_samples"] == r["slope_samples"]["flush_samples"]
    assert _shape(tr[port_trace].dump()) == _shape(tr[ref_trace].dump())
    port_trace.reset_stats()
    assert port_trace.verify_stats()["totals"] == {}


def _rows(n, corrupt=()):
    pk, ms, sg = [], [], []
    for i in range(n):
        priv = gen_ed25519(bytes([i + 1]) + b"\x21" * 31)
        m = b"trace-%d" % i
        s = bytearray(priv.sign(m))
        if i in corrupt:
            s[0] ^= 0xFF
        pk.append(priv.pub_key().bytes())
        ms.append(m)
        sg.append(bytes(s))
    return pk, ms, sg


@pytest.mark.parametrize("tagged", [False, True])
def test_verify_batch_records_the_same_flush(clean_stats, tagged):
    """A host-arm flush of 60 rows with two bad rows from a quarantined
    source: both packages record backend, path, n, n_valid and the
    quarantined count alike, and advance their scorers alike."""
    pk, ms, sg = _rows(60, corrupt=(4, 9))
    srcs = ["peer:bad" if i in (4, 9, 11) else f"peer:ok{i % 3}" for i in range(60)]
    scorers = (ref_prov.SuspicionScorer(), port_prov.SuspicionScorer())
    prev = (ref_prov.set_default(scorers[0]), port_prov.set_default(scorers[1]))
    try:
        for s in scorers:
            s.record_rows(["peer:bad"] * 3, np.zeros(3, dtype=bool))
        kw = {"sources": srcs} if tagged else {}
        want = ref_batch.verify_batch(pk, ms, sg, backend="cpu", **kw)
        got = port_batch.verify_batch(pk, ms, sg, device="cpu", backend="cpu", **kw)
        assert got.tobytes() == want.tobytes()
        r, p = ref_trace.verify_stats()["last_flush"], port_trace.verify_stats()["last_flush"]
        keys = ("backend", "path", "n", "n_valid", "quarantined")
        assert {k: p.get(k) for k in keys} == {k: r.get(k) for k in keys}
        assert p.get("quarantined") == (3 if tagged else None)
        assert scorers[1].stats() == scorers[0].stats()
        r_c, p_c = ref_trace.verify_stats()["counters"], port_trace.verify_stats()["counters"]
        assert p_c["quarantined_rows"] == r_c["quarantined_rows"]
    finally:
        ref_prov.set_default(prev[0])
        port_prov.set_default(prev[1])


def test_stage_stats_percentiles_match():
    rng = np.random.default_rng(5)
    ref, port = ref_txtrace.StageStats(maxlen=16), port_txtrace.StageStats(maxlen=16)
    for _ in range(50):
        stage = ("a", "b", "c")[int(rng.integers(0, 3))]
        sec = float(rng.random())
        ref.observe(stage, sec)
        port.observe(stage, sec)
    assert port.percentiles() == ref.percentiles()
    assert port_txtrace.StageStats().percentiles() == {}
