"""The verification scheduler: the port's crypto/scheduler.py held against
the JAX package's, built from one configuration (convert carries the
reference's SchedulerConfig across).

- Planning: both schedulers run without their dispatch thread, under a
  fake monotonic clock, over a stub verify_batch (as
  tests/test_scheduler.py stubs it); the test plans and flushes step by
  step, so no sleep decides a result. Both must give the same flush
  sequence (lanes and rows of each flush, in order, with their waits),
  preemption counts, budgets under set_pressure(0/1/2), catch-up idle soak
  and starvation floor, quarantine solo flushes and between-chunk vote
  preemption.
- Verdicts: one corrupted row per lane, the port on its card arm
  (backend="cuda", device="cpu": the kernels' plain versions) with a
  512-row lane, so the combined flush runs the RLC path and its recovery;
  the reference on its host arm. Masks equal each other and a standalone
  verify_batch.
- lane_scope routing of verify_commit and begin_verify_commit_light*,
  LaneAccumulator slicing and its error latch, the quarantine partition,
  a closed scheduler going inline, the wait-timeout fallback, a ticket
  already in a running flush at the wait timeout (the port waits for that
  flush; the reference verifies its rows again inline), and a flush that
  raises (it re-raises in every ticket, the thread survives, no inline
  verification is taken).
- The vote path and blocksync on their lanes: VoteSet.flush with peer IDs
  through each package's default scheduler (committed votes, failed
  indices, scorer state), verify_run_batched(scheduler=) on a good and a
  tampered run.

Tolerance: zero everywhere.
"""

import numpy as np
import pytest

from tendermint_tpu.config import config as ref_config
from tendermint_tpu.crypto import batch as ref_batch
from tendermint_tpu.crypto import provenance as ref_prov
from tendermint_tpu.crypto import scheduler as ref_sched
from tendermint_tpu.crypto.keys import gen_ed25519
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import vote_set as jvset
from tendermint_tpu_torch import config as port_config
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.blocksync.verify import verify_run_batched
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto import provenance as port_prov
from tendermint_tpu_torch.crypto import scheduler as port_sched
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import vote_set as tvset
from tests import test_torch_blocksync as tbs
from tests import test_torch_vote_set as tvs

PKGS = {
    "ref": (ref_sched, ref_batch, ref_prov),
    "port": (port_sched, port_batch, port_prov),
}
STATS_KEYS = ("pressure_level", "flushes", "preemptions", "inline_fallbacks",
              "last_flush_rows", "lanes", "lane_wait_percentiles", "backend")


@pytest.fixture(autouse=True)
def _isolated():
    """Memo off in the port (tests/conftest.py turns the reference's off),
    fresh scorers, and no default scheduler left behind."""
    prev_memo, port_batch._MEMO = port_batch._MEMO, port_batch.VerifiedRowMemo(0)
    prev_scorers = (ref_prov.set_default(ref_prov.SuspicionScorer()),
                    port_prov.set_default(port_prov.SuspicionScorer()))
    yield
    port_batch._MEMO = prev_memo
    ref_prov.set_default(prev_scorers[0])
    port_prov.set_default(prev_scorers[1])
    ref_sched.set_default(None)
    port_sched.set_default(None)


def _configs(**kw):
    ref = ref_config.SchedulerConfig(**kw)
    return {"ref": ref, "port": convert.scheduler_config_from_reference(ref)}


def _make(pkg, cfg, **kw):
    extra = {"device": "cpu"} if pkg == "port" else {}
    return PKGS[pkg][0].VerifyScheduler(cfg, **kw, **extra)


@pytest.mark.parametrize("kw", [{}, dict(backend="cpu", light_max_rows=3, catchup_max_wait=1.5,
                                         pressure_rows_factor=0.25, wait_timeout=2.0)])
def test_configs_carry_across(kw):
    from dataclasses import fields

    cfgs = _configs(**kw)
    for f in fields(ref_config.SchedulerConfig):
        assert getattr(cfgs["port"], f.name) == getattr(cfgs["ref"], f.name), f.name
    assert [f.name for f in fields(port_config.SchedulerConfig)] == [
        f.name for f in fields(ref_config.SchedulerConfig)]
    assert port_config.SchedulerConfig() == convert.scheduler_config_from_reference(
        ref_config.SchedulerConfig())
    lref = ref_config.LightServiceConfig(coalesce_window=0.5, max_pending=3, cache_blocks=9)
    lport = convert.light_service_config_from_reference(lref)
    assert [(f.name, getattr(lport, f.name)) for f in fields(port_config.LightServiceConfig)] == [
        (f.name, getattr(lref, f.name)) for f in fields(ref_config.LightServiceConfig)]
    assert port_config.LightServiceConfig() == convert.light_service_config_from_reference(
        ref_config.LightServiceConfig())


# ---------------------------------------------------------------------------
# planning, step by step under a fake clock


class _Clock:
    def __init__(self):
        self.t = 5_000.0

    def monotonic(self):
        return self.t


def _manual(pkg, cfg, clock, monkeypatch, calls, on_call=None):
    """A scheduler of `pkg` with no dispatch thread, its clock `clock`, over
    a stub verify_batch that records each call's rows and tags and answers
    False for the rows signed b"bad"."""
    mod, bmod, _ = PKGS[pkg]
    monkeypatch.setattr(mod, "time", clock)

    def stub(pk, ms, sg, *a, **kw):
        calls.append((len(pk), None if kw.get("sources") is None else tuple(kw["sources"])))
        if on_call is not None:
            on_call(len(calls))
        return np.array([s != b"bad" for s in sg], dtype=bool)

    monkeypatch.setattr(bmod, "verify_batch", stub)

    class Manual(mod.VerifyScheduler):
        def _run(self):  # the test plans and flushes itself
            return

    return Manual(cfg, backend="cpu", **({"device": "cpu"} if pkg == "port" else {}))


def _rows(n, tag="r", bad=()):
    return ([b"\x01" * 32] * n, [f"{tag}{i}".encode() for i in range(n)],
            [b"bad" if i in bad else b"ok" for i in range(n)])


def _step(s):
    """One iteration of the dispatch loop: plan, count a preemption, flush."""
    with s._cv:
        entries, lanes, preempted, timeout = s._plan_locked()
        if preempted:
            s.preemptions += 1
    if not entries:
        return ("idle", None if timeout is None else round(timeout, 9))
    s._flush(entries, lanes)
    f = s.flush_log[-1]
    return ("flush", sorted(lanes), f["rows"], {k: round(v, 9) for k, v in f["wait_s"].items()})


def _stats(s):
    st = s.stats()
    return {k: st[k] for k in STATS_KEYS}


def scenario_preempt(s, clock, out):
    tickets = [s.submit("admission", *_rows(100, "a")) for _ in range(3)]
    tickets += [s.submit("catchup", *_rows(200, "c", bad=(7,))),
                s.submit("light", *_rows(50, "l"))]
    clock.t += 0.001
    tickets.append(s.submit("votes", *_rows(10, "v", bad=(2,))))
    out.append(_step(s))  # the queued votes flush alone, preempting
    out.append(s.verify_rows("votes", *_rows(8, "w", bad=(0,))).tolist())  # inline
    out.append(dict(s.flush_log[-1], t=None))
    clock.t += 0.004
    out += [_step(s), _step(s)]  # admission triggers, light rides; catch-up waits
    clock.t += 0.25
    out += [_step(s), _step(s)]
    out.append([t.wait(0).tolist() for t in tickets])
    out.append([(t.flush_seq, round(t.wait_s, 9)) for t in tickets])


def scenario_pressure(s, clock, out):
    for level in (0, 1, 2, 1, 0):
        s.set_pressure(level)
        out.append(_stats(s))
    s.set_pressure(1)
    for _ in range(5):
        s.submit("admission", *_rows(50, "a"))
    clock.t += 0.0079
    # 250 rows queued: the 75-row budget triggers before the stretched wait
    # (0.008 s), two 50-row entries a flush
    out += [_step(s), _step(s)]
    clock.t += 0.0002
    out += [_step(s), _step(s), _step(s)]
    s.set_pressure(2)
    s.submit("catchup", *_rows(60, "c"))
    clock.t += 0.6
    out.append(_step(s))  # paused: waits for the floor (10 x 0.5 s)
    clock.t += 4.4
    out.append(_step(s))
    s.set_pressure(0)
    out.append(_stats(s))


def scenario_catchup_soak(s, clock, out):
    s.submit("catchup", *_rows(40, "c"))
    out.append(_step(s))
    clock.t += 0.25
    out.append(_step(s))
    s.submit("catchup", *_rows(40, "d"))
    for _ in range(7):  # a busy node: light rows keep arriving
        s.submit("light", *_rows(5, "l"))
        clock.t += 0.4
        out.append(_step(s))
    out.append(_step(s))
    out.append(_stats(s))


def scenario_quarantine(s, clock, out):
    q = s.submit("quarantine", *_rows(5, "q", bad=(1,)))
    s.submit("light", *_rows(10, "l"))
    clock.t += 0.02
    out += [_step(s), _step(s)]  # light first; quarantine not before its wait
    clock.t += 0.03
    out.append(_step(s))
    out.append(q.wait(0).tolist())
    s.submit("quarantine", *_rows(5, "r"))
    s.submit("quarantine", *_rows(5, "s"))
    s.submit("quarantine", *_rows(5, "t"))
    for _ in range(6):  # starvation floor under a busy light lane
        s.submit("light", *_rows(3, "m"))
        clock.t += 0.1
        out.append(_step(s))
    out += [_step(s), _step(s)]
    out.append(_stats(s))


def scenario_lane_wait(s, clock, out):
    s.set_lane_wait("light", 0.05)
    s.submit("light", *_rows(4, "l"))
    clock.t += 0.04
    out.append(_step(s))
    clock.t += 0.01
    out.append(_step(s))
    out.append(_stats(s))


SCENARIOS = {
    "preempt": (scenario_preempt, {}),
    "pressure": (scenario_pressure, dict(admission_max_rows=150, catchup_max_rows=100)),
    "catchup_soak": (scenario_catchup_soak, {}),
    "quarantine": (scenario_quarantine, dict(quarantine_max_rows=8)),
    "lane_wait": (scenario_lane_wait, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_planning_matches(name, monkeypatch):
    fn, kw = SCENARIOS[name]
    cfgs = _configs(**kw)
    got = {}
    for pkg in PKGS:
        clock, calls, out = _Clock(), [], []
        s = _manual(pkg, cfgs[pkg], clock, monkeypatch, calls)
        try:
            fn(s, clock, out)
        finally:
            s.close()
        got[pkg] = (out, calls)
    assert got["port"] == got["ref"]
    assert any(o[0] == "flush" for o in got["port"][0] if isinstance(o, tuple))


def test_votes_preempt_between_chunks(monkeypatch):
    """A catch-up flush over the chunk size splits into verify_batch calls
    of planner_chunk_rows() rows; vote rows queued during the first chunk
    flush alone before the second: calls [100, 12, 100, 100, 50]."""
    cfgs = _configs()
    got = {}
    for pkg in PKGS:
        mod, bmod, _ = PKGS[pkg]
        monkeypatch.setattr(bmod, "planner_chunk_rows", lambda: 100)
        clock, calls, out = _Clock(), [], []
        holder = {}

        def on_call(k, holder=holder):
            if k == 1:
                holder["v"] = holder["s"].submit("votes", *_rows(12, "v", bad=(3,)))

        s = holder["s"] = _manual(pkg, cfgs[pkg], clock, monkeypatch, calls, on_call)
        try:
            t = s.submit("catchup", *_rows(350, "c", bad=(150,)))
            clock.t += 0.3
            out.append(_step(s))
            out.append([dict(f, t=None, wall_s=None) for f in s.flush_log])
            out += [t.wait(0).tolist(), holder["v"].wait(0).tolist(), s.preemptions]
        finally:
            s.close()
        got[pkg] = (out, calls)
    assert got["port"] == got["ref"]
    assert [c[0] for c in got["port"][1]] == [100, 12, 100, 100, 50]


def test_wait_timeout_falls_back_inline(monkeypatch):
    """A ticket nobody flushes misses wait_timeout: the caller verifies its
    rows inline, the ticket leaves the queue and the fallback is counted."""
    cfgs = _configs(wait_timeout=0.05)
    got = {}
    for pkg in PKGS:
        calls = []
        s = _manual(pkg, cfgs[pkg], _Clock(), monkeypatch, calls)
        try:
            mask = s.verify_rows("light", *_rows(6, "l", bad=(4,)))
            got[pkg] = (mask.tolist(), calls, _stats(s))
        finally:
            s.close()
    assert got["port"] == got["ref"]
    assert got["port"][2]["inline_fallbacks"] == 1
    assert got["port"][2]["lanes"]["light"]["depth_rows"] == 0


@pytest.mark.parametrize("lands", [True, False])
def test_in_flight_ticket_at_wait_timeout(monkeypatch, lands):
    """A ticket that the dispatch thread already holds at wait_timeout: the
    port waits one more wait_timeout for that flush and takes its mask with
    no second verify (lands) or, when the flush does not land by then, falls
    back inline once. The reference falls back at once, verifying the rows
    a second time beside the flush (asserted beside it)."""
    import threading

    cfgs = _configs(wait_timeout=2.0 if lands else 0.05)
    got = {}
    for pkg in PKGS:
        calls = []
        s = _manual(pkg, cfgs[pkg], _Clock(), monkeypatch, calls)
        try:
            ticket = s.submit("catchup", *_rows(6, "c", bad=(1,)))
            with s._cv:
                s._lanes["catchup"].queue.popleft()  # the dispatch thread's take
                s._lanes["catchup"].rows = 0
            out = []
            waiter = threading.Thread(target=lambda: out.append(s._wait_or_fallback(
                ticket, (*_rows(6, "c", bad=(1,)), None))))
            waiter.start()
            if lands:
                waiter.join(3.0)  # the reference is back by now; the port still waits
                s._flush([(ticket, *_rows(6, "c", bad=(1,)), None, None)], {"catchup"})
            waiter.join()
            got[pkg] = (out[0].tolist(), len(calls), s.fallbacks)
        finally:
            s.close()
    mask = [i != 1 for i in range(6)]
    assert got["port"] == ((mask, 1, 0) if lands else (mask, 1, 1))
    assert got["ref"] == ((mask, 2, 1) if lands else (mask, 1, 1))


# ---------------------------------------------------------------------------
# verdicts on real rows


def _signed(n, tag=b"s", corrupt=()):
    pk, ms, sg = [], [], []
    for i in range(n):
        priv = gen_ed25519(bytes([i % 250 + 1, i // 250]) + tag[:1] * 30)
        m = tag + b"-%d" % i
        s = bytearray(priv.sign(m))
        if i in corrupt:
            s[0] ^= 0xFF
        pk.append(priv.pub_key().bytes())
        ms.append(m)
        sg.append(bytes(s))
    return pk, ms, sg


def test_one_corrupted_row_per_lane():
    """votes (inline), light 512 + admission 8 (one combined flush: the
    port's RLC check fails and recovers), then catchup 8 (its own flush);
    the reference on its host arm."""
    lanes = {"light": _signed(512, b"L", (100,)), "admission": _signed(8, b"A", (2,)),
             "catchup": _signed(8, b"C", (5,)), "votes": _signed(8, b"V", (7,))}
    want = {lane: ref_batch.verify_batch(*rows, backend="cpu") for lane, rows in lanes.items()}
    cfgs = _configs(light_max_wait=30.0, admission_max_wait=30.0)
    got = {}
    for pkg, kw in (("ref", dict(backend="cpu")), ("port", dict(backend="cuda"))):
        s = _make(pkg, cfgs[pkg], **kw)
        try:
            tickets = {lane: s.submit(lane, *lanes[lane]) for lane in ("light", "admission")}
            masks = {"votes": s.verify_rows("votes", *lanes["votes"])}
            s.set_lane_wait("admission", 0.0)  # admission triggers, light rides
            masks.update({lane: t.wait(120) for lane, t in tickets.items()})
            masks["catchup"] = s.verify_rows("catchup", *lanes["catchup"])
            log = [sorted(f["rows"].items()) for f in s.flush_log]
        finally:
            s.close()
        got[pkg] = (masks, log)
    for lane in lanes:
        assert got["port"][0][lane].tobytes() == got["ref"][0][lane].tobytes() == \
            want[lane].tobytes(), lane
    assert got["port"][1] == got["ref"][1] == [
        [("votes", 8)], [("admission", 8), ("light", 512)], [("catchup", 8)]]


def test_flush_error_reraises_in_every_ticket(monkeypatch):
    """A verify_batch that raises inside a combined flush: every ticket of
    that flush re-raises it, no consumer verifies inline, and the next
    flush runs on the same thread."""
    calls = []

    def boom(pk, ms, sg, *a, **kw):
        calls.append(len(pk))
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return np.ones(len(pk), dtype=bool)

    monkeypatch.setattr(port_batch, "verify_batch", boom)
    s = port_sched.VerifyScheduler(port_config.SchedulerConfig(light_max_wait=30.0),
                                   device="cpu")
    try:
        t1 = s.submit("light", *_rows(3, "a"))
        t2 = s.submit("light", *_rows(4, "b"))
        s.set_lane_wait("light", 0.0)
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="device fault"):
                t.wait(30)
        acc = s.accumulate("light")
        acc.add(*_rows(2, "c"), None)
        assert acc.flush().all() and acc.flush_seq == 2
        assert calls == [7, 2] and s.fallbacks == 0 and s._thread.is_alive()
        assert s.flush_log[0]["error"] == repr(RuntimeError("device fault"))
    finally:
        s.close()


def test_many_threads_share_the_lanes(monkeypatch):
    """24 threads (more than this host's cores) submit to every lane at once
    with the interpreter switching threads every microsecond, over a stub
    verify_batch that refuses the rows signed b"bad": every consumer gets
    exactly its own rows' verdicts, and each lane counts every row once."""
    import sys
    import threading

    monkeypatch.setattr(port_batch, "verify_batch",
                        lambda pk, ms, sg, *a, **kw: np.array([x != b"bad" for x in sg]))
    s = port_sched.VerifyScheduler(port_config.SchedulerConfig(catchup_max_wait=0.001),
                                   device="cpu")
    lanes = ("votes", "light", "admission", "catchup")
    wrong, sent = [], {lane: 0 for lane in lanes}
    lock = threading.Lock()

    def consumer(k):
        for j in range(20):
            lane = lanes[(k + j) % 4]
            n = 1 + (k * 7 + j) % 9
            bad = {(k + j) % n}
            rows = _rows(n, f"t{k}.{j}.", bad)
            mask = s.verify_rows(lane, *rows)
            if mask.tolist() != [i not in bad for i in range(n)]:
                wrong.append((k, j))
            with lock:
                sent[lane] += n

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consumer, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
        s.close()
    assert not wrong
    st = s.stats()
    assert {lane: st["lanes"][lane]["rows_total"] for lane in lanes} == sent
    assert st["inline_fallbacks"] == 0 and all(
        st["lanes"][lane]["depth_rows"] == 0 for lane in lanes)


def test_lane_accumulator_slices_and_latches(monkeypatch):
    s = port_sched.VerifyScheduler(device="cpu")
    try:
        rows = [_signed(6, b"x", (1,)), _signed(5, b"y")]
        with port_batch.accumulate_flushes(s.accumulate("light")) as acc:
            handles = [port_batch.verify_batch_submit(*r, device="cpu") for r in rows]
        assert acc.lanes == 11
        masks = [port_batch.verify_batch_finish(h) for h in handles]
        want = [ref_batch.verify_batch(*r, backend="cpu") for r in rows]
        assert [m.tobytes() for m in masks] == [w.tobytes() for w in want]
        assert acc.flush_count == 1 and s.stats()["lanes"]["light"]["flushes"] == 1
        with pytest.raises(RuntimeError, match="already flushed"):
            acc.add(*rows[0], None)

        def boom(*a, **kw):
            raise RuntimeError("flush failed")

        monkeypatch.setattr(port_batch, "verify_batch", boom)
        bad = s.accumulate("light")
        bad.add(*rows[1], None)
        for _ in range(2):  # latched: the same error at every later finish
            with pytest.raises(RuntimeError, match="flush failed"):
                bad.flush()
        assert s.accumulate("admission").flush().shape == (0,)
    finally:
        s.close()


def test_lane_scope_routes_commit_checks():
    """verify_commit, begin_verify_commit_light and _trusting inside a
    lane_scope ride the lane; the verdicts equal the direct calls'."""
    from fractions import Fraction

    jset = tbs.JSET
    tset = convert.validator_set_from_reference(jset)
    block, parts = tbs.GOOD[0]
    commit = convert.block_from_reference(tbs.GOOD[1][0]).last_commit
    bid = commit.block_id
    s = port_sched.VerifyScheduler(device="cpu")
    try:
        with s.lane_scope("catchup"):
            tset.verify_commit(tbs.CHAIN, bid, commit.height, commit, device="cpu")
            fin_t = tset.begin_verify_commit_light_trusting(tbs.CHAIN, commit, Fraction(1, 3),
                                                            device="cpu")
            fin_l = tset.begin_verify_commit_light(tbs.CHAIN, bid, commit.height, commit,
                                                   device="cpu")
        fin_t()
        fin_l()
        assert [f["rows"] for f in s.flush_log] == [{"catchup": len(jset.validators)}] * 3
        with pytest.raises(ValueError, match="unknown verify lane"):
            with s.lane_scope("nope"):
                pass
    finally:
        s.close()
    # closed: the scope routes normally again
    with s.lane_scope("catchup"):
        tset.verify_commit(tbs.CHAIN, bid, commit.height, commit, device="cpu")
    assert len(s.flush_log) == 3


def test_quarantine_partition_merges_in_row_order():
    """Rows of a quarantined source ride the quarantine lane, the rest their
    own; the merged mask is in row order and equals the reference's."""
    pk, ms, sg = _signed(40, b"Q", corrupt=(3, 17, 30))
    srcs = ["peer:evil" if i in (3, 17, 25) else f"peer:p{i % 4}" for i in range(40)]
    got = {}
    for pkg in PKGS:
        prov = PKGS[pkg][2]
        prov.default_scorer().record_rows(["peer:evil"] * 3, np.zeros(3, dtype=bool))
        s = _make(pkg, _configs()[pkg], backend="cpu")
        try:
            masks = [s.verify_rows(lane, pk, ms, sg, None, srcs) for lane in ("light", "votes")]
            log = sorted(sorted(f["rows"].items()) for f in s.flush_log)
        finally:
            s.close()
        got[pkg] = ([m.tobytes() for m in masks], log, prov.default_scorer().stats())
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == ref_batch.verify_batch(pk, ms, sg, backend="cpu").tobytes()
    assert [("quarantine", 3)] in got["port"][1]


def test_closed_scheduler_goes_inline():
    pk, ms, sg = _signed(6, b"z", (2,))
    s = port_sched.VerifyScheduler(device="cpu")
    port_sched.set_default(s)
    assert port_sched.default_scheduler() is s
    s.close()
    s.close()
    assert port_sched.default_scheduler() is None and s.closed
    assert s.submit("light", pk, ms, sg) is None
    for lane in ("light", "votes", "catchup"):
        assert s.verify_rows(lane, pk, ms, sg).tolist() == [True, True, False, True, True, True]
    acc = s.accumulate("light")
    acc.add(pk, ms, sg, None)
    assert acc.flush().tolist() == [True, True, False, True, True, True]
    with pytest.raises(ValueError, match="unknown verify lane"):
        s.submit("nope", pk, ms, sg)
    assert s.stats()["closed"] and s.stats()["flushes"] == 1  # the inline vote flush


# ---------------------------------------------------------------------------
# the vote path and blocksync on their lanes


def test_vote_set_flush_rides_the_votes_lane():
    """The same votes with peer IDs into both packages' deferred VoteSets,
    each with its default scheduler installed: the same committed votes and
    failed indices, the flush on the votes lane, the same scorer state."""
    picks = [(i, "a", 0, i in (3, 11, 20), f"p{i % 3}" if i % 5 else "") for i in range(24)]
    picks += [(3, "a", 1, False, "p0"), (30, "b", 0, False, "p1")]
    scheds = {pkg: _make(pkg, _configs()[pkg]) for pkg in PKGS}
    ref_sched.set_default(scheds["ref"])
    port_sched.set_default(scheds["port"])
    try:
        jv = jvset.VoteSet(tvs.CHAIN, tvs.HEIGHT, tvs.ROUND, jbasic.SignedMsgType.PRECOMMIT,
                           tvs.JSET, defer_verification=True)
        tv = tvset.VoteSet(tvs.CHAIN, tvs.HEIGHT, tvs.ROUND, tbasic.SignedMsgType.PRECOMMIT,
                           tvs.TSET, defer_verification=True, device="cpu")
        for idx, block, ts, bad, peer in picks:
            j, t = tvs._vote(tvs.JSET, tvs.PRIV, idx, block, ts, bad)
            assert jv.add_vote(j, peer) == tv.add_vote(t, peer) == "pending"
        (jc, jf), (tc, tf) = jv.flush(), tv.flush()
        assert [v.encode() for v in tc] == [v.encode() for v in jc]
        assert tf == jf == [3, 11, 20]
        for pkg in PKGS:
            assert [sorted(f["rows"]) for f in scheds[pkg].flush_log] == [["votes"]]
        stats = port_prov.default_scorer().stats()
        assert stats == ref_prov.default_scorer().stats()
        assert {w["source"] for w in stats["worst"]} == {"peer:p0", "peer:p2", "lane:votes"}
    finally:
        for s in scheds.values():
            s.close()


@pytest.mark.parametrize("flags", [None, {2: {i: "bad" for i in range(12)}}])
def test_blocksync_run_on_the_catchup_lane(flags):
    chain = tbs.GOOD if flags is None else tbs.make_chain(tbs.JSET, tbs.PRIV_OF, 5, seed=3,
                                                         flags=flags)
    ref, port = tbs.runs(chain)
    tset = convert.validator_set_from_reference(tbs.JSET)
    s = port_sched.VerifyScheduler(device="cpu")
    try:
        got = verify_run_batched(tset, tbs.CHAIN, port, scheduler=s)
        assert [sorted(f["rows"]) for f in s.flush_log] == [["catchup"]]
    finally:
        s.close()
    assert got == tbs.reference_index(tbs.JSET, ref) == (None if flags is None else 2)
    # a closed scheduler: the direct call, as the reference's
    assert verify_run_batched(tset, tbs.CHAIN, port, device="cpu", scheduler=s) == got
