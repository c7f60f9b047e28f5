"""The port's SLO engine (libs/slo.py) against the JAX package's: the same
observations on the same synthetic clock give equal evaluate() and
snapshot() documents, the same trips and re-arms, equal tendermint_slo_*
exposition, the same assert_budgets verdict, and the same flush feed
(set_default / feed_flush, and the port's record_flush feeding it). The
config crosses by convert.slo_config_from_reference. Observations from a
numpy seed. Tolerance: zero (documents, exposition text).
"""

import time

import numpy as np
import pytest

from tendermint_tpu.config.config import SLOConfig as JConfig
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import slo as jslo
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs import slo as tslo
from tendermint_tpu_torch.libs import trace as ttrace


def engines(**cfg):
    ref_cfg = JConfig(**cfg)
    regs = (jmetrics.Registry(), tmetrics.Registry())
    ref = jslo.SLOEngine(ref_cfg, metrics=jmetrics.SLOMetrics(regs[0]))
    port = tslo.SLOEngine(convert.slo_config_from_reference(ref_cfg),
                          metrics=tmetrics.SLOMetrics(regs[1]))
    return ref, port, regs


def both(ref, port, fn):
    a, b = fn(ref), fn(port)
    assert a == b
    return a


def test_config_crosses_field_by_field():
    ref = JConfig(target=0.95, window_fast=5.0, verify_lane_wait_votes=0.01, min_samples=2)
    port = convert.slo_config_from_reference(ref)
    assert vars(port) == vars(ref)
    assert tslo.SLOEngine(port).budgets == jslo.SLOEngine(ref).budgets
    assert tslo.OBJECTIVES == jslo.OBJECTIVES and tslo.MAX_EVENTS == jslo.MAX_EVENTS


def test_synthetic_clock_trips_and_rearms_alike():
    ref, port, regs = engines(window_fast=10.0, window_slow=60.0, min_samples=4,
                              verify_flush_wall=0.1, light_verify_p99=0.2)
    rng = np.random.default_rng(14)
    t, docs = 1000.0, []
    # healthy, then a breach burst (trips), then recovery (re-arms)
    for n, p_bad in ((40, 0.0), (30, 0.9), (60, 0.0)):
        for _ in range(n):
            t += float(rng.uniform(0.2, 0.6))
            bad = bool(rng.random() < p_bad)
            for name, budget in (("verify_flush_wall", 0.1), ("light_verify_p99", 0.2)):
                v = budget * (3.0 if bad else float(rng.uniform(0.1, 0.9)))
                assert both(ref, port, lambda e: e.observe(name, v, ts=t)) is (not bad)
            both(ref, port, lambda e: e.observe("no_such_objective", 9.0, ts=t))
            docs.append(both(ref, port, lambda e: e.evaluate(now=t)))
        both(ref, port, lambda e: (e.tripped("verify_flush_wall"), e.any_tripped()))
    trips = [d["verify_flush_wall"]["tripped"] for d in docs]
    assert any(trips) and not trips[-1] and not trips[0]
    assert docs[-1]["verify_flush_wall"]["trips_total"] >= 1
    assert both(ref, port, lambda e: e.snapshot(now=t))["any_tripped"] is False
    assert regs[1].expose() == regs[0].expose()


def test_assert_budgets_alike():
    ref, port, _ = engines(window_fast=60.0, min_samples=2, verify_lane_wait_votes=0.01)
    now = time.monotonic()
    for k in range(6):
        for e in (ref, port):
            e.observe("verify_lane_wait_votes", 0.5, ts=now - 1.0 + k * 0.01)
    outcome = []
    for e in (ref, port):
        try:
            e.assert_budgets()
            outcome.append(None)
        except AssertionError as err:
            outcome.append(str(err))
    assert outcome[0] == outcome[1] and "verify_lane_wait_votes" in outcome[1]
    for e in (ref, port):
        e.assert_budgets(names=["commit_interval"])  # not tripped: no raise


def test_flush_feed_alike_and_from_record_flush():
    ref, port, _ = engines(verify_flush_wall=0.5)
    prev = (jslo.default_engine(), tslo.default_engine())
    jslo.set_default(ref)
    tslo.set_default(port)
    try:
        for s in (0.1, 0.9, 0.2):
            jslo.feed_flush(s)
            tslo.feed_flush(s)
        ttrace.record_flush(backend="cpu", path="cpu", n=3, total_s=0.7)
        jslo.feed_flush(0.7)
        snap = [e.snapshot()["objectives"]["verify_flush_wall"] for e in (ref, port)]
        for s in snap:
            del s["burn_rate"]  # read at two moments of the real clock
        assert snap[0] == snap[1] and snap[1]["observations"] == 4 and snap[1]["breaches"] == 2
    finally:
        jslo.set_default(prev[0])
        tslo.set_default(prev[1])
    assert tslo.default_engine() is prev[1]


@pytest.mark.parametrize("target", [0.0, 0.5, 1.0])
def test_target_clamp_alike(target):
    ref, port, _ = engines(target=target, min_samples=1)
    for e in (ref, port):
        e.observe("commit_interval", 100.0, ts=5.0)
    assert both(ref, port, lambda e: (e.target, e.evaluate(now=6.0)))
