"""The port's metrics core (libs/metrics.py) against the JAX package's: one
sequence of counter, gauge and histogram calls on each package's Registry
gives identical exposition text and snapshots; parse_exposition reads both
alike and refuses the same malformed lines; the families the port feeds
(BatchVerifyMetrics less its three breaker_* series, SLOMetrics,
LightServiceMetrics, SchedulerMetrics, MeshMetrics, ObservatoryMetrics,
FleetMetrics) have the reference's series names, kinds, help, label names
and buckets, and the global registry holds the reference's families less
its pubsub counter and breaker series. Fresh Registry objects only: the
process-global registry is read, never written, so the file is order-free.
Tolerance: zero (exposition text, parsed samples).
"""

import pytest

from tendermint_tpu.libs import metrics as J
from tendermint_tpu_torch.libs import metrics as T

FAMILIES = ("BatchVerifyMetrics", "SLOMetrics", "LightServiceMetrics", "SchedulerMetrics",
            "MeshMetrics", "ObservatoryMetrics", "FleetMetrics")


def drive(mod):
    """One fixed sequence of metric calls; returns the registry."""
    reg = mod.Registry()
    c = reg.counter("t_requests_total", "Requests.", ("method", "code"))
    u = reg.counter("t_plain_total", "Unlabeled.")
    g = reg.gauge("t_depth", "Depth.", ("lane",))
    gu = reg.gauge("t_up", "Up.")
    h = reg.histogram("t_wait_seconds", "Waits.", ("lane",), buckets=(0.001, 0.01, 0.1, 1.0))
    hd = reg.histogram("t_size", "Sizes (default buckets).")
    reg.counter("t_never_total", "Never written.", ("x",))
    c.labels("get", 200).inc()
    c.labels("get", "200").inc(2.5)
    c.labels("post", 500).inc(3)
    u.inc()
    u.inc(0.25)
    g.labels("votes").set(7)
    g.labels("light").set(0.125)
    g.labels("votes").inc(2)
    gu.set(1)
    gu.dec(0.5)
    for v, lane in ((0.0005, "votes"), (0.05, "votes"), (3.0, "catchup"), (0.01, "votes")):
        h.labels(lane).observe(v)
    for v in (1, 7, 64, 1e6):
        hd.observe(v)
    g.replace_series({("a",): 1, ("b",): 2.5})
    return reg


def test_the_same_calls_give_identical_exposition_and_snapshots():
    rj, rt = drive(J), drive(T)
    assert rt.expose() == rj.expose()
    assert rt.snapshot() == rj.snapshot()
    assert T.parse_exposition(rt.expose()) == J.parse_exposition(rj.expose())


def test_parse_exposition_round_trips():
    text = drive(T).expose()
    fams = T.parse_exposition(text)
    assert fams["t_requests_total"]["type"] == "counter"
    assert ("t_requests_total", {"method": "get", "code": "200"}, 3.5) in \
        fams["t_requests_total"]["samples"]
    assert ("t_wait_seconds_bucket", {"lane": "votes", "le": "+Inf"}, 3.0) in \
        fams["t_wait_seconds"]["samples"]
    assert fams["t_never_total"]["samples"] == []
    lines = []  # rebuilt from the parse: the same text
    for name, fam in fams.items():
        lines += [f"# HELP {name} {fam['help']}", f"# TYPE {name} {fam['type']}"]
        for sname, labels, value in fam["samples"]:
            lab = ", ".join(f'{k}="{v}"' for k, v in labels.items())
            val = "+Inf" if value == float("inf") else T._num(value)
            lines.append(f"{sname}{{{lab}}} {val}" if labels else f"{sname} {val}")
    assert "\n".join(lines) + "\n" == text


@pytest.mark.parametrize("bad", ["# NOTE x", "t_x{a=1} 2", "t_orphan 1", "t_x 1 2"])
def test_parse_exposition_refuses_what_the_reference_refuses(bad):
    text = "# HELP t_x X.\n# TYPE t_x counter\n" + bad + "\n"
    outcome = []
    for mod in (J, T):
        try:
            outcome.append(mod.parse_exposition(text))
        except ValueError as e:
            outcome.append(("ValueError", str(e)))
    assert outcome[0] == outcome[1]


def test_label_count_and_unlabeled_inc_errors():
    for mod in (J, T):
        reg = mod.Registry()
        c = reg.counter("t_c_total", "C.", ("a",))
        with pytest.raises(ValueError):
            c.labels("x", "y")
        with pytest.raises(ValueError):
            c.inc()
        with pytest.raises(ValueError, match="duplicate"):
            reg.counter("t_c_total", "C.")


def _catalog(reg):
    out = {}
    for m in reg._metrics:
        out[m.name] = (m.kind, m.help, m.label_names, getattr(m, "buckets", None))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_families_equal_the_reference_less_the_breaker(family):
    rj, rt = J.Registry(), T.Registry()
    getattr(J, family)(rj)
    getattr(T, family)(rt)
    want = {k: v for k, v in _catalog(rj).items() if "_breaker_" not in k}
    assert _catalog(rt) == want
    exp = "\n".join(line for line in rj.expose().split("\n") if "_breaker_" not in line)
    assert rt.expose() == exp
    if family == "BatchVerifyMetrics":
        assert len(_catalog(rj)) - len(want) == 3


def test_global_registry_holds_the_batch_family_only():
    reg = T.global_registry()
    assert T.global_registry() is reg
    names = {m.name for m in reg._metrics}
    fresh = T.Registry()
    for family in (T.BatchVerifyMetrics, T.ChaosMetrics, T.MeshMetrics, T.ObservatoryMetrics,
                   T.FleetMetrics):
        family(fresh)
    assert names == {m.name for m in fresh._metrics}
    # the reference's global registry less its pubsub counter and breaker series
    want = {m.name for m in J.global_registry()._metrics
            if "_breaker_" not in m.name and "_pubsub_" not in m.name}
    assert names == want
    assert T.chaos_metrics() is T.chaos_metrics()
    for getter in ("mesh_metrics", "observatory_metrics", "fleet_metrics"):
        assert getattr(T, getter)() is getattr(T, getter)()
    assert T.batch_metrics().flushes.name == "tendermint_batch_verify_flushes_total"
    assert T.batch_metrics() is T.batch_metrics()
