"""The verify path's metrics: the port's series (libs/metrics.py, fed by
libs/trace.record_flush, crypto/batch.py, crypto/provenance.py,
crypto/scheduler.py and light/service.py) held against the JAX package's
on the same inputs.

- Flushes: the process-global registry's tendermint_batch_verify_* and
  tendermint_device_* samples are read before and after one verify_batch in
  each package, and the deltas must be equal: on the host arm (128 rows,
  and a 6-row set of Ed25519, sr25519 and BLS12-381 rows through the
  per-type split), and on the card arm with device="cpu" (the kernels'
  plain versions) at 300 rows: the per-signature ladder, the single
  combined check with RLC_MIN lowered to 256 (stream off), and its failed
  check recovered by one ladder pass (TMTPU_BISECT=0). The reference's
  card arm runs on its host twins (tests/torch_routing_util.py), its
  backend label "jax" read as the port's "cuda". Counts, row totals,
  buckets of size histograms and gauge values compare exactly; series that
  hold seconds compare by whether they moved, and their histograms by
  count.
- Device health, build accounting and slope samples: mark_device_call,
  device_health, record_compile, compile_seconds_total and
  record_slope_samples as the reference's; a failing
  device call raises after marking the device down (no fallback); an nvcc
  build and a library load of ops/cuda_fe.build_library (nvcc stubbed)
  each count, and a failed build raises and counts nothing.
- The scheduler's lane series and SLO lane waits on scripted traffic with
  no dispatch thread under a fake clock, and the light service's counters
  and latency observations on waves of requests: exposition text equal to
  the reference's (the light service's lanes per coalesced batch by their
  sum only: which misses share a batch depends on thread timing).

Tolerance: zero, except the seconds series and the batch split named above.
"""

import asyncio
import glob
import os
import threading

import numpy as np
import pytest

from tendermint_tpu.config import config as ref_config
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import provenance as jprov
from tendermint_tpu.crypto import scheduler as jsched
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import slo as jslo
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.light import provider as jprovider
from tendermint_tpu.light import service as jservice
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import provenance as tprov
from tendermint_tpu_torch.crypto import scheduler as tsched
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs import slo as tslo
from tendermint_tpu_torch.libs import trace as ttrace
from tendermint_tpu_torch.light import provider as tprovider
from tendermint_tpu_torch.light import service as tservice
from tendermint_tpu_torch.ops import cuda_fe, msm_torch
from tests import test_torch_light_service as tls
from tests.test_torch_scheduler import _Clock, _manual, _rows, _step
from tests.torch_routing_util import install_mixed_twins, knobs, rows_with  # noqa: F401

SECONDS = ("flush_seconds", "prep_seconds", "transfer_seconds_total", "compile_seconds_total",
           "prep_overlap_seconds_total", "prep_hidden_ratio", "device_init_seconds",
           "device_last_call_timestamp_seconds")
FAMILY_PREFIXES = ("tendermint_batch_verify_", "tendermint_device_")


@pytest.fixture(autouse=True)
def _isolated():
    """The port's memo off (tests/conftest.py turns the reference's off) and
    fresh scorers in both packages."""
    prev_memo, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    prev = (jprov.set_default(jprov.SuspicionScorer()), tprov.set_default(tprov.SuspicionScorer()))
    yield
    tbatch._MEMO = prev_memo
    jprov.set_default(prev[0])
    tprov.set_default(prev[1])


def scrape(mod) -> dict:
    """{(sample name, sorted labels): value} of the verify-path families,
    the backend label "jax" read as "cuda"."""
    out = {}
    for fam, body in mod.parse_exposition(mod.global_registry().expose()).items():
        if not fam.startswith(FAMILY_PREFIXES) or "_breaker_" in fam:
            continue
        for name, labels, value in body["samples"]:
            if labels.get("backend") == "jax":
                labels = dict(labels, backend="cuda")
            out[(fam, name, tuple(sorted(labels.items())))] = value
    return out


def moved(before: dict, after: dict) -> dict:
    """The samples that changed, normalized: seconds series as True (and
    their histogram buckets and sums dropped), gauges as their new value,
    everything else as its delta."""
    out = {}
    for key, v in after.items():
        fam, name, labels = key
        d = v - before.get(key, 0.0)
        if d == 0:
            continue
        if any(fam.endswith(s) for s in SECONDS):
            if name.endswith(("_bucket", "_sum")):
                continue
            out[key] = d if name.endswith("_count") else True
        elif name == fam and not fam.endswith("_total"):  # a gauge
            out[key] = v
        else:
            out[key] = d
    return out


def series_moves(ref_call, port_call):
    """Both calls' metric moves (reference first). Every gauge of both
    packages is cleared first, so a gauge the call sets moves whatever an
    earlier test left in it."""
    for mod in (jmetrics, tmetrics):
        for m in mod.global_registry()._metrics:
            if isinstance(m, mod.Gauge):
                m.replace_series({})
    b = scrape(jmetrics)
    ref_call()
    ref_moved = moved(b, scrape(jmetrics))
    b = scrape(tmetrics)
    port_call()
    return ref_moved, moved(b, scrape(tmetrics))


def counter(name: str, **labels) -> tuple:
    full = f"tendermint_batch_verify_{name}"
    return (full, full, tuple(sorted(labels.items())))


def test_host_arm_flush_moves_the_same_series():
    pks, msgs, sigs = rows_with(128, bad=(5,))
    ref_moved, port_moved = series_moves(
        lambda: jbatch.verify_batch(pks, msgs, sigs, backend="cpu"),
        lambda: tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cpu"))
    assert port_moved == ref_moved
    assert port_moved[counter("flushes_total", backend="cpu", path="cpu")] == 1
    assert port_moved[counter("sigs_total", backend="cpu", path="cpu")] == 128
    assert port_moved[counter("backend_rows_total", backend="ed25519")] == 128


def test_mixed_split_counts_each_scheme():
    sr_keys = [tsr.gen_sr25519(bytes([0x70 + i]) * 32) for i in range(2)]
    pks, msgs, sigs = rows_with(3)
    types = ["ed25519"] * 3
    for i, k in enumerate(sr_keys):
        m = b"sr row %d" % i
        pks.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(k.sign(m))
        types.append("sr25519")
    pks.append(b"\x11" * 48)  # a BLS row whose 95-byte signature is False unpaired
    msgs.append(b"bls row")
    sigs.append(b"\x00" * 95)
    types.append("bls12_381")
    got = {}
    ref_moved, port_moved = series_moves(
        lambda: got.setdefault("ref", jbatch.verify_batch(pks, msgs, sigs, backend="cpu",
                                                          key_types=types)),
        lambda: got.setdefault("port", tbatch.verify_batch(pks, msgs, sigs, device="cpu",
                                                           backend="cpu", key_types=types)))
    assert got["port"].tobytes() == got["ref"].tobytes()
    assert port_moved == ref_moved
    for scheme, rows in (("ed25519", 3), ("sr25519", 2), ("bls12_381", 1)):
        assert port_moved[counter("backend_rows_total", backend=scheme)] == rows


@pytest.mark.parametrize("arm", ["persig", "rlc", "rlc_recovered"])
def test_card_arm_flush_moves_the_same_series(knobs, monkeypatch, arm):
    install_mixed_twins(monkeypatch)
    bad = (7, 201) if arm == "rlc_recovered" else ()
    pks, msgs, sigs = rows_with(300, bad=bad)
    if arm != "persig":
        for mod in (tbatch, jbatch):
            monkeypatch.setattr(mod, "RLC_MIN", 256)
        knobs.prep(stream=False)
    if arm == "rlc_recovered":
        monkeypatch.setenv("TMTPU_BISECT", "0")
    got = {}
    ref_moved, port_moved = series_moves(
        lambda: got.setdefault("ref", jbatch.verify_batch(pks, msgs, sigs, backend="jax")),
        lambda: got.setdefault("port", tbatch.verify_batch(pks, msgs, sigs, device="cpu",
                                                           backend="cuda")))
    assert got["port"].tobytes() == got["ref"].tobytes()
    path = tbatch.LAST_FLUSH["path"]
    assert path == jtrace.verify_stats()["last_flush"]["path"]
    assert port_moved == ref_moved
    assert port_moved[counter("flushes_total", backend="cuda", path=path)] == 1
    up = ("tendermint_device_up", "tendermint_device_up", ())
    assert scrape(tmetrics)[up] == 1 and ttrace.device_health()["device_up"] == 1
    if arm == "rlc":
        assert path == "rlc" and port_moved[counter("pubkey_cache_misses_total")] == 300
        assert tbatch.LAST_FLUSH["h2d_bytes"] > 0 and tbatch.LAST_FLUSH["device_dispatches"] == 0
    if arm == "rlc_recovered":
        assert port_moved[counter("recovery_flushes_total")] == 1


def test_device_health_and_compile_accounting_as_the_reference():
    for mod in (jtrace, ttrace):
        mod.mark_device_call(ok=False, error="boom")
    r, p = jtrace.device_health(), ttrace.device_health()
    assert set(p) == set(r) and p["device_up"] == r["device_up"] == 0
    assert p["last_error"] == r["last_error"] == "boom"
    for mod in (jtrace, ttrace):
        mod.mark_device_call(ok=True)
    r, p = jtrace.device_health(), ttrace.device_health()
    assert set(p) == set(r) and p["device_up"] == r["device_up"] == 1 and p["last_error"] is None
    assert p["last_call_age_s"] is not None and p["last_call_age_s"] < 60
    assert ttrace.verify_stats()["device"]["device_up"] == 1
    ttrace.record_device_init(0.25)
    assert ttrace.device_health()["init_seconds"] == 0.25
    b = scrape(tmetrics)
    t0 = ttrace.compile_seconds_total()
    ttrace.record_compile("k", 0.5, "build")
    ttrace.record_compile("k", 0.125, "load")
    assert ttrace.compile_seconds_total() - t0 == 0.625
    d = moved(b, scrape(tmetrics))
    fam = "tendermint_batch_verify_compile_seconds_total"
    assert {k[2] for k in d if k[0] == fam} == {(("kind", "build"),), (("kind", "load"),)}


def test_concurrent_flushes_count_their_own_thread_dispatches():
    """Two threads submit at once, as the scheduler's dispatch thread and an
    inline votes flush do: each flush detail's device_dispatches and
    h2d_bytes are its own thread's launches and uploads. The launches go
    through the wrappers' launch accounting (cuda_fe._launched), in lockstep
    rounds so they interleave."""
    from tendermint_tpu_torch.ops import cuda_msm

    rounds, barrier, details = 5, threading.Barrier(2), {}
    saved = dict(cuda_fe.LAUNCHES), dict(cuda_msm.LAUNCHES)

    def flush(name, per_round, launches, nbytes):
        before = msm_torch.flush_counters()
        for _ in range(rounds):
            barrier.wait()
            for _ in range(per_round):
                cuda_fe._launched(name, 0, launches)
            msm_torch._to_device(np.zeros(nbytes, np.uint8), "cpu")
        details[name] = {}
        tbatch._submit_counters(details[name], before)

    threads = [threading.Thread(target=flush, args=("padd", 1, cuda_fe.LAUNCHES, 32)),
               threading.Thread(target=flush, args=("uptree", 3, cuda_msm.LAUNCHES, 64))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        cuda_fe.LAUNCHES.update(saved[0])
        cuda_msm.LAUNCHES.update(saved[1])
    assert details == {"padd": {"h2d_bytes": 32 * rounds, "device_dispatches": rounds},
                       "uptree": {"h2d_bytes": 64 * rounds, "device_dispatches": 3 * rounds}}


def test_slope_samples_as_the_reference():
    samples = [(1, 0.0105), (2, 0.0202), (4, 0.0409), (8, 0.0811)]
    for mod in (jtrace, ttrace):
        mod.record_slope_samples(samples, slope_ms=10.1, fused=True)
    r, p = (dict(m.verify_stats()["slope_samples"]["fit"]) for m in (jtrace, ttrace))
    assert abs(p.pop("recorded_at") - r.pop("recorded_at")) < 60
    assert p == r and p["samples"] == [list(x) for x in samples] and p["source"] == "bench"


def test_a_device_error_marks_the_device_down_and_raises(knobs, monkeypatch):
    """No fallback: the failing call raises after mark_device_call(ok=False);
    the next good call reads device_up 1 again."""
    from tendermint_tpu_torch.ops import ed25519_torch

    pks, msgs, sigs = rows_with(4)

    def fail(*a, **k):
        raise RuntimeError("CUDA launch of padd failed: cudaError 700")

    real = ed25519_torch.verify_prepared
    monkeypatch.setattr(ed25519_torch, "verify_prepared", fail)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cuda")
    h = ttrace.device_health()
    assert h["device_up"] == 0 and "cudaError 700" in h["last_error"]
    assert scrape(tmetrics)[("tendermint_device_up", "tendermint_device_up", ())] == 0
    monkeypatch.setattr(msm_torch, "rlc_check_submit", fail)
    monkeypatch.setattr(tbatch, "RLC_MIN", 256)
    knobs.prep(stream=False)
    pks, msgs, sigs = rows_with(260)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cuda")
    assert ttrace.device_health()["device_up"] == 0
    monkeypatch.setattr(ed25519_torch, "verify_prepared", real)
    pks, msgs, sigs = rows_with(4)
    assert tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cuda").all()
    assert ttrace.device_health()["device_up"] == 1


def test_build_library_counts_builds_and_loads(monkeypatch, tmp_path):
    """nvcc stubbed by a copy of the native host library: the build and the
    load are each a record_compile; a cached library is a load only; a
    failed build raises and records nothing."""
    native._lib()
    so = sorted(glob.glob(os.path.join(os.path.dirname(native.__file__), "_build", "*.so")))[-1]
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(so, "rb") as src, open(out, "wb") as dst:
            dst.write(src.read())
        return type("R", (), {"returncode": 0, "stderr": "ptxas info: Used 1 registers"})()

    monkeypatch.setattr(cuda_fe, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_fe, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_fe.subprocess, "run", fake_run)
    monkeypatch.setattr(cuda_fe, "_LIBS", {})  # no library loaded in this test's view
    fam = "tendermint_batch_verify_compile_seconds_total"
    b = scrape(tmetrics)
    lib = cuda_fe.build_library("point_kernels", cuda_fe.SOURCES, lambda lib: None)
    assert lib is not None and len(calls) == 1
    d = moved(b, scrape(tmetrics))
    assert {k[2] for k in d if k[0] == fam} == {(("kind", "build"),), (("kind", "load"),)}
    cuda_fe._LIBS.pop("point_kernels")
    b = scrape(tmetrics)
    cuda_fe.build_library("point_kernels", cuda_fe.SOURCES, lambda lib: None)
    assert len(calls) == 1  # cached on disk: no nvcc
    d = moved(b, scrape(tmetrics))
    assert {k[2] for k in d if k[0] == fam} == {(("kind", "load"),)}
    cuda_fe._LIBS.pop("point_kernels")
    for f in tmp_path.iterdir():
        f.unlink()
    monkeypatch.setattr(cuda_fe.subprocess, "run", lambda cmd, **kw: type(
        "R", (), {"returncode": 1, "stderr": "error: no"})())
    b = scrape(tmetrics)
    with pytest.raises(RuntimeError, match="nvcc build of point_kernels failed"):
        cuda_fe.build_library("point_kernels", cuda_fe.SOURCES, lambda lib: None)
    assert not {k for k in moved(b, scrape(tmetrics)) if k[0] == fam}
    assert "point_kernels" not in cuda_fe._LIBS


def test_poisoned_sources_gauge_as_the_reference():
    gauge = ("tendermint_batch_verify_poisoned_sources",) * 2 + ((),)
    for prov, mmod in ((jprov, jmetrics), (tprov, tmetrics)):
        s = prov.SuspicionScorer()
        s.record_rows(["peer:a"] * 3 + ["peer:b"], np.array([0, 0, 0, 1], dtype=bool))
        assert scrape(mmod)[gauge] == len(s.quarantined_sources()) == 1
        s.reset()
        assert scrape(mmod)[gauge] == 0


def test_scheduler_lane_series_equal_the_reference(monkeypatch):
    """Scripted traffic on both schedulers with no dispatch thread, one fake
    clock: queued rows on two lanes, an inline votes flush while they wait
    (a preemption), then the planned flushes; the SchedulerMetrics and
    SLOMetrics exposition text equal to the reference's."""
    out = {}
    for pkg, smod, mmod, lmod, cfg_of in (
            ("ref", jsched, jmetrics, jslo, lambda c: c),
            ("port", tsched, tmetrics, tslo, convert.scheduler_config_from_reference)):
        clock, calls = _Clock(), []
        cfg = cfg_of(ref_config.SchedulerConfig(light_max_wait=0.01, catchup_max_wait=0.2))
        s = _manual(pkg, cfg, clock, monkeypatch, calls)
        reg = mmod.Registry()
        slo_cfg = ref_config.SLOConfig()
        if pkg == "port":
            slo_cfg = convert.slo_config_from_reference(slo_cfg)
        s.metrics = mmod.SchedulerMetrics(reg)
        s.slo = lmod.SLOEngine(slo_cfg, metrics=mmod.SLOMetrics(reg))
        s.submit("catchup", *_rows(5, "c"))
        clock.t += 0.05
        s.submit("light", *_rows(3, "l"))
        assert s.verify_rows("votes", *_rows(2, "v")).all()
        steps = []
        for _ in range(4):
            clock.t += 0.1
            steps.append(_step(s))
        out[pkg] = (reg.expose(), steps, calls, s.preemptions)
    assert out["port"] == out["ref"]
    assert "tendermint_verify_lane_preemptions_total 1" in out["port"][0]


def test_light_service_counters_equal_the_reference():
    chain_id, jblocks, tblocks, now, period = tls.CHAINS["bench"]
    jcfg = ref_config.LightServiceConfig(trust_period=period / 1e9, coalesce_window=0.02,
                                         max_heights_per_flush=9, max_pending=0)
    exposition = {}
    for pkg in ("ref", "port"):
        mmod, lmod = (jmetrics, jslo) if pkg == "ref" else (tmetrics, tslo)
        reg = mmod.Registry()
        slo_cfg = ref_config.SLOConfig(light_verify_p99=1e6)
        if pkg == "port":
            slo_cfg = convert.slo_config_from_reference(slo_cfg)
        kw = dict(metrics=mmod.LightServiceMetrics(reg),
                  slo=lmod.SLOEngine(slo_cfg, metrics=mmod.SLOMetrics(reg)), now_ns=lambda: now)
        if pkg == "ref":
            svc = jservice.LightService(chain_id, jprovider.MockProvider(chain_id, jblocks), jcfg,
                                        **kw)
        else:
            svc = tservice.LightService(chain_id, tprovider.MockProvider(chain_id, tblocks),
                                        convert.light_service_config_from_reference(jcfg),
                                        device="cpu", **kw)
        waves = tls.zipf_waves(8, 8, 48)
        wrong = {waves[-1][0]: b"\x00" * 32}  # the last wave: a conflicting expected hash

        async def go(svc=svc):
            for i, wave in enumerate(waves):
                expect = wrong if i == len(waves) - 1 else {}
                await asyncio.gather(*[tls._answer(svc, h, expect.get(h)) for h in wave])

        try:
            asyncio.run(go())
        finally:
            svc.close()
        # which misses share a batch depends on thread timing: the lanes per
        # batch (buckets, count) are dropped, their sum is not
        exposition[pkg] = "\n".join(
            line for line in reg.expose().splitlines()
            if not line.startswith(("tendermint_light_coalesced_lanes_per_flush_bucket",
                                    "tendermint_light_coalesced_lanes_per_flush_count")))
    assert exposition["port"] == exposition["ref"]
    fams = tmetrics.parse_exposition(exposition["port"])
    outcomes = {s[1]["outcome"]: s[2] for s in fams["tendermint_light_requests_total"]["samples"]}
    assert sum(outcomes.values()) == 48 and outcomes.get("conflict", 0) >= 1
