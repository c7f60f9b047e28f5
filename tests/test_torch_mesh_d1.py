"""The sharded mesh under D1: the tier-1 cases of tests/test_elastic_mesh.py
run on the port beside the reference, and the mesh cases of
tests/test_mesh_telemetry.py that the port can now feed.

The reference's elastic mesh REPLAYS a flush whose shard failed, on the
survivor mesh or one chip. The port does not (ROADMAP D1): the failure is
scored against the shard in the health model, the mesh is dropped so the
next one is built on the healthy devices, and the flush raises a device
error (crypto/batch.is_device_error). Each case runs the port and then the
reference on the same rows, the reference's test double for the elastic
rung selection over 8 fake device keys (`_ElasticMesh`) and host-twin
runners (tests/test_flush_planner.py) wrapped in each package's real
parallel/sharded._guarded, so chaos shard faults and health scoring ride
both packages' dispatch paths.

- a shard fault at each chunk boundary raises in the port; the reference
  replays and returns the unfaulted mask;
- a lost device is struck dead at the fail threshold and the next mesh is
  built on the survivors, where later flushes stay sharded;
- an unattributed failure raises and kills no device;
- a bad signature is not a fault: no strike, exact-mask recovery;
- rejoin needs N consecutive clean probes; a rebuild never blocks a
  concurrent flush; prewarm builds the half mesh;
- the chaos schedule's mesh kinds round-trip through the port's injector and
  LocalChaosNet adapters;
- make_mesh records the mesh, a sharded flush its flush and pad records.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.chaos.device import DeviceFaultInjector as RefInjector  # noqa: E402
from tendermint_tpu.crypto import batch as ref_batch  # noqa: E402
from tendermint_tpu.parallel import health as ref_health  # noqa: E402
from tendermint_tpu.parallel import sharded as ref_sharded  # noqa: E402
from tendermint_tpu_torch.chaos import DeviceFaultInjector  # noqa: E402
from tendermint_tpu_torch.chaos.harness import LocalChaosNet  # noqa: E402
from tendermint_tpu_torch.chaos.schedule import LEVEL_BY_KIND, ChaosSchedule  # noqa: E402
from tendermint_tpu_torch.crypto import batch  # noqa: E402
from tendermint_tpu_torch.parallel import health, sharded  # noqa: E402
from tendermint_tpu_torch.parallel import telemetry as tm  # noqa: E402

from tests.test_elastic_mesh import DEVKEYS, _ElasticMesh  # noqa: E402
from tests.test_flush_planner import _fake_mesh_env, _install_host_twins, _signed_rows  # noqa: E402

CPU = torch.device("cpu")


class _PortElasticMesh:
    """The port's twin of the reference's _ElasticMesh: the elastic rung
    selection (healthy filter -> largest power of two, no breaker: D1) over
    8 fake device keys, with host-twin runners wrapped in the port's
    sharded._guarded: the streamed pair, the combined check and the
    per-signature ladder (the reference's host twin of verify_prepared)."""

    def __init__(self, devices=DEVKEYS):
        self.devices = list(devices)
        self._cache = {}
        self.builds = []

    def env_for(self, devs):
        from tendermint_tpu.ops import ed25519_jax

        key = tuple(devs)
        env = self._cache.get(key)
        if env is None:
            nd, d = len(devs), list(devs)
            base_run, base_fin = _fake_mesh_env(nd)[3]
            ladder = ed25519_jax.verify_prepared  # the host twin, once installed

            def rlc(pts, perm, ends):
                acc, ok = base_run(pts, perm, ends, None)
                return bool(base_fin(acc)), np.asarray(ok).reshape(-1)

            env = (
                nd,
                lambda a, r, s, h: sharded._guarded("mesh_persig_submit", d, ladder, a, r, s, h),
                lambda pts, perm, ends: sharded._guarded("mesh_rlc_submit", d, rlc, pts, perm, ends),
                (lambda pts, perm, ends, acc: sharded._guarded(
                    "mesh_rlc_stream_submit", d, base_run, pts, perm, ends, acc),
                 lambda acc: sharded._guarded("mesh_rlc_stream_finish", d, base_fin, acc)),
            )
            self._cache[key] = env
            self.builds.append(nd)
        return env

    def __call__(self):
        healthy = [str(d) for d in health.MESH_HEALTH.healthy_devices(self.devices)]
        if not healthy:
            return None
        nd = 1 << (len(healthy).bit_length() - 1)
        if nd < 2:
            return None
        return self.env_for(healthy[:nd])


@pytest.fixture
def meshes(monkeypatch):
    """Both packages at the reference's planner geometry (RLC_MIN 8, a
    64-lane budget: 31 rows a chunk), host twins installed, fresh health
    models (fail threshold 2, rejoin after 3 probes, an always-passing
    probe, no probe thread), the reference's breaker reset, and each
    package's _sharded_env pinned to its elastic double. Yields (port
    double, reference double)."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    _install_host_twins(monkeypatch)
    monkeypatch.setattr(ref_batch, "RLC_MIN", 8)
    monkeypatch.setattr(batch, "RLC_MIN", 8)
    budgets = (ref_batch.planner_budget(), batch.planner_budget())
    ref_batch.configure_planner(max_flush_lanes=64)
    batch.configure_planner(max_flush_lanes=64)
    prev_memo, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    hm = health.MeshHealthManager(probe=lambda key: None)
    hm._spawn_probe_thread = False
    monkeypatch.setattr(health, "MESH_HEALTH", hm)
    rh = ref_health.MESH_HEALTH
    saved = (dict(rh._cfg), rh._spawn_probe_thread)
    rh.reset()
    rh.configure(enabled=True, fail_threshold=2, stall_threshold_s=0.0, rejoin_probes=3)
    rh.set_probe(lambda key: None)
    rh._spawn_probe_thread = False
    prev_thr = ref_batch.BREAKER.failure_threshold
    ref_batch.BREAKER.reset()
    ref_batch.BREAKER.configure(failure_threshold=3)
    ref_batch._SHARDED_RUNNER = None
    port_em, ref_em = _PortElasticMesh(), _ElasticMesh()
    monkeypatch.setattr(batch, "_sharded_env", port_em)
    monkeypatch.setattr(ref_batch, "_sharded_env", ref_em)
    tm.reset()
    yield port_em, ref_em
    sharded.set_shard_fault_hook(None)
    ref_sharded.set_shard_fault_hook(None)
    batch.set_device_fault_hook(None)
    ref_batch.set_device_fault_hook(None)
    rh.set_probe_intercept(None)
    rh.set_probe(None)
    rh.reset()
    rh._cfg.update(saved[0])
    rh._spawn_probe_thread = saved[1]
    ref_batch.BREAKER.reset()
    ref_batch.BREAKER.configure(failure_threshold=prev_thr)
    ref_batch._SHARDED_RUNNER = None
    ref_batch.configure_planner(max_flush_lanes=budgets[0])
    batch.configure_planner(max_flush_lanes=budgets[1])
    batch._MEMO = prev_memo
    tm.reset()


def _port_raises(pks, msgs, sigs) -> BaseException:
    with pytest.raises(Exception) as ei:
        batch._verify_batch_streamed(pks, msgs, sigs, CPU)
    assert batch.is_device_error(ei.value)
    return ei.value


# ------------------------------------------------------- faults under D1


@pytest.mark.parametrize("fault_at", [0, 1, 2, 3], ids=["submit0", "submit1", "submit2", "finish"])
def test_shard_fault_at_every_chunk_boundary_raises(meshes, fault_at):
    """93 rows = 3 chunks -> 4 guarded dispatch sites (3 submits and the
    finish). A one-shot shard fault at each site: the port raises it,
    marked a device error, strikes the shard once and drops the mesh; the
    reference replays the flush and returns the unfaulted mask."""
    port_em, ref_em = meshes
    pks, msgs, sigs = _signed_rows(93)
    baseline = batch._verify_batch_streamed(pks, msgs, sigs, CPU)
    assert batch._PATH.label == "rlc-sharded-streamed" and baseline.all()
    assert batch.LAST_FLUSH["chunks"] == 3 and batch.LAST_FLUSH["shards"] == 8
    ref_base = ref_batch._verify_batch_streamed(pks, msgs, sigs)
    assert ref_base.tobytes() == baseline.tobytes()

    def hook_at(fault_at, calls, errtype):
        def hook(site, devices):
            k = calls[0]
            calls[0] += 1
            if k == fault_at:
                raise errtype(site, 2, devices[2])
        return hook

    sharded.set_shard_fault_hook(hook_at(fault_at, [0], sharded.ShardFaultError))
    batch._SHARDED_RUNNER = ("sentinel", None)
    err = _port_raises(pks, msgs, sigs)
    sharded.set_shard_fault_hook(None)
    assert isinstance(err, sharded.ShardFaultError) and err.shard == 2
    assert batch._SHARDED_RUNNER is None  # the mesh was dropped
    dh = health.MESH_HEALTH.snapshot()["devices"][DEVKEYS[2]]
    assert dh["state"] == "healthy" and dh["failures_total"] == 1
    # the next flush passes on the same (still healthy) mesh
    assert batch._verify_batch_streamed(pks, msgs, sigs, CPU).tobytes() == baseline.tobytes()
    assert port_em.builds == [8]

    ref_sharded.set_shard_fault_hook(hook_at(fault_at, [0], ref_sharded.ShardFaultError))
    mask = ref_batch._verify_batch_streamed(pks, msgs, sigs)
    ref_sharded.set_shard_fault_hook(None)
    assert mask.tobytes() == baseline.tobytes()
    assert ref_batch.LAST_FLUSH_DETAIL.get("mesh_replays") == 1
    assert ref_em.builds == [8]


def test_device_lost_is_struck_and_survivor_mesh_built(meshes):
    """Device 7 of 8 lost: in the port the first flush raises (strike 1),
    the second raises and marks it DEAD (strike 2), and the next flush
    runs sharded on the 4-device survivor mesh with the baseline mask. The
    reference does the same descent inside ONE flush by two replays."""
    port_em, ref_em = meshes
    pks, msgs, sigs = _signed_rows(93)
    inj = DeviceFaultInjector().install()
    try:
        baseline = batch._verify_batch_streamed(pks, msgs, sigs, CPU)
        inj.arm_device_lost(7)
        for strike in (1, 2):
            err = _port_raises(pks, msgs, sigs)
            assert isinstance(err, sharded.ShardFaultError) and err.device == DEVKEYS[7]
        assert health.MESH_HEALTH.dead_count() == 1
        assert health.MESH_HEALTH.snapshot()["devices"][DEVKEYS[7]]["state"] == "dead"
        assert inj.lost_devices() == [DEVKEYS[7]]
        mask = batch._verify_batch_streamed(pks, msgs, sigs, CPU)
        assert mask.tobytes() == baseline.tobytes()
        assert batch._PATH.label == "rlc-sharded-streamed"
        assert port_em.builds == [8, 4] and port_em()[0] == 4
        assert health.MESH_HEALTH.ladder_state(8, 4, False, False) == "survivor"
    finally:
        inj.uninstall()
        inj.heal()

    ref_inj = RefInjector().install()
    try:
        ref_inj.arm_device_lost(7)
        mask = ref_batch._verify_batch_streamed(pks, msgs, sigs)
        assert mask.tobytes() == baseline.tobytes()
        assert ref_batch.LAST_FLUSH_DETAIL.get("mesh_replays") == 2
        assert ref_em.builds == [8, 4]
    finally:
        ref_inj.uninstall()
        ref_inj.heal()


def test_unattributed_failure_raises_and_kills_no_device(meshes):
    """A failure no probe pins on a device: the port raises it and strikes
    no device; the reference strikes its breaker's mesh rung and finishes
    the same flush on the single-chip streamed rung."""
    pks, msgs, sigs = _signed_rows(93)

    def hook(site, devices):
        raise RuntimeError("collective timeout")

    sharded.set_shard_fault_hook(hook)
    err = _port_raises(pks, msgs, sigs)
    sharded.set_shard_fault_hook(None)
    assert "collective timeout" in str(err)
    assert getattr(err, "_mesh_attributed", None) is False
    assert health.MESH_HEALTH.dead_count() == 0

    ref_sharded.set_shard_fault_hook(hook)
    mask = ref_batch._verify_batch_streamed(pks, msgs, sigs)
    ref_sharded.set_shard_fault_hook(None)
    assert mask.all() and ref_batch.LAST_JAX_PATH[0] == "rlc-streamed"


def test_bad_signature_is_not_a_mesh_fault(meshes):
    """A bad signature makes the combined check return False WITHOUT
    raising: no health strike in either package, and the chunk-wise
    recovery (the sharded combined checks and ladder) gives the host mask."""
    pks, msgs, sigs = _signed_rows(93)
    sigs = list(sigs)
    sigs[31] = sigs[31][:32] + (1).to_bytes(32, "little")
    cpu = batch.verify_batch_cpu(pks, msgs, sigs)
    mask = batch._verify_batch_streamed(pks, msgs, sigs, CPU)
    assert mask.tobytes() == cpu.tobytes() and not mask[31] and mask.sum() == 92
    assert batch._PATH.label == "rlc-streamed-recovery"
    paths = [c["path"] for c in batch.LAST_FLUSH["recovered_chunks"]]
    assert paths == ["rlc-sharded", "sharded", "rlc-sharded"]
    snap = health.MESH_HEALTH.snapshot()
    assert all(d["failures_total"] == 0 for d in snap["devices"].values())
    ref_mask = ref_batch._verify_batch_streamed(pks, msgs, sigs)
    assert ref_mask.tobytes() == mask.tobytes()
    assert ref_batch.LAST_JAX_PATH[0] == "rlc-streamed-recovery"


def test_injector_shard_error_is_one_shot_and_indices_resolve(meshes):
    """arm_shard_error is one-shot (the flush raises, the next is clean)
    and an int device index resolves to the participating key at dispatch
    time, so revive-by-index frees that key."""
    pks, msgs, sigs = _signed_rows(93)
    inj = DeviceFaultInjector().install()
    try:
        inj.arm_shard_error(1)
        err = _port_raises(pks, msgs, sigs)
        assert err.shard == 1 and ("mesh_rlc_stream_submit", "shard_error:1") in inj.fired
        assert batch._verify_batch_streamed(pks, msgs, sigs, CPU).all()
        assert inj.shard_calls > 0
        inj.arm_device_lost(7)
        _port_raises(pks, msgs, sigs)
        assert inj.lost_devices() == [DEVKEYS[7]]
        inj.revive_device(7)
        assert inj.lost_devices() == []
        inj.arm_shard_hang(0, 0.05)
        t0 = time.perf_counter()
        assert batch._verify_batch_streamed(pks, msgs, sigs, CPU).all()
        assert time.perf_counter() - t0 >= 0.05
        assert ("mesh_rlc_stream_submit", "shard_hang:0") in inj.fired
    finally:
        inj.uninstall()
        inj.heal()
    assert sharded._SHARD_FAULT_HOOK is None and health.MESH_HEALTH._intercept is None


# ------------------------------------------------ rejoin, rebuild, prewarm


def test_rejoin_only_after_consecutive_clean_probes(meshes):
    """Rejoin needs `rejoin_probes` CONSECUTIVE clean probes; a failed probe
    mid-probation resets the streak; the rejoin bumps the generation and
    the full mesh is selected again."""
    port_em, _ = meshes
    hm = health.MESH_HEALTH
    inj = DeviceFaultInjector().install()
    rejoined = []
    hm.add_rejoin_listener(lambda: rejoined.append(True))
    try:
        inj.arm_device_lost(DEVKEYS[5])
        hm.mark_device_lost(DEVKEYS[5])
        assert hm.dead_count() == 1 and port_em()[0] == 4
        for _ in range(4):
            assert not hm.probe_round()
        inj.revive_device(DEVKEYS[5])
        assert not hm.probe_round() and not hm.probe_round()
        inj.arm_device_lost(DEVKEYS[5])  # relapse mid-probation
        assert not hm.probe_round()
        inj.revive_device(DEVKEYS[5])
        assert not hm.probe_round() and not hm.probe_round()
        assert hm.dead_count() == 1
        assert hm.probe_round()
        assert hm.dead_count() == 0 and rejoined
        assert port_em()[0] == 8
        assert hm.ladder_state(8, 8, False, False) == "full"
    finally:
        inj.uninstall()
        inj.heal()


class _FakeCard:
    def __init__(self, i):
        self.i = i

    def __str__(self):
        return f"FakeCard(id={self.i})"


def test_rebuild_never_blocks_a_concurrent_flush(monkeypatch):
    """A flush arriving while another thread holds the mesh-build lock
    gets None at once (one card), never waiting on the build; the built
    mesh is then served warm, and the rebuild is recorded."""
    hm = health.MeshHealthManager()
    hm._spawn_probe_thread = False
    monkeypatch.setattr(health, "MESH_HEALTH", hm)
    monkeypatch.setattr(batch, "_SHARDED_RUNNER", None)
    monkeypatch.setattr(batch, "_LAST_MESH_ND", [2])
    monkeypatch.setenv("TMTPU_SHARDED", "auto")
    monkeypatch.setattr(health, "_visible_devices", lambda: [_FakeCard(i) for i in range(8)])
    tm.reset()
    gate, building = threading.Event(), threading.Event()
    sentinel = (8, None, None, (None, None))

    def slow_build(devs):
        assert [str(d) for d in devs] == [f"FakeCard(id={i})" for i in range(8)]
        building.set()
        assert gate.wait(5)
        return sentinel

    monkeypatch.setattr(batch, "_build_sharded_env", slow_build)
    results = []
    t = threading.Thread(target=lambda: results.append(batch._sharded_env()))
    t.start()
    try:
        assert building.wait(5)
        t0 = time.perf_counter()
        assert batch._sharded_env() is None
        assert time.perf_counter() - t0 < 0.5
    finally:
        gate.set()
        t.join(5)
    assert results == [sentinel] and batch._sharded_env() is sentinel
    assert batch.mesh_ladder_state() == "full"
    stats = tm.mesh_stats()
    assert stats["rebuilds"] == 1 and stats["last_rebuild"]["from_devices"] == 2
    assert stats["ladder"] == "full"
    hm.mark_device_lost("FakeCard(id=3)")  # a new generation: the next call rebuilds
    monkeypatch.setattr(batch, "_build_sharded_env", lambda devs: (len(devs), None, None, None))
    assert batch._sharded_env()[0] == 4 and batch.mesh_ladder_state() == "survivor"
    tm.reset()


def test_prewarm_builds_the_half_mesh(meshes, monkeypatch):
    """_prewarm_survivor_mesh builds the next power of two down of the
    healthy devices and streams one 2-chunk flush through it."""
    port_em, _ = meshes
    built = []

    def fake_build(devs):
        keys = [str(d) for d in devs]
        built.append(keys)
        return port_em.env_for(keys)

    monkeypatch.setattr(batch, "_build_sharded_env", fake_build)
    monkeypatch.setattr(health, "_visible_devices", lambda: list(DEVKEYS))
    pks, msgs, sigs = _signed_rows(1)
    batch._prewarm_survivor_mesh(pks[0], msgs[0], sigs[0], CPU)
    assert built == [DEVKEYS[:4]] and batch.LAST_FLUSH["chunks"] == 2
    assert batch.LAST_FLUSH["shards"] == 4


# ---------------------------------------------------------- chaos surface


def test_chaos_schedule_mesh_kinds_roundtrip_through_the_port():
    """The schedule's mesh kinds and their parameters (the port's schedule
    is the reference's), and each event through LocalChaosNet's adapters
    into the port's injector."""
    from tendermint_tpu.chaos.schedule import ChaosSchedule as RefSchedule

    kinds = ("shard_error", "shard_hang", "device_lost")
    sch = ChaosSchedule.generate(7, 4, episodes=12, kinds=kinds, mesh_devices=8)
    assert sch.to_json() == RefSchedule.generate(
        7, 4, episodes=12, kinds=kinds, mesh_devices=8).to_json()
    assert ChaosSchedule.from_json(sch.to_json()).fingerprint() == sch.fingerprint()
    net = LocalChaosNet(make_node=lambda i: None, n=0)
    inj = net.injector
    for kind in ("shard_error", "shard_hang", "device_lost", "device_revive"):
        assert LEVEL_BY_KIND[kind] == "device"
    for ev in sch:
        getattr(net, ev.kind)(**ev.param_dict())
    want_err = [ev.param_dict()["shard"] for ev in sch if ev.kind == "shard_error"]
    want_hang = [(ev.param_dict()["shard"], ev.param_dict()["seconds"])
                 for ev in sch if ev.kind == "shard_hang"]
    assert inj._shard_errors == want_err and inj._shard_hangs == want_hang
    assert not inj._lost_indices  # every loss revived by its episode's end
    net.device_lost(5)
    net.device_lost("FakeTPU(id=6)")
    assert 5 in inj._lost_indices and inj.lost_devices() == ["FakeTPU(id=6)"]
    net.device_revive(None)
    assert inj.lost_devices() == [] and not inj._lost_indices
    inj.heal()


# ------------------------------------------------------------- telemetry


def test_make_mesh_records_the_mesh():
    tm.reset()
    sharded.make_mesh([CPU] * 4)
    m = tm.mesh_stats()["mesh"]
    assert m["n_devices"] == 4 and m["platform"] == "cpu" and m["axes"] == {"vals": 4}
    assert m["devices"] == ["cpu#0", "cpu#1", "cpu#2", "cpu#3"]
    sharded.make_mesh([CPU] * 4, shape=(2, 2), axis_names=("blocks", "vals"))
    assert tm.mesh_stats()["mesh"]["axes"] == {"blocks": 2, "vals": 2}
    with pytest.raises(ValueError):  # no card here, and no device named
        sharded.make_mesh()
    with pytest.raises(ValueError):
        sharded.make_mesh([CPU] * 4, shape=(2, 2))
    tm.reset()


def test_sharded_flush_writes_flush_and_pad_records(monkeypatch):
    """A sharded combined check through the port's routing on a pinned
    make_mesh([cpu] * 2): the pad decision (the real row count), the
    prep, the flush with its gather bytes, and the published health."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    monkeypatch.setattr(batch, "RLC_MIN", 16)
    hm = health.MeshHealthManager()
    hm._spawn_probe_thread = False
    monkeypatch.setattr(health, "MESH_HEALTH", hm)
    prev_memo, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    tm.reset()
    try:
        env = batch._build_sharded_env([CPU] * 2)
        monkeypatch.setattr(batch, "_sharded_env", lambda: env)
        pks, msgs, sigs = _signed_rows(24)
        assert batch.verify_batch_cuda(pks, msgs, sigs, CPU).all()
        assert batch._PATH.label == "rlc-sharded"
        s = tm.mesh_stats()
        assert s["last_pad"]["requested_lanes"] == 2 * 24 + 1
        assert s["last_pad"]["padded_lanes"] == 2 * 64
        assert s["last_prep"] == dict(s["last_prep"], shards=2, lanes_per_shard=64)
        assert s["flushes"] == {"rlc": 1}
        lf = s["last_flush"]
        assert (lf["kind"], lf["shards"], lf["lanes_per_shard"], lf["ok"]) == ("rlc", 2, 64, True)
        assert s["totals"]["all_gathers"] == 1 and s["totals"]["all_gather_bytes"] == 2 * 320
        assert set(s["health"]["devices"]) == {"cpu#0", "cpu#1"}
        # a failed flush publishes the health it struck
        inj = DeviceFaultInjector().install()
        try:
            inj.arm_shard_error(1)
            with pytest.raises(sharded.ShardFaultError) as ei:
                batch.verify_batch_cuda(pks, msgs, sigs, CPU)
            assert batch.is_device_error(ei.value)
        finally:
            inj.uninstall()
        assert tm.mesh_stats()["health"]["devices"]["cpu#1"]["failures_total"] == 1
    finally:
        batch._MEMO = prev_memo
        tm.reset()
