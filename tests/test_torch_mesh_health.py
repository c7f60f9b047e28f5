"""The port's mesh telemetry and health model (tendermint_tpu_torch/parallel/
telemetry.py, health.py) against the JAX package's, on the same call
sequences: the cases of tests/test_mesh_telemetry.py and
tests/test_elastic_mesh.py that need no mesh.

Both packages' records and snapshots are compared with the wall-clock
stamps (`ts` of the last flush, prep and rebuild) left out; health managers
are fresh instances driven step by step with a scripted probe, their
snapshots, return values and generations equal after every step. Then the
port's surfaces: one mesh_stats() behind GET /debug/mesh, verify_stats'
`mesh` block and the observatory's `mesh` section; the tendermint_mesh_*
series; the node's `[crypto] mesh_health_*` policy; the default probe. No
tolerance applies.
"""

import asyncio
import json
import os
from types import SimpleNamespace

import pytest
import torch

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.parallel import health as R_health  # noqa: E402
from tendermint_tpu.parallel import telemetry as R_tm  # noqa: E402
from tendermint_tpu_torch.parallel import health as T_health  # noqa: E402
from tendermint_tpu_torch.parallel import telemetry as T_tm  # noqa: E402

DEVKEYS = [f"cuda:{i}" for i in range(8)]
TIME_KEYS = ("ts",)


def timeless(doc):
    if isinstance(doc, dict):
        return {k: timeless(v) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [timeless(v) for v in doc]
    return doc


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Zeroed telemetry and a fresh health manager in both packages (both
    are process-global; the health managers' probe threads are off)."""
    managers = {}
    for name, tm, hm in (("ref", R_tm, R_health), ("port", T_tm, T_health)):
        tm.reset()
        m = hm.MeshHealthManager()
        m._spawn_probe_thread = False
        monkeypatch.setattr(hm, "MESH_HEALTH", m)
        managers[name] = m
    yield managers
    R_tm.reset()
    T_tm.reset()


def both(fn):
    """fn(telemetry, health) on each package; returns (ref, port)."""
    return fn(R_tm, R_health), fn(T_tm, T_health)


def _record_typical_flush(tm, kind="rlc", ndev=8, lanes=256):
    tm.record_flush(kind, ndev=ndev, shard_lanes=lanes, submit_s=0.003, finish_s=0.040,
                    all_gather_bytes=ndev * 4 * 20 * 4,
                    devices=[f"cpu:{i}" for i in range(ndev)], ok=True)


def same_stats() -> dict:
    r, t = both(lambda tm, hm: tm.mesh_stats())
    assert timeless(t) == timeless(r)
    return t


# ---------------------------------------------------------------- telemetry


def test_record_and_snapshot_roundtrip():
    def drive(tm, hm):
        tm.record_mesh(("vals",), (8,), [f"cpu:{i}" for i in range(8)], "cpu")
        tm.record_prepare(8, 256, 0.012)
        tm.record_pad(2001, 2048)
        _record_typical_flush(tm)
        tm.record_aot("hit")
        tm.record_aot("miss")

    both(drive)
    s = same_stats()
    assert s["mesh"]["n_devices"] == 8
    assert s["mesh"]["axes"] == {"vals": 8}
    assert s["flushes"] == {"rlc": 1}
    lf = s["last_flush"]
    assert lf["lanes_total"] == 8 * 256 and lf["shards"] == 8
    assert lf["submit_ms"] == 3.0 and lf["finish_ms"] == 40.0 and lf["ok"] is True
    assert s["last_pad"]["pad_waste_fraction"] == round((2048 - 2001) / 2048, 4)
    assert s["last_prep"]["lanes_per_shard"] == 256
    assert s["totals"]["all_gathers"] == 1
    assert s["totals"]["all_gather_bytes"] == 8 * 4 * 20 * 4
    assert s["totals"]["prep_calls"] == 1
    assert s["aot_cache"] == {"hit": 1, "miss": 1}


def test_reset_zeroes_aggregates():
    both(lambda tm, hm: (_record_typical_flush(tm), tm.reset()))
    s = same_stats()
    assert s["flushes"] == {} and s["last_flush"] is None
    assert s["totals"]["submit_seconds"] == 0.0


def test_fresh_snapshot_is_the_single_device_answer():
    s = same_stats()
    assert s["mesh"] is None and s["ladder"] is None and s["rebuilds"] == 0
    assert s["health"] == {"enabled": True, "generation": 0, "fail_threshold": 2,
                           "rejoin_probes": 3, "dead": 0, "devices": {}}


def test_mesh_stats_carry_health_ladder_and_rebuilds(fresh):
    def drive(tm, hm):
        hm.MESH_HEALTH.mark_device_lost(DEVKEYS[2])
        tm.record_rebuild(8, 4, 0.0123)
        tm.record_mesh_health(hm.MESH_HEALTH.snapshot(), "survivor")

    both(drive)
    s = same_stats()
    assert s["ladder"] == "survivor"
    assert s["rebuilds"] == 1
    assert s["last_rebuild"]["from_devices"] == 8 and s["last_rebuild"]["to_devices"] == 4
    assert s["health"]["devices"][DEVKEYS[2]]["state"] == "dead"
    assert s["health"]["dead"] == 1
    # health reads LIVE: a probe streak shows without a new push
    hm = fresh["port"]
    hm.set_probe(lambda key: None)
    fresh["ref"].set_probe(lambda key: None)
    both(lambda tm, h: h.MESH_HEALTH.probe_round())
    assert same_stats()["health"]["devices"][DEVKEYS[2]]["clean_probes"] == 1


def test_mesh_series_exposed_in_global_registry():
    from tendermint_tpu_torch.libs import metrics as M

    _record_typical_flush(T_tm, ndev=2, lanes=8)
    T_tm.record_aot("corrupt")
    T_tm.record_mesh_health({"devices": {"cuda:0": {"state": "healthy"},
                                         "cuda:1": {"state": "dead", "clean_probes": 1}}},
                            "survivor")
    text = M.global_registry().expose()
    assert "tendermint_mesh_flushes_total" in text
    assert 'result="corrupt"' in text
    assert 'device="cpu:0"' in text
    fams = M.parse_exposition(text)
    health = {s[1]["device"]: s[2] for s in fams["tendermint_mesh_device_health"]["samples"]}
    assert health == {"cuda:0": 1.0, "cuda:1": 0.5}
    assert fams["tendermint_mesh_ladder_state"]["samples"][0][2] == 1.0


def test_one_snapshot_behind_every_surface():
    """GET /debug/mesh, verify_stats' `mesh` block and the observatory's
    `mesh` section are the same mesh_stats()."""
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.rpc.server import RPCServer
    from tendermint_tpu_torch.tools import chain_observatory as obs

    T_tm.record_mesh(("vals",), (2,), ["cuda:0", "cuda:1"], "gpu")
    _record_typical_flush(T_tm, ndev=2, lanes=8)
    T_health.MESH_HEALTH.mark_device_lost("cuda:1")
    rpc = RPCServer(SimpleNamespace(config=test_config(), metrics=None))
    route = asyncio.run(rpc._debug_mesh({}))
    assert route["mesh"]["n_devices"] == 2 and route["flushes"] == {"rlc": 1}
    assert route["health"]["dead"] == 1
    assert trace.verify_stats()["mesh"] == route
    assert obs.capture_node_dump(SimpleNamespace())["mesh"] == route
    assert route == T_tm.mesh_stats()


# ---------------------------------------------------------------- health


def scripted(lost: set):
    """A probe that fails for the keys in `lost` (the chaos intercept's
    role in the reference's tests)."""
    def probe(key):
        if key in lost:
            raise RuntimeError(f"device {key} lost")
    return probe


def same_health(fresh) -> dict:
    r, t = fresh["ref"].snapshot(), fresh["port"].snapshot()
    assert t == r
    assert fresh["port"].generation == fresh["ref"].generation
    return t


def test_rejoin_only_after_consecutive_clean_probes(fresh):
    lost = set()
    rejoined = {"ref": [], "port": []}
    for name, hm in fresh.items():
        hm.configure(enabled=True, fail_threshold=2, stall_threshold_s=0.0, rejoin_probes=3)
        hm.set_probe(scripted(lost))
        hm.add_rejoin_listener(lambda n=name: rejoined[n].append(True))

    def step(fn):
        out = [fn(fresh[n]) for n in ("ref", "port")]
        assert out[0] == out[1]
        same_health(fresh)
        return out[1]

    lost.add(DEVKEYS[5])
    assert step(lambda hm: hm.mark_device_lost(DEVKEYS[5])) is True
    assert step(lambda hm: hm.healthy_devices(DEVKEYS)) == DEVKEYS[:5] + DEVKEYS[6:]
    for _ in range(4):
        assert step(lambda hm: hm.probe_round()) is False
    lost.clear()
    assert step(lambda hm: hm.probe_round()) is False
    assert step(lambda hm: hm.probe_round()) is False
    lost.add(DEVKEYS[5])  # relapse mid-probation resets the streak
    assert step(lambda hm: hm.probe_round()) is False
    lost.clear()
    assert step(lambda hm: hm.probe_round()) is False
    assert step(lambda hm: hm.probe_round()) is False
    assert step(lambda hm: hm.dead_count()) == 1
    assert step(lambda hm: hm.probe_round()) is True
    assert step(lambda hm: hm.dead_count()) == 0
    assert rejoined == {"ref": [True], "port": [True]}
    assert step(lambda hm: hm.ladder_state(8, 8, False, False)) == "full"


def test_ladder_state_monotone_mapping(fresh):
    seq = {}
    for name, hm in fresh.items():
        s = [hm.ladder_state(8, 8, False, False)]
        hm.mark_device_lost(DEVKEYS[3])
        s += [hm.ladder_state(8, 4, False, False), hm.ladder_state(8, 4, False, True),
              hm.ladder_state(8, 1, False, False), hm.ladder_state(8, 8, True, True),
              hm.ladder_state(0, 0, False, False)]
        seq[name] = s
    assert seq["port"] == seq["ref"] == ["full", "survivor", "single", "single", "host", "single"]
    gauges = [T_health.LADDER_GAUGE[s] for s in seq["port"][:5]]
    assert gauges == sorted(gauges)
    assert T_health.LADDER_GAUGE == R_health.LADDER_GAUGE == T_tm._LADDER_GAUGE
    same_health(fresh)


def test_stall_strikes_reset_on_fast_flush(fresh):
    for hm in fresh.values():
        hm.configure(stall_threshold_s=0.05)
        hm.set_probe(lambda key: None)
    for elapsed in (0.2, 0.001, 0.2, 0.2):
        for hm in fresh.values():
            hm.record_success(DEVKEYS, elapsed_s=elapsed)
        snap = same_health(fresh)
    assert snap["dead"] == len(DEVKEYS)
    assert all(d["stall_strikes"] == 2 for d in snap["devices"].values())


class _Attributed(RuntimeError):
    def __init__(self, msg, device=None, shard=None):
        super().__init__(msg)
        if device is not None:
            self.device = device
        if shard is not None:
            self.shard = shard


@pytest.mark.parametrize("case", ["device", "shard", "probe", "unattributed", "disabled"])
def test_record_failure_attribution(fresh, case):
    lost = {DEVKEYS[6]} if case == "probe" else set()
    errs = {"device": lambda: _Attributed("x", device=DEVKEYS[1]),
            "shard": lambda: _Attributed("x", shard=3),
            "probe": lambda: RuntimeError("collective failed"),
            "unattributed": lambda: RuntimeError("collective failed"),
            "disabled": lambda: _Attributed("x", device=DEVKEYS[1])}
    out = {}
    for name, hm in fresh.items():
        hm.configure(fail_threshold=2, enabled=case != "disabled")
        hm.set_probe(scripted(lost))
        got = []
        for _ in range(3):
            e = errs[case]()
            got.append((hm.record_failure(DEVKEYS[:4] if case != "probe" else DEVKEYS, e),
                        getattr(e, "_mesh_scored", None), getattr(e, "_mesh_attributed", None)))
        out[name] = got
    assert out["port"] == out["ref"]
    snap = same_health(fresh)
    want_dead = {"device": [DEVKEYS[1]], "shard": [DEVKEYS[3]], "probe": [DEVKEYS[6]],
                 "unattributed": [], "disabled": []}[case]
    assert sorted(k for k, d in snap["devices"].items() if d["state"] == "dead") == want_dead
    if want_dead:
        assert out["port"][1][0] is True  # the second strike killed it
        assert snap["devices"][want_dead[0]]["failures_total"] == 3


def test_configure_clamps_like_the_reference(fresh):
    for hm in fresh.values():
        hm.configure(fail_threshold=0, stall_threshold_s=-1.0, rejoin_probes=-2,
                     probe_interval_s=0.0)
        hm.configure(enabled=None)
        assert hm._cfg == {"enabled": True, "fail_threshold": 1, "stall_threshold_s": 0.0,
                           "rejoin_probes": 1, "probe_interval_s": 0.05}
    same_health(fresh)
    for hm in fresh.values():
        hm.reset()
    same_health(fresh)


def test_probe_thread_rejoins_a_dead_device(fresh):
    """The background prober (probe_interval_s) re-admits a device whose
    probes pass, as the reference's does."""
    hm = fresh["port"]
    hm._spawn_probe_thread = True
    hm.configure(rejoin_probes=2, probe_interval_s=0.05)
    hm.set_probe(lambda key: None)
    hm.mark_device_lost("cuda:3")
    for _ in range(200):
        if hm.dead_count() == 0:
            break
        import time

        time.sleep(0.02)
    assert hm.dead_count() == 0


def test_default_probe_is_a_torch_round_trip(fresh):
    T_health._default_probe(torch.device("cpu"))
    hm = fresh["port"]
    if not torch.cuda.is_available():
        # no card: a key resolves to no device, so the probe fails, as a
        # departed card does
        assert hm._probe_one("cuda:0") is False
    else:
        assert hm._probe_one("cuda:0") is True


def test_node_applies_the_mesh_health_policy(fresh, tmp_path):
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto.keys import gen_ed25519
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    cfg = test_config()
    cfg.base.db_backend, cfg.root_dir, cfg.rpc.laddr = "memdb", "", ""
    cfg.instrumentation.forensics_dir = ""
    cfg.consensus.wal_path = str(tmp_path / "wal" / "wal")
    cfg.crypto.mesh_health_fail_threshold = 5
    cfg.crypto.mesh_health_rejoin_probes = 7
    cfg.crypto.mesh_health_stall_threshold = 1.5
    cfg.crypto.mesh_health_probe_interval = 0.5
    # nothing process-global but the policy: no scheduler or SLO default
    cfg.scheduler.enabled = cfg.slo.enabled = False
    key = gen_ed25519(b"M" * 32)
    node = Node(cfg, GenesisDoc(chain_id="mesh-policy",
                                validators=[GenesisValidator(key.pub_key(), 10)]),
                priv_validator=FilePV(key), device="cpu")
    node.proxy_app.stop()
    hm = fresh["port"]
    assert hm._cfg == {"enabled": True, "fail_threshold": 5, "stall_threshold_s": 1.5,
                       "rejoin_probes": 7, "probe_interval_s": 0.5}
    snap = T_tm.mesh_stats()["health"]
    assert (snap["fail_threshold"], snap["rejoin_probes"]) == (5, 7)
    assert json.dumps(snap)
