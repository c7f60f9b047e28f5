"""Mesh telemetry: the port's copy of tendermint_tpu/parallel/telemetry.py.

A process-global store plus the tendermint_mesh_* series (libs/metrics.py
MeshMetrics, on the global registry) for the multi-device paths, read by
two surfaces, as in the reference: the `mesh` block of
libs/trace.verify_stats() (GET /debug/verify_stats) and GET /debug/mesh
(rpc/server.py), and by the observatory's dumps
(tools/chain_observatory.py). All three read one `mesh_stats()`.

The sharded mesh feeds the records as the reference's does:
parallel/sharded.py the mesh (make_mesh), flush and prep records, with
devices named by their shard keys; crypto/batch.py the pad decision, the
rebuilds and the health pushes. The artifact-cache record stays unfed: the
port builds its kernels with nvcc rather than an AOT artifact cache. On a
single-card node no mesh is built, so the snapshot is the reference's
single-device answer: `mesh: null`, zeroed totals, and the health manager
(parallel/health.py MESH_HEALTH, read live) with the node's
`[crypto] mesh_health_*` policy and no device tracked.

Torch-free: importable by the RPC layer and verify_stats on any node.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

_LOCK = threading.Lock()


def _fresh() -> Dict[str, Any]:
    return {
        "mesh": None,  # {"devices": [...], "shape": {...}, "platform"}
        "flushes": {},  # kind -> count
        "totals": {
            "submit_seconds": 0.0,
            "finish_seconds": 0.0,
            "all_gathers": 0,
            "all_gather_bytes": 0,
            "prep_seconds": 0.0,
            "prep_calls": 0,
        },
        "last_flush": None,
        "last_prep": None,
        "aot_cache": {},  # result -> count (hit / miss / corrupt)
        # per-device health + degrade ladder
        "health": None,  # parallel/health.MeshHealthManager.snapshot()
        "ladder": None,  # "full" | "survivor" | "single" | "host"
        "rebuilds": 0,
        "last_rebuild": None,
    }


_STATS: Dict[str, Any] = _fresh()


def _metrics():
    from tendermint_tpu_torch.libs import metrics as _m

    return _m.mesh_metrics()


def record_mesh(axis_names, shape, devices, platform: str) -> None:
    """The mesh a sharded runner was built over (at its construction)."""
    info = {
        "axes": dict(zip(list(axis_names), [int(s) for s in shape])),
        "devices": [str(d) for d in devices],
        "n_devices": len(devices),
        "platform": platform,
    }
    with _LOCK:
        _STATS["mesh"] = info
    try:
        _metrics().devices.set(len(devices))
    except Exception:  # telemetry must never fail the verify path
        pass


def record_prepare(ndev: int, lanes_per_shard: int, seconds: float) -> None:
    """Host-side shard prep: per-shard window sort + bucket boundaries."""
    with _LOCK:
        t = _STATS["totals"]
        t["prep_seconds"] += seconds
        t["prep_calls"] += 1
        _STATS["last_prep"] = {
            "shards": ndev,
            "lanes_per_shard": lanes_per_shard,
            "seconds": round(seconds, 6),
            "ts": time.time(),
        }
    try:
        _metrics().prep_seconds.inc(seconds)
    except Exception:
        pass


def record_pad(requested_lanes: int, padded_lanes: int) -> None:
    """Lane padding chosen by the routing layer, which knows the real batch
    size (the sharded runners only see the padded arrays)."""
    waste = (
        (padded_lanes - requested_lanes) / padded_lanes if padded_lanes else 0.0
    )
    with _LOCK:
        last = _STATS.setdefault("last_pad", {})
        last.update(
            requested_lanes=requested_lanes,
            padded_lanes=padded_lanes,
            pad_waste_fraction=round(waste, 4),
        )
    try:
        _metrics().pad_waste_fraction.set(waste)
    except Exception:
        pass


def record_flush(
    kind: str,
    *,
    ndev: int,
    shard_lanes: int,
    submit_s: float,
    finish_s: float,
    all_gather_bytes: int = 0,
    devices: Optional[List[str]] = None,
    ok: Optional[bool] = None,
) -> None:
    """One sharded flush completed: `submit_s` = wall blocked dispatching
    the sharded program, `finish_s` = wall blocked syncing its result
    (per-shard skew hides inside the finish)."""
    with _LOCK:
        _STATS["flushes"][kind] = _STATS["flushes"].get(kind, 0) + 1
        t = _STATS["totals"]
        t["submit_seconds"] += submit_s
        t["finish_seconds"] += finish_s
        if all_gather_bytes:
            t["all_gathers"] += 1
            t["all_gather_bytes"] += all_gather_bytes
        _STATS["last_flush"] = {
            "kind": kind,
            "shards": ndev,
            "lanes_per_shard": shard_lanes,
            "lanes_total": shard_lanes * ndev,
            "submit_ms": round(submit_s * 1e3, 3),
            "finish_ms": round(finish_s * 1e3, 3),
            "all_gather_bytes": all_gather_bytes,
            "ok": ok,
            "ts": time.time(),
        }
    try:
        m = _metrics()
        m.flushes.labels(kind).inc()
        m.submit_seconds.inc(submit_s)
        m.finish_seconds.inc(finish_s)
        if all_gather_bytes:
            m.all_gathers.inc()
            m.all_gather_bytes.inc(all_gather_bytes)
        for i in range(ndev):
            dev = devices[i] if devices and i < len(devices) else str(i)
            m.shard_lanes.labels(dev).set(shard_lanes)
    except Exception:
        pass
    try:
        from tendermint_tpu_torch.libs.trace import tracer

        if tracer.enabled:
            tracer.event(
                "mesh.flush",
                kind=kind,
                shards=ndev,
                lanes_per_shard=shard_lanes,
                submit_ms=round(submit_s * 1e3, 3),
                finish_ms=round(finish_s * 1e3, 3),
            )
    except Exception:
        pass


def record_rebuild(from_devices: int, to_devices: int, seconds: float) -> None:
    """One mesh rebuild: the topology changed size, a device died (shrink)
    or re-joined after clean probes (grow)."""
    with _LOCK:
        _STATS["rebuilds"] += 1
        _STATS["last_rebuild"] = {
            "from_devices": int(from_devices),
            "to_devices": int(to_devices),
            "seconds": round(seconds, 6),
            "ts": time.time(),
        }
    try:
        _metrics().rebuilds.inc()
    except Exception:
        pass
    try:
        from tendermint_tpu_torch.libs.trace import tracer

        if tracer.enabled:
            tracer.event(
                "mesh.rebuild",
                from_devices=int(from_devices),
                to_devices=int(to_devices),
                seconds=round(seconds, 6),
            )
    except Exception:
        pass


# Encoded ladder rungs for the tendermint_mesh_ladder_state gauge; keep in
# sync with parallel/health.LADDER_GAUGE.
_LADDER_GAUGE = {"full": 0, "survivor": 1, "single": 2, "host": 3}


def record_mesh_health(snapshot: dict, ladder: str) -> None:
    """Per-device health + ladder rung, pushed by the sharded path. The
    device-health gauge is replace_series'd: a departed device's series
    DROPS from /metrics instead of freezing at its last value."""
    with _LOCK:
        _STATS["health"] = snapshot
        _STATS["ladder"] = ladder
    try:
        m = _metrics()
        values = {}
        for dev, st in (snapshot.get("devices") or {}).items():
            if st.get("state") == "healthy":
                v = 1.0
            elif st.get("clean_probes", 0) > 0:
                v = 0.5  # dead but probing clean: mid-rejoin
            else:
                v = 0.0
            values[(dev,)] = v
        m.device_health.replace_series(values)
        m.ladder_state.set(_LADDER_GAUGE.get(ladder, 2))
    except Exception:
        pass


def record_aot(result: str) -> None:
    """Kernel artifact-cache outcome: `hit` (loaded), `miss` (fresh build),
    `corrupt` (deleted + rebuilt); the reference's AOT cache records these.
    Machine-scoped keys make a foreign host's artifacts misses."""
    with _LOCK:
        _STATS["aot_cache"][result] = _STATS["aot_cache"].get(result, 0) + 1
    try:
        _metrics().aot_cache.labels(result).inc()
    except Exception:
        pass


def mesh_stats() -> dict:
    """Snapshot for /debug/mesh, the verify_stats `mesh` block and the
    observatory's dumps."""
    with _LOCK:
        out = {
            "mesh": dict(_STATS["mesh"]) if _STATS["mesh"] else None,
            "flushes": dict(_STATS["flushes"]),
            "totals": {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in _STATS["totals"].items()
            },
            "last_flush": dict(_STATS["last_flush"]) if _STATS["last_flush"] else None,
            "last_prep": dict(_STATS["last_prep"]) if _STATS["last_prep"] else None,
            "last_pad": dict(_STATS.get("last_pad") or {}) or None,
            "aot_cache": dict(_STATS["aot_cache"]),
            "ladder": _STATS.get("ladder"),
            "rebuilds": _STATS.get("rebuilds", 0),
            "last_rebuild": (
                dict(_STATS["last_rebuild"]) if _STATS.get("last_rebuild") else None
            ),
        }
    # Health reads LIVE from the manager so /debug/mesh shows probe
    # streaks as they advance, not the last pushed snapshot.
    try:
        from tendermint_tpu_torch.parallel.health import MESH_HEALTH

        out["health"] = MESH_HEALTH.snapshot()
    except Exception:
        out["health"] = _STATS.get("health")
    return out


def reset() -> None:
    """Test hook: zero the aggregated mesh telemetry (not the metrics)."""
    global _STATS
    with _LOCK:
        _STATS = _fresh()
