"""Mesh health model: the port's copy of tendermint_tpu/parallel/health.py.

One process-global MeshHealthManager scores every mesh device from the
sharded submit/finish accounting plus a cheap per-device probe, and names
the degrade LADDER rung the verify stack is on:

    full      every visible device healthy, full power-of-two mesh
    survivor  >= 1 device dead, mesh rebuilt on the next power-of-two of
              the healthy survivors (`generation` is the rebuild key)
    single    fewer than 2 healthy devices: single-card verification
    host      the device backend itself is shut: host verification

Scoring is simple and monotone: `fail_threshold` consecutive failures (or
stall strikes) mark a device DEAD; a dead device re-joins only after
`rejoin_probes` CONSECUTIVE clean probes, the hysteresis that keeps the
ladder from flapping. Every healthy-set change bumps `generation`.

Attribution: an error that names its device (`.device`) or its shard
(`.shard`) is pinned on it; any other failure is localized by probing each
participant. A failure no probe can attribute returns False from
`record_failure`.

What the port uses of it: node/node.py applies `[crypto] mesh_health_*`
through `configure_mesh_health`, and parallel/telemetry.mesh_stats() reads
`MESH_HEALTH.snapshot()` live for /debug/mesh, verify_stats' `mesh` block
and the observatory's dumps. parallel/sharded.py feeds `record_success` /
`record_failure` from every sharded dispatch, keyed by shard
(`Mesh.keys`: a device that appears more than once in a mesh is scored per
shard, "cuda:0#2", and probed as its device), and crypto/batch.py's
`_sharded_env` builds the next mesh over the healthy cards. Under D1
nothing in the port consumes the ladder as a fallback: a failed sharded
flush raises.

The default probe is a tiny torch round trip pinned to the device (the
reference's is a jax.device_put), imported lazily, so the module is
torch-free at import.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

HEALTHY = "healthy"
DEAD = "dead"

LADDER_FULL = "full"
LADDER_SURVIVOR = "survivor"
LADDER_SINGLE = "single"
LADDER_HOST = "host"

# Gauge encoding for tendermint_tpu_mesh_ladder_state (libs/metrics.py).
LADDER_GAUGE = {
    LADDER_FULL: 0,
    LADDER_SURVIVOR: 1,
    LADDER_SINGLE: 2,
    LADDER_HOST: 3,
}


def _default_probe(device) -> None:
    """One tiny round trip pinned to THIS device, with no kernel of the
    port's: the question is whether the card answers, not whether a kernel
    builds."""
    import torch

    torch.arange(8, dtype=torch.int32, device=device).cpu()


def _visible_devices() -> list:
    """The cards torch sees, as the devices the default probe resolves a
    key against (str(torch.device("cuda", 0)) is "cuda:0")."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceHealth:
    """Per-device score card. `key` is str(device), stable across the
    rebuilds that discard the device objects themselves."""

    __slots__ = (
        "key", "state", "consec_failures", "stall_strikes",
        "clean_probes", "failures_total", "last_error", "died_at",
    )

    def __init__(self, key: str) -> None:
        self.key = key
        self.state = HEALTHY
        self.consec_failures = 0
        self.stall_strikes = 0
        self.clean_probes = 0
        self.failures_total = 0
        self.last_error = ""
        self.died_at = 0.0

    def as_dict(self) -> dict:
        return {
            "state": self.state,
            "consec_failures": self.consec_failures,
            "stall_strikes": self.stall_strikes,
            "clean_probes": self.clean_probes,
            "failures_total": self.failures_total,
            "last_error": self.last_error,
        }


class MeshHealthManager:
    """Process-global health ranking + rejoin prober for the device mesh."""

    def __init__(self, probe: Callable = _default_probe) -> None:
        self._lock = threading.RLock()
        self._devices: Dict[str, DeviceHealth] = {}
        self._probe = probe
        self._intercept: Optional[Callable] = None  # chaos hook, runs first
        self._cfg = {
            "enabled": True,
            "fail_threshold": 2,
            "stall_threshold_s": 0.0,  # 0 disables stall scoring
            "rejoin_probes": 3,
            "probe_interval_s": 2.0,
        }
        self.generation = 0  # bumped on every healthy-set change
        self._probe_thread: Optional[threading.Thread] = None
        self._spawn_probe_thread = True
        self._on_rejoin: List[Callable] = []

    # -- configuration ----------------------------------------------------

    def configure(
        self,
        enabled: Optional[bool] = None,
        fail_threshold: Optional[int] = None,
        stall_threshold_s: Optional[float] = None,
        rejoin_probes: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
    ) -> None:
        """Apply `[crypto] mesh_health_*` config (node/node.py). Process-
        global, last node wins."""
        with self._lock:
            if enabled is not None:
                self._cfg["enabled"] = bool(enabled)
            if fail_threshold is not None:
                self._cfg["fail_threshold"] = max(1, int(fail_threshold))
            if stall_threshold_s is not None:
                self._cfg["stall_threshold_s"] = max(0.0, float(stall_threshold_s))
            if rejoin_probes is not None:
                self._cfg["rejoin_probes"] = max(1, int(rejoin_probes))
            if probe_interval_s is not None:
                self._cfg["probe_interval_s"] = max(0.05, float(probe_interval_s))

    def set_probe(self, fn: Optional[Callable]) -> None:
        """Replace the per-device probe (tests; None restores the default)."""
        with self._lock:
            self._probe = fn or _default_probe

    def set_probe_intercept(self, fn: Optional[Callable]) -> None:
        """Chaos hook: runs BEFORE the real probe so an injected device loss
        also fails probes (chaos/device.py's injector installs one)."""
        with self._lock:
            self._intercept = fn

    def add_rejoin_listener(self, fn: Callable) -> None:
        """Called (no args, outside the lock) whenever a device re-joins, so
        a mesh runner built on the old set can be dropped eagerly."""
        with self._lock:
            if fn not in self._on_rejoin:
                self._on_rejoin.append(fn)

    def reset(self) -> None:
        """Forget all device history (tests / fresh topologies)."""
        with self._lock:
            self._devices.clear()
            self.generation += 1

    # -- scoring ----------------------------------------------------------

    def _entry(self, key: str) -> DeviceHealth:
        dh = self._devices.get(key)
        if dh is None:
            dh = self._devices[key] = DeviceHealth(key)
        return dh

    def record_success(self, devices: Sequence, elapsed_s: float = 0.0) -> None:
        """A sharded call over `devices` returned cleanly. Clears consecutive
        failure counts; scores a stall strike instead when the call's wall
        exceeded the stall threshold (a wedged-but-not-dead chip drags every
        shard, so the strike lands on all participants)."""
        if not self._cfg["enabled"]:
            return
        thr = self._cfg["stall_threshold_s"]
        stalled = thr > 0.0 and elapsed_s > thr
        with self._lock:
            changed = False
            for d in devices:
                dh = self._entry(str(d))
                if dh.state != HEALTHY:
                    continue
                dh.consec_failures = 0
                if stalled:
                    dh.stall_strikes += 1
                    if dh.stall_strikes >= self._cfg["fail_threshold"]:
                        changed |= self._mark_dead_locked(dh, "stall")
                else:
                    dh.stall_strikes = 0
            if changed:
                self.generation += 1
        if stalled:
            self._ensure_probe_thread()

    def record_failure(self, devices: Sequence, error: BaseException) -> bool:
        """A sharded call over `devices` raised. Attribute the failure to a
        device (an error with `.device` or `.shard` names it; otherwise
        probe each participant) and score it. Returns True when the healthy
        set changed (the caller must invalidate its mesh cache); False means
        the failure could not be pinned on any device (the reference strikes
        its breaker's "mesh" rung then; under D1 the port raises)."""
        if not self._cfg["enabled"]:
            return False
        keys = [str(d) for d in devices]
        sick = self._attribute(keys, error)
        try:
            # stamp the exception so layered handlers never double-score
            # one failure, and so the caller can tell "attributed to a
            # device" from "mesh-collective failure"
            error._mesh_scored = True
            error._mesh_attributed = bool(sick)
        except Exception:
            pass
        if not sick:
            return False
        changed = False
        with self._lock:
            for key in sick:
                dh = self._entry(key)
                dh.consec_failures += 1
                dh.failures_total += 1
                dh.last_error = repr(error)[:200]
                if (
                    dh.state == HEALTHY
                    and dh.consec_failures >= self._cfg["fail_threshold"]
                ):
                    changed |= self._mark_dead_locked(dh, repr(error)[:200])
            if changed:
                self.generation += 1
        self._ensure_probe_thread()
        return changed

    def mark_device_lost(self, device) -> bool:
        """Administrative / chaos kill: the device is gone NOW, no threshold
        accounting. Returns True when the healthy set changed."""
        with self._lock:
            dh = self._entry(str(device))
            dh.failures_total += 1
            dh.last_error = "device_lost"
            if dh.state == HEALTHY:
                self._mark_dead_locked(dh, "device_lost")
                self.generation += 1
                changed = True
            else:
                changed = False
        self._ensure_probe_thread()
        return changed

    def _mark_dead_locked(self, dh: DeviceHealth, reason: str) -> bool:
        dh.state = DEAD
        dh.clean_probes = 0
        dh.died_at = time.monotonic()
        dh.last_error = reason
        return True

    def _attribute(self, keys: List[str], error: BaseException) -> List[str]:
        """Which of `keys` is sick? ShardFaultError carries the answer; any
        other failure is localized by probing each participant."""
        dev = getattr(error, "device", None)
        if dev is not None:
            key = str(dev)
            return [key] if key in keys or not keys else [key]
        shard = getattr(error, "shard", None)
        if shard is not None and 0 <= int(shard) < len(keys):
            return [keys[int(shard)]]
        sick = []
        for key in keys:
            if not self._probe_one(key):
                sick.append(key)
        return sick

    # -- probing / rejoin -------------------------------------------------

    def _probe_one(self, key: str) -> bool:
        """Probe the device whose str() is `key`. The intercept (chaos) sees
        the key first; the real probe needs the live device, resolved from
        the cards torch sees: a departed card simply fails resolution."""
        intercept = self._intercept
        probe = self._probe
        try:
            if intercept is not None:
                intercept(key)
            if probe is _default_probe:
                dev_key = key.split("#")[0]  # a shard of a repeated device probes its device
                for d in _visible_devices():
                    if str(d) == dev_key:
                        probe(d)
                        return True
                return False
            probe(key)
            return True
        except Exception:
            return False

    def probe_round(self) -> bool:
        """One rejoin pass over the dead devices: a clean probe increments
        the device's streak, a failed probe resets it; `rejoin_probes`
        consecutive clean probes re-admit the device (generation bump, so
        the next _sharded_env call rebuilds toward the full mesh). Callable
        directly from tests; the background thread just loops it. Returns
        True when any device re-joined."""
        with self._lock:
            dead = [dh.key for dh in self._devices.values() if dh.state == DEAD]
            need = self._cfg["rejoin_probes"]
        rejoined = []
        for key in dead:
            ok = self._probe_one(key)
            with self._lock:
                dh = self._devices.get(key)
                if dh is None or dh.state != DEAD:
                    continue
                if ok:
                    dh.clean_probes += 1
                    if dh.clean_probes >= need:
                        dh.state = HEALTHY
                        dh.consec_failures = 0
                        dh.stall_strikes = 0
                        dh.last_error = ""
                        self.generation += 1
                        rejoined.append(key)
                else:
                    dh.clean_probes = 0
        if rejoined:
            for fn in list(self._on_rejoin):
                try:
                    fn()
                except Exception:
                    pass
        return bool(rejoined)

    def _ensure_probe_thread(self) -> None:
        if not self._spawn_probe_thread:
            return
        with self._lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            if not any(dh.state == DEAD for dh in self._devices.values()):
                return
            t = threading.Thread(
                target=self._probe_loop, name="mesh-health-probe", daemon=True
            )
            self._probe_thread = t
        t.start()

    def _probe_loop(self) -> None:
        while True:
            with self._lock:
                interval = self._cfg["probe_interval_s"]
                alive = any(dh.state == DEAD for dh in self._devices.values())
            if not alive:
                return  # nothing left to nurse; thread respawns on next death
            time.sleep(interval)
            try:
                self.probe_round()
            except Exception:
                pass

    # -- queries ----------------------------------------------------------

    def healthy_devices(self, devices: Sequence) -> list:
        """Filter a device list down to the healthy members, in mesh order.
        Unknown devices are healthy by default (no history = no penalty)."""
        if not self._cfg["enabled"]:
            return list(devices)
        with self._lock:
            out = []
            for d in devices:
                dh = self._devices.get(str(d))
                if dh is None or dh.state == HEALTHY:
                    out.append(d)
            return out

    def dead_count(self) -> int:
        with self._lock:
            return sum(1 for dh in self._devices.values() if dh.state == DEAD)

    def ladder_state(
        self, n_visible: int, mesh_devices: int, device_open: bool, mesh_open: bool
    ) -> str:
        """Name the active rung. Inputs come from the caller because only it
        knows the live topology: visible device count, the mesh size
        actually in use, and whether the device backend or the mesh rung is
        shut."""
        if device_open:
            return LADDER_HOST
        if mesh_open or mesh_devices < 2:
            return LADDER_SINGLE
        if self.dead_count() > 0 or (n_visible and mesh_devices < n_visible):
            return LADDER_SURVIVOR
        return LADDER_FULL

    def snapshot(self) -> dict:
        """Per-device health for /debug/mesh, /debug/verify_stats and the
        observatory's dumps."""
        with self._lock:
            return {
                "enabled": self._cfg["enabled"],
                "generation": self.generation,
                "fail_threshold": self._cfg["fail_threshold"],
                "rejoin_probes": self._cfg["rejoin_probes"],
                "dead": self.dead_count(),
                "devices": {
                    key: dh.as_dict() for key, dh in sorted(self._devices.items())
                },
            }


MESH_HEALTH = MeshHealthManager()


def configure_mesh_health(**kwargs) -> None:
    """Apply `[crypto] mesh_health_*` config (node/node.py)."""
    MESH_HEALTH.configure(**kwargs)
