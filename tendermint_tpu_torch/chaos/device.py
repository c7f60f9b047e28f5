"""Device-level fault injection for the batch-verify pipeline: the port's
copy of tendermint_tpu/chaos/device.py.

Installs into crypto/batch.py's device fault hook, which every device entry
point calls (`_on_device`: the RLC submit, the RLC result sync, the
per-signature ladder). Armed faults fire on the next device calls whatever
the site, as a sick card looks from the host: every dispatch fails or
stalls, whichever kernel it carries. An injected error is a device error
like a real one: it marks the device down and reaches the caller, with no
fallback (ROADMAP D1).

Shard-targeted faults additionally install into parallel/sharded.py's
shard-fault hook, which every SHARDED dispatch site calls with the
participating shard keys, so a chaos schedule can kill exactly one shard of
one mesh dispatch:

    shard_error {shard}          the next sharded dispatch raises a
                                 ShardFaultError attributed to that shard
    shard_hang  {shard, seconds} the next sharded dispatch stalls first
                                 (feeds the health model's stall scoring)
    device_lost {device}         EVERY dispatch that includes that device
                                 raises, and its health probes fail, until
                                 heal()/revive_device()

The injector also registers a probe intercept with the mesh health manager
(parallel/health.py), so a "lost" device keeps failing its rejoin probes:
the death / probation / rejoin cycle is drivable from one schedule. In the
port a failed sharded flush raises a device error (crypto/batch.py, D1):
the health model strikes the shard and the next mesh is built on the
healthy devices, but the flush itself is not replayed.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class DeviceFaultError(RuntimeError):
    """The injected stand-in for a device failure."""


class DeviceFaultInjector:
    """Count-armed fault source. Thread-safe: the consensus event loop, the
    prewarm thread and the scheduler's dispatch thread can all reach device
    entry points at once.

    arm_errors(k): the next k device calls raise DeviceFaultError.
    arm_hang(s):   the next device call sleeps s seconds first (a stall the
                   caller sees as a slow flush).
    persistent:    raise on EVERY call until heal().
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._errors_left = 0
        self._hangs: List[float] = []
        self._persistent = False
        self.calls = 0  # total device-entry calls observed
        self.fired: List[Tuple[str, str]] = []  # (site, "error"|"hang")
        # Shard-targeted state (sharded.set_shard_fault_hook); a shard index
        # is a slice of the mesh dispatch, a lost device is a STRING key
        # matched against the participating shard keys.
        self._shard_errors: List[int] = []  # one-shot, by shard index
        self._shard_hangs: List[Tuple[int, float]] = []  # (shard, seconds)
        self._lost_indices: List[int] = []  # pending: resolve at next dispatch
        self._lost_devices: set = set()  # resolved device strings
        self._lost_by_index: Dict[int, str] = {}  # index -> resolved string
        self.shard_calls = 0  # total sharded dispatch-site calls observed

    # -- arming -------------------------------------------------------------

    def arm_errors(self, count: int) -> None:
        with self._lock:
            self._errors_left += max(0, int(count))

    def arm_hang(self, seconds: float) -> None:
        with self._lock:
            self._hangs.append(float(seconds))

    def set_persistent(self, on: bool = True) -> None:
        with self._lock:
            self._persistent = bool(on)

    def arm_shard_error(self, shard: int) -> None:
        """The next sharded dispatch raises, attributed to `shard` (an index
        into the participating shard keys)."""
        with self._lock:
            self._shard_errors.append(int(shard))

    def arm_shard_hang(self, shard: int, seconds: float) -> None:
        """The next sharded dispatch stalls `seconds` first: the health
        model sees a slow flush and scores a stall strike."""
        with self._lock:
            self._shard_hangs.append((int(shard), float(seconds)))

    def arm_device_lost(self, device) -> None:
        """EVERY sharded dispatch including `device` raises, and its health
        probes fail, until heal()/revive_device(). `device` may be a shard
        key (matched exactly) or an int index (resolved against the
        participating shard keys at the next dispatch)."""
        with self._lock:
            if isinstance(device, int):
                self._lost_indices.append(device)
            else:
                self._lost_devices.add(str(device))

    def revive_device(self, device=None) -> None:
        """Un-lose a device (or all, if None): its probes pass again, so the
        health model's rejoin cycle can run. Accepts the same index/string
        forms as arm_device_lost (an index revives whatever key it resolved
        to at dispatch time)."""
        with self._lock:
            if device is None:
                self._lost_indices.clear()
                self._lost_devices.clear()
                self._lost_by_index.clear()
            elif isinstance(device, int):
                if device in self._lost_indices:
                    self._lost_indices.remove(device)
                key = self._lost_by_index.pop(device, None)
                if key is not None:
                    self._lost_devices.discard(key)
            else:
                self._lost_devices.discard(str(device))
                self._lost_by_index = {
                    i: k for i, k in self._lost_by_index.items() if k != str(device)
                }

    def lost_devices(self) -> List[str]:
        with self._lock:
            return sorted(self._lost_devices)

    def heal(self) -> None:
        with self._lock:
            self._errors_left = 0
            self._hangs.clear()
            self._persistent = False
            self._shard_errors.clear()
            self._shard_hangs.clear()
            self._lost_indices.clear()
            self._lost_devices.clear()
            self._lost_by_index.clear()

    # -- the hook (crypto/batch.set_device_fault_hook) ----------------------

    def __call__(self, site: str) -> None:
        with self._lock:
            self.calls += 1
            hang: Optional[float] = self._hangs.pop(0) if self._hangs else None
            fire_error = self._persistent or self._errors_left > 0
            if not self._persistent and self._errors_left > 0:
                self._errors_left -= 1
            if hang is not None:
                self.fired.append((site, "hang"))
            if fire_error:
                self.fired.append((site, "error"))
        if hang is not None:
            time.sleep(hang)  # the device call "stalls"
        if fire_error:
            raise DeviceFaultError(f"injected device fault at {site}")

    # -- the shard hook (parallel/sharded.set_shard_fault_hook) -------------

    def shard_fault(self, site: str, devices) -> None:
        """Called by every SHARDED dispatch site with the participating shard
        keys. Raises sharded.ShardFaultError carrying the shard index and
        key, so the health model attributes the fault to exactly one shard
        instead of probing the whole mesh."""
        from tendermint_tpu_torch.parallel.sharded import ShardFaultError

        keys = [str(d) for d in devices]
        with self._lock:
            self.shard_calls += 1
            # Resolve index-armed losses against this dispatch's shard keys
            # (the first sharded dispatch after arming names the victim).
            while self._lost_indices:
                idx = self._lost_indices.pop(0)
                if 0 <= idx < len(keys):
                    self._lost_devices.add(keys[idx])
                    self._lost_by_index[idx] = keys[idx]
            lost_here = [i for i, k in enumerate(keys) if k in self._lost_devices]
            shard_err: Optional[int] = (
                self._shard_errors.pop(0) if self._shard_errors else None
            )
            shard_hang: Optional[Tuple[int, float]] = (
                self._shard_hangs.pop(0) if self._shard_hangs else None
            )
            if lost_here:
                self.fired.append((site, f"device_lost:{keys[lost_here[0]]}"))
            if shard_hang is not None:
                self.fired.append((site, f"shard_hang:{shard_hang[0]}"))
            if shard_err is not None:
                self.fired.append((site, f"shard_error:{shard_err}"))
        if shard_hang is not None:
            time.sleep(shard_hang[1])  # one shard "straggles"
        if lost_here:
            i = lost_here[0]
            raise ShardFaultError(site, i, keys[i])
        if shard_err is not None:
            i = max(0, min(int(shard_err), len(keys) - 1)) if keys else 0
            dev = keys[i] if keys else f"shard{shard_err}"
            raise ShardFaultError(site, i, dev)

    def probe_intercept(self, key: str) -> None:
        """Installed into MESH_HEALTH: a lost device keeps failing its rejoin
        probes until revive_device()/heal(), so probation is chaos-drivable."""
        with self._lock:
            lost = key in self._lost_devices
        if lost:
            raise DeviceFaultError(f"injected probe failure on lost device {key}")

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "DeviceFaultInjector":
        from tendermint_tpu_torch.crypto import batch
        from tendermint_tpu_torch.parallel import health, sharded

        batch.set_device_fault_hook(self)
        sharded.set_shard_fault_hook(self.shard_fault)
        health.MESH_HEALTH.set_probe_intercept(self.probe_intercept)
        return self

    def uninstall(self) -> None:
        from tendermint_tpu_torch.crypto import batch
        from tendermint_tpu_torch.parallel import health, sharded

        batch.set_device_fault_hook(None)
        sharded.set_shard_fault_hook(None)
        health.MESH_HEALTH.set_probe_intercept(None)
