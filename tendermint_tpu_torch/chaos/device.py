"""Device-level fault injection for the batch-verify pipeline: the port's
copy of the batch half of tendermint_tpu/chaos/device.py.

Installs into crypto/batch.py's device fault hook, which every device entry
point calls (`_on_device`: the RLC submit, the RLC result sync, the
per-signature ladder). Armed faults fire on the next device calls whatever
the site, as a sick card looks from the host: every dispatch fails or
stalls, whichever kernel it carries. An injected error is a device error
like a real one: it marks the device down and reaches the caller, with no
fallback (ROADMAP D1).

The shard and mesh half of the reference's injector (shard errors and
hangs, lost devices, the mesh health probe intercept) needs the sharded
verify path, which the port has not taken yet: those methods raise
NotImplementedError naming ROADMAP A6, and install() installs only the
batch hook, not an intercept on parallel/health.py's probes.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

_A6 = "not ported yet (ROADMAP A6: the sharded mesh, parallel/sharded.py)"


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
        raise NotImplementedError(f"arm_shard_error: {_A6}")

    def arm_shard_hang(self, shard: int, seconds: float) -> None:
        raise NotImplementedError(f"arm_shard_hang: {_A6}")

    def arm_device_lost(self, device) -> None:
        raise NotImplementedError(f"arm_device_lost: {_A6}")

    def revive_device(self, device=None) -> None:
        raise NotImplementedError(f"revive_device: {_A6}")

    def heal(self) -> None:
        with self._lock:
            self._errors_left = 0
            self._hangs.clear()
            self._persistent = False

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

    def shard_fault(self, site: str, devices) -> None:
        raise NotImplementedError(f"shard_fault: {_A6}")

    def probe_intercept(self, key: str) -> None:
        raise NotImplementedError(f"probe_intercept: {_A6}")

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "DeviceFaultInjector":
        from tendermint_tpu_torch.crypto import batch

        batch.set_device_fault_hook(self)
        return self

    def uninstall(self) -> None:
        from tendermint_tpu_torch.crypto import batch

        batch.set_device_fault_hook(None)
