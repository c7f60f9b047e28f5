"""Chaos engine: seeded, deterministic fault injection for the full stack.
The port's copy of tendermint_tpu/chaos/, chaos/fleet.py's seeded fleet soak included.

Three fault levels, matching where a production validator actually breaks:

- **device** (chaos/device.py): the device entry points of crypto/batch.py
  raise or hang on schedule; with no fallback (ROADMAP D1) the error
  reaches the caller, and a consensus flush halts its node;
- **network** (chaos/harness.py + p2p/switch.py conn filters,
  p2p/fuzz.py seeded FuzzedConnection): partitions, heals, latency shaping;
- **process** (chaos/process.py + libs/fail.py handlers): hard kills that
  drop the WAL's in-memory buffer, WAL tail truncation/corruption, restarts;

and the catch-up (chaos/catchup.py: stalling, lying and corrupting serving
peers) and adversary (chaos/byzantine.py: equivocation, signature
poisoning) kinds.

`ChaosSchedule.generate(seed, ...)` produces the fault timeline as a pure
function of its seed — re-running with the same seed reproduces the same
schedule bit-for-bit (`fingerprint()` pins it). `ChaosEngine` walks the
schedule against an adapter (the in-process `LocalChaosNet` harness, or any
object with the same method names).
"""

from tendermint_tpu_torch.chaos.device import DeviceFaultError, DeviceFaultInjector
from tendermint_tpu_torch.chaos.engine import ChaosEngine
from tendermint_tpu_torch.chaos.schedule import ChaosSchedule, FaultEvent

__all__ = [
    "ChaosEngine",
    "ChaosSchedule",
    "DeviceFaultError",
    "DeviceFaultInjector",
    "FaultEvent",
]
