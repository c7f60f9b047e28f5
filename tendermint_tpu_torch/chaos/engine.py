"""ChaosEngine: replay a ChaosSchedule against an adapter. The port's copy of
tendermint_tpu/chaos/engine.py.

The adapter supplies one method per fault kind (the schedule's params become
keyword arguments); `LocalChaosNet` (chaos/harness.py) is the in-process
implementation for multinode soaks, but any object with the same method
names works (a device-only adapter is enough for the device kinds):

    device_error(count)          device_hang(seconds)
    partition(groups)            heal()
    crash(target, wal_fault)     restart(target)

`run()` walks the schedule on the event loop's clock; `apply()` fires a
single event synchronously (deterministic unit tests skip the sleeping).
Every successfully applied FAULT (not the heal/restart recovery actions)
increments tendermint_chaos_faults_injected_total{level} so a soak's
/metrics scrape shows the injected load next to the recovery counters it
caused.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
from typing import List, Optional

from tendermint_tpu_torch.chaos.schedule import ChaosSchedule, FaultEvent

logger = logging.getLogger("tendermint_tpu_torch.chaos")


class ChaosEngine:
    def __init__(self, schedule: ChaosSchedule, adapter):
        self.schedule = schedule
        self.adapter = adapter
        self.applied: List[FaultEvent] = []
        self.errors: List[tuple] = []  # (event, repr(exc)) — faults that failed to apply
        self._task: Optional[asyncio.Task] = None

    async def run(self) -> None:
        """Apply every event at its scheduled offset from now."""
        logger.info(
            "chaos schedule seed=%s fingerprint=%s events=%d duration=%.1fs",
            self.schedule.seed,
            self.schedule.fingerprint(),
            len(self.schedule),
            self.schedule.duration(),
        )
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in self.schedule:
            delay = ev.at - (loop.time() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            await self.apply(ev)

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self.run(), name="chaos-engine")
        return self._task

    async def stop(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def apply(self, ev: FaultEvent) -> None:
        """Fire one event. An adapter failure is recorded, not raised — a
        fault that can't be applied (e.g. crashing a node that is already
        down) must not abort the rest of the schedule."""
        logger.info("chaos: t=%.2fs %s %s", ev.at, ev.kind, ev.param_dict() or "")
        fn = getattr(self.adapter, ev.kind, None)
        if fn is None:
            self.errors.append((ev, f"adapter has no handler for {ev.kind!r}"))
            return
        try:
            res = fn(**ev.param_dict())
            if inspect.isawaitable(res):
                await res
        except Exception as e:
            logger.exception("chaos: applying %s failed", ev.kind)
            self.errors.append((ev, repr(e)))
            return
        self.applied.append(ev)
        if ev.kind in ("heal", "restart"):
            return  # recovery actions, not injected faults — don't count
        try:
            # counted only when the fault actually applied: the series'
            # purpose is matching injected load against the recovery
            # counters it caused, so failed applications (and the recovery
            # kinds above) must not inflate it
            from tendermint_tpu_torch.libs.metrics import chaos_metrics

            chaos_metrics().faults_injected.labels(ev.level).inc()
        except Exception:
            pass
