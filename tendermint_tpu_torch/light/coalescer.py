"""Job batcher for the light service: the port's copy of
tendermint_tpu/light/coalescer.py.

Many light clients asking for (mostly Zipfian) heights must not each pay a
flush: the service answers repeat heights from its verified-header cache,
and this module groups the misses. Concurrently parked submits (an
asyncio.gather burst) join one batch: the first submit arms a next-tick
callback, later submits in the same loop tick join, and `max_jobs` fires a
full batch early. All of a batch's jobs run in ONE worker-thread call that
shares one lane submission through crypto/batch.accumulate_flushes.

The coalescing wait across ticks lives in the scheduler's light lane
(crypto/scheduler.py), which holds every batch's rows for the configured
window, so batches fired ticks apart, and other consumers' rows, merge
into one combined flush.

`run_batch(jobs) -> (results, info)` is supplied by the service;
`results[i]` is `(ok, value)`: an exception value fails job i only.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["Coalescer"]


class _Window:
    __slots__ = ("jobs", "futures", "timer", "fired")

    def __init__(self):
        self.jobs: List[Any] = []
        self.futures: List[asyncio.Future] = []
        self.timer: Optional[asyncio.TimerHandle] = None
        self.fired = False


class Coalescer:
    """Batches concurrently-submitted jobs into shared executor runs:
    same-loop-tick submits join one batch; the cross-tick coalescing wait
    lives in the scheduler's light lane, not here."""

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Tuple[List[Tuple[bool, Any]], dict]],
        max_jobs: int = 64,
    ):
        if max_jobs <= 0:
            raise ValueError("max_jobs must be positive")
        self.run_batch = run_batch
        self.max_jobs = int(max_jobs)
        self._window: Optional[_Window] = None
        self._closed = False
        # stats (served by /debug/light and the bench scenario)
        self.windows_fired = 0
        self.jobs_total = 0
        self.last_batch_jobs = 0
        self.largest_batch_jobs = 0
        self.busy_wall_s = 0.0

    # -- submit ---------------------------------------------------------------

    async def submit(self, job) -> Any:
        """Join the open batch (arming one if none is open) and await this
        job's result; raises the job's own failure."""
        if self._closed:
            raise RuntimeError("coalescer is closed")
        loop = asyncio.get_running_loop()
        w = self._window
        if w is None or w.fired:
            w = _Window()
            self._window = w
            # next-tick fire: every submit already parked on this loop
            # iteration joins; the lane's coalescing window does the rest
            w.timer = loop.call_later(0.0, self._fire, w)
        fut: asyncio.Future = loop.create_future()
        w.jobs.append(job)
        w.futures.append(fut)
        if len(w.jobs) >= self.max_jobs:
            self._fire(w)
        return await fut

    def _fire(self, w: _Window) -> None:
        if w.fired:
            return
        w.fired = True
        if w.timer is not None:
            w.timer.cancel()
        if self._window is w:
            self._window = None
        asyncio.get_running_loop().create_task(self._run(w))

    async def _run(self, w: _Window) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        try:
            results, _info = await loop.run_in_executor(
                None, self.run_batch, list(w.jobs)
            )
        except BaseException as e:  # a broken batch runner fails every job
            results = [(False, e)] * len(w.jobs)
        if len(results) < len(w.jobs):
            # a short result list must never strand the surplus submitters
            # awaiting forever — fail them loudly instead
            results = list(results) + [
                (False, RuntimeError(
                    f"batch runner returned {len(results)} results for "
                    f"{len(w.jobs)} jobs"
                ))
            ] * (len(w.jobs) - len(results))
        self.busy_wall_s += time.perf_counter() - t0
        self.windows_fired += 1
        self.jobs_total += len(w.jobs)
        self.last_batch_jobs = len(w.jobs)
        self.largest_batch_jobs = max(self.largest_batch_jobs, len(w.jobs))
        for fut, res in zip(w.futures, results):
            if fut.cancelled():
                continue
            ok, value = (
                res if isinstance(res, tuple) and len(res) == 2
                else (False, RuntimeError(f"bad batch result {res!r}"))
            )
            if ok:
                fut.set_result(value)
            else:
                fut.set_exception(
                    value if isinstance(value, BaseException)
                    else RuntimeError(str(value))
                )

    # -- teardown / stats -----------------------------------------------------

    def close(self) -> None:
        """Cancel the open batch (pending submitters get CancelledError)
        and refuse further submits — a request landing in the node's
        teardown gap must not arm a fresh batch on a dying loop."""
        self._closed = True
        w = self._window
        self._window = None
        if w is not None and not w.fired:
            w.fired = True
            if w.timer is not None:
                w.timer.cancel()
            for fut in w.futures:
                if not fut.done():
                    fut.cancel()

    def stats(self) -> dict:
        return {
            "max_jobs": self.max_jobs,
            "windows_fired": self.windows_fired,
            "jobs_total": self.jobs_total,
            "last_batch_jobs": self.last_batch_jobs,
            "largest_batch_jobs": self.largest_batch_jobs,
            "busy_wall_s": round(self.busy_wall_s, 6),
            "pending_jobs": len(self._window.jobs) if self._window else 0,
        }
