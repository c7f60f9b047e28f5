"""Flow rate monitoring/limiting (reference: libs/flowrate/flowrate.go).

An EWMA byte-rate monitor with an async limiter: MConnection calls
`await limit(n, rate)` around sends/recvs; returns immediately while under
the rate, sleeps just enough when over it.

The port's copy of tendermint_tpu/libs/flowrate.py.
"""

from __future__ import annotations

import asyncio
import time


class Monitor:
    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self.start = time.monotonic()
        self.total = 0
        self.rate_avg = 0.0  # EWMA bytes/sec
        self._window = window
        self._last = self.start
        self._acc = 0
        self._tokens = 0.0  # token bucket for limit(); capped at 1 window
        self._tokens_ts = self.start

    def update(self, n: int) -> None:
        now = time.monotonic()
        self.total += n
        self._acc += n
        dt = now - self._last
        if dt >= self._window:
            inst = self._acc / dt
            alpha = 0.5
            self.rate_avg = inst if self.rate_avg == 0 else (alpha * inst + (1 - alpha) * self.rate_avg)
            self._acc = 0
            self._last = now

    def status_rate(self) -> float:
        """Current average rate estimate in bytes/sec."""
        now = time.monotonic()
        dt = now - self._last
        if dt >= self._window and dt > 0:
            inst = self._acc / dt
            return 0.5 * inst + 0.5 * self.rate_avg
        return self.rate_avg

    async def limit(self, n: int, rate: int) -> None:
        """Account n bytes; sleep as needed to keep the rate under `rate`
        bytes/sec. True token bucket with burst capped at one window — idle
        time does NOT bank unbounded credit (a peer that idles an hour then
        floods is limited immediately)."""
        self.update(n)
        if rate <= 0:
            return
        now = time.monotonic()
        burst = rate * self._window
        self._tokens = min(burst, self._tokens + rate * (now - self._tokens_ts))
        self._tokens_ts = now
        self._tokens -= n
        if self._tokens < 0:
            await asyncio.sleep(min(-self._tokens / rate, 1.0))
