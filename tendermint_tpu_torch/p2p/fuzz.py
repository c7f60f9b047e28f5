"""Fuzzed connection wrapper: injects delays and drops for adversarial I/O
testing (reference: p2p/fuzz.go:14 FuzzedConnection, config/config.go:623
FuzzConnConfig).

Wraps any object exposing async read(n)/write(data) + close() (the stream
interface MConnection drives). Two modes, like the reference:
  "drop":  after start_after seconds, drop reads/writes with prob_drop_rw
  "delay": sleep a random interval up to max_delay before each read/write

Reproducibility: the reference's FuzzedConnection draws from the global rand
and wall clock, so a failing fuzz run can never be replayed. Here both are
injectable — `seed` (threaded through `[p2p] fuzz_seed`, see
config/config.py and transport.py's per-connection derivation) pins the
drop/delay decision sequence, and `clock` pins the activation boundary — so
the same seed reproduces the same fault pattern bit-for-bit.

The port's copy of tendermint_tpu/p2p/fuzz.py: the same seed gives the
reference's decision sequence (tests/test_torch_p2p.py).
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class FuzzConfig:
    """reference: config/config.go FuzzConnConfig defaults, plus `seed`
    (0 = non-deterministic, the reference behavior)."""

    mode: str = "drop"  # "drop" | "delay"
    max_delay: float = 3.0
    prob_drop_rw: float = 0.2
    prob_drop_conn: float = 0.0
    prob_sleep: float = 0.0
    start_after: float = 10.0
    seed: int = 0


class FuzzedConnection:
    def __init__(
        self,
        inner,
        config: FuzzConfig | None = None,
        rng: random.Random | None = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.inner = inner
        self.config = config or FuzzConfig()
        if rng is None:
            # seeded config without an explicit rng: still deterministic
            # (single-connection uses; the transport derives per-connection
            # rngs so concurrent connections don't share one stream)
            rng = random.Random(self.config.seed) if self.config.seed else random.Random()
        self.rng = rng
        self._clock = clock or time.monotonic
        self._born = self._clock()
        self._closed = False

    def _active(self) -> bool:
        return self._clock() - self._born >= self.config.start_after

    async def _fuzz(self) -> bool:
        """Returns True if the op should be dropped."""
        if not self._active():
            return False
        cfg = self.config
        if cfg.mode == "delay":
            await asyncio.sleep(self.rng.uniform(0, cfg.max_delay))
            return False
        # drop mode
        if cfg.prob_drop_conn and self.rng.random() < cfg.prob_drop_conn:
            self.close()
            return True
        if cfg.prob_sleep and self.rng.random() < cfg.prob_sleep:
            await asyncio.sleep(self.rng.uniform(0, cfg.max_delay))
        return bool(cfg.prob_drop_rw) and self.rng.random() < cfg.prob_drop_rw

    async def read(self, n: int) -> bytes:
        if await self._fuzz():
            # a dropped read stalls like a lossy link (the reference returns
            # 0 bytes; an async stream must park instead of busy-looping)
            await asyncio.sleep(self.config.max_delay)
        return await self.inner.read(n)

    async def write(self, data: bytes) -> None:
        if await self._fuzz():
            return  # silently dropped
        await self.inner.write(data)

    def close(self) -> None:
        self._closed = True
        self.inner.close()
