"""Node-level overload controller: the port's copy of
tendermint_tpu/node/overload.py, whole (no reference counterpart — the
reference sheds implicitly through bounded goroutine queues and dropped
sends; here the policy is explicit, observable, and ordered).

Samples the node's queue depths into per-signal saturations [0, 1]:

    mempool          resident txs vs [mempool] size
    mempool_bytes    resident bytes vs [mempool] max_txs_bytes
    consensus_queue  the receive loop's inbound queue depth
    rpc_inflight     sheddable RPC requests executing vs max_inflight
    p2p_send_queues  pending messages across peer send queues

and folds the worst signal into a pressure level with hysteresis:

    0 NORMAL    everything admitted
    1 ELEVATED  shed txs: inbound mempool gossip dropped pre-CheckTx,
                outbound tx walk paused, RPC broadcast_tx_* return 429
    2 CRITICAL  additionally shed non-critical gossip (evidence walk
                paused) and sheddable RPC reads (queries return 429)

Consensus channels are exempt at every level — votes, proposals, and block
parts are never shed (the vote-path guard test pins this). Levels step
back down when pressure falls below 80% of the entering watermark, so the
switches don't flap at the boundary. State is exported as
`tendermint_overload_*` series and the `controller` block of
`GET /debug/overload`."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

logger = logging.getLogger("tendermint_tpu_torch.node")

LEVEL_NORMAL = 0
LEVEL_ELEVATED = 1
LEVEL_CRITICAL = 2

LEVEL_NAMES = {LEVEL_NORMAL: "normal", LEVEL_ELEVATED: "elevated",
               LEVEL_CRITICAL: "critical"}

# step back down only once pressure drops below this fraction of the
# watermark that was crossed on the way up
HYSTERESIS = 0.8


class OverloadController:
    def __init__(self, node, cfg, metrics=None):
        """node: the Node (signals are read via getattr chains so partial
        assemblies — no p2p, no RPC — sample as zero); cfg: OverloadConfig;
        metrics: OverloadMetrics or None."""
        self.node = node
        self.cfg = cfg
        self.metrics = metrics
        self.level = LEVEL_NORMAL
        self.transitions_up = 0
        self.transitions_down = 0
        self.last_signals: Dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None

    # -- signals -------------------------------------------------------------

    @staticmethod
    def _sat(value: float, cap: float) -> float:
        if cap <= 0:
            return 0.0
        return min(1.0, max(0.0, value / cap))

    def sample(self) -> Dict[str, float]:
        node = self.node
        signals: Dict[str, float] = {}
        mp = getattr(node, "mempool", None)
        if mp is not None:
            signals["mempool"] = self._sat(mp.size(), mp.max_txs)
            signals["mempool_bytes"] = self._sat(mp.txs_bytes(), mp.max_txs_bytes)
        cs = getattr(node, "consensus", None)
        q = getattr(cs, "_queue", None)
        if q is not None:
            signals["consensus_queue"] = self._sat(q.qsize(), q.maxsize or 0)
        gate = getattr(getattr(node, "rpc_server", None), "gate", None)
        if gate is not None:
            signals["rpc_inflight"] = self._sat(gate.inflight, gate.max_inflight)
        sw = getattr(node, "switch", None)
        if sw is not None:
            pending = 0
            cap = 0
            for peer in sw.peers.list():
                try:
                    st = peer.status()
                except Exception:
                    continue
                pending += sum(c["pending_messages"] for c in st["channels"])
            for d in sw._channel_descs:
                cap += d.send_queue_capacity
            signals["p2p_send_queues"] = self._sat(pending, cap * max(1, sw.num_peers()))
        self.last_signals = signals
        if self.metrics is not None:
            for name, v in signals.items():
                self.metrics.pressure.labels(name).set(round(v, 4))
        return signals

    # -- level machine -------------------------------------------------------

    def evaluate(self) -> int:
        """One controller tick: sample, derive the pressure level with
        hysteresis, apply the shed switches. Returns the new level."""
        signals = self.sample()
        sat = max(signals.values(), default=0.0)
        new = self.level
        if self.level < LEVEL_CRITICAL and sat >= self.cfg.critical_watermark:
            new = LEVEL_CRITICAL
        elif self.level < LEVEL_ELEVATED and sat >= self.cfg.elevated_watermark:
            new = LEVEL_ELEVATED
        elif self.level == LEVEL_CRITICAL and sat < HYSTERESIS * self.cfg.critical_watermark:
            new = LEVEL_ELEVATED
            if sat < HYSTERESIS * self.cfg.elevated_watermark:
                new = LEVEL_NORMAL
        elif self.level == LEVEL_ELEVATED and sat < HYSTERESIS * self.cfg.elevated_watermark:
            new = LEVEL_NORMAL
        if new != self.level:
            direction = "up" if new > self.level else "down"
            logger.warning(
                "overload pressure %s: %s -> %s (max saturation %.2f, %s)",
                direction, LEVEL_NAMES[self.level], LEVEL_NAMES[new], sat,
                {k: round(v, 2) for k, v in signals.items()},
            )
            if direction == "up":
                self.transitions_up += 1
            else:
                self.transitions_down += 1
            if self.metrics is not None:
                self.metrics.transitions.labels(direction).inc()
            self.level = new
        if self.metrics is not None:
            self.metrics.pressure_level.set(self.level)
        self._apply()
        return self.level

    def _apply(self) -> None:
        """Flip the shed switches for the current level — in ORDER: txs
        first (elevated), then non-critical gossip + RPC reads (critical).
        Votes are untouchable at every level."""
        shed_txs = self.level >= LEVEL_ELEVATED
        shed_gossip = self.level >= LEVEL_CRITICAL
        mpr = getattr(self.node, "mempool_reactor", None)
        if mpr is not None:
            mpr.shed = shed_txs
        gate = getattr(getattr(self.node, "rpc_server", None), "gate", None)
        if gate is not None:
            gate.shed_writes = shed_txs
            gate.shed_reads = shed_gossip
        sw = getattr(self.node, "switch", None)
        evr = sw.reactors.get("EVIDENCE") if sw is not None else None
        if evr is not None:
            evr.shed = shed_gossip
        # verification scheduler budgets (crypto/scheduler.py): level 1
        # shrinks the admission/catch-up lanes, level 2 pauses catch-up —
        # the device's bulk capacity yields to the vote path exactly when
        # the node is drowning
        sched = getattr(self.node, "scheduler", None)
        if sched is not None:
            sched.set_pressure(self.level)

    def shed_state(self) -> Dict[str, bool]:
        return {
            "mempool_gossip": self.level >= LEVEL_ELEVATED,
            "rpc_writes": self.level >= LEVEL_ELEVATED,
            "rpc_reads": self.level >= LEVEL_CRITICAL,
            "evidence_gossip": self.level >= LEVEL_CRITICAL,
            "votes": False,  # never
        }

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "level_name": LEVEL_NAMES[self.level],
            "signals": {k: round(v, 4) for k, v in self.last_signals.items()},
            "shed": self.shed_state(),
            "transitions": {"up": self.transitions_up, "down": self.transitions_down},
            "watermarks": {
                "elevated": self.cfg.elevated_watermark,
                "critical": self.cfg.critical_watermark,
            },
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="overload-controller")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        try:
            while True:
                self.evaluate()
                await asyncio.sleep(self.cfg.sample_interval)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("overload controller died")
