"""Per-stage accumulators for the vote path's host loop: the port's copy of
tendermint_tpu/libs/hotstats.py.

Each layer of the receive loop (protowire encodes, the WAL, event-bus
fan-out, gossip, the signature verify) adds its wall time to one of five
stage buckets, so a run can report a per-stage us/vote breakdown. Timing is
off by default: every instrumented call site reduces to one `stats.enabled`
flag check. Stages are measured at their own layer, so they nest rather
than partition: a WAL frame write that runs a first Vote.encode counts
under both `wal` and `encode`.
"""

from __future__ import annotations

from time import perf_counter

__all__ = ["HotpathStats", "stats", "perf_counter"]


class HotpathStats:
    """Five stage buckets: encode (protowire/sign-bytes computes), wal
    (frame writes + group-commit flushes + fsyncs), pubsub (event-bus
    publishes), gossip (reactor broadcast fan-out), verify (host or device
    signature checks)."""

    STAGES = ("encode", "wal", "pubsub", "gossip", "verify")

    __slots__ = ("enabled", "seconds", "counts")

    def __init__(self) -> None:
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.seconds = {s: 0.0 for s in self.STAGES}
        self.counts = {s: 0 for s in self.STAGES}

    def add(self, stage: str, dt: float, n: int = 1) -> None:
        self.seconds[stage] += dt
        self.counts[stage] += n

    def snapshot(self) -> dict:
        return {"seconds": dict(self.seconds), "counts": dict(self.counts)}

    def delta_since(self, before: dict) -> dict:
        """Stage seconds/counts accumulated since a snapshot(): a timed
        region bracketed this way leaves warm-up work out."""
        return {
            "seconds": {
                s: self.seconds[s] - before["seconds"].get(s, 0.0) for s in self.STAGES
            },
            "counts": {
                s: self.counts[s] - before["counts"].get(s, 0) for s in self.STAGES
            },
        }

    @staticmethod
    def breakdown_us(delta: dict, votes: int) -> dict:
        """{stage}_us per vote from a delta_since() dict."""
        if votes <= 0:
            return {}
        return {
            f"{s}_us": round(delta["seconds"][s] / votes * 1e6, 3)
            for s in HotpathStats.STAGES
        }


# Process-global instance (one live consensus hot loop per process; a
# measurement enables it around its timed region).
stats = HotpathStats()
