"""Deterministic fault schedules: a pure function of (seed, parameters). The
port's copy of tendermint_tpu/chaos/schedule.py: the same seed gives the same
events, JSON and fingerprint in both packages.

A schedule is a flat, time-sorted list of FaultEvents. Generation draws every
decision from ONE `random.Random(seed)` stream, so the same seed always
produces the same schedule (Mersenne Twister sequences are stable across
Python versions for the operations used here); `fingerprint()` hashes the
canonical JSON so a soak log can prove which schedule ran, and
`to_json`/`from_json` round-trip a schedule into a post-mortem artifact.

Episodes are SEQUENTIAL (a partition heals before the next fault starts):
overlapping partitions+crashes can legitimately stall a 4-validator net for
their whole union, which turns a bounded soak into a timeout lottery. The
serialized form still interleaves start/end events ("partition" then "heal",
"crash" then "restart") so the engine replays a flat timeline.

Event kinds and their params:
  device_error  {"count": k}                 next k device calls raise
  device_hang   {"seconds": s}               next device call sleeps s
  partition     {"groups": [[...], [...]]}   split node indices into groups
  heal          {}                           clear partitions, re-dial mesh
  crash         {"target": i, "wal_fault": None|"truncate"|"corrupt"}
  restart       {"target": i}
  shard_error   {"shard": j}                 next sharded dispatch fails at shard j
  shard_hang    {"shard": j, "seconds": s}   next sharded dispatch straggles at shard j
  device_lost   {"device": j}                mesh device j dies (every dispatch
                                             including it fails, probes fail)
  device_revive {"device": j}                device j's probes pass again; the
                                             health model runs its rejoin cycle
  peer_stall    {"target": i, "seconds": s}  node i swallows block requests
  peer_lie      {"target": i, "count": k}    node i serves k commit-tampered blocks
  chunk_corrupt {"target": i, "count": k}    node i serves k bit-rotted snapshot chunks

The catchup-level kinds fault the SERVING side of blocksync/
statesync via chaos/catchup.ServeFaults, so a rejoin soak's syncing nodes
meet stalling, lying, and corrupting peers on a reproducible timeline.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass
from typing import List, Sequence, Tuple

LEVEL_BY_KIND = {
    "device_error": "device",
    "device_hang": "device",
    "shard_error": "device",
    "shard_hang": "device",
    "device_lost": "device",
    "device_revive": "device",
    "partition": "network",
    "heal": "network",
    "crash": "process",
    "restart": "process",
    "peer_stall": "catchup",
    "peer_lie": "catchup",
    "chunk_corrupt": "catchup",
    "sig_poison": "adversary",
}


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, (list, tuple)) else v


def _thaw(v):
    return [_thaw(x) for x in v] if isinstance(v, tuple) else v


@dataclass(frozen=True)
class FaultEvent:
    at: float  # seconds from schedule start
    kind: str  # see LEVEL_BY_KIND
    params: Tuple[Tuple[str, object], ...] = ()  # sorted key/value pairs

    @property
    def level(self) -> str:
        return LEVEL_BY_KIND[self.kind]

    def param_dict(self) -> dict:
        """Params with list values thawed back from tuples (the engine hands
        these to adapter methods as keyword arguments)."""
        return {k: _thaw(v) for k, v in self.params}

    @classmethod
    def make(cls, at: float, kind: str, **params) -> "FaultEvent":
        if kind not in LEVEL_BY_KIND:
            raise ValueError(f"unknown fault kind {kind!r}")
        frozen = tuple(sorted((k, _freeze(v)) for k, v in params.items()))
        return cls(round(float(at), 4), kind, frozen)


class ChaosSchedule:
    def __init__(self, seed: int, events: Sequence[FaultEvent]):
        self.seed = seed
        self.events: List[FaultEvent] = sorted(events, key=lambda e: (e.at, e.kind))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ChaosSchedule)
            and self.seed == other.seed
            and self.events == other.events
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def duration(self) -> float:
        return self.events[-1].at if self.events else 0.0

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "events": [
                    {"at": e.at, "kind": e.kind, "params": {k: _thaw(v) for k, v in e.params}}
                    for e in self.events
                ],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "ChaosSchedule":
        o = json.loads(text)
        return cls(
            o["seed"],
            [
                FaultEvent.make(e["at"], e["kind"], **e.get("params", {}))
                for e in o["events"]
            ],
        )

    def fingerprint(self) -> str:
        """Stable hex digest of the canonical schedule — two runs with the
        same seed must log the same fingerprint (the reproducibility pin)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    # -- generation ---------------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        n_nodes: int,
        *,
        episodes: int = 6,
        kinds: Sequence[str] = ("partition", "crash", "device_error", "device_hang"),
        min_gap: float = 1.0,
        max_gap: float = 3.0,
        min_episode: float = 2.0,
        max_episode: float = 5.0,
        protected: Sequence[int] = (),
        start_delay: float = 2.0,
        mesh_devices: int = 8,
    ) -> "ChaosSchedule":
        """Deterministic episode schedule. `protected` node indices are never
        crashed (e.g. the byzantine equivocator, whose misbehavior the soak
        must keep observing). Partitions isolate ONE node (3-1 style splits
        keep >2/3 power connected, so the net limps instead of halting)."""
        rng = random.Random(seed)
        crashable = [i for i in range(n_nodes) if i not in set(protected)]
        if "crash" in kinds and not crashable:
            raise ValueError(
                "no crashable nodes: every index is protected but 'crash' "
                "is a requested fault kind"
            )
        events: List[FaultEvent] = []
        t = start_delay + rng.uniform(0.0, max_gap - min_gap)
        for _ in range(max(0, int(episodes))):
            kind = rng.choice(list(kinds))
            if kind == "partition":
                lonely = rng.randrange(n_nodes)
                groups = [
                    [i for i in range(n_nodes) if i != lonely],
                    [lonely],
                ]
                dur = rng.uniform(min_episode, max_episode)
                events.append(FaultEvent.make(t, "partition", groups=groups))
                events.append(FaultEvent.make(t + dur, "heal"))
                t += dur
            elif kind == "crash":
                target = rng.choice(crashable)
                wal_fault = rng.choice([None, "truncate", "corrupt"])
                dur = rng.uniform(min_episode, max_episode)
                events.append(
                    FaultEvent.make(t, "crash", target=target, wal_fault=wal_fault)
                )
                events.append(FaultEvent.make(t + dur, "restart", target=target))
                t += dur
            elif kind == "device_error":
                events.append(
                    FaultEvent.make(t, "device_error", count=rng.randint(3, 6))
                )
            elif kind == "device_hang":
                events.append(
                    FaultEvent.make(
                        t, "device_hang", seconds=round(rng.uniform(0.05, 0.3), 3)
                    )
                )
            elif kind == "shard_error":
                events.append(
                    FaultEvent.make(
                        t, "shard_error", shard=rng.randrange(mesh_devices)
                    )
                )
            elif kind == "shard_hang":
                events.append(
                    FaultEvent.make(
                        t, "shard_hang", shard=rng.randrange(mesh_devices),
                        seconds=round(rng.uniform(0.05, 0.3), 3),
                    )
                )
            elif kind == "device_lost":
                device = rng.randrange(mesh_devices)
                dur = rng.uniform(min_episode, max_episode)
                events.append(FaultEvent.make(t, "device_lost", device=device))
                events.append(
                    FaultEvent.make(t + dur, "device_revive", device=device)
                )
                t += dur
            elif kind == "peer_stall":
                events.append(
                    FaultEvent.make(
                        t, "peer_stall", target=rng.randrange(n_nodes),
                        seconds=round(rng.uniform(min_episode, max_episode), 3),
                    )
                )
            elif kind == "peer_lie":
                events.append(
                    FaultEvent.make(
                        t, "peer_lie", target=rng.randrange(n_nodes),
                        count=rng.randint(1, 3),
                    )
                )
            elif kind == "chunk_corrupt":
                events.append(
                    FaultEvent.make(
                        t, "chunk_corrupt", target=rng.randrange(n_nodes),
                        count=rng.randint(1, 3),
                    )
                )
            elif kind == "sig_poison":
                # signature-poisoning flood: the target gossips votes whose
                # signatures pass precheck but fail real verification —
                # count must clear the scorer's quarantine (3) + punish (8)
                # gates so the defense pipeline runs end to end
                events.append(
                    FaultEvent.make(
                        t, "sig_poison", target=rng.randrange(n_nodes),
                        count=rng.randint(12, 20),
                    )
                )
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
            t += rng.uniform(min_gap, max_gap)
        return cls(seed, events)
