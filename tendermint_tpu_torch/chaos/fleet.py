"""Fleet harness: a seeded heterogeneous soak. The port's copy of
tendermint_tpu/chaos/fleet.py.

`FleetSpec.generate(seed, n)` is a pure function of ONE `random.Random(seed)`
stream, like ChaosSchedule.generate: it fixes the role split (validators with
mixed ed25519/BLS keys, full nodes, some entering mid-soak via blocksync or
statesync, light-serving edges), a bounded-degree p2p topology (a ring over
the initial nodes plus seeded chord edges: a full mesh is O(n²) dials at 50
nodes), a composed chaos schedule (partitions, crashes + WAL damage,
catch-up faults against the serving side, device faults, signature
poisoning), and the workload plan (signed-tx flood cadence, Zipfian light
traffic, RPC burst shape). `fingerprint()` hashes the canonical spec JSON:
the same arguments give the reference's spec, schedule and fingerprints.

`FleetNet` extends LocalChaosNet with the staged lifecycle: only join_at==0
nodes boot at start; `join(i)` brings a staged node up later (blocksync from
genesis, or statesync off node 0's snapshots); `restart()` refuses to
early-start a node the soak never booted.

`run_fleet_soak` is the whole story end to end: boot, flood, joiners, chaos,
height gate, then every surviving node's observatory dump and a
`fleet_manifest.json` into one directory for tools/fleet_referee.py to audit
offline, beside the in-process `net.assert_safety()`.

The port's additions: `FleetHarness` and `run_fleet_soak` take `device=`
and hand it to every Node (tests pass "cpu"); and ROADMAP D1 for a fleet.
The reference's fallbacks absorb an injected `device_error`, so its fleet
commits on. A port node whose flush meets one stores the error and halts.
`run_fleet_soak`'s gate loop therefore polls every live node's
`raise_failures()` and ends the soak at the first stored failure, naming
the node and the heights: a device error is raised as itself, with a note
naming the node; any other failure as a RuntimeError from it. It does not
wait out `deadline_s`.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import random
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from tendermint_tpu_torch.chaos.engine import ChaosEngine
from tendermint_tpu_torch.chaos.harness import LocalChaosNet
from tendermint_tpu_torch.chaos.schedule import ChaosSchedule, FaultEvent

logger = logging.getLogger("tendermint_tpu_torch.chaos")

ROLE_VALIDATOR = "validator"
ROLE_FULL = "full"
ROLE_LIGHT = "light_edge"
ROLES = (ROLE_VALIDATOR, ROLE_FULL, ROLE_LIGHT)

MANIFEST_NAME = "fleet_manifest.json"


@dataclass(frozen=True)
class NodeSpec:
    index: int
    role: str  # validator | full | light_edge
    key_type: str = "ed25519"  # validators only: ed25519 | bls12_381
    sync_mode: str = "consensus"  # consensus | blocksync | statesync
    join_at: float = 0.0  # seconds after soak start; 0 = boots with the net
    # signature poisoner (chaos/byzantine.py poison_votes): this validator
    # floods the net with precheck-passing, verify-failing votes on every
    # sig_poison event — the adversarial-flush-defense role
    poisoner: bool = False


class FleetSpec:
    """One seeded fleet: nodes + topology + chaos schedule + workload plan."""

    def __init__(
        self,
        seed: int,
        nodes: Sequence[NodeSpec],
        topology: Sequence[Tuple[int, int]],
        schedule: ChaosSchedule,
        workload: dict,
    ):
        self.seed = seed
        self.nodes: List[NodeSpec] = list(nodes)
        self.topology: List[Tuple[int, int]] = [tuple(e) for e in topology]
        self.schedule = schedule
        self.workload = dict(workload)

    # -- views ---------------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def validators(self) -> List[NodeSpec]:
        return [ns for ns in self.nodes if ns.role == ROLE_VALIDATOR]

    @property
    def light_edges(self) -> List[NodeSpec]:
        return [ns for ns in self.nodes if ns.role == ROLE_LIGHT]

    @property
    def joiners(self) -> List[NodeSpec]:
        return [ns for ns in self.nodes if ns.join_at > 0]

    def initial(self) -> List[NodeSpec]:
        return [ns for ns in self.nodes if ns.join_at <= 0]

    def role_of(self, i: int) -> str:
        return self.nodes[i].role

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "nodes": [asdict(ns) for ns in self.nodes],
            "topology": [list(e) for e in self.topology],
            "schedule": json.loads(self.schedule.to_json()),
            "workload": self.workload,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        o = json.loads(text)
        return cls(
            o["seed"],
            [NodeSpec(**ns) for ns in o["nodes"]],
            [tuple(e) for e in o["topology"]],
            ChaosSchedule.from_json(json.dumps(o["schedule"])),
            o["workload"],
        )

    def fingerprint(self) -> str:
        """Stable digest over the WHOLE spec (roles, keys, topology, chaos
        schedule, workload): the soak's reproducibility pin."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    # -- generation ----------------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        n_nodes: int = 50,
        *,
        validator_frac: float = 0.32,
        light_frac: float = 0.20,
        joiner_frac: float = 0.25,
        bls_validators: int = 1,
        statesync_joiners: int = 1,
        poisoners: int = 0,
        peer_degree: int = 4,
        episodes: int = 8,
        min_gap: float = 1.0,
        max_gap: float = 3.0,
        min_episode: float = 2.0,
        max_episode: float = 5.0,
        start_delay: float = 1.0,
        join_window: Tuple[float, float] = (4.0, 12.0),
        chaos_kinds: Sequence[str] = (
            "partition",
            "crash",
            "peer_stall",
            "peer_lie",
            "chunk_corrupt",
            "device_error",
            "device_hang",
        ),
    ) -> "FleetSpec":
        """Deterministic fleet from one rng stream.

        Node 0 is always a protected ed25519 validator: it anchors the
        statesync joiners' light provider and serves their snapshots, so the
        chaos composer never crashes or isolates it. BLS validators are real
        (they sign and everyone verifies): callers sizing a live soak for a
        slow pairing backend pass ``bls_validators=0`` and prove the
        mixed-key path at small scale.
        """
        if n_nodes < 4:
            raise ValueError("a fleet needs at least 4 nodes (BFT quorum)")
        rng = random.Random(seed)

        n_val = max(4, int(round(n_nodes * validator_frac)))
        n_val = min(n_val, n_nodes)
        n_light = min(max(0, int(round(n_nodes * light_frac))), n_nodes - n_val)

        # deterministic placement: validators first, light edges last, full
        # nodes in between — priv-key wiring stays a plain `i < n_val` check
        key_types = ["ed25519"] * n_val
        for vi in rng.sample(range(1, n_val), min(bls_validators, n_val - 1)):
            key_types[vi] = "bls12_381"

        # poisoners are ed25519 validators (never the anchor): they must sit
        # in the validator set so their fabricated votes clear the vote
        # set's structural checks and reach batch verification. rng draws
        # ONLY when requested: other seeds keep their fingerprints.
        poison_set: set = set()
        if poisoners > 0:
            pool = [i for i in range(1, n_val) if key_types[i] == "ed25519"]
            poison_set = set(rng.sample(pool, min(poisoners, len(pool))))

        full_indices = list(range(n_val, n_nodes - n_light))
        n_join = min(len(full_indices), int(round(len(full_indices) * joiner_frac)))
        joiner_set = set(rng.sample(full_indices, n_join)) if n_join else set()
        statesync_set = (
            set(rng.sample(sorted(joiner_set), min(statesync_joiners, n_join)))
            if n_join
            else set()
        )

        nodes: List[NodeSpec] = []
        for i in range(n_nodes):
            if i < n_val:
                nodes.append(NodeSpec(
                    i, ROLE_VALIDATOR, key_type=key_types[i],
                    poisoner=i in poison_set,
                ))
            elif i in joiner_set:
                join_at = round(rng.uniform(*join_window), 2)
                mode = "statesync" if i in statesync_set else "blocksync"
                nodes.append(
                    NodeSpec(i, ROLE_FULL, sync_mode=mode, join_at=join_at)
                )
            elif i < n_nodes - n_light:
                nodes.append(NodeSpec(i, ROLE_FULL))
            else:
                nodes.append(NodeSpec(i, ROLE_LIGHT))

        topology = cls._compose_topology(rng, nodes, peer_degree)
        schedule = cls._compose_schedule(
            rng,
            seed,
            nodes,
            episodes=episodes,
            kinds=chaos_kinds,
            min_gap=min_gap,
            max_gap=max_gap,
            min_episode=min_episode,
            max_episode=max_episode,
            start_delay=start_delay,
        )
        # sized for a single-process fleet: every tx fans out to N CheckTx
        # admissions plus per-commit rechecks, so a few tx/s is already a
        # real flood at 50 nodes; hotter rates starve consensus of CPU
        # and the soak crawls instead of committing
        workload = {
            "tx_interval": round(rng.uniform(0.4, 0.8), 3),
            "tx_batch": rng.randint(1, 2),
            "tx_mempool_cap": 300,
            "light_interval": round(rng.uniform(0.1, 0.2), 3),
            "light_batch": rng.randint(1, 2),
            "zipf_exponent": round(rng.uniform(1.0, 1.3), 2),
            "zipf_window": 64,
            "rpc_burst_period": round(rng.uniform(1.0, 2.5), 2),
            "rpc_burst_n": rng.randint(4, 10),
        }
        return cls(seed, nodes, topology, schedule, workload)

    @staticmethod
    def _compose_topology(
        rng: random.Random, nodes: Sequence[NodeSpec], peer_degree: int
    ) -> List[Tuple[int, int]]:
        """Bounded-degree connectivity: a ring over the initial nodes (so the
        boot net is connected without a full mesh) plus seeded chord edges;
        staged joiners get `peer_degree` seeded edges into the initial set."""
        initial = [ns.index for ns in nodes if ns.join_at <= 0]
        edges = set()

        def add(a: int, b: int) -> None:
            if a != b:
                edges.add((min(a, b), max(a, b)))

        for k, i in enumerate(initial):
            add(i, initial[(k + 1) % len(initial)])
        for ns in nodes:
            pool = [j for j in initial if j != ns.index]
            want = peer_degree if ns.join_at > 0 else max(0, peer_degree - 2)
            for j in rng.sample(pool, min(want, len(pool))):
                add(ns.index, j)
        return sorted(edges)

    @staticmethod
    def _compose_schedule(
        rng: random.Random,
        seed: int,
        nodes: Sequence[NodeSpec],
        *,
        episodes: int,
        kinds: Sequence[str],
        min_gap: float,
        max_gap: float,
        min_episode: float,
        max_episode: float,
        start_delay: float,
    ) -> ChaosSchedule:
        """Fleet-aware episode composer. Differs from ChaosSchedule.generate
        in three ways that matter at 50 nodes: partition groups span EVERY
        index (LocalChaosNet blocks a node absent from all groups from
        everything: a staged joiner must not boot into a void), crash
        targets are only initial non-light nodes (restart() of a
        never-started index would early-boot a joiner), and catch-up faults
        aim at the serving validators the joiners sync from."""
        n = len(nodes)
        # statesync anchor + snapshot source; poisoners are protected too:
        # the soak must keep observing their flood (and its quarantine) the
        # same way ChaosSchedule.generate protects the equivocator
        poisoner_idxs = [ns.index for ns in nodes if getattr(ns, "poisoner", False)]
        protected = {0} | set(poisoner_idxs)
        crashable = [
            ns.index
            for ns in nodes
            if ns.join_at <= 0 and ns.role != ROLE_LIGHT and ns.index not in protected
        ]
        lonely_pool = [
            ns.index for ns in nodes if ns.join_at <= 0 and ns.index not in protected
        ]
        servers = [
            ns.index for ns in nodes if ns.role == ROLE_VALIDATOR and ns.index not in protected
        ]
        events: List[FaultEvent] = []
        t = start_delay + rng.uniform(0.0, max(0.0, max_gap - min_gap))
        for _ in range(max(0, int(episodes))):
            kind = rng.choice(list(kinds))
            if kind == "partition":
                lonely = rng.choice(lonely_pool)
                groups = [[i for i in range(n) if i != lonely], [lonely]]
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
            elif kind == "peer_stall":
                events.append(
                    FaultEvent.make(
                        t,
                        "peer_stall",
                        target=rng.choice(servers),
                        seconds=round(rng.uniform(min_episode, max_episode), 3),
                    )
                )
            elif kind == "peer_lie":
                events.append(
                    FaultEvent.make(
                        t, "peer_lie", target=rng.choice(servers), count=rng.randint(1, 3)
                    )
                )
            elif kind == "chunk_corrupt":
                events.append(
                    FaultEvent.make(
                        t,
                        "chunk_corrupt",
                        target=rng.choice(servers),
                        count=rng.randint(1, 3),
                    )
                )
            elif kind == "device_error":
                events.append(FaultEvent.make(t, "device_error", count=rng.randint(3, 6)))
            elif kind == "device_hang":
                events.append(
                    FaultEvent.make(
                        t, "device_hang", seconds=round(rng.uniform(0.05, 0.3), 3)
                    )
                )
            elif kind == "sig_poison":
                if not poisoner_idxs:
                    raise ValueError(
                        "'sig_poison' requested but the fleet has no poisoner "
                        "nodes (FleetSpec.generate(poisoners=...))"
                    )
                # count clears the scorer's quarantine (3) + punish (8)
                # gates in one flood
                events.append(
                    FaultEvent.make(
                        t, "sig_poison", target=rng.choice(poisoner_idxs),
                        count=rng.randint(12, 20),
                    )
                )
            else:
                raise ValueError(f"unknown fleet fault kind {kind!r}")
            t += rng.uniform(min_gap, max_gap)
        if (
            "sig_poison" in kinds
            and poisoner_idxs
            and not any(e.kind == "sig_poison" for e in events)
        ):
            # a fleet that seats a poisoner must exercise it: the episode
            # draw is seeded and may skip the kind, so guarantee one flood
            events.append(
                FaultEvent.make(
                    t, "sig_poison", target=rng.choice(poisoner_idxs),
                    count=rng.randint(12, 20),
                )
            )
        return ChaosSchedule(seed, events)


class FleetNet(LocalChaosNet):
    """LocalChaosNet with the fleet's staged lifecycle + seeded topology."""

    def __init__(self, make_node, spec: FleetSpec, injector=None):
        super().__init__(make_node, spec.n_nodes, injector)
        self.spec = spec
        self.node_ids: Dict[int, str] = {}  # recorded at first boot; survives crash
        self._ever_started: set = set()

    async def start(self) -> None:
        self.injector.install()
        for ns in self.spec.initial():
            await self._start_node(ns.index)
        await self.dial_mesh()

    async def _start_node(self, i: int) -> None:
        await super()._start_node(i)
        self._ever_started.add(i)
        self.node_ids[i] = self.nodes[i].node_key.id
        self._update_role_gauge()

    async def join(self, i: int) -> None:
        """Bring a staged node (join_at > 0) up mid-soak."""
        if self.nodes[i] is not None:
            return
        await self._start_node(i)
        await self.dial_mesh()

    async def restart(self, target: int) -> None:
        # a replayed schedule's restart must never early-boot a staged
        # joiner that hasn't reached its join_at yet
        if target not in self._ever_started:
            return
        await super().restart(target)

    async def crash(self, target: int, wal_fault: Optional[str] = None) -> None:
        await super().crash(target, wal_fault)
        self._update_role_gauge()

    async def dial_mesh(self) -> None:
        """Dial only the spec's edges (not the O(n²) full mesh)."""
        for i, j in self.spec.topology:
            a, b = self.nodes[i], self.nodes[j]
            if a is None or b is None:
                continue
            # a node mid-boot (join/restart racing this dial pass) has no
            # listener yet; the next dial_mesh picks the edge up
            if getattr(b, "p2p_addr", None) is None:
                continue
            if a.switch.peers.has(b.node_key.id):
                continue
            if not self._allowed(a, b.node_key.id):
                continue
            try:
                await a.switch.dial_peers_async(
                    [f"{b.node_key.id}@{b.p2p_addr}"], persistent=True
                )
            except Exception:
                logger.exception("fleet dial failed")

    def _update_role_gauge(self) -> None:
        try:
            from tendermint_tpu_torch.libs.metrics import fleet_metrics

            counts = {r: 0 for r in ROLES}
            for ns in self.spec.nodes:
                if self.nodes[ns.index] is not None:
                    counts[ns.role] += 1
            for r, c in counts.items():
                fleet_metrics().nodes_by_role.labels(r).set(float(c))
        except Exception:
            pass


class FleetWorkloads:
    """The three concurrent client-side load generators: a
    signed-tx flood through the admission lane, Zipfian light traffic at the
    light edges, and periodic RPC bursts. All target choices draw from a
    seeded rng (derived from the spec seed): load is part of the replay."""

    def __init__(self, net: FleetNet, client_priv):
        self.net = net
        self.spec = net.spec
        self.client_priv = client_priv
        self.rng = random.Random(net.spec.seed ^ 0x5AFE)
        self.counters = {
            "tx_submitted": 0,
            "tx_errors": 0,
            "light_ok": 0,
            "light_shed": 0,
            "light_errors": 0,
            "rpc_ok": 0,
            "rpc_shed": 0,
            "rpc_errors": 0,
        }
        self._clients: Dict[int, tuple] = {}
        self._stop = asyncio.Event()
        self._tasks: List[asyncio.Task] = []

    def _client(self, i: int):
        """One LocalClient per live node object (a restart invalidates the
        cached server, so the cache is keyed on the node's identity)."""
        from tendermint_tpu_torch.rpc.client import LocalClient

        node = self.net.nodes[i]
        if node is None:
            return None
        cached = self._clients.get(i)
        if cached is not None and cached[0] is node:
            return cached[1]
        client = LocalClient(node)
        self._clients[i] = (node, client)
        return client

    def _live_indices(self, role: Optional[str] = None) -> List[int]:
        return [
            ns.index
            for ns in self.spec.nodes
            if self.net.nodes[ns.index] is not None
            and (role is None or ns.role == role)
        ]

    async def _tx_flood(self) -> None:
        from tendermint_tpu_torch.types.signed_tx import encode_signed_tx

        w = self.spec.workload
        n = 0
        while not self._stop.is_set():
            targets = self._live_indices(ROLE_VALIDATOR) or self._live_indices()
            cap = w.get("tx_mempool_cap") or 0
            for _ in range(w["tx_batch"]):
                if not targets:
                    break
                i = targets[n % len(targets)]
                node = self.net.nodes[i]
                if node is None:
                    continue
                # client-side backpressure: an unbounded resident set makes
                # every commit recheck it, and the fleet crawls: a real
                # flood client backs off when the pool stops draining
                mp = getattr(node, "mempool", None)
                if cap and mp is not None and mp.size() > cap:
                    continue
                client = self._client(i)
                if client is None:
                    continue
                tx = encode_signed_tx(self.client_priv, b"fleet%07d=v" % n)
                n += 1
                try:
                    await client.call("broadcast_tx_async", tx="0x" + tx.hex())
                    self.counters["tx_submitted"] += 1
                except Exception:
                    self.counters["tx_errors"] += 1
            await asyncio.sleep(w["tx_interval"])

    def _zipf_height(self, head: int) -> int:
        """Recency-biased Zipfian target: rank 1 = the head, tail falls off
        as 1/rank^a over the last `zipf_window` heights."""
        w = self.spec.workload
        window = max(1, min(head, int(w["zipf_window"])))
        ranks = range(1, window + 1)
        weights = [1.0 / (r ** w["zipf_exponent"]) for r in ranks]
        rank = self.rng.choices(list(ranks), weights=weights, k=1)[0]
        return head - rank + 1

    async def _light_traffic(self) -> None:
        from tendermint_tpu_torch.rpc.client import RPCError

        w = self.spec.workload
        k = 0
        while not self._stop.is_set():
            edges = self._live_indices(ROLE_LIGHT)
            head = self.net.max_height()
            if edges and head >= 2:
                for _ in range(w["light_batch"]):
                    i = edges[k % len(edges)]
                    k += 1
                    client = self._client(i)
                    if client is None:
                        continue
                    try:
                        await client.call(
                            "light_verify", height=self._zipf_height(head)
                        )
                        self.counters["light_ok"] += 1
                    except RPCError as e:
                        key = "light_shed" if e.code == -32005 else "light_errors"
                        self.counters[key] += 1
                    except Exception:
                        self.counters["light_errors"] += 1
            await asyncio.sleep(w["light_interval"])

    async def _rpc_bursts(self) -> None:
        from tendermint_tpu_torch.rpc.client import RPCError

        w = self.spec.workload
        methods = ("status", "net_info", "light_status")
        while not self._stop.is_set():
            await asyncio.sleep(w["rpc_burst_period"])
            live = self._live_indices()
            if not live:
                continue
            for _ in range(w["rpc_burst_n"]):
                i = self.rng.choice(live)
                client = self._client(i)
                if client is None:
                    continue
                try:
                    await client.call(self.rng.choice(methods))
                    self.counters["rpc_ok"] += 1
                except RPCError as e:
                    key = "rpc_shed" if e.code == -32005 else "rpc_errors"
                    self.counters[key] += 1
                except Exception:
                    self.counters["rpc_errors"] += 1

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._tx_flood(), name="fleet-tx-flood"),
            asyncio.create_task(self._light_traffic(), name="fleet-light"),
            asyncio.create_task(self._rpc_bursts(), name="fleet-rpc"),
        ]

    async def stop(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []


class FleetHarness:
    """Builds the fleet's nodes from a FleetSpec: per-spec priv keys (mixed
    ed25519/BLS), genesis, role-shaped configs, staged sync modes. Every
    Node gets `device` (None: the card, with the reference's routing)."""

    def __init__(
        self,
        spec: FleetSpec,
        root_dir: str,
        *,
        db_backend: str = "sqlite",
        snapshot_interval: int = 4,
        snapshot_keep: int = 80,
        slo_scale: float = 10.0,
        timeout_scale: Optional[float] = None,
        device=None,
    ):
        from tendermint_tpu_torch.crypto.keys import gen_bls12_381, gen_ed25519
        from tendermint_tpu_torch.privval.file_pv import FilePV
        from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

        self.spec = spec
        self.root_dir = str(root_dir)
        self.db_backend = db_backend
        self.snapshot_interval = snapshot_interval
        self.snapshot_keep = snapshot_keep
        self.device = device
        # test_config's sub-second round clock (0.4s propose) assumes a
        # handful of nodes; at fleet scale one starved core cannot gossip
        # a proposal plus two ~n/2-vote quorums before it expires, and
        # every height churns through failed rounds. Stretch the clock with
        # fleet size: skip_timeout_commit keeps the happy path committing
        # the instant quorum lands, so this only suppresses premature
        # round-skipping, like raising timeout_propose on an
        # underprovisioned real testnet.
        self.timeout_scale = (
            timeout_scale if timeout_scale is not None
            else max(1.0, spec.n_nodes / 8.0)
        )
        # SLO budgets ride the same clock: stretching the rounds stretches
        # the commit cadence, and every cadence-coupled budget
        # (tx_commit_latency spans 2-4 block intervals) must stretch with
        # it or the referee flags the stretched clock itself
        self.slo_scale = slo_scale * self.timeout_scale
        self.chain_id = f"fleet-{spec.seed}"

        def _priv(ns: NodeSpec):
            seed_bytes = bytes([(40 + ns.index) % 256]) * 32
            if ns.key_type == "bls12_381":
                return gen_bls12_381(seed_bytes)
            return gen_ed25519(seed_bytes)

        self._priv_keys = {ns.index: _priv(ns) for ns in spec.validators}
        self._pv_files = {
            i: os.path.join(self.root_dir, f"pv_state_{i}.json")
            for i in self._priv_keys
        }
        self.genesis = GenesisDoc(
            chain_id=self.chain_id,
            validators=[
                GenesisValidator(self._priv_keys[ns.index].pub_key(), 10)
                for ns in spec.validators
            ],
        )
        self.client_key = gen_ed25519(b"\x7f" * 32)  # the flood's signer
        self.net = FleetNet(self.make_node, spec)
        self._file_pv = FilePV

    def make_node(self, i: int):
        from tendermint_tpu_torch.abci.kvstore import SignedKVStoreApplication
        from tendermint_tpu_torch.config.config import test_config
        from tendermint_tpu_torch.node.node import Node

        ns = self.spec.nodes[i]
        cfg = test_config()
        cfg.base.db_backend = self.db_backend
        cfg.base.moniker = f"{ns.role}-{i}"
        cfg.rpc.laddr = ""
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False
        cfg.root_dir = os.path.join(self.root_dir, f"node{i}")
        os.makedirs(cfg.root_dir, exist_ok=True)
        cfg.instrumentation.forensics_dir = os.path.join(cfg.root_dir, "forensics")
        # SLOConfig budgets are sized for a LAN-ish production net; a
        # single-process soak under injected partitions/crashes shares one
        # host, so the harness loosens every budget by slo_scale (soaks
        # loosen to prove compliance, tighten to prove trips): the guards
        # still fire on real stalls
        for budget in (
            "proposal_propagation",
            "prevote_quorum_delay",
            "commit_interval",
            "verify_flush_wall",
            "light_verify_p99",
            "tx_commit_latency",
            "rpc_request_p99",
            "verify_lane_wait_votes",
            "verify_lane_wait_light",
            "verify_lane_wait_admission",
            "verify_lane_wait_catchup",
            "verify_lane_wait_quarantine",
        ):
            setattr(cfg.slo, budget, getattr(cfg.slo, budget) * self.slo_scale)
        for t in (
            "timeout_propose",
            "timeout_propose_delta",
            "timeout_prevote",
            "timeout_prevote_delta",
            "timeout_precommit",
            "timeout_precommit_delta",
        ):
            setattr(
                cfg.consensus, t, getattr(cfg.consensus, t) * self.timeout_scale
            )
        # deferred vote verification: gossiped votes queue and batch-verify
        # through the scheduler WITH peer provenance, the path the
        # adversarial flush defense protects. A sig_poison flood that were
        # verified serially at ingress would never reach a batch flush.
        cfg.consensus.defer_vote_verification = True
        # initial nodes run consensus from genesis (the all-fresh blocksync
        # handoff races at height 0); staged joiners take the real catch-up
        # paths
        cfg.base.fast_sync = ns.sync_mode in ("blocksync", "statesync")
        if ns.sync_mode == "statesync":
            cfg.statesync.enable = True
            # discovery is a SINGLE window here (ErrNoSnapshots ends the
            # retry ladder in a fallback to block sync), and it must cover
            # the joiner's post-start dials plus offer round-trips under
            # fleet load: a 1s window sees no offers at 50 nodes
            cfg.statesync.discovery_time = 6.0 * self.timeout_scale
            cfg.statesync.chunk_request_timeout = 3.0 * self.timeout_scale
            cfg.statesync.chunk_retries = 4
            cfg.statesync.chunk_backoff = 0.1
        priv = None
        if i in self._priv_keys:
            priv = self._file_pv(self._priv_keys[i], state_file=self._pv_files[i])
        app = SignedKVStoreApplication(
            snapshot_interval=self.snapshot_interval,
            snapshot_keep=self.snapshot_keep,
        )
        node = Node(cfg, self.genesis, priv_validator=priv, app=app, device=self.device)
        if ns.sync_mode == "statesync":
            from tendermint_tpu_torch.rpc.client import LocalClient
            from tendermint_tpu_torch.statesync.stateprovider import (
                LightClientStateProvider,
            )
            from tendermint_tpu_torch.types.basic import NANOS

            source = self.net.nodes[0] or next(
                (n for n in self.net.live_nodes()), None
            )
            if source is not None and source.block_store.load_block(1) is not None:
                node._state_provider = LightClientStateProvider(
                    self.chain_id,
                    [LocalClient(source)],
                    1,
                    source.block_store.load_block(1).hash(),
                    24 * 3600 * NANOS,
                    device=self.device,
                )
        return node

    def write_manifest(self, directory: str, extra: Optional[dict] = None) -> str:
        """The referee's ground truth: which nodes SHOULD have dumped, with
        role/key/sync labels keyed the same way the observatory labels nodes
        (node_key.id[:10]), so coverage gaps become named nodes."""
        os.makedirs(directory, exist_ok=True)
        doc = {
            "fleet_manifest": 1,
            "seed": self.spec.seed,
            "chain_id": self.chain_id,
            "fingerprint": self.spec.fingerprint(),
            "schedule_fingerprint": self.spec.schedule.fingerprint(),
            "nodes": [
                {
                    **asdict(ns),
                    "node_id": self.net.node_ids.get(ns.index),
                    "label": (self.net.node_ids.get(ns.index) or "")[:10] or None,
                    "live": self.net.nodes[ns.index] is not None,
                }
                for ns in self.spec.nodes
            ],
            "workload": self.spec.workload,
        }
        if extra:
            doc.update(extra)
        path = os.path.join(directory, MANIFEST_NAME)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path


def _suspicion_stats() -> Optional[dict]:
    try:
        from tendermint_tpu_torch.crypto import provenance as _prov

        return _prov.default_scorer().stats()
    except Exception:
        return None


def raise_node_failures(net: FleetNet, heights: dict) -> None:
    """ROADMAP D1 for a fleet: raise the first failure a live node stored
    (Node.raise_failures: a prewarm, catch-up or state sync error, or a
    consensus halt), in node order. A device error is raised as itself with
    a note naming the node, its role and `heights`; any other failure as a
    RuntimeError naming them, from it."""
    from tendermint_tpu_torch.crypto.batch import device_error_of

    for ns in net.spec.nodes:
        node = net.nodes[ns.index]
        if node is None:
            continue
        try:
            node.raise_failures()
        except Exception as e:
            where = (
                f"fleet node {ns.index} ({ns.role}, "
                f"{(net.node_ids.get(ns.index) or '?')[:10]}) failed ({e}): "
                f"heights={heights} head={net.max_height()}"
            )
            dev_err = device_error_of(e)
            if dev_err is not None:
                dev_err.add_note(where)
                raise dev_err
            raise RuntimeError(where) from e


async def run_fleet_soak(
    spec: FleetSpec,
    root_dir: str,
    *,
    min_heights: int = 20,
    deadline_s: float = 600.0,
    settle_height: int = 2,
    lag_tolerance: int = 2,
    db_backend: str = "sqlite",
    referee: bool = True,
    device=None,
) -> dict:
    """The whole fleet story: boot -> workloads -> staged joins -> chaos ->
    height gate -> dumps + manifest -> (optionally) the offline referee.

    Returns a result dict with the verdict, heights, workload counters,
    chaos accounting, and the spec fingerprint. Raises RuntimeError (with a
    per-node height map) if the fleet stalls past `deadline_s`, and a live
    node's stored failure as soon as a gate sees it (raise_node_failures).
    Every Node gets `device`.
    """
    harness = FleetHarness(spec, root_dir, db_backend=db_backend, device=device)
    net = harness.net
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    deadline = t0 + deadline_s
    dumps_dir = os.path.join(str(root_dir), "observatory")

    def _heights() -> dict:
        return {
            ns.index: (net.nodes[ns.index].block_store.height
                       if net.nodes[ns.index] is not None else None)
            for ns in spec.nodes
        }

    async def _gate(cond, what: str) -> None:
        last_log = loop.time()
        while not cond():
            raise_node_failures(net, _heights())
            now = loop.time()
            if now > deadline:
                raise RuntimeError(
                    f"fleet soak stalled ({what}): heights={_heights()} "
                    f"head={net.max_height()}"
                )
            if now - last_log >= 15.0:
                last_log = now
                logger.info(
                    "fleet soak waiting on %s: t=%.0fs head=%s live=%d",
                    what, now - t0, net.max_height(), len(net.live_nodes()),
                )
            await asyncio.sleep(0.25)
        raise_node_failures(net, _heights())

    logger.info("fleet soak booting %d initial nodes", len(spec.initial()))
    await net.start()
    logger.info("fleet soak booted in %.1fs", loop.time() - t0)
    workloads = FleetWorkloads(net, harness.client_key)
    workloads.start()
    joiner_tasks: List[asyncio.Task] = []
    engine = ChaosEngine(spec.schedule, net)
    try:
        # baseline: the initial net commits before chaos starts
        await _gate(lambda: net.min_height() >= settle_height, "baseline")

        async def _join(ns: NodeSpec) -> None:
            await asyncio.sleep(ns.join_at)
            if ns.sync_mode == "statesync":
                # a statesync joiner needs a snapshot safely behind the head
                await _gate(
                    lambda: net.max_height() >= harness.snapshot_interval + 2,
                    f"snapshot for joiner {ns.index}",
                )
            await net.join(ns.index)

        joiner_tasks = [
            asyncio.create_task(_join(ns), name=f"fleet-join-{ns.index}")
            for ns in spec.joiners
        ]
        chaos_task = engine.start()

        def _settled() -> bool:
            if not chaos_task.done() or any(not t.done() for t in joiner_tasks):
                return False
            head = net.max_height()
            if head < min_heights:
                return False
            return all(
                n.block_store.height >= head - lag_tolerance
                for n in net.live_nodes()
            )

        await _gate(_settled, f"min_heights={min_heights} + catch-up")
        logger.info(
            "fleet soak settled at head=%d in %.1fs",
            net.max_height(), loop.time() - t0,
        )
        for t in joiner_tasks:
            t.result()  # surface joiner exceptions
        await chaos_task
        await workloads.stop()

        # the in-process safety check; the referee re-audits from the dumps
        net.assert_safety()

        from tendermint_tpu_torch.tools import chain_observatory as obs

        for n in net.live_nodes():
            obs.write_node_dump(n, dumps_dir)
        elapsed = loop.time() - t0
        harness.write_manifest(
            dumps_dir,
            extra={
                "min_heights": min_heights,
                "elapsed_s": round(elapsed, 2),
                "chaos": {
                    "applied": len(engine.applied),
                    "scheduled": len(spec.schedule),
                    "errors": [repr(e) for e in engine.errors],
                },
                "workload_counters": dict(workloads.counters),
            },
        )

        result = {
            "seed": spec.seed,
            "fingerprint": spec.fingerprint(),
            "schedule_fingerprint": spec.schedule.fingerprint(),
            "n_nodes": spec.n_nodes,
            "heights": net.max_height(),
            "min_height": net.min_height(),
            "elapsed_s": round(elapsed, 2),
            "live_nodes": len(net.live_nodes()),
            "joiners": {
                ns.index: {
                    "sync_mode": ns.sync_mode,
                    "height": (
                        net.nodes[ns.index].block_store.height
                        if net.nodes[ns.index] is not None else None
                    ),
                    "base": (
                        net.nodes[ns.index].block_store.base
                        if net.nodes[ns.index] is not None else None
                    ),
                }
                for ns in spec.joiners
            },
            "chaos_applied": len(engine.applied),
            "chaos_errors": [repr(e) for e in engine.errors],
            # adversarial flush defense: the process-global suspicion
            # scorer's view after the soak, plus which node ids the spec's
            # poisoners booted as (so a referee/test can match
            # "peer:<id>" quarantine entries back to the seeded adversary)
            "suspicion": _suspicion_stats(),
            "poisoners": {
                ns.index: net.node_ids.get(ns.index)
                for ns in spec.nodes
                if getattr(ns, "poisoner", False)
            },
            "workload": dict(workloads.counters),
            "dumps_dir": dumps_dir,
            "safety_violations": 0,  # assert_safety() would have raised
        }
        if referee:
            from tendermint_tpu_torch.tools import fleet_referee

            report = fleet_referee.build_report(
                obs.load_dumps(dumps_dir),
                manifest=fleet_referee.load_manifest(dumps_dir),
            )
            fleet_referee.write_report(report, dumps_dir)
            result["verdict"] = report["verdict"]
            result["safety_violations"] = len(report["safety"]["violations"])
            result["report"] = report
        return result
    finally:
        await workloads.stop()
        for t in joiner_tasks:
            t.cancel()
        await asyncio.gather(*joiner_tasks, return_exceptions=True)
        await engine.stop()
        await net.stop()
