"""LocalChaosNet: an in-process multi-validator net with chaos controls. The
port's copy of tendermint_tpu/chaos/harness.py.

The ChaosEngine-facing adapter for soaks: owns N Nodes built by a caller
-supplied factory (so the test controls config — db backend, WAL paths,
plaintext transport), wires the full mesh, and implements the network/process
fault kinds (device kinds are delegated to a DeviceFaultInjector, which is
process-global like the crypto pipeline it faults).

Partitions are enforced at BOTH ends: every switch gets a connection filter
admitting only same-group peer ids (dials, inbound upgrades, and reconnect
attempts all consult it — p2p/switch.py), and existing cross-group links are
dropped. heal() clears the filters and re-dials the mesh, so liveness after
heal exercises the real dial/handshake path, not a kept-alive socket.

The device kinds go to the port's chaos/device.py injector. An injected
`device_error` is a device error like a real one (ROADMAP D1): the flush it
meets raises, and a node whose deferred vote flush meets it halts with
`halt_error`, where the reference's fallbacks absorb it. The shard kinds
(`shard_error`, `shard_hang`), `device_lost` and `device_revive` arm the
injector's shard half, which parallel/sharded.py's dispatches meet: a node
whose card flushes run on a mesh sees the armed shard's flush raise (D1),
the health model strike that shard and the next mesh built on the healthy
devices.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

from tendermint_tpu_torch.chaos.device import DeviceFaultInjector
from tendermint_tpu_torch.chaos.process import (
    corrupt_wal_tail,
    hard_kill,
    truncate_wal_tail,
)

logger = logging.getLogger("tendermint_tpu_torch.chaos")


class LocalChaosNet:
    def __init__(
        self,
        make_node: Callable[[int], object],
        n: int,
        injector: Optional[DeviceFaultInjector] = None,
    ):
        self.make_node = make_node
        self.n = n
        self.nodes: List[Optional[object]] = [None] * n
        self.injector = injector or DeviceFaultInjector()
        self._groups: Optional[List[set]] = None
        self._id_to_index: Dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self.injector.install()
        for i in range(self.n):
            await self._start_node(i)
        await self.dial_mesh()

    async def _start_node(self, i: int) -> None:
        node = self.make_node(i)
        self.nodes[i] = node
        # register + filter BEFORE the listener opens: a node restarted
        # during an active partition must never accept a cross-group
        # connection in the startup window (peers' filters pass unknown ids)
        self._id_to_index[node.node_key.id] = i
        if self._groups is not None:
            self._apply_filter(i)
        await node.start()

    async def dial_mesh(self) -> None:
        for a in self.live_nodes():
            for b in self.live_nodes():
                if a is b or a.switch.peers.has(b.node_key.id):
                    continue
                if not self._allowed(a, b.node_key.id):
                    continue
                try:
                    await a.switch.dial_peers_async(
                        [f"{b.node_key.id}@{b.p2p_addr}"], persistent=True
                    )
                except Exception:
                    logger.exception("chaos mesh dial failed")

    async def stop(self) -> None:
        self.injector.uninstall()
        for node in self.live_nodes():
            try:
                await node.stop()
            except Exception:
                pass

    def live_nodes(self) -> List[object]:
        return [n for n in self.nodes if n is not None]

    # -- device faults (schedule kinds) -------------------------------------

    def device_error(self, count: int) -> None:
        self.injector.arm_errors(count)

    def device_hang(self, seconds: float) -> None:
        self.injector.arm_hang(seconds)

    def shard_error(self, shard: int) -> None:
        """Next sharded dispatch fails at shard `shard`."""
        self.injector.arm_shard_error(shard)

    def shard_hang(self, shard: int, seconds: float) -> None:
        """Next sharded dispatch straggles `seconds` at shard `shard`."""
        self.injector.arm_shard_hang(shard, seconds)

    def device_lost(self, device) -> None:
        """Mesh device dies: every dispatch including it raises and its
        health probes fail until device_revive. `device` is an index into
        the mesh's device list (or an explicit device string)."""
        self.injector.arm_device_lost(device)

    def device_revive(self, device=None) -> None:
        """Lost device's probes pass again; rejoin cycle can run. An index
        revives whatever device string it resolved to at dispatch time;
        None revives all."""
        self.injector.revive_device(device)

    # -- network faults ------------------------------------------------------

    def _group_of(self, i: int) -> Optional[set]:
        if self._groups is None:
            return None
        for g in self._groups:
            if i in g:
                return g
        return None

    def _allowed(self, node, peer_id: str) -> bool:
        if self._groups is None:
            return True
        me = self._id_to_index.get(node.node_key.id)
        other = self._id_to_index.get(peer_id)
        if me is None or other is None:
            return True
        g = self._group_of(me)
        return g is not None and other in g

    def _apply_filter(self, i: int) -> None:
        node = self.nodes[i]
        if node is None or node.switch is None:
            return
        if self._groups is None:
            node.switch.set_conn_filter(None)
        else:
            node.switch.set_conn_filter(
                lambda peer_id, _node=node: self._allowed(_node, peer_id)
            )

    async def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Split node indices into isolated groups; cross-group links drop
        and stay down (filters block dial/accept/reconnect) until heal()."""
        self._groups = [set(g) for g in groups]
        for i in range(self.n):
            self._apply_filter(i)
        for node in self.live_nodes():
            for peer in list(node.switch.peers.list()):
                if not self._allowed(node, peer.id):
                    await node.switch.disconnect_peer(peer.id, "chaos partition")

    async def heal(self) -> None:
        self._groups = None
        for i in range(self.n):
            self._apply_filter(i)
        await self.dial_mesh()

    # -- catch-up faults -----------------------------------------------------

    def _serve_faults(self, target: int):
        """The target node's ServeFaults, installing one on first use.
        Crashed nodes return None (arming a dead server is a no-op, like
        restart() of a live node — a replayed schedule must not abort)."""
        node = self.nodes[target]
        if node is None:
            return None
        from tendermint_tpu_torch.chaos.catchup import install

        sf = getattr(node, "blocksync_reactor", None) and node.blocksync_reactor.serve_faults
        return sf or install(node)

    def peer_stall(self, target: int, seconds: float) -> None:
        """Node `target` silently swallows block requests for `seconds`."""
        sf = self._serve_faults(target)
        if sf is not None:
            sf.arm_block_stall(seconds)

    def peer_lie(self, target: int, count: int) -> None:
        """Node `target` serves its next `count` blocks commit-tampered."""
        sf = self._serve_faults(target)
        if sf is not None:
            sf.arm_block_lies(count)

    def chunk_corrupt(self, target: int, count: int) -> None:
        """Node `target` serves its next `count` snapshot chunks bit-rotted."""
        sf = self._serve_faults(target)
        if sf is not None:
            sf.arm_chunk_corrupt(count)

    # -- adversarial faults (adversarial flush defense) ----------------------

    async def sig_poison(self, target: int, count: int, burst: bool = False) -> None:
        """Node `target` gossips `count` precheck-passing, verify-failing
        votes (chaos/byzantine.py poison_votes) — the signature-poisoning
        flood the provenance/quarantine defense must absorb; `burst` (an
        event param the reference's schedules never set) writes the flood
        to each peer at once. Crashed targets no-op (a replayed schedule
        must not abort)."""
        node = self.nodes[target]
        if node is None:
            return
        from tendermint_tpu_torch.chaos.byzantine import poison_votes

        await poison_votes(node, count, burst=burst)

    # -- process faults ------------------------------------------------------

    async def crash(self, target: int, wal_fault: Optional[str] = None) -> None:
        node = self.nodes[target]
        if node is None:
            return
        wal_path = node.wal.path
        self._id_to_index.pop(node.node_key.id, None)
        self.nodes[target] = None
        await hard_kill(node)
        if wal_fault == "truncate":
            truncate_wal_tail(wal_path)
        elif wal_fault == "corrupt":
            corrupt_wal_tail(wal_path)

    async def restart(self, target: int) -> None:
        if self.nodes[target] is not None:
            return  # already up (e.g. a schedule replayed onto a live node)
        await self._start_node(target)
        await self.dial_mesh()

    # -- invariants ----------------------------------------------------------

    def min_height(self) -> int:
        live = self.live_nodes()
        return min((n.block_store.height for n in live), default=0)

    def max_height(self) -> int:
        return max((n.block_store.height for n in self.live_nodes()), default=0)

    def assert_safety(self) -> None:
        """No two nodes may have committed conflicting blocks at any height —
        THE BFT safety invariant, checked over every height any pair of live
        nodes share."""
        live = self.live_nodes()
        top = max((n.block_store.height for n in live), default=0)
        for h in range(1, top + 1):
            hashes = {}
            for node in live:
                if node.block_store.height < h:
                    continue
                b = node.block_store.load_block(h)
                if b is not None:
                    hashes[node.node_key.id[:8]] = b.hash().hex()
            if len(set(hashes.values())) > 1:
                raise AssertionError(
                    f"SAFETY VIOLATION at height {h}: conflicting commits {hashes}"
                )

    def committed_evidence(self) -> list:
        """All DuplicateVoteEvidence committed in any live node's chain."""
        out = []
        for node in self.live_nodes():
            for h in range(1, node.block_store.height + 1):
                b = node.block_store.load_block(h)
                if b is not None and len(b.evidence) > 0:
                    out.extend(b.evidence)
        return out
