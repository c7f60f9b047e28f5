"""Evidence reactor: gossips pending evidence on channel 0x38
(reference: evidence/reactor.go:16).

The port's copy of tendermint_tpu/evidence/reactor.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence, decode_evidence

logger = logging.getLogger("tendermint_tpu_torch.evidence")

EVIDENCE_CHANNEL = 0x38
BROADCAST_SLEEP = 0.1


def encode_evidence_list(evs: List[DuplicateVoteEvidence]) -> bytes:
    w = pw.Writer()
    for ev in evs:
        w.message_field(1, ev.encode(), always=True)
    return w.bytes()


def decode_evidence_list(data: bytes) -> List[DuplicateVoteEvidence]:
    return [decode_evidence(v) for f, _, v in pw.Reader(data) if f == 1]


class EvidenceReactor(Reactor):
    def __init__(self, evpool):
        super().__init__("EVIDENCE")
        self.evpool = evpool
        self._peer_tasks: Dict[str, asyncio.Task] = {}
        # flipped by the overload controller at CRITICAL pressure: pending
        # evidence is re-offered once pressure clears, so pausing the walk
        # delays inclusion without losing anything
        self.shed = False

    def get_channels(self) -> List[ChannelDescriptor]:
        # sheddable: evidence gossip re-sends until ack'd by inclusion, so a
        # shed message is retried — safe to drop under overload (reference
        # maxMsgSize: evidence lists are bounded by consensus params)
        return [
            ChannelDescriptor(
                EVIDENCE_CHANNEL, priority=6, send_queue_capacity=10,
                recv_message_capacity=1_048_576, sheddable=True,
            )
        ]

    async def add_peer(self, peer) -> None:
        self._peer_tasks[peer.id] = asyncio.create_task(
            self._broadcast_routine(peer), name=f"ev-bcast-{peer.id[:8]}"
        )

    async def remove_peer(self, peer, reason) -> None:
        t = self._peer_tasks.pop(peer.id, None)
        if t:
            t.cancel()

    async def stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()
        self._peer_tasks.clear()

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            evs = decode_evidence_list(msg_bytes)
        except Exception as e:
            logger.error("bad evidence msg from %s: %s", peer.id[:10], e)
            await self.switch.stop_peer_for_error(peer, e)
            return
        from tendermint_tpu_torch.evidence.pool import EvidenceWindowError

        import asyncio as _asyncio

        loop = _asyncio.get_running_loop()
        for ev in evs:
            try:
                # off-loop: gossiped evidence's signature checks ride the
                # scheduler's catch-up lane (idle-soak; see
                # EvidencePool._catchup_verifier), and that wait must park
                # an executor thread, never the consensus event loop
                await loop.run_in_executor(None, self.evpool.add_evidence, ev)
            except EvidenceWindowError as e:
                # benign race: honest peers with lagging/leading state offer
                # evidence outside OUR window — drop, never score
                logger.info("dropped out-of-window evidence from %s: %s", peer.id[:10], e)
            except Exception as e:
                # INVALID evidence (bad sigs, wrong set, forged powers) is
                # peer misconduct — it costs every receiver two signature
                # verifications; score it so a spammer eventually trips the
                # trust threshold (p2p/behaviour.py).
                logger.info("rejected evidence from %s: %s", peer.id[:10], e)
                try:
                    from tendermint_tpu_torch.p2p.behaviour import (
                        BAD_MESSAGE,
                        PeerBehaviour,
                    )

                    await self.switch.reporter.report(
                        PeerBehaviour(peer.id, BAD_MESSAGE, f"bad evidence: {e}")
                    )
                except Exception:
                    pass

    async def _broadcast_routine(self, peer) -> None:
        """Periodically offer all pending evidence the peer may lack
        (reference: evidence/reactor.go broadcastEvidenceRoutine)."""
        sent: set = set()
        try:
            while True:
                if self.shed:
                    await asyncio.sleep(BROADCAST_SLEEP)
                    continue
                pending = self.evpool.pending_evidence(-1)
                fresh = [ev for ev in pending if ev.hash() not in sent]
                if fresh:
                    ok = await peer.send(EVIDENCE_CHANNEL, encode_evidence_list(fresh))
                    if ok:
                        sent.update(ev.hash() for ev in fresh)
                if len(sent) > 4096:
                    # bound the per-peer dedup set on a long-lived connection:
                    # evidence that left the pending set (committed/expired)
                    # no longer needs suppressing
                    sent &= {ev.hash() for ev in pending}
                await asyncio.sleep(BROADCAST_SLEEP)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("evidence broadcast died for %s", peer.id[:10])
