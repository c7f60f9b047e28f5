"""Mempool reactor: gossips transactions on channel 0x30
(reference: mempool/reactor.go:18,190).

Per-peer broadcast task walks the mempool's tx list by insertion order and
skips txs the peer sent us (peer-ID tracking, reference: :41-96 mempoolIDs).

The port's copy of tendermint_tpu/mempool/reactor.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor

logger = logging.getLogger("tendermint_tpu_torch.mempool")

MEMPOOL_CHANNEL = 0x30
BROADCAST_SLEEP = 0.02
# proto framing slack on top of the configured max tx size when computing
# the channel's assembled-message cap (reference: mempool/reactor.go
# calcMaxMsgSize over MaxTxBytes)
MSG_OVERHEAD_BYTES = 4096


def encode_txs(txs: List[bytes]) -> bytes:
    w = pw.Writer()
    for tx in txs:
        w.bytes_field(1, tx, emit_empty=True)
    return w.bytes()


def decode_txs(data: bytes) -> List[bytes]:
    return [v for f, _, v in pw.Reader(data) if f == 1]


class MempoolReactor(Reactor):
    def __init__(self, mempool, broadcast: bool = True, metrics=None):
        super().__init__("MEMPOOL")
        self.mempool = mempool
        self.broadcast = broadcast
        self.metrics = metrics  # OverloadMetrics or None
        self._peer_tasks: Dict[str, asyncio.Task] = {}
        # Shed switch, flipped by the node's overload controller
        # (node/overload.py): while set, inbound gossiped txs are dropped
        # BEFORE the app CheckTx round-trip and the outbound walk pauses.
        # Independently of the switch, a FULL mempool sheds inbound gossip
        # (no point paying CheckTx for a tx that cannot be admitted).
        self.shed = False
        self.shed_rx = 0  # gossip messages dropped without decode/CheckTx

    def get_channels(self) -> List[ChannelDescriptor]:
        # sheddable: under inbound overload, gossiped txs are the FIRST
        # traffic dropped (votes never are — see ChannelDescriptor.sheddable).
        # The cap derives from the CONFIGURED max tx size, so a fleet running
        # raised [mempool] max_tx_bytes doesn't fatally disconnect honest
        # peers gossiping legitimately large txs.
        max_tx = getattr(self.mempool, "max_tx_bytes", 1_048_576)
        return [
            ChannelDescriptor(
                MEMPOOL_CHANNEL, priority=5, send_queue_capacity=128,
                recv_message_capacity=max_tx + MSG_OVERHEAD_BYTES, sheddable=True,
            )
        ]

    async def add_peer(self, peer) -> None:
        if self.broadcast:
            self._peer_tasks[peer.id] = asyncio.create_task(
                self._broadcast_tx_routine(peer), name=f"mempool-bcast-{peer.id[:8]}"
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
        if self.shed or self.mempool.is_full(0):
            # overload/full: drop the whole batch BEFORE decoding it or
            # paying the CheckTx round-trip (parsing a flood to count it
            # would defeat the point) — gossiped txs are retried by the
            # sender's walk, so a shed here costs latency, not delivery
            self.shed_rx += 1  # messages (batches), not txs
            if self.metrics is not None:
                self.metrics.shed.labels("mempool_gossip").inc()
            return
        loop = asyncio.get_running_loop()
        txs = decode_txs(msg_bytes)
        # One executor hop for the WHOLE gossiped batch: check_tx_batch
        # verifies every signed-tx envelope in ONE admission-lane submit
        # (device-batched CheckTx, crypto/scheduler.py) before the per-tx
        # locked admission — off-loop so a slow CheckTx can't stall all
        # p2p/consensus I/O (same policy as the RPC broadcast path).
        try:
            await loop.run_in_executor(
                None, self.mempool.check_tx_batch, txs, peer.id
            )
        except Exception as e:
            logger.debug("gossiped tx batch rejected: %s", e)

    async def _broadcast_tx_routine(self, peer) -> None:
        """(reference: mempool/reactor.go:190 broadcastTxRoutine)"""
        sent: set = set()
        try:
            while True:
                if self.shed:
                    await asyncio.sleep(BROADCAST_SLEEP * 5)
                    continue
                entries = self.mempool.entries()
                progress = False
                for key, tx, senders in entries:
                    if key in sent:
                        continue
                    if peer.id in senders:
                        sent.add(key)  # peer gave it to us; skip
                        continue
                    ok = await peer.send(MEMPOOL_CHANNEL, encode_txs([tx]))
                    if ok:
                        sent.add(key)
                        progress = True
                        tt = getattr(self.mempool, "_tt", lambda: None)()
                        if tt is not None:
                            # first successful fan-out only — the tracker
                            # dedupes repeats, so the stage names when the tx
                            # FIRST left this node, not how many peers got it
                            tt.record(key, "first_gossiped", peer=peer.id[:10])
                if not progress:
                    await asyncio.sleep(BROADCAST_SLEEP)
                # GC the sent-set against the live mempool
                if len(sent) > 10000:
                    live = {k for k, _, _ in self.mempool.entries()}
                    sent &= live
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("mempool broadcast died for %s", peer.id[:10])
