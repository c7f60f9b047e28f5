"""Consensus reactor: gossips round state, proposals/parts and votes over 4
p2p channels (reference: consensus/reactor.go:27-30,41).

Channels: 0x20 State, 0x21 Data, 0x22 Vote, 0x23 VoteSetBits. Per peer, three
gossip tasks mirror the reference's goroutines (gossipDataRoutine :490,
gossipVotesRoutine :629, queryMaj23Routine :761). Internal consensus events
(NewRoundStep/ValidBlock/Vote) are broadcast via event-bus subscriptions
(reference: :398-470 broadcast routines).

All mutation of ConsensusState happens by enqueueing onto its receive loop
(add_peer_message); PeerState updates run inline on the shared asyncio loop —
a callback with no awaits is atomic, which is the same discipline the
reference achieves with the PeerState mutex.

The port's copy of tendermint_tpu/consensus/reactor.py, with one difference
that follows Go (consensus/reactor.go AddPeer: "If we're fast_syncing,
broadcast a RoundStepMessage later upon SwitchToConsensus()"): while
`wait_sync` the reactor does not announce its round state to a new peer,
and switch_to_consensus broadcasts it. The reference announces it at once,
so a syncing node's peers learn its height and spend the link on
consensus catch-up gossip (block parts and commit votes the syncing node
drops) while blocksync fetches the same blocks (ROADMAP C).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from tendermint_tpu_torch.consensus.cs_state import ConsensusState
from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    TraceContext,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    decode_message_traced,
    encode_message,
)
from tendermint_tpu_torch.consensus.round_state import RoundStepType
from tendermint_tpu_torch.libs import hotstats as _hotstats
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType
from tendermint_tpu_torch.types.event_bus import (
    EVENT_NEW_ROUND_STEP,
    EVENT_VALID_BLOCK,
    EVENT_VOTE,
    query_for_event,
)

logger = logging.getLogger("tendermint_tpu_torch.consensus.reactor")

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

GOSSIP_SLEEP = 0.02  # reference: config PeerGossipSleepDuration 100ms; tests are faster

# a trace stamp older than this measures catch-up/retransmission (the
# receiver's lag), not gossip propagation: count the message, drop the latency
STALE_TRACE_S = 30.0
QUERY_MAJ23_SLEEP = 0.5


def propagation_latency(recv_ts: float, origin_ts: float, skew) -> float:
    """Skew-corrected per-hop propagation latency in seconds.

    `origin_ts` lives in the ORIGIN node's wall-clock domain; `skew` is the
    origin's remote-minus-local offset estimated from timestamped ping/pong
    (p2p/conn/connection.py), so the origin's local send time is
    origin_ts - skew and latency = recv_ts - origin_ts + skew. Clamped at
    zero: residual skew error (±RTT/2) must never fabricate negative
    latency — honesty over precision."""
    lat = recv_ts - origin_ts
    if skew is not None:
        lat += skew
    return max(0.0, lat)


class PeerState:
    """What we know the peer knows (reference: consensus/reactor.go:928)."""

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self.height = 0
        self.round = -1
        self.step = RoundStepType.NEW_HEIGHT
        self.start_time_ns = 0
        self.proposal = False
        self.proposal_block_psh = None
        self.proposal_block_parts: Optional[BitArray] = None
        self.proposal_pol_round = -1
        self.proposal_pol: Optional[BitArray] = None
        self.prevotes: Dict[int, BitArray] = {}
        self.precommits: Dict[int, BitArray] = {}
        self.last_commit_round = -1
        self.last_commit: Optional[BitArray] = None
        self.catchup_commit_round = -1
        self.catchup_commit: Optional[BitArray] = None

    # -- updates from messages (reference: reactor.go ApplyNewRoundStep...) --

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        ps_height, ps_round = self.height, self.round
        if msg.height < self.height or (
            msg.height == self.height and msg.round < self.round
        ):
            return
        self.height = msg.height
        self.round = msg.round
        self.step = RoundStepType(msg.step) if msg.step else RoundStepType.NEW_HEIGHT
        self.start_time_ns = time.time_ns() - msg.seconds_since_start_time * 10**9
        if ps_height != msg.height or ps_round != msg.round:
            self.proposal = False
            self.proposal_block_psh = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
        if ps_height != msg.height:
            if ps_height + 1 == msg.height and ps_round == msg.last_commit_round:
                self.last_commit_round = msg.last_commit_round
                self.last_commit = self.precommits.get(ps_round)
            else:
                self.last_commit_round = msg.last_commit_round
                self.last_commit = None
            self.prevotes.clear()
            self.precommits.clear()
            self.catchup_commit_round = -1
            self.catchup_commit = None

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        if msg.height != self.height:
            return
        if msg.round != self.round and not msg.is_commit:
            return
        self.proposal_block_psh = msg.block_part_set_header
        self.proposal_block_parts = BitArray.from_bools(msg.block_parts)

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        if msg.height != self.height or msg.proposal_pol_round != self.proposal_pol_round:
            return
        self.proposal_pol = BitArray.from_bools(msg.proposal_pol)

    def apply_has_vote(self, msg: HasVoteMessage) -> None:
        if msg.height != self.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def set_has_proposal(self, proposal) -> None:
        if self.height != proposal.height or self.round != proposal.round:
            return
        if self.proposal:
            return
        self.proposal = True
        if self.proposal_block_parts is None:
            self.proposal_block_psh = proposal.block_id.part_set_header
            self.proposal_block_parts = BitArray(proposal.block_id.part_set_header.total)
        self.proposal_pol_round = proposal.pol_round
        self.proposal_pol = None

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        if self.height != height or self.round != round_:
            return
        if self.proposal_block_parts is not None:
            self.proposal_block_parts.set_index(index, True)

    def _votes_bits(self, height: int, round_: int, type_: SignedMsgType, num_validators: int) -> Optional[BitArray]:
        if self.height != height:
            # votes for height-1 land in last_commit
            if self.height == height + 1 and type_ == SignedMsgType.PRECOMMIT and round_ == self.last_commit_round:
                if self.last_commit is None:
                    self.last_commit = BitArray(num_validators)
                return self.last_commit
            return None
        table = self.prevotes if type_ == SignedMsgType.PREVOTE else self.precommits
        if round_ not in table:
            table[round_] = BitArray(num_validators)
        return table[round_]

    # Hard cap on any peer-supplied validator index: bounds every BitArray
    # allocation a remote can trigger (the reference's PeerRoundState arrays
    # are implicitly sized by the known validator set).
    MAX_VOTE_INDEX = 1 << 16

    def set_has_vote(self, height: int, round_: int, type_: SignedMsgType, index: int, num_validators: int = 0) -> None:
        if index < 0 or index >= self.MAX_VOTE_INDEX:
            return
        bits = self._votes_bits(height, round_, type_, max(num_validators, index + 1))
        if bits is not None:
            if index >= bits.size():
                # grow (peer table created before we knew the valset size)
                grown = BitArray(index + 1)
                grown.update(bits)
                bits = grown
                table = self.prevotes if type_ == SignedMsgType.PREVOTE else self.precommits
                if self.height == height:
                    table[round_] = bits
                elif self.height == height + 1:
                    self.last_commit = bits
            bits.set_index(index, True)

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage, our_votes: Optional[List[bool]] = None) -> None:
        bits = self._votes_bits(msg.height, msg.round, msg.type, len(msg.votes))
        if bits is None:
            return
        update = BitArray.from_bools(msg.votes)
        if our_votes is not None:
            # peer claims maj23: they have everything in (claimed OR ours)
            update = update.or_(BitArray.from_bools(our_votes))
        bits.update(update.or_(bits))

    def pick_vote_to_send(self, votes) -> Optional[object]:
        """votes: a VoteSet-like with bit_array()/get_by_index(); returns a
        Vote the peer lacks (reference: PeerState.PickSendVote :1049)."""
        picked = self.pick_votes_to_send(votes, limit=1)
        return picked[0] if picked else None

    def pick_votes_to_send(self, votes, limit: int = 64) -> List[object]:
        """Up to `limit` votes the peer lacks, in index order — ONE pass over
        the bit arrays per gossip wakeup instead of one full rescan per vote
        (the per-vote rescan made vote gossip O(validators) per vote)."""
        if votes is None or votes.size() == 0:
            return []
        ours = votes.bit_array()
        height = getattr(votes, "height", self.height)
        round_ = getattr(votes, "round", 0)
        type_ = getattr(votes, "signed_msg_type", SignedMsgType.PREVOTE)
        theirs = self._votes_bits(height, round_, type_, len(ours))
        out: List[object] = []
        for idx, have in enumerate(ours):
            if have and (theirs is None or not theirs.get_index(idx)):
                vote = votes.get_by_index(idx)
                if vote is not None:
                    out.append(vote)
                    if len(out) >= limit:
                        break
        return out


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState, wait_sync: bool = False):
        super().__init__("CONSENSUS")
        self.cs = cs
        self.wait_sync = wait_sync  # True while fast-sync is running
        self._tasks: List[asyncio.Task] = []
        self._peer_tasks: Dict[str, List[asyncio.Task]] = {}
        # (height, round) proposals already seen once — bounds the first-
        # receipt dedupe behind the propagation SLO (chain observatory)
        self._prop_seen: "OrderedDict[tuple, None]" = OrderedDict()

    def get_channels(self) -> List[ChannelDescriptor]:
        # NEVER sheddable: the overload shed order is txs -> non-critical
        # gossip -> never votes (per-channel caps follow the reference's
        # consensus maxMsgSize of 1MB; block parts are 64KB chunks)
        cap = 1_048_576
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6, send_queue_capacity=100,
                              recv_message_capacity=cap),
            ChannelDescriptor(DATA_CHANNEL, priority=10, send_queue_capacity=100,
                              recv_message_capacity=cap),
            ChannelDescriptor(VOTE_CHANNEL, priority=7, send_queue_capacity=100,
                              recv_message_capacity=cap),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=2,
                              recv_message_capacity=cap),
        ]

    async def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._broadcast_routine(), name="consr-broadcast"),
        ]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for tasks in self._peer_tasks.values():
            for t in tasks:
                t.cancel()
        self._peer_tasks.clear()

    async def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Fast-sync -> consensus handoff (reference: consensus/reactor.go:106);
        peers learn our round state now (Go: the broadcast on
        SwitchToConsensus)."""
        self.wait_sync = False
        await self.cs.start()
        if self.switch is not None:
            await self.switch.broadcast(
                STATE_CHANNEL,
                encode_message(self._our_round_step(), trace=self._fresh_trace()),
            )
        # spin up gossip for peers added while syncing
        for peer in (self.switch.peers.list() if self.switch else []):
            if peer.id not in self._peer_tasks:
                ps = peer.get("cs_peer_state") or PeerState(peer.id)
                peer.set("cs_peer_state", ps)
                self._peer_tasks[peer.id] = [
                    asyncio.create_task(self._gossip_data_routine(peer, ps)),
                    asyncio.create_task(self._gossip_votes_routine(peer, ps)),
                    asyncio.create_task(self._query_maj23_routine(peer, ps)),
                ]

    # -- peers -------------------------------------------------------------

    async def add_peer(self, peer) -> None:
        ps = PeerState(peer.id)
        peer.set("cs_peer_state", ps)
        if self.wait_sync:
            # announced at the handoff (switch_to_consensus), as Go does
            return
        await peer.send(
            STATE_CHANNEL,
            encode_message(self._our_round_step(), trace=self._fresh_trace()),
        )
        self._peer_tasks[peer.id] = [
            asyncio.create_task(self._gossip_data_routine(peer, ps)),
            asyncio.create_task(self._gossip_votes_routine(peer, ps)),
            asyncio.create_task(self._query_maj23_routine(peer, ps)),
        ]

    async def remove_peer(self, peer, reason) -> None:
        for t in self._peer_tasks.pop(peer.id, []):
            t.cancel()

    # -- trace propagation (the chain observatory) ---------------------------

    def _self_id(self) -> str:
        sw = self.switch
        if sw is None:
            return ""
        try:
            return sw.node_info.node_id
        except Exception:
            return ""

    def _fresh_trace(self) -> TraceContext:
        """Origin stamp for a message WE generate right now (NewRoundStep,
        HasVote): hops 0, wall clock now."""
        return TraceContext(self._self_id(), time.time(), 0)

    def _otrace(self, payload) -> TraceContext:
        """Outbound trace for a gossiped payload (vote/proposal/part):
        self-originated objects get ONE origin stamp at first send (memoized
        — every peer sees the same origin time), relayed objects forward the
        received context with the hop count bumped."""
        rx = getattr(payload, "_rx_trace", None)
        if rx is not None:
            fwd = payload.__dict__.get("_fwd_trace")
            if fwd is None:
                fwd = rx.forwarded()
                object.__setattr__(payload, "_fwd_trace", fwd)
            return fwd
        mine = payload.__dict__.get("_origin_trace")
        if mine is None:
            mine = self._fresh_trace()
            object.__setattr__(payload, "_origin_trace", mine)
        return mine

    def _note_trace(self, msg, tctx: TraceContext, peer) -> None:
        """A traced message arrived: stash the context on the payload (so a
        re-gossip forwards it hop-bumped) and record per-hop propagation
        latency — skew-corrected against the origin's ping/pong clock-skew
        estimate when the origin is a direct peer, else against the relaying
        peer's (the best available proxy on a multi-hop path).

        The stamp is remote-supplied and arrives BEFORE consensus
        validation, so recording is defensive: per-height timeline entries
        only for heights adjacent to our own (a peer must not flush the
        ring with invented heights), and stamps older than STALE_TRACE_S
        record counts but never latency — catch-up/retransmitted gossip
        measures the RECEIVER's lag, and must not poison the origin's."""
        recv_ts = time.time()
        payload = kind = None
        if isinstance(msg, VoteMessage):
            payload, kind = msg.vote, "vote"
        elif isinstance(msg, BlockPartMessage):
            payload, kind = msg.part, "block_part"
        elif isinstance(msg, ProposalMessage):
            payload, kind = msg.proposal, "proposal"
        elif isinstance(msg, HasVoteMessage):
            kind = "has_vote"
        elif isinstance(msg, NewRoundStepMessage):
            kind = "round_step"
        else:
            kind = "other"
        if payload is not None:
            try:
                object.__setattr__(payload, "_rx_trace", tctx)
            except Exception:
                pass
        tl = self.cs._tl()
        slo = self.cs.slo
        m = self.cs._live_metrics()
        if tl is None and slo is None and m is None:
            return
        skew = None
        sw = self.switch
        if sw is not None:
            try:
                skew = sw.clock_skew(tctx.origin)
            except Exception:
                skew = None
        if skew is None:
            mc = getattr(peer, "mconn", None)
            if mc is not None:
                try:
                    skew = mc.clock_skew()
                except Exception:
                    skew = None
        lat = propagation_latency(recv_ts, tctx.origin_ts, skew)
        stale = lat > STALE_TRACE_S
        if tl is not None and not stale:
            tl.record_hop(tctx.origin, kind, lat, skew_corrected=skew is not None)

        def _height_ok(h: int) -> bool:
            ours = self.cs.rs.height
            return ours - 1 <= h <= ours + 1

        if kind == "proposal":
            p = msg.proposal
            if not _height_ok(p.height):
                return
            first = self._mark_first_receipt(p.height, p.round)
            if tl is not None:
                # the timeline dedupes first-seen itself and counts the
                # duplicate receipts
                tl.record_proposal_propagation(
                    p.height, p.round, tctx.origin, lat, tctx.hops, ts=recv_ts
                )
            if first and not stale:
                # budget/histogram semantics are FIRST local receipt: each
                # peer gossips the proposal independently, and a duplicate
                # arriving late from a lagging peer is not propagation
                if m is not None:
                    m.proposal_propagation_seconds.observe(lat)
                if slo is not None:
                    slo.observe("proposal_propagation", lat)
        elif kind == "block_part":
            if not _height_ok(msg.height):
                return
            if tl is not None:
                tl.record_block_part(
                    msg.height, msg.round, None if stale else lat, ts=recv_ts
                )
        elif kind == "vote":
            v = msg.vote
            if not _height_ok(v.height):
                return
            if tl is not None:
                tl.record_vote_origin(
                    v.height, v.round, v.type.name, tctx.origin,
                    None if stale else lat,
                )
            if m is not None and not stale:
                m.vote_propagation_seconds.observe(lat)

    def _mark_first_receipt(self, height: int, round_: int) -> bool:
        """True exactly once per (height, round) proposal receipt; the seen
        set is bounded (FIFO) so remote-supplied keys cannot grow it."""
        key = (height, round_)
        seen = self._prop_seen
        if key in seen:
            return False
        seen[key] = None
        while len(seen) > 256:
            seen.popitem(last=False)
        return True

    # -- receive -----------------------------------------------------------

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            msg, tctx = decode_message_traced(msg_bytes)
        except Exception as e:
            logger.error("bad consensus msg from %s: %s", peer.id[:10], e)
            await self.switch.stop_peer_for_error(peer, e)
            return
        ps: PeerState = peer.get("cs_peer_state")
        if ps is None:
            return
        if tctx is not None:
            try:
                self._note_trace(msg, tctx, peer)
            except Exception:
                logger.exception("trace propagation recording failed")
        rs = self.cs.rs

        if chan_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                ps.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, VoteSetMaj23Message):
                if rs.height == msg.height and rs.votes is not None:
                    try:
                        rs.votes.set_peer_maj23(msg.round, msg.type, peer.id, msg.block_id)
                    except Exception as e:
                        logger.debug("set_peer_maj23: %s", e)
                    votes = (
                        rs.votes.prevotes(msg.round)
                        if msg.type == SignedMsgType.PREVOTE
                        else rs.votes.precommits(msg.round)
                    )
                    our = votes.bit_array_by_block_id(msg.block_id) if votes else None
                    if our is not None:
                        await peer.send(
                            VOTE_SET_BITS_CHANNEL,
                            encode_message(
                                VoteSetBitsMessage(msg.height, msg.round, msg.type, msg.block_id, our)
                            ),
                        )
        elif chan_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                await self.cs.add_peer_message(msg, peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
                m = self.cs.metrics
                if m is not None:
                    # block-part gossip timing (reference: CometBFT
                    # consensus/metrics.go BlockGossipPartsReceived /
                    # BlockGossipReceiveLatency)
                    matches = msg.height == rs.height and msg.round == rs.round
                    m.block_parts.labels("true" if matches else "false").inc()
                    if matches:
                        # origin: the round's proposal; before it arrives,
                        # fall back to the height start — valid for round 0
                        # only (start_time_ns is per-height, and counting a
                        # failed earlier round as gossip latency would
                        # pollute the tail)
                        origin_ns = 0
                        if rs.proposal is not None:
                            origin_ns = rs.proposal.timestamp_ns
                        elif rs.round == 0:
                            origin_ns = rs.start_time_ns
                        if origin_ns:
                            m.block_gossip_receive_latency.observe(
                                max(0.0, (time.time_ns() - origin_ns) / 1e9)
                            )
                await self.cs.add_peer_message(msg, peer.id)
        elif chan_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, VoteMessage):
                n_vals = rs.validators.size() if rs.validators else 0
                ps.set_has_vote(
                    msg.vote.height, msg.vote.round, msg.vote.type, msg.vote.validator_index, n_vals
                )
                await self.cs.add_peer_message(msg, peer.id)
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                if rs.height == msg.height and rs.votes is not None:
                    votes = (
                        rs.votes.prevotes(msg.round)
                        if msg.type == SignedMsgType.PREVOTE
                        else rs.votes.precommits(msg.round)
                    )
                    our = votes.bit_array_by_block_id(msg.block_id) if votes else None
                    ps.apply_vote_set_bits(msg, our)
                else:
                    ps.apply_vote_set_bits(msg, None)

    # -- broadcasts (reference: reactor.go:398-470) -------------------------

    def _our_round_step(self) -> NewRoundStepMessage:
        rs = self.cs.rs
        return NewRoundStepMessage(
            height=rs.height,
            round=rs.round,
            step=int(rs.step),
            seconds_since_start_time=max(0, int((time.time_ns() - rs.start_time_ns) / 1e9)),
            last_commit_round=rs.last_commit.round if rs.last_commit is not None else -1,
        )

    async def _broadcast_routine(self) -> None:
        """Event-bus → p2p broadcasts, COALESCED per wakeup: each consume
        drains everything already queued on its subscription and handles the
        batch in one call. Under a vote storm that turns N per-vote wakeups
        (each a full per-peer broadcast round) into one batched
        `broadcast_many`; for round-step/valid-block events only the LATEST
        state is broadcast (a NewRoundStepMessage carries full state, so
        intermediate ones are strictly stale)."""
        bus = self.cs.event_bus
        sub_step = bus.subscribe("cs-reactor", query_for_event(EVENT_NEW_ROUND_STEP), 200)
        sub_valid = bus.subscribe("cs-reactor", query_for_event(EVENT_VALID_BLOCK), 200)
        sub_vote = bus.subscribe("cs-reactor", query_for_event(EVENT_VOTE), 500)

        async def consume(sub, handler):
            while True:
                try:
                    msg = await sub.next()
                except Exception:
                    return
                batch = [msg]
                done = False
                while True:
                    try:
                        m = sub.queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if m is None:  # cancellation sentinel (unsubscribed)
                        done = True
                        break
                    batch.append(m)
                try:
                    await handler(batch)
                except Exception:
                    logger.exception("broadcast handler failed")
                if done:
                    return

        async def on_steps(_msgs):
            # coalesced: broadcast our CURRENT round state once per drain
            if self.switch is not None:
                await self.switch.broadcast(
                    STATE_CHANNEL,
                    encode_message(self._our_round_step(), trace=self._fresh_trace()),
                )

        async def on_valid(_msgs):
            rs = self.cs.rs
            if self.switch is not None and rs.proposal_block_parts is not None:
                m = NewValidBlockMessage(
                    rs.height, rs.round, rs.proposal_block_parts.header,
                    rs.proposal_block_parts.bit_array(), rs.step == RoundStepType.COMMIT,
                )
                await self.switch.broadcast(STATE_CHANNEL, encode_message(m))

        async def on_votes(msgs):
            if self.switch is None:
                return
            hs = _hotstats.stats if _hotstats.stats.enabled else None
            if hs is not None:
                t0 = _hotstats.perf_counter()
            payloads = []
            trace = self._fresh_trace()  # one stamp for the whole drain batch
            for msg in msgs:
                vote = msg.data.vote
                payloads.append(
                    encode_message(
                        HasVoteMessage(vote.height, vote.round, vote.type, vote.validator_index),
                        trace=trace,
                    )
                )
            await self.switch.broadcast_many(STATE_CHANNEL, payloads)
            if hs is not None:
                hs.add("gossip", _hotstats.perf_counter() - t0, n=len(msgs))

        await asyncio.gather(
            consume(sub_step, on_steps), consume(sub_valid, on_valid), consume(sub_vote, on_votes)
        )

    # -- gossip routines ----------------------------------------------------

    async def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        """(reference: consensus/reactor.go:490 gossipDataRoutine)"""
        try:
            while True:
                # Always yield once per iteration: peer.send() can return
                # False synchronously (dead connection) and a no-await loop
                # would freeze the event loop and resist cancellation.
                await asyncio.sleep(0)
                rs = self.cs.rs
                # 1. peer needs a part of the current proposal block
                if (
                    rs.proposal_block_parts is not None
                    and rs.height == ps.height
                    and ps.proposal_block_parts is not None
                    and rs.proposal_block_parts.header == ps.proposal_block_psh
                ):
                    ours = BitArray.from_bools(rs.proposal_block_parts.bit_array())
                    needed = ours.sub(ps.proposal_block_parts)
                    idx = needed.pick_random()
                    if idx is not None:
                        part = rs.proposal_block_parts.get_part(idx)
                        if part is not None:
                            ok = await peer.send(
                                DATA_CHANNEL,
                                encode_message(
                                    BlockPartMessage(rs.height, rs.round, part),
                                    trace=self._otrace(part),
                                ),
                            )
                            if ok:
                                ps.set_has_proposal_block_part(rs.height, rs.round, idx)
                            else:
                                await asyncio.sleep(GOSSIP_SLEEP)
                            continue
                # 2. peer is at an earlier height: catch them up from the store
                if ps.height != 0 and ps.height < rs.height and ps.height >= self.cs.block_store.base:
                    if await self._gossip_catchup(peer, ps):
                        continue
                # 3. peer needs our proposal
                if rs.proposal is not None and rs.height == ps.height and rs.round == ps.round and not ps.proposal:
                    await peer.send(
                        DATA_CHANNEL,
                        encode_message(
                            ProposalMessage(rs.proposal), trace=self._otrace(rs.proposal)
                        ),
                    )
                    ps.set_has_proposal(rs.proposal)
                    if 0 <= rs.proposal.pol_round:
                        pol = rs.votes.prevotes(rs.proposal.pol_round)
                        if pol is not None:
                            await peer.send(
                                DATA_CHANNEL,
                                encode_message(
                                    ProposalPOLMessage(rs.height, rs.proposal.pol_round, pol.bit_array())
                                ),
                            )
                    continue
                await asyncio.sleep(GOSSIP_SLEEP)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("gossip data routine died for %s", peer.id[:10])

    async def _gossip_catchup(self, peer, ps: PeerState) -> bool:
        """Send one block part for the peer's height from the store
        (reference: reactor.go:583 gossipDataForCatchup)."""
        if ps.proposal_block_parts is None:
            meta = self.cs.block_store.load_block_meta(ps.height)
            if meta is None:
                return False
            block_id = meta[0] if isinstance(meta, tuple) else meta.block_id
            ps.proposal_block_psh = block_id.part_set_header
            ps.proposal_block_parts = BitArray(block_id.part_set_header.total)
        needed = ps.proposal_block_parts.not_()
        idx = needed.pick_random()
        if idx is None:
            return False
        part = self.cs.block_store.load_block_part(ps.height, idx)
        if part is None:
            return False
        ok = await peer.send(
            DATA_CHANNEL,
            encode_message(
                BlockPartMessage(ps.height, ps.round, part), trace=self._otrace(part)
            ),
        )
        if ok:
            ps.proposal_block_parts.set_index(idx, True)
        return ok

    # max votes sent to one peer per gossip wakeup: one bit-array scan
    # amortizes over the whole run instead of one rescan per vote, while the
    # bound keeps a single peer from monopolizing the send queue
    VOTE_GOSSIP_BATCH = 64

    async def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        """(reference: consensus/reactor.go:629 gossipVotesRoutine; vote
        picking is batched — see PeerState.pick_votes_to_send)."""
        try:
            while True:
                await asyncio.sleep(0)  # guaranteed yield (see data routine)
                rs = self.cs.rs
                picked: List[object] = []
                if rs.height == ps.height and rs.votes is not None:
                    # current height: prevotes/precommits for peer's round,
                    # POL prevotes, our round's votes. The OUR-round sets are
                    # the round-catchup path (reference: reactor.go
                    # gossipVotesForHeight's final rs.Round clause): a peer
                    # that restarted or healed from a partition sits rounds
                    # behind and can only skip forward on +2/3 ANY at a later
                    # round — which it can never assemble unless same-height
                    # peers send votes from rounds ABOVE its own (the
                    # receiver files them under its peer-catchup rounds,
                    # round_state.py:116). Without this, a lagging validator
                    # crawls one timeout-stretched round at a time while the
                    # quorum needs it.
                    candidates = [
                        rs.votes.prevotes(ps.round) if ps.round >= 0 else None,
                        rs.votes.precommits(ps.round) if ps.round >= 0 else None,
                        rs.votes.prevotes(ps.proposal_pol_round) if ps.proposal_pol_round >= 0 else None,
                    ]
                    if 0 <= ps.round < rs.round:
                        candidates.append(rs.votes.prevotes(rs.round))
                        candidates.append(rs.votes.precommits(rs.round))
                    for votes in candidates:
                        picked = (
                            ps.pick_votes_to_send(votes, self.VOTE_GOSSIP_BATCH)
                            if votes else []
                        )
                        if picked:
                            break
                elif (
                    rs.height == ps.height + 1 and rs.last_commit is not None
                ):
                    # peer is finishing the previous height: send last commit
                    picked = ps.pick_votes_to_send(rs.last_commit, self.VOTE_GOSSIP_BATCH)
                elif (
                    ps.height != 0
                    and rs.height > ps.height + 1
                    and ps.height >= self.cs.block_store.base
                ):
                    # catchup: precommits from the stored commit
                    commit = self.cs.block_store.load_block_commit(ps.height)
                    if commit is not None:
                        vote = self._pick_commit_vote(ps, commit)
                        if vote is not None:
                            picked = [vote]
                if picked:
                    sent_any = False
                    for vote in picked:
                        ok = await peer.send(
                            VOTE_CHANNEL,
                            encode_message(VoteMessage(vote), trace=self._otrace(vote)),
                        )
                        if not ok:
                            break
                        sent_any = True
                        # peer-state update coalesces naturally: bits flip as
                        # sends succeed, so the next scan skips them all
                        ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
                    if sent_any:
                        continue
                await asyncio.sleep(GOSSIP_SLEEP)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("gossip votes routine died for %s", peer.id[:10])

    def _pick_commit_vote(self, ps: PeerState, commit):
        theirs = ps._votes_bits(
            commit.height, commit.round, SignedMsgType.PRECOMMIT, len(commit.signatures)
        )
        for idx, cs_sig in enumerate(commit.signatures):
            if cs_sig.absent():
                continue
            if theirs is None or not theirs.get_index(idx):
                return commit.get_vote(idx)
        return None

    async def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        """(reference: consensus/reactor.go:761 queryMaj23Routine)"""
        try:
            while True:
                await asyncio.sleep(QUERY_MAJ23_SLEEP)
                rs = self.cs.rs
                if rs.votes is None or rs.height != ps.height:
                    continue
                for type_, votes in (
                    (SignedMsgType.PREVOTE, rs.votes.prevotes(rs.round)),
                    (SignedMsgType.PRECOMMIT, rs.votes.precommits(rs.round)),
                ):
                    if votes is None:
                        continue
                    maj = votes.two_thirds_majority()
                    if maj is not None:
                        await peer.send(
                            STATE_CHANNEL,
                            encode_message(VoteSetMaj23Message(rs.height, rs.round, type_, maj)),
                        )
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("query maj23 routine died for %s", peer.id[:10])
