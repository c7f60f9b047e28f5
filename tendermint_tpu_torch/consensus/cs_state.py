"""The Tendermint BFT consensus state machine (reference
consensus/state.go:83): the port's copy of tendermint_tpu/consensus/cs_state.py.

One asyncio task (`_receive_loop`, reference receiveRoutine,
consensus/state.go:684) takes every input, peer messages, the node's own
messages, timeouts and tx availability, and is the only writer of
RoundState. Timeouts come from one replaceable timer (reference
consensus/ticker.go). Every input is written to the WAL before it is
handled; the node's own messages are fsynced.

The step functions follow the reference one for one: enterNewRound,
enterPropose, then (proposal and parts complete) enterPrevote,
enterPrevoteWait, enterPrecommit (the locking and POL rules, reference
consensus/state.go:1255), enterPrecommitWait, enterCommit,
tryFinalizeCommit and finalizeCommit (SaveBlock, WAL EndHeight,
ApplyBlock, updateToState, scheduleRound0).

With `config.defer_vote_verification` the votes are queued in their
VoteSets (on `device`) and verified together: after each drain of at most
512 queued messages, once the queue is empty, `_flush_deferred_votes` runs
one VoteSet.flush per (type, round) that gained votes, each one
crypto/batch.verify_batch call (the card from 256 rows when `device` is
None). A failure inside the flush or the loop halts consensus
(halt-don't-corrupt): it is logged, kept in `halt_error`, and the loop
stops; nothing falls back to a host verify. The node (node/node.py) hands
it the consensus metrics (`metrics=`, libs/metrics.ConsensusMetrics), the
timeline ring (`timeline=`, consensus/timeline.py), the SLO engine (`slo=`)
and the tx tracker (`tx_tracker=`: the proposed and committed stages).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, List, Optional

from tendermint_tpu_torch.config import ConsensusConfig
from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
)
from tendermint_tpu_torch.consensus.round_state import HeightVoteSet, RoundState, RoundStepType
from tendermint_tpu_torch.consensus.wal import (
    WAL,
    EndHeightMessage,
    EventRoundState,
    MsgInfo,
    TimeoutInfo,
)
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs.trace import tracer as _tracer
from tendermint_tpu_torch.state.execution import BlockExecutor, BlockValidationError
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.event_bus import (
    EVENT_COMPLETE_PROPOSAL,
    EVENT_LOCK,
    EVENT_NEW_ROUND,
    EVENT_NEW_ROUND_STEP,
    EVENT_POLKA,
    EVENT_TIMEOUT_PROPOSE,
    EVENT_TIMEOUT_WAIT,
    EVENT_VALID_BLOCK,
    EventBus,
)
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import (
    ConflictingVotesError,
    VoteSet,
    VoteSetError,
)

logger = logging.getLogger("tendermint_tpu_torch.consensus")


def commit_to_vote_set(chain_id: str, commit, val_set: ValidatorSet, device=None) -> VoteSet:
    """Rebuild the precommit VoteSet from a seen commit
    (reference: types/vote_set.go CommitToVoteSet). Sign-bytes for the whole
    commit are built in ONE batched pass (canonical.vote_sign_bytes_many)
    and seeded into each vote's memo, so the per-vote serial verify inside
    add_vote never runs the per-row canonical encoder."""
    vote_set = VoteSet(chain_id, commit.height, commit.round, SignedMsgType.PRECOMMIT, val_set,
                       device=device)
    idxs = [i for i, cs_sig in enumerate(commit.signatures) if not cs_sig.absent()]
    msgs = commit.vote_sign_bytes_many(chain_id, idxs)
    for i, msg in zip(idxs, msgs):
        vote = commit.get_vote(i)
        vote.seed_sign_bytes(chain_id, msg)
        vote_set.add_vote(vote)
    return vote_set


class ConsensusState:
    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store,
        tx_notifier,  # mempool (set_txs_available_callback) or None
        evpool,
        wal: WAL,
        event_bus: Optional[EventBus] = None,
        priv_validator=None,
        metrics=None,
        timeline=None,
        slo=None,
        tx_tracker=None,
        device=None,
    ):
        """device: where the deferred vote flushes verify (HeightVoteSet ->
        VoteSet -> verify_batch); None keeps the reference's routing, the
        card from 256 rows. metrics: libs/metrics.ConsensusMetrics;
        timeline: consensus/timeline.ConsensusTimeline; tx_tracker:
        libs/txtrace.TxTracker (the proposed and committed stages)."""
        self.config = config
        self.device = device
        self.metrics = metrics
        # tx lifecycle tracker (libs/txtrace.py): consensus contributes the
        # proposed(height,round) and committed(height,index) stages; gated on
        # the tracer flag like the timeline, muted during replay
        self.tx_tracker = tx_tracker
        # per-height/round timeline ring (consensus/timeline.py); recording
        # is gated on tracer.enabled so a disabled recorder costs the hot
        # path only flag checks
        self.timeline = timeline
        # SLO engine (libs/slo.py): commit-interval and prevote-quorum-delay
        # observations feed it here
        self.slo = slo
        # (height, round, step, perf_counter) of the current step, and
        # (height, round, perf_counter) of the current round: the clocks
        # behind step_duration_seconds / round_duration_seconds
        self._step_clock = None
        self._round_clock = None
        # (height, round) pairs already recorded by the prevote-delay gauges
        self._quorum_prevote_marked = None
        self._full_prevote_marked = None
        # the exception that halted the receive loop, if one did
        self.halt_error: Optional[BaseException] = None
        self.block_exec = block_exec
        self.block_store = block_store
        self.tx_notifier = tx_notifier
        self.evpool = evpool
        self.wal = wal
        self.event_bus = event_bus or EventBus()
        self.priv_validator = priv_validator
        self.priv_validator_pub_key = priv_validator.get_pub_key() if priv_validator else None

        self.rs = RoundState()
        self.state: Optional[State] = None
        self.replay_mode = False
        self.n_steps = 0

        self._queue: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self._timer_task: Optional[asyncio.Task] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        self._running = False
        # hooks for byzantine tests (reference: consensus/state.go:135-137
        # function fields exist exactly for this)
        self.decide_proposal: Callable = self._default_decide_proposal
        self.do_prevote: Callable = self._default_do_prevote

        if state.last_block_height > 0:
            self._reconstruct_last_commit(state)
        self._update_to_state(state)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        self._catchup_replay(self.rs.height)
        if self.tx_notifier is not None:
            loop = asyncio.get_running_loop()
            self.tx_notifier.set_txs_available_callback(
                lambda: loop.call_soon_threadsafe(self._enqueue_nowait, ("txs_available", None))
            )
        self._loop_task = asyncio.create_task(self._receive_loop(), name="cs-receive")
        if self.rs.step == RoundStepType.NEW_HEIGHT:
            self._schedule_round0()
        elif self.rs.step == RoundStepType.COMMIT:
            # Replay re-entered COMMIT. If the block is already complete this
            # finalizes immediately (we are the only mutator until the loop
            # drains); if parts are missing only peer gossip can supply them —
            # no timeout applies (reference: enterCommit waits on gossip).
            self._try_finalize_commit(self.rs.height)
            if self.rs.step == RoundStepType.NEW_HEIGHT:
                self._schedule_round0()
        else:
            # WAL catchup left us mid-height. A NEW_HEIGHT timeout would be
            # dropped by _handle_timeout's step guard, and any timer left over
            # from replay may target an already-passed step — either way the
            # node would stall with no timer. Re-drive liveness by arming the
            # round's precommit-wait timeout: when it fires we precommit
            # (honoring locks) and advance to the next round, where peers/our
            # own proposer turn make progress (reference: consensus/replay.go:93
            # relies on gossip to re-drive; a single-node net has no gossip).
            self._schedule_timeout(
                self.config.precommit_timeout(self.rs.round),
                self.rs.height, self.rs.round, RoundStepType.PRECOMMIT_WAIT,
            )

    async def stop(self) -> None:
        self._running = False
        if self._timer_task:
            self._timer_task.cancel()
        if self._loop_task:
            await self._queue.put(("quit", None))
            try:
                await asyncio.wait_for(self._loop_task, timeout=5)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._loop_task.cancel()
        self.wal.close()

    async def wait_until_stopped(self) -> None:
        await self._stopped.wait()

    # ------------------------------------------------------------------
    # external input
    # ------------------------------------------------------------------

    def _enqueue_nowait(self, item) -> None:
        try:
            self._queue.put_nowait(item)
        except asyncio.QueueFull:
            asyncio.ensure_future(self._queue.put(item))

    async def add_peer_message(self, msg, peer_id: str) -> None:
        await self._queue.put(("peer", MsgInfo(msg, peer_id)))

    async def add_internal_message(self, msg) -> None:
        await self._queue.put(("internal", MsgInfo(msg, "")))

    def send_internal(self, msg) -> None:
        self._enqueue_nowait(("internal", MsgInfo(msg, "")))

    # ------------------------------------------------------------------
    # the receive loop (reference: consensus/state.go:684 receiveRoutine)
    # ------------------------------------------------------------------

    async def _receive_loop(self) -> None:
        defer = self.config.defer_vote_verification
        flush_interval = max(self.config.vote_flush_interval, 0.001)
        try:
            while self._running:
                # asyncio.Queue.get does not yield when items are ready; yield
                # explicitly so timers, RPC, and peers are never starved.
                await asyncio.sleep(0)
                if defer:
                    # Deferred-verification mode: wait at most one flush
                    # interval so queued unverified votes are batch-verified
                    # even when no new input arrives.
                    try:
                        kind, payload = await asyncio.wait_for(
                            self._queue.get(), timeout=flush_interval
                        )
                    except asyncio.TimeoutError:
                        try:
                            self._flush_deferred_votes()
                        except Exception as e:
                            self._halt(e)
                            break
                        continue
                else:
                    kind, payload = await self._queue.get()
                # Greedy drain: take everything already queued and process it
                # in one tight batch — the per-message asyncio round trip
                # (queue await + explicit yield) was ~30-50 us/vote under a
                # vote storm, comparable to the actual bookkeeping. Message
                # ORDER is exactly the queue order, and each message is still
                # WAL-written before it is handled. With wal_group_commit on,
                # peer/timeout frames sit in the WAL's in-process buffer until
                # the drain-end flush below — a hard kill mid-drain can lose
                # up to one drain's worth of PEER frames from the replay log
                # (self-generated messages still fsync inline, so safety is
                # intact; the loss is replay/post-mortem completeness, bounded
                # by the batch size and the WAL's max-latency fsync bound).
                # Bounded so a firehose peer cannot starve timers/RPC for
                # more than one batch.
                batch = [(kind, payload)]
                while len(batch) < 512:
                    try:
                        batch.append(self._queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                quit_seen = False
                try:
                    for kind, payload in batch:
                        if kind == "quit":
                            quit_seen = True
                            break
                        if kind == "peer":
                            self.wal.write(payload)
                            self._handle_msg(payload)
                        elif kind == "internal":
                            self.wal.write_sync(payload)  # fsync self msgs
                            if isinstance(payload.msg, VoteMessage):
                                fail.fail_point("internal_vote_after_wal")
                            self._handle_msg(payload)
                        elif kind == "timeout":
                            self.wal.write(payload)
                            self._handle_timeout(payload)
                        elif kind == "txs_available":
                            self._handle_txs_available()
                    # Batch boundary — the group-commit point: everything the
                    # drain wrote lands as one buffered write, fsynced when
                    # the max-latency bound is due (no-op when
                    # wal_group_commit is off or nothing is pending).
                    if not quit_seen:
                        self.wal.flush_buffered()
                    # Then flush deferred votes in one device batch (storms
                    # accumulate while the queue is busy, then verify
                    # together). Never on quit — a shutdown must not
                    # batch-verify, commit, or publish into components that
                    # are already stopping.
                    if defer and not quit_seen and self._queue.empty():
                        self._flush_deferred_votes()
                except Exception as e:
                    self._halt(e)
                    break
                if quit_seen:
                    break
        finally:
            self._stopped.set()

    def _halt(self, e: BaseException) -> None:
        logger.exception("CONSENSUS FAILURE!!! halting (halt-don't-corrupt)")
        self.halt_error = e

    def _handle_msg(self, mi: MsgInfo) -> None:
        """Per-message errors are logged and tolerated — only genuine invariant
        violations (anything that escapes this method) halt consensus
        (reference: consensus/state.go:766 handleMsg logs errors and continues).
        """
        msg, peer_id = mi.msg, mi.peer_id
        try:
            if isinstance(msg, ProposalMessage):
                msg.proposal.validate_basic()
                self._set_proposal(msg.proposal)
            elif isinstance(msg, BlockPartMessage):
                msg.part.validate_basic()
                self._add_proposal_block_part(msg, peer_id)
            elif isinstance(msg, VoteMessage):
                msg.vote.validate_basic()
                self._try_add_vote(msg.vote, peer_id)
            else:
                logger.error("unknown msg type %s", type(msg))
        except (VoteSetError, ValueError) as e:
            logger.error("error with msg %s from %s: %s", type(msg).__name__, peer_id or "self", e)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < int(rs.step)
        ):
            return
        step = RoundStepType(ti.step)
        if step == RoundStepType.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif step == RoundStepType.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif step == RoundStepType.PROPOSE:
            if self.metrics is not None:
                self.metrics.proposal_timeout_total.inc()
            self._publish_rs(EVENT_TIMEOUT_PROPOSE)
            self._enter_prevote(ti.height, ti.round)
        elif step == RoundStepType.PREVOTE_WAIT:
            self._publish_rs(EVENT_TIMEOUT_WAIT)
            self._enter_precommit(ti.height, ti.round)
        elif step == RoundStepType.PRECOMMIT_WAIT:
            self._publish_rs(EVENT_TIMEOUT_WAIT)
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise RuntimeError(f"invalid timeout step {step}")

    def _handle_txs_available(self) -> None:
        """(reference: consensus/state.go:873 handleTxsAvailable)"""
        rs = self.rs
        if rs.round != 0:
            return
        if rs.step == RoundStepType.NEW_HEIGHT:
            if self._need_proof_block(rs.height):
                return  # enterPropose will be called by enterNewRound
            delay = max(0.0, rs.start_time_ns / 1e9 - time.time()) + 0.001
            self._schedule_timeout(delay, rs.height, 0, RoundStepType.NEW_ROUND)
        elif rs.step == RoundStepType.NEW_ROUND:
            self._enter_propose(rs.height, 0)

    # ------------------------------------------------------------------
    # timeouts
    # ------------------------------------------------------------------

    def _schedule_timeout(self, duration_s: float, height: int, round_: int, step: RoundStepType) -> None:
        """Single replaceable timer (reference: consensus/ticker.go:94)."""
        if self._timer_task is not None:
            self._timer_task.cancel()
        ti = TimeoutInfo(duration_s, height, round_, int(step))

        async def fire():
            try:
                if duration_s > 0:
                    await asyncio.sleep(duration_s)
                await self._queue.put(("timeout", ti))
            except asyncio.CancelledError:
                pass

        self._timer_task = asyncio.create_task(fire(), name="cs-timeout")

    def _schedule_round0(self) -> None:
        delay = max(0.0, self.rs.start_time_ns / 1e9 - time.time())
        self._schedule_timeout(delay, self.rs.height, 0, RoundStepType.NEW_HEIGHT)

    # ------------------------------------------------------------------
    # state update helpers
    # ------------------------------------------------------------------

    def _reconstruct_last_commit(self, state: State) -> None:
        """(reference: consensus/state.go reconstructLastCommit)"""
        seen = self.block_store.load_seen_commit(state.last_block_height)
        if seen is None:
            raise RuntimeError(
                f"failed to reconstruct last commit: seen commit for height {state.last_block_height} not found"
            )
        vote_set = commit_to_vote_set(state.chain_id, seen, state.last_validators,
                                      device=self.device)
        if not vote_set.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit: does not have +2/3 maj")
        self.rs.last_commit = vote_set

    def _update_to_state(self, state: State) -> None:
        """(reference: consensus/state.go:564 updateToState)"""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState() expected state height of {rs.height} but found {state.last_block_height}"
            )
        if self.state is not None and not self.state.is_empty():
            if state.last_block_height <= self.state.last_block_height:
                self._new_step()
                return

        if state.last_block_height == 0:
            rs.last_commit = None
        elif rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise RuntimeError("wanted to form a commit, but precommits didn't have 2/3+")
            rs.last_commit = precommits

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        rs.height = height
        rs.round = 0
        rs.step = RoundStepType.NEW_HEIGHT
        now_ns = time.time_ns()
        if rs.commit_time_ns == 0:
            rs.start_time_ns = now_ns + int(self.config.timeout_commit * 1e9)
        else:
            rs.start_time_ns = rs.commit_time_ns + int(self.config.timeout_commit * 1e9)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(
            state.chain_id, height, state.validators,
            defer_verification=self.config.defer_vote_verification, device=self.device,
        )
        rs.commit_round = -1
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state
        if self.evpool is not None:
            self.evpool.set_state(state)
        self._new_step()

    def _new_step(self) -> None:
        rs = self.rs
        # Only log round-state transitions while actually running: the
        # constructor's updateToState must not append to the WAL (the
        # reference opens the WAL in OnStart, consensus/state.go:303, so
        # construction never writes; this also keeps the replay CLI
        # read-only).
        if self._running:
            self.wal.write(EventRoundState(rs.height, rs.round, int(rs.step)))
        self._mark_step()
        self.n_steps += 1
        self._publish_rs(EVENT_NEW_ROUND_STEP)

    def _tl(self):
        """The timeline iff recording is on: tracing disabled reduces every
        timeline call site to this one flag check."""
        tl = self.timeline
        if tl is None or not _tracer.enabled or self.replay_mode:
            return None
        return tl

    def _track_block_txs(self, stage: str, height: int, round_: int, block) -> None:
        """Stamp a lifecycle stage for every tracked tx of `block`: one flag
        check when tracing is off or no tracker is wired (the hashing inside
        record_block never runs)."""
        tt = self.tx_tracker
        if (
            tt is None or not tt.enabled or self.replay_mode
            or block is None or not block.txs
        ):
            return
        tt.record_block(stage, height, round_, block.txs)

    def _mark_step(self) -> None:
        """Close the previous step's duration and open the new one (the
        reference's metrics.MarkStep, CometBFT consensus/metrics.go
        RecordConsMetrics)."""
        rs = self.rs
        cur = (rs.height, rs.round, rs.step)
        prev = self._step_clock
        if prev is not None and prev[:3] == cur:
            return  # _new_step without a step change (e.g. precommit-wait arm)
        now = time.perf_counter()
        if prev is not None and self.metrics is not None and not self.replay_mode:
            self.metrics.step_duration_seconds.labels(prev[2].name.lower()).observe(
                now - prev[3]
            )
        self._step_clock = (rs.height, rs.round, rs.step, now)
        tl = self._tl()
        if tl is not None:
            tl.record_step(rs.height, rs.round, rs.step.name)
            # a point event in the flight recorder's ring, so a trace
            # interleaves consensus steps with verify spans
            _tracer.event(
                "consensus.step",
                height=rs.height, round=rs.round, step=rs.step.name,
            )

    def _mark_round(self, height: int, round_: int) -> None:
        """Round clock: observe the previous round's duration when the round
        escalates; _finalize_commit observes the committing round."""
        now = time.perf_counter()
        prev = self._round_clock
        if prev is not None and prev[0] == height and prev[1] == round_:
            return
        if (
            prev is not None and self.metrics is not None and not self.replay_mode
            and prev[0] == height and prev[1] < round_
        ):
            self.metrics.round_duration_seconds.observe(now - prev[2])
        self._round_clock = (height, round_, now)

    def _publish_rs(self, event_type: str) -> None:
        if self.event_bus is not None:
            self.event_bus.publish_round_state(
                event_type, self.rs.height, self.rs.round, self.rs.step.name
            )

    def _publish_vote(self, vote: Vote) -> None:
        self.event_bus.publish_vote(vote)

    def _publish_votes(self, votes: List[Vote]) -> None:
        """Batch form used by the deferred-vote drain: one subscriber-match
        pass for the whole batch (EventBus.publish_votes), and — like all
        vote publishes — free when nobody subscribed to Vote events."""
        if votes:
            self.event_bus.publish_votes(votes)

    # ------------------------------------------------------------------
    # step: new round (reference: consensus/state.go:907)
    # ------------------------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStepType.NEW_HEIGHT
        ):
            return
        logger.info("enterNewRound(%s/%s)", height, round_)

        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)

        self._mark_round(height, round_)
        rs.round = round_
        rs.step = RoundStepType.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track next round too
        rs.triggered_timeout_precommit = False
        self._mark_step()  # NEW_ROUND has no _new_step of its own
        if self.metrics is not None and not self.replay_mode:
            self.metrics.rounds.set(round_)
        self._publish_rs(EVENT_NEW_ROUND)

        wait_for_txs = (
            self.config.wait_for_txs() and round_ == 0 and not self._need_proof_block(height)
            and self.tx_notifier is not None and self.tx_notifier.size() == 0
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round_, RoundStepType.NEW_ROUND
                )
        else:
            self._enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        if height == self.state.initial_height:
            return True
        last_meta = self.block_store.load_block_meta(height - 1)
        if last_meta is None:
            return True
        last_block = self.block_store.load_block(height - 1)
        return self.state.app_hash != last_block.header.app_hash

    # ------------------------------------------------------------------
    # step: propose (reference: consensus/state.go:989)
    # ------------------------------------------------------------------

    def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStepType.PROPOSE
        ):
            return
        logger.info("enterPropose(%s/%s)", height, round_)

        try:
            self._schedule_timeout(
                self.config.propose_timeout(round_), height, round_, RoundStepType.PROPOSE
            )
            if self.priv_validator is None or self.priv_validator_pub_key is None:
                return
            address = self.priv_validator_pub_key.address()
            if not rs.validators.has_address(address):
                return
            if rs.validators.get_proposer().address == address:
                logger.info("enterPropose: our turn to propose")
                self.decide_proposal(height, round_)
        finally:
            rs.round = round_
            rs.step = RoundStepType.PROPOSE
            self._new_step()
            if self._is_proposal_complete():
                self._enter_prevote(height, rs.round)

    def _default_decide_proposal(self, height: int, round_: int) -> None:
        """(reference: consensus/state.go:1061 defaultDecideProposal)"""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block, block_parts = self._create_proposal_block()
            if block is None:
                return
        self.wal.flush_and_sync()

        block_id = BlockID(block.hash(), block_parts.header)
        proposal = Proposal(
            height=height, round=round_, pol_round=rs.valid_round,
            block_id=block_id, timestamp_ns=time.time_ns(),
        )
        try:
            proposal = self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:
            if not self.replay_mode:
                logger.error("enterPropose: error signing proposal: %s", e)
            return
        m = self._live_metrics()
        if m is not None:
            m.proposal_create_count.inc()
        self.send_internal(ProposalMessage(proposal))
        for i in range(block_parts.total):
            self.send_internal(BlockPartMessage(height, round_, block_parts.get_part(i)))
        logger.info("signed proposal %s/%s %s", height, round_, block.hash().hex()[:12])

    def _create_proposal_block(self):
        rs = self.rs
        if rs.height == self.state.initial_height:
            commit = Commit(0, 0, BlockID(), ())
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
        else:
            logger.error("propose step; cannot propose anything without commit for the previous block")
            return None, None
        proposer_addr = self.priv_validator_pub_key.address()
        block = self.block_exec.create_proposal_block(
            rs.height, self.state, commit, proposer_addr, time.time_ns()
        )
        parts = PartSet.from_data(block.encode())
        return block, parts

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    # ------------------------------------------------------------------
    # proposal / block part intake
    # ------------------------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """(reference: consensus/state.go defaultSetProposal :1692)"""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (proposal.pol_round >= 0 and proposal.pol_round >= proposal.round):
            m = self._live_metrics()
            if m is not None:
                m.proposal_receive_count.labels("rejected").inc()
            raise VoteSetError("error invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            m = self._live_metrics()
            if m is not None:
                m.proposal_receive_count.labels("rejected").inc()
            raise VoteSetError("error invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)
        m = self._live_metrics()
        if m is not None:
            m.proposal_receive_count.labels("accepted").inc()
        tl = self._tl()
        if tl is not None:
            tl.record_proposal(proposal.height, proposal.round)
        logger.info("received proposal %s", proposal.height)

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> None:
        """(reference: consensus/state.go:1751 addProposalBlockPart)"""
        rs = self.rs
        if msg.height != rs.height:
            return
        if rs.proposal_block_parts is None:
            return
        try:
            added = rs.proposal_block_parts.add_part(msg.part)
        except ValueError as e:
            if msg.round != rs.round:
                return
            raise
        if not added:
            return
        if rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            rs.proposal_block = Block.decode(data)
            logger.info("received complete proposal block %s %s", rs.proposal_block.header.height,
                        rs.proposal_block.hash().hex()[:12])
            # tx lifecycle: every tracked tx of the now-complete proposal is
            # `proposed` (our own proposals land here too: their parts ride
            # internal BlockPartMessages through this same path)
            self._track_block_txs("proposed", rs.height, rs.round, rs.proposal_block)
            self._publish_rs(EVENT_COMPLETE_PROPOSAL)

            prevotes = rs.votes.prevotes(rs.round)
            block_id = prevotes.two_thirds_majority() if prevotes else None
            if block_id is not None and not block_id.is_zero() and rs.valid_round < rs.round:
                if rs.proposal_block.hash() == block_id.hash:
                    rs.valid_round = rs.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts

            if rs.step <= RoundStepType.PROPOSE and self._is_proposal_complete():
                self._enter_prevote(rs.height, rs.round)
            elif rs.step == RoundStepType.COMMIT:
                self._try_finalize_commit(rs.height)

    # ------------------------------------------------------------------
    # step: prevote (reference: consensus/state.go:1160)
    # ------------------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStepType.PREVOTE
        ):
            return
        logger.info("enterPrevote(%s/%s)", height, round_)
        self.do_prevote(height, round_)
        rs.round = round_
        rs.step = RoundStepType.PREVOTE
        self._new_step()

    def _default_do_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(SignedMsgType.PREVOTE, rs.locked_block.hash(), rs.locked_block_parts.header)
            return
        if rs.proposal_block is None:
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except (BlockValidationError, Exception) as e:
            logger.error("enterPrevote: ProposalBlock is invalid: %s", e)
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        self._sign_add_vote(
            SignedMsgType.PREVOTE, rs.proposal_block.hash(), rs.proposal_block_parts.header
        )

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStepType.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError(f"enterPrevoteWait({height}/{round_}) without +2/3 prevotes")
        rs.round = round_
        rs.step = RoundStepType.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(
            self.config.prevote_timeout(round_), height, round_, RoundStepType.PREVOTE_WAIT
        )

    # ------------------------------------------------------------------
    # step: precommit — the locking rules (reference: consensus/state.go:1255)
    # ------------------------------------------------------------------

    def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStepType.PRECOMMIT
        ):
            return
        logger.info("enterPrecommit(%s/%s)", height, round_)

        try:
            prevotes = rs.votes.prevotes(round_)
            block_id = prevotes.two_thirds_majority() if prevotes else None

            # No polka: precommit nil.
            if block_id is None:
                self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
                return

            self._publish_rs(EVENT_POLKA)
            pol_round, _ = rs.votes.pol_info()
            if pol_round < round_:
                raise RuntimeError(f"POLRound should be {round_} but got {pol_round}")

            # +2/3 prevoted nil: unlock and precommit nil.
            if block_id.is_zero():
                if rs.locked_block is not None:
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
                return

            # Already locked on that block: relock.
            if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                rs.locked_round = round_
                self._publish_rs(EVENT_LOCK)
                self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash, block_id.part_set_header)
                return

            # Polka for our proposal block: lock it.
            if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                self.block_exec.validate_block(self.state, rs.proposal_block)  # panics if invalid
                rs.locked_round = round_
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                self._publish_rs(EVENT_LOCK)
                self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash, block_id.part_set_header)
                return

            # Polka for a block we don't have: unlock, fetch, precommit nil.
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.part_set_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
        finally:
            rs.round = round_
            rs.step = RoundStepType.PRECOMMIT
            self._new_step()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError(f"enterPrecommitWait({height}/{round_}) without +2/3 precommits")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit_timeout(round_), height, round_, RoundStepType.PRECOMMIT_WAIT
        )

    # ------------------------------------------------------------------
    # step: commit (reference: consensus/state.go:1394)
    # ------------------------------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= RoundStepType.COMMIT:
            return
        logger.info("enterCommit(%s/%s)", height, commit_round)
        try:
            precommits = rs.votes.precommits(commit_round)
            block_id = precommits.two_thirds_majority()
            if block_id is None:
                raise RuntimeError("enterCommit expects +2/3 precommits")
            if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts
            if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    block_id.part_set_header
                ):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(block_id.part_set_header)
                    self._publish_rs(EVENT_VALID_BLOCK)
        finally:
            rs.step = RoundStepType.COMMIT
            rs.commit_round = commit_round
            rs.commit_time_ns = time.time_ns()
            self._new_step()
            self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            raise RuntimeError("tryFinalizeCommit() height mismatch")
        precommits = rs.votes.precommits(rs.commit_round)
        block_id = precommits.two_thirds_majority() if precommits else None
        if block_id is None or block_id.is_zero():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return  # don't have the block yet; keep waiting
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """(reference: consensus/state.go:1489 finalizeCommit)"""
        rs = self.rs
        if rs.height != height or rs.step != RoundStepType.COMMIT:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        block_id = precommits.two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if block_id is None:
            raise RuntimeError("cannot finalize commit: no 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise RuntimeError("expected ProposalBlockParts header to be commit header")
        if block.hash() != block_id.hash:
            raise RuntimeError("cannot finalize commit: proposal block does not hash to commit hash")
        _tv0 = time.perf_counter()
        self.block_exec.validate_block(self.state, block)
        _tv1 = time.perf_counter()
        if _tracer.enabled:
            _tracer.event(
                "consensus.commit_verify",
                height=height,
                n_sigs=len(block.last_commit.signatures),
                dur_ms=round((_tv1 - _tv0) * 1e3, 3),
            )

        logger.info("finalizing commit of block %d txs=%d hash=%s",
                    block.header.height, len(block.txs), block.hash().hex()[:12])
        tl = self._tl()
        if tl is not None:
            tl.record_commit(height, rs.commit_round, txs=len(block.txs))
        self._track_block_txs("committed", height, rs.commit_round, block)
        if self.metrics is not None:
            m = self.metrics
            if (
                not self.replay_mode
                and self._round_clock is not None
                and self._round_clock[:2] == (height, rs.commit_round)
            ):
                # replay re-runs commits at replay speed, and a commit of an
                # EARLIER round after escalation (late precommits) belongs
                # to a round the clock no longer tracks: both would record
                # bogus near-zero samples in the low buckets
                m.round_duration_seconds.observe(
                    time.perf_counter() - self._round_clock[2]
                )
            m.commit_verify_seconds.observe(_tv1 - _tv0)
            m.num_txs.set(len(block.txs))
            m.total_txs.inc(len(block.txs))
            m.block_size_bytes.set(block_parts.byte_size)
            m.rounds.set(rs.round)
            vals = rs.validators
            m.validators.set(vals.size())
            m.validators_power.set(vals.total_voting_power())
            missing = sum(1 for cs_ in block.last_commit.signatures if not cs_.for_block())
            m.missing_validators.set(missing)
            m.byzantine_validators.set(len(block.evidence))
            if self.state.last_block_height > 0:
                m.block_interval_seconds.observe(
                    max(0.0, (block.header.time_ns - self.state.last_block_time_ns) / 1e9)
                )
        if (
            self.slo is not None and not self.replay_mode
            and self.state.last_block_height > 0
        ):
            self.slo.observe(
                "commit_interval",
                max(0.0, (block.header.time_ns - self.state.last_block_time_ns) / 1e9),
            )
        fail.fail_point("cs_before_save_block")
        if self.block_store.height < block.header.height:
            seen_commit = precommits.make_commit()
            self.block_store.save_block(block, block_parts, seen_commit)
        fail.fail_point("cs_after_save_block")

        # EndHeight marker: blockstore has the block; recovery runs ApplyBlock
        # via handshake if we crash after this point.
        self.wal.write_end_height(height)
        if tl is not None:
            tl.record_end_height(height)
        fail.fail_point("cs_after_wal_endheight")

        state_copy = self.state.copy()
        new_state = self.block_exec.apply_block(
            state_copy, BlockID(block.hash(), block_parts.header), block
        )
        fail.fail_point("cs_after_apply_block")

        self._update_to_state(new_state)
        if self.metrics is not None:
            self.metrics.height.set(new_state.last_block_height)
        if self.priv_validator is not None:
            self.priv_validator_pub_key = self.priv_validator.get_pub_key()
        self._schedule_round0()

    # ------------------------------------------------------------------
    # votes
    # ------------------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """(reference: consensus/state.go:1829 tryAddVote + :1880 addVote)"""
        try:
            return self._add_vote(vote, peer_id)
        except ConflictingVotesError as e:
            self._handle_vote_conflict(e)
            return False
        except VoteSetError as e:
            logger.debug("vote not added: %s", e)
            return False

    def _handle_vote_conflict(self, e: ConflictingVotesError) -> None:
        """Turn an equivocation into DuplicateVoteEvidence (also called by the
        deferred-verification flush, which surfaces conflicts in batches;
        reference: consensus/state.go:1829 tryAddVote's ErrVoteConflictingVotes
        branch)."""
        vote = e.vote_b
        if self.priv_validator_pub_key is not None and (
            vote.validator_address == self.priv_validator_pub_key.address()
        ):
            logger.error("found conflicting vote from ourselves; did you unsafe_reset a validator?")
            return
        if self.evpool is not None:
            _, val = self.rs.validators.get_by_address(vote.validator_address)
            ev = DuplicateVoteEvidence.from_votes(
                e.vote_a, e.vote_b, self.state.last_block_time_ns,
                self.rs.validators.total_voting_power(),
                val.voting_power if val else 0,
            )
            fail.fail_point("cs_evidence_from_consensus")
            try:
                self.evpool.add_evidence_from_consensus(
                    ev, time.time_ns(), self.rs.validators
                )
            except Exception as err:
                # The pool verifies before accepting (evidence/pool.py); a
                # rejected add means the evidence would never survive peer
                # validation anyway — log loudly, keep consensus running.
                logger.error(
                    "evidence pool rejected consensus-discovered equivocation "
                    "by %s at %d/%d: %s",
                    vote.validator_address.hex()[:12], vote.height, vote.round, err,
                )

    def _flush_deferred_votes(self) -> None:
        """Deferred-verification tick: batch-verify all queued votes in one
        device call, surface equivocations as evidence, and re-run the 2/3
        progress checks for every (type, round) that gained votes.

        This is the consensus-side half of config.defer_vote_verification —
        under a vote storm each flush is ONE batched kernel invocation over
        the validator axis instead of per-vote scalar verifies (the
        vectorized analog of the reference's per-vote path,
        types/vote_set.go:143,203).

        Rows that verify OK here also land in the cross-flush verified-row
        memo (crypto/batch.VerifiedRowMemo): when this height commits, the
        seen-commit's verify_commit re-presents the same (pubkey, msg, sig)
        tuples and resolves them from the memo instead of re-flushing, so
        the commit path only pays device time for signatures that were never
        deferred-verified in the first place."""
        rs = self.rs
        if rs.votes is not None and rs.votes.has_pending():
            tr = _tracer if _tracer.enabled else None
            span = None
            if tr is not None:
                span = tr.span("consensus.vote_flush", height=rs.height)
                span.__enter__()
            try:
                height_before = rs.height
                votes_before = rs.votes
                flushed = votes_before.flush_all()
                for err in votes_before.drain_conflicts():
                    self._handle_vote_conflict(err)
                if span is not None:
                    span.set(
                        committed=sum(len(c) for _, _, c, _ in flushed),
                        failed=sum(len(f) for _, _, _, f in flushed),
                    )
            finally:
                # always close: a raise between enter and here would corrupt
                # the tracer's thread-local span stack for the whole loop —
                # and pass the live exception so the span records error=...
                if span is not None:
                    import sys as _sys

                    span.__exit__(*_sys.exc_info())
            for vtype, vround, committed, failed in flushed:
                # Publish only now: enqueue time would advertise (HasVote)
                # signatures we have not verified, letting a forged vote
                # suppress gossip of the genuine one.
                self._publish_votes(committed)
                if failed:
                    logger.warning(
                        "deferred flush: %d invalid %s signatures at round %d",
                        len(failed), vtype.name, vround,
                    )
                # A progress check can COMMIT the block and advance the
                # height, replacing rs.votes with a fresh HeightVoteSet; the
                # remaining (type, round) pairs belong to the finished height
                # and must not be re-checked against the new one.
                if rs.height != height_before:
                    break
                self._check_progress_after_vote(vtype, vround)
        if rs.last_commit is not None and rs.last_commit.pending_count() > 0:
            committed, _failed = rs.last_commit.flush()
            self._publish_votes(committed)
            for err in rs.last_commit.pop_conflicts():
                self._handle_vote_conflict(err)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        rs = self.rs
        # Late precommit for the previous height (during commit timeout).
        if vote.height + 1 == rs.height and vote.type == SignedMsgType.PRECOMMIT:
            if rs.step != RoundStepType.NEW_HEIGHT:
                m = self._live_metrics()
                if m is not None:
                    m.late_votes.labels(vote.type.name.lower()).inc()
                return False
            if rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if not added:
                m = self._live_metrics()
                if m is not None:
                    m.duplicate_votes.inc()
                return False
            if added != "pending":  # unverified: published at flush instead
                self._publish_vote(vote)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return True

        if vote.height != rs.height:
            m = self._live_metrics()
            if vote.height < rs.height and m is not None:
                m.late_votes.labels(vote.type.name.lower()).inc()
            return False

        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            # VoteSet.add_vote returns falsy ONLY for exact duplicates
            # (same validator, block, signature) — everything else raises
            m = self._live_metrics()
            if m is not None:
                m.duplicate_votes.inc()
            return False
        tl = self._tl()
        if tl is not None:
            tl.record_vote(vote.height, vote.round, vote.type.name)
        if added == "pending":
            # Deferred verification: the vote is queued, not verified — do
            # NOT publish (the reactor would broadcast HasVote and peers
            # would stop gossiping the genuine vote). flush publishes the
            # ones that verify.
            return True
        self._publish_vote(vote)
        self._check_progress_after_vote(vote.type, vote.round)
        return True

    def _check_progress_after_vote(self, vtype: SignedMsgType, vround: int) -> None:
        """Run the 2/3-majority state transitions for one (type, round).

        Factored out of _add_vote so the deferred-verification flush can
        re-run the checks after a batch of votes commits at once
        (reference: consensus/state.go:1880 addVote's post-add logic)."""
        rs = self.rs
        height = rs.height
        # Rounds beyond the tracked window (set_round tracks round..round+1)
        # have no vote set; nothing to check.
        if rs.votes is None or rs.votes._get_vote_set(vround, vtype) is None:
            return
        if vtype == SignedMsgType.PREVOTE:
            prevotes = rs.votes.prevotes(vround)
            block_id = prevotes.two_thirds_majority()
            self._mark_prevote_delays(prevotes, vround, block_id)
            if block_id is not None:
                # Unlock on newer polka for a different block.
                if (
                    rs.locked_block is not None
                    and rs.locked_round < vround <= rs.round
                    and rs.locked_block.hash() != block_id.hash
                ):
                    logger.info("unlocking because of POL")
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                # Update valid block.
                if not block_id.is_zero() and rs.valid_round < vround == rs.round:
                    if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                        rs.valid_round = vround
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.part_set_header
                    ):
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
                    self._publish_rs(EVENT_VALID_BLOCK)

            if rs.round < vround and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vround)
            elif rs.round == vround and rs.step >= RoundStepType.PREVOTE:
                block_id = prevotes.two_thirds_majority()
                if block_id is not None and (self._is_proposal_complete() or block_id.is_zero()):
                    self._enter_precommit(height, vround)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vround)
            elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vround:
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)

        elif vtype == SignedMsgType.PRECOMMIT:
            precommits = rs.votes.precommits(vround)
            block_id = precommits.two_thirds_majority()
            if block_id is not None:
                self._enter_new_round(height, vround)
                self._enter_precommit(height, vround)
                if not block_id.is_zero():
                    self._enter_commit(height, vround)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        self._enter_new_round(rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vround)
            elif rs.round <= vround and precommits.has_two_thirds_any():
                self._enter_new_round(height, vround)
                self._enter_precommit_wait(height, vround)

    def _live_metrics(self):
        """Metrics sink, muted during WAL replay: catch-up re-processes old
        messages at replay speed and must not re-count them."""
        return None if self.replay_mode else self.metrics

    def _mark_prevote_delays(self, prevotes, vround: int, block_id) -> None:
        """quorum_prevote_delay / full_prevote_delay: seconds from the
        proposal's signed timestamp to 2/3 (resp. all) prevote arrival
        (reference: CometBFT consensus/state.go addVote's
        QuorumPrevoteDelay/FullPrevoteDelay gauges). Recorded once per
        (height, round) so trailing prevotes don't inflate the value."""
        rs = self.rs
        if (
            (self.metrics is None and self.slo is None) or self.replay_mode
            or rs.proposal is None or rs.proposal.round != vround
        ):
            return
        delay = max(0.0, (time.time_ns() - rs.proposal.timestamp_ns) / 1e9)
        key = (rs.height, vround)
        if block_id is not None and self._quorum_prevote_marked != key:
            self._quorum_prevote_marked = key
            if self.metrics is not None:
                self.metrics.quorum_prevote_delay.set(delay)
            if self.slo is not None:
                self.slo.observe("prevote_quorum_delay", delay)
        if prevotes.has_all() and self._full_prevote_marked != key:
            self._full_prevote_marked = key
            if self.metrics is not None:
                self.metrics.full_prevote_delay.set(delay)

    def _sign_vote(self, msg_type: SignedMsgType, block_hash: bytes, psh: PartSetHeader) -> Optional[Vote]:
        rs = self.rs
        if self.priv_validator_pub_key is None:
            return None
        addr = self.priv_validator_pub_key.address()
        idx, _ = rs.validators.get_by_address(addr)
        if idx < 0:
            return None
        vote = Vote(
            type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(block_hash, psh),
            timestamp_ns=self._vote_time(),
            validator_address=addr,
            validator_index=idx,
        )
        try:
            return self.priv_validator.sign_vote(self.state.chain_id, vote)
        except Exception as e:
            if not self.replay_mode:
                logger.error("failed signing vote: %s", e)
            return None

    def _vote_time(self) -> int:
        """Monotonic vote time: max(now, last block time + 1ms)
        (reference: consensus/state.go voteTime)."""
        now = time.time_ns()
        min_time = self.state.last_block_time_ns + 1_000_000
        return max(now, min_time)

    def _sign_add_vote(self, msg_type: SignedMsgType, block_hash: bytes, psh: PartSetHeader) -> Optional[Vote]:
        if self.priv_validator is None or self.replay_mode:
            return None
        if not self.rs.validators.has_address(self.priv_validator_pub_key.address()):
            return None
        vote = self._sign_vote(msg_type, block_hash, psh)
        if vote is not None:
            self.send_internal(VoteMessage(vote))
        return vote

    # ------------------------------------------------------------------
    # WAL catchup replay (reference: consensus/replay.go:93 catchupReplay)
    # ------------------------------------------------------------------

    def _catchup_replay(self, cs_height: int) -> None:
        if self.wal.search_for_end_height(cs_height) is not None:
            raise RuntimeError(f"WAL should not contain #ENDHEIGHT {cs_height}")
        msgs = self.wal.search_for_end_height(cs_height - 1)
        if msgs is None:
            return  # nothing to replay
        self.replay_mode = True
        try:
            for msg in msgs:
                if isinstance(msg, MsgInfo):
                    # Read-only replay: the messages are already durable in
                    # the WAL (reference: consensus/replay.go:93 catchupReplay
                    # only reads; re-writing would grow the WAL every restart).
                    try:
                        self._handle_msg(msg)
                    except Exception as e:
                        logger.error("replay: msg failed: %s", e)
                elif isinstance(msg, TimeoutInfo):
                    pass  # timeouts are rescheduled naturally
                elif isinstance(msg, EventRoundState):
                    pass
        finally:
            self.replay_mode = False
        logger.info("replayed WAL messages for height %d", cs_height)
