"""RoundState, RoundStepType and HeightVoteSet (reference
consensus/types/round_state.go:16-67, height_vote_set.go:41): the port's
copy of tendermint_tpu/consensus/round_state.py. HeightVoteSet hands its
`device` to every VoteSet it makes, so a deferred flush verifies where
consensus asked (None: the reference's routing, the card from 256 rows).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet


class RoundStepType(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


class HeightVoteSet:
    """All rounds' prevotes+precommits for one height; tracks peer-claimed
    majorities to spawn catch-up vote sets
    (reference: consensus/types/height_vote_set.go:41,117,185)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 defer_verification: bool = False, device=None):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.defer_verification = defer_verification
        self.device = device
        self._round_vote_sets: Dict[int, Tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: Dict[str, List[int]] = {}
        self.round = 0
        self.set_round(0)

    def set_round(self, round_: int) -> None:
        """Track round and round+1 (to allow round-skipping)."""
        for r in range(self.round, round_ + 2):
            if r not in self._round_vote_sets:
                self._add_round(r)
        self.round = round_

    def _add_round(self, round_: int) -> None:
        prevotes = VoteSet(
            self.chain_id, self.height, round_, SignedMsgType.PREVOTE, self.val_set,
            defer_verification=self.defer_verification, device=self.device,
        )
        precommits = VoteSet(
            self.chain_id, self.height, round_, SignedMsgType.PRECOMMIT, self.val_set,
            defer_verification=self.defer_verification, device=self.device,
        )
        self._round_vote_sets[round_] = (prevotes, precommits)

    def _get_vote_set(self, round_: int, type_: SignedMsgType) -> Optional[VoteSet]:
        entry = self._round_vote_sets.get(round_)
        if entry is None:
            return None
        return entry[0] if type_ == SignedMsgType.PREVOTE else entry[1]

    def has_pending(self) -> bool:
        """True if any round's vote set has deferred (unverified) votes."""
        return any(
            vs.pending_count() > 0
            for pair in self._round_vote_sets.values()
            for vs in pair
        )

    def flush_all(self):
        """Flush every round vote set with deferred votes in one pass.

        Returns [(type, round, committed_votes, failed_indices)] for each
        set that had pending votes — the caller publishes the committed
        votes (they were NOT published at enqueue time), re-runs the 2/3
        progress checks for those (type, round) pairs, and drains conflicts
        via drain_conflicts().
        """
        out = []
        for round_, (prevotes, precommits) in sorted(self._round_vote_sets.items()):
            for vs in (prevotes, precommits):
                if vs.pending_count() > 0:
                    committed, failed = vs.flush()
                    out.append((vs.signed_msg_type, round_, committed, failed))
        return out

    def drain_conflicts(self):
        """Collect equivocation conflicts discovered by deferred flushes."""
        out = []
        for prevotes, precommits in self._round_vote_sets.values():
            out.extend(prevotes.pop_conflicts())
            out.extend(precommits.pop_conflicts())
        return out

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, SignedMsgType.PREVOTE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, SignedMsgType.PRECOMMIT)

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """(reference: height_vote_set.go:117 AddVote)"""
        if vote.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError(f"unexpected vote type {vote.type}")
        vote_set = self._get_vote_set(vote.round, vote.type)
        if vote_set is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vote_set = self._get_vote_set(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise ValueError("peer has sent a vote that does not match our round for more than one round")
        return vote_set.add_vote(vote, peer_id)

    def pol_info(self) -> Tuple[int, Optional[BlockID]]:
        """Highest round with a prevote 2/3 majority (reference:
        height_vote_set.go POLInfo)."""
        # Only rounds <= self.round: a majority recorded in a peer-catchup
        # round above ours must not be reported as the POL (reference:
        # height_vote_set.go POLInfo scans hvs.round down to 0).
        for r in sorted((r for r in self._round_vote_sets if r <= self.round), reverse=True):
            vs = self.prevotes(r)
            if vs is not None:
                bid = vs.two_thirds_majority()
                if bid is not None:
                    return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, type_: SignedMsgType, peer_id: str, block_id: BlockID) -> None:
        if round_ not in self._round_vote_sets:
            self._add_round(round_)
        vs = self._get_vote_set(round_, type_)
        vs.set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """(reference: consensus/types/round_state.go:67)"""

    height: int = 0
    round: int = 0
    step: RoundStepType = RoundStepType.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    def round_state_summary(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "step": self.step.name,
            "proposal": self.proposal is not None,
            "proposal_block": self.proposal_block.hash().hex() if self.proposal_block else None,
            "locked_round": self.locked_round,
            "locked_block": self.locked_block.hash().hex() if self.locked_block else None,
            "valid_round": self.valid_round,
        }
