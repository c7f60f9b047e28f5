"""VoteSet: the votes of one (height, round, type).

The port's copy of tendermint_tpu/types/vote_set.py (reference
types/vote_set.go): one canonical vote per validator, the power for each
block, +2/3 detection, conflicts (the material of DuplicateVoteEvidence) and
the blocks peers claim have +2/3. `_add_verified` follows the reference's
addVerifiedVote (types/vote_set.go:229-290): a conflicting vote is still
counted under its block when a peer claims that block, and the canonical
vote is replaced when the conflict is for the +2/3 block.

Signatures are verified as a vote arrives, on the host, or, with
`defer_verification=True`, queued: `flush()` builds every queued vote's
sign bytes in one pass and verifies them in ONE crypto.batch.verify_batch
call with each row's key type (on the card from 256 rows), then commits the
votes that verified through `_add_verified`, queuing the conflicts it finds
for `pop_conflicts()`. Each row is tagged with its provenance,
`peer:<id>` or `lane:votes` (crypto/provenance.py); with a default
scheduler installed (crypto/scheduler.py) the flush rides its votes lane,
on the scheduler's device, as the reference's does
(types/vote_set.py:226-264).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from tendermint_tpu_torch.crypto.batch import verify_batch
from tendermint_tpu_torch.libs import hotstats
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, SignedMsgType
from tendermint_tpu_torch.types.vote import Vote


class VoteSetError(Exception):
    pass


class ConflictingVotesError(VoteSetError):
    def __init__(self, vote_a: Vote, vote_b: Vote):
        super().__init__("conflicting votes from validator")
        self.vote_a = vote_a  # the vote held
        self.vote_b = vote_b  # the new one


@dataclass
class _BlockVotes:
    peer_maj23: bool
    votes: List[Optional[Vote]]
    sum: int = 0

    def add_verified(self, idx: int, vote: Vote, power: int) -> None:
        if self.votes[idx] is None:
            self.votes[idx] = vote
            self.sum += power


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: SignedMsgType, val_set, defer_verification: bool = False,
                 device=None, backend: Optional[str] = None):
        """device, backend: passed to verify_batch by flush() when no default
        scheduler is installed (the scheduler's own apply otherwise)."""
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.defer_verification = defer_verification
        self.device = device
        self.backend = backend
        n = val_set.size()
        self._votes: List[Optional[Vote]] = [None] * n
        self._votes_bit_array: List[bool] = [False] * n
        self._sum = 0
        self._maj23: Optional[BlockID] = None
        self._votes_by_block: Dict[bytes, _BlockVotes] = {}
        self._peer_maj23s: Dict[str, BlockID] = {}
        # the deferred queue: (idx, vote, validator, peer id), and its
        # (idx, block key, signature) set
        self._pending: List[tuple] = []
        self._pending_seen: Set[Tuple[int, bytes, bytes]] = set()
        self._conflicts: List[ConflictingVotesError] = []

    # -- queries ---------------------------------------------------------------

    def size(self) -> int:
        return self.val_set.size()

    def bit_array(self) -> List[bool]:
        return list(self._votes_bit_array)

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[List[bool]]:
        bv = self._votes_by_block.get(block_id.key())
        return None if bv is None else [v is not None for v in bv.votes]

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self._votes[idx]

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        idx, _ = self.val_set.get_by_address(address)
        return self._votes[idx] if idx >= 0 else None

    def list_votes(self) -> List[Vote]:
        return [v for v in self._votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self._maj23 is not None

    def two_thirds_majority(self) -> Optional[BlockID]:
        return self._maj23

    def has_two_thirds_any(self) -> bool:
        return self._sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self._sum == self.val_set.total_voting_power()

    def sum_power(self) -> int:
        return self._sum

    def pop_conflicts(self) -> List[ConflictingVotesError]:
        out, self._conflicts = self._conflicts, []
        return out

    def pending_count(self) -> int:
        """Votes accepted and queued, not yet verified by flush()."""
        return len(self._pending)

    # -- adding votes ----------------------------------------------------------

    def _get_vote(self, idx: int, block_key: bytes) -> Optional[Vote]:
        """The vote held for validator idx under this block, canonical or
        tracked with a conflict (reference getVote)."""
        existing = self._votes[idx]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self._votes_by_block.get(block_key)
        return None if bv is None else bv.votes[idx]

    def add_vote(self, vote: Vote, peer_id: str = ""):
        """True when the vote was verified and added, "pending" when it was
        queued for flush() (not verified yet: not to be gossiped before the
        flush adds it), False for a duplicate. Raises VoteSetError for an
        invalid vote and ConflictingVotesError for an equivocation
        (reference types/vote_set.go:143-290). peer_id: the peer the vote
        came from, each deferred row's provenance ("peer:<id>"; "" is a local
        or replayed vote, "lane:votes")."""
        if vote is None:
            raise VoteSetError("nil vote")
        idx = vote.validator_index
        if idx < 0:
            raise VoteSetError("index < 0")
        if not vote.signature:
            raise VoteSetError("no signature")
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.signed_msg_type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, got "
                f"{vote.height}/{vote.round}/{vote.type}")
        addr, val = self.val_set.get_by_index(idx)
        if val is None:
            raise VoteSetError(f"cannot find validator {idx} in valSet of size {self.size()}")
        if addr != vote.validator_address:
            raise VoteSetError("validator address does not match index")
        block_key = vote.block_id.key()
        existing = self._get_vote(idx, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False
            raise VoteSetError("non-deterministic signature for the same block")
        if self.defer_verification:
            seen_key = (idx, block_key, vote.signature)
            if seen_key in self._pending_seen:
                return False
            self._pending_seen.add(seen_key)
            self._pending.append((idx, vote, val, peer_id))
            return "pending"
        if not self._verify_now(vote, val.pub_key):
            raise VoteSetError(f"invalid signature from validator {idx}")
        added, conflicting = self._add_verified(idx, vote, val.voting_power, block_key)
        if conflicting is not None:
            raise ConflictingVotesError(conflicting, vote)
        return added

    def _verify_now(self, vote: Vote, pub_key) -> bool:
        hs = hotstats.stats if hotstats.stats.enabled else None
        if hs is None:
            return pub_key.verify(vote.sign_bytes(self.chain_id), vote.signature)
        msg = vote.sign_bytes(self.chain_id)  # counted under "encode" by the memo
        t0 = hotstats.perf_counter()
        ok = pub_key.verify(msg, vote.signature)
        hs.add("verify", hotstats.perf_counter() - t0)
        return ok

    def flush(self) -> Tuple[List[Vote], List[int]]:
        """Verify every queued vote in one flush (the default scheduler's votes
        lane, or verify_batch) and add those that verified, in queue order,
        through the same path as add_vote.
        Returns (the votes added, now safe to gossip; the validator indices
        of the votes that failed); the conflicts found wait in
        pop_conflicts(). A failure of the flush raises and leaves the queue
        as it was."""
        if not self._pending:
            return [], []
        from tendermint_tpu_torch.crypto import scheduler as _scheduler

        pubkeys = [val.pub_key.bytes() for _, _, val, _ in self._pending]
        sigs = [vote.signature for _, vote, _, _ in self._pending]
        key_types = [val.pub_key.type_name() for _, _, val, _ in self._pending]
        sources = [f"peer:{peer}" if peer else "lane:votes" for *_, peer in self._pending]
        msgs = canonical.vote_sign_bytes_many(
            self.chain_id, self.signed_msg_type, self.height, self.round,
            ((vote.block_id, vote.timestamp_ns) for _, vote, _, _ in self._pending))
        hs = hotstats.stats if hotstats.stats.enabled else None
        if hs is not None:
            t0 = hotstats.perf_counter()
        sched = _scheduler.default_scheduler()
        if sched is not None:
            mask = sched.verify_rows("votes", pubkeys, msgs, sigs, key_types, sources)
        else:
            mask = verify_batch(pubkeys, msgs, sigs, device=self.device, key_types=key_types,
                                backend=self.backend, sources=sources)
        if hs is not None:
            hs.add("verify", hotstats.perf_counter() - t0, n=len(pubkeys))
        committed, failed = [], []
        for ok, (idx, vote, val, _) in zip(mask, self._pending):
            if not ok:
                failed.append(idx)
                continue
            block_key = vote.block_id.key()
            if self._get_vote(idx, block_key) is not None:  # an earlier queued vote added it
                continue
            added, conflicting = self._add_verified(idx, vote, val.voting_power, block_key)
            if added:
                committed.append(vote)
            if conflicting is not None:
                self._conflicts.append(ConflictingVotesError(conflicting, vote))
        self._pending.clear()
        self._pending_seen.clear()
        return committed, failed

    def _add_verified(self, idx: int, vote: Vote, power: int,
                      block_key: Optional[bytes] = None) -> Tuple[bool, Optional[Vote]]:
        """The reference's addVerifiedVote (types/vote_set.go:229-290), for a
        vote whose signature verified: (added, the conflicting vote held)."""
        if block_key is None:
            block_key = vote.block_id.key()
        conflicting: Optional[Vote] = None
        existing = self._votes[idx]
        if existing is not None:
            conflicting = existing
            # the canonical vote is replaced by one for the +2/3 block; the sum stays
            if self._maj23 is not None and self._maj23.key() == block_key:
                self._votes[idx] = vote
                self._votes_bit_array[idx] = True
        else:
            self._votes[idx] = vote
            self._votes_bit_array[idx] = True
            self._sum += power
        bv = self._votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            bv = _BlockVotes(peer_maj23=False, votes=[None] * self.size())
            self._votes_by_block[block_key] = bv
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        orig_sum = bv.sum
        bv.add_verified(idx, vote, power)
        if orig_sum < quorum <= bv.sum and self._maj23 is None:
            self._maj23 = vote.block_id
            for i, bvote in enumerate(bv.votes):  # the block's votes become canonical
                if bvote is not None:
                    self._votes[i] = bvote
                    self._votes_bit_array[i] = True
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer's claim that a block has +2/3 (reference
        types/vote_set.go:291-330)."""
        existing = self._peer_maj23s.get(peer_id)
        if existing is not None and existing != block_id:
            raise VoteSetError(f"setPeerMaj23: conflicting blockID from peer {peer_id}")
        self._peer_maj23s[peer_id] = block_id
        key = block_id.key()
        bv = self._votes_by_block.get(key)
        if bv is None:
            self._votes_by_block[key] = _BlockVotes(peer_maj23=True, votes=[None] * self.size())
        else:
            bv.peer_maj23 = True

    def make_commit(self):
        """The Commit of the +2/3 precommits (reference
        types/vote_set.go:578-602): COMMIT for a vote for the block, NIL for
        a nil vote, absent otherwise."""
        from tendermint_tpu_torch.types.block import Commit, CommitSig

        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise VoteSetError("cannot MakeCommit() unless VoteSet.Type is PRECOMMIT")
        if self._maj23 is None:
            raise VoteSetError("cannot MakeCommit() unless a blockhash has +2/3")
        sigs = []
        for vote in self._votes:
            if vote is not None and vote.block_id == self._maj23:
                flag = BlockIDFlag.COMMIT
            elif vote is not None and vote.block_id.is_zero():
                flag = BlockIDFlag.NIL
            else:
                sigs.append(CommitSig.absent_sig())
                continue
            sigs.append(CommitSig(flag, vote.validator_address, vote.timestamp_ns,
                                  vote.signature))
        return Commit(self.height, self.round, self._maj23, tuple(sigs))
