"""Validator and ValidatorSet with BATCHED commit verification.

The verify_commit half of tendermint_tpu/types/validator_set.py (reference
types/validator_set.go:662-714): the reference's serial per-validator verify
loop becomes one crypto.batch.verify_batch flush on the card. Same errors and
messages as the JAX package. Proposer selection and set updates are not part
of this slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from tendermint_tpu_torch.crypto.batch import verify_batch
from tendermint_tpu_torch.crypto.keys import Ed25519PubKey

INT64_MAX = 2**63 - 1


class CommitVerifyError(Exception):
    pass


class NotEnoughVotingPowerError(CommitVerifyError):
    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
        )
        self.got = got
        self.needed = needed


def _clip64(x: int) -> int:
    return max(-(2**63), min(INT64_MAX, x))


@dataclass
class Validator:
    pub_key: Ed25519PubKey
    voting_power: int
    address: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


class ValidatorSet:
    """Validators sorted by descending voting power, ties by ascending address
    (reference: types/validator_set.go ValidatorsByVotingPower)."""

    def __init__(self, validators: Sequence[Validator]):
        self.validators: List[Validator] = sorted(
            (Validator(v.pub_key, v.voting_power, v.address) for v in validators),
            key=lambda v: (-v.voting_power, v.address),
        )
        if len({v.address for v in self.validators}) != len(self.validators):
            raise ValueError("duplicate validator address")
        self._total_voting_power: Optional[int] = None

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            tot = 0
            for v in self.validators:
                tot = _clip64(tot + v.voting_power)
            self._total_voting_power = tot
        return self._total_voting_power

    def verify_commit(self, chain_id: str, block_id, height: int, commit, device=None) -> None:
        """All signatures checked; +2/3 must be for the block."""
        if self.size() != len(commit.signatures):
            raise CommitVerifyError(
                f"invalid commit -- wrong set size: {self.size()} vs {len(commit.signatures)}"
            )
        if height != commit.height:
            raise CommitVerifyError(f"invalid commit -- wrong height: {height} vs {commit.height}")
        if block_id != commit.block_id:
            raise CommitVerifyError(
                f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
            )
        pubkeys, sigs, meta, idxs = [], [], [], []
        for idx, cs in enumerate(commit.signatures):
            if cs.absent():
                continue
            val = self.validators[idx]
            pubkeys.append(val.pub_key.bytes())
            idxs.append(idx)
            sigs.append(cs.signature)
            meta.append((idx, val.voting_power, cs.for_block()))
        msgs = commit.vote_sign_bytes_many(chain_id, idxs)
        mask = verify_batch(pubkeys, msgs, sigs, device=device)
        tallied = 0
        for ok, (idx, power, for_block) in zip(mask, meta):
            if not ok:
                raise CommitVerifyError(f"wrong signature (#{idx})")
            if for_block:
                tallied += power
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise NotEnoughVotingPowerError(tallied, needed)
