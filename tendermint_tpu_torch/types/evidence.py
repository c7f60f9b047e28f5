"""DuplicateVoteEvidence: two conflicting votes by one validator at the same
height, round and type.

The port's copy of tendermint_tpu/types/evidence.py (reference
types/evidence.go). `verify` checks the two signatures, one after the other
on the host or, given a `batch_verifier` (crypto/batch.verify_batch, say),
as two rows of one flush. The codec wraps the body in the Evidence oneof,
byte-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import ts_seconds_nanos
from tendermint_tpu_torch.types.vote import Vote, decode_timestamp


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int
    validator_power: int
    timestamp_ns: int

    TYPE_URL = 1  # the field number inside the Evidence oneof

    @classmethod
    def from_votes(cls, vote1: Vote, vote2: Vote, block_time_ns: int, total_power: int,
                   val_power: int) -> "DuplicateVoteEvidence":
        """The votes ordered by block ID key (reference types/evidence.go
        NewDuplicateVoteEvidence)."""
        if vote1.block_id.key() < vote2.block_id.key():
            a, b = vote1, vote2
        else:
            a, b = vote2, vote1
        return cls(a, b, total_power, val_power, block_time_ns)

    @property
    def height(self) -> int:
        return self.vote_a.height

    def address(self) -> bytes:
        return self.vote_a.validator_address

    def hash(self) -> bytes:
        return tmhash.sum256(self.encode())

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def verify(self, chain_id: str, pubkey, batch_verifier=None) -> None:
        """(reference evidence/verify.go VerifyDuplicateVote, types/evidence.go:189)
        Raises ValueError. batch_verifier: callable(pubkeys, msgs, sigs,
        key_types) -> bool mask, which checks both signatures in one call;
        None checks them one after the other with pubkey.verify."""
        a, b = self.vote_a, self.vote_b
        if a.height != b.height or a.round != b.round or a.type != b.type:
            raise ValueError("duplicate votes must have same H/R/S")
        if a.validator_address != b.validator_address:
            raise ValueError("duplicate votes must be from the same validator")
        if a.block_id == b.block_id:
            raise ValueError("duplicate votes must vote for different blocks")
        if pubkey.address() != a.validator_address:
            raise ValueError("address does not match pubkey")
        if batch_verifier is not None:
            pk, kt = pubkey.bytes(), pubkey.type_name()
            mask = batch_verifier([pk, pk], [a.sign_bytes(chain_id), b.sign_bytes(chain_id)],
                                  [a.signature, b.signature], [kt, kt])
            if not mask[0]:
                raise ValueError("verifying VoteA: invalid signature")
            if not mask[1]:
                raise ValueError("verifying VoteB: invalid signature")
            return
        if not pubkey.verify(a.sign_bytes(chain_id), a.signature):
            raise ValueError("verifying VoteA: invalid signature")
        if not pubkey.verify(b.sign_bytes(chain_id), b.signature):
            raise ValueError("verifying VoteB: invalid signature")

    def encode(self) -> bytes:
        body = pw.Writer()
        body.message_field(1, self.vote_a.encode(), always=True)
        body.message_field(2, self.vote_b.encode(), always=True)
        body.varint_field(3, self.total_voting_power)
        body.varint_field(4, self.validator_power)
        body.message_field(5, pw.encode_timestamp(*ts_seconds_nanos(self.timestamp_ns)),
                           always=True)
        w = pw.Writer()
        w.message_field(self.TYPE_URL, body.bytes(), always=True)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "DuplicateVoteEvidence":
        vote_a = vote_b = None
        total = valp = ts = 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                vote_a = Vote.decode(v)
            elif f == 2:
                vote_b = Vote.decode(v)
            elif f == 3:
                total = pw.int64_from_varint(v)
            elif f == 4:
                valp = pw.int64_from_varint(v)
            elif f == 5:
                ts = decode_timestamp(v)
        if vote_a is None or vote_b is None:
            raise ValueError("malformed DuplicateVoteEvidence")
        return cls(vote_a, vote_b, total, valp, ts)


def decode_evidence(data: bytes):
    """An Evidence oneof -> its evidence; an unknown type raises ValueError."""
    for f, _, v in pw.Reader(data):
        if f == DuplicateVoteEvidence.TYPE_URL:
            return DuplicateVoteEvidence.decode_body(v)
    raise ValueError("unknown evidence type")
