"""Proposal type (reference: types/proposal.go).

The port's copy of tendermint_tpu/types/proposal.py, the same encodings byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType, ts_seconds_nanos


@dataclass(frozen=True)
class Proposal:
    height: int
    round: int
    pol_round: int  # -1 when there is no POL
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    type: SignedMsgType = SignedMsgType.PROPOSAL

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round, self.block_id, self.timestamp_ns
        )

    def validate_basic(self) -> None:
        if self.type != SignedMsgType.PROPOSAL:
            raise ValueError("invalid proposal type")
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        if self.pol_round < -1 or (self.pol_round >= self.round and self.pol_round != -1):
            # reference: types/proposal.go ValidateBasic: -1 <= polRound < round
            raise ValueError("invalid POLRound")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("expected a complete, non-empty BlockID")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def with_signature(self, sig: bytes) -> "Proposal":
        return replace(self, signature=sig)

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, int(self.type))
        w.varint_field(2, self.height)
        w.varint_field(3, self.round)
        w.varint_field(4, self.pol_round)
        w.message_field(5, self.block_id.encode(), always=True)
        sec, nanos = ts_seconds_nanos(self.timestamp_ns)
        w.message_field(6, pw.encode_timestamp(sec, nanos), always=True)
        w.bytes_field(7, self.signature)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        height = round_ = 0
        pol_round = 0
        block_id = BlockID()
        ts = 0
        sig = b""
        for f, _, v in pw.Reader(data):
            if f == 2:
                height = pw.int64_from_varint(v)
            elif f == 3:
                round_ = pw.int64_from_varint(v)
            elif f == 4:
                pol_round = pw.int64_from_varint(v)
            elif f == 5:
                block_id = BlockID.decode(v)
            elif f == 6:
                sec = nanos = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        sec = pw.int64_from_varint(vv)
                    elif ff == 2:
                        nanos = pw.int64_from_varint(vv)
                ts = sec * 1_000_000_000 + nanos
            elif f == 7:
                sig = v
        return cls(
            height=height,
            round=round_,
            pol_round=pol_round,
            block_id=block_id,
            timestamp_ns=ts,
            signature=sig,
        )
