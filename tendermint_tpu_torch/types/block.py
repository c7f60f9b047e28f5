"""CommitSig and Commit (reference types/block.go), the part of
tendermint_tpu/types/block.py that commit verification needs."""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, SignedMsgType


@dataclass(frozen=True)
class CommitSig:
    block_id_flag: BlockIDFlag
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent_sig(cls) -> "CommitSig":
        return cls(block_id_flag=BlockIDFlag.ABSENT)

    def absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """(reference: types/block.go:638-651)"""
        if self.block_id_flag == BlockIDFlag.COMMIT:
            return commit_block_id
        return BlockID()


@dataclass(frozen=True)
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: tuple

    def __post_init__(self):
        object.__setattr__(self, "signatures", tuple(self.signatures))

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        cs = self.signatures[val_idx]
        return canonical.vote_sign_bytes(
            chain_id, SignedMsgType.PRECOMMIT, self.height, self.round,
            cs.block_id(self.block_id), cs.timestamp_ns,
        )

    def vote_sign_bytes_many(self, chain_id: str, val_idxs) -> list:
        """vote_sign_bytes over many signature indices in one pass."""
        return canonical.vote_sign_bytes_many(
            chain_id, SignedMsgType.PRECOMMIT, self.height, self.round,
            (
                (self.signatures[i].block_id(self.block_id), self.signatures[i].timestamp_ns)
                for i in val_idxs
            ),
        )
