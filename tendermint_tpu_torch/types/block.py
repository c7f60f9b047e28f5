"""CommitSig, Commit (reference types/block.go) and AggregateCommit: the
part of tendermint_tpu/types/block.py that commit verification needs."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

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


@dataclass(frozen=True)
class AggregateCommit:
    """A commit carried as one aggregate BLS signature and a signer bitmap.

    Every BLS signer signs the same canonical precommit bytes, with the
    commit's single `timestamp_ns`. `signers` is a little-endian
    bit-per-validator-index bitmap over the validator set the commit is
    verified against. The wire codec is not ported yet."""

    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    signers: bytes
    agg_signature: bytes

    def signer_indices(self) -> List[int]:
        out = []
        for byte_i, b in enumerate(self.signers):
            while b:
                bit = b & -b
                out.append(byte_i * 8 + bit.bit_length() - 1)
                b ^= bit
        return out

    def has_signer(self, idx: int) -> bool:
        byte_i = idx // 8
        return byte_i < len(self.signers) and bool(self.signers[byte_i] >> (idx % 8) & 1)

    @staticmethod
    def bitmap_of(indices: Sequence[int], n_vals: int) -> bytes:
        bm = bytearray((n_vals + 7) // 8)
        for i in indices:
            if not 0 <= i < n_vals:
                raise ValueError(f"signer index {i} out of range")
            bm[i // 8] |= 1 << (i % 8)
        return bytes(bm)

    def sign_bytes(self, chain_id: str) -> bytes:
        """The one canonical message every signer signed."""
        return canonical.vote_sign_bytes(
            chain_id, SignedMsgType.PRECOMMIT, self.height, self.round, self.block_id,
            self.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1 and self.block_id.is_zero():
            raise ValueError("aggregate commit cannot be for nil block")
        if len(self.agg_signature) != 96:
            raise ValueError("aggregate signature must be 96 bytes")
        if not any(self.signers):
            raise ValueError("empty signer bitmap")
