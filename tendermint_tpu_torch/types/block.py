"""Header, CommitSig, Commit, Block (reference types/block.go) and
AggregateCommit: the port's copy of tendermint_tpu/types/block.py, but for
the AggregateCommit codec.

Header.hash is the Merkle root of the 14 proto-encoded header fields
(reference types/block.go Header.Hash, types/encoding_helper.go cdcEncode:
primitives wrapped in single-field messages); Commit.hash the Merkle root
of the proto-encoded CommitSigs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.basic import (
    BlockID,
    BlockIDFlag,
    SignedMsgType,
    ts_seconds_nanos,
)
from tendermint_tpu_torch.types.vote import Vote, decode_timestamp


def _cdc_bytes(b: bytes) -> bytes:
    w = pw.Writer()
    w.bytes_field(1, b)
    return w.bytes()


def _cdc_string(s: str) -> bytes:
    w = pw.Writer()
    w.string_field(1, s)
    return w.bytes()


def _cdc_int64(v: int) -> bytes:
    w = pw.Writer()
    w.varint_field(1, v)
    return w.bytes()


def tx_hash(tx: bytes) -> bytes:
    return tmhash.sum256(tx)


def txs_hash(txs: Sequence[bytes]) -> bytes:
    """Merkle root over the transactions' SHA-256 hashes (reference
    types/tx.go Txs.Hash)."""
    return hash_from_byte_slices([tx_hash(tx) for tx in txs])


def _timestamp(ts_ns: int) -> bytes:
    return pw.encode_timestamp(*ts_seconds_nanos(ts_ns))


@dataclass(frozen=True)
class ConsensusVersion:
    """reference: proto/tendermint/version/types.proto Consensus."""

    block: int = 11  # BlockProtocol, reference: version/version.go
    app: int = 0

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.block)
        w.varint_field(2, self.app)
        return w.bytes()


_HASH_FIELDS = ("last_commit_hash", "data_hash", "evidence_hash", "last_results_hash",
                "validators_hash", "next_validators_hash", "consensus_hash")
# Header.encode / decode: proto field number -> bytes attribute
_BYTES_FIELDS = {6: "last_commit_hash", 7: "data_hash", 8: "validators_hash",
                 9: "next_validators_hash", 10: "consensus_hash", 11: "app_hash",
                 12: "last_results_hash", 13: "evidence_hash", 14: "proposer_address"}


@dataclass(frozen=True)
class Header:
    version: ConsensusVersion
    chain_id: str
    height: int
    time_ns: int
    last_block_id: BlockID
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes

    def hash(self) -> bytes:
        """Merkle root over the proto-encoded fields; b"" for a header
        without a validators hash (reference: types/block.go Header.Hash)."""
        if not self.validators_hash:
            return b""
        return hash_from_byte_slices([
            self.version.encode(),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            _timestamp(self.time_ns),
            self.last_block_id.encode(),
            *(_cdc_bytes(getattr(self, _BYTES_FIELDS[f])) for f in range(6, 15)),
        ])

    def validate_basic(self) -> None:
        if len(self.chain_id) > 50:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Header.Height")
        if self.height == 0:
            raise ValueError("zero Header.Height")
        self.last_block_id.validate_basic()
        for name in _HASH_FIELDS:
            h = getattr(self, name)
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"wrong {name} size")
        if len(self.proposer_address) != tmhash.TRUNCATED_SIZE:
            raise ValueError("invalid ProposerAddress length")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.message_field(1, self.version.encode(), always=True)
        w.string_field(2, self.chain_id)
        w.varint_field(3, self.height)
        w.message_field(4, _timestamp(self.time_ns), always=True)
        w.message_field(5, self.last_block_id.encode(), always=True)
        for f in range(6, 15):
            w.bytes_field(f, getattr(self, _BYTES_FIELDS[f]))
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        kw = dict(version=ConsensusVersion(), chain_id="", height=0, time_ns=0,
                  last_block_id=BlockID(), **{a: b"" for a in _BYTES_FIELDS.values()})
        for f, _, v in pw.Reader(data):
            if f == 1:
                blk = app = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        blk = vv
                    elif ff == 2:
                        app = vv
                kw["version"] = ConsensusVersion(blk, app)
            elif f == 2:
                kw["chain_id"] = v.decode("utf-8")
            elif f == 3:
                kw["height"] = pw.int64_from_varint(v)
            elif f == 4:
                kw["time_ns"] = decode_timestamp(v)
            elif f == 5:
                kw["last_block_id"] = BlockID.decode(v)
            elif f in _BYTES_FIELDS:
                kw[_BYTES_FIELDS[f]] = v
        return cls(**kw)


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

    def validate_basic(self) -> None:
        if self.block_id_flag not in (BlockIDFlag.ABSENT, BlockIDFlag.COMMIT, BlockIDFlag.NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.absent():
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
                raise ValueError("expected ValidatorAddress size to be 20 bytes")
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > 96:  # a compressed G2 BLS signature; 64 otherwise
                raise ValueError("signature is too big")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, int(self.block_id_flag))
        w.bytes_field(2, self.validator_address)
        w.message_field(3, _timestamp(self.timestamp_ns), always=True)
        w.bytes_field(4, self.signature)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        flag, addr, ts, sig = BlockIDFlag.ABSENT, b"", 0, b""
        for f, _, v in pw.Reader(data):
            if f == 1:
                flag = BlockIDFlag(v)
            elif f == 2:
                addr = v
            elif f == 3:
                ts = decode_timestamp(v)
            elif f == 4:
                sig = v
        return cls(flag, addr, ts, sig)


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

    def get_vote(self, val_idx: int) -> Vote:
        """The precommit of signature val_idx (reference types/block.go:770-782)."""
        cs = self.signatures[val_idx]
        return Vote(type=SignedMsgType.PRECOMMIT, height=self.height, round=self.round,
                    block_id=cs.block_id(self.block_id), timestamp_ns=cs.timestamp_ns,
                    validator_address=cs.validator_address, validator_index=val_idx,
                    signature=cs.signature)

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

    def hash(self) -> bytes:
        return hash_from_byte_slices([cs.encode() for cs in self.signatures])

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.message_field(3, self.block_id.encode(), always=True)
        for cs in self.signatures:
            w.message_field(4, cs.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        height = round_ = 0
        block_id = BlockID()
        sigs: List[CommitSig] = []
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                block_id = BlockID.decode(v)
            elif f == 4:
                sigs.append(CommitSig.decode(v))
        return cls(height, round_, block_id, tuple(sigs))


EMPTY_COMMIT = Commit(height=0, round=0, block_id=BlockID(), signatures=())


@dataclass(frozen=True)
class Block:
    """A header, its transactions, its evidence and the commit of the block
    before it (reference types/block.go Block)."""

    header: Header
    txs: tuple
    evidence: tuple
    last_commit: Commit

    def __post_init__(self):
        object.__setattr__(self, "txs", tuple(self.txs))
        object.__setattr__(self, "evidence", tuple(self.evidence))

    def hash(self) -> bytes:
        return self.header.hash()

    def data_hash(self) -> bytes:
        return txs_hash(self.txs)

    def validate_basic(self) -> None:
        self.header.validate_basic()
        self.last_commit.validate_basic()
        if self.header.height > 1 and self.last_commit.size() == 0:
            raise ValueError("nil LastCommit")
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong Header.LastCommitHash")
        if self.header.data_hash != self.data_hash():
            raise ValueError("wrong Header.DataHash")
        if self.header.evidence_hash != hash_from_byte_slices([e.hash() for e in self.evidence]):
            raise ValueError("wrong Header.EvidenceHash")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.message_field(1, self.header.encode(), always=True)
        data = pw.Writer()
        for tx in self.txs:
            data.bytes_field(1, tx, emit_empty=True)
        w.message_field(2, data.bytes(), always=True)
        ev = pw.Writer()
        for e in self.evidence:
            ev.message_field(1, e.encode(), always=True)
        w.message_field(3, ev.bytes(), always=True)
        w.message_field(4, self.last_commit.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        from tendermint_tpu_torch.types.evidence import decode_evidence

        header = None
        txs: List[bytes] = []
        evidence = []
        last_commit = EMPTY_COMMIT
        for f, _, v in pw.Reader(data):
            if f == 1:
                header = Header.decode(v)
            elif f == 2:
                txs.extend(vv for ff, _, vv in pw.Reader(v) if ff == 1)
            elif f == 3:
                evidence.extend(decode_evidence(vv) for ff, _, vv in pw.Reader(v) if ff == 1)
            elif f == 4:
                last_commit = Commit.decode(v)
        if header is None:
            raise ValueError("block missing header")
        return cls(header, tuple(txs), tuple(evidence), last_commit)


@dataclass(frozen=True)
class AggregateCommit:
    """A commit carried as one aggregate BLS signature and a signer bitmap.

    Every BLS signer signs the same canonical precommit bytes, with the
    commit's single `timestamp_ns`. `signers` is a little-endian
    bit-per-validator-index bitmap over the validator set the commit is
    verified against. `encode` / `decode` are the reference's wire codec,
    byte for byte: height (1), round (2), block ID (3), timestamp (4),
    signers (5), signature (6)."""

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

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.message_field(3, self.block_id.encode(), always=True)
        w.message_field(4, pw.encode_timestamp(*ts_seconds_nanos(self.timestamp_ns)), always=True)
        w.bytes_field(5, self.signers)
        w.bytes_field(6, self.agg_signature)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "AggregateCommit":
        height = round_ = ts = 0
        block_id = BlockID()
        signers = sig = b""
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                block_id = BlockID.decode(v)
            elif f == 4:
                sec = nanos = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        sec = pw.int64_from_varint(vv)
                    elif ff == 2:
                        nanos = pw.int64_from_varint(vv)
                ts = sec * 1_000_000_000 + nanos
            elif f == 5:
                signers = v
            elif f == 6:
                sig = v
        return cls(height, round_, block_id, ts, signers, sig)
