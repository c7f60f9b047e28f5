"""Vote: a signed prevote or precommit for a block, or for nil.

The port's copy of tendermint_tpu/types/vote.py (reference types/vote.go).
Sign bytes are the canonical length-delimited proto of types/canonical.py,
memoised per instance (a Vote is frozen); the wire encoding is the proto
Vote, fields 1-8, byte-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.crypto.keys import address_from_pubkey_bytes
from tendermint_tpu_torch.libs import hotstats
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType, ts_seconds_nanos


@dataclass(frozen=True)
class Vote:
    type: SignedMsgType
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def sign_bytes(self, chain_id: str) -> bytes:
        """Canonical sign bytes, memoised per instance and chain id
        (with_signature builds a new instance, with an empty memo)."""
        cached = self.__dict__.get("_sign_bytes")
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        hs = hotstats.stats if hotstats.stats.enabled else None
        if hs is not None:
            t0 = hotstats.perf_counter()
        data = canonical.vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id, self.timestamp_ns)
        if hs is not None:
            hs.add("encode", hotstats.perf_counter() - t0)
        object.__setattr__(self, "_sign_bytes", (chain_id, data))
        return data

    def seed_sign_bytes(self, chain_id: str, data: bytes) -> None:
        """Prime the sign-bytes memo from a batched encoder
        (canonical.vote_sign_bytes_many); `data` is what sign_bytes returns."""
        object.__setattr__(self, "_sign_bytes", (chain_id, data))

    def verify(self, chain_id: str, pubkey) -> bool:
        """One host verification (reference types/vote.go:149): the key's
        address must be the vote's, then the key verifies the sign bytes."""
        if address_from_pubkey_bytes(pubkey.bytes()) != self.validator_address:
            return False
        return pubkey.verify(self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        if self.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError("invalid vote type")
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got: {self.block_id}")
        if len(self.validator_address) != 20:
            raise ValueError("wrong validator address size")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 96:  # a compressed G2 BLS signature; 64 otherwise
            raise ValueError("signature too big")

    def with_signature(self, sig: bytes) -> "Vote":
        return replace(self, signature=sig)

    _T1 = pw.tag(1, pw.VARINT)
    _T2 = pw.tag(2, pw.VARINT)
    _T3 = pw.tag(3, pw.VARINT)
    _T4 = pw.tag(4, pw.BYTES)
    _T5 = pw.tag(5, pw.BYTES)
    _T6 = pw.tag(6, pw.BYTES)
    _T7 = pw.tag(7, pw.VARINT)
    _T8 = pw.tag(8, pw.BYTES)

    def encode(self) -> bytes:
        """The proto Vote, memoised per instance: zero scalars omitted, the
        block ID and timestamp always emitted."""
        cached = self.__dict__.get("_wire")
        if cached is not None:
            return cached
        hs = hotstats.stats if hotstats.stats.enabled else None
        if hs is not None:
            t0 = hotstats.perf_counter()
        enc = pw.encode_varint
        parts = []
        if int(self.type):
            parts.append(self._T1 + enc(int(self.type)))
        if self.height:
            parts.append(self._T2 + enc(self.height))
        if self.round:
            parts.append(self._T3 + enc(self.round))
        bid = self.block_id.encode()
        parts.append(self._T4 + enc(len(bid)) + bid)
        ts = pw.encode_timestamp(*ts_seconds_nanos(self.timestamp_ns))
        parts.append(self._T5 + enc(len(ts)) + ts)
        if self.validator_address:
            parts.append(self._T6 + enc(len(self.validator_address)) + self.validator_address)
        if self.validator_index:
            parts.append(self._T7 + enc(self.validator_index))
        if self.signature:
            parts.append(self._T8 + enc(len(self.signature)) + self.signature)
        data = b"".join(parts)
        if hs is not None:
            hs.add("encode", hotstats.perf_counter() - t0)
        object.__setattr__(self, "_wire", data)
        return data

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        vals = {"type": SignedMsgType.UNKNOWN, "height": 0, "round": 0, "block_id": BlockID(),
                "timestamp_ns": 0, "validator_address": b"", "validator_index": 0,
                "signature": b""}
        for f, _, v in pw.Reader(data):
            if f == 1:
                vals["type"] = SignedMsgType(v)
            elif f == 2:
                vals["height"] = pw.int64_from_varint(v)
            elif f == 3:
                vals["round"] = pw.int64_from_varint(v)
            elif f == 4:
                vals["block_id"] = BlockID.decode(v)
            elif f == 5:
                vals["timestamp_ns"] = decode_timestamp(v)
            elif f == 6:
                vals["validator_address"] = v
            elif f == 7:
                vals["validator_index"] = pw.int64_from_varint(v)
            elif f == 8:
                vals["signature"] = v
        return cls(**vals)


def decode_timestamp(data: bytes) -> int:
    """A proto Timestamp (seconds, nanos) -> integer nanoseconds."""
    sec = nanos = 0
    for f, _, v in pw.Reader(data):
        if f == 1:
            sec = pw.int64_from_varint(v)
        elif f == 2:
            nanos = pw.int64_from_varint(v)
    return sec * 1_000_000_000 + nanos
