"""Consensus messages (reference: consensus/msgs.go + proto/tendermint/consensus).

Used on the wire (p2p channels 0x20-0x23) and in the WAL. Envelope: one
protowire message with a field per variant (mirrors the proto oneof).

The port's copy of tendermint_tpu/consensus/messages.py, the same encodings byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote


@dataclass(frozen=True)
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int
    last_commit_round: int

    FIELD = 1

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.varint_field(3, self.step)
        w.varint_field(4, self.seconds_since_start_time)
        w.varint_field(5, self.last_commit_round)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "NewRoundStepMessage":
        vals = [0, 0, 0, 0, 0]
        for f, _, v in pw.Reader(data):
            if 1 <= f <= 5:
                vals[f - 1] = pw.int64_from_varint(v)
        return cls(*vals)


@dataclass(frozen=True)
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: object  # PartSetHeader
    block_parts: List[bool]
    is_commit: bool

    FIELD = 2

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.message_field(3, self.block_part_set_header.encode(), always=True)
        bits = pw.Writer()
        bits.varint_field(1, len(self.block_parts))
        bits.bytes_field(2, _pack_bits(self.block_parts))
        w.message_field(4, bits.bytes(), always=True)
        w.varint_field(5, 1 if self.is_commit else 0)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "NewValidBlockMessage":
        from tendermint_tpu_torch.types.basic import PartSetHeader

        height = round_ = 0
        psh = PartSetHeader()
        parts: List[bool] = []
        is_commit = False
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                psh = PartSetHeader.decode(v)
            elif f == 4:
                n = 0
                raw = b""
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        n = vv
                    elif ff == 2:
                        raw = vv
                parts = _unpack_bits(raw, n)
            elif f == 5:
                is_commit = bool(v)
        return cls(height, round_, psh, parts, is_commit)


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal

    FIELD = 3

    def encode_body(self) -> bytes:
        return self.proposal.encode()

    @classmethod
    def decode_body(cls, data: bytes) -> "ProposalMessage":
        return cls(Proposal.decode(data))


@dataclass(frozen=True)
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: List[bool]

    FIELD = 4

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.proposal_pol_round)
        bits = pw.Writer()
        bits.varint_field(1, len(self.proposal_pol))
        bits.bytes_field(2, _pack_bits(self.proposal_pol))
        w.message_field(3, bits.bytes(), always=True)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "ProposalPOLMessage":
        height = pol_round = 0
        pol: List[bool] = []
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                pol_round = pw.int64_from_varint(v)
            elif f == 3:
                n = 0
                raw = b""
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        n = vv
                    elif ff == 2:
                        raw = vv
                pol = _unpack_bits(raw, n)
        return cls(height, pol_round, pol)


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part

    FIELD = 5

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.message_field(3, self.part.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "BlockPartMessage":
        height = round_ = 0
        part = None
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                part = Part.decode(v)
        return cls(height, round_, part)


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote

    FIELD = 6

    def encode_body(self) -> bytes:
        return self.vote.encode()

    @classmethod
    def decode_body(cls, data: bytes) -> "VoteMessage":
        return cls(Vote.decode(data))


@dataclass(frozen=True)
class HasVoteMessage:
    height: int
    round: int
    type: SignedMsgType
    index: int

    FIELD = 7

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.varint_field(3, int(self.type))
        w.varint_field(4, self.index)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "HasVoteMessage":
        vals = [0, 0, 0, 0]
        for f, _, v in pw.Reader(data):
            if 1 <= f <= 4:
                vals[f - 1] = pw.int64_from_varint(v)
        return cls(vals[0], vals[1], SignedMsgType(vals[2]), vals[3])


@dataclass(frozen=True)
class VoteSetMaj23Message:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID

    FIELD = 8

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.varint_field(3, int(self.type))
        w.message_field(4, self.block_id.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "VoteSetMaj23Message":
        height = round_ = t = 0
        bid = BlockID()
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                t = v
            elif f == 4:
                bid = BlockID.decode(v)
        return cls(height, round_, SignedMsgType(t), bid)


@dataclass(frozen=True)
class VoteSetBitsMessage:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID
    votes: List[bool]

    FIELD = 9

    def encode_body(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.height)
        w.varint_field(2, self.round)
        w.varint_field(3, int(self.type))
        w.message_field(4, self.block_id.encode(), always=True)
        bits = pw.Writer()
        bits.varint_field(1, len(self.votes))
        bits.bytes_field(2, _pack_bits(self.votes))
        w.message_field(5, bits.bytes(), always=True)
        return w.bytes()

    @classmethod
    def decode_body(cls, data: bytes) -> "VoteSetBitsMessage":
        height = round_ = t = 0
        bid = BlockID()
        votes: List[bool] = []
        for f, _, v in pw.Reader(data):
            if f == 1:
                height = pw.int64_from_varint(v)
            elif f == 2:
                round_ = pw.int64_from_varint(v)
            elif f == 3:
                t = v
            elif f == 4:
                bid = BlockID.decode(v)
            elif f == 5:
                n = 0
                raw = b""
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        n = vv
                    elif ff == 2:
                        raw = vv
                votes = _unpack_bits(raw, n)
        return cls(height, round_, SignedMsgType(t), bid, votes)


@dataclass(frozen=True)
class TraceContext:
    """Cross-node block-lifecycle trace metadata riding the p2p envelope
    (the chain observatory): origin node id, origin wall clock, and hop
    count. Stamped by the SENDER of a consensus message; every receiver can
    then record per-hop propagation latency (skew-corrected against the
    direct peer's ping/pong clock-skew estimate) into the consensus
    timeline. Encoded as envelope field TRACE_FIELD, APPENDED AFTER the
    variant field — decoders that don't know it (the WAL replayer, old
    peers) return at the variant field and never see it, so the wire format
    stays backward- and forward-compatible."""

    origin: str  # origin node id (hex, p2p/key.py NodeKey.id)
    origin_ts: float  # wall-clock seconds at the origin's FIRST send
    hops: int = 0  # 0 = direct from the origin; +1 per relay

    TRACE_FIELD = 15

    def encode(self) -> bytes:
        cached = self.__dict__.get("_enc")
        if cached is not None:
            return cached
        w = pw.Writer()
        w.bytes_field(1, self.origin.encode())
        w.varint_field(2, int(self.origin_ts * 1e6))
        w.varint_field(3, self.hops)
        data = w.bytes()
        object.__setattr__(self, "_enc", data)
        return data

    @classmethod
    def decode(cls, data: bytes) -> "TraceContext":
        origin, ts_us, hops = "", 0, 0
        for f, _, v in pw.Reader(data):
            if f == 1:
                origin = v.decode(errors="replace")
            elif f == 2:
                ts_us = pw.int64_from_varint(v)
            elif f == 3:
                hops = pw.int64_from_varint(v)
        return cls(origin, ts_us / 1e6, hops)

    def forwarded(self) -> "TraceContext":
        """The context a relaying node stamps on re-gossip: same origin and
        origin time, one more hop."""
        return TraceContext(self.origin, self.origin_ts, self.hops + 1)


_TAG_TRACE = pw.tag(TraceContext.TRACE_FIELD, pw.BYTES)


_MESSAGE_TYPES = {
    cls.FIELD: cls
    for cls in (
        NewRoundStepMessage,
        NewValidBlockMessage,
        ProposalMessage,
        ProposalPOLMessage,
        BlockPartMessage,
        VoteMessage,
        HasVoteMessage,
        VoteSetMaj23Message,
        VoteSetBitsMessage,
    )
}


def encode_message(msg, trace: Optional[TraceContext] = None) -> bytes:
    if type(msg) is VoteMessage:
        # The envelope memo lives on the VOTE (deeply immutable), not the
        # per-send VoteMessage wrapper: one vote is wrapped freshly for its
        # WAL frame and for EVERY peer it is gossiped to, but the bytes are
        # identical — one build total. The memo is TRACE-FREE: the trace
        # suffix is appended outside it (TraceContext.encode is itself
        # memoized, so a traced gossip send costs two concats, not a
        # re-encode of the vote).
        vote = msg.vote
        env = vote.__dict__.get("_vote_msg_env")
        if env is None:
            w = pw.Writer()
            w.message_field(VoteMessage.FIELD, vote.encode(), always=True)
            env = w.bytes()
            object.__setattr__(vote, "_vote_msg_env", env)
    else:
        w = pw.Writer()
        w.message_field(msg.FIELD, msg.encode_body(), always=True)
        env = w.bytes()
    if trace is None:
        return env
    tb = trace.encode()
    return env + _TAG_TRACE + pw.encode_varint(len(tb)) + tb


def decode_message(data: bytes):
    for f, _, v in pw.Reader(data):
        cls = _MESSAGE_TYPES.get(f)
        if cls is not None:
            return cls.decode_body(v)
    raise ValueError("unknown consensus message")


def decode_message_traced(data: bytes):
    """(message, TraceContext or None). Unlike decode_message — which
    returns at the variant field and is what the WAL replayer keeps using —
    this walks every envelope field so the trailing trace is recovered."""
    msg = None
    trace = None
    for f, _, v in pw.Reader(data):
        if f == TraceContext.TRACE_FIELD:
            trace = TraceContext.decode(v)
            continue
        cls = _MESSAGE_TYPES.get(f)
        if cls is not None and msg is None:
            msg = cls.decode_body(v)
    if msg is None:
        raise ValueError("unknown consensus message")
    return msg, trace


def _pack_bits(bits: List[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _unpack_bits(raw: bytes, n: int) -> List[bool]:
    return [bool(raw[i // 8] >> (i % 8) & 1) if i // 8 < len(raw) else False for i in range(n)]
