"""Canonical vote and proposal sign-bytes (byte-exact gogoproto marshaling).

The port's copy of tendermint_tpu/types/canonical.py
(reference types/canonical.go, proto/tendermint/types/canonical.proto):
fields ascending, zero scalars omitted, nil BlockID omitted, height/round as
sfixed64, timestamp always emitted, the result length-delimited.
"""

from __future__ import annotations

from tendermint_tpu_torch.libs import hotstats
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType, ts_seconds_nanos


def canonical_block_id_bytes(block_id: BlockID) -> bytes | None:
    """None for a zero BlockID (reference: types/canonical.go:18-34)."""
    if block_id is None or block_id.is_zero():
        return None
    w = pw.Writer()
    w.bytes_field(1, block_id.hash)
    psh = pw.Writer()
    psh.varint_field(1, block_id.part_set_header.total)
    psh.bytes_field(2, block_id.part_set_header.hash)
    w.message_field(2, psh.bytes(), always=True)
    return w.bytes()


def _timestamp_bytes(ts_ns: int) -> bytes:
    sec, nanos = ts_seconds_nanos(ts_ns)
    return pw.encode_timestamp(sec, nanos)


def canonical_vote_bytes(msg_type, height: int, round_: int, block_id: BlockID,
                         timestamp_ns: int, chain_id: str) -> bytes:
    """CanonicalVote marshal (type=1, height=2 sfixed64, round=3 sfixed64,
    block_id=4, timestamp=5, chain_id=6)."""
    w = pw.Writer()
    w.varint_field(1, int(msg_type))
    w.sfixed64_field(2, height)
    w.sfixed64_field(3, round_)
    w.message_field(4, canonical_block_id_bytes(block_id))
    w.message_field(5, _timestamp_bytes(timestamp_ns), always=True)
    w.string_field(6, chain_id)
    return w.bytes()


def canonical_proposal_bytes(height: int, round_: int, pol_round: int, block_id: BlockID,
                             timestamp_ns: int, chain_id: str) -> bytes:
    """CanonicalProposal marshal (type=1, height=2, round=3, pol_round=4 int64,
    block_id=5, timestamp=6, chain_id=7)."""
    w = pw.Writer()
    w.varint_field(1, int(SignedMsgType.PROPOSAL))
    w.sfixed64_field(2, height)
    w.sfixed64_field(3, round_)
    w.varint_field(4, pol_round)  # int64 varint; -1 encodes as 10 bytes
    w.message_field(5, canonical_block_id_bytes(block_id))
    w.message_field(6, _timestamp_bytes(timestamp_ns), always=True)
    w.string_field(7, chain_id)
    return w.bytes()


def proposal_sign_bytes(chain_id: str, height: int, round_: int, pol_round: int,
                        block_id: BlockID, timestamp_ns: int) -> bytes:
    """Length-delimited canonical proposal (reference types/proposal.go
    ProposalSignBytes)."""
    return pw.length_delimited(
        canonical_proposal_bytes(height, round_, pol_round, block_id, timestamp_ns, chain_id))


def vote_sign_bytes(chain_id: str, msg_type, height: int, round_: int, block_id: BlockID,
                    timestamp_ns: int) -> bytes:
    """Length-delimited canonical vote (reference: types/vote.go VoteSignBytes)."""
    return pw.length_delimited(
        canonical_vote_bytes(msg_type, height, round_, block_id, timestamp_ns, chain_id)
    )


def vote_sign_bytes_many(chain_id: str, msg_type: SignedMsgType, height: int, round_: int,
                         rows) -> list:
    """vote_sign_bytes for rows sharing (chain_id, type, height, round); `rows`
    iterates (block_id, timestamp_ns). The shared prefix and suffix are
    encoded once; per row it is a memo hit or one timestamp encode and a
    join. Byte-identical to vote_sign_bytes per row. Its time counts under
    hotstats' `encode` stage, one count a row."""
    hs = hotstats.stats if hotstats.stats.enabled else None
    if hs is not None:
        t0 = hotstats.perf_counter()
    w = pw.Writer()
    w.varint_field(1, int(msg_type))
    w.sfixed64_field(2, height)
    w.sfixed64_field(3, round_)
    prefix = w.bytes()
    sw = pw.Writer()
    sw.string_field(6, chain_id)
    suffix = sw.bytes()
    tag4 = pw.tag(4, pw.BYTES)
    tag5 = pw.tag(5, pw.BYTES)
    enc = pw.encode_varint
    bid_cache: dict = {}
    row_cache: dict = {}
    out = []
    for block_id, ts in rows:
        bkey = None if block_id is None else block_id.key()
        row = row_cache.get((bkey, ts))
        if row is None:
            bid_part = bid_cache.get(bkey)
            if bid_part is None:
                body = canonical_block_id_bytes(block_id)
                bid_part = b"" if body is None else tag4 + enc(len(body)) + body
                bid_cache[bkey] = bid_part
            tb = _timestamp_bytes(ts)
            body = prefix + bid_part + tag5 + enc(len(tb)) + tb + suffix
            row = enc(len(body)) + body
            row_cache[(bkey, ts)] = row
        out.append(row)
    if hs is not None:
        hs.add("encode", hotstats.perf_counter() - t0, n=len(out))
    return out
