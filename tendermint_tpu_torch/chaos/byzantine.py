"""Byzantine behaviors for chaos soaks (reference test model:
consensus/byzantine_test.go:35): the port's copy of
tendermint_tpu/chaos/byzantine.py.

`install_equivocator` swaps a node's prevote behavior via the hook the state
machine exposes for exactly this (cs_state.do_prevote): each round it signs
the honest prevote AND a conflicting prevote for a fabricated BlockID with
the RAW key (a byzantine validator ignores the double-sign guard), then
gossips the conflict. A fabricated hash can never equal the honest prevote,
so EVERY round produces a detectable equivocation — the honest nodes must
turn it into DuplicateVoteEvidence and commit it.

`poison_votes` is the signature-poisoning flood (adversarial flush defense,
crypto/provenance.py): the target gossips `count` votes whose signatures are
REAL ed25519 signatures — valid point encoding, s < L, so they sail through
the cheap host precheck — but signed over the WRONG bytes, so they fail the
device batch verify and force RLC recovery flushes on every honest receiver.
Each vote carries a distinct fabricated BlockID so the deferred vote-set
dedup cannot collapse the flood. The defense under test: receivers' suspicion
scorers must quarantine the poisoning peer (rerouting its rows to the
scheduler's quarantine lane) and then punish it through the p2p trust scorer.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time


def install_equivocator(node) -> None:
    from tendermint_tpu_torch.consensus.messages import VoteMessage, encode_message
    from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
    from tendermint_tpu_torch.types.vote import Vote

    cs = node.consensus
    orig_do_prevote = cs._default_do_prevote

    def byz_do_prevote(height: int, round_: int) -> None:
        orig_do_prevote(height, round_)
        rs = cs.rs
        addr = node.priv_validator.get_pub_key().address()
        idx, _ = rs.validators.get_by_address(addr)
        if idx < 0:
            return
        vote = Vote(
            type=SignedMsgType.PREVOTE,
            height=height,
            round=round_,
            block_id=BlockID(b"\x42" * 32, PartSetHeader(1, b"\x42" * 32)),
            timestamp_ns=time.time_ns(),
            validator_address=addr,
            validator_index=idx,
        )
        sig = node.priv_validator.priv_key.sign(vote.sign_bytes(cs.state.chain_id))
        vote = dataclasses.replace(vote, signature=sig)

        async def gossip():
            try:
                await node.switch.broadcast(
                    VOTE_CHANNEL, encode_message(VoteMessage(vote))
                )
            except Exception:
                pass  # a dying switch mid-chaos must not kill the loop

        asyncio.ensure_future(gossip())

    cs.do_prevote = byz_do_prevote


async def poison_votes(node, count: int, burst: bool = False) -> int:
    """Gossip `count` precheck-passing but verify-failing votes from `node`
    (module docstring). Returns how many were actually broadcast.

    burst=True floods as a peer that ignores its own backpressure: every
    vote is built first, then each peer gets all of them in one write
    (p2p/conn/connection.MConnection.write_burst), so they land in the
    receivers' queues together and reach their deferred vote flushes in
    large batches. The votes' bytes are the same either way."""
    from tendermint_tpu_torch.consensus.messages import VoteMessage, encode_message
    from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
    from tendermint_tpu_torch.types.vote import Vote

    cs = node.consensus
    rs = cs.rs
    addr = node.priv_validator.get_pub_key().address()
    idx, _ = rs.validators.get_by_address(addr)
    if idx < 0 or node.switch is None:
        return 0
    sent = 0
    msgs = []
    for i in range(max(0, int(count))):
        # distinct fabricated BlockID per vote: the deferred vote-set dedup
        # keys on (validator, block, signature), so a repeated id would
        # collapse the flood to one row
        tag = bytes([0x50 + (i % 0xA0)]) + i.to_bytes(4, "big") + b"\x51" * 27
        vote = Vote(
            type=SignedMsgType.PREVOTE,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(tag, PartSetHeader(1, tag)),
            timestamp_ns=time.time_ns(),
            validator_address=addr,
            validator_index=idx,
        )
        # the poison: a REAL signature (passes precheck) over bytes that are
        # NOT this vote's sign bytes (fails verification)
        sig = node.priv_validator.priv_key.sign(
            b"tmtpu-sig-poison:" + i.to_bytes(4, "big")
        )
        vote = dataclasses.replace(vote, signature=sig)
        if burst:
            msgs.append(encode_message(VoteMessage(vote)))
            continue
        try:
            await node.switch.broadcast(
                VOTE_CHANNEL, encode_message(VoteMessage(vote))
            )
            sent += 1
        except Exception:
            pass  # a dying switch mid-chaos must not kill the flood loop
    if burst:
        peers = [p for p in node.switch.peers.list() if p.has_channel(VOTE_CHANNEL)]
        res = await asyncio.gather(
            *(p.mconn.write_burst(VOTE_CHANNEL, msgs) for p in peers),
            return_exceptions=True,
        )
        sent = len(msgs) if any(r is True for r in res) else 0
    return sent
