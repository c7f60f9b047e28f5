"""Blocksync's batched commit check: one flush over a run of blocks.

The reference's BlocksyncReactor._verify_run_batched
(tendermint_tpu/blocksync/reactor.py:285-342) as a function, without the
reactor, its metrics and the breaker's degrade (ROADMAP D1). Each (first,
parts, second) triple of the run holds a block, its PartSet and the next
block, whose last_commit commits `first`; every commit is checked against
the same validator set, and the for-block signatures of all of them go to
ONE flush with each row's key type: the scheduler's catch-up lane when one
is given and open (crypto/scheduler.py, which splits a flush above
planner_chunk_rows()), else one crypto.batch.verify_batch call (on the card
from 256 rows: the pipelined stream from 2,048 rows, the streamed planner
past 12,287).
"""

from __future__ import annotations

from typing import Optional, Sequence

from tendermint_tpu_torch.crypto.batch import verify_batch
from tendermint_tpu_torch.types.basic import BlockID


def verify_run_batched(vals, chain_id: str, run: Sequence[tuple], device=None,
                       backend: Optional[str] = None, scheduler=None) -> Optional[int]:
    """The index of the first triple whose commit fails, or None when all
    pass. A commit fails on its structure (a size other than the set's, a
    block ID other than BlockID(first.hash(), parts.header), a height other
    than first's) or when the power of its for-block signatures that
    verified is at most 2/3 of the set's. A run whose commits hold no
    for-block signature gives 0 (None when the run is empty), as the
    reference's does. device and backend go to verify_batch; a scheduler's
    lane uses the scheduler's own."""
    pubkeys, msgs, sigs, key_types = [], [], [], []
    spans = []  # (start, count, powers, total power, structure ok)
    for first, parts, second, *_ in run:
        commit = second.last_commit
        first_id = BlockID(first.hash(), parts.header)
        start = len(sigs)
        if len(commit.signatures) != vals.size():
            spans.append((start, 0, [], 1, False))
            continue
        idxs, powers = [], []
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val = vals.validators[idx]
            pubkeys.append(val.pub_key.bytes())
            idxs.append(idx)
            sigs.append(cs.signature)
            key_types.append(val.pub_key.type_name())
            powers.append(val.voting_power)
        msgs.extend(commit.vote_sign_bytes_many(chain_id, idxs))
        ok_struct = commit.block_id == first_id and commit.height == first.header.height
        spans.append((start, len(sigs) - start, powers, vals.total_voting_power(), ok_struct))
    if not sigs:
        return 0 if run else None
    if scheduler is not None and not scheduler.closed:
        mask = scheduler.verify_rows("catchup", pubkeys, msgs, sigs, key_types)
    else:
        mask = verify_batch(pubkeys, msgs, sigs, device=device, key_types=key_types,
                            backend=backend)
    for i, (start, count, powers, total, ok_struct) in enumerate(spans):
        if not ok_struct:
            return i
        tallied = sum(p for ok, p in zip(mask[start:start + count], powers) if ok)
        if tallied * 3 <= total * 2:
            return i
    return None
