"""The slice as a whole: one height of the vote path into the commit check,
in the port and in the JAX package, each with a verified-row memo.

n validators precommit for one block, one of them with a bad signature.
Both packages queue the votes in a deferred VoteSet, flush it (one
verify_batch with the key types), make the commit and verify it with
ValidatorSet.verify_commit. The commit's rows are the rows the flush
verified, so both answer it from the memo with no flush (path "memo"). At
48 validators both flush on the host; at 300 the port's VoteSet names the
card arm (device="cpu", backend="cuda": the kernels' plain versions) and
the reference's runs under its host twins (tests/torch_routing_util.py).
Tolerance: zero. Flush results, commit bytes, labels and memo counts equal.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvset
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import vote_set as tvset
from tests.torch_routing_util import knobs  # noqa: F401  (fixture)

torch.set_num_threads(2)

CHAIN = "slice11-chain"
HEIGHT = 12
BAD = 3


@pytest.fixture
def memo(knobs):
    """A 4,096-row memo in both packages; the port's earlier memo is
    restored after the test (tests/conftest.py restores the reference's)."""
    prev = tbatch._MEMO
    tbatch.configure_verified_memo(4096)
    jbatch.configure_verified_memo(4096)
    yield
    tbatch._MEMO = prev


@pytest.mark.parametrize("n,card", [(48, False), (300, True)])
def test_one_height_votes_to_memo_commit(memo, n, card):
    rng = np.random.default_rng(n)
    privs = [jkeys.gen_ed25519(rng.bytes(32)) for _ in range(n)]
    jset = jvs.ValidatorSet([jvs.Validator(p.pub_key(), 10) for p in privs])
    tset = convert.validator_set_from_reference(jset)
    priv_of = {p.pub_key().address(): p for p in privs}
    jbid = jbasic.BlockID(rng.bytes(32), jbasic.PartSetHeader(2, rng.bytes(32)))
    tbid = tbasic.BlockID(jbid.hash, tbasic.PartSetHeader(2, jbid.part_set_header.hash))
    jv = jvset.VoteSet(CHAIN, HEIGHT, 0, jbasic.SignedMsgType.PRECOMMIT, jset,
                       defer_verification=True)
    tv = tvset.VoteSet(CHAIN, HEIGHT, 0, tbasic.SignedMsgType.PRECOMMIT, tset,
                       defer_verification=True, device="cpu",
                       backend="cuda" if card else None)
    for idx, val in enumerate(jset.validators):
        vote = jvote.Vote(jbasic.SignedMsgType.PRECOMMIT, HEIGHT, 0, jbid,
                          1_700_000_000_000_000_000 + 7_000 * idx, val.address, idx)
        sig = priv_of[val.address].sign(vote.sign_bytes(CHAIN))
        if idx == BAD:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        vote = vote.with_signature(sig)
        assert tv.add_vote(convert.vote_from_reference(vote)) == jv.add_vote(vote) == "pending"

    committed, failed = tv.flush()
    label = tbatch.LAST_FLUSH["path"]
    jtrace.reset_stats()
    jcommitted, jfailed = jv.flush()
    assert [v.encode() for v in committed] == [v.encode() for v in jcommitted]
    assert failed == jfailed == [BAD] and len(committed) == n - 1
    assert label == jtrace.verify_stats()["last_flush"]["path"] == ("persig" if card else "cpu")
    assert tv.has_two_thirds_majority() and jv.has_two_thirds_majority()

    commit, jcommit = tv.make_commit(), jv.make_commit()
    assert commit.encode() == jcommit.encode()
    assert commit.signatures[BAD].absent()
    stats0 = tbatch.verified_memo_stats()
    assert stats0 == jbatch.verified_memo_stats() and stats0["insertions"] == n - 1

    tset.verify_commit(CHAIN, tbid, HEIGHT, commit, device="cpu")
    label = tbatch.LAST_FLUSH["path"]
    jtrace.reset_stats()
    jset.verify_commit(CHAIN, jbid, HEIGHT, jcommit)
    assert label == jtrace.verify_stats()["last_flush"]["path"] == "memo"
    assert tbatch.LAST_FLUSH["memo_hits"] == n - 1
    stats = tbatch.verified_memo_stats()
    assert stats == jbatch.verified_memo_stats()
    assert stats["hits"] - stats0["hits"] == n - 1 and stats["insertions"] == n - 1
