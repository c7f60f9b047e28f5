"""The port's VoteSet (tendermint_tpu_torch/types/vote_set.py) against the
JAX package's, driven by the same seeded operations.

64 validators of seeded powers, the port's set carried over by
convert.validator_set_from_reference. A numpy-seeded sequence of
operations goes to both vote sets at once, verifying at add and deferred:
votes for block A (two timestamps each, so a second vote for the same
block carries another signature), for block B, for nil and with a bad
signature; exact duplicates; votes of another height, of an index out of
range and with an address not the index's; peers claiming +2/3 for A or B
(a peer changing its claim raises); and, deferred, flushes. After every
step: the return value or the exception (type, message and, for a
conflict, both votes' bytes), the bit arrays (whole and by block), the
power, +2/3 (and any), the votes held, the queue, the conflicts and
make_commit's bytes or its error. Then a deferred flush with bad rows, and
a flush over a mixed Ed25519 / sr25519 set, where each row goes under its
key type. Both packages run their host arm (fewer than 256 rows).
Tolerance: zero.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvset
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import vote_set as tvset

CHAIN = "vote-set-chain"
HEIGHT, ROUND = 9, 1
N = 64


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _block(tag: int):
    h, ph = bytes([tag]) * 32, bytes([tag + 1]) * 32
    return (jbasic.BlockID(h, jbasic.PartSetHeader(3, ph)),
            tbasic.BlockID(h, tbasic.PartSetHeader(3, ph)))


BLOCKS = {"a": _block(0xA0), "b": _block(0xB0), "nil": (jbasic.BlockID(), tbasic.BlockID())}


def _set(n_sr: int = 0, seed: int = 5):
    """n validators of seeded powers, the last n_sr sr25519: (reference set,
    port set, private key by address)."""
    rng = np.random.default_rng(seed)
    privs = [(jsr.gen_sr25519 if i >= N - n_sr else jkeys.gen_ed25519)(
        bytes([0x61, i, n_sr]) + bytes(29)) for i in range(N)]
    jset = jvs.ValidatorSet([jvs.Validator(p.pub_key(), int(rng.integers(1, 100)))
                             for p in privs])
    return jset, convert.validator_set_from_reference(jset), {
        p.pub_key().address(): p for p in privs}


JSET, TSET, PRIV = _set()


def _vote(jset, priv_of, idx, block="a", ts=0, bad=False, height=HEIGHT, address=None):
    """The same precommit in both packages, signed by validator idx's key
    (a flipped signature byte when bad)."""
    addr = jset.validators[idx % len(jset.validators)].address
    jbid, tbid = BLOCKS[block]
    stamp = 1_700_000_000_000_000_000 + 1_000 * idx + ts
    fields = dict(height=height, round=ROUND, timestamp_ns=stamp,
                  validator_address=address or addr, validator_index=idx)
    j = jvote.Vote(type=jbasic.SignedMsgType.PRECOMMIT, block_id=jbid, **fields)
    t = convert.vote_from_reference(j)
    assert t.block_id == tbid
    sig = priv_of[addr].sign(j.sign_bytes(CHAIN))
    if bad:
        sig = sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:]
    return j.with_signature(sig), t.with_signature(sig)


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # compared by type name, message and a conflict's votes
        votes = (e.vote_a.encode(), e.vote_b.encode()) if hasattr(e, "vote_a") else None
        return type(e).__name__, str(e), votes
    return ("ok", out)


def _flush_outcome(vs):
    committed, failed = vs.flush()
    return [v.encode() for v in committed], failed


def _state(vs):
    try:
        commit = vs.make_commit().encode()
    except Exception as e:
        commit = (type(e).__name__, str(e))
    maj = vs.two_thirds_majority()
    return dict(
        bits=vs.bit_array(), sum=vs.sum_power(), maj=None if maj is None else maj.key(),
        any=vs.has_two_thirds_any(), all=vs.has_all(), pending=vs.pending_count(),
        votes=[None if v is None else v.encode() for v in (vs.get_by_index(i)
                                                           for i in range(vs.size()))],
        by_a=vs.bit_array_by_block_id(BLOCKS["a"][0]), commit=commit,
        conflicts=[(c.vote_a.encode(), c.vote_b.encode()) for c in vs.pop_conflicts()])


def _tstate(vs):
    s = _state(vs)
    s["by_a"] = vs.bit_array_by_block_id(BLOCKS["a"][1])
    return s


def _run(seed: int, defer: bool, steps: int = 300):
    rng = np.random.default_rng(seed)
    jv = jvset.VoteSet(CHAIN, HEIGHT, ROUND, jbasic.SignedMsgType.PRECOMMIT, JSET,
                       defer_verification=defer)
    tv = tvset.VoteSet(CHAIN, HEIGHT, ROUND, tbasic.SignedMsgType.PRECOMMIT, TSET,
                       defer_verification=defer)
    sent, seen = [], {"pending": 0, "conflict": 0, "maj": False, "failed": 0}
    for step in range(steps):
        op = rng.choice(["add"] * 10 + ["dup", "peer", "invalid"] + ["flush"] * 2)
        if op == "flush" or (defer and step == steps - 1):
            got, want = _flush_outcome(tv), _flush_outcome(jv)
            assert got == want, step
            seen["failed"] += len(got[1])
        elif op == "peer":
            peer = f"peer{rng.integers(0, 3)}"
            block = rng.choice(["a", "b"])
            got = _outcome(lambda: tv.set_peer_maj23(peer, BLOCKS[block][1]))
            assert got == _outcome(lambda: jv.set_peer_maj23(peer, BLOCKS[block][0])), step
        else:
            if op == "dup" and sent:
                j, t = sent[int(rng.integers(0, len(sent)))]
            elif op == "invalid":
                kind = rng.integers(0, 3)
                idx = int(rng.integers(0, N))
                j, t = _vote(JSET, PRIV, idx, height=HEIGHT + 1) if kind == 0 else (
                    _vote(JSET, PRIV, N + idx) if kind == 1 else
                    _vote(JSET, PRIV, idx, address=bytes(20)))
            else:
                idx = int(rng.integers(0, N))
                block = rng.choice(["a"] * 6 + ["b", "b", "nil"])
                j, t = _vote(JSET, PRIV, idx, block, ts=int(rng.integers(0, 2)),
                             bad=rng.random() < 0.05)
                sent.append((j, t))
            got = _outcome(lambda: tv.add_vote(t, "p"))
            assert got == _outcome(lambda: jv.add_vote(j, "p")), step
            seen["pending"] += got == ("ok", "pending")
            seen["conflict"] += got[0] == "ConflictingVotesError"
        ts, js = _tstate(tv), _state(jv)
        assert ts == js, step
        seen["conflict"] += len(ts["conflicts"])
        seen["maj"] |= ts["maj"] is not None
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("defer", [False, True])
def test_seeded_sequences_match(seed, defer):
    seen = _run(seed, defer)
    assert seen["maj"] and seen["conflict"]
    assert (seen["pending"] > 0) is defer


def test_deferred_flush_with_bad_rows():
    """Bad signatures at three validators: their indices come back failed,
    the rest commit, +2/3 and the commit bytes as in the reference."""
    jv = jvset.VoteSet(CHAIN, HEIGHT, ROUND, jbasic.SignedMsgType.PRECOMMIT, JSET,
                       defer_verification=True)
    tv = tvset.VoteSet(CHAIN, HEIGHT, ROUND, tbasic.SignedMsgType.PRECOMMIT, TSET,
                       defer_verification=True)
    bad = {3, 17, 40}
    for idx in range(N):
        j, t = _vote(JSET, PRIV, idx, "nil" if idx == 5 else "a", bad=idx in bad)
        assert tv.add_vote(t) == jv.add_vote(j) == "pending"
    got = _flush_outcome(tv)
    assert got == _flush_outcome(jv)
    assert sorted(got[1]) == sorted(bad) and len(got[0]) == N - len(bad)
    assert tbatch.LAST_FLUSH["path"] == "cpu"
    assert _tstate(tv) == _state(jv)
    assert tv.has_two_thirds_majority()


def test_flush_over_a_mixed_key_set():
    """A set whose last 16 validators are sr25519: the flush sends each row
    under its key type (path "mixed"); an sr25519 vote with a bad signature
    fails, the others commit."""
    jset, tset, priv = _set(n_sr=16, seed=6)
    jv = jvset.VoteSet(CHAIN, HEIGHT, ROUND, jbasic.SignedMsgType.PRECOMMIT, jset,
                       defer_verification=True)
    tv = tvset.VoteSet(CHAIN, HEIGHT, ROUND, tbasic.SignedMsgType.PRECOMMIT, tset,
                       defer_verification=True)
    kinds = [v.pub_key.type_name() for v in tset.validators]
    bad = {kinds.index("sr25519"), kinds.index("ed25519")}
    for idx in range(N):
        j, t = _vote(jset, priv, idx, bad=idx in bad)
        assert tv.add_vote(t) == jv.add_vote(j) == "pending"
    got = _flush_outcome(tv)
    assert got == _flush_outcome(jv) and sorted(got[1]) == sorted(bad)
    assert tbatch.LAST_FLUSH["path"] == "mixed"
    assert _tstate(tv) == _state(jv)
