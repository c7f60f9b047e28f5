"""The port's Vote and DuplicateVoteEvidence (tendermint_tpu_torch/types/
vote.py, evidence.py) against the JAX package's, on seeded votes.

Each vote is built field for field in both packages from numpy-seeded
values (nil and complete block IDs, zero, negative and large timestamps,
prevotes and precommits) and signed by a seeded key. Checked: sign bytes,
the wire encoding and its decoding (each package decodes the other's
bytes), validate_basic's errors, verify; and for DuplicateVoteEvidence
from_votes' order, hash, codec, validate_basic, decode_evidence and verify
with and without a batch verifier (each package's verify_batch), with the
first or the second signature bad. Tolerance: zero. Bytes identical,
verdicts and exceptions (type and message) equal.
"""

import dataclasses

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types import vote as tvote

CHAIN = "vote-chain"
RNG_SEED = 20261017


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _block_ids(rng, kind):
    """(reference BlockID, port BlockID) of a kind: nil, complete, or a hash
    without a part set (incomplete)."""
    if kind == "nil":
        return jbasic.BlockID(), tbasic.BlockID()
    h, ph = rng.bytes(32), rng.bytes(32)
    total = int(rng.integers(1, 1602)) if kind == "complete" else 0  # <= MAX_PART_SET_TOTAL
    phash = ph if kind == "complete" else b""
    return (jbasic.BlockID(h, jbasic.PartSetHeader(total, phash)),
            tbasic.BlockID(h, tbasic.PartSetHeader(total, phash)))


def _votes(rng, priv, kind="complete", **over):
    """The same vote in both packages, signed by priv; `over` replaces
    fields before signing."""
    jbid, tbid = _block_ids(rng, kind)
    f = dict(type=int(rng.choice([1, 2])), height=int(rng.integers(1, 1 << 40)),
             round=int(rng.integers(0, 50)),
             timestamp_ns=int(rng.integers(-(1 << 40), 1 << 62)),
             validator_address=priv.pub_key().address(),
             validator_index=int(rng.integers(0, 10_000)))
    f.update(over)
    j = jvote.Vote(type=jbasic.SignedMsgType(f["type"]), height=f["height"], round=f["round"],
                   block_id=jbid, timestamp_ns=f["timestamp_ns"],
                   validator_address=f["validator_address"],
                   validator_index=f["validator_index"])
    t = tvote.Vote(type=tbasic.SignedMsgType(f["type"]), height=f["height"], round=f["round"],
                   block_id=tbid, timestamp_ns=f["timestamp_ns"],
                   validator_address=f["validator_address"],
                   validator_index=f["validator_index"])
    sig = priv.sign(j.sign_bytes(CHAIN))
    return j.with_signature(sig), t.with_signature(sig)


def _priv(i):
    return jkeys.gen_ed25519(bytes([0x70, i]) + bytes(30))


def _tpub(priv):
    return tkeys.Ed25519PubKey(priv.pub_key().bytes())


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok", out)


@pytest.mark.parametrize("kind", ["complete", "nil"])
def test_sign_bytes_and_codec_match(kind):
    rng = np.random.default_rng(RNG_SEED)
    for i in range(24):
        over = {"timestamp_ns": 0} if i % 6 == 0 else {}
        if i % 8 == 1:
            over.update(round=0, validator_index=0)
        j, t = _votes(rng, _priv(i), kind, **over)
        assert t.sign_bytes(CHAIN) == j.sign_bytes(CHAIN)
        assert t.sign_bytes("other") == j.sign_bytes("other") != j.sign_bytes(CHAIN)
        assert t.encode() == j.encode()
        assert tvote.Vote.decode(j.encode()) == t
        assert jvote.Vote.decode(t.encode()) == j
        assert convert.vote_from_reference(j) == t
        assert t.is_nil() is j.is_nil() is (kind == "nil")
        assert t.verify(CHAIN, _tpub(_priv(i))) is j.verify(CHAIN, _priv(i).pub_key()) is True
        assert t.verify(CHAIN, _tpub(_priv(i + 1))) is False  # another key's address
        bad = t.with_signature(t.signature[:-1] + bytes([t.signature[-1] ^ 1]))
        assert bad.verify(CHAIN, _tpub(_priv(i))) is False


def _invalid_variants(rng):
    """(name, reference vote, port vote) for each validate_basic branch."""
    priv = _priv(99)
    j, t = _votes(rng, priv)
    out = [("valid", j, t)]
    for name, kw in [("type", dict(type=jbasic.SignedMsgType.PROPOSAL)),
                     ("height", dict(height=-1)), ("round", dict(round=-2)),
                     ("address", dict(validator_address=b"\x01" * 19)),
                     ("index", dict(validator_index=-1)), ("nosig", dict(signature=b"")),
                     ("bigsig", dict(signature=b"\x02" * 97)),
                     ("bls_size_sig", dict(signature=b"\x02" * 96))]:
        tkw = dict(kw)
        if "type" in kw:
            tkw["type"] = tbasic.SignedMsgType(int(kw["type"]))
        out.append((name, dataclasses.replace(j, **kw), dataclasses.replace(t, **tkw)))
    bids = [(jbasic.BlockID(b"\x05" * 32, jbasic.PartSetHeader(0, b"")),
             tbasic.BlockID(b"\x05" * 32, tbasic.PartSetHeader(0, b""))),
            (jbasic.BlockID(b"\x05" * 31, jbasic.PartSetHeader(1, b"\x06" * 32)),
             tbasic.BlockID(b"\x05" * 31, tbasic.PartSetHeader(1, b"\x06" * 32))),
            (jbasic.BlockID(b"\x05" * 32, jbasic.PartSetHeader(-1, b"\x06" * 32)),
             tbasic.BlockID(b"\x05" * 32, tbasic.PartSetHeader(-1, b"\x06" * 32)))]
    for k, (jb, tb) in enumerate(bids):
        out.append((f"block_id_{k}", dataclasses.replace(j, block_id=jb),
                    dataclasses.replace(t, block_id=tb)))
    return out


def test_validate_basic_errors_match():
    rng = np.random.default_rng(RNG_SEED + 1)
    outcomes = []
    for name, j, t in _invalid_variants(rng):
        got, want = _outcome(t.validate_basic), _outcome(j.validate_basic)
        assert got == want, name
        outcomes.append(got[0])
    assert outcomes.count("ok") == 2  # the valid vote and the 96-byte signature


def _evidence_votes(rng):
    """Two precommits by one validator for two blocks at one height and
    round, in both packages."""
    priv = _priv(7)
    j1, t1 = _votes(rng, priv, type=2, height=41, round=3, validator_index=12)
    j2, t2 = _votes(rng, priv, type=2, height=41, round=3, validator_index=12)
    return priv, (j1, t1), (j2, t2)


def _flip(v):
    return v.with_signature(v.signature[:5] + bytes([v.signature[5] ^ 4]) + v.signature[6:])


@pytest.mark.parametrize("bad", [None, "a", "b"])
@pytest.mark.parametrize("batched", [False, True])
def test_duplicate_vote_evidence_matches(bad, batched):
    rng = np.random.default_rng(RNG_SEED + 2)
    priv, (j1, t1), (j2, t2) = _evidence_votes(rng)
    jev_ = jev.DuplicateVoteEvidence.from_votes(j1, j2, 1_700_000_000_000_000_123, 1000, 10)
    tev_ = tev.DuplicateVoteEvidence.from_votes(t2, t1, 1_700_000_000_000_000_123, 1000, 10)
    assert tev_.encode() == jev_.encode() and tev_.hash() == jev_.hash()
    assert tev_.height == jev_.height == 41 and tev_.address() == jev_.address()
    assert tev.decode_evidence(jev_.encode()) == tev_
    assert jev.decode_evidence(tev_.encode()) == jev_
    assert convert.evidence_from_reference(jev_) == tev_
    assert _outcome(tev_.validate_basic) == _outcome(jev_.validate_basic) == ("ok", None)
    if bad == "a":
        jev_ = dataclasses.replace(jev_, vote_a=_flip(jev_.vote_a))
        tev_ = dataclasses.replace(tev_, vote_a=_flip(tev_.vote_a))
    elif bad == "b":
        jev_ = dataclasses.replace(jev_, vote_b=_flip(jev_.vote_b))
        tev_ = dataclasses.replace(tev_, vote_b=_flip(tev_.vote_b))
    jbv = (lambda p, m, s, kt: jbatch.verify_batch(p, m, s, key_types=kt)) if batched else None
    tbv = (lambda p, m, s, kt: tbatch.verify_batch(p, m, s, device="cpu", key_types=kt)
           ) if batched else None
    got = _outcome(lambda: tev_.verify(CHAIN, _tpub(priv), batch_verifier=tbv))
    want = _outcome(lambda: jev_.verify(CHAIN, priv.pub_key(), batch_verifier=jbv))
    assert got == want
    assert got == {None: ("ok", None),
                   "a": ("ValueError", "verifying VoteA: invalid signature"),
                   "b": ("ValueError", "verifying VoteB: invalid signature")}[bad]


def test_duplicate_vote_evidence_structure_errors():
    """verify's structural refusals and validate_basic's order check, in the
    reference's order and words."""
    rng = np.random.default_rng(RNG_SEED + 3)
    priv, (j1, t1), (j2, t2) = _evidence_votes(rng)
    jb = jev.DuplicateVoteEvidence.from_votes(j1, j2, 5, 100, 10)
    tb = tev.DuplicateVoteEvidence.from_votes(t1, t2, 5, 100, 10)
    cases = [
        ("height", dict(height=42)), ("round", dict(round=4)),
        ("type", dict(type=1)), ("address", dict(validator_address=b"\x09" * 20)),
    ]
    for name, kw in cases:
        tkw = dict(kw, **({"type": tbasic.SignedMsgType(1)} if "type" in kw else {}))
        jkw = dict(kw, **({"type": jbasic.SignedMsgType(1)} if "type" in kw else {}))
        jx = dataclasses.replace(jb, vote_b=dataclasses.replace(jb.vote_b, **jkw))
        tx = dataclasses.replace(tb, vote_b=dataclasses.replace(tb.vote_b, **tkw))
        got = _outcome(lambda: tx.verify(CHAIN, _tpub(priv)))
        assert got == _outcome(lambda: jx.verify(CHAIN, priv.pub_key())), name
        assert got[0] == "ValueError"
    same_j = dataclasses.replace(jb, vote_b=dataclasses.replace(jb.vote_b,
                                                                block_id=jb.vote_a.block_id))
    same_t = dataclasses.replace(tb, vote_b=dataclasses.replace(tb.vote_b,
                                                                block_id=tb.vote_a.block_id))
    assert _outcome(lambda: same_t.verify(CHAIN, _tpub(priv))) == _outcome(
        lambda: same_j.verify(CHAIN, priv.pub_key())) == (
        "ValueError", "duplicate votes must vote for different blocks")
    other = _priv(8)
    assert _outcome(lambda: tb.verify(CHAIN, _tpub(other))) == _outcome(
        lambda: jb.verify(CHAIN, other.pub_key())) == ("ValueError", "address does not match pubkey")
    swapped_j = dataclasses.replace(jb, vote_a=jb.vote_b, vote_b=jb.vote_a)
    swapped_t = dataclasses.replace(tb, vote_a=tb.vote_b, vote_b=tb.vote_a)
    assert _outcome(swapped_t.validate_basic) == _outcome(swapped_j.validate_basic) == (
        "ValueError", "duplicate votes in invalid order")


def test_decode_evidence_refuses_unknown_types():
    from tendermint_tpu_torch.libs import protowire as pw

    w = pw.Writer()
    w.message_field(2, b"\x08\x01", always=True)
    data = w.bytes()
    assert _outcome(lambda: tev.decode_evidence(data)) == _outcome(
        lambda: jev.decode_evidence(data)) == ("ValueError", "unknown evidence type")
    w = pw.Writer()
    w.message_field(1, b"\x18\x05", always=True)  # a body without its votes
    data = w.bytes()
    assert _outcome(lambda: tev.decode_evidence(data)) == _outcome(
        lambda: jev.decode_evidence(data)) == ("ValueError", "malformed DuplicateVoteEvidence")
