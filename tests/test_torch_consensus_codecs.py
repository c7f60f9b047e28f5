"""The port's consensus codecs and stores against the JAX package's, byte for
byte (tolerance 0): every consensus message type, WAL records and a WAL the
reference wrote (with a torn or corrupt tail), proposal sign bytes, the
genesis JSON and hashes, the params hash, and the state and block stores,
including a block store the reference saved and the port loads.

Inputs are made from a numpy seed; a short chain is committed by the
reference (tests/test_torch_consensus_util.run_chain) for the stores.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu_torch import convert
from tests.test_torch_consensus_util import Pkg, run_chain, seeds

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261019
CHAIN = "codec-chain"
TS = 1_700_000_123_456_789_012


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A one-validator chain of the reference commits 3 heights with txs;
    its stores stay in memory."""
    tmp = tmp_path_factory.mktemp("chain")
    node = run_chain(REF, seeds(1, SEED), str(tmp / "wal"), 3, txs=(b"k1=v1", b"k2=v2", b"k3"))
    return node


def _block_id(rng, P):
    return P.basic.BlockID(rng.bytes(32), P.basic.PartSetHeader(int(rng.integers(1, 9)),
                                                                rng.bytes(32)))


def _messages(P, rng, chain_node):
    """One message of each consensus type, built from the same seeded values
    in package P (the vote and proposal signed in the reference, carried)."""
    bid = _block_id(rng, P)
    jnode = chain_node
    jvote = jnode.block_store.load_seen_commit(2).get_vote(0)
    vote = jvote if P is REF else convert.vote_from_reference(jvote)
    jprop = REF.proposal.Proposal(5, 2, 1, REF.basic.BlockID(bid.hash, REF.basic.PartSetHeader(
        bid.part_set_header.total, bid.part_set_header.hash)), TS)
    jprop = jprop.with_signature(jnode.privs[0].priv_key.sign(jprop.sign_bytes(CHAIN)))
    prop = jprop if P is REF else convert.proposal_from_reference(jprop)
    part = P.part_set.PartSet.from_data(rng.bytes(100_000)).get_part(1)
    bits = [bool(b) for b in rng.integers(0, 2, 37)]
    M, T = P.messages, P.basic.SignedMsgType
    return {
        "NewRoundStep": M.NewRoundStepMessage(7, 2, 6, 3, 1),
        "NewValidBlock": M.NewValidBlockMessage(7, 2, bid.part_set_header, bits, True),
        "Proposal": M.ProposalMessage(prop),
        "ProposalPOL": M.ProposalPOLMessage(7, 1, bits),
        "BlockPart": M.BlockPartMessage(7, 2, part),
        "Vote": M.VoteMessage(vote),
        "HasVote": M.HasVoteMessage(7, 2, T.PRECOMMIT, 41),
        "VoteSetMaj23": M.VoteSetMaj23Message(7, 2, T.PREVOTE, bid),
        "VoteSetBits": M.VoteSetBitsMessage(7, 2, T.PRECOMMIT, bid, bits),
    }


KINDS = ("NewRoundStep", "NewValidBlock", "Proposal", "ProposalPOL", "BlockPart", "Vote",
         "HasVote", "VoteSetMaj23", "VoteSetBits")


@pytest.mark.parametrize("kind", KINDS)
def test_message_bytes(kind, chain):
    want = _messages(REF, np.random.default_rng(SEED), chain)[kind]
    got = _messages(PORT, np.random.default_rng(SEED), chain)[kind]
    raw = REF.messages.encode_message(want)
    assert PORT.messages.encode_message(got) == raw
    back = PORT.messages.decode_message(raw)
    assert PORT.messages.encode_message(back) == raw
    trace_j = REF.messages.TraceContext("ab" * 20, 1_700_000_000.25, 2)
    trace_p = PORT.messages.TraceContext("ab" * 20, 1_700_000_000.25, 2)
    traced = REF.messages.encode_message(want, trace_j)
    assert PORT.messages.encode_message(got, trace_p) == traced
    m, t = PORT.messages.decode_message_traced(traced)
    assert PORT.messages.encode_message(m) == raw and t == trace_p


def _wal_records(P, msgs):
    W = P.wal
    return [W.EndHeightMessage(6), W.EventRoundState(7, 0, 1),
            W.TimeoutInfo(0.4, 7, 0, 3), W.MsgInfo(msgs["Proposal"], "peer-1"),
            W.MsgInfo(msgs["BlockPart"], "peer-1"), W.MsgInfo(msgs["Vote"], ""),
            W.TimeoutInfo(1.25, 7, 1, 7), W.EventRoundState(7, 1, 8)]


def _write_wal(P, path, records, group_commit):
    w = P.wal.WAL(path, group_commit=group_commit)
    for i, r in enumerate(records):
        (w.write_sync if i % 3 == 0 else w.write)(r)
    w.flush_buffered()
    w.write_end_height(7)
    w.close()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("group_commit", [False, True])
def test_wal_records_and_reference_wal(group_commit, chain, tmp_path, monkeypatch):
    """The same records give the same WAL file; the port reads the
    reference's file into the same messages and finds the same end-height
    markers; a torn tail stops the lenient reader at the same record and a
    corrupt one raises the same CorruptedWALError in strict mode."""
    clock = SimpleNamespace(perf_counter=lambda: 1000.0)  # the group-commit clock
    monkeypatch.setattr(REF.wal, "time", clock)
    monkeypatch.setattr(PORT.wal, "time", clock)
    jrec = _wal_records(REF, _messages(REF, np.random.default_rng(SEED), chain))
    prec = _wal_records(PORT, _messages(PORT, np.random.default_rng(SEED), chain))
    jraw = _write_wal(REF, str(tmp_path / "j" / "wal"), jrec, group_commit)
    praw = _write_wal(PORT, str(tmp_path / "p" / "wal"), prec, group_commit)
    assert praw == jraw
    jpath = str(tmp_path / "j" / "wal")
    got = list(PORT.wal.iter_wal_messages(jpath, strict=True))
    want = list(REF.wal.iter_wal_messages(jpath, strict=True))
    assert len(got) == len(want) == len(jrec) + 2
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want]
    for g, w in zip(got, want):
        if type(w).__name__ == "MsgInfo":
            assert (PORT.messages.encode_message(g.msg), g.peer_id) == (
                REF.messages.encode_message(w.msg), w.peer_id)
        else:
            assert tuple(vars(g).values()) == tuple(vars(w).values())
    pw_ = PORT.wal.WAL(jpath)
    after = pw_.search_for_end_height(6)
    assert len(after) == len(jrec) - 1 + 1
    assert pw_.search_for_end_height(8) is None
    pw_.close()
    for cut, flip in ((len(jraw) - 5, None), (len(jraw), len(jraw) - 3), (len(jraw), 2)):
        data = bytearray(jraw[:cut])
        if flip is not None:
            data[flip] ^= 0x40
        path = str(tmp_path / f"bad-{cut}-{flip}")
        with open(path, "wb") as f:
            f.write(bytes(data))
        lenient = list(PORT.wal.iter_wal_messages(path))
        assert len(lenient) == len(list(REF.wal.iter_wal_messages(path)))
        with pytest.raises(PORT.wal.CorruptedWALError) as e:
            list(PORT.wal.iter_wal_messages(path, strict=True))
        with pytest.raises(REF.wal.CorruptedWALError) as je:
            list(REF.wal.iter_wal_messages(path, strict=True))
        assert str(e.value) == str(je.value)


def test_proposal_sign_bytes_and_signature(chain):
    rng = np.random.default_rng(SEED + 1)
    bid = _block_id(rng, REF)
    for pol in (-1, 0, 3):
        jp = REF.proposal.Proposal(9, 4, pol, bid, TS + pol)
        pp = convert.proposal_from_reference(jp)
        assert pp.sign_bytes(CHAIN) == jp.sign_bytes(CHAIN)
        assert pp.encode() == jp.encode()
        seed = rng.bytes(32)
        js = REF.file_pv.FilePV(REF.keys.gen_ed25519(seed)).sign_proposal(CHAIN, jp)
        ps = PORT.file_pv.FilePV(PORT.keys.gen_ed25519(seed)).sign_proposal(CHAIN, pp)
        assert ps.encode() == js.encode()


def test_genesis_json_hashes_and_params():
    rng = np.random.default_rng(SEED + 2)
    keys = [rng.bytes(32) for _ in range(5)]
    jparams = REF.params.ConsensusParams(
        block=REF.params.BlockParams(1_048_576, 40_000_000),
        evidence=REF.params.EvidenceParams(500, 3_600 * 10**9, 2_048))
    jgen = REF.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time_ns=TS, initial_height=3, consensus_params=jparams,
        validators=[REF.genesis.GenesisValidator(REF.keys.gen_ed25519(k).pub_key(), 10 + i,
                                                 name=f"v{i}") for i, k in enumerate(keys)],
        app_hash=rng.bytes(8), app_state=b'{"accounts": [1, 2]}')
    jgen.validate_and_complete()
    pgen = convert.genesis_from_reference(jgen)
    assert pgen.to_json() == jgen.to_json()
    assert pgen.validator_hash() == jgen.validator_hash()
    assert PORT.sm_state.state_from_genesis(pgen).to_json() == \
        REF.sm_state.state_from_genesis(jgen).to_json()
    pparams = pgen.consensus_params
    assert pparams.hash() == jparams.hash()
    assert PORT.params.ConsensusParams().hash() == REF.params.ConsensusParams().hash()
    with pytest.raises(ValueError) as e:
        PORT.genesis.GenesisDoc(chain_id="x" * 51).validate_and_complete()
    with pytest.raises(ValueError) as je:
        REF.genesis.GenesisDoc(chain_id="x" * 51).validate_and_complete()
    assert str(e.value) == str(je.value)


def _db_items(db):
    return sorted(db.iterate_prefix(b""))


def test_state_store_bytes_and_reference_store(chain):
    """The port's StateStore writes the reference's bytes for the same
    states, and reads the reference's store into the same state,
    validators and ABCI responses."""
    jdb = chain.state_store.db
    pstore = PORT.state_store.StateStore(PORT.kvdb.MemDB())
    for k, v in _db_items(jdb):
        pstore.db.set(k, v)
    jstate = chain.state_store.load()
    pstate = pstore.load()
    assert pstate.to_json() == jstate.to_json()
    for h in range(1, jstate.last_block_height + 2):
        jv, pv = chain.state_store.load_validators(h), pstore.load_validators(h)
        assert jv is not None
        assert (pv.hash(), pv.get_proposer().address) == (jv.hash(), jv.get_proposer().address)
        jr, pr = chain.state_store.load_abci_responses(h), pstore.load_abci_responses(h)
        assert (pr is None) == (jr is None)
        if jr is not None:
            assert pr.to_json() == jr.to_json()
    fresh = PORT.state_store.StateStore(PORT.kvdb.MemDB())
    jfresh = REF.state_store.StateStore(REF.kvdb.MemDB())
    fresh.save(convert.state_from_reference(jstate))
    jfresh.save(jstate)
    assert _db_items(fresh.db) == _db_items(jfresh.db)


def test_block_store_bytes_and_reference_store(chain):
    """Blocks the reference saved load in the port as the same blocks,
    parts and commits; the port saving them writes the same bytes."""
    jbs = chain.block_store
    pbs = PORT.blockstore.BlockStore(PORT.kvdb.MemDB())
    for k, v in _db_items(jbs.db):
        pbs.db.set(k, v)
    assert (pbs.base, pbs.height) == (jbs.base, jbs.height) and jbs.height >= 3
    again = PORT.blockstore.BlockStore(PORT.kvdb.MemDB())
    for h in range(1, jbs.height + 1):
        jb, pb = jbs.load_block(h), pbs.load_block(h)
        assert pb.encode() == jb.encode() and pb.hash() == jb.hash()
        assert pbs.load_seen_commit(h).encode() == jbs.load_seen_commit(h).encode()
        assert pbs.load_block_commit(h - 1) is None or \
            pbs.load_block_commit(h - 1).encode() == jbs.load_block_commit(h - 1).encode()
        jmeta, pmeta = jbs.load_block_meta(h), pbs.load_block_meta(h)
        assert pmeta[0].encode() == jmeta[0].encode() and pmeta[1] == jmeta[1]
        for i in range(pmeta[1]):
            assert pbs.load_block_part(h, i).encode() == jbs.load_block_part(h, i).encode()
        parts = PORT.part_set.PartSet.from_data(pb.encode())
        again.save_block(pb, parts, pbs.load_seen_commit(h))
    assert _db_items(again.db) == _db_items(jbs.db)
    assert pbs.load_block_by_hash(jbs.load_block(2).hash()).hash() == jbs.load_block(2).hash()
