"""The port's ConsensusState against the JAX package's, scenario by scenario.

The scenarios are tests/test_consensus_state.py's (:209 full round, :247
LockNoPOL, :300 POL relock, :343 POL unlock on a nil polka, :433 propose
timeout, :515 conflicting votes), plus deferred verification with one bad
signature (tests/test_multinode.py:260). Each runs first on the reference,
which signs and records every injected message, then on the port, fed the
same messages by their bytes, under one fake clock (tests/test_torch_consensus_util.py).
Compared with tolerance 0: the (height, round, step) events, the node's own
votes, the committed block hashes and seen commits, the app hash and the
pending evidence, all as bytes.

Port only: a 300-validator height on the card arm's plain kernels (the
deferred flushes of 299 and 300 rows take the card arm's route for fewer
than RLC_MIN = 512 rows, the per-signature ladder "persig"; the next
height's LastCommit check is answered from the verified-row memo), a device error in the deferred flush
halting consensus, and the Handshaker restarting the port from stores and a
WAL the reference wrote.
"""

import asyncio
import os

import pytest

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.ops import cuda_fe, cuda_msm
from tests.test_torch_consensus_util import FakeTime, Node, Pkg, run_scenario, seeds

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")  # the reference's host arm, as its tests run

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261018
TXS = (b"alpha=1", b"beta=2", b"gamma")
FAKE_A = (b"\x22" * 32, 1, b"\x11" * 32)
FAKE_B = (b"\x33" * 32, 1, b"\x11" * 32)


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _slow_propose(cfg):
    cfg.timeout_propose = 1.0  # the injected round-0 proposal arrives first


async def _full_round(d):
    """The node (validator 0) proposes height 1 with the mempool's txs; a
    stub proposes height 2; everyone votes for each proposal."""
    for h in (1, 2):
        await d.wait_step("PROPOSE", height=h)
        await d.settle()
        await d.proposal()
        await d.settle()
        await d.votes("PREVOTE", h, 0, "proposal", [1, 2, 3])
        await d.votes("PRECOMMIT", h, 0, "proposal", [1, 2, 3])
        await d.wait_step("NEW_HEIGHT", height=h + 1)
        d.tick(1_000_000_000)
    await d.wait_step("PROPOSE", height=3)


async def _lock_round0(d):
    """A stub's proposal at height 1, round 0, a polka for it (the node
    locks), then +2/3 nil precommits: round 1."""
    await d.wait_step("PROPOSE", height=1)
    await d.settle()
    await d.proposal()
    await d.settle()
    await d.votes("PREVOTE", 1, 0, "proposal", [0, 2, 3])
    await d.settle()
    await d.votes("PRECOMMIT", 1, 0, "nil", [0, 2, 3])
    await d.wait_step("PREVOTE", height=1, round_=1)
    await d.settle()


async def _lock_no_pol(d):
    """Locked, without a new POL the node prevotes the locked block in round
    1, and after two nil prevotes and the prevote-wait timeout precommits nil
    while staying locked (state_test.go:343)."""
    await _lock_round0(d)
    await d.votes("PREVOTE", 1, 1, "nil", [0, 2])
    await d.wait_step("PRECOMMIT", height=1, round_=1)
    await d.settle()


async def _pol_relock(d):
    """A polka for the same block in round 1 relocks it (state_test.go:529)."""
    await _lock_round0(d)
    await d.votes("PREVOTE", 1, 1, "locked", [0, 2, 3])
    await d.wait_step("PRECOMMIT", height=1, round_=1)
    await d.settle()


async def _pol_unlock(d):
    """A nil polka in round 1 unlocks (state_test.go POLUnlock)."""
    await _lock_round0(d)
    await d.votes("PREVOTE", 1, 1, "nil", [0, 2, 3])
    await d.wait_step("PRECOMMIT", height=1, round_=1)
    await d.settle()


async def _propose_timeout(d):
    """No proposal arrives: the propose timeout gives a nil prevote."""
    await d.wait_step("PREVOTE", height=1)
    await d.settle()


async def _conflicting_votes(d):
    """Two prevotes of validator 2 for different blocks: DuplicateVoteEvidence
    in the pool."""
    await d.wait_step("PROPOSE", height=1)
    await d.settle()
    await d.votes("PREVOTE", 1, 0, FAKE_A, [2], raw=True)
    await d.votes("PREVOTE", 1, 0, FAKE_B, [2], raw=True)
    await d.settle(0.1)


async def _deferred_bad_signature(d):
    """Deferred verification: each drain's votes verified in one flush; the
    prevote and precommit of validator 3 carry a bad signature, are dropped
    at the flush, and the height still commits on the other three."""
    await d.wait_step("PROPOSE", height=1)
    await d.settle()
    await d.proposal()
    await d.settle()
    await d.votes("PREVOTE", 1, 0, "proposal", [0, 2, 3], bad=(3,))
    await d.votes("PRECOMMIT", 1, 0, "proposal", [0, 2, 3], bad=(3,))
    await d.wait_step("NEW_HEIGHT", height=2)
    await d.settle()


SCENARIOS = {
    "full_round": dict(fn=_full_round, own=0, txs=TXS),
    "lock_no_pol": dict(fn=_lock_no_pol, cfg_edit=_slow_propose),
    "pol_relock": dict(fn=_pol_relock, cfg_edit=_slow_propose),
    "pol_unlock_nil_polka": dict(fn=_pol_unlock, cfg_edit=_slow_propose),
    "propose_timeout_nil_prevote": dict(fn=_propose_timeout),
    "conflicting_votes_evidence": dict(fn=_conflicting_votes, cfg_edit=_slow_propose),
    "deferred_bad_signature": dict(fn=_deferred_bad_signature, defer=True,
                                   cfg_edit=_slow_propose, txs=TXS),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, tmp_path):
    sc = dict(SCENARIOS[name])
    fn = sc.pop("fn")
    vals = seeds(4, SEED)
    want, script, ref_node = run_scenario(REF, fn, vals, tmp_path, **sc)
    got, _, node = run_scenario(PORT, fn, vals, tmp_path, script=script, **sc)
    assert got == want
    assert not got["halted"]
    rs, jrs = node.cs.rs, ref_node.cs.rs
    assert (rs.locked_round, rs.valid_round) == (jrs.locked_round, jrs.valid_round)
    if name == "full_round":
        assert len(want["blocks"]) == 2 and want["steps"][-1] == (3, 0, "PROPOSE")
        assert node.app.size == ref_node.app.size == len(TXS)
    elif name == "lock_no_pol":
        assert rs.locked_block is not None and rs.locked_round == 0
        assert node.cs.rs.votes.precommits(1).get_by_index(1).block_id.is_zero()
    elif name == "pol_relock":
        assert rs.locked_round == 1
    elif name == "pol_unlock_nil_polka":
        assert rs.locked_block is None and rs.locked_round == -1
    elif name == "propose_timeout_nil_prevote":
        assert rs.votes.prevotes(0).get_by_index(1).block_id.is_zero()
    elif name == "conflicting_votes_evidence":
        assert len(want["evidence"]) == 1
        assert convert.evidence_from_reference(
            ref_node.evpool.pending_evidence(-1)[0]).encode() == got["evidence"][0]
    elif name == "deferred_bad_signature":
        commit = node.block_store.load_seen_commit(1)
        assert [s.absent() for s in commit.signatures] == [False, False, False, True]


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

N_WIDE = 300
_SIGNED: dict = {}  # (height, type, block hash) -> votes, signed once per module


def _wide_votes(node, type_name: str, height: int, block_id, idxs):
    """Votes of validators `idxs`, signed by the reference's keys (OpenSSL)
    on the port's sign bytes, and cached."""
    key = (height, type_name, block_id.hash)
    if key not in _SIGNED:
        out = []
        for i in idxs:
            pv = node.privs[i]
            v = PORT.vote.Vote(type=PORT.basic.SignedMsgType[type_name], height=height, round=0,
                               block_id=block_id, timestamp_ns=node.cs.state.last_block_time_ns
                               + 1_000_000 if height > 1 else FakeTime().now_ns,
                               validator_address=pv.get_pub_key().address(), validator_index=i)
            sig = REF.keys.gen_ed25519(pv.priv_key.bytes()).sign(v.sign_bytes(node.chain_id))
            out.append(PORT.vote.Vote.decode(v.with_signature(sig).encode()))
        _SIGNED[key] = out
    return _SIGNED[key]


def test_wide_height_flushes_on_the_card_arm_and_commit_check_hits_the_memo(tmp_path,
                                                                               monkeypatch):
    """300 validators, deferred verification, device="cpu", the memo on (as a
    node runs it). Each drain's votes are one flush of 299 or 300 rows on the
    card arm's plain kernels (LAST_FLUSH path "persig": the card arm below
    RLC_MIN rows, as the reference routes it); the height commits;
    height 2's proposal carries the LastCommit, which validate_block answers
    from the memo (path "memo") with no kernel launched."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    monkeypatch.setattr(tbatch, "_MEMO", tbatch.VerifiedRowMemo(65_536))
    clock = FakeTime()
    monkeypatch.setattr(PORT.cs_state, "time", clock)

    def cfg_edit(cfg):
        cfg.timeout_propose = cfg.timeout_prevote = cfg.timeout_precommit = 60.0

    node = Node(PORT, seeds(N_WIDE, SEED + 1), str(tmp_path / "wal"), defer=True, own=0,
                cfg_edit=cfg_edit, txs=TXS)
    flushes, checks = [], []
    vs_mod = PORT.cs_state.VoteSet.__module__
    import importlib

    vote_set = importlib.import_module(vs_mod)
    real_vb = vote_set.verify_batch

    def recorded_verify_batch(pks, *a, **k):
        out = real_vb(pks, *a, **k)
        flushes.append((len(pks), tbatch.LAST_FLUSH["path"]))
        return out

    monkeypatch.setattr(vote_set, "verify_batch", recorded_verify_batch)
    real_validate = node.block_exec.validate_block

    def validate(state, block, **k):
        cuda_fe.reset_launches()
        cuda_msm.reset_launches()
        tbatch.LAST_FLUSH.clear()
        real_validate(state, block, **k)
        checks.append((block.header.height, tbatch.LAST_FLUSH.get("path"),
                       sum(cuda_fe.LAUNCHES.values()) + sum(cuda_msm.LAUNCHES.values())))

    node.block_exec.validate_block = validate
    stubs = list(range(1, N_WIDE))

    async def main():
        cs = node.cs
        await cs.start()
        try:
            q = node.steps
            while True:  # height 1: the node proposes, then prevotes its block
                d = (await asyncio.wait_for(q.next(), 60)).data
                if d.step == "PREVOTE":
                    break
            bid = PORT.basic.BlockID(cs.rs.proposal_block.hash(),
                                     cs.rs.proposal_block_parts.header)
            for type_name in ("PREVOTE", "PRECOMMIT"):
                for v in _wide_votes(node, type_name, 1, bid, stubs):
                    await cs.add_peer_message(PORT.messages.VoteMessage(v), "stub")
                while cs._queue.qsize() or cs.rs.votes.has_pending():
                    await asyncio.sleep(0.05)
            while node.block_store.height < 1:
                await asyncio.sleep(0.05)
            clock.now_ns += 1_000_000_000
            step = PORT.round_state.RoundStepType
            while not (cs.rs.height == 2 and cs.rs.step >= step.PROPOSE):
                await asyncio.sleep(0.05)
            if cs.rs.proposal_block is None:  # another validator proposes height 2
                idx = node.proposer_idx()
                block = node.block_exec.create_proposal_block(
                    2, cs.state, cs.rs.last_commit.make_commit(),
                    cs.rs.validators.validators[idx].address, clock.now_ns)
                parts = PORT.part_set.PartSet.from_data(block.encode())
                prop = PORT.proposal.Proposal(
                    2, 0, -1, PORT.basic.BlockID(block.hash(), parts.header), clock.now_ns)
                prop = prop.with_signature(REF.keys.gen_ed25519(
                    node.privs[idx].priv_key.bytes()).sign(prop.sign_bytes(node.chain_id)))
                await cs.add_peer_message(PORT.messages.ProposalMessage(prop), "stub")
                for i in range(parts.total):
                    await cs.add_peer_message(
                        PORT.messages.BlockPartMessage(2, 0, parts.get_part(i)), "stub")
            while not (cs.rs.height == 2 and cs.rs.step >= step.PREVOTE):
                await asyncio.sleep(0.05)
            while cs._queue.qsize() or cs.rs.votes.has_pending():
                await asyncio.sleep(0.05)
        finally:
            await cs.stop()

    asyncio.run(main())
    assert node.cs.halt_error is None
    wide = [f for f in flushes if f[0] >= 256]
    assert len(wide) == 2 and all(path == "persig" for _, path in wide), flushes
    assert tbatch.RLC_MIN > max(n for n, _ in wide)
    assert sum(n for n, _ in flushes) >= 2 * N_WIDE
    commit = node.block_store.load_seen_commit(1)
    assert sum(not s.absent() for s in commit.signatures) == N_WIDE
    assert [c for c in checks if c[0] == 2] == [(2, "memo", 0)], checks
    rs = node.cs.rs
    assert rs.votes.prevotes(0).get_by_index(0).block_id.hash == rs.proposal_block.hash()


def test_device_error_in_the_deferred_flush_halts_consensus(tmp_path, monkeypatch):
    """A flush that raises (a device fault) halts the receive loop: the error
    is kept, the loop stops, nothing commits, and no row is verified any
    other way (no host fallback)."""
    import importlib

    vote_set = importlib.import_module(PORT.cs_state.VoteSet.__module__)
    calls = []

    def device_fault(*a, **k):
        calls.append(len(a[0]))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(vote_set, "verify_batch", device_fault)
    host = []
    monkeypatch.setattr(tbatch, "verify_batch_cpu",
                        lambda *a, **k: host.append(1) or (_ for _ in ()).throw(AssertionError))
    node = Node(PORT, seeds(4, SEED), str(tmp_path / "wal"), defer=True, own=0)

    async def main():
        await node.cs.start()
        try:
            await asyncio.wait_for(node.cs.wait_until_stopped(), 30)
        finally:
            await node.cs.stop()

    asyncio.run(main())
    assert isinstance(node.cs.halt_error, RuntimeError)
    assert calls and not host
    assert node.block_store.height == 0


def test_handshaker_restarts_the_port_from_reference_stores_and_wal(tmp_path):
    """A one-validator chain of the JAX package commits 3 heights (or a few
    more before it stops) into SQLite stores and a WAL; the port opens them,
    replays the blocks into a fresh kvstore app (the same app hash), and its
    ConsensusState resumes at the next height."""
    db = tmp_path / "db"
    wal = str(tmp_path / "wal")
    val = seeds(1, SEED + 2)
    ref_db = lambda name: REF.kvdb.SQLiteDB(str(db / f"{name}.db"))  # noqa: E731
    jnode = Node(REF, val, wal, db=ref_db, own=0, txs=TXS)

    async def run_ref():
        await jnode.cs.start()
        try:
            while jnode.block_store.height < 3:
                await asyncio.sleep(0.02)
        finally:
            await jnode.cs.stop()

    asyncio.run(run_ref())
    jstate = jnode.state_store.load()
    top = jstate.last_block_height
    assert top >= 3 and jnode.block_store.height == top and jnode.app.size == len(TXS)

    P = PORT
    state_store = P.state_store.StateStore(P.kvdb.SQLiteDB(str(db / "state.db")))
    block_store = P.blockstore.BlockStore(P.kvdb.SQLiteDB(str(db / "blocks.db")))
    state = state_store.load()
    assert state.to_json() == jstate.to_json()
    gen = convert.genesis_from_reference(REF.genesis.GenesisDoc(
        chain_id=jnode.chain_id, validators=[REF.genesis.GenesisValidator(
            jnode.privs[0].get_pub_key(), 10)]))
    app = P.kvstore.KVStoreApplication()
    proxy = P.multi.AppConns(P.multi.local_client_creator(app))
    hs = P.replay.Handshaker(state_store, state, block_store, gen, device="cpu")
    state = hs.handshake(proxy)
    assert hs.n_blocks == top
    assert app.app_hash == jnode.app.app_hash == state.app_hash
    mempool = P.mempool.Mempool(proxy.mempool)
    evpool = P.evidence_pool.EvidencePool(P.kvdb.MemDB(), state_store, block_store)
    ex = P.execution.BlockExecutor(state_store, proxy.consensus, mempool, evpool,
                                   block_store=block_store, device="cpu")
    cfg = convert.consensus_config_from_reference(jnode.cs.config)
    cs = P.cs_state.ConsensusState(cfg, state, ex, block_store, mempool, evpool,
                                   P.wal.WAL(wal), priv_validator=convert.file_pv_from_reference(
                                       jnode.privs[0]), device="cpu")
    assert cs.rs.height == top + 1 and cs.rs.last_commit.has_two_thirds_majority()

    async def run_port():
        await cs.start()
        try:
            while cs.rs.step.name == "NEW_HEIGHT":
                await asyncio.sleep(0.02)
        finally:
            await cs.stop()

    asyncio.run(run_port())
    assert cs.halt_error is None and cs.rs.height >= top + 1
    assert block_store.load_block(top).hash() == jnode.block_store.load_block(top).hash()
