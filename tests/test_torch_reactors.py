"""The port's reactors' own units, tolerance 0.

Port only, the reference's tests on the port's modules:
tests/test_reactor_gossip_coalescing.py:79-138 (HasVote broadcasts coalesce
per drain, only the latest round step is broadcast, pick_votes_to_send) and
tests/test_blocksync_pipeline.py:38-345 (the pool's requeue and dedup under
a flaky peer, redo, scoring, backoff and ban, the checkpoint and its
resume, and a plaintext end-to-end pipeline sync between two port nodes).
The two serve-fault tests there (:368-402) import chaos/catchup.py, which
the port has not taken yet (ROADMAP A5).

Beside the reference: the blocksync messages, the mempool and evidence
reactors' list codecs, and BitArray give equal bytes in both packages, and
each decodes the other's.

No fallback (ROADMAP D1): a catch-up flush that raises reaches
Node.wait_for_height and Node.stop; an admission flush that raises under a
gossiped batch is logged by the mempool reactor and no tx is admitted or
verified on the host.
"""

import asyncio
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_p2p_util import PORT, REF, make_node, run

BS_POOL = PORT.bs_pool
SEED = 20261018


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


# -- tests/test_reactor_gossip_coalescing.py on the port -----------------------

BID = PORT.basic.BlockID(b"\x01" * 32, PORT.basic.PartSetHeader(1, b"\x02" * 32))


def make_vote(i, height=5, round_=0, type_=PORT.basic.SignedMsgType.PREVOTE):
    return PORT.vote.Vote(type=type_, height=height, round=round_, block_id=BID,
                          timestamp_ns=1, validator_address=bytes([i]) * 20,
                          validator_index=i, signature=b"\x55" * 64)


class StubSwitch:
    def __init__(self):
        self.single = []
        self.batches = []
        self.peers = SimpleNamespace(list=lambda: [])

    async def broadcast(self, chan_id, msg):
        self.single.append((chan_id, msg))

    async def broadcast_many(self, chan_id, msgs):
        self.batches.append((chan_id, list(msgs)))


class StubVoteSet:
    def __init__(self, votes, height=5, round_=0, type_=PORT.basic.SignedMsgType.PREVOTE):
        self._votes = votes
        self.height = height
        self.round = round_
        self.signed_msg_type = type_

    def size(self):
        return len(self._votes)

    def bit_array(self):
        return [v is not None for v in self._votes]

    def get_by_index(self, idx):
        return self._votes[idx]


def make_reactor():
    RST = PORT.round_state.RoundStepType
    rs = SimpleNamespace(height=5, round=0, step=RST.PREVOTE, start_time_ns=0,
                         last_commit=None, proposal_block_parts=None)
    cs = SimpleNamespace(event_bus=PORT.event_bus.EventBus(), rs=rs)
    reactor = PORT.cs_reactor.ConsensusReactor(cs)
    reactor.set_switch(StubSwitch())
    return reactor


def test_hasvote_broadcasts_coalesce_per_drain():
    M = PORT.cs_messages

    async def go():
        reactor = make_reactor()
        await reactor.start()
        try:
            await asyncio.sleep(0.05)
            reactor.cs.event_bus.publish_votes([make_vote(i) for i in range(20)])
            await asyncio.sleep(0.1)
            sw = reactor.switch
            assert [b for b in sw.batches if len(b[1]) > 1]
            decoded = [M.decode_message(p) for _, msgs in sw.batches for p in msgs]
            decoded += [M.decode_message(p) for _, p in sw.single]
            has_votes = [m for m in decoded if isinstance(m, M.HasVoteMessage)]
            assert sorted(m.index for m in has_votes) == list(range(20))
            assert len(sw.batches) + len(sw.single) < 20
        finally:
            await reactor.stop()

    run(go(), 20)


def test_round_step_broadcast_sends_only_latest_state():
    M = PORT.cs_messages
    RST = PORT.round_state.RoundStepType

    async def go():
        reactor = make_reactor()
        await reactor.start()
        try:
            await asyncio.sleep(0.05)
            for step in ("PROPOSE", "PREVOTE", "PRECOMMIT"):
                reactor.cs.event_bus.publish_round_state("NewRoundStep", 5, 0, step)
            reactor.cs.rs.step = RST.PRECOMMIT
            await asyncio.sleep(0.1)
            steps = [M.decode_message(p) for _, p in reactor.switch.single]
            steps = [m for m in steps if isinstance(m, M.NewRoundStepMessage)]
            assert steps and len(steps) < 3
            assert steps[-1].step == int(RST.PRECOMMIT)
        finally:
            await reactor.stop()

    run(go(), 20)


def test_pick_votes_to_send_batches_and_respects_limit():
    votes = [make_vote(i) if i % 2 == 0 else None for i in range(40)]
    vs = StubVoteSet(votes)
    ps = PORT.cs_reactor.PeerState("peer-x")
    ps.height, ps.round = 5, 0
    assert [v.validator_index for v in ps.pick_votes_to_send(vs, limit=8)] == \
        [0, 2, 4, 6, 8, 10, 12, 14]
    for idx in (0, 2, 4):
        ps.set_has_vote(5, 0, PORT.basic.SignedMsgType.PREVOTE, idx, 40)
    assert [v.validator_index for v in ps.pick_votes_to_send(vs, limit=8)] == \
        [6, 8, 10, 12, 14, 16, 18, 20]
    assert ps.pick_vote_to_send(vs).validator_index == 6
    assert ps.pick_votes_to_send(StubVoteSet([])) == []


# -- tests/test_blocksync_pipeline.py on the port -------------------------------


def _metrics():
    return PORT.metrics.BlockSyncMetrics(PORT.metrics.Registry())


def _counter_val(c):
    return c._values.get((), 0.0)


def _fake_block(height):
    return SimpleNamespace(header=SimpleNamespace(height=height))


def test_pool_flaky_peer_no_skip_no_dup():
    async def go():
        sent, punished = [], []

        async def send_request(peer_id, height):
            sent.append((peer_id, height))
            if peer_id == "good":
                async def deliver(h=height):
                    await asyncio.sleep(0.01)
                    pool.add_block("good", _fake_block(h))

                asyncio.get_running_loop().create_task(deliver())

        async def punish(peer_id, reason):
            punished.append((peer_id, reason))

        pool = BS_POOL.BlockPool(1, send_request, punish, metrics=_metrics(),
                                 peer_timeout=0.15, retry_sleep=0.01)
        pool.set_peer_range("good", 1, 40)
        pool.set_peer_range("flaky", 1, 40)
        pool.start()
        applied = []
        try:
            while len(applied) < 20:
                b = pool.get_block(pool.height)
                if b is not None:
                    applied.append(b.header.height)
                    pool.pop_request()
                await asyncio.sleep(0.005)
        finally:
            pool.stop()
        assert applied == list(range(1, 21))
        flaky = pool._peers.get("flaky")
        if flaky is not None:
            assert flaky.pending == 0 and flaky.timeouts > 0 and flaky.score < 1.0
        else:
            assert any(p == "flaky" for p, _ in punished)
        good = pool._peers["good"]
        assert good.blocks_served >= 20 and good.score > 0.9

    run(go(), 30)


def test_redo_request_releases_pending_and_requeues():
    async def go():
        sent = []

        async def send_request(peer_id, height):
            sent.append((peer_id, height))

        async def punish(peer_id, reason):
            pass

        m = _metrics()
        pool = BS_POOL.BlockPool(5, send_request, punish, metrics=m, peer_timeout=5.0,
                                 retry_sleep=0.01)
        pool.set_peer_range("p1", 1, 40)
        pool.start()
        try:
            while ("p1", 5) not in sent or ("p1", 6) not in sent:
                await asyncio.sleep(0.01)
            p1 = pool._peers["p1"]
            pending_before = p1.pending
            assert pending_before >= 2
            assert pool.add_block("p1", _fake_block(5))
            assert pool.redo_request(5) == "p1"
            assert p1.bad_blocks == 1 and p1.score < 1.0
            assert pool.redo_request(6) == "p1"
            assert p1.pending == pending_before - 2
            assert pool.get_block(5) is None and pool.get_block(6) is None
            assert _counter_val(m.redos_total) == 2
            p1.backoff_until = 0.0
            while sent.count(("p1", 5)) < 2 or sent.count(("p1", 6)) < 2:
                await asyncio.sleep(0.01)
        finally:
            pool.stop()

    run(go(), 20)


def test_peer_scoring_backoff_and_ban():
    p = BS_POOL._PoolPeer("x", base=1, height=100)
    assert p.score == 1.0
    p.record_failure()
    assert p.score < 1.0 and p.backoff_until > time.monotonic()
    first_backoff = p.backoff_until
    p.record_failure()
    assert p.backoff_until >= first_backoff
    p.record_good(0.05)
    assert p.failures == 0 and p.backoff_until == 0.0
    for _ in range(20):
        p.record_failure()
    assert p.banned() and p.score < BS_POOL.BAN_THRESHOLD


def test_pick_peer_respects_backoff_and_weights():
    async def go():
        async def noop(*a):
            pass

        pool = BS_POOL.BlockPool(1, noop, noop)
        pool.set_peer_range("a", 1, 50)
        pool.set_peer_range("b", 1, 50)
        pa, pb = pool._peers["a"], pool._peers["b"]
        pb.backoff_until = time.monotonic() + 60
        assert all(pool._pick_peer(10).peer_id == "a" for _ in range(20))
        pb.backoff_until = 0.0
        pb.score = 0.05
        picks = [pool._pick_peer(10).peer_id for _ in range(400)]
        assert picks.count("a") > picks.count("b") * 3

    run(go(), 10)


def test_ban_punishes_and_removes():
    async def go():
        punished = []

        async def noop(*a):
            pass

        async def punish(peer_id, reason):
            punished.append(peer_id)

        pool = BS_POOL.BlockPool(1, noop, punish)
        pool.set_peer_range("bad", 1, 50)
        p = pool._peers["bad"]
        for _ in range(20):
            p.record_failure()
        assert await pool._ban_if_bad(p, "test")
        assert punished == ["bad"] and pool.num_peers() == 0

    run(go(), 10)


def _mk_chain(start, n, P=PORT, chain_id="ckpt-chain"):
    """A hash-linked run of minimal (but encode/decode-true) blocks."""
    B, T = P.block, P.basic
    blocks = []
    prev_hash = b"\xaa" * 32
    for h in range(start, start + n):
        commit = B.Commit(
            height=h - 1, round=0,
            block_id=T.BlockID(prev_hash, T.PartSetHeader(1, b"\xbb" * 32)),
            signatures=(B.CommitSig(T.BlockIDFlag.COMMIT, b"\x01" * 20, 7, b"\x02" * 64),))
        header = B.Header(
            version=B.ConsensusVersion(), chain_id=chain_id, height=h, time_ns=1_000_000 * h,
            last_block_id=T.BlockID(prev_hash, T.PartSetHeader(1, b"\xbb" * 32)),
            last_commit_hash=b"\xcc" * 32, data_hash=b"\xdd" * 32,
            validators_hash=b"\xee" * 32, next_validators_hash=b"\xee" * 32,
            consensus_hash=b"\xff" * 32, app_hash=b"\x11" * 32,
            last_results_hash=b"\x22" * 32, evidence_hash=b"\x33" * 32,
            proposer_address=b"\x44" * 20)
        b = B.Block(header=header, txs=(), evidence=(), last_commit=commit)
        blocks.append(b)
        prev_hash = b.hash()
    return blocks


def test_checkpoint_roundtrip_and_linkage(tmp_path):
    CK = PORT.bs_checkpoint.CatchupCheckpoint
    path = str(tmp_path / "catchup.json")
    ck = CK(path)
    blocks = _mk_chain(5, 4)
    ck.save(4, blocks)
    loaded = ck.load(4)
    assert [b.header.height for b in loaded] == [5, 6, 7, 8]
    assert [b.hash() for b in loaded] == [b.hash() for b in blocks]
    assert [b.header.height for b in ck.load(6)] == [7, 8]
    assert ck.load(9) == [] and ck.load(2) == []
    payload = json.loads(open(path).read())
    payload["blocks"][1] = _mk_chain(6, 1, chain_id="evil")[0].encode().hex()
    open(path, "w").write(json.dumps(payload))
    assert ck.load(4) == []
    open(path, "w").write("{not json")
    assert ck.load(4) == []
    ck.clear()
    assert ck.load(4) == []
    off = CK(None)
    off.save(1, blocks)
    assert off.load(1) == []


def test_checkpoint_file_crosses_packages(tmp_path):
    """A checkpoint the reference wrote loads in the port, block for block."""
    path = str(tmp_path / "catchup.json")
    ref_blocks = _mk_chain(5, 4, P=REF)
    REF.bs_checkpoint.CatchupCheckpoint(path).save(4, ref_blocks)
    loaded = PORT.bs_checkpoint.CatchupCheckpoint(path).load(4)
    assert [b.encode() for b in loaded] == [b.encode() for b in ref_blocks]


def test_resume_applies_without_reverifying(tmp_path):
    blocks = _mk_chain(5, 4)
    path = str(tmp_path / "catchup.json")
    PORT.bs_checkpoint.CatchupCheckpoint(path).save(4, blocks)
    applied = []

    class _Vals:
        def hash(self):
            return b"\xee" * 32

    class _Exec:
        def apply_block(self, state, block_id, block, trust_last_commit=False):
            applied.append((block.header.height, trust_last_commit))
            return SimpleNamespace(last_block_height=block.header.height,
                                   last_block_id=block_id, validators=_Vals())

    class _Store:
        saved = []

        def save_block(self, block, parts, commit):
            self.saved.append(block.header.height)

    state = SimpleNamespace(
        last_block_height=4,
        last_block_id=SimpleNamespace(hash=blocks[0].header.last_block_id.hash),
        validators=_Vals())
    m = _metrics()
    r = PORT.bs_reactor.BlocksyncReactor(state, _Exec(), _Store(), active=True, metrics=m,
                                         checkpoint_path=path)
    called = []
    r._verify_run_batched = lambda *a, **k: called.append(a) or None
    r._resume_from_checkpoint()
    assert [h for h, _ in applied] == [5, 6, 7]
    assert all(trust for _, trust in applied) and called == []
    assert r.state.last_block_height == 7
    assert _counter_val(m.resume_events_total) == 1
    assert _counter_val(m.blocks_applied_total) == 3


def test_resume_rejects_foreign_chain(tmp_path):
    blocks = _mk_chain(5, 3)
    path = str(tmp_path / "catchup.json")
    PORT.bs_checkpoint.CatchupCheckpoint(path).save(4, blocks)
    state = SimpleNamespace(last_block_height=4,
                            last_block_id=SimpleNamespace(hash=b"\x66" * 32),
                            validators=SimpleNamespace(hash=lambda: b"\xee" * 32))
    r = PORT.bs_reactor.BlocksyncReactor(state, None, None, active=True, checkpoint_path=path)
    r._resume_from_checkpoint()
    assert r.state.last_block_height == 4 and not os.path.exists(path)


def test_pipeline_sync_e2e_plaintext(tmp_path):
    """A fresh port node catches up from a port validator through the
    three-stage pipeline over the plaintext transport: blocks equal, the
    run's rows recorded, the handoff to consensus fires, the checkpoint is
    cleared after it."""

    def edit_syncer(cfg):
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False
        cfg.root_dir = str(tmp_path / "syncer")
        os.makedirs(os.path.join(cfg.root_dir, "data"), exist_ok=True)

    def edit_source(cfg):
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False
        # ~5 heights a second: the syncer's head does not run away from it
        cfg.consensus.skip_timeout_commit = False
        cfg.consensus.timeout_commit = 0.2

    async def go():
        source = make_node(PORT, tmp_path, "source", "pipe-chain", 1, val=0, edit=edit_source)
        syncer = make_node(PORT, tmp_path, "syncer", "pipe-chain", 1, edit=edit_syncer)
        try:
            await source.start()
            await source.wait_for_height(8, timeout=30)
            await syncer.start()
            assert syncer.fast_sync is True
            ckpt_path = syncer.blocksync_reactor.checkpoint.path
            assert ckpt_path
            await syncer.switch.dial_peers_async(
                [f"{source.node_key.id}@{source.p2p_addr}"], persistent=True)
            await syncer.wait_for_height(8, timeout=30)
            for h in (2, 5, 8):
                assert syncer.block_store.load_block(h).hash() == \
                    source.block_store.load_block(h).hash()
            await asyncio.wait_for(syncer.blocksync_reactor.synced.wait(), 15)
            sb = syncer.metrics.blocksync.super_batch_rows
            assert sb._totals.get((), 0) >= 1 and sb._sums.get((), 0.0) > 0
            assert not os.path.exists(ckpt_path)
            await syncer.wait_for_height(source.block_store.height + 2, timeout=30)
        finally:
            await syncer.stop()
            await source.stop()

    run(go(), 80)


# -- bytes beside the reference ------------------------------------------------


def _commit_block(P):
    """A block whose last_commit carries three signatures, built in P."""
    return _mk_chain(9, 1, P=P, chain_id="bytes-chain")[0]


@pytest.mark.parametrize("kind", ["block_request", "no_block_response", "block_response",
                                  "status_request", "status_response"])
def test_blocksync_messages_bytes(kind):
    def msg(P):
        M = P.bs_messages
        return {
            "block_request": lambda: M.BlockRequest(17),
            "no_block_response": lambda: M.NoBlockResponse(18),
            "block_response": lambda: M.BlockResponse(_commit_block(P)),
            "status_request": lambda: M.StatusRequest(),
            "status_response": lambda: M.StatusResponse(1234, 7),
        }[kind]()

    ref = REF.bs_messages.encode_message(msg(REF))
    port = PORT.bs_messages.encode_message(msg(PORT))
    assert port == ref
    assert PORT.bs_messages.encode_message(PORT.bs_messages.decode_message(ref)) == ref
    assert REF.bs_messages.encode_message(REF.bs_messages.decode_message(port)) == port


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 100, 10_000])
def test_bit_array_bytes(n):
    rng = np.random.default_rng(SEED + n)
    bools = [bool(b) for b in rng.integers(0, 2, n)]
    ref = REF.bits.BitArray.from_bools(bools)
    port = PORT.bits.BitArray.from_bools(bools)
    assert port.to_bytes() == ref.to_bytes()
    assert convert.bit_array_from_reference(ref) == port
    assert port.get_true_indices() == ref.get_true_indices()
    other = [bool(b) for b in rng.integers(0, 2, n)]
    for op in ("or_", "and_", "sub"):
        r = getattr(ref, op)(REF.bits.BitArray.from_bools(other))
        p = getattr(port, op)(PORT.bits.BitArray.from_bools(other))
        assert p.to_bytes() == r.to_bytes(), op
    assert port.not_().to_bytes() == ref.not_().to_bytes()


def test_gossip_list_codecs_bytes():
    rng = np.random.default_rng(SEED)
    txs = [rng.bytes(int(k)) for k in rng.integers(0, 300, 40)] + [b""]
    assert PORT.mp_reactor.encode_txs(txs) == REF.mp_reactor.encode_txs(txs)
    assert PORT.mp_reactor.decode_txs(REF.mp_reactor.encode_txs(txs)) == txs
    keys = [REF.keys.gen_ed25519(bytes([40 + i]) * 32) for i in range(2)]
    T = REF.basic

    def vote(i, bid):
        import dataclasses

        v = REF.vote.Vote(type=T.SignedMsgType.PREVOTE, height=3, round=0, block_id=bid,
                          timestamp_ns=1_700_000_000_000_000_000 + i,
                          validator_address=keys[0].pub_key().address(), validator_index=0)
        return dataclasses.replace(v, signature=keys[0].sign(v.sign_bytes("ev-chain")))

    bid_a = T.BlockID(b"\x0a" * 32, T.PartSetHeader(1, b"\x0b" * 32))
    bid_b = T.BlockID(b"\x0c" * 32, T.PartSetHeader(1, b"\x0d" * 32))
    ev = REF.evidence.DuplicateVoteEvidence.from_votes(vote(0, bid_a), vote(1, bid_b),
                                                       1_700_000_000, 20, 10)
    pev = convert.evidence_from_reference(ev)
    ref_bytes = REF.ev_reactor.encode_evidence_list([ev])
    assert PORT.ev_reactor.encode_evidence_list([pev]) == ref_bytes
    assert [e.hash() for e in PORT.ev_reactor.decode_evidence_list(ref_bytes)] == [pev.hash()]


# -- no fallback ---------------------------------------------------------------


class _Broken:
    """A scheduler whose lanes raise, as a device error does."""

    closed = False

    def verify_rows(self, *a, **kw):
        raise RuntimeError("device on fire")

    def close(self):
        pass


def test_catchup_device_error_reaches_wait_for_height(tmp_path):
    """A catch-up flush that raises ends the verify stage: the syncer's
    Node keeps the error, wait_for_height and stop raise it, no block is
    applied, and nothing verifies on the host instead."""

    def plain(cfg):
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False

    async def go():
        source = make_node(PORT, tmp_path, "source", "dev-err-chain", 1, val=0, edit=plain)
        syncer = make_node(PORT, tmp_path, "syncer", "dev-err-chain", 1, edit=plain)
        syncer.blocksync_reactor.scheduler = _Broken()
        host_calls = []
        orig = PORT.bs_reactor.verify_run_batched

        def spy(*a, **kw):
            host_calls.append(kw.get("scheduler"))
            return orig(*a, **kw)

        PORT.bs_reactor.verify_run_batched = spy
        try:
            await source.start()
            await source.wait_for_height(4, timeout=30)
            await syncer.start()
            await syncer.switch.dial_peers_async([f"{source.node_key.id}@{source.p2p_addr}"])
            with pytest.raises(RuntimeError, match="catch-up verification failed") as ei:
                await syncer.wait_for_height(3, timeout=30)
            assert isinstance(ei.value.__cause__, RuntimeError)
            assert "device on fire" in str(ei.value.__cause__)
            assert syncer.block_store.height == 0
            assert all(isinstance(s, _Broken) for s in host_calls) and len(host_calls) == 1
        finally:
            PORT.bs_reactor.verify_run_batched = orig
            await source.stop()
        with pytest.raises(RuntimeError, match="catch-up verification failed"):
            await syncer.stop()

    run(go(), 60)


def test_gossiped_batch_device_error_is_logged_not_verified(caplog):
    """The mempool reactor's hop: check_tx_batch raises (the admission
    lane failed); the reactor logs it, admits nothing, and the app verifies
    nothing on the host."""
    txs = [REF.signed_tx.encode_signed_tx(REF.keys.gen_ed25519(b"\x2a" * 32), b"k%d=v" % i)
           for i in range(3)]
    app = PORT.kvstore.SignedKVStoreApplication()
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.mempool.mempool import Mempool

    mp = Mempool(LocalClient(app), scheduler=_Broken(), sig_precheck=True)
    reactor = PORT.mp_reactor.MempoolReactor(mp)
    peer = SimpleNamespace(id="ab" * 20)
    import logging

    with caplog.at_level(logging.DEBUG, logger="tendermint_tpu_torch.mempool"):
        run(reactor.receive(PORT.mp_reactor.MEMPOOL_CHANNEL, peer,
                            PORT.mp_reactor.encode_txs(txs)), 10)
    assert mp.size() == 0 and app.serial_verifies == 0 and app.precheck_consumed == 0
    assert any("device on fire" in r.getMessage() for r in caplog.records)


def test_syncing_node_announces_its_round_state_at_the_handoff():
    """While wait_sync, the port's consensus reactor tells a new peer
    nothing (Go consensus/reactor.go AddPeer), and switch_to_consensus
    broadcasts the round state; the reference announces it at add_peer,
    so its peers start consensus catch-up gossip to a node that drops it
    while syncing (ROADMAP C)."""

    class Peer:
        id = "cd" * 20

        def __init__(self):
            self.sent, self.data = [], {}

        async def send(self, chan, msg):
            self.sent.append(chan)
            return True

        def set(self, k, v):
            self.data[k] = v

        def get(self, k):
            return self.data.get(k)

    def reactor(P):
        rs = SimpleNamespace(height=3, round=0, step=P.round_state.RoundStepType.NEW_HEIGHT,
                             start_time_ns=0, last_commit=None)

        async def start():
            pass

        cs = SimpleNamespace(rs=rs, start=start)
        r = P.cs_reactor.ConsensusReactor(cs, wait_sync=True)
        sw = StubSwitch()
        r.set_switch(sw)
        return r, sw

    async def go(P):
        r, sw = reactor(P)
        peer = Peer()
        await r.add_peer(peer)
        before = list(peer.sent)
        await r.switch_to_consensus(None)
        await r.stop()
        return before, [c for c, _ in sw.single]

    assert run(go(REF), 10) == ([PORT.cs_reactor.STATE_CHANNEL], [])
    assert run(go(PORT), 10) == ([], [PORT.cs_reactor.STATE_CHANNEL])
