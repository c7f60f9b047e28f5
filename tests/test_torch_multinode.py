"""Nets of port nodes, and nets of port and reference nodes, over real
sockets on 127.0.0.1, tolerance 0.

Port only: tests/test_multinode.py:97-335 on nets of the port's Nodes
(device="cpu", secret connections): four validators commit; a tx gossiped
from one node commits; a late validator catches up by consensus gossip; an
equivocator's DuplicateVoteEvidence is committed, with vote verification
immediate and with it deferred (the deferred flush is the card's path).

Across the packages (secret connections, all nodes in one event loop, the
reference on its host arm):
- a mixed net of 2 reference and 2 port validators (power 10 each) reaches
  height 5 with the same block hash and app hash at every height;
- a tx broadcast to a reference node commits, and the port nodes' stores
  hold it;
- on a signed_kvstore net, a reference node gossips signed txs (3 with bad
  signatures) to a port full node and a reference full node: both admit
  the same txs with the same codes through their admission lanes, in one
  lane flush whose rows carry the sender's peer ID (sender:<id>), with the
  same precheck_consumed / serial_verifies counters and the same suspicion
  record of that source;
- a fresh port node fast-syncs 8 heights from a reference validator, and a
  fresh reference node from a port validator: the stores are equal block
  for block and consensus takes over;
- a reference node with statesync on dials a port node: the port node's
  statesync reactor answers the reference's SnapshotsRequest on channel
  0x60 with its snapshots and keeps the peer (a port node without a
  statesync reactor dropped the peer on the unknown channel, ROADMAP C6);
- an equivocator in a mixed net: its DuplicateVoteEvidence reaches both
  packages' pools and is committed.

Every net test has a hard timeout of its own, and waits are bounded by
chain progress (tests/torch_p2p_util.py).
"""

import asyncio
import dataclasses
import time

import pytest

pytest.importorskip("cryptography")

from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_p2p_util import (
    P_OF,
    PORT,
    REF,
    addr_of,
    block_in_store,
    make_net,
    make_node,
    run,
    start_and_connect,
    stop_all,
    wait_until,
)


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _same_chain(nodes, upto):
    """(block hash, app hash) per height, as the set over the nodes."""
    return [{(n.block_store.load_block(h).hash(), n.block_store.load_block(h).header.app_hash)
             for n in nodes} for h in range(1, upto + 1)]


def _install_equivocator(byz):
    """The node's prevote step also signs a prevote for a made-up block
    with its raw key and broadcasts it (tests/test_multinode.py:180)."""
    P = PORT if byz.__class__.__module__.startswith("tendermint_tpu_torch") else REF
    cs = byz.consensus
    orig = cs._default_do_prevote

    def byz_do_prevote(height, round_):
        orig(height, round_)
        T = P.basic
        addr = byz.priv_validator.get_pub_key().address()
        idx, _ = cs.rs.validators.get_by_address(addr)
        vote = P.vote.Vote(type=T.SignedMsgType.PREVOTE, height=height, round=round_,
                           block_id=T.BlockID(b"\x42" * 32, T.PartSetHeader(1, b"\x42" * 32)),
                           timestamp_ns=time.time_ns(), validator_address=addr,
                           validator_index=idx)
        sig = byz.priv_validator.priv_key.sign(vote.sign_bytes(cs.state.chain_id))
        vote = dataclasses.replace(vote, signature=sig)
        msg = P.cs_messages.encode_message(P.cs_messages.VoteMessage(vote))
        asyncio.ensure_future(byz.switch.broadcast(P.cs_reactor.VOTE_CHANNEL, msg))

    cs.do_prevote = byz_do_prevote


def _committed_evidence(node, byz_addr):
    for h in range(1, node.block_store.height + 1):
        b = node.block_store.load_block(h)
        if b is not None and len(b.evidence) > 0:
            ev = b.evidence[0]
            assert ev.vote_a.height == ev.vote_b.height
            assert ev.vote_a.validator_address == byz_addr
            return ev
    return None


# -- tests/test_multinode.py on port nets -------------------------------------


def test_four_validator_port_net_commits_blocks(tmp_path):
    async def go():
        nodes = make_net(["port"] * 4, tmp_path, chain="port-net")
        try:
            await start_and_connect(nodes)
            await asyncio.gather(*(n.wait_for_height(5, timeout=30) for n in nodes))
            h = min(n.block_store.height for n in nodes)
            assert len({n.block_store.load_block(h - 1).hash() for n in nodes}) == 1
            commit = nodes[0].block_store.load_seen_commit(h - 1)
            assert sum(1 for s in commit.signatures if not s.absent()) >= 3
        finally:
            await stop_all(nodes)

    run(go(), 60)


def test_port_net_commits_txs_via_gossip(tmp_path):
    async def go():
        nodes = make_net(["port"] * 3, tmp_path, chain="gossip-chain")
        try:
            await start_and_connect(nodes)
            await asyncio.gather(*(n.wait_for_height(1, timeout=30) for n in nodes))
            nodes[2].mempool.check_tx(b"gossip=works")
            await wait_until(lambda: any(block_in_store(n, b"gossip=works") for n in nodes),
                             nodes, max_new_heights=12)
        finally:
            await stop_all(nodes)

    run(go(), 60)


def test_port_node_catches_up_after_late_join(tmp_path):
    async def go():
        nodes = make_net(["port"] * 4, tmp_path, chain="latejoin-chain")
        late, early = nodes[3], nodes[:3]
        try:
            await start_and_connect(early)
            await asyncio.gather(*(n.wait_for_height(3, timeout=30) for n in early))
            await late.start()
            await late.switch.dial_peers_async([addr_of(early[0])], persistent=True)
            await late.wait_for_height(3, timeout=30)
            assert late.block_store.load_block(2).hash() == \
                early[0].block_store.load_block(2).hash()
        finally:
            await stop_all(nodes)

    run(go(), 60)


@pytest.mark.parametrize("defer", [False, True], ids=["immediate", "deferred"])
def test_port_equivocator_produces_evidence(defer, tmp_path):
    """(tests/test_multinode.py:180 and :259) With deferred verification the
    net stays live and the conflict, found at flush time, still becomes
    DuplicateVoteEvidence."""

    async def go():
        nodes = make_net(["port"] * 4, tmp_path, chain="byz-chain", defer_votes=defer)
        byz = nodes[0]
        byz_addr = byz.priv_validator.get_pub_key().address()
        try:
            await start_and_connect(nodes)
            _install_equivocator(byz)
            if defer:
                await asyncio.gather(*(n.wait_for_height(4, timeout=30) for n in nodes))
            await wait_until(lambda: any(_committed_evidence(n, byz_addr) for n in nodes[1:]),
                             nodes, max_new_heights=15)
            assert all(getattr(n.consensus, "halt_error", None) is None for n in nodes)
        finally:
            await stop_all(nodes)

    run(go(), 80)


# -- across the packages ------------------------------------------------------


def test_mixed_net_commits_with_equal_hashes(tmp_path):
    """2 reference and 2 port validators over secret connections reach
    height 5; at every height all four hold the same block hash and app
    hash (the kvstore's app hash moves with its txs: one tx a height is
    submitted to a node of each package in turn)."""

    async def go():
        nodes = make_net(["ref", "port", "ref", "port"], tmp_path, chain="mixed-chain")
        try:
            await start_and_connect(nodes)
            for h in range(1, 5):
                await asyncio.gather(*(n.wait_for_height(h, timeout=30) for n in nodes))
                nodes[h % 4].mempool.check_tx(b"mixed%d=%d" % (h, h))
            await asyncio.gather(*(n.wait_for_height(5, timeout=30) for n in nodes))
            chain = _same_chain(nodes, 5)
            assert all(len(s) == 1 for s in chain), chain
            assert len({a for s in chain for _, a in s}) >= 2  # the app hash moved
            assert all(getattr(n.consensus, "halt_error", None) is None for n in nodes)
        finally:
            await stop_all(nodes)

    run(go(), 60)


def test_tx_to_a_reference_node_commits_in_the_port_stores(tmp_path):
    async def go():
        nodes = make_net(["ref", "port", "ref", "port"], tmp_path, chain="mixed-tx-chain")
        try:
            await start_and_connect(nodes)
            await asyncio.gather(*(n.wait_for_height(1, timeout=30) for n in nodes))
            nodes[0].mempool.check_tx(b"across=packages")
            await wait_until(lambda: all(block_in_store(n, b"across=packages")
                                         for n in (nodes[1], nodes[3])),
                             nodes, max_new_heights=12)
        finally:
            await stop_all(nodes)

    run(go(), 60)


def test_signed_txs_gossiped_from_a_reference_node(tmp_path):
    """A reference validator sends one Txs message (40 signed txs, 3 with a
    flipped signature byte) on channel 0x30 to a port full node and a
    reference full node. Each receiver's mempool reactor makes one
    check_tx_batch(txs, peer.id) hop: one admission-lane flush of 40 rows
    tagged sender:<the validator's ID>; the codes, the admitted txs, the
    app's counters and the suspicion record of that source are equal."""
    privs = [REF.keys.gen_ed25519(bytes([60 + k]) * 32) for k in range(8)]
    txs = [REF.signed_tx.encode_signed_tx(privs[i % 8], b"g%d=%d" % (i, i)) for i in range(40)]
    bad = (3, 21, 38)
    for i in bad:
        b = bytearray(txs[i])
        b[40] ^= 0xFF  # inside the signature
        txs[i] = bytes(b)

    def no_fast_sync(cfg):
        cfg.base.fast_sync = False
        cfg.mempool.recheck = False  # no post-commit recheck flush on the lane

    async def go():
        sender = make_node(REF, tmp_path, "sender", "signed-chain", 1, val=0, abci="signed_kvstore")
        receivers = {k: make_node(P_OF[k], tmp_path, f"rx-{k}", "signed-chain", 1,
                                  abci="signed_kvstore", edit=no_fast_sync)
                     for k in ("ref", "port")}
        scorers = {"ref": REF.provenance.SuspicionScorer(),
                   "port": PORT.provenance.SuspicionScorer()}
        prev = {k: P_OF[k].provenance.set_default(s) for k, s in scorers.items()}
        got = {}
        for k, node in receivers.items():
            orig = node.mempool.check_tx_batch

            def spy(batch, sender_id="", _k=k, _orig=orig):
                res = _orig(batch, sender_id)
                got[_k] = (sender_id, [None if r is None else r.code for r in res])
                return res

            node.mempool.check_tx_batch = spy
        nodes = [sender, *receivers.values()]
        try:
            for n in nodes:
                await n.start()
            for n in receivers.values():
                await n.switch.dial_peers_async([addr_of(sender)])
            await asyncio.gather(*(n.wait_for_height(1, timeout=30) for n in nodes))
            await sender.switch.broadcast(REF.mp_reactor.MEMPOOL_CHANNEL,
                                          REF.mp_reactor.encode_txs(txs))
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30
            while len(got) < 2 and loop.time() < deadline:
                await asyncio.sleep(0.05)
            out = {}
            for k, node in receivers.items():
                flushes = [f["rows"]["admission"] for f in list(node.scheduler.flush_log)
                           if "admission" in f["rows"]]
                worst = {w["source"]: w["fails"] for w in scorers[k].stats()["worst"]}
                out[k] = (got.get(k), flushes, node.app.serial_verifies,
                          node.app.precheck_consumed, node.mempool.size(), worst)
            return out, sender.node_key.id
        finally:
            for k, p in prev.items():
                P_OF[k].provenance.set_default(p)
            await stop_all(nodes)

    out, sender_id = run(go(), 60)
    assert out["port"] == out["ref"]
    (peer, codes), flushes, serial, consumed, size, worst = out["port"]
    want = REF.kvstore.SignedKVStoreApplication.CODE_BAD_SIGNATURE
    assert peer == sender_id
    assert [i for i, c in enumerate(codes) if c == want] == list(bad)
    assert [i for i, c in enumerate(codes) if c == 0] == [i for i in range(40) if i not in bad]
    assert (flushes, serial, consumed, size) == ([40], 0, 40, 37)
    assert worst == {f"sender:{sender_id}": 3}


@pytest.mark.parametrize("source,syncer", [("ref", "port"), ("port", "ref")],
                         ids=["port_syncs_from_ref", "ref_syncs_from_port"])
def test_fast_sync_across_packages(source, syncer, tmp_path):
    """A single validator of one package commits 8 heights (a tx at each);
    a fresh full node of the other dials it, fast-syncs, and hands off to
    consensus: both stores equal block for block, then the syncer follows
    the chain by consensus."""

    def edit(cfg):
        cfg.p2p.pex = False
        # a chain of ~5 heights a second, not hundreds: the syncer catches
        # a head that moves slower than its status requests
        cfg.consensus.skip_timeout_commit = False
        cfg.consensus.timeout_commit = 0.2

    async def go():
        src = make_node(P_OF[source], tmp_path, "src", "sync-chain", 1, val=0, edit=edit)
        dst = make_node(P_OF[syncer], tmp_path, "dst", "sync-chain", 1, edit=edit)
        try:
            await src.start()
            for h in range(1, 9):
                await src.wait_for_height(h, timeout=30)
                src.mempool.check_tx(b"s%d=%d" % (h, h))
            await src.wait_for_height(8, timeout=30)
            await dst.start()
            assert dst.fast_sync is True
            await dst.switch.dial_peers_async([addr_of(src)], persistent=True)
            await dst.wait_for_height(8, timeout=30)
            await asyncio.wait_for(dst.blocksync_reactor.synced.wait(), 15)
            target = src.block_store.height + 2
            await dst.wait_for_height(target, timeout=30)
            upto = min(src.block_store.height, dst.block_store.height)
            return ([src.block_store.load_block(h).encode() for h in range(1, upto + 1)] ==
                    [dst.block_store.load_block(h).encode() for h in range(1, upto + 1)],
                    upto >= 10, getattr(dst.consensus, "halt_error", None))
        finally:
            await stop_all([dst, src])

    assert run(go(), 80) == (True, True, None)


def test_reference_statesync_node_dials_port_node(tmp_path, caplog):
    """A reference node with statesync on (its active statesync reactor sends
    SnapshotsRequest on 0x60 to every new peer) dials a port validator: the
    port node lists 0x60/0x61, answers the request with its app's snapshots
    on 0x60, and keeps the peer (before the port had a statesync reactor it
    stopped the peer on the unknown channel, ROADMAP C6). The reference's
    syncer takes the port's snapshots into its pool."""
    import logging

    def ss(cfg):
        cfg.statesync.enable = True
        cfg.statesync.discovery_time = 30.0  # the test ends before it runs out
        cfg.p2p.pex = False

    def no_pex(cfg):
        cfg.p2p.pex = False

    async def go():
        src = make_node(PORT, tmp_path, "src", "ss-chain", 1, val=0, edit=no_pex)
        src.proxy_app.snapshot.app.snapshot_interval = 2
        ref = make_node(REF, tmp_path, "ref-ss", "ss-chain", 1, edit=ss)
        # the reference's syncer collects snapshots during its discovery
        # window; its state provider is asked only after it
        ref._state_provider = object()
        served, offered = [], []
        orig_rx = src.statesync_reactor.receive

        async def spy(chan_id, peer, msg_bytes):
            served.append(chan_id)
            await orig_rx(chan_id, peer, msg_bytes)

        src.statesync_reactor.receive = spy
        try:
            await src.start()
            await src.wait_for_height(3, timeout=30)
            assert ref.state_sync and {0x60, 0x61} <= set(ref.switch.node_info.channels)
            assert {0x60, 0x61} <= set(src.switch.node_info.channels)
            await ref.start()
            await ref.switch.dial_peers_async([addr_of(src)])
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 15
            while loop.time() < deadline:
                syncer = ref.statesync_reactor.syncer
                if syncer is not None and len(syncer.snapshots):
                    offered = [(s.height, s.format) for s in syncer.snapshots.ranked()]
                    break
                await asyncio.sleep(0.02)
            return (served, offered, src.switch.peers.has(ref.node_key.id),
                    [(s.height, s.format) for s in src.app.list_snapshots().snapshots])
        finally:
            await stop_all([ref, src])

    with caplog.at_level(logging.INFO, logger="tendermint_tpu_torch.p2p"):
        served, offered, kept, snaps = run(go(), 60)
    assert 0x60 in served and kept
    assert offered and set(offered) <= set(snaps)
    assert not any("unknown channel" in r.getMessage() for r in caplog.records)


def test_mixed_net_equivocator_evidence_reaches_both_packages(tmp_path):
    """An equivocating port validator in a net of 2 reference and 2 port
    validators: its DuplicateVoteEvidence is committed, and every honest
    node of both packages stores the block and marks the evidence
    committed in its pool."""

    async def go():
        nodes = make_net(["port", "ref", "port", "ref"], tmp_path, chain="mixed-byz-chain",
                         defer_votes=True)
        byz = nodes[0]
        byz_addr = byz.priv_validator.get_pub_key().address()
        honest = nodes[1:]
        try:
            await start_and_connect(nodes)
            _install_equivocator(byz)
            await wait_until(lambda: all(_committed_evidence(n, byz_addr) for n in honest),
                             nodes, max_new_heights=15)
            evs = [_committed_evidence(n, byz_addr) for n in honest]
            await wait_until(lambda: all(n.evidence_pool.is_committed(ev)
                                         for n, ev in zip(honest, evs)),
                             nodes, max_new_heights=3)
            return ({ev.hash() for ev in evs}, {type(n).__module__.split(".")[0] for n in honest},
                    [getattr(n.consensus, "halt_error", None) for n in nodes])
        finally:
            await stop_all(nodes)

    hashes, pkgs, halts = run(go(), 80)
    assert len(hashes) == 1
    assert pkgs == {"tendermint_tpu", "tendermint_tpu_torch"}
    assert halts == [None] * 4
