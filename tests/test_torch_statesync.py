"""The port's state sync (statesync/) against the JAX package's.

Units, each run on both packages with the same inputs and the same
outcome: the four wire messages byte for byte, the snapshot pool's ranking
and rejections, the chunk queue, the restore checkpoint, the kvstore's
snapshot chunks and the syncer's retry ladder (the reference's
tests/test_statesync.py:35-153 and tests/test_statesync_robustness.py:
115-278). The one difference (ROADMAP D1): a device error of the state
provider propagates out of the port's syncer, where the reference rejects
the snapshot.

Nodes: a port node bootstraps from a port peer's snapshot through
`[statesync] rpc_servers`; a port node from a reference source and a
reference node from a port source restore the State the other package's
state provider builds and the source's app hash; and an injected device
fault in the light check is raised by `wait_for_height` with no block-sync
fallback.
"""

import asyncio
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

pytest.importorskip("cryptography")

from tests.torch_rpc_util import free_port  # noqa: E402

_MODULES = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "messages": "statesync.messages",
    "snapshots": "statesync.snapshots", "chunks": "statesync.chunks",
    "checkpoint": "statesync.checkpoint", "syncer": "statesync.syncer",
    "stateprovider": "statesync.stateprovider", "metrics": "libs.metrics",
    "node": "node.node", "keys": "crypto.keys", "file_pv": "privval.file_pv",
    "genesis": "types.genesis", "rpc_client": "rpc.client",
}


def pkg(which: str) -> SimpleNamespace:
    root = "tendermint_tpu" if which == "ref" else "tendermint_tpu_torch"
    ns = SimpleNamespace(which=which, **{k: importlib.import_module(f"{root}.{m}")
                                         for k, m in _MODULES.items()})
    ns.config = importlib.import_module(
        "tendermint_tpu.config.config" if which == "ref" else "tendermint_tpu_torch.config")
    return ns


REF, PORT = pkg("ref"), pkg("port")
P_OF = {"ref": REF, "port": PORT}
BOTH = pytest.mark.parametrize("which", ["port", "ref"])
APP_HASH = b"\x0a" * 32


# ------------------------------------------------------------------- units


def test_messages_byte_equal():
    rng = np.random.default_rng(19)
    for _ in range(20):
        h, f, c, i = (int(x) for x in rng.integers(1, 1 << 40, 4))
        blob = bytes(rng.integers(0, 256, int(rng.integers(0, 200)), np.uint8))
        for build in (lambda M: M.SnapshotsRequest(),
                      lambda M: M.SnapshotsResponse(h, f % 1000, c % 4096, blob[:32] or b"x", blob),
                      lambda M: M.ChunkRequest(h, f % 1000, i % 4096),
                      lambda M: M.ChunkResponse(h, f % 1000, i % 4096, blob, bool(i & 1))):
            enc = PORT.messages.encode_message(build(PORT.messages))
            assert enc == REF.messages.encode_message(build(REF.messages))
            assert PORT.messages.decode_message(enc) == build(PORT.messages)
            assert REF.messages.decode_message(enc) == build(REF.messages)
    assert (PORT.messages.SNAPSHOT_CHANNEL, PORT.messages.CHUNK_CHANNEL) == (0x60, 0x61)
    assert (PORT.messages.SNAPSHOT_MSG_SIZE, PORT.messages.CHUNK_MSG_SIZE) == \
        (REF.messages.SNAPSHOT_MSG_SIZE, REF.messages.CHUNK_MSG_SIZE)


@BOTH
def test_snapshot_pool_ranking_and_rejection(which):
    S = P_OF[which].snapshots
    pool = S.SnapshotPool()
    s1, s2, s3 = S.Snapshot(10, 1, 2, b"h1"), S.Snapshot(20, 1, 2, b"h2"), S.Snapshot(20, 2, 2, b"h3")
    assert pool.add("peer-a", s1) and pool.add("peer-a", s2)
    assert pool.add("peer-b", s2) is False  # known, new peer recorded
    assert pool.add("peer-b", s3)
    assert [s.height for s in pool.ranked()] == [20, 20, 10]
    assert pool.best().format == 2
    pool.reject_format(2)
    assert pool.best() == s2
    pool.reject(s2)
    assert pool.best() == s1
    assert pool.add("peer-a", s2) is False  # stays rejected
    pool.remove_peer("peer-a")
    assert pool.best() is None
    assert s1.key() == REF.snapshots.Snapshot(10, 1, 2, b"h1").key()


@BOTH
def test_chunk_queue_ordering_retry_and_sender_discard(which):
    C, S = P_OF[which].chunks, P_OF[which].snapshots

    async def go():
        q = C.ChunkQueue(S.Snapshot(5, 1, 3, b"h"))
        assert sorted(q.allocate() for _ in range(3)) == [0, 1, 2]
        assert q.allocate() is None
        q.add(C.Chunk(5, 1, 1, b"one", "p1"))
        q.add(C.Chunk(5, 1, 0, b"zero", "p2"))
        got = [(await q.next()).index, (await q.next()).index]
        q.retry(1)
        q.add(C.Chunk(5, 1, 1, b"one'", "p3"))
        got.append((await q.next()).chunk)
        q.add(C.Chunk(5, 1, 2, b"two", "bad"))
        q.discard_sender("bad")
        got.append(q.has(2))
        q.add(C.Chunk(5, 1, 2, b"two'", "ok"))
        got += [(await q.next()).chunk, q.done()]
        # a refetch of an early chunk re-delivers it, then resumes
        q2 = C.ChunkQueue(S.Snapshot(5, 1, 4, b"h"))
        for i in range(2):
            q2.add(C.Chunk(5, 1, i, b"c%d" % i, "p"))
        got += [(await q2.next()).index, (await q2.next()).index]
        q2.retry(0)
        for i, c in ((0, b"c0'"), (2, b"c2"), (3, b"c3")):
            q2.add(C.Chunk(5, 1, i, c, "p"))
        got += [(await q2.next()).index for _ in range(3)] + [q2.done()]
        # mark_applied / fail
        q3 = C.ChunkQueue(S.Snapshot(5, 1, 3, b"h"))
        q3.mark_applied(0)
        q3.mark_applied(2)
        got += [q3.allocate(), q3.allocate()]
        q4 = C.ChunkQueue(S.Snapshot(5, 1, 1, b"h"))
        t4 = asyncio.create_task(q4.next())
        await asyncio.sleep(0.01)
        q4.fail(RuntimeError("budget exhausted"))
        with pytest.raises(RuntimeError):
            await asyncio.wait_for(t4, 2)
        return got

    got = asyncio.run(asyncio.wait_for(go(), 10))
    assert got == [0, 1, b"one'", False, b"two'", True, 0, 1, 0, 2, 3, True, 1, None]


@BOTH
def test_restore_checkpoint(which, tmp_path):
    P = P_OF[which]
    snap = P.snapshots.Snapshot(5, 1, 3, b"\x55" * 8, b"")
    ck = P.checkpoint.RestoreCheckpoint(str(tmp_path / "restore.json"))
    ck.save(snap, {0, 2})
    assert ck.load(snap) == {0, 2}
    assert ck.load(P.snapshots.Snapshot(6, 1, 3, b"\x66" * 8, b"")) == set()
    ck.save(snap, {0, 99})
    assert ck.load(snap) == {0}
    off = P.checkpoint.RestoreCheckpoint(None)
    off.save(snap, {1})
    assert off.load(snap) == set()
    # the file each package writes is read by the other
    other = P_OF["ref" if which == "port" else "port"].checkpoint.RestoreCheckpoint(
        str(tmp_path / "restore.json"))
    assert other.load(snap) == {0}
    ck.clear()
    assert not os.path.exists(tmp_path / "restore.json")


def test_kvstore_snapshots_restore_across_packages():
    """A port kvstore's snapshot chunks are the reference's byte for byte,
    and each package's app restores from the other's chunks."""
    apps = {w: P_OF[w].kvstore.KVStoreApplication(snapshot_interval=2) for w in P_OF}
    for w, app in apps.items():
        a = P_OF[w].abci
        for h in range(1, 5):
            app.deliver_tx(a.RequestDeliverTx(tx=b"k%d=v%d" % (h, h)))
            app.commit()
    snaps = {w: apps[w].list_snapshots().snapshots for w in P_OF}
    assert [(s.height, s.chunks, s.hash) for s in snaps["port"]] == \
        [(s.height, s.chunks, s.hash) for s in snaps["ref"]]
    for src, dst in (("port", "ref"), ("ref", "port")):
        a, snap = P_OF[dst].abci, snaps[src][-1]
        restored = P_OF[dst].kvstore.KVStoreApplication()
        offer = a.Snapshot(height=snap.height, format=snap.format, chunks=snap.chunks,
                           hash=snap.hash, metadata=snap.metadata)
        assert restored.offer_snapshot(a.RequestOfferSnapshot(
            snapshot=offer, app_hash=apps[src].app_hash)).result == a.OFFER_SNAPSHOT_ACCEPT
        for i in range(snap.chunks):
            chunk = apps[src].load_snapshot_chunk(
                P_OF[src].abci.RequestLoadSnapshotChunk(snap.height, 1, i)).chunk
            assert chunk == apps[dst].load_snapshot_chunk(
                a.RequestLoadSnapshotChunk(snap.height, 1, i)).chunk
            assert restored.apply_snapshot_chunk(a.RequestApplySnapshotChunk(
                index=i, chunk=chunk)).result == a.APPLY_SNAPSHOT_CHUNK_ACCEPT
        info = restored.info(a.RequestInfo())
        assert (info.last_block_height, info.last_block_app_hash) == (4, apps[src].app_hash)


# ------------------------------------------------------- the syncer's ladder


def harness(P, plan=None, peers=("p1", "p2"), silent=(), checkpoint=None, provider=None,
            **syncer_kw):
    """A Syncer of package P wired to scripted peers and a scripted app (the
    reference's tests/test_statesync_robustness.py Harness)."""
    a = P.abci
    snap = P.snapshots.Snapshot(5, 1, 3, b"\x55" * 8, b"")

    class StubProvider(P.stateprovider.StateProvider):
        async def app_hash(self, height):
            return APP_HASH

        async def commit(self, height):
            return "commit"

        async def state(self, height):
            return "state"

    class StubApp:
        def __init__(self):
            self.applied, self.offers = [], 0
            self.plan = {k: list(v) for k, v in (plan or {}).items()}

        def offer_snapshot(self, req):
            self.offers += 1
            return a.ResponseOfferSnapshot(result=a.OFFER_SNAPSHOT_ACCEPT)

        def apply_snapshot_chunk(self, req):
            self.applied.append(req.index)
            seq = self.plan.get(req.index)
            return seq.pop(0) if seq else a.ResponseApplySnapshotChunk()

        def info(self, req):
            return a.ResponseInfo(last_block_height=5, last_block_app_hash=APP_HASH)

    h = SimpleNamespace(app=StubApp(), requests=[], punished=[], silent=set(silent),
                        metrics=P.metrics.StateSyncMetrics(P.metrics.Registry()), snap=snap)

    async def request_chunk(peer_id, height, fmt, index):
        h.requests.append((peer_id, index))
        if peer_id in h.silent:
            return

        async def deliver():
            await asyncio.sleep(0.01)
            h.syncer.add_chunk(P.chunks.Chunk(height, fmt, index, b"chunk-%d" % index, peer_id))

        asyncio.get_running_loop().create_task(deliver())

    async def punish(peer_id, reason):
        h.punished.append((peer_id, reason))

    kw = dict(chunk_fetchers=2, chunk_timeout=0.15, chunk_retries=8, chunk_backoff=0.01)
    kw.update(syncer_kw)
    h.syncer = P.syncer.Syncer(provider or StubProvider(), h.app, h.app, request_chunk,
                               metrics=h.metrics, punish_peer=punish, checkpoint=checkpoint, **kw)
    for p in peers:
        h.syncer.add_snapshot(p, snap)
    return h


def run_sync(h, timeout=20.0):
    return asyncio.run(asyncio.wait_for(h.syncer.sync_any(0), timeout))


def counter(c):
    return c._values.get((), 0.0)


@BOTH
def test_chunk_timeout_rerequests_from_second_peer(which):
    P = P_OF[which]

    async def go():
        h = harness(P, peers=("p1",), silent=("p1",))
        task = asyncio.create_task(h.syncer.sync_any(0))
        await asyncio.sleep(0.4)
        assert h.requests and all(p == "p1" for p, _ in h.requests)
        h.syncer.add_snapshot("p2", h.snap)
        state, commit = await asyncio.wait_for(task, 20)
        for idx in range(3):
            assert [p for p, i in h.requests if i == idx][-1] == "p2"
        return (state, commit, counter(h.metrics.chunk_retries_total) > 0,
                counter(h.metrics.chunks_applied_total))

    assert asyncio.run(asyncio.wait_for(go(), 30)) == ("state", "commit", True, 3)


@BOTH
def test_reject_sender_punishes_and_requeues(which):
    P = P_OF[which]
    a = P.abci
    h = harness(P, plan={1: [a.ResponseApplySnapshotChunk(
        result=a.APPLY_SNAPSHOT_CHUNK_RETRY, refetch_chunks=[1], reject_senders=["p1"])]})
    assert run_sync(h) == ("state", "commit")
    assert ("p1", "app rejected snapshot sender") in h.punished
    assert [p for p, i in h.requests if i == 1][-1] == "p2"
    assert h.app.applied.count(1) >= 2
    assert counter(h.metrics.chunks_applied_total) == 3


@BOTH
def test_app_abort_is_structured(which):
    P = P_OF[which]
    h = harness(P, plan={0: [P.abci.ResponseApplySnapshotChunk(
        result=P.abci.APPLY_SNAPSHOT_CHUNK_ABORT)]})
    with pytest.raises(P.syncer.ErrAbort):
        run_sync(h)


@BOTH
def test_corrupt_chunk_punished_and_resourced(which):
    P = P_OF[which]
    h = harness(P, plan={0: [P.abci.ResponseApplySnapshotChunk(
        result=P.abci.APPLY_SNAPSHOT_CHUNK_RETRY)]})
    assert run_sync(h) == ("state", "commit")
    assert len(h.punished) == 1 and h.punished[0][1] == "corrupt snapshot chunk"
    seq = [p for p, i in h.requests if i == 0]
    assert len(seq) >= 2 and seq[-1] != h.punished[0][0]
    assert counter(h.metrics.bad_chunks_total) == 1
    assert h.app.applied.count(0) == 2


@BOTH
def test_retry_budget_exhaustion_ends_in_no_snapshots(which):
    P = P_OF[which]
    h = harness(P, silent=("p1", "p2"), chunk_retries=1, chunk_timeout=0.05)
    with pytest.raises(P.syncer.ErrNoSnapshots):
        run_sync(h)
    assert counter(h.metrics.chunk_retries_total) >= 1


@BOTH
def test_resume_after_crash_skips_applied_chunks(which, tmp_path):
    P = P_OF[which]
    ckpt = str(tmp_path / "restore.json")
    h1 = harness(P, plan={2: [P.abci.ResponseApplySnapshotChunk(
        result=P.abci.APPLY_SNAPSHOT_CHUNK_ABORT)]},
        checkpoint=P.checkpoint.RestoreCheckpoint(ckpt))
    with pytest.raises(P.syncer.ErrAbort):
        run_sync(h1)
    assert sorted(set(h1.app.applied) - {2}) == [0, 1]
    h2 = harness(P, checkpoint=P.checkpoint.RestoreCheckpoint(ckpt))
    assert run_sync(h2) == ("state", "commit")
    assert h2.app.applied == [2] and {i for _, i in h2.requests} == {2}
    assert h2.app.offers == 1 and counter(h2.metrics.resume_events_total) == 1
    assert not os.path.exists(ckpt)


@BOTH
def test_provider_failure_rejects_the_snapshot(which):
    """A provider failure that is no device error (an RPC error, a height
    not committed yet) rejects the snapshot in both packages."""
    P = P_OF[which]

    class Failing(P.stateprovider.StateProvider):
        async def app_hash(self, height):
            raise RuntimeError("height 7 is not committed yet")

    h = harness(P, provider=Failing())
    with pytest.raises(P.syncer.ErrNoSnapshots):
        run_sync(h)
    assert h.app.offers == 0


def test_device_error_of_the_provider_propagates():
    """ROADMAP D1: an error that came out of device work inside the light
    check propagates out of the port's syncer unchanged; the reference turns
    the same error into a rejected snapshot (and so ErrNoSnapshots)."""
    from tendermint_tpu_torch.chaos import DeviceFaultError, DeviceFaultInjector
    from tendermint_tpu_torch.crypto import batch

    def failing(P, on_device):
        class Failing(P.stateprovider.StateProvider):
            async def app_hash(self, height):
                on_device()

        return Failing()

    inj = DeviceFaultInjector().install()
    try:
        inj.set_persistent(True)

        def card_entry():
            with batch._on_device("rlc_submit"):
                pass

        with pytest.raises(DeviceFaultError) as e:
            run_sync(harness(PORT, provider=failing(PORT, card_entry)))
        assert batch.is_device_error(e.value)
        assert inj.fired == [("rlc_submit", "error")]

        def ref_entry():
            raise DeviceFaultError("injected device fault at rlc_submit")

        with pytest.raises(REF.syncer.ErrNoSnapshots):
            run_sync(harness(REF, provider=failing(REF, ref_entry)))
        # the state task's failure: the same split
        class StateFails(PORT.stateprovider.StateProvider):
            async def app_hash(self, height):
                return APP_HASH

            async def commit(self, height):
                return "commit"

            async def state(self, height):
                card_entry()

        h = harness(PORT, provider=StateFails())
        with pytest.raises(DeviceFaultError):
            run_sync(h)
    finally:
        inj.uninstall()


# -------------------------------------------------------------------- nodes

GENESIS_TIME_NS = 1_700_000_000_000_000_000


def genesis(P, chain):
    pub = P.keys.gen_ed25519(b"\x71" * 32).pub_key()
    return P.genesis.GenesisDoc(chain_id=chain, genesis_time_ns=GENESIS_TIME_NS,
                                validators=[P.genesis.GenesisValidator(pub, 10)])


def make(P, tmp, name, chain, validator=False, statesync=False, app=None, rpc_servers=(),
         trust=None, rpc=False):
    cfg = P.config.test_config()
    cfg.base.db_backend, cfg.root_dir = "memdb", ""
    # the reference's server does not read back a :0 port
    port = free_port() if P.which == "ref" else 0
    cfg.rpc.laddr = f"tcp://127.0.0.1:{port}" if rpc else ""
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.instrumentation.forensics_dir = ""
    cfg.consensus.wal_path = str(tmp / name / "wal")
    # pace the source at ~4 blocks/s so its snapshots stay servable
    cfg.consensus.timeout_commit = 0.25
    cfg.consensus.skip_timeout_commit = False
    cfg.statesync.enable = statesync
    cfg.statesync.discovery_time = 0.3
    cfg.statesync.chunk_request_timeout = 5.0
    cfg.statesync.rpc_servers = list(rpc_servers)
    if trust is not None:
        cfg.statesync.trust_height, cfg.statesync.trust_hash = trust
    priv = P.file_pv.FilePV(P.keys.gen_ed25519(b"\x71" * 32)) if validator else None
    extra = {"device": "cpu"} if P.which == "port" else {}
    return P.node.Node(cfg, genesis(P, chain), priv_validator=priv,
                       app=app or P.kvstore.KVStoreApplication(), **extra)


def rpc_url(node) -> str:
    port = getattr(node.rpc_server, "port", None) or node.config.rpc.laddr.rsplit(":", 1)[1]
    return f"http://127.0.0.1:{port}"


async def source_ready(src, timeout=60):
    """A snapshot exists and the chain is 2+ past it (the provider needs H+2)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        snaps = src.app.list_snapshots().snapshots
        if snaps and src.block_store.height >= snaps[-1].height + 2:
            return
        assert loop.time() < deadline, "source made no snapshot"
        await asyncio.sleep(0.1)


def state_summary(state, P):
    """A State as bytes either package computes the same way."""
    cp = state.consensus_params
    return (state.chain_id, state.initial_height, state.last_block_height,
            state.last_block_id.hash, state.last_block_id.part_set_header.hash,
            state.last_block_time_ns, state.validators.hash(), state.next_validators.hash(),
            state.last_validators.hash(), state.last_height_validators_changed,
            cp.block.max_bytes, cp.block.max_gas, cp.evidence.max_age_num_blocks,
            cp.evidence.max_age_duration_ns, state.last_height_consensus_params_changed,
            state.last_results_hash, state.app_hash)


def sync_between(tmp, src_kind, dst_kind):
    """A `src_kind` validator takes snapshots every 4 heights; a fresh
    `dst_kind` node state-syncs from it through `[statesync] rpc_servers`,
    then block-syncs to the head. Returns what the syncer restored (State
    summary, commit height, app hash) beside what the other package's
    state provider builds over the same source at the same height."""
    S, D = P_OF[src_kind], P_OF[dst_kind]
    chain = f"ss-{src_kind}-{dst_kind}"

    async def go():
        src = make(S, tmp, "src", chain, validator=True, rpc=True,
                   app=S.kvstore.KVStoreApplication(snapshot_interval=4, snapshot_keep=50))
        for i in range(3):
            src.mempool.check_tx(b"ss%d=val%d" % (i, i))
        await src.start()
        dst = None
        try:
            await source_ready(src)
            trust = (1, src.block_store.load_block(1).hash().hex())
            dst = make(D, tmp, "dst", chain, statesync=True, rpc_servers=[rpc_url(src)],
                       trust=trust)
            got = {}
            real = dst.statesync_reactor.sync

            async def spy(*a, **kw):
                state, commit = await real(*a, **kw)
                got.update(state=state, commit=commit, app=dst.proxy_app.query.info(
                    D.abci.RequestInfo()).last_block_app_hash)
                return state, commit

            dst.statesync_reactor.sync = spy
            await dst.start()
            assert dst.state_sync is True
            await dst.switch.dial_peers_async([f"{src.node_key.id}@{src.p2p_addr}"],
                                              persistent=True)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 60
            while "state" not in got:
                assert loop.time() < deadline, "no snapshot restored"
                await asyncio.sleep(0.05)
            h = got["state"].last_block_height
            target = max(h + 2, src.block_store.height + 1)
            await dst.wait_for_height(target, timeout=60)
            assert dst.block_store.load_block(1) is None  # no replay from genesis
            assert dst.block_store.load_seen_commit(h) is not None
            q = dst.proxy_app.query.query(D.abci.RequestQuery(path="/store", data=b"ss0"))
            assert q.value == b"val0"
            # the other package's state provider over the same source
            O = P_OF["ref" if dst_kind == "port" else "port"]
            other = O.stateprovider.LightClientStateProvider(
                chain, [O.rpc_client.HTTPClient(rpc_url(src))], 1,
                src.block_store.load_block(1).hash(), 24 * 3600 * 10**9)
            want = await other.state(h)
            for c in other.rpc_clients:
                await c.close()
            return (state_summary(got["state"], D), state_summary(want, O),
                    got["commit"].height, got["app"],
                    src.block_store.load_block(h + 1).header.app_hash,
                    getattr(dst.metrics.statesync.fallbacks_total, "_values", {}).get((), 0.0))
        finally:
            if dst is not None:
                await dst.stop()
            await src.stop()

    return asyncio.run(asyncio.wait_for(go(), 150))


@pytest.mark.parametrize("src_kind,dst_kind", [("port", "port"), ("ref", "port"),
                                               ("port", "ref")])
def test_node_state_syncs_across_packages(tmp_path, src_kind, dst_kind):
    got, want, commit_h, app_hash, src_app_hash, fallbacks = sync_between(
        tmp_path, src_kind, dst_kind)
    assert got == want
    assert commit_h == got[2] and app_hash == src_app_hash == got[-1]
    assert fallbacks == 0


def test_port_node_answers_snapshot_requests(tmp_path):
    """The port node's statesync reactor lists 0x60/0x61 (sheddable, the
    reference's priorities and capacities) and answers a SnapshotsRequest
    with its app's recent snapshots."""
    from tendermint_tpu_torch.statesync.messages import (SnapshotsRequest, SnapshotsResponse,
                                                         decode_message, encode_message)

    async def go():
        node = make(PORT, tmp_path, "srv", "ss-serve", validator=True,
                    app=PORT.kvstore.KVStoreApplication(snapshot_interval=2))
        ref_node = make(REF, tmp_path, "refsrv", "ss-serve", validator=True)
        descs = {d.id: (d.priority, d.send_queue_capacity, d.recv_message_capacity,
                        d.sheddable) for d in node.statesync_reactor.get_channels()}
        ref_descs = {d.id: (d.priority, d.send_queue_capacity, d.recv_message_capacity,
                            d.sheddable) for d in ref_node.statesync_reactor.get_channels()}
        await node.start()
        try:
            await node.wait_for_height(5, timeout=30)
            sent = []

            class Peer:
                id = "peer-x"

                async def send(self, chan, data):
                    sent.append((chan, decode_message(data)))
                    return True

            await node.statesync_reactor.receive(0x60, Peer(), encode_message(SnapshotsRequest()))
            return descs, ref_descs, sent, 0x60 in node.switch.node_info.channels
        finally:
            await node.stop()

    descs, ref_descs, sent, listed = asyncio.run(asyncio.wait_for(go(), 60))
    assert descs == ref_descs and set(descs) == {0x60, 0x61} and listed
    assert sent and all(c == 0x60 and isinstance(m, SnapshotsResponse) for c, m in sent)
    assert [m.height for _, m in sent] == sorted((m.height for _, m in sent), reverse=True)


def test_device_fault_in_the_light_check_reaches_wait_for_height(tmp_path, monkeypatch):
    """An injected device fault in the state provider's first light check:
    the port node keeps it in statesync_error, raises it from
    wait_for_height and stop, and does not fall back to block sync (the
    reference would reject the snapshot and block-sync from genesis). The
    light check reaches the card arm's first device entry: the routing
    variable unset and the row floor at 1 once the syncer has started (so
    it has no prewarm), while the source's consensus sits in a long commit
    timeout."""
    from tendermint_tpu_torch.chaos import DeviceFaultError, DeviceFaultInjector
    from tendermint_tpu_torch.crypto import batch

    async def go():
        src = make(PORT, tmp_path, "src", "ss-fault", validator=True, rpc=True,
                   app=PORT.kvstore.KVStoreApplication(snapshot_interval=4, snapshot_keep=50))
        await src.start()
        dst = None
        inj = DeviceFaultInjector()
        try:
            await source_ready(src)
            # the source's consensus waits out a long commit timeout: no
            # flush of its own while the syncer's light check runs
            src.config.consensus.timeout_commit = 600.0
            await asyncio.sleep(1.0)
            src_height = src.block_store.height
            trust = (1, src.block_store.load_block(1).hash().hex())
            dst = make(PORT, tmp_path, "dst", "ss-fault", statesync=True,
                       rpc_servers=[rpc_url(src)], trust=trust)
            switched = []
            real_switch = dst.blocksync_reactor.switch_to_blocksync

            async def spy(state):
                switched.append(state)
                await real_switch(state)

            dst.blocksync_reactor.switch_to_blocksync = spy
            await dst.start()
            monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
            monkeypatch.setattr(batch, "_CUDA_MIN_BATCH", 1)
            inj.install().set_persistent(True)
            await dst.switch.dial_peers_async([f"{src.node_key.id}@{src.p2p_addr}"])
            with pytest.raises(RuntimeError, match="device error") as e:
                await dst.wait_for_height(2, timeout=30)
            cause = e.value.__cause__
            fallbacks = dst.metrics.statesync.fallbacks_total._values.get((), 0.0)
            with pytest.raises(RuntimeError, match="device error"):
                await dst.stop()
            assert src.block_store.height == src_height
            return cause, switched, fallbacks, list(inj.fired), dst.block_store.height
        finally:
            inj.uninstall()
            monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")
            await src.stop()

    cause, switched, fallbacks, fired, height = asyncio.run(asyncio.wait_for(go(), 90))
    assert isinstance(cause, DeviceFaultError) and batch.is_device_error(cause)
    assert fired and fired[0][1] == "error" and fired[0][0] in ("persig", "rlc_submit")
    assert switched == [] and fallbacks == 0 and height == 0
