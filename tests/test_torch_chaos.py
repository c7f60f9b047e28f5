"""The port's chaos engine (tendermint_tpu_torch/chaos/: schedule, engine,
process, catchup, byzantine, harness) against the JAX package's.

Pure parts run in both packages on the same inputs and must agree to the
byte: `ChaosSchedule.generate` over a grid of seeds and kind sets (events,
JSON, fingerprint, levels, the round trip between the packages), its
rejections, the WAL tail faults under one rng, `ServeFaults`' tampered
blocks and chunks, `poison_votes`' vote bytes at a fixed time, and the
engine's dispatch, error capture and fault counter. Then live nets of port
nodes on device="cpu" (the host arm, TMTPU_CRYPTO_BACKEND=cpu): the
reference's partition/heal smoke (tests/test_chaos.py:466-503), a
signature-poisoning flood whose victims' masks are False on every poisoned
row while the provenance scorer quarantines and punishes the source, and
the D1 pin: a device_error that meets a vote flush on the card arm halts a
port node, where the reference's node commits on. No tolerance applies.
"""

import asyncio
import os
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

import tendermint_tpu.chaos as R_chaos  # noqa: E402
from tendermint_tpu.chaos import byzantine as R_byz  # noqa: E402
from tendermint_tpu.chaos import catchup as R_catch  # noqa: E402
from tendermint_tpu.chaos import process as R_proc  # noqa: E402
from tendermint_tpu.chaos import schedule as R_sched  # noqa: E402
from tendermint_tpu.libs import metrics as R_metrics  # noqa: E402
import tendermint_tpu_torch.chaos as T_chaos  # noqa: E402
from tendermint_tpu_torch.chaos import byzantine as T_byz  # noqa: E402
from tendermint_tpu_torch.chaos import catchup as T_catch  # noqa: E402
from tendermint_tpu_torch.chaos import process as T_proc  # noqa: E402
from tendermint_tpu_torch.chaos import schedule as T_sched  # noqa: E402
from tendermint_tpu_torch.crypto import batch as T_batch  # noqa: E402
from tendermint_tpu_torch.crypto import provenance as T_prov  # noqa: E402
from tendermint_tpu_torch.libs import metrics as T_metrics  # noqa: E402
from torch_p2p_util import PORT, REF  # noqa: E402

SEEDS = (0, 7, 20260803, 20261016)
KIND_SETS = (
    ("partition", "crash", "device_error", "device_hang"),
    ("partition",),
    ("crash", "partition", "sig_poison"),
    ("peer_stall", "peer_lie", "chunk_corrupt", "sig_poison"),
    ("shard_error", "shard_hang", "device_lost", "device_hang"),
)


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = T_batch._MEMO
    T_batch._MEMO = T_batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        T_batch._MEMO = prev


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("kinds", KIND_SETS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_generate_equals_the_reference(seed, kinds):
    kw = dict(episodes=9, kinds=kinds, protected=(0,), min_gap=0.4, max_gap=1.7)
    r = R_sched.ChaosSchedule.generate(seed, 5, **kw)
    t = T_sched.ChaosSchedule.generate(seed, 5, **kw)
    assert t.to_json() == r.to_json()
    assert t.fingerprint() == r.fingerprint()
    assert len(t) == len(r) and t.duration() == r.duration()
    assert [e.level for e in t] == [e.level for e in r]
    assert [e.param_dict() for e in t] == [e.param_dict() for e in r]
    # each package reads the other's artifact back to an equal schedule
    assert T_sched.ChaosSchedule.from_json(r.to_json()) == t
    assert R_sched.ChaosSchedule.from_json(t.to_json()) == r


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the rejection is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["unknown_kind", "all_protected", "make_unknown"])
def test_schedule_rejections_equal(case):
    def run(S):
        if case == "unknown_kind":
            return _raised(lambda: S.ChaosSchedule.generate(1, 4, kinds=("meteor",)))
        if case == "all_protected":
            return _raised(lambda: S.ChaosSchedule.generate(
                1, 3, kinds=("crash",), protected=(0, 1, 2)))
        return _raised(lambda: S.FaultEvent.make(1.0, "sig_poisoning", count=3))

    got, want = run(T_sched), run(R_sched)
    assert want is not None and got == want
    assert T_sched.LEVEL_BY_KIND == R_sched.LEVEL_BY_KIND


def test_package_exports_equal():
    assert T_chaos.__all__ == R_chaos.__all__
    ev = T_chaos.FaultEvent.make(2.5, "sig_poison", target=1, count=12)
    assert ev.level == "adversary" and ev.param_dict() == {"target": 1, "count": 12}


# ------------------------------------------------------------- WAL faults


def _wal_file(tmp_path, name: str) -> str:
    from tendermint_tpu_torch.consensus.wal import WAL

    wal = WAL(str(tmp_path / name / "wal"))
    for h in range(1, 7):
        wal.write_end_height(h)
    wal.close()
    return wal.path


@pytest.mark.parametrize("fault", ["truncate13", "truncate1", "truncate_past", "corrupt0",
                                   "corrupt5", "corrupt_wide"])
def test_wal_tail_faults_byte_identical(tmp_path, fault):
    """The same damage from both packages on copies of one port WAL; the
    port's non-strict reader keeps the clean prefix."""
    from tendermint_tpu_torch.consensus.wal import iter_wal_messages

    src = _wal_file(tmp_path, "w")
    full = list(iter_wal_messages(src))
    with open(src, "rb") as f:
        data = f.read()
    out = {}
    for name, P in (("ref", R_proc), ("port", T_proc)):
        path = str(tmp_path / f"{name}.wal")
        with open(path, "wb") as f:
            f.write(data)
        if fault.startswith("truncate"):
            drop = {"truncate13": 13, "truncate1": 1, "truncate_past": len(data) + 9}[fault]
            P.truncate_wal_tail(path, drop_bytes=drop)
        else:
            seed, span = {"corrupt0": (0, 16), "corrupt5": (5, 16),
                          "corrupt_wide": (9, 4096)}[fault]
            P.corrupt_wal_tail(path, rng=random.Random(seed), span=span)
        with open(path, "rb") as f:
            out[name] = f.read()
        kept = list(iter_wal_messages(path))
        assert kept == full[: len(kept)]
    assert out["port"] == out["ref"]
    assert out["port"] != data
    # a missing file is left alone by both
    T_proc.truncate_wal_tail(str(tmp_path / "none"))
    T_proc.corrupt_wal_tail(str(tmp_path / "none"))
    assert not os.path.exists(tmp_path / "none")


def test_crash_wal_drops_buffered_frames(tmp_path):
    """The port's copy of tests/test_chaos.py's crash_wal check, on the
    port's WAL: the group-commit buffer is lost, the durable prefix stays."""
    from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage, iter_wal_messages

    wal = WAL(str(tmp_path / "b" / "wal"), group_commit=True, group_commit_max_latency=10.0)
    wal.write_end_height(1)
    wal.write(EndHeightMessage(2))
    T_proc.crash_wal(wal)
    msgs = list(iter_wal_messages(wal.path))
    assert EndHeightMessage(1) in msgs and EndHeightMessage(2) not in msgs
    wal.close()


# ------------------------------------------------------------ ServeFaults


def _block(P, h: int, sigs: int = 2):
    """One encode/decode-true block of package P (test_blocksync_pipeline's
    _mk_chain shape, with `sigs` commit signatures)."""
    B = P.block
    basic = P.basic
    prev = b"\xaa" * 32
    commit = B.Commit(
        height=h - 1, round=0,
        block_id=basic.BlockID(prev, basic.PartSetHeader(1, b"\xbb" * 32)),
        signatures=tuple(
            B.CommitSig(basic.BlockIDFlag.COMMIT, bytes([1 + i]) * 20, 7 + i,
                        bytes([2 + i]) * 64) for i in range(sigs)),
    )
    header = B.Header(
        version=B.ConsensusVersion(), chain_id="ckpt-chain", height=h, time_ns=1_000_000 * h,
        last_block_id=basic.BlockID(prev, basic.PartSetHeader(1, b"\xbb" * 32)),
        last_commit_hash=b"\xcc" * 32, data_hash=b"\xdd" * 32, validators_hash=b"\xee" * 32,
        next_validators_hash=b"\xee" * 32, consensus_hash=b"\xff" * 32, app_hash=b"\x11" * 32,
        last_results_hash=b"\x22" * 32, evidence_hash=b"\x33" * 32,
        proposer_address=b"\x44" * 20,
    )
    return B.Block(header=header, txs=(b"tx-a", b"tx-b"), evidence=(), last_commit=commit)


@pytest.mark.parametrize("sigs", [0, 1, 3])
def test_serve_faults_tamper_equal_bytes(sigs):
    rb, tb = _block(REF, 5, sigs), _block(PORT, 5, sigs)
    assert tb.encode() == rb.encode()
    rs, ts = R_catch.ServeFaults(), T_catch.ServeFaults()
    assert ts.corrupt_block(tb).encode() == rs.corrupt_block(rb).encode()
    for chunk in (b"", b"\x00", b"\x10\x20\x30" * 50):
        assert ts.corrupt_chunk(chunk) == rs.corrupt_chunk(chunk)
    assert ts.fired == rs.fired


def test_serve_faults_corrupt_block_is_a_lie_not_noise():
    """tests/test_blocksync_pipeline.py:368-382 on the port's types."""
    b = _block(PORT, 5, 1)
    sf = T_catch.ServeFaults()
    bad = sf.corrupt_block(b)
    rt = PORT.block.Block.decode(bad.encode())
    assert rt.header.height == 5
    assert bad.hash() == b.hash()
    assert bad.last_commit.signatures[0].signature != b.last_commit.signatures[0].signature
    assert ("block_lie", "height=5") in sf.fired


def test_serve_faults_stall_and_counters():
    """tests/test_blocksync_pipeline.py:385-402 on the port's ServeFaults,
    and install() on a node's two serving reactors."""
    t = [0.0]
    sf = T_catch.ServeFaults(clock=lambda: t[0])
    assert not sf.block_stalled()
    sf.arm_block_stall(5.0)
    assert sf.block_stalled()
    t[0] = 6.0
    assert not sf.block_stalled()
    sf.arm_block_lies(1)
    assert sf.take_block_lie() and not sf.take_block_lie()
    sf.arm_chunk_corrupt(1)
    assert sf.take_chunk_corrupt() and not sf.take_chunk_corrupt()
    assert sf.corrupt_chunk(b"\x00\x01")[0] == 0xFF
    sf.arm_block_lies(2)
    sf.heal()
    assert not sf.take_block_lie()
    node = SimpleNamespace(blocksync_reactor=SimpleNamespace(serve_faults=None),
                           statesync_reactor=SimpleNamespace(serve_faults=None))
    got = T_catch.install(node)
    assert node.blocksync_reactor.serve_faults is got is node.statesync_reactor.serve_faults


# ------------------------------------------------------------ poison_votes


class _Recorder:
    """The switch of a fake node: what broadcast and write_burst sent."""

    def __init__(self, peers: int):
        self.sent = []
        outer = self

        class Conn:
            async def write_burst(self, ch, msgs):
                outer.sent.extend((ch, m) for m in msgs)
                return True

        class Peer:
            mconn = Conn()

            def has_channel(self, ch):
                return True

        self.peers = SimpleNamespace(list=lambda: [Peer() for _ in range(peers)])

    async def broadcast(self, ch, msg):
        self.sent.append((ch, msg))


def _fake_node(P, peers=1):
    keys = [P.keys.gen_ed25519(bytes([60 + i]) * 32) for i in range(4)]
    vals = P.validator_set.ValidatorSet(
        [P.validator_set.Validator(k.pub_key(), 10) for k in keys])
    rs = SimpleNamespace(height=7, round=2, validators=vals)
    return SimpleNamespace(consensus=SimpleNamespace(rs=rs), switch=_Recorder(peers),
                           priv_validator=P.file_pv.FilePV(keys[1]))


def test_poison_votes_same_bytes_at_a_fixed_time(monkeypatch):
    import importlib

    R = SimpleNamespace(**vars(REF), validator_set=importlib.import_module(
        "tendermint_tpu.types.validator_set"))
    T = SimpleNamespace(**vars(PORT), validator_set=importlib.import_module(
        "tendermint_tpu_torch.types.validator_set"))
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    rn, tn = _fake_node(R), _fake_node(T)
    assert asyncio.run(R_byz.poison_votes(rn, 21)) == 21
    assert asyncio.run(T_byz.poison_votes(tn, 21)) == 21
    assert tn.switch.sent == rn.switch.sent and len(rn.switch.sent) == 21
    # the burst writes the same votes to each peer at once
    bn = _fake_node(T, peers=3)
    assert asyncio.run(T_byz.poison_votes(bn, 21, burst=True)) == 21
    assert bn.switch.sent == rn.switch.sent * 3
    # every poisoned vote fails verification, and its signature is a real one
    vote = PORT.cs_messages.decode_message(rn.switch.sent[0][1]).vote
    key = tn.priv_validator.get_pub_key()
    assert not key.verify(vote.sign_bytes("any-chain"), vote.signature)
    assert key.verify(b"tmtpu-sig-poison:" + (0).to_bytes(4, "big"), vote.signature)
    # a node outside the set, or without a switch, sends nothing
    tn.switch = None
    assert asyncio.run(T_byz.poison_votes(tn, 3)) == 0


# ----------------------------------------------------------------- engine


class _Adapter:
    def __init__(self):
        self.calls = []

    def device_error(self, count):
        self.calls.append(("device_error", count))

    async def partition(self, groups):
        self.calls.append(("partition", groups))

    def crash(self, target, wal_fault):
        raise RuntimeError("cannot crash")

    async def sig_poison(self, target, count):
        self.calls.append(("sig_poison", target, count))


def test_engine_dispatch_and_errors_equal_the_reference():
    """tests/test_chaos.py:302-336 run on both engines: the same calls, the
    same recorded errors, the same fault counts on each package's
    tendermint_chaos_faults_injected_total{level}."""
    events = [("device_error", dict(count=2)), ("partition", dict(groups=[[0, 1], [2]])),
              ("crash", dict(target=1, wal_fault=None)), ("heal", {}),
              ("sig_poison", dict(target=2, count=13))]
    out = {}
    for name, S, M in (("ref", R_chaos, R_metrics), ("port", T_chaos, T_metrics)):
        ad = _Adapter()
        sched = S.ChaosSchedule(0, [S.FaultEvent.make(0.0, k, **p) for k, p in events])
        eng = S.ChaosEngine(sched, ad)
        before = dict(M.chaos_metrics().faults_injected._values)

        async def run():
            for ev in sched:
                await eng.apply(ev)

        asyncio.run(run())
        after = M.chaos_metrics().faults_injected._values
        delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        out[name] = (ad.calls, [(e.kind, msg) for e, msg in eng.errors],
                     [e.kind for e in eng.applied], delta)
    assert out["port"] == out["ref"]
    assert out["port"][3] == {("device",): 1, ("network",): 1, ("adversary",): 1}
    # the family is the reference's
    rj, rt = R_metrics.Registry(), T_metrics.Registry()
    R_metrics.ChaosMetrics(rj)
    T_metrics.ChaosMetrics(rt)
    assert rt.expose() == rj.expose()


def test_harness_shard_kinds_are_recorded_as_errors():
    """The harness hands the shard and mesh kinds to the port's injector
    (once refused there naming ROADMAP A6, now ported): the engine applies
    each, the injector holds them armed as the reference's would, and no
    error is recorded (no node is needed: the device kinds touch none)."""
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet

    net = LocalChaosNet(lambda i: None, 2)
    sched = T_chaos.ChaosSchedule(1, [
        T_chaos.FaultEvent.make(0.0, "shard_error", shard=1),
        T_chaos.FaultEvent.make(0.0, "device_lost", device=0),
        T_chaos.FaultEvent.make(0.0, "device_hang", seconds=0.0)])
    eng = T_chaos.ChaosEngine(sched, net)

    async def run():
        for ev in sched:
            await eng.apply(ev)

    asyncio.run(run())
    assert eng.errors == []
    assert sorted(e.kind for e in eng.applied) == ["device_hang", "device_lost", "shard_error"]
    inj = net.injector
    assert inj._shard_errors == [1] and inj._lost_indices == [0]
    net.injector.heal()


# --------------------------------------------------------------- live nets


def make_port_net(n, tmp_path, chain="chaos-smoke", defer=False, device="cpu", edit=None):
    """tests/test_chaos.py:418-452's node factory, on port nodes."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto.keys import gen_ed25519
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    privs = [gen_ed25519(bytes([20 + i]) * 32) for i in range(n)]
    gen = GenesisDoc(chain_id=chain, validators=[GenesisValidator(p.pub_key(), 10)
                                                 for p in privs])

    def make_node(i):
        cfg = test_config()
        cfg.base.db_backend = "memdb"
        cfg.base.fast_sync = False
        cfg.rpc.laddr = ""
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False
        cfg.root_dir = ""
        cfg.consensus.wal_path = str(tmp_path / f"wal{i}" / "wal")
        cfg.consensus.defer_vote_verification = defer
        cfg.instrumentation.forensics_dir = ""
        if edit is not None:
            edit(cfg)
        return Node(cfg, gen, app=KVStoreApplication(), device=device,
                    priv_validator=FilePV(privs[i],
                                          state_file=str(tmp_path / f"pv_state_{i}.json")))

    return make_node, privs


async def _wait_heights(net, pred, hard_timeout=120.0):
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not pred():
        for n in net.live_nodes():
            n.raise_failures()
        if loop.time() - t0 > hard_timeout:
            raise AssertionError(f"chaos net stalled: heights="
                                 f"{[n.block_store.height for n in net.live_nodes()]}")
        await asyncio.sleep(0.05)


def test_chaos_smoke_partition_heal_on_port_nodes(tmp_path):
    """tests/test_chaos.py:466-503 on port nodes: a seeded partition/heal
    schedule, progress after the heal, no safety violation."""
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet

    kw = dict(episodes=2, kinds=("partition",), min_episode=1.0, max_episode=2.0,
              min_gap=0.3, max_gap=0.8, start_delay=0.8)
    sched = T_chaos.ChaosSchedule.generate(20260803, 4, **kw)
    assert sched.fingerprint() == R_chaos.ChaosSchedule.generate(20260803, 4, **kw).fingerprint()

    async def run():
        net = LocalChaosNet(make_port_net(4, tmp_path)[0], 4)
        await net.start()
        try:
            engine = T_chaos.ChaosEngine(sched, net)
            await engine.start()
            assert not engine.errors, engine.errors
            h0 = net.max_height()
            await _wait_heights(
                net, lambda: all(n.block_store.height >= h0 + 2 for n in net.live_nodes()))
            net.assert_safety()
            assert net.committed_evidence() == []
        finally:
            await net.stop()

    asyncio.run(run())


@pytest.mark.parametrize("burst,count", [(False, 16), (True, 48)], ids=["gossip", "burst"])
def test_sig_poison_smoke(tmp_path, monkeypatch, burst, count):
    """A sig_poison from node 0 into three port nodes with deferred vote
    flushes: every flush that holds a poisoned row is False there and
    agrees with ed25519_ref row for row; the scorer quarantines the source
    and then punishes it; each victim's trust reporter records it; the net
    keeps committing, safely."""
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet
    from tendermint_tpu_torch.crypto import ed25519_ref
    from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE

    make_node, privs = make_port_net(4, tmp_path, chain="chaos-poison", defer=True)
    poison = {privs[0].sign(b"tmtpu-sig-poison:" + i.to_bytes(4, "big")) for i in range(count)}
    flushes = []
    real = T_batch.verify_batch

    def vb(pks, msgs, sigs, device=None, key_types=None, backend=None, **kw):
        mask = real(pks, msgs, sigs, device, key_types, backend, **kw)
        flushes.append((list(pks), list(msgs), list(sigs), np.asarray(mask, bool)))
        return mask

    monkeypatch.setattr(T_batch, "verify_batch", vb)
    punished = []
    scorer = T_prov.default_scorer()
    scorer.reset()

    def on_punish(src, info):
        punished.append((src, dict(info)))

    scorer.add_punish_callback(on_punish)

    async def run():
        net = LocalChaosNet(make_node, 4)
        await net.start()
        try:
            await _wait_heights(net, lambda: net.min_height() >= 1)
            sched = T_chaos.ChaosSchedule(3, [T_chaos.FaultEvent.make(
                0.0, "sig_poison", target=0, count=count, burst=burst)])
            engine = T_chaos.ChaosEngine(sched, net)
            await engine.start()
            assert not engine.errors, engine.errors
            h0 = net.max_height()
            await _wait_heights(
                net, lambda: all(n.block_store.height >= h0 + 2 for n in net.live_nodes()))
            net.assert_safety()
            pid = net.nodes[0].node_key.id
            for victim in net.nodes[1:]:
                assert (pid, BAD_MESSAGE) in [(pb.peer_id, pb.kind)
                                              for pb in victim.switch.reporter.history]
            return pid
        finally:
            await net.stop()

    try:
        pid = asyncio.run(run())
    finally:
        scorer.remove_punish_callback(on_punish)
        scorer.reset()
    assert [info["quarantines"] for src, info in punished if src == f"peer:{pid}"] == [1]
    hit = 0
    for pks, msgs, sigs, mask in flushes:
        rows = [k for k, s in enumerate(sigs) if s in poison]
        hit += len(rows)
        assert not mask[rows].any()
        assert mask.tolist() == [ed25519_ref.verify_cofactored(p, m, s)
                                 for p, m, s in zip(pks, msgs, sigs)]
    assert hit >= 11  # the scorer's quarantine (3) and punish (8) gates


def test_device_error_halts_the_port_node_and_the_reference_commits_on(tmp_path, monkeypatch):
    """ROADMAP D1: one node, deferred votes, the vote flushes on the card
    arm ([scheduler] backend, on the plain versions here), a device_error
    armed through the harness. The port's first flush raises the injected
    error, consensus halts with it, and the node raises it; the reference's
    node, armed the same way, absorbs every error in its fallbacks and
    commits on."""
    from tendermint_tpu.abci.kvstore import KVStoreApplication as RApp
    from tendermint_tpu.chaos.harness import LocalChaosNet as RNet
    from tendermint_tpu.config.config import test_config as r_test_config
    from tendermint_tpu.crypto import batch as R_batch
    from tendermint_tpu.crypto.keys import gen_ed25519 as r_gen
    from tendermint_tpu.node.node import Node as RNode
    from tendermint_tpu.privval.file_pv import FilePV as RPV
    from tendermint_tpu.types.genesis import GenesisDoc as RGen
    from tendermint_tpu.types.genesis import GenesisValidator as RGV
    from tendermint_tpu_torch.chaos.device import DeviceFaultError
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet

    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)

    def edit(cfg):
        cfg.scheduler.backend = "cuda"

    make_node, _ = make_port_net(1, tmp_path, chain="d1-port", defer=True, edit=edit)
    sched = T_chaos.ChaosSchedule(0, [T_chaos.FaultEvent.make(0.0, "device_error", count=1000)])

    async def port():
        net = LocalChaosNet(make_node, 1)
        await net.start()
        try:
            node = net.nodes[0]
            if node._prewarm_thread is not None:  # armed after the prewarm
                await asyncio.get_running_loop().run_in_executor(
                    None, node._prewarm_thread.join)
            await T_chaos.ChaosEngine(sched, net).start()
            for _ in range(600):
                if node.consensus.halt_error is not None:
                    break
                await asyncio.sleep(0.05)
            err = node.consensus.halt_error
            assert T_batch.is_device_error(err)
            while not isinstance(err, DeviceFaultError) and err is not None:
                err = err.__cause__ or err.__context__
            assert isinstance(err, DeviceFaultError)
            with pytest.raises(RuntimeError, match="consensus halted"):
                node.raise_failures()
            assert net.injector.fired[0][1] == "error"
            halted_at = node.block_store.height
            await asyncio.sleep(0.3)
            return halted_at, node.block_store.height
        finally:
            net.injector.heal()
            await net.stop()

    halted_at, later = asyncio.run(port())
    assert later == halted_at  # a halted node commits nothing more

    # the reference, beside it: its device path on these rows is the RLC
    # one (RLC_MIN lowered so a vote flush takes it); every device call
    # raises at its entry and its fallback verifies on the host
    monkeypatch.setattr(R_batch, "RLC_MIN", 1)
    k = r_gen(b"\x15" * 32)
    gen = RGen(chain_id="d1-ref", validators=[RGV(k.pub_key(), 10)])

    def make_ref(i):
        cfg = r_test_config()
        cfg.base.db_backend, cfg.root_dir, cfg.rpc.laddr = "memdb", "", ""
        cfg.base.fast_sync, cfg.p2p.plaintext, cfg.p2p.pex = False, True, False
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.consensus.wal_path = str(tmp_path / "ref-wal" / "wal")
        cfg.consensus.defer_vote_verification = True
        cfg.scheduler.backend = "jax"
        return RNode(cfg, gen, priv_validator=RPV(k), app=RApp())

    rsched = R_chaos.ChaosSchedule(0, [R_chaos.FaultEvent.make(0.0, "device_error", count=1000)])

    async def ref():
        net = RNet(make_ref, 1)
        await net.start()
        try:
            await R_chaos.ChaosEngine(rsched, net).start()
            await net.nodes[0].wait_for_height(3, timeout=60)
            return len(net.injector.fired)
        finally:
            net.injector.heal()
            await net.stop()

    assert asyncio.run(ref()) >= 1
