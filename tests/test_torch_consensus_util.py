"""One consensus fixture for both packages, and a record-and-replay runner:
helpers of tests/test_torch_consensus_state.py, test_torch_consensus_codecs.py,
test_torch_abci.py and test_torch_execution.py (this module holds no test).

`Pkg("ref")` / `Pkg("port")` name the modules of the JAX package or of the
port; `Node(pkg, seeds, ...)` is the reference's tests/test_consensus_state.py
Fixture over either: a kvstore app behind local ABCI connections, memory or
SQLite stores, a mempool, an evidence pool, the Handshaker's InitChain, a WAL
and a ConsensusState whose own validator is validator `own` of the set
(sorted by address at equal power: validator 0 proposes height 1, round 0).
Validator keys come from numpy-seeded 32-byte seeds.

A scenario is an async function of a `Runner`. Run first on the reference,
the runner signs every injected proposal, part and vote there (OpenSSL) and
records them; run on the port, it injects the same messages, carried across
by their wire bytes. Both runs read one fake clock (`FakeTime`, patched into
each package's cs_state module), so timestamps, blocks and the node's own
votes are the same bytes in both.
"""

import asyncio
import contextlib
import dataclasses
import importlib
import time as _time
from types import SimpleNamespace

import numpy as np

T0 = 1_700_000_000_000_000_000

_MODULES = {
    "kvstore": "abci.kvstore", "abci": "abci.types", "client": "abci.client",
    "multi": "proxy.multi", "cs_state": "consensus.cs_state", "messages": "consensus.messages",
    "round_state": "consensus.round_state", "wal": "consensus.wal", "replay": "consensus.replay",
    "evidence_pool": "evidence.pool", "kvdb": "libs.kvdb", "mempool": "mempool.mempool",
    "file_pv": "privval.file_pv", "execution": "state.execution", "sm_state": "state.sm_state",
    "state_store": "state.store", "blockstore": "store.blockstore", "basic": "types.basic",
    "block": "types.block", "event_bus": "types.event_bus", "genesis": "types.genesis",
    "part_set": "types.part_set", "proposal": "types.proposal", "vote": "types.vote",
    "keys": "crypto.keys", "params": "types.params", "pubsub": "libs.pubsub",
    "evidence": "types.evidence", "metrics": "libs.metrics", "txtrace": "libs.txtrace",
    "timeline": "consensus.timeline", "signed_tx": "types.signed_tx", "hotstats": "libs.hotstats",
    "scheduler": "crypto.scheduler", "txindex": "state.txindex", "forensics": "libs.forensics",
    "overload": "node.overload", "tmhash": "crypto.tmhash", "toml": "config.toml",
    "trace": "libs.trace", "service": "libs.service", "log": "libs.log",
}


def Pkg(which: str) -> SimpleNamespace:
    root = "tendermint_tpu" if which == "ref" else "tendermint_tpu_torch"
    ns = SimpleNamespace(which=which, **{k: importlib.import_module(f"{root}.{m}")
                                         for k, m in _MODULES.items()})
    ns.config = importlib.import_module("tendermint_tpu.config.config" if which == "ref"
                                        else "tendermint_tpu_torch.config")
    return ns


class FakeTime:
    """The clock both packages' cs_state read: time_ns() and time() return
    `now_ns`, which only the runner moves; perf_counter is the real one."""

    def __init__(self, now_ns: int = T0):
        self.now_ns = now_ns

    def time_ns(self) -> int:
        return self.now_ns

    def time(self) -> float:
        return self.now_ns / 1e9

    perf_counter = staticmethod(_time.perf_counter)


class FakeClock(FakeTime):
    """FakeTime whose perf_counter reads the fake clock too: step, round
    and stage durations are then what the runner moved the clock by."""

    def perf_counter(self) -> float:
        return self.now_ns / 1e9


# the modules whose `time` a hooked run reads from the fake clock
HOOKED_TIME = ("cs_state", "timeline", "txtrace", "mempool")


def seeds(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


class Node:
    """The reference's consensus Fixture over either package."""

    def __init__(self, pkg, val_seeds, wal_path: str, chain_id: str = "cs-torch-chain",
                 defer: bool = False, db=None, cfg_edit=None, device="cpu", txs=(),
                 own: int = 1, hooks: bool = False):
        """hooks: the node's metrics (ConsensusMetrics, StateMetrics and
        TxLifecycleMetrics on `self.registry`), the timeline ring and the
        tx tracker are wired, as node/node.py wires them."""
        self.pkg, self.chain_id, self.own = pkg, chain_id, own
        P = pkg
        self.hooks = hooks
        self.registry = P.metrics.Registry() if hooks else None
        self.timeline = P.timeline.ConsensusTimeline() if hooks else None
        self.tx_tracker = (P.txtrace.TxTracker(metrics=P.metrics.TxLifecycleMetrics(self.registry))
                           if hooks else None)
        self.privs = [P.file_pv.FilePV(P.keys.gen_ed25519(s)) for s in val_seeds]
        gen = P.genesis.GenesisDoc(chain_id=chain_id, validators=[
            P.genesis.GenesisValidator(p.get_pub_key(), 10) for p in self.privs])
        gen.validate_and_complete()
        state = P.sm_state.state_from_genesis(gen)
        by_addr = {p.get_pub_key().address(): p for p in self.privs}
        self.privs = [by_addr[v.address] for v in state.validators.validators]
        db = db or (lambda name: P.kvdb.MemDB())
        self.app = P.kvstore.KVStoreApplication()
        self.proxy = P.multi.AppConns(P.multi.local_client_creator(self.app))
        self.block_store = P.blockstore.BlockStore(db("blocks"))
        self.state_store = P.state_store.StateStore(db("state"))
        self.state_store.save(state)
        self.event_bus = P.event_bus.EventBus()
        self.mempool = P.mempool.Mempool(self.proxy.mempool, tx_tracker=self.tx_tracker)
        for tx in txs:
            self.mempool.check_tx(tx)
        self.evpool = P.evidence_pool.EvidencePool(db("evidence"), self.state_store,
                                                   self.block_store)
        self.evpool.set_state(state)
        port = {"device": device} if P.which == "port" else {}
        exec_hooks, cs_hooks = {}, {}
        if hooks:
            exec_hooks = dict(metrics=P.metrics.StateMetrics(self.registry),
                              tx_tracker=self.tx_tracker)
            cs_hooks = dict(metrics=P.metrics.ConsensusMetrics(self.registry),
                            timeline=self.timeline, tx_tracker=self.tx_tracker)
        self.block_exec = P.execution.BlockExecutor(
            self.state_store, self.proxy.consensus, self.mempool, self.evpool,
            event_bus=self.event_bus, block_store=self.block_store, **exec_hooks, **port)
        cfg = P.config.test_config().consensus
        cfg.defer_vote_verification = defer
        if cfg_edit is not None:
            cfg_edit(cfg)
        state = P.replay.Handshaker(self.state_store, state, self.block_store, gen,
                                    self.event_bus, **port).handshake(self.proxy)
        self.own_votes = []
        pv = self.privs[own]
        real_sign = pv.sign_vote

        def sign_vote(chain_id, vote):
            out = real_sign(chain_id, vote)
            self.own_votes.append(out.encode())
            return out

        pv.sign_vote = sign_vote
        self.cs = P.cs_state.ConsensusState(
            cfg, state, self.block_exec, self.block_store, self.mempool, self.evpool,
            P.wal.WAL(wal_path), event_bus=self.event_bus, priv_validator=pv, **cs_hooks,
            **port)
        q = P.event_bus.query_for_event(P.event_bus.EVENT_NEW_ROUND_STEP)
        self.steps = self.event_bus.subscribe("wait", q, 10_000)
        self.record = self.event_bus.subscribe("record", q, 10_000)

    def proposer_idx(self) -> int:
        rs = self.cs.rs
        addr = rs.validators.get_proposer().address
        return next(i for i, v in enumerate(rs.validators.validators) if v.address == addr)

    def step_log(self) -> list:
        out = []
        while not self.record.queue.empty():
            d = self.record.queue.get_nowait().data
            out.append((d.height, d.round, d.step))
        return out

    def outcome(self) -> dict:
        """What the comparison reads: the (height, round, step) events,
        the node's own votes, each stored block's hash and its seen
        commit, the state's app hash and the pending evidence, as bytes."""
        bs = self.block_store
        return dict(
            steps=self.step_log(), own_votes=self.own_votes,
            blocks=[bs.load_block(h).hash() for h in range(1, bs.height + 1)],
            seen_commits=[bs.load_seen_commit(h).encode() for h in range(1, bs.height + 1)],
            app_hash=self.state_store.load().app_hash,
            evidence=[e.encode() for e in self.evpool.pending_evidence(-1)],
            halted=getattr(self.cs, "halt_error", None) is not None)


class Runner:
    """Scenario operations over one Node. On the reference (`script` None)
    every injected message is signed there and appended to `self.script`;
    on the port (`script` given) the same messages are injected, decoded
    from their wire bytes."""

    def __init__(self, node: Node, clock: FakeTime, script=None, stub_privs=None):
        self.node, self.clock = node, clock
        self.cs = node.cs
        self.replay = script is not None
        self.script = list(script) if script is not None else []
        self.stub_privs = stub_privs  # the reference's FilePVs, in set order
        self._pos = 0

    async def start(self):
        await self.cs.start()

    async def stop(self):
        await self.cs.stop()

    async def sleep(self, t: float):
        await asyncio.sleep(t)

    async def settle(self, t: float = 0.05):
        """Let the receive loop drain its queue and any timers due."""
        for _ in range(200):
            await asyncio.sleep(t)
            if self.cs._queue.empty():
                return

    async def wait_step(self, step: str, height=None, round_=None, timeout=20.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                rs = self.cs.rs
                raise TimeoutError(f"waiting for {step} h={height} r={round_}; at "
                                   f"{rs.height}/{rs.round}/{rs.step.name}")
            try:
                d = (await asyncio.wait_for(self.node.steps.next(), remaining)).data
            except asyncio.TimeoutError:
                continue
            if d.step == step and height in (None, d.height) and round_ in (None, d.round):
                return

    @contextlib.contextmanager
    def _harness(self):
        """The runner's own signing and encoding is not the node's work:
        hotstats does not count it."""
        hs = self.node.pkg.hotstats.stats
        prev, hs.enabled = hs.enabled, False
        try:
            yield
        finally:
            hs.enabled = prev

    def _next(self, kind):
        item = self.script[self._pos]
        self._pos += 1
        assert item[0] == kind, (item[0], kind)
        return item[1:]

    async def _inject(self, raw_msgs, peer):
        M = self.node.pkg.messages
        for raw in raw_msgs:
            await self.cs.add_peer_message(M.decode_message(raw), peer)

    async def proposal(self, round_: int = 0, txs_from_mempool: bool = True):
        """The current proposer's proposal and parts for the node's height,
        unless the node proposed it itself."""
        if self.replay:
            raw, peer = self._next("proposal")
            await self._inject(raw, peer)
            return
        node, rs = self.node, self.cs.rs
        if rs.proposal_block is not None:
            self.script.append(("proposal", [], ""))
            return
        with self._harness():
            raw, peer = self._sign_proposal(round_)
        self.script.append(("proposal", raw, peer))
        await self._inject(raw, peer)

    def _sign_proposal(self, round_: int):
        node, rs = self.node, self.cs.rs
        P = node.pkg
        idx = node.proposer_idx()
        height = rs.height
        if height == node.cs.state.initial_height:
            commit = P.block.Commit(0, 0, P.basic.BlockID(), ())
        else:
            commit = rs.last_commit.make_commit()
        proposer = rs.validators.validators[idx]
        block = node.block_exec.create_proposal_block(height, node.cs.state, commit,
                                                      proposer.address, self.clock.now_ns)
        parts = P.part_set.PartSet.from_data(block.encode())
        prop = P.proposal.Proposal(height=height, round=round_, pol_round=-1,
                                   block_id=P.basic.BlockID(block.hash(), parts.header),
                                   timestamp_ns=self.clock.now_ns)
        prop = node.privs[idx].sign_proposal(node.chain_id, prop)
        msgs = [P.messages.ProposalMessage(prop)] + [
            P.messages.BlockPartMessage(height, round_, parts.get_part(i))
            for i in range(parts.total)]
        return [P.messages.encode_message(m) for m in msgs], f"stub-{idx}"

    def proposal_block_id(self):
        rs, P = self.cs.rs, self.node.pkg
        return P.basic.BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header)

    async def votes(self, type_name: str, height: int, round_: int, target, idxs,
                    raw: bool = False, bad=()):
        """Votes of validators `idxs` for `target` ("proposal", "locked",
        "nil" or a (hash, psh_total, psh_hash) triple), signed by the reference's
        FilePVs; the rows in `bad` carry a flipped signature byte."""
        if self.replay:
            for raw_msg, peer in self._next("votes")[0]:
                await self._inject([raw_msg], peer)
            return
        with self._harness():
            out = self._sign_votes(type_name, height, round_, target, idxs, raw, bad)
        self.script.append(("votes", out))
        for raw_msg, peer in out:
            await self._inject([raw_msg], peer)

    def _sign_votes(self, type_name, height, round_, target, idxs, raw, bad):
        P = self.node.pkg
        if target == "proposal":
            bid = self.proposal_block_id()
        elif target == "locked":
            rs = self.cs.rs
            bid = P.basic.BlockID(rs.locked_block.hash(), rs.locked_block_parts.header)
        elif target == "nil":
            bid = P.basic.BlockID()
        else:
            bid = P.basic.BlockID(target[0], P.basic.PartSetHeader(target[1], target[2]))
        out = []
        for i in idxs:
            pv = self.node.privs[i]
            vote = P.vote.Vote(type=P.basic.SignedMsgType[type_name], height=height,
                               round=round_, block_id=bid, timestamp_ns=self.clock.now_ns,
                               validator_address=pv.get_pub_key().address(),
                               validator_index=i)
            if raw or i in bad:
                sig = pv.priv_key.sign(vote.sign_bytes(self.node.chain_id))
                if i in bad:
                    sig = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
                vote = dataclasses.replace(vote, signature=sig)
            else:
                vote = pv.sign_vote(self.node.chain_id, vote)
            out.append((P.messages.encode_message(P.messages.VoteMessage(vote)), f"stub-{i}"))
        return out

    def tick(self, ns: int):
        self.clock.now_ns += ns


def run_scenario(pkg, scenario, val_seeds, tmp_path, script=None, defer=False,
                 cfg_edit=None, txs=(), own: int = 1, hooks: bool = False):
    """Run `scenario(runner)` on one package under a fresh fake clock;
    returns (outcome, script). With `hooks` the metrics, timeline and tx
    tracker are wired and read the fake clock (FakeClock) in every module
    of HOOKED_TIME."""
    clock = FakeClock() if hooks else FakeTime()
    names = HOOKED_TIME if hooks else ("cs_state",)
    real = {n: getattr(pkg, n).time for n in names}
    for n in names:
        getattr(pkg, n).time = clock
    try:
        node = Node(pkg, val_seeds, str(tmp_path / f"wal-{pkg.which}"), defer=defer,
                    cfg_edit=cfg_edit, txs=txs, own=own, hooks=hooks)
        drv = Runner(node, clock, script)

        async def main():
            await drv.start()
            try:
                await scenario(drv)
            finally:
                await drv.stop()

        asyncio.run(main())
    finally:
        for n, mod in real.items():
            getattr(pkg, n).time = mod
    return node.outcome(), drv.script, node


def run_chain(pkg, val_seeds, wal_path: str, heights: int, db=None, txs=(), own: int = 0):
    """A chain of validators that all live in this node (one validator, or
    the node alone holding +2/3) run until `heights` blocks are stored;
    returns the stopped Node."""
    node = Node(pkg, val_seeds, wal_path, db=db, txs=txs, own=own)

    async def main():
        await node.cs.start()
        try:
            while node.block_store.height < heights:
                await asyncio.sleep(0.01)
        finally:
            await node.cs.stop()

    asyncio.run(main())
    return node
