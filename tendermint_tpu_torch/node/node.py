"""Node assembly (reference node/node.go:613 NewNode, :840 OnStart): the
port's copy of tendermint_tpu/node/node.py, a standalone node.

Wires: the crypto pipeline's process-global knobs → metrics, tracer,
forensics, SLO engine, verification scheduler, tx tracker, timeline → DBs →
state → the in-process app (4 conns) → handshake/replay → event bus + tx
indexer → mempool (with the scheduler's admission lane) → evidence pool →
block executor → consensus → light service (over LocalNodeProvider) →
overload controller; `start()` then serves the RPC server
(rpc/server.py, `rpc.laddr`), the gRPC broadcast API (rpc/grpc_api.py,
`rpc.grpc_laddr`) and the Prometheus listener (libs/prometheus_server.py,
`instrumentation.prometheus`). There is no p2p switch: every route that
touches p2p answers as the reference does with `switch is None`.

`device` goes to the scheduler, consensus, the block executor, the
handshake and the light service. `None` stays `None` down to
crypto/batch.verify_batch, so every flush routes as the reference's does:
the host arm below 256 rows, the card above; for the scheduler `None` means
the card. Tests pass `device="cpu"`.

What is not ported refuses to start instead of being skipped:
`Node.__init__` raises NotImplementedError, naming the ROADMAP item, for
`p2p.laddr` (A3), `statesync.enable` (A4), a remote `base.proxy_app` (A3)
and `base.priv_validator_addr` (A3). A config made by `test_config()` has
the reference's `rpc.laddr` (127.0.0.1:26657): set it empty for no RPC
server, or to `tcp://127.0.0.1:0` for a free port (`rpc_server.port`).

No fallback (ROADMAP D1): a failed prewarm is kept in `prewarm_error`, and
`wait_for_height` and `stop` raise it; a consensus halt (`halt_error`)
raises from `wait_for_height` too.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Optional

from tendermint_tpu_torch.abci.kvstore import (
    CounterApplication,
    KVStoreApplication,
    PersistentKVStoreApplication,
    SignedKVStoreApplication,
)
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.consensus.cs_state import ConsensusState
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs.kvdb import KVDB, MemDB, SQLiteDB
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.proxy.multi import AppConns, local_client_creator
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.sm_state import state_from_genesis
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.state.txindex import IndexerService, KVTxIndexer
from tendermint_tpu_torch.store.blockstore import BlockStore
from tendermint_tpu_torch.types.event_bus import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc

logger = logging.getLogger("tendermint_tpu_torch.node")


def _open_db(cfg: Config, name: str) -> KVDB:
    if cfg.base.db_backend == "memdb" or not cfg.root_dir:
        return MemDB()
    return SQLiteDB(os.path.join(cfg.root_dir, "data", f"{name}.db"))


def _parse_host_stripe(v):
    """`[crypto] prep_host_stripe` accepts "auto"/"1"/"0" (or a bool from
    programmatic configs); None leaves the process-global setting alone."""
    if v is None or v == "auto":
        return v
    if isinstance(v, str):
        return v not in ("0", "false", "off")
    return bool(v)


def default_app(name: str):
    if name == "kvstore":
        return KVStoreApplication()
    if name == "persistent_kvstore":
        return PersistentKVStoreApplication()
    if name == "counter":
        return CounterApplication()
    if name == "signed_kvstore":
        return SignedKVStoreApplication()
    raise ValueError(f"unknown in-proc app {name!r}")


def _refuse_unported(config: Config) -> None:
    """The parts of the reference's node the port has not taken yet raise
    here, each naming the ROADMAP item that ports it."""
    asks = [
        (config.p2p.laddr, "p2p.laddr", "A3 (the p2p fabric and the reactors)"),
        (config.statesync.enable, "statesync.enable", "A4 (state sync)"),
        (config.base.proxy_app, "base.proxy_app", "A3 (abci/socket.py, abci/grpc.py)"),
        (config.base.priv_validator_addr, "base.priv_validator_addr",
         "A3 (privval/remote.py)"),
    ]
    for value, key, item in asks:
        if value:
            raise NotImplementedError(
                f"{key} = {value!r}: not ported yet (ROADMAP {item}); set it empty or false")


class Node:
    def __init__(
        self,
        config: Config,
        genesis: GenesisDoc,
        priv_validator: Optional[FilePV] = None,
        app=None,
        device=None,
    ):
        _refuse_unported(config)
        self.config = config
        self.genesis = genesis
        self.device = device
        # the chain's verification predicate before any key is checked; the
        # mode is process-global, so a "cofactored" config resets any
        # "cofactorless" left by the environment or an earlier Node
        from tendermint_tpu_torch.crypto.keys import set_verify_mode

        set_verify_mode(config.base.ed25519_verify_mode)
        # the planner budget, the prep pipeline and the verified-row memo
        # (process-global: the last Node constructed in a process wins)
        from tendermint_tpu_torch.crypto import batch as _batch

        _batch.configure_planner(max_flush_lanes=config.crypto.max_flush_lanes)
        _batch.configure_prep(
            prep_threads=config.crypto.prep_threads,
            staged=config.crypto.prep_staged,
            stream=config.crypto.prep_stream,
            stream_floor=config.crypto.prep_stream_floor,
            host_stripe=_parse_host_stripe(config.crypto.prep_host_stripe),
        )
        _batch.configure_verified_memo(rows=config.crypto.verified_memo_rows)
        self.priv_validator = priv_validator

        # metrics (reference: node/node.go:106 DefaultMetricsProvider)
        from tendermint_tpu_torch.libs.metrics import NodeMetrics, PubSubMetrics

        self.metrics = NodeMetrics()

        # flight recorder (libs/trace.py): process-global, last node wins
        from tendermint_tpu_torch.libs import trace as _trace

        _trace.tracer.configure(
            enabled=config.instrumentation.trace_enabled,
            ring_size=config.instrumentation.trace_ring_size,
        )

        # stall forensics (libs/forensics.py): the device round trips
        # heartbeat into a ring under [instrumentation] forensics_dir
        # (relative paths resolve under root_dir); rings left by dead pids
        # are swept here
        fdir = config.instrumentation.forensics_dir
        if fdir:
            from tendermint_tpu_torch.libs import forensics as _forensics

            if not os.path.isabs(fdir) and config.root_dir:
                fdir = os.path.join(config.root_dir, fdir)
            _forensics.configure(fdir)

        # SLO engine (libs/slo.py); the flush feed is process-global
        self.slo = None
        if config.slo.enabled:
            from tendermint_tpu_torch.libs import slo as _slo

            self.slo = _slo.SLOEngine(config.slo, metrics=self.metrics.slo)
            _slo.set_default(self.slo)

        # the node-wide verification scheduler (crypto/scheduler.py): votes
        # preempt, light serves within its window, CheckTx admission
        # batches, catch-up soaks idle capacity. Also the process-global
        # default, for the consumers with no wiring path (types/vote_set.py,
        # evidence/pool.py).
        self.scheduler = None
        if config.scheduler.enabled:
            from tendermint_tpu_torch.crypto import scheduler as _sched

            self.scheduler = _sched.VerifyScheduler(
                config.scheduler,
                device=device,
                metrics=self.metrics.scheduler,
                slo=self.slo,
            )
            _sched.set_default(self.scheduler)

        # tx lifecycle tracker (libs/txtrace.py); recording follows the
        # tracer's flag
        self.tx_tracker = None
        if config.instrumentation.txtrace_enabled:
            from tendermint_tpu_torch.libs.txtrace import TxTracker

            self.tx_tracker = TxTracker(
                max_txs=config.instrumentation.txtrace_ring,
                metrics=self.metrics.txtrace,
                slo=self.slo,
            )

        # per-height/round consensus timeline ring (consensus/timeline.py)
        from tendermint_tpu_torch.consensus.timeline import ConsensusTimeline

        self.timeline = ConsensusTimeline(
            max_heights=config.instrumentation.timeline_heights
        )

        # databases
        self.block_db = _open_db(config, "blockstore")
        self.state_db = _open_db(config, "state")
        self.evidence_db = _open_db(config, "evidence")
        self.block_store = BlockStore(self.block_db)
        self.state_store = StateStore(self.state_db)

        # state from store or genesis
        state = self.state_store.load()
        if state is None:
            genesis.validate_and_complete()
            state = state_from_genesis(genesis)

        # the in-process ABCI app (4 logical connections)
        app = app or default_app(config.base.abci)
        self.app = app
        self.proxy_app = AppConns(local_client_creator(app))

        # event bus + tx indexer (the pubsub counter rides the node's
        # registry: the port's global registry holds the batch family only)
        self.event_bus = EventBus(metrics=PubSubMetrics(self.metrics.registry))
        self.tx_index_db = _open_db(config, "tx_index")
        self.tx_indexer = KVTxIndexer(self.tx_index_db)
        self.indexer_service = IndexerService(self.tx_indexer, self.event_bus)

        # handshake: sync app with chain
        handshaker = Handshaker(self.state_store, state, self.block_store, genesis,
                                self.event_bus, device=device)
        state = handshaker.handshake(self.proxy_app)
        self.state = state

        # mempool, with the scheduler's admission lane
        self.mempool = Mempool(
            self.proxy_app.mempool,
            max_txs=config.mempool.size,
            max_txs_bytes=config.mempool.max_txs_bytes,
            cache_size=config.mempool.cache_size,
            keep_invalid_txs_in_cache=config.mempool.keep_invalid_txs_in_cache,
            recheck=config.mempool.recheck,
            metrics=self.metrics.mempool,
            wal_path=(
                os.path.join(config.root_dir, config.mempool.wal_dir, "wal")
                if config.mempool.wal_dir and config.root_dir
                else ""
            ),
            max_tx_bytes=config.mempool.max_tx_bytes,
            ttl_num_blocks=config.mempool.ttl_num_blocks,
            ttl_seconds=config.mempool.ttl_seconds,
            eviction=config.mempool.eviction,
            max_txs_per_sender=config.mempool.max_txs_per_sender,
            tx_tracker=self.tx_tracker,
            scheduler=self.scheduler,
            sig_precheck=(
                self.scheduler is not None
                and config.scheduler.admission_precheck
            ),
        )

        # evidence pool
        self.evidence_pool = EvidencePool(self.evidence_db, self.state_store, self.block_store)
        self.evidence_pool.set_state(state)

        # block executor
        self.block_exec = BlockExecutor(
            self.state_store,
            self.proxy_app.consensus,
            self.mempool,
            self.evidence_pool,
            event_bus=self.event_bus,
            block_store=self.block_store,
            metrics=self.metrics.state,
            tx_tracker=self.tx_tracker,
            device=device,
        )

        # consensus
        if os.path.isabs(config.consensus.wal_path):
            wal_path = config.consensus.wal_path
        elif config.root_dir:
            wal_path = os.path.join(config.root_dir, config.consensus.wal_path)
        else:
            wal_path = os.path.join(os.getcwd(), ".tmp_wal", "wal")
        self.wal = WAL(
            wal_path,
            group_commit=config.consensus.wal_group_commit,
            group_commit_max_latency=config.consensus.wal_group_commit_max_latency,
        )
        self.consensus = ConsensusState(
            config.consensus,
            state,
            self.block_exec,
            self.block_store,
            self.mempool,
            self.evidence_pool,
            self.wal,
            event_bus=self.event_bus,
            priv_validator=priv_validator,
            metrics=self.metrics.consensus,
            timeline=self.timeline,
            slo=self.slo,
            tx_tracker=self.tx_tracker,
            device=device,
        )

        # light client as a service (light/service.py) over the node's own
        # stores; no background work until the first request
        self.light_service = None
        if config.light_service.enabled:
            from tendermint_tpu_torch.light.service import LightService, LocalNodeProvider

            self.light_service = LightService(
                genesis.chain_id,
                LocalNodeProvider(self),
                config.light_service,
                metrics=self.metrics.light,
                slo=self.slo,
                scheduler=self.scheduler,
                # [scheduler] enabled=false means no lane engine anywhere
                own_scheduler_if_missing=False,
                device=device,
            )

        # the servers start in start(); no p2p fabric (ROADMAP A3): the
        # routes and the overload controller read switch/node_key as None
        self.rpc_server = None
        self.grpc_server = None
        self.prometheus_server = None
        self.switch = None
        self.node_key = None

        # overload controller (node/overload.py): samples queue depths and
        # the RPC gate's inflight into a pressure level, sets the
        # scheduler's budgets and flips the gate's shed switches; the switch
        # and the mempool reactor it also reads are absent here
        from tendermint_tpu_torch.node.overload import OverloadController

        self.overload = OverloadController(
            self, config.overload, metrics=self.metrics.overload
        )

        self._running = False
        self._punish_cb = None
        self._prewarm_thread: Optional[threading.Thread] = None
        self.prewarm_error: Optional[BaseException] = None

    async def start(self) -> None:
        self._running = True
        self._start_crypto_prewarm()
        await self.indexer_service.start()
        await self.consensus.start()
        if self.config.rpc.laddr:
            from tendermint_tpu_torch.rpc.server import RPCServer

            self.rpc_server = RPCServer(self)
            await self.rpc_server.start()
        if self.config.rpc.grpc_laddr:
            from tendermint_tpu_torch.rpc.grpc_api import GrpcBroadcastServer

            self.grpc_server = GrpcBroadcastServer(self, self.config.rpc.grpc_laddr)
            self.grpc_server.start()
        if self.config.instrumentation.prometheus:
            from tendermint_tpu_torch.libs.prometheus_server import PrometheusServer

            self.prometheus_server = PrometheusServer(
                self.metrics, self.config.instrumentation.prometheus_listen_addr
            )
            await self.prometheus_server.start()
        if self.config.overload.enabled:
            self.overload.start()
        self._install_punish_hook()
        logger.info("node started (chain %s)", self.genesis.chain_id)

    def _install_punish_hook(self) -> None:
        """Route suspicion-scorer punishments (crypto/provenance.py): a
        punished ``sender:<id>`` collapses that sender's mempool quota. The
        ``peer:`` half reports to the p2p trust scorer, which waits for the
        p2p fabric (ROADMAP A3)."""
        from tendermint_tpu_torch.crypto import provenance as _prov

        def punish(source: str, info: dict) -> None:
            if source.startswith("sender:"):
                self.mempool.penalize_sender(source[len("sender:"):])

        self._punish_cb = punish
        _prov.default_scorer().add_punish_callback(punish)

    def _start_crypto_prewarm(self) -> None:
        """Build and warm the steady-state verification path for this
        chain's validator-set size in a thread (crypto/batch.prewarm), so a
        node starting into a vote storm does not pay the first builds on
        its receive loop. Only on the card arm, or with BLS keys. A failure
        is kept in `prewarm_error` (no fallback: wait_for_height and stop
        raise it)."""
        from tendermint_tpu_torch.crypto import batch as _batch

        vals = self.consensus.rs.validators
        n_vals = vals.size()
        pubkeys = [v.pub_key.bytes() for v in vals.validators]
        has_bls = any(v.pub_key.type_name() == "bls12_381" for v in vals.validators)
        if n_vals <= 0 or (_batch.backend_default() != "cuda" and not has_bls):
            return

        def run():
            try:
                _batch.prewarm(n_vals, pubkeys=pubkeys, bls=has_bls, device=self.device)
            except BaseException as e:
                logger.exception("crypto kernel prewarm failed")
                self.prewarm_error = e

        self._prewarm_thread = threading.Thread(target=run, name="crypto-prewarm", daemon=True)
        self._prewarm_thread.start()

    def _raise_stored(self) -> None:
        if self.prewarm_error is not None:
            raise RuntimeError("crypto prewarm failed") from self.prewarm_error

    async def stop(self) -> None:
        self._running = False
        if self._punish_cb is not None:
            from tendermint_tpu_torch.crypto import provenance as _prov

            _prov.default_scorer().remove_punish_callback(self._punish_cb)
            self._punish_cb = None
        if self.light_service is not None:
            self.light_service.close()
        if self.scheduler is not None:
            from tendermint_tpu_torch.crypto import scheduler as _sched

            # last-node-wins: deregister only if still ours
            if _sched.default_scheduler() is self.scheduler:
                _sched.set_default(None)
            self.scheduler.close()
        await self.overload.stop()
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.prometheus_server is not None:
            await self.prometheus_server.stop()
        await self.consensus.stop()
        await self.indexer_service.stop()
        self.mempool.close_wal()
        self.proxy_app.stop()
        if self.slo is not None:
            from tendermint_tpu_torch.libs import slo as _slo

            if _slo.default_engine() is self.slo:
                _slo.set_default(None)
        if self._prewarm_thread is not None:
            await asyncio.get_running_loop().run_in_executor(None, self._prewarm_thread.join)
        for db in (self.block_db, self.state_db, self.evidence_db, self.tx_index_db):
            db.close()
        self._raise_stored()

    async def wait_for_height(self, height: int, timeout: float = 30.0) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.block_store.height < height:
            self._raise_stored()
            if self.consensus.halt_error is not None:
                raise RuntimeError("consensus halted") from self.consensus.halt_error
            if loop.time() > deadline:
                raise TimeoutError(
                    f"timed out waiting for height {height} (at {self.block_store.height})"
                )
            await asyncio.sleep(0.02)
        self._raise_stored()
