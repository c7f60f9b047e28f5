"""Node assembly (reference node/node.go:613 NewNode, :840 OnStart): the
port's copy of tendermint_tpu/node/node.py, a standalone node.

Wires: the crypto pipeline's process-global knobs → metrics, tracer,
forensics, SLO engine, verification scheduler, tx tracker, timeline → DBs →
state → the in-process app (4 conns) → handshake/replay → event bus + tx
indexer → mempool (with the scheduler's admission lane) → evidence pool →
block executor → consensus → light service (over LocalNodeProvider) →
overload controller → with `p2p.laddr`, the p2p fabric (node key,
NodeInfo, MultiplexTransport with secret connections unless
`p2p.plaintext`, Switch with the trust store) and its reactors: consensus
(votes to `cs.add_peer_message`, so into the deferred flush), mempool
(each gossiped batch one `check_tx_batch(txs, peer.id)` hop, into the
scheduler's admission lane), evidence, blocksync (catch-up runs into the
scheduler's catch-up lane) and PEX (`p2p.pex`). `start()` then listens on
`p2p.laddr` (the bound address in `p2p_addr`), dials
`p2p.persistent_peers`, and serves the RPC server (rpc/server.py,
`rpc.laddr`), the gRPC broadcast API (rpc/grpc_api.py, `rpc.grpc_laddr`)
and the Prometheus listener (libs/prometheus_server.py,
`instrumentation.prometheus`). With fast sync on (and not the only
validator), consensus starts at the blocksync handoff. Without `p2p.laddr`
every route that touches p2p answers as the reference does with
`switch is None`. The statesync reactor (channels 0x60/0x61) serves the
app's snapshots; with `statesync.enable` on an empty chain it restores one
(`_run_state_sync`: a LightClientStateProvider over `[statesync]
rpc_servers` as HTTPClients, its light checks on `device`), bootstraps the
stores and hands off to block sync.

The app: the in-process app named by `base.abci`, or with `base.proxy_app`
set a remote one through proxy/multi.default_client_creator (`base.abci =
"grpc"` selects abci/grpc.py, which is then the only import of grpc;
otherwise the socket client), with the non-consensus connections
reconnecting (`[base] abci_reconnect_*`). The validator: `priv_validator`,
or with `base.priv_validator_addr` set a privval/remote.SignerClient that
the node closes at stop.

`device` goes to the scheduler, consensus, the block executor, the
handshake and the light service. `None` stays `None` down to
crypto/batch.verify_batch, so every flush routes as the reference's does:
the host arm below 256 rows, the card above; for the scheduler `None` means
the card. Tests pass `device="cpu"`.

A config made by `test_config()` has the reference's `rpc.laddr`
(127.0.0.1:26657): set it empty for no RPC server, or to
`tcp://127.0.0.1:0` for a free port (`rpc_server.port`).

No fallback (ROADMAP D1): a failed prewarm is kept in `prewarm_error`, a
catch-up flush that raised in `blocksync_reactor.verify_error`, a device
error of the state sync (crypto/batch.is_device_error) in
`statesync_error`, and `wait_for_height` and `stop` raise them; a
consensus halt (`halt_error`) raises from `wait_for_height` too. Any other
failure of the state sync falls back to block sync from genesis, as in the
reference. An admission flush that raises under a gossiped batch reaches
the mempool reactor's hop, which logs it.
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
from tendermint_tpu_torch.proxy.multi import (AppConns, default_client_creator,
                                              local_client_creator)
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


class Node:
    def __init__(
        self,
        config: Config,
        genesis: GenesisDoc,
        priv_validator: Optional[FilePV] = None,
        app=None,
        device=None,
    ):
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
        # the mesh health model's policy (parallel/health.py; process-global)
        _batch.configure_mesh_health(
            enabled=config.crypto.mesh_health_enabled,
            fail_threshold=config.crypto.mesh_health_fail_threshold,
            stall_threshold_s=config.crypto.mesh_health_stall_threshold,
            rejoin_probes=config.crypto.mesh_health_rejoin_probes,
            probe_interval_s=config.crypto.mesh_health_probe_interval,
        )
        self._owns_priv_validator = False
        if priv_validator is None and config.base.priv_validator_addr:
            # dial the remote signer (reference: node/node.go:658
            # createAndStartPrivValidatorSocketClient)
            from tendermint_tpu_torch.privval.remote import SignerClient

            host, port = self._parse_laddr(config.base.priv_validator_addr)
            priv_validator = SignerClient(host, port)
            self._owns_priv_validator = True
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

        # ABCI app (4 logical connections); an external proxy_app address
        # selects the socket/grpc transport (reference: proxy/client.go)
        remote_app = bool(config.base.proxy_app)
        if remote_app:
            client_creator = default_client_creator(
                config.base.proxy_app, config.base.abci,
                call_timeout=config.base.abci_call_timeout,
            )
        else:
            app = app or default_app(config.base.abci)
            client_creator = local_client_creator(app)
        self.app = app
        # a remote app's non-consensus conns reconnect with backoff (an app
        # restart must not crash the node); the consensus conn stays fatal
        self.proxy_app = AppConns(
            client_creator,
            resilient=remote_app,
            attempts=config.base.abci_reconnect_attempts,
            base_delay=config.base.abci_reconnect_base_delay,
            max_delay=config.base.abci_reconnect_max_delay,
        )

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

        # the servers start in start()
        self.rpc_server = None
        self.grpc_server = None
        self.prometheus_server = None

        # overload controller (node/overload.py): samples queue depths, the
        # RPC gate's inflight and the peers' send queues into a pressure
        # level, sets the scheduler's budgets and flips the shed switches
        # (the RPC gate, the mempool reactor, the evidence reactor)
        from tendermint_tpu_torch.node.overload import OverloadController

        self.overload = OverloadController(
            self, config.overload, metrics=self.metrics.overload
        )

        # p2p (reference: node/node.go:754-793 createTransport/createSwitch)
        self.switch = None
        self.node_key = None
        self.p2p_addr = None
        self.consensus_reactor = None
        self.mempool_reactor = None
        self.blocksync_reactor = None
        self.statesync_reactor = None
        self.addr_book = None
        self.pex_reactor = None
        self.fast_sync = False
        # state sync only makes sense on an empty chain
        # (reference: node/node.go:672 decide stateSync)
        self.state_sync = bool(config.statesync.enable) and self.block_store.height == 0
        self._statesync_task: Optional[asyncio.Task] = None
        # the state provider state sync uses; None builds the reference's
        # LightClientStateProvider over `[statesync] rpc_servers` (a fleet
        # harness sets one over a LocalClient, chaos/fleet.py)
        self._state_provider = None
        self.statesync_error: Optional[BaseException] = None
        if config.p2p.laddr:
            self._build_p2p(config, genesis, state, priv_validator)
        else:
            self.state_sync = False

        self._running = False
        self._punish_cb = None
        self._prewarm_thread: Optional[threading.Thread] = None
        self.prewarm_error: Optional[BaseException] = None

    def _build_p2p(self, config: Config, genesis: GenesisDoc, state, priv_validator) -> None:
        """The switch and its reactors (reference node/node.py:399-548)."""
        from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
        from tendermint_tpu_torch.mempool.reactor import MempoolReactor
        from tendermint_tpu_torch.p2p import MultiplexTransport, NodeInfo, NodeKey, Switch
        from tendermint_tpu_torch.statesync.reactor import StatesyncReactor

        if Switch is None:
            # the package gates the networked pieces when the `cryptography`
            # wheel is absent; a node that configured a listener fails loudly
            raise ImportError(
                "p2p.laddr is configured but the p2p transport is "
                "unavailable (missing `cryptography` wheel)"
            )
        if not config.p2p.plaintext:
            from tendermint_tpu_torch.p2p.conn.secret_connection import HAVE_CRYPTOGRAPHY

            if not HAVE_CRYPTOGRAPHY:
                raise ImportError(
                    "p2p.laddr is configured with secret connections but "
                    "the `cryptography` wheel is missing; set "
                    "p2p.plaintext=true for unauthenticated in-process "
                    "test nets"
                )
        if config.root_dir:
            self.node_key = NodeKey.load_or_gen(
                os.path.join(config.root_dir, "config", "node_key.json")
            )
        else:
            self.node_key = NodeKey.generate()
        node_info = NodeInfo(
            node_id=self.node_key.id,
            listen_addr=config.p2p.laddr,
            network=genesis.chain_id,
            moniker=config.base.moniker,
        )
        fuzz_cfg = None
        if config.p2p.test_fuzz:
            from tendermint_tpu_torch.p2p.fuzz import FuzzConfig

            # seeded: every fuzzed connection's fault sequence replays from
            # [p2p] fuzz_seed (transport._upgrade's derivation)
            fuzz_cfg = FuzzConfig(seed=config.p2p.fuzz_seed)
        transport = MultiplexTransport(
            self.node_key,
            node_info,
            use_secret_conn=not config.p2p.plaintext,
            fuzz_config=fuzz_cfg,
        )
        trust_path = (
            os.path.join(config.root_dir, "data", "trust_metrics.json")
            if config.root_dir
            else None
        )
        recv_limit = None
        if config.p2p.recv_rate_limit:
            from tendermint_tpu_torch.p2p.conn.connection import RecvRateLimit

            recv_limit = RecvRateLimit(
                bytes_per_s=config.p2p.recv_rate_bytes_per_channel,
                msgs_per_s=config.p2p.recv_rate_msgs_per_channel,
                strikes=config.p2p.recv_rate_strikes,
                strike_window=config.p2p.recv_rate_strike_window,
            )
        self.switch = Switch(
            transport, metrics=self.metrics.p2p, trust_store_path=trust_path,
            recv_limit=recv_limit,
        )
        # fast sync is pointless when we are the only validator
        # (reference: node/node.go onlyValidatorIsUs)
        only_us = (
            priv_validator is not None
            and state.validators.size() == 1
            and state.validators.validators[0].address
            == priv_validator.get_pub_key().address()
        )
        self.fast_sync = bool(config.base.fast_sync) and not only_us
        self.consensus_reactor = ConsensusReactor(
            self.consensus, wait_sync=self.fast_sync or self.state_sync
        )
        self.switch.add_reactor("CONSENSUS", self.consensus_reactor)
        self.mempool_reactor = MempoolReactor(
            self.mempool, broadcast=config.mempool.broadcast,
            metrics=self.metrics.overload,
        )
        self.switch.add_reactor("MEMPOOL", self.mempool_reactor)
        self.switch.add_reactor("EVIDENCE", EvidenceReactor(self.evidence_pool))
        # crash-resume checkpoints: only nodes with a real root dir persist
        # them (memdb test nodes re-fetch, always safe)
        catchup_ckpt = (
            os.path.join(config.root_dir, "data", "catchup_checkpoint.json")
            if config.root_dir
            else None
        )
        restore_ckpt = (
            os.path.join(config.root_dir, "data", "statesync_checkpoint.json")
            if config.root_dir
            else None
        )
        self.blocksync_reactor = BlocksyncReactor(
            state, self.block_exec, self.block_store,
            consensus_reactor=self.consensus_reactor,
            # a state-sync node starts blocksync only after the restore
            active=self.fast_sync and not self.state_sync,
            metrics=self.metrics.blocksync,
            peer_timeout=config.fastsync.peer_timeout,
            retry_sleep=config.fastsync.retry_sleep,
            scheduler=self.scheduler,
            checkpoint_path=catchup_ckpt,
            device=self.device,
        )
        self.switch.add_reactor("BLOCKSYNC", self.blocksync_reactor)
        self.statesync_reactor = StatesyncReactor(
            self.proxy_app.snapshot, self.proxy_app.query, active=self.state_sync,
            metrics=self.metrics.statesync,
            checkpoint_path=restore_ckpt,
        )
        self.switch.add_reactor("STATESYNC", self.statesync_reactor)
        if config.p2p.pex:
            from tendermint_tpu_torch.p2p.pex import AddrBook, PexReactor

            book_file = (
                os.path.join(config.root_dir, "config", "addrbook.json")
                if config.root_dir
                else None
            )
            self.addr_book = AddrBook(book_file)
            seeds = [s.strip() for s in config.p2p.seeds.split(",") if s.strip()]
            self.pex_reactor = PexReactor(
                self.addr_book,
                seeds=seeds,
                max_outbound=config.p2p.max_num_outbound_peers,
                seed_mode=config.p2p.seed_mode,
            )
            self.switch.add_reactor("PEX", self.pex_reactor)

    @staticmethod
    def _parse_laddr(laddr: str) -> tuple:
        addr = laddr.split("://", 1)[-1]
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    async def start(self) -> None:
        self._running = True
        self._start_crypto_prewarm()
        await self.indexer_service.start()
        if not (self.switch is not None and (self.fast_sync or self.state_sync)):
            # with fast or state sync on, consensus starts at the blocksync
            # handoff (reference: node/node.go:897 -> SwitchToConsensus)
            await self.consensus.start()
        if self.switch is not None:
            await self.switch.start()
            host, port = self._parse_laddr(self.config.p2p.laddr)
            self.p2p_addr = await self.switch.transport.listen(host, port)
            if self.config.p2p.persistent_peers:
                peers = [a.strip() for a in self.config.p2p.persistent_peers.split(",")
                         if a.strip()]
                await self.switch.dial_peers_async(peers, persistent=True)
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
        if self.state_sync:
            self._statesync_task = asyncio.create_task(
                self._run_state_sync(), name="statesync"
            )
        if self.config.overload.enabled:
            self.overload.start()
        self._install_punish_hook()
        logger.info("node started (chain %s)", self.genesis.chain_id)

    def _install_punish_hook(self) -> None:
        """Route suspicion-scorer punishments (crypto/provenance.py): a
        punished ``peer:<id>`` feeds the switch's trust reporter a
        BAD_MESSAGE report (repeated reports drop the peer below the trust
        threshold and disconnect it), and a punished ``sender:<id>``
        collapses that sender's mempool quota. The callback fires on a
        verify thread, so p2p reports hop to the event loop."""
        from tendermint_tpu_torch.crypto import provenance as _prov

        loop = asyncio.get_running_loop()

        def punish(source: str, info: dict) -> None:
            if source.startswith("peer:"):
                if self.switch is None:
                    return
                from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE, PeerBehaviour

                pb = PeerBehaviour(
                    source[len("peer:"):], BAD_MESSAGE,
                    f"signature poisoning ({info.get('offenses', 0)} bad rows in quarantine)",
                )

                def _report():
                    asyncio.ensure_future(self.switch.reporter.report(pb))

                loop.call_soon_threadsafe(_report)
            elif source.startswith("sender:"):
                self.mempool.penalize_sender(source[len("sender:"):])

        self._punish_cb = punish
        _prov.default_scorer().add_punish_callback(punish)

    async def _run_state_sync(self) -> None:
        """Restore from a peer snapshot, bootstrap the stores, then hand off
        to block sync (reference: node/node.go:560 startStateSync). A device
        error is kept in `statesync_error` with no fallback (ROADMAP D1);
        any other failure falls back to block sync from genesis, as in the
        reference."""
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.statesync.stateprovider import (
            LightClientStateProvider,
        )

        cfg = self.config.statesync
        clients = []
        provider = self._state_provider
        if provider is None:
            clients = [HTTPClient(u) for u in cfg.rpc_servers]
            provider = LightClientStateProvider(
                self.genesis.chain_id,
                clients,
                cfg.trust_height,
                bytes.fromhex(cfg.trust_hash),
                int(cfg.trust_period * 1_000_000_000),
                device=self.device,
            )
        try:
            try:
                state, commit = await self.statesync_reactor.sync(
                    provider,
                    cfg.discovery_time,
                    chunk_fetchers=cfg.chunk_fetchers,
                    chunk_timeout=cfg.chunk_request_timeout,
                    chunk_retries=cfg.chunk_retries,
                    chunk_backoff=cfg.chunk_backoff,
                )
            finally:
                for c in clients:  # the sessions this node opened
                    await c.close()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            from tendermint_tpu_torch.crypto.batch import is_device_error

            if is_device_error(e):
                logger.error("state sync hit a device error: %r", e)
                self.statesync_error = e
                return
            # every snapshot or peer exhausted (the retry ladder's
            # ErrNoSnapshots), or a provider failure: block sync from genesis
            logger.exception("state sync failed; falling back to block sync")
            self.metrics.statesync.fallbacks_total.inc()
            await self.blocksync_reactor.switch_to_blocksync(self.state)
            return
        self.state_store.bootstrap(state)
        self.block_store.save_seen_commit(state.last_block_height, commit)
        self.state = state
        self.evidence_pool.set_state(state)
        logger.info(
            "state synced to height %d; switching to block sync",
            state.last_block_height,
        )
        await self.blocksync_reactor.switch_to_blocksync(state)

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
        bs = self.blocksync_reactor
        if bs is not None and bs.verify_error is not None:
            raise RuntimeError("catch-up verification failed") from bs.verify_error
        if self.statesync_error is not None:
            raise RuntimeError("state sync failed on a device error") from self.statesync_error

    def raise_failures(self) -> None:
        """Raise the first failure the node has stored (`_raise_stored`) or
        its consensus halt; the command line's `start` polls it."""
        self._raise_stored()
        if self.consensus.halt_error is not None:
            raise RuntimeError("consensus halted") from self.consensus.halt_error

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
        if self._statesync_task is not None:
            self._statesync_task.cancel()
            await asyncio.gather(self._statesync_task, return_exceptions=True)
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.prometheus_server is not None:
            await self.prometheus_server.stop()
        if self.switch is not None:
            await self.switch.stop()
        await self.consensus.stop()
        await self.indexer_service.stop()
        if self._owns_priv_validator:
            self.priv_validator.close()
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
            self.raise_failures()
            if loop.time() > deadline:
                raise TimeoutError(
                    f"timed out waiting for height {height} (at {self.block_store.height})"
                )
            await asyncio.sleep(0.02)
        self._raise_stored()
