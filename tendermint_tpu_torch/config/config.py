"""Configuration tree (reference config/config.go:55-101): the port's copy
of tendermint_tpu/config/config.py, every section with the reference's
fields and defaults, so that convert.config_from_reference carries a
reference Config across field by field and config/toml.py writes the same
text.

Durations are seconds (float). The consensus timeouts follow the reference:
propose 3 s + 0.5 s a round, prevote and precommit 1 s + 0.5 s a round,
commit 1 s (reference config/config.go:838-848). Some fields are read by
parts of the reference the port has not taken yet (the p2p fabric, the RPC
servers, state sync, the circuit breaker and the mesh health model); they
keep their defaults, and node/node.py refuses the ones that would start
an unported server.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict
from typing import List


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "tpu-node"
    fast_sync: bool = True
    db_backend: str = "sqlite"
    log_level: str = "info"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # remote signer address the node DIALS, e.g. "tcp://127.0.0.1:26659".
    # Fills the role of the reference's PrivValidatorListenAddr
    # (config/config.go) with the dial direction inverted: here the signer
    # listens and the node connects (see privval/remote.py).
    priv_validator_addr: str = ""
    node_key_file: str = "config/node_key.json"
    # In-process app name ("kvstore", "counter", …) OR, when proxy_app is an
    # address, the transport to reach it: "socket" | "grpc"
    # (reference: config/config.go ProxyApp + ABCI).
    abci: str = "kvstore"
    # External app address, e.g. "tcp://127.0.0.1:26658". Empty = run the
    # app named by `abci` in-process (the reference's DefaultClientCreator,
    # proxy/client.go).
    proxy_app: str = ""
    filter_peers: bool = False
    # Ed25519 verification predicate. Default "cofactored" (ZIP-215-style,
    # the framework's batch-friendly predicate on every path — see
    # crypto/ed25519_ref.verify_cofactored). "cofactorless" switches
    # DEFAULT-routed verification to reference-exact semantics (Go
    # ed25519.Verify, reference: crypto/ed25519/ed25519.go): host OpenSSL
    # only, device batch paths disabled for auto-routed calls. REQUIRED
    # when co-validating with reference (Go) nodes: cofactored accepts a
    # strict superset (crafted small-torsion signatures), which is a
    # consensus-fork vector at the 2/3 boundary in a mixed fleet.
    ed25519_verify_mode: str = "cofactored"
    # ABCI socket/grpc client resilience (abci/socket.py, proxy/multi.py).
    # Per-call timeout (the reference's hardwired 30s in socket_client.go
    # promoted to config); reconnect-with-backoff applies to the mempool/
    # query/snapshot connections only — a CONSENSUS connection failure
    # stays fatal-loud (reference: proxy/multi_app_conn.go kills the node
    # on consensus-conn death).
    abci_call_timeout: float = 30.0
    abci_reconnect_attempts: int = 5
    abci_reconnect_base_delay: float = 0.2
    abci_reconnect_max_delay: float = 5.0


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    # gRPC broadcast API (BroadcastTx/Ping only; reference: rpc/grpc/api.go,
    # config/config.go GRPCListenAddress). Empty = disabled.
    grpc_laddr: str = ""
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit: float = 10.0
    max_body_bytes: int = 1000000
    # unlocks the unsafe_* routes (reference: rpc.unsafe in config.toml)
    unsafe: bool = False
    # Load shedding (rpc/server.py): sheddable methods (broadcast_tx_*,
    # queries/searches) run under a bounded concurrency gate; past
    # max_inflight_requests they are refused immediately with HTTP 429 +
    # Retry-After (JSON-RPC error -32005) instead of queueing without
    # bound. Health/status/consensus-critical routes bypass the gate.
    # 0 disables shedding.
    max_inflight_requests: int = 256
    # Retry-After seconds advertised on a shed response
    shed_retry_after: float = 1.0


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_timeout: float = 0.1
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5120000
    recv_rate: int = 5120000
    pex: bool = True
    seed_mode: bool = False
    allow_duplicate_ip: bool = False
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    # test-only adversarial I/O (reference: config/config.go TestFuzz)
    test_fuzz: bool = False
    # deterministic fuzz: seed for the FuzzedConnection rng streams (0 = the
    # reference's non-reproducible behavior); each upgraded connection derives
    # its own stream from (seed, connection ordinal) so a failing fuzz run
    # replays from its seed (p2p/fuzz.py, docs/ROBUSTNESS.md)
    fuzz_seed: int = 0
    # plaintext transport (no secret-connection upgrade): in-process test
    # nets and minimal containers without the `cryptography` wheel. NEVER
    # for production — peers are unauthenticated.
    plaintext: bool = False
    # Per-peer inbound admission control (p2p/conn/connection.py): token
    # buckets per SHEDDABLE channel (mempool/pex/evidence declare
    # sheddable=True on their ChannelDescriptor; consensus channels are
    # exempt — votes are never rate-limited to zero). A message that finds
    # its channel's bucket empty is dropped before reactor dispatch and
    # counted; a peer that keeps flooding past its budget accumulates
    # strikes and is reported to the trust scorer, then disconnected.
    # 0 disables the corresponding bucket.
    recv_rate_limit: bool = True
    recv_rate_bytes_per_channel: int = 1_048_576  # bytes/s per sheddable channel
    recv_rate_msgs_per_channel: int = 2000  # msgs/s per sheddable channel
    # shed events within recv_rate_strike_window seconds before the peer is
    # reported for rate-limit misbehavior (each report records bad conduct;
    # repeated reports push the trust score under the disconnect threshold)
    recv_rate_strikes: int = 200
    recv_rate_strike_window: float = 10.0


@dataclass
class MempoolConfig:
    wal_dir: str = ""  # empty disables the mempool WAL (reference default)
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576
    # Admission control (mempool/mempool.py). TTLs follow the reference's
    # v0.35+ knobs (config/config.go TTLNumBlocks/TTLDuration): a tx older
    # than ttl_seconds OR admitted more than ttl_num_blocks blocks ago is
    # purged on the post-commit update. 0 disables.
    ttl_num_blocks: int = 0
    ttl_seconds: float = 0.0
    # When full, evict lowest-priority/oldest resident txs to admit a
    # higher-priority arrival instead of hard-erroring (the reference
    # priority mempool's eviction); false restores the old "mempool is
    # full" error behavior.
    eviction: bool = True
    # Per-sender in-flight cap for GOSSIPED txs (sender = peer id): one
    # flooding peer cannot occupy the whole pool. 0 = unlimited. Locally
    # submitted txs (RPC, empty sender) are not quota'd.
    max_txs_per_sender: int = 0


@dataclass
class StateSyncConfig:
    enable: bool = False
    rpc_servers: List[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period: float = 168 * 3600.0
    discovery_time: float = 15.0
    # per-chunk fetch timeout before the chunk is re-requested from another
    # peer (statesync/syncer.py; was a hardcoded CHUNK_TIMEOUT alongside
    # this knob — the syncer now honors this value on the node path)
    chunk_request_timeout: float = 10.0
    chunk_fetchers: int = 4
    # retry ladder (ISSUE 12): each chunk gets chunk_retries re-requests —
    # exponential backoff chunk_backoff * 2^attempt, routed to a different
    # peer than the last — before the snapshot is abandoned and the next
    # one (or the blocksync fallback) is tried
    chunk_retries: int = 8
    chunk_backoff: float = 0.25


@dataclass
class FastSyncConfig:
    version: str = "v0"
    # block-request timeout before the assigned peer is punished and the
    # height re-requested, and the scheduler's poll sleep (blocksync/pool.py
    # PEER_TIMEOUT/RETRY_SLEEP promoted to config with the same defaults)
    peer_timeout: float = 10.0
    retry_sleep: float = 0.05


@dataclass
class OverloadConfig:
    """Node-level overload controller (node/overload.py; no reference
    counterpart — the reference sheds implicitly via bounded goroutine
    queues). Samples queue depths into a pressure level that flips the
    shed switches in order: txs first, then non-critical gossip, never
    votes."""

    enabled: bool = True
    sample_interval: float = 0.5
    # fraction of capacity at which a single signal saturates (1.0);
    # pressure level is derived from the max over all signals with
    # hysteresis: ELEVATED at >= elevated_watermark, CRITICAL at
    # >= critical_watermark, stepping back down only below 80% of the
    # entering watermark (no shed/unshed flapping at the boundary)
    elevated_watermark: float = 0.7
    critical_watermark: float = 0.9


@dataclass
class SLOConfig:
    """Declared latency budgets + burn-rate guard policy (libs/slo.py; no
    reference counterpart — the reference leaves SLOs to external alerting).
    Budgets are seconds; an observation over budget is a breach, and an
    error-budget burn rate >= burn_rate_trip over BOTH windows trips the
    objective's guard (tendermint_slo_tripped / GET /debug/slo). Defaults
    are sized for a LAN-ish production net; soaks tighten them to prove
    trips and loosen them to prove compliance."""

    enabled: bool = True
    # target compliance ratio: 1 - target is the error budget
    target: float = 0.99
    # multi-window burn-rate evaluation (seconds) and trip threshold
    window_fast: float = 60.0
    window_slow: float = 600.0
    burn_rate_trip: float = 4.0
    # minimum observations in the fast window before a trip can fire (one
    # slow block on an idle chain must not page)
    min_samples: int = 6
    # -- budgets (seconds) --
    # origin-stamp -> first local receipt of a proposal (skew-corrected)
    proposal_propagation: float = 1.0
    # proposal timestamp -> +2/3 prevote quorum
    prevote_quorum_delay: float = 2.0
    # consecutive committed block timestamps
    commit_interval: float = 15.0
    # one batch-verify flush, any backend
    verify_flush_wall: float = 2.0
    # one light_verify request, admission -> verified response (the serving
    # subsystem's p99 budget; fed by light/service.py per request)
    light_verify_p99: float = 0.5
    # a tx's first receipt (rpc|gossip) -> commit in a finalized block
    # (fed by libs/txtrace.py; the "where is my transaction" budget)
    tx_commit_latency: float = 10.0
    # one dispatched RPC request, any method (fed per request by
    # rpc/server.py's shared _dispatch; with target=0.99 this is the
    # serving path's p99 bound)
    rpc_request_p99: float = 1.0
    # per-lane queue waits of the global verification scheduler
    # (crypto/scheduler.py, fed once per combined flush): votes must land
    # within thread-handoff time, light within its coalescing window plus
    # slack, admission within its bounded-latency promise, catch-up within
    # its idle-soak starvation floor
    verify_lane_wait_votes: float = 0.05
    verify_lane_wait_light: float = 0.1
    verify_lane_wait_admission: float = 0.1
    verify_lane_wait_catchup: float = 5.0
    # quarantine flushes only when every other lane is drained (plus a
    # starvation floor); suspect sources wait accordingly
    verify_lane_wait_quarantine: float = 30.0


@dataclass
class LightServiceConfig:
    """Light-client-as-a-service (light/service.py; no reference
    counterpart — the reference's `tendermint light` is a client-side
    proxy, not a serving subsystem). The node answers skipping-verification
    requests for thousands of clients: repeat heights hit a bounded
    verified-header cache (single-flight), distinct-height misses coalesce
    into shared cross-height device flushes, and admission rides the PR 5
    LoadGate so the live vote path is never starved."""

    enabled: bool = True
    # coalescing window (seconds): the first cache miss arms the window;
    # every miss arriving within it joins ONE shared device flush. 0 still
    # coalesces same-event-loop-tick bursts.
    coalesce_window: float = 0.01
    # window capacity: a window flushes early once this many distinct
    # heights joined (bounds worst-case lanes per flush)
    max_heights_per_flush: int = 64
    # verified-header cache bound (LightStore pruning size)
    cache_blocks: int = 2048
    # service-level admission backstop: misses in flight past this shed
    # with 429 + Retry-After (cache hits are never shed). 0 disables.
    max_pending: int = 1024
    # trusting period (seconds) for the service's anchor span; a trusted
    # ancestor older than this routes through the bisection client
    trust_period: float = 7 * 24 * 3600.0
    # skipping-verification trust level (reference DefaultTrustLevel 1/3)
    trust_level_numerator: int = 1
    trust_level_denominator: int = 3
    # clock drift tolerance (seconds) for header time checks
    max_clock_drift: float = 10.0


@dataclass
class SchedulerConfig:
    """Global verification scheduler (crypto/scheduler.py; no reference
    counterpart — the reference verifies serially at each call site).
    Every verification consumer submits (pubkey, msg, sig) rows to one
    node-wide scheduler with priority lanes: votes PREEMPT (flush
    immediately, alone), light serves within its coalescing-window SLO,
    admission (CheckTx prechecks) gets bounded latency, catch-up
    (blocksync/evidence) soaks idle capacity. Budgets respond to the
    overload controller: pressure level 1 shrinks admission/catch-up
    (rows x pressure_rows_factor, waits x pressure_wait_factor), level 2
    pauses catch-up entirely."""

    enabled: bool = True
    # crypto backend for the combined flushes ("" = crypto default)
    backend: str = ""
    # -- per-lane budgets: max rows taken per combined flush (0 = uncapped)
    # and max seconds a queued row waits before its lane must flush --
    votes_max_rows: int = 0        # votes are never capped or delayed
    votes_max_wait: float = 0.0
    light_max_rows: int = 8192
    light_max_wait: float = 0.01   # the PR 9 coalescing-window SLO; the
    #                                light service re-pins this from its
    #                                [light_service] coalesce_window
    admission_max_rows: int = 1024
    admission_max_wait: float = 0.004
    catchup_max_rows: int = 8192
    catchup_max_wait: float = 0.25
    # quarantine lane (crypto/provenance.py): rows from sources whose rows
    # recently failed; flushes ALONE, only when every other lane is empty
    # (starvation floor = CATCHUP_STARVATION_FACTOR x max_wait)
    quarantine_max_rows: int = 4096
    quarantine_max_wait: float = 0.05
    # overload response (node/overload.py calls set_pressure)
    pressure_rows_factor: float = 0.5
    pressure_wait_factor: float = 2.0
    # device-batched tx admission (the ABCI split): mempool CheckTx decodes
    # signed-tx envelopes (types/signed_tx.py) and batch-verifies their
    # signatures through the admission lane, passing the verdict to the app
    # in RequestCheckTx.sig_precheck instead of the app paying a serial
    # per-tx verify
    admission_precheck: bool = True
    # a consumer blocked on its verdict falls back to an inline host verify
    # after this many seconds (the scheduler must never wedge a consumer)
    wait_timeout: float = 30.0


@dataclass
class ConsensusConfig:
    wal_path: str = "data/cs.wal/wal"
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    double_sign_check_height: int = 0
    # TPU batch-verification knobs (no reference counterpart)
    defer_vote_verification: bool = False
    vote_flush_interval: float = 0.05
    # WAL group-commit (consensus/wal.py): coalesce non-sync WAL writes into
    # one buffered write per receive-loop queue drain, fsynced when the
    # oldest un-synced write has aged past wal_group_commit_max_latency
    # (seconds). write_sync (self-generated messages) still fsyncs before
    # returning regardless, so consensus SAFETY is unchanged. Trade-off for
    # peer/timeout frames: vs. the old writer (which never fsynced them but
    # did land each in the OS page cache per message), group commit adds
    # machine-crash durability via the aged fsync, while a hard PROCESS
    # kill mid-drain can lose up to one drain's worth of peer frames from
    # the replay log (replay completeness, not safety).
    wal_group_commit: bool = True
    wal_group_commit_max_latency: float = 0.02

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit_time(self) -> float:
        return self.timeout_commit

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks or self.create_empty_blocks_interval > 0


@dataclass
class CryptoConfig:
    """Verify-path circuit breaker (crypto/circuit_breaker.py; no reference
    counterpart — the reference's serial host loop has no device to break
    away from). The breaker is process-global like the rest of the crypto
    pipeline; the last Node constructed in a process wins."""

    # trip TPU->CPU-serial after this many CONSECUTIVE device failures
    breaker_enabled: bool = True
    breaker_failure_threshold: int = 3
    # a flush slower than this (seconds) counts as a deadline overrun;
    # breaker_failure_threshold consecutive overruns also trip. 0 disables
    # the deadline (flush time varies hugely with first-compile costs).
    breaker_flush_deadline: float = 0.0
    # health-probe backoff while OPEN: base doubles per failed probe up to max
    breaker_probe_base: float = 1.0
    breaker_probe_max: float = 60.0
    # Streamed flush planner (crypto/batch.py, ISSUE 13): row sets whose
    # lane count would exceed this device budget split into fixed-bucket
    # chunks streamed double-buffered through the RLC pipeline with
    # on-device partial accumulation — a 100k-validator commit (or a
    # 64-block catch-up super-batch) runs at CONSTANT device footprint
    # instead of compiling an unbounded one-off shape. Lanes = 2*rows + 1;
    # the default matches the 10k-commit steady-state bucket.
    max_flush_lanes: int = 24576
    # Stage-overlapped host prep (crypto/batch.py, ISSUE 18).
    # prep_threads: native prep worker-pool width for challenge hashing /
    # scalar derivation / window sort (0 = host default, min(cores, 8)).
    prep_threads: int = 0
    # prep_staged: stage _rlc_submit's host prep (hashing on the prep pool
    # while lane assembly + the A-block upload proceed; only the MSM gather
    # waits on the window sort).
    prep_staged: bool = True
    # prep_stream: let IN-budget flushes of >= prep_stream_floor rows ride
    # the flush planner as a 2-chunk stream (tail prep hides behind head
    # kernels; reuses the planner's warm chunk bucket, no new compiles).
    prep_stream: bool = True
    prep_stream_floor: int = 2048
    # prep_host_stripe: stripe the HOST (no-device) RLC fallback so the
    # next stripe's prep overlaps the current Pippenger MSM. "auto" stripes
    # only on multi-core hosts — on one core the overlap is time-slicing
    # and the MSM split costs wall (cross-stripe per-signer coefficient
    # collapse is lost). "1"/"0" force it on/off.
    prep_host_stripe: str = "auto"
    # Cross-flush verified-row memo (bounded LRU of digests of rows that
    # verified OK; a commit assembled from deferred-verified votes flushes
    # only the unseen residue). 0 disables.
    verified_memo_rows: int = 65536
    # Elastic mesh health model (parallel/health.py, ISSUE 19): per-device
    # failure/stall scoring drives the degrade ladder full -> survivor ->
    # single -> host instead of the breaker's all-or-nothing trip.
    mesh_health_enabled: bool = True
    # consecutive attributed failures before a device is declared dead and
    # the mesh rebuilds over the survivors
    mesh_health_fail_threshold: int = 2
    # a sharded dispatch slower than this (seconds) scores a stall strike
    # on every participant; strikes accumulate to fail_threshold. 0 disables
    # (flush wall varies hugely with first-compile costs).
    mesh_health_stall_threshold: float = 0.0
    # a dead device re-joins (mesh grows back) only after this many
    # CONSECUTIVE clean probes — the rejoin hysteresis that stops a flapping
    # chip from thrashing rebuilds
    mesh_health_rejoin_probes: int = 3
    # background probe cadence for dead devices (seconds)
    mesh_health_probe_interval: float = 2.0


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    namespace: str = "tendermint_tpu"
    # Flight recorder for the batch-verify pipeline (libs/trace.py; no
    # reference counterpart). trace_enabled=false reduces the batch path's
    # tracing work to a single flag check; the ring holds the most recent
    # trace_ring_size span/event records, served by the /debug/trace RPC
    # route. Process-global (like the verify mode): the last Node
    # constructed in a process wins.
    trace_enabled: bool = True
    trace_ring_size: int = 4096
    # consensus timeline ring (consensus/timeline.py): most-recent heights
    # kept for GET /debug/consensus_timeline and post-mortem diffing against
    # `wal-inspect`. Node-local; recording follows trace_enabled.
    timeline_heights: int = 128
    # On-demand profiler captures (libs/profiler.py via
    # GET /debug/device_profile) write run dirs here; empty = a tmtpu_profiles
    # dir under the system temp dir.
    profile_dir: str = ""
    # Transaction lifecycle tracker (libs/txtrace.py): bounded per-tx
    # journey ring behind the tx_status route and GET /debug/tx_trace.
    # Recording itself is gated on trace_enabled (one flag, one contract);
    # txtrace_enabled=false skips constructing the tracker entirely.
    txtrace_enabled: bool = True
    txtrace_ring: int = 8192
    # Stall forensics (libs/forensics.py): device entry points heartbeat
    # phase stamps into an mmap'd ring under this dir and FORENSICS_*.json
    # captures land there — NEVER the repo/app root (ISSUE 8 satellite).
    # Relative paths resolve under root_dir when one is set. Node start
    # sweeps heartbeat files left by dead pids. Empty = disabled (the
    # TMTPU_FORENSICS_DIR env default still applies).
    forensics_dir: str = "./forensics"


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    fastsync: FastSyncConfig = field(default_factory=FastSyncConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    light_service: LightServiceConfig = field(default_factory=LightServiceConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    root_dir: str = ""

    def path(self, rel: str) -> str:
        return os.path.join(self.root_dir, rel)

    def genesis_path(self) -> str:
        return self.path(self.base.genesis_file)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            o = json.load(f)
        cfg = cls()
        for section, data in o.items():
            if section == "root_dir":
                cfg.root_dir = data
                continue
            target = getattr(cfg, section, None)
            if target is None or not isinstance(data, dict):
                continue
            for k, v in data.items():
                if hasattr(target, k):
                    setattr(target, k, v)
        return cfg


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """Short timeouts for in-process tests (reference: config.TestConfig)."""
    cfg = Config()
    cfg.consensus.timeout_propose = 0.4
    cfg.consensus.timeout_propose_delta = 0.1
    cfg.consensus.timeout_prevote = 0.2
    cfg.consensus.timeout_prevote_delta = 0.1
    cfg.consensus.timeout_precommit = 0.2
    cfg.consensus.timeout_precommit_delta = 0.1
    cfg.consensus.timeout_commit = 0.1
    cfg.consensus.skip_timeout_commit = True
    cfg.p2p.laddr = ""  # tests opt in to p2p with an explicit port
    return cfg


test_config.__test__ = False  # not a pytest case when imported into test modules
