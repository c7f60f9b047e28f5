"""Configuration of the port: copies of `SLOConfig`, `SchedulerConfig`,
`LightServiceConfig`, `ConsensusConfig` and `MempoolConfig` from
tendermint_tpu/config/config.py (:133, :210-340, :343), with the same fields
and defaults, and `Config` / `test_config()` as far as the consensus slice
reads them. convert.py carries the reference's instances across field by
field. The rest of the node's configuration (base, RPC, p2p, state sync,
crypto, instrumentation) and its TOML form wait for the node (ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SLOConfig:
    """libs/slo.py: declared latency budgets (seconds) and the burn-rate
    guard. An observation over its budget is a breach; an error-budget burn
    rate >= burn_rate_trip over both windows trips the objective."""

    enabled: bool = True
    # target compliance ratio: 1 - target is the error budget
    target: float = 0.99
    # multi-window burn-rate evaluation (seconds) and trip threshold
    window_fast: float = 60.0
    window_slow: float = 600.0
    burn_rate_trip: float = 4.0
    # observations in the fast window before a trip can fire
    min_samples: int = 6
    # budgets (seconds)
    proposal_propagation: float = 1.0
    prevote_quorum_delay: float = 2.0
    commit_interval: float = 15.0
    verify_flush_wall: float = 2.0
    light_verify_p99: float = 0.5
    tx_commit_latency: float = 10.0
    rpc_request_p99: float = 1.0
    verify_lane_wait_votes: float = 0.05
    verify_lane_wait_light: float = 0.1
    verify_lane_wait_admission: float = 0.1
    verify_lane_wait_catchup: float = 5.0
    verify_lane_wait_quarantine: float = 30.0


@dataclass
class LightServiceConfig:
    """light/service.py: the light client as a service. Repeat heights hit
    a bounded verified-header cache (single-flight); distinct-height misses
    coalesce into shared cross-height flushes on the scheduler's light
    lane."""

    enabled: bool = True
    # coalescing window (seconds): the light lane holds rows this long, so
    # misses arriving within it share one flush; 0 still coalesces
    # same-event-loop-tick bursts
    coalesce_window: float = 0.01
    # a batch of jobs fires early once this many distinct heights joined
    max_heights_per_flush: int = 64
    # verified-header cache bound (LightStore pruning size)
    cache_blocks: int = 2048
    # misses in flight past this are shed (cache hits never are); 0 disables
    max_pending: int = 1024
    # trusting period (seconds) of the service's anchor span
    trust_period: float = 7 * 24 * 3600.0
    # skipping-verification trust level (1/3)
    trust_level_numerator: int = 1
    trust_level_denominator: int = 3
    # clock drift tolerance (seconds) for header time checks
    max_clock_drift: float = 10.0


@dataclass
class SchedulerConfig:
    """crypto/scheduler.py: one node-wide scheduler with priority lanes.
    Votes preempt (flush at once, alone), light serves within its
    coalescing window, admission gets bounded latency, catch-up soaks idle
    capacity. Pressure level 1 shrinks admission and catch-up (rows x
    pressure_rows_factor, waits x pressure_wait_factor), level 2 pauses
    catch-up."""

    enabled: bool = True
    # crypto backend of the combined flushes ("" = the crypto default)
    backend: str = ""
    # per-lane budgets: max rows taken per combined flush (0 = uncapped)
    # and max seconds a queued row waits before its lane must flush
    votes_max_rows: int = 0
    votes_max_wait: float = 0.0
    light_max_rows: int = 8192
    light_max_wait: float = 0.01  # the light service re-pins it from coalesce_window
    admission_max_rows: int = 1024
    admission_max_wait: float = 0.004
    catchup_max_rows: int = 8192
    catchup_max_wait: float = 0.25
    # quarantine lane (crypto/provenance.py): flushes alone, only when every
    # other lane is empty (starvation floor = CATCHUP_STARVATION_FACTOR x wait)
    quarantine_max_rows: int = 4096
    quarantine_max_wait: float = 0.05
    # overload response (set_pressure)
    pressure_rows_factor: float = 0.5
    pressure_wait_factor: float = 2.0
    # device-batched transaction admission (read by the mempool, not ported)
    admission_precheck: bool = True
    # a consumer blocked on its verdict verifies inline after this many seconds
    wait_timeout: float = 30.0


@dataclass
class MempoolConfig:
    """mempool/mempool.py. The WAL, TTL, eviction and per-sender fields are
    read by parts of the reference's mempool the port has not taken yet;
    they keep their defaults so a carried configuration reads the same."""

    wal_dir: str = ""  # empty disables the mempool WAL (reference default)
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576
    ttl_num_blocks: int = 0
    ttl_seconds: float = 0.0
    eviction: bool = True
    max_txs_per_sender: int = 0


@dataclass
class ConsensusConfig:
    """consensus/cs_state.py (reference config/config.go ConsensusConfig)."""

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
    # queue votes and verify them in one batched flush per receive-loop
    # drain (no reference counterpart)
    defer_vote_verification: bool = False
    vote_flush_interval: float = 0.05
    # WAL group commit (consensus/wal.py): non-sync writes of one drain are
    # one buffered write, fsynced once the oldest has waited this long;
    # write_sync (the node's own messages) still fsyncs before it returns
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
class Config:
    """The sections of the reference's Config that the consensus slice
    reads."""

    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)


def test_config() -> Config:
    """Short timeouts for in-process runs (reference config.TestConfig)."""
    cfg = Config()
    cfg.consensus.timeout_propose = 0.4
    cfg.consensus.timeout_propose_delta = 0.1
    cfg.consensus.timeout_prevote = 0.2
    cfg.consensus.timeout_prevote_delta = 0.1
    cfg.consensus.timeout_precommit = 0.2
    cfg.consensus.timeout_precommit_delta = 0.1
    cfg.consensus.timeout_commit = 0.1
    cfg.consensus.skip_timeout_commit = True
    return cfg


test_config.__test__ = False  # not a pytest case when imported into a test module
