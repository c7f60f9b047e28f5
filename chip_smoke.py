#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (tendermint_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card, nvcc and gcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. the card (nvidia-smi name and power limit), torch / CUDA / nvcc versions;
  2. build the CUDA kernel libraries (one nvcc each, started together, sm_90a)
     and the native host prep (gcc);
  3. each of the six kernels against its plain torch version on the card at
     the shapes the paths below give it (uptree and fenwick_reduce on the
     warm, streamed and pipelined MSMs and on each of the tampered
     bisection's combined checks, 2,048-10,240 lanes, chunks of 2,048 or
     1,024; fsquare_chain on their A and R decompressions; pdbl at all six
     window-fold shapes and on the ladder; padd on the top trees, the tail,
     every window-fold level, the chunk partials' fold and the ladder; the
     ladder at the widths of tampered_persig, the bisection's leaves and
     host_small_cuda; the A and R of mixed_sr25519_10k's tampered 2,048-row
     sub-check (6,144 lanes); the light paths' 8,192- and 10,240-lane
     flushes, their R decompressions and the cold trusting check's A and R,
     the 4,096-lane recovery ladder, the 3,072-lane skipping checks and the
     accumulated flush's pipelined chunk: uptree, fenwick_reduce and the
     decompression), and off the paths: both padd kernels at 32, 192,
     1,024, 4,096, 4,097, 16,384 and 24,576 lanes (the sweep that sets
     cuda_fe.PADD_FEW_LANES) and bucket_fold at T = 1 and 33 windows;
     tolerance zero (integer arithmetic), with
     its device time (the profiler's kernel records, median per launch;
     where CUPTI keeps none in two sessions, CUDA events around calls
     queued behind a device sleep, and the row says which),
     its call time by CUDA events, the plain version's time, its bound
     (fenwick_reduce's byte count is the distinct 32-B sectors its gather
     touches, counted on the host from the index table and printed), ptxas's
     registers and spills, and for the rows of the redesigned kernels
     (padd, fenwick_reduce, bucket_fold, fp12_sparse_mul, fp381_mul) the
     card ms recorded before their redesigns (text line only);
     the unfused MSM total against the integer reference on a small input,
     and the fused total against the unfused one at the 10k commit's 20,480
     lanes; ops/ristretto_torch.ristretto_decode on the card against its
     plain version, limb for limb, at 2,048 and 1,024 lanes (the mixed
     paths' sr25519 decodes);
  4. batch.prewarm(10,000, backend="cuda") (its seconds printed; the A
     cache is reset after it), then a 10,000-validator commit (random keys
     from a seed, real signatures over each row's precommit sign bytes)
     through ValidatorSet.verify_commit on three paths: "cold" (plain
     kernel: A and R decompressed together, fills the A cache) and "warm"
     (cached-A kernel), both under configure_prep(stream=False), the single
     flush, then 7 interleaved pairs of warm calls with the staged host
     prep off and on (configure_prep(staged=...), both medians printed),
     then one more warm call under torch.profiler (device busy time,
     idle share, kernels by device time); and "pipelined", the default
     route of 2,048 to 12,287 rows: two chunks of the planner's 24,576-lane
     bucket, a head of 1,250 rows (one warm call, 5 timed, one profiled;
     host prep, prep wait and prep overlap printed); all run the fused MSM
     (uptree, fenwick_reduce, bucket_fold);
  "device_sort": the warm single flush (stream off) with TMTPU_DEVICE_SORT=1
     ("warm_dsort": the window sort on the card) against 0, 7 interleaved
     pairs, both profiled, and the tampered rows under each (equal masks,
     labels and recovery flushes: "warm tampered", "warm_dsort tampered");
  5. the "tampered" path: three tampered signatures, so the pipelined
     combined check fails and the bisection gives the mask (20 flushes:
     17 combined checks and 3 per-signature leaves, as the reference's
     recursion gives on these rows), which must be False exactly there;
     "tampered_persig", the same rows with TMTPU_BISECT=0 (one per-signature
     pass over all rows); each arm warmed once and timed once (tampered's
     profiled call, ~45-66 s of profiler for its ~227,000 kernels, was cut
     to make room for the command-line and chaos phases, and
     tampered_persig's, ~13 s, to keep a slow host inside the limit);
     verify_commit raises CommitVerifyError;
  6. the "streamed" path: verify_batch over 100,000 rows (the commit's signed
     rows tiled ten times) through the flush planner, 9 chunks of 24,576
     lanes, once to warm and three timed runs (its profiled run, ~9 s, was
     cut to keep a slow host inside the limit);
     then "streamed_tampered": two tampered rows in different chunks, the
     chunk-wise recovery (each 12,287-row chunk pipelined, then bisected;
     each chunk's path and flush count printed), a mask False exactly there;
  "host_small": BASELINE config 1, 128 rows through Ed25519BatchVerifier()
     with no backend and no device: the host combined check with no kernel
     launched; 200 rows with a bad row: the host bisection; the same 128
     rows through Ed25519BatchVerifier(device=<the card>), which asks for the
     card ("host_small_cuda"): its per-signature ladder; every mask held
     against ed25519_ref.verify_cofactored;
  7. "mixed_commit": a 10,000-validator set holding 4 BLS validators, a
     plain Commit through verify_commit honest, with one bad BLS row and with
     one bad Ed25519 row (Ed25519 rows on the card, pipelined since slice 9,
     BLS rows by bls_ref on the host), verdicts held against bls_ref /
     ed25519_ref;
  8. "mixed_sr25519_10k": BASELINE config 5 as bench.py builds it (10,000
     rows, the last 2,000 sr25519, 110-byte messages) through
     verify_batch(key_types=...) on the reference's one-MSM route
     ("rlc-mixed", mode "mixed": 10,240 A + 8,192 Ed25519 R + 2,048 sr25519
     R lanes, no sr25519 row on the host): a cold call (both A fills), a
     warm one, SR_REPS timed and one profiled; "mixed_sr25519_10k split",
     the exact per-type split (the Ed25519 rows pipelined on the card, the
     sr25519 rows by the native verifier on the host) timed and profiled
     beside it; then an Ed25519 and an sr25519 row tampered: the combined
     check fails and the split gives the exact mask (path "mixed",
     rlc_fallback); launches held to SR_MIXED_WARM / SR_MIXED_COLD; 64 rows
     of each mask held against the port's pure-Python verifiers;
  9. the BLS kernels fp381_mul and fp12_sparse_mul against their plain
     versions at the BLS paths' shapes (fp381_mul at every Miller-step
     launch shape, 8-216 products on 2 lanes, and at fold levels 1, 8 and
     14, as routed, then each shape on both fp381_mul kernels: the sweep
     that sets cuda_bls.FP_FEW_PRODUCTS; fp12_sparse_mul on the Miller
     loop's 2 lanes and one wide row off the path), printed as in phase 3
     (fp12_sparse_mul bound by its 54
     products a lane over the whole card, or one product's multiply-adds
     issued one a clock, whichever is longer);
  10. a 10,000-validator BLS set (keys sk0 + i, one aggregate signature over
     the full bitmap, built before the card is touched) through
     ValidatorSet.verify_aggregate_commit on three paths: "bls_cold" (the
     host decode of 10k keys fills the key cache), "bls_warm" (5 timed calls,
     then one under torch.profiler; host time split by stage) and
     "bls_rejected" (a valid G2 point that is the wrong signature, and a
     correctly signed bitmap at <= 2/3 of the power); the card's aggregate
     pubkey and pairing verdicts are held against the host bls_ref, whose
     Miller loops on the warm call's pairs are timed beside the card's;
  11. "cofactorless": a 300-validator commit holding one torsion-defect
     signature (a cofactored accept, a cofactorless reject) under verify mode
     cofactorless (keys.set_verify_mode, the switch TMTPU_ED25519_MODE sets at
     import): verify_commit must refuse that row on the host serial loop
     (LAST_FLUSH mode host_serial) with no kernel launched; an explicit
     backend="cuda" must accept every row on the card; then, back in
     cofactored mode, the same commit must pass on the card;
  12. the light paths (a corpus signed on the fork pool before the card is
     touched): "light_trusting_4k" (BASELINE config 3 at bench.py's size:
     light.verifier.verify_non_adjacent from a trusted 4,096-validator
     header at height 1 to one at height 5 whose set replaces 1,024 of
     them, trust 1/3; the trusting check's 3,072 rows and the light check's
     4,096, each an asynchronous cached-A single flush after one cold call,
     both labels "rlc-async"; 10 interleaved rounds of the whole step, its
     two checks submitted together and the same two checks one after the
     other, the pair's order alternating, then the step and the serial pair
     profiled); "light_tampered"
     (3 bad rows of known validators: both finishes recover by one
     per-signature pass, "persig-async", masks held against
     ed25519_ref.verify_cofactored on every row, and the step passes; its
     ~15-22-s profiled call was cut with tampered's);
     "light_skipping" (a light.client.Client in skipping mode over a
     MockProvider chain of 16 heights x 1,024 validators whose whole set
     rotates at height 9: the trusted heights must be the bisection's,
     steps and card flushes printed); "light_accumulated" (heights 1-8's
     commits submitted under accumulate_flushes with a bad row in commit
     3: one flush, the default 8,192-row route with bisection, each slice
     equal to that commit's own submit and finish); the light checks that
     light_skipping's refused steps submit and never finish (count, host ms,
     launches), and one such dropped submit timed and profiled; the phase's
     seconds; "light_mixed": begin_verify_commit_light_trusting and its
     finish on a 4,096-validator set holding 819 sr25519 validators, the
     mixed flush submitted unsynced ("rlc-async", mode "mixed"; cold, 5
     timed, one profiled), and with one tampered row, recovered by the
     split (path "mixed", rlc_fallback, False there only);
  13. the consensus and catch-up paths: "verify_commit_1k" (BASELINE
     config 2: the first 1,000 corpus validators with their own
     signatures, cold and 5 warm calls, the single flush "rlc", one
     profiled); "vote_storm_10k" (BASELINE config 5's vote stream: the 10k
     corpus's commit signatures as precommits into a deferred
     types.vote_set.VoteSet, flushed every 512 adds, 19 flushes of 512 rows
     and one of 272, each flush's ms and label, votes/s, +2/3 and
     make_commit's bytes equal to the corpus commit's (the profiled storm of
     one drain of each kind, ~9 s, was cut to keep a slow host inside the
     limit);
     the verify-at-add arm on the first 1,024 votes with no launch; with
     the default memo the storm again and its commit's verify_commit from
     the memo, path "memo", 0 launches; a drain with a bad vote, an
     equivocation whose pair pop_conflicts gives, its DuplicateVoteEvidence
     verified through verify_batch and refused with a flipped signature);
     "catchup_128" and "super_batch_1k" (BASELINE config 4 at bench.py's
     bench_catchup and bench_super_batch sizes, the latter's depth cut from
     10k blocks to 16: real blocks, part sets and last commits signed on
     the fork pool, through blocksync.verify.verify_run_batched, ms per
     run, blocks/s, labels, one run profiled; a tampered catchup_128 run
     whose block 5 has 43 bad signatures and block 11 a wrong block ID: the
     index is 5, then 11 with block 5 repaired); "memo" (the default memo:
     a repeated 10k verify_commit and verify_batch of its rows answered
     from it, 0 launches, all True). Every timed phase, old and new, runs
     with the verified-row memo off (configure_verified_memo(0), as
     bench.py times); the memo checks put the default back around
     themselves. Each phase's seconds are printed;
  14. the scheduler paths (crypto/scheduler.py, memo off): "scheduler_lanes"
     (each consumer through its lane of a default scheduler on the card
     against its direct call: the storm's 20 drains on the votes lane, the
     catch-up runs on the catch-up lane, super_batch_1k split at
     planner_chunk_rows() into two pipelined flushes, light_trusting_4k's
     step accumulated on the light lane; masks, indices, labels and launch
     counts equal); "light_serve_1k" (a LightService under bench.py
     bench_light_serve's traffic on light_skipping's chain, every answer
     the chain's header, and its serial arm); "scheduler_mixed" (storms,
     super_batch_1k runs, light clients and queued vote rows at once on one
     scheduler: deterministic results, no vote flush with another lane's
     rows, a between-chunk preemption, no inline fallback, every Ed25519
     kernel launched; one short window profiled); "poisoned_votes"
     (bench.py bench_poisoned_flush's 512-row vote batches, clean and at 1%
     poison, through the votes lane: the quarantine lane after the first
     recovery, every mask equal to ed25519_ref's);
  15. the shape check: from phase 4 on, each call of the six Ed25519
     wrappers notes its shape (the lanes of its batch, uptree's windows and
     chunk, fenwick_reduce's storage segments and Kf, bucket_fold's windows;
     not the loop counts); a shape that no phase-3 row has gets a row
     checked on the arguments of its first call (the scheduler paths'
     timing-dependent flush sizes, the quarantine lane's small ladders),
     and every shape a path gave a kernel must then be the shape of a row,
     or the script exits naming it;
  16. "g1_msm_10k": the general-base G1 MSM (ops/bls12_torch.g1_msm) over
     the BLS set's 10,000 keys with scalars below r from the seed: all-ones
     scalars equal the fold's aggregate key and the host Jacobian sum, the
     limb tail and the host tail agree on the card's buckets, a 512-key
     prefix equals bls_ref's sum of scalar multiples, and g1_msm is linear
     in the scalars; 5 timed calls with the B7 launches of each (the same on
     every call), one profiled, and a kernel row for each fp381_mul shape
     the path gives, on the arguments of its first call;
  17. "metrics": the port's Prometheus exposition (libs/metrics.py) read
     before and after one warm 10k verify_commit, one 10k
     verify_aggregate_commit and one 512-row votes-lane flush through an
     installed scheduler built with metrics= and slo=: the flush, row,
     scheme, aggregate-size, lane and SLO deltas must be exact, device_up 1
     and build or load seconds recorded; then verify_stats()'s device block
     and the recorder's own cost (µs a record_flush, 10,000 calls);
  18. "profile_report": libs/profiler.trace_function around one warm 10k
     single flush, then tools/profile_report.report on its run directory
     (under $TMTPU_PROFILE_DIR, else libs/profiler.default_base_dir(); its
     report.json beside the trace): every Ed25519 kernel launch in a
     named stage, uptree, fenwick_reduce and bucket_fold one launch each,
     and the stage table with the share that fell to no stage;
  19. "consensus_10k": the port's ConsensusState (consensus/cs_state.py)
     with deferred vote verification on the card (device None, the
     reference's routing) over BASELINE config 5's validator set
     (mixed_sr25519_10k's keys, 8,000 Ed25519 and 2,000 sr25519, power 10),
     the node one Ed25519 validator with a FilePV, the verified-row memo on,
     the kvstore app, a WAL in a temporary directory and 1,000 64-byte txs;
     4 heights, each: the proposal (the node's executor builds it, or the
     node proposes), every other validator's prevote and precommit signed on
     a pool forked before the card is touched (outside the timed window),
     the votes injected in bursts of 512 (one receive-loop drain each); 100
     bad precommits at height 3. Prints each height's injection-to-commit
     time and launches (the shapes join the shape check), each deferred
     flush's rows, route and ms, their median and votes/s, the LastCommit
     checks of heights 2-4 (path "memo", 0 launches), height 2's device busy
     time and idle share and its hotstats stage totals (encode, verify,
     pubsub, wal), and the phase's seconds with signing apart; every
     flush's mask equals the host arm's (only the 100 planted rows False),
     the committed LastCommits and the seen commits of heights 3 and 4
     verify on the host arm without the planted rows, and consensus must not
     have halted; the stores as they stood after height 3 serve the next two
     phases, those after height 4 statesync_10k;
  20. "rpc_light_10k": a port Node as a full node over SQLite copies of
     consensus_10k's stores, RPC on 127.0.0.1:0 with the light service and
     Prometheus: light clients over HTTPProvider, 16 HTTP clients of
     light_verify / light_block, the light proxy, the metrics and debug
     pages and a poisoned height-3 commit; every mask held to the host arm;
     inside its window "cli_light_10k": the port's command line
     (cli/main.py) `--device cuda light` against that node's RPC, trust
     height 1, verify height 3, in a worker thread (the command runs its
     own asyncio loop); its printed hash and app hash held to the node's
     block 3, its flushes (all on the card arm) held to the host arm, its
     launches counted in their own window, its seconds split into fetch and
     flush ms; then "observatory_scrape_10k": the observatory's CLI
     (tools/chain_observatory.py `--nodes <url>`) in a worker thread, exit
     0 with one node merged, and a scrape_node of the same node whose
     `mesh` block equals GET /debug/mesh's answer;
  21. "p2p_sync_10k": a new full node J of consensus_10k's chain joins
     through the port's p2p fabric (secret connections, three port Nodes on
     the card, device None): J dials L, a full node whose blocksync reactor
     swallows the first block request and serves block 2 with its
     last_commit's first signatures flipped until <= 2/3 of the power is
     valid; the verify stage refuses the run on the catch-up lane and J
     drops L; J dials S, an honest full node with fast sync off, syncs
     heights 1-2 in one catch-up run, hands off to consensus at height 3
     and commits it from S's catch-up gossip (block parts and LastCommit
     precommits into the deferred vote flushes). Launch windows "lie",
     "blocksync" and "consensus". Prints the handshakes, J's bytes per
     channel, the transfer ms, each flush, the dial-of-S-to-commit time in
     three parts, L's punishment and the phase's seconds; every mask equals
     the host arm's, only the flipped rows are False, J's blocks, commits
     and app hash equal S's, J did not halt or store an error; before S
     and J stop, each node's dump (tools/chain_observatory.py
     write_node_dump) and the fleet referee over the two: verdict pass, a
     clean safety audit of the 3 shared heights, and
     tendermint_fleet_safety_checks_total raised by that count;
  21b. "statesync_10k": a new full node J of consensus_10k's 4-height
     chain joins by snapshot: S (a full node over its stores, RPC on, its
     kvstore behind a port SocketServer reached through base.proxy_app,
     whose ListSnapshots answers the snapshot of height 1 alone), J
     (statesync on, [statesync] rpc_servers = S's RPC, trust height 1, its
     kvstore behind a port GrpcServer): J's light client verifies heights
     1-3 on the card, the chunks are applied over gRPC, J bootstraps at
     height 1, block-syncs height 2 (and 3 when block 4 is in) on the
     catch-up lane and hands off. Launch windows "light", "blocksync" and
     "handoff". Prints the light blocks' fetch ms beside each check's rows,
     route and ms, the chunks, each flush, J's bytes per channel and dial
     to handoff in parts; every mask equals the host arm's, J's restored
     state and app hash equal S's at height 1, J's blocks and app hash
     after block sync equal S's, J holds no block 1, did not halt, store an
     error or fall back; then "device_fault": one armed DeviceFaultInjector error on a
     warm 10k verify_commit raises at rlc_submit and leaves device_up 0;
     after heal() the rows verify with the host arm's mask ("device_fault
     healed");
  22. "tx_admission": bench.py bench_tx_admission at its own parameters on
     the port's Node (node/node.py, device None): one validator running
     signed_kvstore with deferred votes on the votes lane, memdb, mempool
     500,000 / cache 1,000,000 / TTL 2 blocks / recheck off, the scheduler
     at its defaults, prewarm off; 6 baseline heights, then 256-tx batches
     from 4 threads through check_tx_batch: the serial arm (6,000 txs,
     sig_precheck off, the app verifies each tx) and the batched arm
     (30,000 txs on the admission lane, profiled), each at most 8 s; then one
     256-tx batch with 3 flipped signatures. The corpus (16 keys) is signed
     on the fork pool in main(). Prints each arm's admissions/s and their
     ratio, the app's serial_verifies / precheck_consumed and
     prechecked_total, the admission flushes (rows, route, ms; the recorder's
     labels; the scheduler's flush_log), the votes lane's p99 flush wall at
     baseline and under the flood and the preemptions, each arm's launches,
     the batched arm's device busy and idle share, keys._HAVE_OPENSSL, the
     node's mempool, consensus height and scheduler series, one tx's journey
     (received to delivered) and the phase's seconds with signing apart;
     every admission flush's mask equals the host arm's, the batched arm
     paid no app-side verify, exactly the 3 planted txs are refused, each
     committed LastCommit verifies on the host arm, and the node did not
     halt or store an error;
  22b. "cli_localnet": the path a user takes: the port's `testnet --v 4`
     into a temporary directory ([instrumentation] prometheus on, each on a
     free port), four children `python -m tendermint_tpu_torch.cli --device
     cuda --home <h> start` (stdout and stderr to a file in each home); every
     child reaches height 3 by RPC status, blocks 1-3 have equal hashes
     across the four by RPC block, each child's /metrics shows card flushes
     (tendermint_batch_verify_flushes_total{backend="cuda"}), and each
     exits 0 on SIGINT. Prints each child's seconds from spawn to "node ...
     started", to height 3, and its card flushes;
  22c. "chaos_poison_10k": a chaos/harness.LocalChaosNet of four port Nodes
     (device None, plaintext transport, SQLite stores, deferred vote
     verification: the reference's chaos nets, tests/test_chaos.py
     make_plain_net with the crash soak's db_backend, the deferred flush on) under a seeded ChaosSchedule: a partition of one node and
     its heal, a crash of another with its WAL tail truncated and its
     restart, then a sig_poison of CHAOS_POISON votes (chaos/byzantine.py,
     written to each peer at once) from a third node into the other three.
     The engine applies every event without error, assert_safety() holds,
     every live node commits two heights past the schedule's top, the
     poisoner is quarantined by the provenance scorer and then punished
     (each victim's trust reporter holds a bad_message of it). Every flush
     of 256 rows or more that holds poisoned rows ran on the card; each
     flush's mask is False on the poisoned rows and equal to the host
     arm's. Prints the schedule, the poisoned flushes (rows, route, lane,
     ms), the time from the flood to the punishment and the launches;
  22d. "fleet_smoke_7": chaos/fleet.run_fleet_soak on the reference's
     tier-1 smoke spec (tests/test_fleet_soak.py _smoke_spec, seed
     20260807: 4 Ed25519 validators, one of them the poisoner, a resident
     full node, a blocksync joiner, a light edge; partition, peer_stall and
     sig_poison) with each node's `device` None (the card with the
     reference's routing, as the other node phases: the fleet's flushes of
     1-49 rows take the host arm), FLEET_MIN_HEIGHTS heights, the referee
     on, the provenance scorer reset first (with every node's device the
     card, the 7 in-process nodes' launching threads convoy on the GIL and
     the fleet does not fit the limit: tools/fleet_probe.py measures it).
     The run must give verdict pass with 0 safety violations, the poisoner
     (and no other source) quarantined and punished, the joiner within 2
     heights of the head,
     full coverage, the referee CLI and release_gate.evaluate(skip_perf)
     agreeing with it and fleet_safety_checks_total raised by the audit's
     count; every flush's mask equals the host arm's. Prints the spec, the
     heights by node, each node's flushes by lane (rows, route, ms; the
     vote sets' flushes ride the process-global default scheduler, the last
     node's), the flood to the quarantine and to the punishment, the fleet
     series and the launches (window "fleet_smoke_7 soak", the ladder's
     three where a flush took the card);
  22e. "mesh_10k": the sharded mesh (parallel/sharded.py and the sharded
     arms of crypto/batch.py) on MESH_SHARDS = 4 shards of the one card,
     pinned as the reference's tests pin their virtual devices
     (batch._sharded_env -> _build_sharded_env([card] * 4); shard keys
     "cuda:0#0".."cuda:0#3"), over the commit phase's 10,000 rows with the
     memo off. First the single-card `rlc` flush (stream off) and the host
     arm's mask on the fork pool; then, on the mesh: verify_batch (one warm,
     3 timed, counts the same on each) and ValidatorSet.verify_commit take
     path "rlc-sharded", 4 x 5,120 lanes in LAST_FLUSH and in the mesh
     telemetry's flush record, the mask byte-identical to the single-card
     and host masks; one flipped signature (row MESH_TAMPERED): the combined
     check fails and the bisection over sharded halves, its leaf on the
     sharded ladder, gives the host's mask ("rlc-bisect"); the rows tiled
     MESH_STREAM_TILES times (20,000 rows, over the planner's budget):
     "rlc-sharded-streamed", 2 chunks, 6,144 lanes a shard, the tiled host
     mask; sharded_commit_step over the 10k rows (4,096 lanes a shard):
     ok, its mask the host's and its tally the verify_commit tally;
     aggregate_bitmap_sharded over build_bls_set's 10,000 keys and the full
     bitmap: affine ints equal to the single-card fold and to bls_ref's
     sum, with a kernel row for each fp381_mul shape of its shard folds
     that no earlier row has (path mesh_bls_fold); chaos/device.py's arm_shard_error(2): the flush
     raises ShardFaultError, a device error (no replay, no launch), the
     health model strikes "cuda:0#2" once, and the next flush on a freshly
     pinned env passes with the host's mask; then /debug/mesh's numbers
     (telemetry.mesh_stats(): flushes, pad waste, submit and finish
     seconds, gathers and their bytes, prep). With two cards or more the
     "auto" mesh over the distinct cards verifies the rows too; on one card
     that arm prints that it did not run (_sharded_env() is None). Every
     Ed25519 shape the phase gives a kernel gets its row from
     recorded_rows (the per-shard MSMs' 5,120- and 6,144-lane shapes, the
     sharded ladders');
  23. a `kernels` JSON line (a row off every path counts 0 launches), the
     card line, and last the `ok` JSON line.
The launch counts are zeroed just before each path and read just after it
(the warm, pipelined and streamed paths per call); every kernel of a path must
launch on it: the six Ed25519 kernels on the Ed25519 paths (pipelined,
tampered, tampered_persig, mixed_commit, mixed_sr25519_10k, the four light
paths, light_mixed, the consensus and catch-up paths, the scheduler paths,
consensus_10k's heights, p2p_sync_10k's lie and blocksync windows (its
consensus window where a flush took a card route), statesync_10k's light
and blocksync windows, device_fault healed, tx_admission's
batched arm and cli_light_10k included, and chaos_poison_10k's window where
a poisoned flush took a combined check on the card (else the ladder's
three), and fleet_smoke_7's soak (the ladder's three), and mesh_10k's
single-card, rlc-sharded, verify_commit, tampered, streamed and healed
paths; the tampered batch and mesh_10k's commit step launch the ladder's
three), the two BLS kernels on the BLS paths, fp381_mul on g1_msm_10k and
mesh_10k's shard folds, none on host_small, mesh_10k's armed shard fault, the
verify-at-add arm, the evidence check and the memo's answers. Exits non-zero without a result when no CUDA device
is available.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing as mp
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
N_VALIDATORS = 10_000
CHAIN_ID = "chip-smoke-chain"
HEIGHT = 7
TAMPERED = (17, 4242, 9_999)
STREAM_TILES = 10  # 100,000 rows
STREAM_TAMPERED = (17, 60_000)  # chunks 0 and 4

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_MAD_PER_SM_PER_CLK = 64  # CUDA C++ Programming Guide, cc 9.0 throughput table
# Product multiply-adds per lane, counted from csrc/fe25519.cuh: a field mul
# is 20 x 20 = 400, a square 20 + 190 = 210, a mul by a small constant 20.
MUL, SQR, SMALL = 400, 210, 20
# a, b, pt qt, (pt qt) 2d, pz qz and the 4 outputs: 9 products; 2 * zz
PADD_MADS = 9 * MUL + SMALL
POINT_BYTES = 4 * 20 * 4


def pdbl_mads(times: int) -> int:
    # per doubling: 4 squares, 3 products, 2 * zz; t = e h on the last one only
    return times * (4 * SQR + 3 * MUL + SMALL) + MUL


# fp381 Montgomery product, counted from csrc/fp381.cuh: the 33 x 33
# schoolbook product, 33 x 33 reduction multiply-adds and the 33 m_i (the
# top-limb folds of sub, 33 constant multiplies each, are not counted).
FP381_MUL = 2 * 33 * 33 + 33
FP_BYTES = 33 * 4
# fp12_sparse_mul: 18 Karatsuba Fp2 products of 3 base products a lane.
SPARSE_PRODUCTS = 54
# BLS path constants
BLS_HEIGHT = 5
BLS_TS = 1_700_000_000_123_456_789
BLS_SUB_SIGNERS = 6_666  # 66,660 of 100,000 power: <= 2/3
N_MIXED_BLS = 4  # BLS validators in the mixed plain commit (each costs a host pairing check)
# BASELINE config 5 (bench.py make_batch / bench_mixed_streaming): 10,000
# validators, the last 20% sr25519, 110-byte messages
N_SR = 2_000
SR_MSG_LEN = 110
# The tampered bisection's combined checks (rows -> 2 x _lane_bucket(rows + 1)
# MSM lanes, the fused chunk): 512, 1,024, 1,808, 2,048 and 4,096 rows; its
# 8,192-row check has warm's 20,480 lanes.
TAMPERED_MSM = ((2_048, 2048, 512), (3_072, 1024, 1_024), (4_096, 2048, 1_808),
                (6_144, 2048, 2_048), (10_240, 2048, 4_096))
SR_TAMPERED = (4_321, 9_876)  # an Ed25519 row and an sr25519 row
# The one-MSM mixed flush of mixed_sr25519_10k: lanes 10,240 (A block) +
# 8,192 (Ed25519 R) + 2,048 (sr25519 R) = 20,480, the warm single flush's MSM.
# Launches (padd, pdbl, fsquare_chain, uptree, fenwick_reduce, bucket_fold):
# the warm single flush's plus one ristretto decode's six fsquare_chain;
# cold adds the two A fills' six each.
SR_MIXED_WARM = dict(padd=11, pdbl=6, fsquare_chain=12, uptree=1, fenwick_reduce=1, bucket_fold=1)
SR_MIXED_COLD = dict(SR_MIXED_WARM, fsquare_chain=24)
SR_REPS = 5  # timed warm calls of the card route and of the split arm each
# The mixed asynchronous light check: a 4,096-validator set, the last 20%
# sr25519, the trusting check (trust 1/3) of a commit all of them signed,
# its row LIGHT_MIXED_BAD tampered in the failing case.
LIGHT_MIXED_SR = 819
LIGHT_MIXED_BAD = 4_000
N_COFACTORLESS = 300  # the cofactorless commit: its host loop is pure Python where OpenSSL is missing
PADD_SWEEP = (32, 192, 1_024, 4_096, 4_097, 16_384, 24_576)
# The light paths. BASELINE config 3 at bench.py's size (_CONFIG_SIZES
# "light_trusting_4k"): a trusted header at height 1 with 4,096 validators,
# an untrusted one at height 5 whose set replaces 1,024 of them; trust 1/3.
LIGHT_N = 4_096
LIGHT_REPLACED = 1_024
LIGHT_TAMPERED = 3  # bad rows in the untrusted commit, all of known validators
LIGHT_ROUNDS = 10  # interleaved rounds of the step, its checks together and one after the other
NANOS = 1_000_000_000
LIGHT_T0 = 1_700_000_000 * NANOS
LIGHT_NOW = LIGHT_T0 + 3_600 * NANOS
LIGHT_PERIOD = 24 * 3_600 * NANOS
LIGHT_DRIFT = 10 * NANOS
# light_skipping: 16 heights x 1,024 validators, the whole set rotating at
# height 9; light_accumulated: heights 1-8's commits, one bad row in commit 3
SKIP_HEIGHTS, SKIP_N, SKIP_ROTATION = 16, 1_024, 9
ACC_COMMITS, ACC_BAD = 8, (3, 100)
# The consensus and catch-up paths. verify_commit_1k: BASELINE config 2
# (bench.py _CONFIG_SIZES "verify_commit_1k"), the first 1,000 validators of
# the 10k corpus with their own signatures. vote_storm_10k: BASELINE config
# 5's vote stream (bench.py bench_vote_storm) over the 10k corpus, whose
# commit signatures are its precommits, drained every DRAIN adds; the
# verify-at-add arm on the first AT_ADD_VOTES. catchup: BASELINE config 4 at
# bench.py's sizes, (blocks, validators, blocks a run): bench_catchup and
# bench_super_batch (config 4's width; its depth cut from 10k blocks to 16).
N_1K = 1_000
DRAIN = 512
AT_ADD_VOTES = 1_024
STORM_BAD = 17  # the bad vote of the tampered drain
CATCHUP = {"catchup_128": (48, 128, 16), "super_batch_1k": (16, 1_024, 16)}
CATCHUP_TXS = 4  # 200-byte transactions a block
# the tampered catchup_128 run: bad signatures on more than a third of the
# power in block 5's commit, and a wrong block ID in block 11's
CATCHUP_BAD_BLOCK, CATCHUP_BAD_ROWS, CATCHUP_WRONG_ID = 5, 43, 11
# The scheduler paths (crypto/scheduler.py). light_serve_1k: bench.py
# bench_light_serve's traffic (32 clients, Zipf(1.1) heights over
# 2..heights, seed 7, a 0.02-s coalescing window, max_heights_per_flush
# heights + 1, no max_pending) on light_skipping's chain, its 600 requests
# cut to 256 (8 a client) once the whole run with rpc_light_10k passed
# 1,000 s of its 1,200-s limit; its serial arm is sampled on the first
# SERVE_SERIAL requests (~0.6 s each; 60 until consensus_10k's fourth
# height took the whole run to 1,074.7 s, 30 until the command-line and
# chaos phases left a slow host too little of the limit). poisoned_votes: bench.py
# bench_poisoned_flush's shape, POISON_ROWS-row vote batches from the 10k
# corpus, POISON_CALLS calls at 0 and POISONED_CALLS at 1% poison (seed 20;
# each poisoned call after the first runs two per-signature ladders at once,
# ~3 s, so that arm is cut from 64 calls to 4: 16 until the whole run passed
# 900 s of its 1,200-s limit with tx_admission, 8 until consensus_10k's
# fourth height took it to 1,074.7 s). PEERS: the peers the vote
# paths tag their rows with.
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_SEED, SERVE_WINDOW, SERVE_SERIAL = 32, 256, 7, 0.02, 16
POISON_ROWS, POISON_CALLS, POISONED_CALLS, POISON_RATE, POISON_SEED = 512, 64, 4, 0.01, 20
PEERS = 8
# consensus_10k: BASELINE config 5's validator set (mixed_sr25519_10k's keys:
# 8,000 Ed25519 and 2,000 sr25519 validators, power 10) under the port's
# ConsensusState with deferred vote verification on the card, CONSENSUS_HEIGHTS
# heights; CONSENSUS_TXS kvstore txs of CONSENSUS_TX_BYTES bytes through
# check_tx before height 1; at the last height the first CONSENSUS_BAD
# precommits carry a bad signature. Votes arrive in bursts of DRAIN, one
# receive-loop drain each. The propose timeout is raised from test_config's
# 0.4 s to CONSENSUS_PROPOSE_S: the proposal and its parts are injected as
# soon as the node enters PROPOSE, and this covers building a 1,000-tx block
# on a loaded host.
CONSENSUS_HEIGHTS, CONSENSUS_TXS, CONSENSUS_TX_BYTES, CONSENSUS_BAD = 3, 1_000, 64, 100
# consensus_10k then commits one height more for statesync_10k alone: its
# server must stand two heights above the joiner's restored height + 1 for
# block sync to fetch a block (blocksync/reactor.py `_caught_up`); the
# phases before it keep the stores as they stood at CONSENSUS_HEIGHTS
STATESYNC_HEIGHTS = CONSENSUS_HEIGHTS + 1
CONSENSUS_PROPOSE_S = 5.0
# tx_admission: bench.py bench_tx_admission at its own parameters on the
# port's Node: ADM_KEYS signing keys, check_tx_batch batches of ADM_BATCH
# txs from ADM_SENDERS threads, a baseline window of ADM_BASELINE heights
# after height 2, then a serial arm (sig_precheck off, ADM_SERIAL_TXS txs)
# and a batched arm (the admission lane, ADM_BATCHED_TXS txs), each at most
# ADM_FLOOD_S seconds; then one tampered batch of ADM_BATCH txs whose
# ADM_TAMPERED rows carry a flipped signature. The corpus is signed on the
# fork pool before the card is touched.
ADM_KEYS, ADM_BATCH, ADM_SENDERS, ADM_BASELINE = 16, 256, 4, 6
ADM_FLOOD_S, ADM_SERIAL_TXS, ADM_BATCHED_TXS = 8.0, 6_000, 30_000
ADM_TAMPERED = (17, 128, 255)
# rpc_light_10k: the port's Node as a full node over consensus_10k's 3
# heights (SQLite copies of its stores), its RPC server on a free port with
# the light service on, Prometheus on another. RPC_CLIENT_RUNS light clients
# over HTTPProvider verify height 3 from height 1, each with a fresh store;
# RPC_CLIENTS HTTP clients each send RPC_REQUESTS requests, light_verify and
# light_block in turn over heights 1-3 (cut from 20 to keep the phase near
# 60 s: every answer carries the 10k-signature commit, ~2.3 MB of JSON, and
# light_block the 10k set, ~1.9 MB more, all built and parsed on the host;
# PERF.md section 4); the light proxy's verified commit and validators at
# RPC_PROXY_HEIGHT; and a provider whose client flips two bits of the
# scalar's top byte in each of the first signatures of the height-3 commit
# until the valid ones hold no more than 2/3 of the power, which the light
# client must refuse. Those rows fail the s < L precheck and leave the
# combined check: a flip that passes the precheck costs the step a
# bisection of ~9 s a check on this set on an H100 (PERF.md section 7).
RPC_CLIENT_RUNS, RPC_CLIENTS, RPC_REQUESTS, RPC_PROXY_HEIGHT = 3, 16, 6, 2
# p2p_sync_10k: the joiner's [fastsync] peer_timeout (seconds): above the
# ~4.4 s that two 10k-commit blocks (~1.1 MB each) take at the MConnection's
# 512,000 B/s, below the 10 s default, which L's swallowed first request
# would otherwise cost in full
P2P_PEER_TIMEOUT = 6.0
# statesync_10k: the joiner's [statesync] discovery_time (seconds), opened
# once it has dialed the server: its SnapshotsRequest is answered within
# milliseconds on the loopback
STATESYNC_DISCOVERY_S = 1.0

REPLACES = {
    "padd": "tendermint_tpu/ops/pallas_fe.py:249",
    "pdbl": "tendermint_tpu/ops/pallas_fe.py:262",
    "fsquare_chain": "tendermint_tpu/ops/pallas_fe.py:275",
    "uptree": "tendermint_tpu/ops/pallas_msm.py:302",
    "fenwick_reduce": "tendermint_tpu/ops/pallas_msm.py:384",
    "bucket_fold": "tendermint_tpu/ops/pallas_msm.py:490",
    "fp381_mul": "tendermint_tpu/ops/pallas_bls.py:331",
    "fp12_sparse_mul": "tendermint_tpu/ops/pallas_bls.py:374",
}
SOURCE = {
    **dict.fromkeys(("padd", "pdbl", "fsquare_chain"), "tendermint_tpu_torch/csrc/point_kernels.cu"),
    **dict.fromkeys(("uptree", "fenwick_reduce", "bucket_fold"),
                    "tendermint_tpu_torch/csrc/msm_kernels.cu"),
    **dict.fromkeys(("fp381_mul", "fp12_sparse_mul"), "tendermint_tpu_torch/csrc/bls_kernels.cu"),
}
ED25519_KERNELS = ("padd", "pdbl", "fsquare_chain", "uptree", "fenwick_reduce", "bucket_fold")
BLS_KERNELS = ("fp381_mul", "fp12_sparse_mul")
NO_LIBRARY = {
    "padd": "no PyTorch call adds curve points",
    "pdbl": "no PyTorch call doubles curve points",
    "fsquare_chain": "no PyTorch call squares in GF(2^255-19)",
    "uptree": "no PyTorch call builds a curve-point pair tree",
    "fenwick_reduce": "no PyTorch call sums gathered curve points",
    "bucket_fold": "no PyTorch call folds curve-point buckets",
    "fp381_mul": "no PyTorch call computes a Montgomery product in GF(p381)",
    "fp12_sparse_mul": "no PyTorch call multiplies in Fp12",
}


def work_seconds(mads: int, card: dict) -> float:
    """Least time for `mads` int32 multiply-adds in all, spread evenly over
    the whole card (64 a clock per SM)."""
    return mads / (card["sms"] * INT32_MAD_PER_SM_PER_CLK * card["clock_hz"])


def imad_seconds(mads_per_lane: int, lanes: int, card: dict) -> float:
    """Least time for `lanes` lanes of `mads_per_lane` int32 multiply-adds
    each: the function's work over the whole card, whatever shape a kernel
    gives its launch."""
    return work_seconds(mads_per_lane * lanes, card)


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, reps: int = 5):
    """Warm median of `reps` calls in ms, by CUDA events around each call:
    the wrapper's host time is inside the window, so a launch of a few
    microseconds reads as its call time (`call_ms`), not its device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# Card ms recorded by chip_smoke.py runs before each kernel's redesign (the
# thread-per-lane pdbl and fsquare_chain, padd, bucket_fold, fenwick_reduce,
# fp12_sparse_mul, fp381_mul's Miller launches), by (kernel, path, lanes)
# (PERF.md's kernel table and findings; NVIDIA H100 80GB HBM3, 700.00 W).
# Printed on the row's text line only, labelled as recorded: the `kernels`
# JSON line holds only what this run measured.
RECORDED_BEFORE_MS = {
    ("padd", "warm", 160): 0.0203, ("padd", "warm", 32): 0.0205,
    ("padd", "streamed", 192): 0.0205, ("padd", "tampered_persig", 16_384): 0.0215,
    ("bucket_fold", "warm", 8_192): 0.1695,
    ("pdbl", "tampered_persig", 16_384): 0.0378,
    ("fsquare_chain", "warm", 10_240): 0.0301, ("fsquare_chain", "cold", 20_480): 0.0470,
    ("fsquare_chain", "streamed", 24_576): 0.0461,
    ("fsquare_chain", "tampered_persig", 16_384): 0.0292,
    ("fenwick_reduce", "warm", 8_192): 0.3327,
    ("fp12_sparse_mul", "bls_warm", 2): 0.1221, ("fp12_sparse_mul", None, 16_384): 0.4642,
    ("fp381_mul", "bls_warm", 216): 0.0063,
}


def fenwick_gather_sectors(node_idx, n0: int, n1: int, n2: int) -> int:
    """The 32-byte sectors that fenwick_reduce's gather must touch: over
    every node that node_idx names, its 80 limb rows in its segment of the
    storage map [lvl0 | ctree | top] (limb-major (4, 20, n_seg) int32
    tensors, each 32-byte aligned), the distinct (segment, sector) pairs. A
    host count from the index table: the byte floor of the gather."""
    g = np.unique(np.asarray(node_idx, dtype=np.int64))
    rows = np.arange(4 * 20, dtype=np.int64)[:, None]
    total = 0
    for lo, n in ((0, n0), (n0, n1), (n0 + n1, n2)):
        j = g[(g >= lo) & (g < lo + n)] - lo
        if j.size:
            total += np.unique((rows * n + j) // 8).size  # 8 int32 words a sector
    return int(total)


KERNEL_SYMBOL = {  # the __global__ function each wrapper launches
    "padd": ("padd_quad_kernel", "padd_lanes_kernel"),
    "pdbl": ("pdbl_quad_kernel", "pdbl_lanes_kernel"),
    "fsquare_chain": ("fsquare_chain_kernel", "fsquare_chain_quad_kernel"),
    "uptree": ("uptree_kernel",),
    "fenwick_reduce": ("fenwick_kernel",), "bucket_fold": ("bucket_fold_kernel",),
    "fp381_mul": ("fp381_mul_kernel", "fp381_mul_few_kernel"),
    "fp12_sparse_mul": ("fp12_sparse_mul_kernel",),
}
ENTRY_SYMBOL = {  # cuda_fe.padd's and cuda_bls.fp381_mul's entries
    "tm_padd": "padd_quad_kernel", "tm_padd_lanes": "padd_lanes_kernel",
    "tm_fp381_mul": "fp381_mul_kernel", "tm_fp381_mul_few": "fp381_mul_few_kernel",
}
# the sweep's PADD_FEW_LANES for each padd kernel: every shape at or under it
# takes the warp kernel, every shape over it the 4-threads-a-lane kernel
SWEEP_FEW_LANES = {"padd_lanes_kernel": 1 << 30, "padd_quad_kernel": 0}
# the sweep's FP_FEW_PRODUCTS for each fp381_mul kernel, likewise
SWEEP_FEW_PRODUCTS = {"fp381_mul_few_kernel": 1 << 30, "fp381_mul_kernel": 0}


@contextlib.contextmanager
def pinned(module, name: str, limit: int):
    """A routing threshold (cuda_fe.PADD_FEW_LANES, cuda_bls.FP_FEW_PRODUCTS,
    which the *_entry functions read at call time) pinned to `limit` inside
    the block."""
    saved = getattr(module, name)
    setattr(module, name, limit)
    try:
        yield
    finally:
        setattr(module, name, saved)


def ptxas_usage() -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from the builds'
    `nvcc -Xptxas -v` output (cuda_fe.BUILD_LOG)."""
    from tendermint_tpu_torch.ops import cuda_fe

    usage, cur, spill = {}, None, 0
    for log in cuda_fe.BUILD_LOG.values():
        for line in log["ptxas"].splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                cur, spill = m.group(1), 0
            elif cur and (m := re.search(r"(\d+) bytes spill stores", line)):
                spill = int(m.group(1))
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                usage[cur], cur = (int(m.group(1)), spill), None
    return usage


def kernel_usage(symbol: str, usage: dict):
    """(registers, spill bytes) of the __global__ function `symbol`, found by
    its mangled prefix _Z<len><name>."""
    prefix = f"_Z{len(symbol)}{symbol}"
    return next((v for k, v in usage.items() if k.startswith(prefix)), (None, None))


def launched_symbol(name: str, lanes: int) -> str:
    """The __global__ function the wrapper of `name` launches on `lanes` lanes."""
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe

    if name == "pdbl":
        return ("pdbl_lanes_kernel" if cuda_fe.pdbl_entry(lanes) == "tm_pdbl_lanes"
                else "pdbl_quad_kernel")
    if name == "padd":
        return ENTRY_SYMBOL[cuda_fe.padd_entry(lanes)]
    if name == "fp381_mul":  # `lanes`: the launch's products
        return ENTRY_SYMBOL[cuda_bls.fp381_mul_entry(lanes)]
    if name == "fsquare_chain":
        return ("fsquare_chain_quad_kernel" if cuda_fe.fsquare_chain_entry(lanes)
                == "tm_fsquare_chain_quad" else "fsquare_chain_kernel")
    return KERNEL_SYMBOL[name][0]


def profiled_ms(fn, name: str, reps: int):
    """The profiler's per-launch records of kernel `name` over `reps` warm
    calls of `fn`: (median ms, symbol, other device ms per call: uptree's
    layout copy and counter memset), or None where it kept too few."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.libs.profiler import is_device_record

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def which(label: str):
        return next((sym for sym in KERNEL_SYMBOL[name] if sym in label), None)

    durs, syms, other_us = [], set(), 0.0
    for e in prof.events():
        if not is_device_record(e):
            continue
        sym = which(e.name)
        if sym is not None:
            durs.append(e.time_range.elapsed_us() / 1e3)
            syms.add(sym)
        else:
            other_us += e.time_range.elapsed_us()
    # CUPTI may drop a few records of microsecond launches: the median is
    # over those it kept, at least half
    if reps // 2 <= len(durs) <= reps and len(syms) == 1:
        return statistics.median(durs), syms.pop(), other_us / 1e3 / reps
    print(f"profiler kept {len(durs)} records of {name} ({syms}) in {reps} calls", flush=True)
    return None


def queued_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: CUDA events around `reps` calls queued
    behind a device sleep, so they run back to back and the wrapper's host
    time stays outside the window. The sleep grows until the window's start
    was still queued when the last call was enqueued."""
    cycles = 1 << 22
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise SystemExit("queued_ms: the calls were not all enqueued behind the device sleep")


def device_ms(fn, name: str, lanes: int, reps: int = 10, symbol: str | None = None):
    """Device time of one launch of kernel `name` in ms, the symbol that ran,
    the device time per call of the other work the wrapper launches, and the
    method: the profiler's per-launch records (median), asked twice; where
    CUPTI keeps no records in either session, CUDA events around calls
    queued behind a device sleep (queued_ms), whose time per call counts the
    wrapper's other launches too (its other ms is then None)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        if (got := profiled_ms(fn, name, reps)) is not None:
            return (*got, "profiler, median per launch")
    return queued_ms(fn, reps), symbol or launched_symbol(name, lanes), None, "events, queued calls"


def seeded_points(m: int, rng: np.random.Generator):
    """Encodings of m seeded scalar multiples s0 B, (s0 + d) B, ... (m, 32)."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    s0 = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
    step = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    p = ref.point_mul(s0, ref.BASE)
    out = []
    for _ in range(m):
        out.append(np.frombuffer(ref.point_compress(p), dtype=np.uint8))
        p = ref.point_add(p, step)
    return np.stack(out)


def fused_storage(pts, rng, n: int):
    """The fused MSM's intermediates over n lanes of `pts` (a 10k commit's
    20,480) with seeded scalars: sort, the storage map and node indices
    (msm_torch._fused_stages) and the prefix points."""
    from tendermint_tpu_torch.ops import cuda_msm, msm_torch

    digits = rng.integers(0, 256, size=(n, 32)).astype(np.uint8)
    digits[n // 2:, 16:] = 0  # the R block's scalars are < 2^128
    perm, ends = msm_torch.sort_windows(digits, zero16_from=n // 2)
    perm_t = torch.from_numpy(perm.astype(np.int32)).to(pts.device)
    ends_t = torch.from_numpy(ends).to(pts.device)
    lvl0, ctree, top, idx = msm_torch._fused_stages(pts, perm_t, ends_t)
    return dict(perm=perm_t, ends=ends_t, lvl0=lvl0, ctree=ctree, top=top, idx=idx,
                prefix=cuda_msm.fenwick_reduce_plain(lvl0, ctree, top, idx), t=perm.shape[0])


def max_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_err(a, b) for a, b in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def padd_case_of(path, p, q, where, few_lanes=None):
    """padd on points p, q. `few_lanes` pins cuda_fe.PADD_FEW_LANES around
    each call to force one kernel (the sweep); None keeps the routing as
    shipped."""
    from tendermint_tpu_torch.ops import cuda_fe

    lanes = p.numel() // 80
    few = cuda_fe.PADD_FEW_LANES if few_lanes is None else few_lanes
    with pinned(cuda_fe, "PADD_FEW_LANES", few):
        symbol = ENTRY_SYMBOL[cuda_fe.padd_entry(lanes)]

    def forced():
        with pinned(cuda_fe, "PADD_FEW_LANES", few):
            return cuda_fe.padd(p, q)

    kern = (lambda: cuda_fe.padd(p, q)) if few_lanes is None else forced
    return dict(name="padd", path=path, variant=where, lanes=lanes, symbol=symbol, kern=kern,
                plain=lambda: cuda_fe.padd_plain(p, q), key=shape_key("padd", p, q),
                mads=PADD_MADS, items=lanes, bytes=3 * POINT_BYTES * lanes)


def pdbl_case_of(path, p, times, variant):
    from tendermint_tpu_torch.ops import cuda_fe

    lanes = p.numel() // 80
    return dict(name="pdbl", path=path, variant=variant, lanes=lanes,
                kern=lambda: cuda_fe.pdbl(p, times), plain=lambda: cuda_fe.pdbl_plain(p, times),
                key=shape_key("pdbl", p, times), mads=pdbl_mads(times), items=lanes,
                bytes=(3 * 80 + POINT_BYTES) * lanes)  # x, y, z in (t is not read), 4 out


def bucket_fold_case_of(path, prefix, t_):
    from tendermint_tpu_torch.ops import cuda_msm

    m = 256 * t_
    return dict(name="bucket_fold", path=path, variant=f"T={t_}", lanes=m,
                kern=lambda: cuda_msm.bucket_fold(prefix, t_),
                plain=lambda: cuda_msm.bucket_fold_plain(prefix, t_),
                key=shape_key("bucket_fold", prefix, t_),
                mads=PADD_MADS, items=255 * t_, bytes=(m + 2 * t_) * POINT_BYTES,
                bound_note="operations: 255 adds a window x PADD_MADS over the whole card; "
                           "the adds form a chain 8 levels deep, which this bound does not "
                           "count")


def fsq_case_of(path, x, k, variant):
    from tendermint_tpu_torch.ops import cuda_fe

    lanes = x.numel() // 20
    return dict(name="fsquare_chain", path=path, variant=variant, lanes=lanes,
                kern=lambda: cuda_fe.fsquare_chain(x, k),
                plain=lambda: cuda_fe.fsquare_chain_plain(x, k),
                key=shape_key("fsquare_chain", x, k), mads=k * SQR, items=lanes,
                bytes=2 * 80 * lanes)


def uptree_case_of(path, x, perm, ch, variant):
    from tendermint_tpu_torch.ops import cuda_msm
    from tendermint_tpu_torch.ops.msm_geometry import chunk_geometry, tree_written_positions

    t_, n = perm.shape
    nchunks = t_ * n // ch
    pos = torch.from_numpy(tree_written_positions(ch)).to(x.device)

    def written(t):  # level 0, and the chunk-tree positions that hold a node
        return t[0], t[1].reshape(4, 20, nchunks, chunk_geometry(ch).rows_out * 128)[..., pos]

    return dict(name="uptree", path=path, variant=variant, lanes=t_ * n,
                kern=lambda: cuda_msm.uptree(x, perm, ch),
                plain=lambda: cuda_msm.uptree_plain(x, perm, ch),
                key=shape_key("uptree", x, perm, ch),
                view=written, mads=PADD_MADS, items=nchunks * (ch - 1),
                # table and perm read once; level 0 and the chunk trees written once
                bytes=n * POINT_BYTES + t_ * n * 4 + (t_ * n + nchunks * (ch - 1)) * POINT_BYTES)


def fenwick_case_of(path, lvl0, ctree, top, idx, variant, card):
    from tendermint_tpu_torch.ops import cuda_msm

    m, kf = idx.shape
    fw_args = (lvl0, ctree, top, idx)
    # the gather's floor: the distinct 32-B sectors of the nodes' limb rows
    sectors = fenwick_gather_sectors(idx.cpu().numpy(), *(a.shape[-1] for a in fw_args[:3]))
    return dict(name="fenwick_reduce", path=path, variant=variant, lanes=m,
                kern=lambda: cuda_msm.fenwick_reduce(*fw_args),
                plain=lambda: cuda_msm.fenwick_reduce_plain(*fw_args),
                key=shape_key("fenwick_reduce", *fw_args),
                t_ops=work_seconds(m * (kf - 1) * PADD_MADS, card),
                bytes=sectors * 32 + m * kf * 4 + m * POINT_BYTES, sectors=sectors,
                bound_note=f"operations: (Kf-1) x PADD_MADS a lane over the whole card; "
                           f"bytes: {sectors} gather sectors x 32 B, the index table and "
                           f"the output once")


def kernel_checks(dev, rng, card: dict) -> list:
    """Each kernel against its plain version at the shapes of each path:
    warm (cached A: R decompressed on 10,240 lanes, the fused MSM over
    20,480 lanes), cold (A and R decompressed on 20,480), tampered_persig
    (the per-signature ladder on the 16,384-lane bucket), tampered (the
    bisection's ladder leaf on 1,024 lanes), streamed and pipelined
    (24,576-lane chunks: A and R decompressed, the fused MSM)."""
    from tendermint_tpu_torch.ops import cuda_fe, msm_torch

    enc = seeded_points(2048, rng)
    p0, ok = msm_torch.decompress_rows(enc, dev)
    assert bool(ok.all()), "seeded points failed to decompress"
    base = torch.cat([p0, cuda_fe.pdbl_plain(p0, 1)], dim=-1)  # reduced + carried limbs
    nb = base.shape[-1]

    def pick(n):
        return base[..., torch.from_numpy(rng.integers(0, nb, size=n)).to(dev)].contiguous()

    def padd_case(path, lanes, where, few_lanes=None):
        return padd_case_of(path, pick(lanes), pick(lanes), where, few_lanes)

    def pdbl_case(path, lanes, times, where):
        return pdbl_case_of(path, pick(lanes), times, f"times={times}, {where}")

    def fsq_case(path, lanes, where):
        return fsq_case_of(path, pick(lanes)[1].contiguous(), 50, f"k=50, {where}")

    def uptree_case(path, n, ch, where):
        x = pick(n)
        perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(32)])
                                .astype(np.int32)).to(dev)
        return uptree_case_of(path, x, perm, ch, f"ch={ch}, {where}")

    def fenwick_case(path, n, where):
        """fenwick_reduce on the fused storage of an n-lane MSM; returns the
        case and the storage (its prefix points feed bucket_fold)."""
        fs = fused_storage(pick(n), rng, n)
        kf = fs["idx"].shape[1]
        return fenwick_case_of(path, fs["lvl0"], fs["ctree"], fs["top"], fs["idx"],
                               f"Kf={kf}, 256 buckets x {fs['t']} windows, {n:,}-lane MSM, "
                               f"{where}", card), fs

    warm_fenwick, fs = fenwick_case("warm", 20_480, "10k commit")
    trusting_fenwick, trusting_fs = fenwick_case("light_trusting_4k", 8_192,
                                                 "trusting check, 3,072 rows")
    cases = [
        uptree_case("warm", 20_480, 2048, "10k commit: 32 windows x 10 chunks"),
        uptree_case("streamed", 24_576, 2048, "planner chunk: 32 windows x 12 chunks"),
        uptree_case("pipelined", 24_576, 2048, "pipelined chunk: 32 windows x 12 chunks"),
        # the bisection's combined checks of 512-8,192 rows (8,192 is warm's 20,480 lanes)
        *(uptree_case("tampered", n, ch, f"bisection sub-check of {rows} rows: "
                                         f"32 windows x {n // ch} chunks")
          for n, ch, rows in TAMPERED_MSM),
        warm_fenwick,
        *(fenwick_case("tampered", n, f"bisection sub-check of {rows} rows")[0]
          for n, _, rows in TAMPERED_MSM),
        bucket_fold_case_of("warm", fs["prefix"], fs["t"]),
        bucket_fold_case_of(None, pick(256), 1),
        bucket_fold_case_of(None, pick(256 * 33), 33),
        padd_case("warm", 32 * 5, "top tree level 1: 32 windows x 5 root pairs"),
        padd_case("streamed", 32 * 6, "top tree level 1: 32 windows x 6 root pairs"),
        padd_case("warm", 32, "[255] P_255 and W per window"),
        padd_case("pipelined", 1, "the chunk partials' fold"),
        *(padd_case("warm", lanes, f"window fold level {level}: {lanes} pairs")
          for level, lanes in enumerate((16, 8, 4, 2), 1)),
        padd_case("tampered", 32 * 3, "top tree level 1 of a 4,096-row sub-check: 32 x 3"),
        padd_case("tampered", 32 * 2, "top tree level 1 of a 1,024-2,048-row sub-check: 32 x 2"),
        padd_case("tampered_persig", 16_384, "per-signature ladder"),
        padd_case("tampered", 1_024, "per-signature ladder, the bisection's 784-row leaf"),
        padd_case("tampered", 512, "per-signature ladder, the bisection's 512-row leaves"),
        padd_case("host_small_cuda", 128, "per-signature ladder of 128 rows"),
        *(padd_case(None, n, f"sweep, {symbol}", few)
          for n in PADD_SWEEP for symbol, few in SWEEP_FEW_LANES.items()),
        pdbl_case("warm", 32, 8, "[256] P_255 per window"),
        pdbl_case("warm", 16, 8, "window fold level 1"),
        pdbl_case("warm", 8, 16, "window fold level 2"),
        pdbl_case("warm", 4, 32, "window fold level 3"),
        pdbl_case("warm", 2, 64, "window fold level 4"),
        pdbl_case("warm", 1, 128, "last window-fold level"),
        pdbl_case("tampered_persig", 16_384, 4, "per-signature ladder"),
        pdbl_case("tampered", 1_024, 4, "per-signature ladder, the bisection's 784-row leaf"),
        pdbl_case("tampered", 512, 4, "per-signature ladder, the bisection's 512-row leaves"),
        pdbl_case("cofactored_300", 512, 4, "per-signature ladder of a 300-row commit"),
        pdbl_case("host_small_cuda", 128, 4, "per-signature ladder of 128 rows"),
        fsq_case("warm", 10_240, "R decompression"),
        fsq_case("cold", 20_480, "A and R decompression"),
        fsq_case("streamed", 24_576, "A and R decompression per chunk"),
        fsq_case("tampered_persig", 16_384, "per-signature A or R decompression"),
        fsq_case("tampered", 1_024, "A or R decompression, the bisection's 784-row leaf"),
        fsq_case("pipelined", 24_576, "A and R decompression per chunk of the 10k commit"),
        fsq_case("tampered", 512, "A or R decompression, the bisection's 512-row leaves"),
        *(fsq_case("tampered", n // 2, f"R decompression of a {rows}-row cached sub-check")
          for n, _, rows in TAMPERED_MSM),
        fsq_case("cofactored_300", 512, "A or R decompression of a 300-row commit"),
        fsq_case("host_small_cuda", 128, "A or R decompression of 128 rows"),
        fsq_case("mixed_sr25519_10k tampered", 6_144,
                 "A and R decompression of the bisection's 2,048-row sub-check"),
        # the one-MSM mixed flush: its Ed25519 R (8,192 lanes) and sr25519 R
        # (2,048, the ristretto decode's chain), the cold call's A fills (8,000
        # Ed25519 keys; 2,000 sr25519 keys padded to 2,048); the mixed light
        # check's cold fill of 3,277 Ed25519 keys
        fsq_case("mixed_sr25519_10k", 8_192, "Ed25519 R decompression of the mixed flush"),
        fsq_case("mixed_sr25519_10k", 2_048, "sr25519 R ristretto decode of the mixed flush"),
        fsq_case("mixed_sr25519_10k cold", 8_000, "A fill: decompression of 8,000 Ed25519 keys"),
        fsq_case("light_mixed cold", 3_277, "A fill: decompression of 3,277 Ed25519 keys"),
        # the light paths: the trusting check's 3,072 rows (8,192 lanes) and the
        # light check's 4,096 (10,240), cached A; the recovery ladder on 4,096
        # lanes; the skipping chain's 1,024-row checks (3,072 lanes); the
        # accumulated 8,192-row flush, pipelined in the planner's chunk
        uptree_case("light_trusting_4k", 8_192, 2048, "trusting check, 3,072 rows: "
                                                       "32 windows x 4 chunks"),
        uptree_case("light_trusting_4k", 10_240, 2048, "light check, 4,096 rows: "
                                                        "32 windows x 5 chunks"),
        trusting_fenwick,
        fenwick_case("light_trusting_4k", 10_240, "light check, 4,096 rows")[0],
        bucket_fold_case_of("light_trusting_4k", trusting_fs["prefix"], trusting_fs["t"]),
        fsq_case("light_trusting_4k", 4_096, "R decompression of the trusting check"),
        fsq_case("light_trusting_4k", 5_120, "R decompression of the light check"),
        fsq_case("light_trusting_4k", 8_192, "A and R decompression of the cold trusting check"),
        padd_case("light_trusting_4k", 32 * 2, "top tree level 1 of the trusting check: 32 x 2"),
        padd_case("light_trusting_4k", 32 * 3, "top tree level 1 of the light check: 32 x 3"),
        padd_case("light_trusting_4k", 32, "[255] P_255 and W per window"),
        pdbl_case("light_trusting_4k", 32, 8, "[256] P_255 per window"),
        pdbl_case("light_trusting_4k", 1, 128, "last window-fold level"),
        padd_case("light_tampered", 4_096, "per-signature ladder, 3,072 and 4,096 rows"),
        pdbl_case("light_tampered", 4_096, 4, "per-signature ladder, 3,072 and 4,096 rows"),
        fsq_case("light_tampered", 4_096, "per-signature A or R decompression"),
        uptree_case("light_skipping", 3_072, 1024, "1,024-row check: 32 windows x 3 chunks"),
        fenwick_case("light_skipping", 3_072, "1,024-row check")[0],
        fsq_case("light_skipping", 1_536, "R decompression of a cached 1,024-row check"),
        fsq_case("light_skipping", 3_072, "A and R decompression of a 1,024-row check"),
        padd_case("light_skipping", 32, "top tree level 1 of a 1,024-row check: 32 x 1"),
        uptree_case("light_accumulated", 24_576, 2048, "pipelined chunk of the 8,192-row "
                                                        "flush: 32 windows x 12 chunks"),
        fsq_case("light_accumulated", 24_576, "A and R decompression per pipelined chunk"),
        fenwick_case("light_accumulated", 24_576, "pipelined chunk of the 8,192-row flush")[0],
        # the consensus and catch-up paths: the 1,000-row commit and the storm's
        # 512-row drains (cached A: 2,048 lanes), the cold commit's A and R, the
        # 272-row drain's ladder (512 lanes), the catch-up runs' pipelined and
        # streamed chunks (24,576 lanes)
        uptree_case("verify_commit_1k", 2_048, 2048, "1,000-row commit and 512-row vote "
                                                      "drains: 32 windows x 1 chunk"),
        fenwick_case("verify_commit_1k", 2_048, "1,000-row commit and 512-row vote drains")[0],
        fsq_case("verify_commit_1k", 1_024, "R decompression of the 1,000-row commit and the "
                                            "512-row drains"),
        fsq_case("verify_commit_1k cold", 2_048, "A and R decompression of the cold 1,000-row "
                                                 "commit"),
        padd_case("vote_storm_10k", 512, "per-signature ladder of the 272-row drain"),
        pdbl_case("vote_storm_10k", 512, 4, "per-signature ladder of the 272-row drain"),
        fsq_case("vote_storm_10k", 512, "A or R decompression of the 272-row drain"),
        uptree_case("catchup_128", 24_576, 2048, "pipelined chunk of a 2,048-row run: "
                                                  "32 windows x 12 chunks"),
        fenwick_case("catchup_128", 24_576, "pipelined chunk of a 2,048-row run")[0],
        fsq_case("catchup_128", 24_576, "A and R decompression per pipelined chunk"),
        uptree_case("super_batch_1k", 24_576, 2048, "planner chunk of the 16,384-row run: "
                                                     "32 windows x 12 chunks"),
        fsq_case("super_batch_1k", 24_576, "A and R decompression per planner chunk"),
    ]

    return check_cases(cases, card), base


def bound_text(bound_by: str, note) -> str:
    """What binds a row, with the note on how its work was counted."""
    if not note or note.startswith(bound_by):
        return note or bound_by
    return f"{bound_by}; {note}"


def check_cases(cases, card: dict) -> list:
    """Each case's kernel against its plain version (max |err| must be 0),
    then both timed, with the bound of the case's work (`t_ops` where the
    case counts its operations itself, else `mads` an item over `items`
    items on the whole card), ptxas's registers and spills, and on the text
    line the card ms recorded before the redesign where the row has one
    (RECORDED_BEFORE_MS)."""
    usage = ptxas_usage()
    rows = []
    for c in cases:
        view = c.get("view", lambda t: t)
        got = c["kern"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        err = max_err(view(got), view(want))
        if err != 0:  # limb-identical, so equal after freeze too
            raise SystemExit(f"kernel {c['name']} {c['variant']} disagrees with its "
                             f"plain version: max |err| {err}")
        ms, symbol, other_ms, ms_by = device_ms(c["kern"], c["name"], c["lanes"],
                                                symbol=c.get("symbol"))
        call_ms = timed(c["kern"])
        plain_ms = timed(c["plain"], reps=3)
        t_ops = (c["t_ops"] if "t_ops" in c else imad_seconds(c["mads"], c["items"], card)) * 1e3
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        row = dict(
            name=c["name"], path=c["path"], variant=c["variant"], lanes=c["lanes"], route="cuda",
            source=SOURCE[c["name"]], replaces=REPLACES[c["name"]], symbol=symbol,
            max_abs_err=err, ms=ms, ms_by=ms_by, wrapper_other_ms=other_ms, call_ms=call_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
            library_note=NO_LIBRARY[c["name"]],
        )
        row["regs"], row["spill_bytes"] = kernel_usage(symbol, usage)
        for k in ("bound_note", "sectors"):
            if k in c:
                row[k] = c[k]
        if "key" in c:
            row["shape"] = c["key"][1:]
        rows.append(row)
        print(f"kernel {row['name']} [{row['path']}] {row['variant']} lanes={row['lanes']} "
              f"{symbol}: ms={ms:.4f} ({ms_by}) "
              f"wrapper_other_ms={'in ms' if other_ms is None else f'{other_ms:.4f}'} "
              f"call_ms={call_ms:.4f} "
              f"(events) plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.5f} "
              f"({bound_text(row['bound_by'], c.get('bound_note'))}) "
              f"max_abs_err={err} library_ms=null regs={row['regs']} "
              f"spill_bytes={row['spill_bytes']}"
              + (f" sectors={c['sectors']}" if "sectors" in c else "")
              + (f" recorded_before_ms={RECORDED_BEFORE_MS[key]} (PERF.md, not this run)"
                 if (key := (c["name"], c["path"], c["lanes"])) in RECORDED_BEFORE_MS else ""),
              flush=True)
    return rows


def carried_limbs(shape, rng) -> torch.Tensor:
    """Random (*shape[:-1], 33, n) fp381 operands in the product's input
    discipline: limbs 0..31 in [0, 4096] (carried limbs may sit at 4096),
    the top limb < 16, so every value is < 2^388."""
    lead, n = shape[:-1], shape[-1]
    x = rng.integers(0, 4097, size=(*lead, 33, n), dtype=np.int32)
    x[..., 32, :] = rng.integers(0, 16, size=(*lead, n), dtype=np.int32)
    return torch.from_numpy(x)


# B7's launch shapes on the bls_warm path: the Miller loop's stacked products
# on its 2 lanes (square12, padd2, line_dbl / line_add) and three of the key
# fold's 14 levels over the 16,384-lane padded set (6 products x 8,192 ... 1
# pairs)
FP_MILLER_SHAPES = (
    ((4, 2), "Miller step: 4 x 2 products (line_dbl / line_add)"),
    ((6, 2), "Miller step: 6 x 2 products (line_dbl / line_add)"),
    ((9, 2), "Miller step: 9 x 2 products (line_dbl / line_add)"),
    ((12, 2), "Miller step: 12 x 2 products (line_dbl / line_add)"),
    ((18, 2), "Miller step padd2: 6 Fp2 x 3 products x 2 lanes"),
    ((36, 3, 2), "Miller step square12: 36 Fp2 x 3 products x 2 lanes"),
)
FP_FOLD_SHAPES = (
    ((6, 8_192), "fold level 1: 6 products x 8,192 pairs"),
    ((6, 64), "fold level 8: 6 products x 64 pairs"),
    ((6, 1), "fold level 14: 6 products x 1 pair"),
)


def bls_kernel_checks(dev, rng, card: dict) -> list:
    """B7 at every Miller-step shape and at fold levels 1, 8 and 14, as
    routed, then each shape on both kernels (the sweep that sets
    cuda_bls.FP_FEW_PRODUCTS); B8 at the Miller loop's 2 lanes and at 16,384
    lanes (off the path: throughput)."""
    from tendermint_tpu_torch.ops import cuda_bls

    def mul_case(shape, variant, few_products=None):
        """`few_products` pins cuda_bls.FP_FEW_PRODUCTS around each call to
        force one kernel (the sweep); None keeps the routing as shipped."""
        a, b = carried_limbs(shape, rng).to(dev), carried_limbs(shape, rng).to(dev)
        products = int(np.prod(shape))
        few = cuda_bls.FP_FEW_PRODUCTS if few_products is None else few_products
        with pinned(cuda_bls, "FP_FEW_PRODUCTS", few):
            symbol = ENTRY_SYMBOL[cuda_bls.fp381_mul_entry(products)]

        def forced():
            with pinned(cuda_bls, "FP_FEW_PRODUCTS", few):
                return cuda_bls.fp381_mul(a, b)

        return dict(name="fp381_mul", path="bls_warm" if few_products is None else None,
                    variant=variant if few_products is None else f"sweep, {symbol}: {variant}",
                    lanes=products, symbol=symbol,
                    kern=(lambda: cuda_bls.fp381_mul(a, b)) if few_products is None else forced,
                    plain=lambda: cuda_bls.fp381_mul_plain(a, b),
                    mads=FP381_MUL, items=products, bytes=3 * FP_BYTES * products)

    def sparse_case(n, variant, path):
        f = carried_limbs((6, 2, n), rng).to(dev)
        line = carried_limbs((3, 2, n), rng).to(dev)
        # The function's floor, not the launch's: its 54 products a lane over
        # the whole card, or the chain of one product as one thread issues
        # it (FP381_MUL multiply-adds, one a clock), whichever is longer.
        t_card = work_seconds(n * SPARSE_PRODUCTS * FP381_MUL, card)
        t_chain = FP381_MUL / card["clock_hz"]
        return dict(name="fp12_sparse_mul", path=path, variant=variant, lanes=n,
                    kern=lambda: cuda_bls.fp12_sparse_mul(f, line),
                    plain=lambda: cuda_bls.fp12_sparse_mul_plain(f, line),
                    t_ops=max(t_card, t_chain), bytes=(18 + 12) * FP_BYTES * n,
                    bound_note=(f"operations: one product's FP381_MUL issued one a clock"
                                if t_chain >= t_card else
                                f"operations: {SPARSE_PRODUCTS} x FP381_MUL a lane over the "
                                f"whole card"))

    shapes = FP_MILLER_SHAPES + FP_FOLD_SHAPES
    return check_cases([
        *(mul_case(shape, variant) for shape, variant in shapes),
        *(mul_case(shape, variant, few) for shape, variant in shapes
          for few in SWEEP_FEW_PRODUCTS.values()),
        sparse_case(2, "Miller step: 2 lanes", "bls_warm"),
        sparse_case(16_384, "16,384 lanes, off the path (throughput)", None),
    ], card)


def msm_reference_check(dev, rng, base) -> None:
    """The unfused MSM total on the card against the integer MSM at 64 lanes
    (A block with ~2^253 scalars, R block with < 2^128), by canonical
    encoding; then the fused total against the unfused one at 20,480 lanes
    (the 10k commit's lanes) on seeded points and scalars."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import ed25519_torch, msm_torch

    def compress(total):
        return bytes(ed25519_torch.compress(total.reshape(4, 20, 1).contiguous())[:, 0].cpu().numpy())

    n = 64
    enc = seeded_points(n, rng)
    scal = [int.from_bytes(rng.bytes(32), "little") % ref.L if i < n // 2
            else int.from_bytes(rng.bytes(16), "little") for i in range(n)]
    want = ref.IDENTITY
    for e, s in zip(enc, scal):
        want = ref.point_add(want, ref.point_mul(s, ref.point_decompress(e.tobytes())))
    pts, ok = msm_torch.decompress_rows(enc, dev)
    perm, ends = msm_torch.sort_windows(msm_torch.scalars_to_bytes(scal, n), zero16_from=n // 2)
    node_idx = msm_torch.fenwick_nodes_device(torch.from_numpy(ends).to(dev), n)
    total = msm_torch._msm_total(pts, torch.from_numpy(perm.astype(np.int32)).to(dev), node_idx)
    if compress(total) != ref.point_compress(want):
        raise SystemExit("MSM total on the card differs from the integer reference")
    print("msm total (64 lanes) equals the ed25519_ref integer MSM", flush=True)

    n = 20_480
    pts = base[..., torch.from_numpy(rng.integers(0, base.shape[-1], size=n)).to(dev)].contiguous()
    fs = fused_storage(pts, rng, n)
    fused = msm_torch._msm_total_fused(pts, fs["perm"], fs["ends"])
    unfused = msm_torch._msm_total(pts, fs["perm"], msm_torch.fenwick_nodes_device(fs["ends"], n))
    if compress(fused) != compress(unfused):
        raise SystemExit("fused and unfused MSM totals differ at 20,480 lanes")
    print(f"msm total ({n} lanes): fused == unfused by canonical encoding", flush=True)


def ristretto_check(dev, rng) -> None:
    """ops/ristretto_torch.ristretto_decode on the card (pow_p58 on the
    fsquare_chain kernel) against the same function on a CPU tensor (the
    plain chain), limb for limb and verdict for verdict, at the decode's
    lane counts on the mixed paths: 2,048 (mixed_sr25519_10k's sr25519 R
    block and A fill) and 1,024 (the mixed light check's); seeded multiples
    of the basepoint, every ninth lane an odd (invalid) encoding. Prints
    each decode's call ms (events)."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519
    from tendermint_tpu_torch.ops import ristretto_torch

    step = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    p = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    encs = []
    for i in range(2_048):
        e = bytearray(sr25519.ristretto_encode(p))
        if i % 9 == 8:
            e[0] |= 1
        encs.append(np.frombuffer(bytes(e), dtype=np.uint8))
        p = ref.point_add(p, step)
    for lanes in (2_048, 1_024):
        cols = torch.from_numpy(np.ascontiguousarray(np.stack(encs[:lanes]).T))
        on_card = cols.to(dev)
        got, ok = ristretto_torch.ristretto_decode(on_card)
        want, ok_w = ristretto_torch.ristretto_decode(cols)
        err = max_err(got.cpu(), want)
        if err != 0 or not torch.equal(ok.cpu(), ok_w) or int(ok_w.sum()) != lanes - lanes // 9:
            raise SystemExit(f"ristretto_decode at {lanes} lanes: card differs from plain "
                             f"(max |err| {err}) or verdicts differ")
        ms = timed(lambda: ristretto_torch.ristretto_decode(on_card))
        print(f"ristretto_decode ({lanes} lanes) on the card equals its plain version: max |err| "
              f"0, {int(ok.sum())} valid lanes; call_ms={ms:.3f} (events)", flush=True)


def _sign_rows(args):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    out = []
    for seed, msg in args:
        a, prefix = ref.secret_expand(seed)
        pk = ref.point_compress(ref.point_mul(a, ref.BASE))
        r = ref.sha512_mod_l(prefix + msg)
        r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
        h = ref.sha512_mod_l(r_enc + pk + msg)
        out.append(r_enc + ((r + h * a) % ref.L).to_bytes(32, "little"))
    return out


def build_commit(rng):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    seeds = [rng.bytes(32) for _ in range(N_VALIDATORS)]
    workers = os.cpu_count() or 1
    chunks = [[(s, b"") for s in seeds[i::workers]] for i in range(workers)]

    with mp.get_context("fork").Pool(workers) as pool:
        pk_parts = pool.map(_pubkey_rows, chunks)
        pubs = [None] * N_VALIDATORS
        for i, part in enumerate(pk_parts):
            pubs[i::workers] = part
        vals = ValidatorSet([Validator(Ed25519PubKey(pk), 10) for pk in pubs])
        seed_of = {pk: s for pk, s in zip(pubs, seeds)}
        block_id = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
        ts0 = 1_700_000_000_000_000_000
        sigs_meta = [(v.address, ts0 + 1_000 * i) for i, v in enumerate(vals.validators)]
        stub = Commit(HEIGHT, 0, block_id, [
            CommitSig(BlockIDFlag.COMMIT, a, ts, b"") for a, ts in sigs_meta])
        msgs = stub.vote_sign_bytes_many(CHAIN_ID, range(N_VALIDATORS))
        jobs = [(seed_of[v.pub_key.bytes()], m) for v, m in zip(vals.validators, msgs)]
        parts = pool.map(_sign_rows, [jobs[i::workers] for i in range(workers)])
        pool.close()
        pool.join()
    sigs = [None] * N_VALIDATORS
    for i, part in enumerate(parts):
        sigs[i::workers] = part
    commit = Commit(HEIGHT, 0, block_id, [
        CommitSig(BlockIDFlag.COMMIT, a, ts, s) for (a, ts), s in zip(sigs_meta, sigs)])
    print(f"corpus: {N_VALIDATORS} validators signed in {time.perf_counter() - t0:.1f} s "
          f"({workers} processes)", flush=True)
    return vals, block_id, commit, msgs


def _pubkey_rows(args):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    return [ref.point_compress(ref.point_mul(ref.secret_expand(s)[0], ref.BASE)) for s, _ in args]


def profile_path(path: str, fn, median_ms: float) -> None:
    """One call of a path under torch.profiler, device activity only (host
    op records would cost the script seconds on the long paths): device
    busy time (sum of kernel times; one stream, so kernels do not overlap),
    the idle share against the path's unprofiled median, and the kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.libs.profiler import device_rows

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        print(f"profile {path}: the profiler recorded no device time (device busy: not measured)")
        return
    n_kernels = sum(e.count for e in rows)
    print(f"profile {path}: device_busy_ms={busy_us / 1e3:.2f} kernels={n_kernels} "
          f"idle_share={1 - busy_us / 1e3 / median_ms:.3f} (vs median {median_ms:.1f} ms; "
          f"profiled in {time.perf_counter() - t0:.1f} s)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"profile {path}:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


# A call's shape as a kernel row names it, by wrapper (the wrapper's own
# argument names): the lanes of its point or field batch, uptree's windows
# and chunk, fenwick_reduce's storage segments and Kf, bucket_fold's
# windows. The run-time loop counts (pdbl's doublings, fsquare_chain's
# squarings) are not part of a shape.
SHAPE_OF = {
    "padd": lambda p, q: (p.numel() // 80,),
    "pdbl": lambda p, times=1: (p.numel() // 80,),
    "fsquare_chain": lambda x, k: (x.numel() // 20,),
    "uptree": lambda pts, perm, ch: (pts.shape[-1], perm.shape[0], ch),
    "fenwick_reduce": lambda lvl0, ctree, top, node_idx: (
        lvl0.shape[-1], ctree.shape[-1], top.shape[-1], node_idx.shape[-1]),
    "bucket_fold": lambda prefix, t_windows: (prefix.shape[-1], t_windows),
}
SHAPES_SEEN: set = set()  # the wrappers' shapes since the last reset_launches()
PATH_SHAPES: dict = {}  # path -> the shapes read_launches() took for it


def shape_key(name: str, *args, **kwargs) -> tuple:
    return (name, *SHAPE_OF[name](*args, **kwargs))


NEW_SHAPE_ARGS: dict = {}  # shape key -> (args, kwargs) of its first call with no row


def record_shapes(rows: list) -> None:
    """From here on each call of the six Ed25519 wrappers adds its shape
    to SHAPES_SEEN (a dict lookup and a set add a call; the wrappers and
    their launch counts are unchanged). The first call of a shape that no
    row of `rows` has keeps a copy of its arguments, for recorded_rows()."""
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    known = {(r["name"], *r["shape"]) for r in rows if "shape" in r}

    def shim(module, name):
        real = getattr(module, name)

        def call(*a, **k):
            key = shape_key(name, *a, **k)
            SHAPES_SEEN.add(key)
            if key not in known and key not in NEW_SHAPE_ARGS:
                NEW_SHAPE_ARGS[key] = (
                    tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a), dict(k))
            return real(*a, **k)
        setattr(module, name, call)

    for name in ED25519_KERNELS:
        shim(cuda_fe if name in cuda_fe.LAUNCHES else cuda_msm, name)


def recorded_rows(card: dict, launches: dict) -> list:
    """A kernel row for each shape a path gave a kernel that no phase-3 row
    has (the scheduler's combined flushes and the quarantine lane's small
    flushes, whose sizes depend on timing): the kernel against its plain
    version on the arguments of that shape's first call, timed and bounded
    as phase 3's rows are. The row's path is a path that gave the shape."""
    cases = []
    for key, (args, kw) in sorted(NEW_SHAPE_ARGS.items(), key=str):
        paths = sorted(p for p, keys in PATH_SHAPES.items() if key in keys)
        if not paths:  # seen outside every path's window (a kernel check's own call)
            continue
        path = next((p for p in paths if p in launches), paths[0])
        where = f"recorded on {', '.join(paths)}"
        name = key[0]
        if name == "padd":
            cases.append(padd_case_of(path, *args, where))
        elif name == "pdbl":
            times = kw.get("times", args[1] if len(args) > 1 else 1)
            cases.append(pdbl_case_of(path, args[0], times, f"times={times}, {where}"))
        elif name == "fsquare_chain":
            cases.append(fsq_case_of(path, *args, f"k={args[1]}, {where}"))
        elif name == "uptree":
            cases.append(uptree_case_of(path, *args, f"ch={args[2]}, {where}"))
        elif name == "fenwick_reduce":
            cases.append(fenwick_case_of(path, *args, f"Kf={args[3].shape[1]}, {where}", card))
        else:
            cases.append(bucket_fold_case_of(path, *args))
    print(f"recorded shapes: {len(cases)} shapes first given by the paths below phase 3, "
          f"each checked on its recorded arguments", flush=True)
    return check_cases(cases, card)


def note_shapes(path: str) -> None:
    PATH_SHAPES.setdefault(path, set()).update(SHAPES_SEEN)


def coverage(rows: list) -> None:
    """Every shape a path gave one of the six Ed25519 wrappers is the shape
    of a kernel row (of that path or another); exits non-zero naming each
    shape that has none."""
    have = {(r["name"], *r["shape"]) for r in rows if "shape" in r}
    missing = sorted({(key, path) for path, keys in PATH_SHAPES.items() for key in keys
                      if key not in have}, key=str)
    print(f"shapes: {sum(map(len, PATH_SHAPES.values()))} (path, kernel, shape) triples on "
          f"{len(PATH_SHAPES)} paths, {len({k for v in PATH_SHAPES.values() for k in v})} "
          f"distinct shapes, {len(missing)} without a kernel row", flush=True)
    for key, path in missing:
        print(f"shape without a kernel row: {key[0]} {key[1:]} on {path}", flush=True)
    if missing:
        raise SystemExit(f"{len(missing)} shapes of the paths have no kernel row")


def reset_launches() -> None:
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    cuda_fe.reset_launches()
    cuda_msm.reset_launches()
    cuda_bls.reset_launches()
    SHAPES_SEEN.clear()


def read_launches(path: str, kernels=ED25519_KERNELS) -> dict:
    """The launch counts of all eight kernels since the last reset; every
    kernel of the path (`kernels`) must have run. The wrappers' shapes since
    the reset are the path's too."""
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    note_shapes(path)
    counts = {**cuda_fe.LAUNCHES, **cuda_msm.LAUNCHES, **cuda_bls.LAUNCHES}
    for name in kernels:
        if counts[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the {path} path")
    return counts


def same_counts(launches: dict, path: str, counts: dict) -> None:
    if launches.setdefault(path, counts) != counts:
        raise SystemExit(f"{path} calls launched different counts: {launches[path]} vs {counts}")


def commit_phase(dev, corpus, launches: dict) -> None:
    """prewarm, then the commit paths, each with its own launch counts in
    `launches`: {path: {kernel: n}}. cold and warm run the single flush
    (configure_prep(stream=False)); pipelined, tampered and tampered_persig
    run with the default configuration, as a node would."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import CommitVerifyError

    vals, block_id, commit, msgs = corpus
    t0 = time.perf_counter()
    batch.prewarm(N_VALIDATORS, backend="cuda")
    torch.cuda.synchronize()
    print(f"prewarm({N_VALIDATORS}, backend='cuda'): {time.perf_counter() - t0:.2f} s "
          f"(stream flag after: {batch._stream_enabled()})", flush=True)
    if not batch._stream_enabled():
        raise SystemExit("prewarm left the stream flag off")
    batch.reset_a_cache()

    def verify(tag: str) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return dict(batch.LAST_FLUSH, ms=ms, counts=read_launches(tag))

    stream = batch._stream_enabled()
    batch.configure_prep(stream=False)
    try:
        # Cold: the plain kernel decompresses A and R together and fills the cache.
        cold = verify("cold")
        launches["cold"] = cold["counts"]
        assert cold.get("mode") == "plain" and cold.get("fused") and "recovery_s" not in cold, cold
        # Warm: the cached-A kernel; counts per call, the same on every call.
        warm_flush = [verify("warm") for _ in range(7)]
        for f in warm_flush:
            same_counts(launches, "warm", f["counts"])
            assert f.get("mode") == "cached" and f.get("fused") and "recovery_s" not in f, f
        warm = [f["ms"] for f in warm_flush]
        # Staged against unstaged host prep on the same warm call, interleaved.
        staged_ab = {True: [], False: []}
        for _ in range(7):
            for staged in (False, True):
                batch.configure_prep(staged=staged)
                f = verify("warm")
                same_counts(launches, "warm", f["counts"])
                assert f.get("mode") == "cached" and "recovery_s" not in f, f
                staged_ab[staged].append((f["ms"], f["prep_s"] * 1e3))
        batch.configure_prep(staged=True)
        print("warm staged vs unstaged (interleaved, 7 each): " + " ".join(
            f"{'staged' if k else 'unstaged'}_median_ms="
            f"{statistics.median(t for t, _ in v):.1f} "
            f"{'staged' if k else 'unstaged'}_host_prep_ms={statistics.median(p for _, p in v):.1f}"
            for k, v in staged_ab.items()), flush=True)
        sign_bytes = []
        for _ in range(3):  # the commit API's own host work before the flush
            t0 = time.perf_counter()
            commit.vote_sign_bytes_many(CHAIN_ID, range(N_VALIDATORS))
            sign_bytes.append((time.perf_counter() - t0) * 1e3)
        prep = statistics.median(f["prep_s"] for f in warm_flush) * 1e3
        total = statistics.median(f["total_s"] for f in warm_flush) * 1e3
        print(f"verify_commit 10k (stream off): cold_ms={cold['ms']:.1f} "
              f"warm_median_ms={statistics.median(warm):.1f} warm_ms={[round(w, 1) for w in warm]} "
              f"sign_bytes_ms={statistics.median(sign_bytes):.1f} host_prep_ms={prep:.1f} "
              f"submit_to_sync_ms={total - prep:.1f} lanes={cold['lanes']} "
              f"(A block {cold['lanes'] // 2}) fused={cold['fused']}", flush=True)
        print(f"launches cold={launches['cold']} warm per call={launches['warm']}", flush=True)
        profile_path("warm", lambda: vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit,
                                                        device=dev), statistics.median(warm))
    finally:
        batch.configure_prep(stream=stream)

    # Pipelined: the default route of a 10k commit, two chunks of the planner's bucket.
    verify("pipelined")  # warm
    piped = [verify("pipelined") for _ in range(5)]
    for f in piped:
        same_counts(launches, "pipelined", f["counts"])
        if not (f.get("mode") == "pipelined" and f.get("path") == "rlc-pipelined"
                and f.get("chunks") == 2 and f.get("head_rows") == 1_250
                and f.get("chunk_lanes") == 24_576 and "recovery_s" not in f):
            raise SystemExit(f"pipelined flush detail wrong: {f}")
    pms = [f["ms"] for f in piped]

    def med(key):
        return statistics.median(f[key] for f in piped) * 1e3

    print(f"pipelined verify_commit 10k: median_ms={statistics.median(pms):.1f} "
          f"ms={[round(t, 1) for t in pms]} host_prep_ms={med('prep_s'):.1f} "
          f"prep_wait_ms={med('prep_wait_s'):.1f} prep_overlap_ms={med('prep_overlap_s'):.1f} "
          f"chunks=2 head_rows=1250 chunk_lanes=24576 launches per call={launches['pipelined']}",
          flush=True)
    profile_path("pipelined", lambda: vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit,
                                                         device=dev), statistics.median(pms))

    # Tampered: the pipelined check fails; the bisection (default) or one
    # per-signature pass (TMTPU_BISECT=0) gives the mask.
    pubkeys = [vals.validators[i].pub_key.bytes() for i in range(N_VALIDATORS)]
    sigs = [cs.signature for cs in commit.signatures]
    for i in TAMPERED:
        sigs[i] = flip(sigs[i])
    tampered = Commit(HEIGHT, 0, block_id, [
        CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns, s)
        for cs, s in zip(commit.signatures, sigs)])
    try:
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, tampered, device=dev)
    except CommitVerifyError as e:
        print(f"tampered commit rejected: {e}", flush=True)
    else:
        raise SystemExit("tampered commit was accepted")
    for path, bisect, want_path, want_flushes in (("tampered", "1", "rlc-bisect", 20),
                                                  ("tampered_persig", "0", "persig", 1)):
        os.environ["TMTPU_BISECT"] = bisect
        try:
            batch.verify_batch(pubkeys, msgs, sigs, device=dev)  # warm: this arm's shapes
            reset_launches()
            t0 = time.perf_counter()
            mask = batch.verify_batch(pubkeys, msgs, sigs, device=dev)
            torch.cuda.synchronize()
            batch_ms = (time.perf_counter() - t0) * 1e3
            launches[path] = read_launches(path)
            f = dict(batch.LAST_FLUSH)
            bad = tuple(int(i) for i in np.flatnonzero(~mask))
            if bad != TAMPERED:
                raise SystemExit(f"{path} mask wrong: False at {bad}, expected {TAMPERED}")
            if (f.get("path"), f.get("recovery_flushes"), f.get("mode")) != (
                    want_path, want_flushes, "pipelined"):
                raise SystemExit(f"{path} flush detail wrong: {f}")
            print(f"{path} rows {bad}: verify_batch ms={batch_ms:.1f} path={f['path']} "
                  f"recovery_flushes={f['recovery_flushes']} "
                  f"recovery_ms={f['recovery_s'] * 1e3:.1f} launches={launches[path]}", flush=True)
        finally:
            del os.environ["TMTPU_BISECT"]


def device_sort_phase(dev, corpus, launches: dict) -> None:
    """The device-sort arm (TMTPU_DEVICE_SORT=1: the cached-A flush sorts
    its windows on the card, msm_torch.sort_windows_device) against the
    host sort (0) on the warm 10k single flush, the stream off: 7
    interleaved pairs of verify_commit (label "rlc", mode "cached", the
    LAST_FLUSH device_sort flag), one profiled call of each, and the
    TAMPERED rows through verify_batch under each (the bisection's cached
    sub-checks sort on the card too): equal masks, labels and recovery
    flushes."""
    from tendermint_tpu_torch.crypto import batch

    vals, block_id, commit, msgs = corpus
    pubkeys = [v.pub_key.bytes() for v in vals.validators]
    bad_sigs = [cs.signature for cs in commit.signatures]
    for i in TAMPERED:
        bad_sigs[i] = flip(bad_sigs[i])
    path_of = {"0": "warm", "1": "warm_dsort"}

    def verify(flag: str) -> dict:
        os.environ["TMTPU_DEVICE_SORT"] = flag
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        f = dict(batch.LAST_FLUSH)
        same_counts(launches, path_of[flag], read_launches(path_of[flag]))
        if (f.get("path"), f.get("mode"), f.get("device_sort", False)) != (
                "rlc", "cached", flag == "1"):
            raise SystemExit(f"device sort {flag}: flush {f}")
        return ms

    stream = batch._stream_enabled()
    batch.configure_prep(stream=False)
    try:
        verify("1")  # warm: the sort's own launches
        times = {"0": [], "1": []}
        for _ in range(7):
            for flag in ("0", "1"):
                times[flag].append(verify(flag))
        med = {k: statistics.median(v) for k, v in times.items()}
        tampered = {}
        for flag in ("0", "1"):
            os.environ["TMTPU_DEVICE_SORT"] = flag
            reset_launches()
            mask = batch.verify_batch(pubkeys, msgs, bad_sigs, device=dev)
            launches[f"{path_of[flag]} tampered"] = read_launches(f"{path_of[flag]} tampered")
            f = batch.LAST_FLUSH
            tampered[flag] = (mask.tobytes(), f.get("path"), f.get("recovery_flushes"))
        bad = tuple(int(i) for i in np.flatnonzero(~mask))
        if tampered["0"] != tampered["1"] or bad != TAMPERED:
            raise SystemExit(f"device sort: tampered masks or labels differ: "
                             f"{[(t[1], t[2]) for t in tampered.values()]}, False at {bad}")
        print(f"device sort (10k warm single flush, stream off; 7 interleaved pairs): "
              f"TMTPU_DEVICE_SORT=1 median_ms={med['1']:.1f} "
              f"ms={[round(t, 1) for t in times['1']]} against the host sort median_ms="
              f"{med['0']:.1f} ms={[round(t, 1) for t in times['0']]}; launches per call "
              f"{launches['warm_dsort']} (host sort {launches['warm']}); tampered rows {bad}: "
              f"the same mask, path {tampered['1'][1]} and recovery flushes "
              f"{tampered['1'][2]} under both", flush=True)
        for flag in ("0", "1"):
            os.environ["TMTPU_DEVICE_SORT"] = flag
            profile_path(f"{path_of[flag]} (device sort A/B)", lambda: vals.verify_commit(
                CHAIN_ID, block_id, HEIGHT, commit, device=dev), med[flag])
    finally:
        os.environ.pop("TMTPU_DEVICE_SORT", None)
        batch.configure_prep(stream=stream)


def host_small_phase(dev, corpus, launches: dict) -> None:
    """The host arm: BASELINE config 1 (128 rows through Ed25519BatchVerifier
    with no backend and no device) takes the host combined check with no
    kernel launched; 200 rows with a bad row take the host bisection; the
    same 128 rows through Ed25519BatchVerifier(device=<the card>), which asks
    for the card, run its per-signature ladder (the reference's batch128).
    Every mask is held against ed25519_ref.verify_cofactored."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E

    vals, _, commit, msgs = corpus
    pks = [v.pub_key.bytes() for v in vals.validators[:200]]
    sigs = [cs.signature for cs in commit.signatures[:200]]
    msgs = list(msgs[:200])

    def held(mask, sigs_, n):
        want = [E.verify_cofactored(pks[i], msgs[i], sigs_[i]) for i in range(n)]
        if mask.tolist() != want:
            raise SystemExit("host_small: a mask differs from ed25519_ref.verify_cofactored")

    out = {}
    for tag, device in (("host_small", None), ("host_small_cuda", dev)):
        v = batch.Ed25519BatchVerifier(device=device)
        for row in zip(pks[:128], msgs[:128], sigs[:128]):
            v.add(*row)
        v.verify()  # warm
        times = []
        for _ in range(5):
            reset_launches()
            t0 = time.perf_counter()
            mask = v.verify()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            same_counts(launches, tag, read_launches(tag, () if device is None else
                                                     ("padd", "pdbl", "fsquare_chain")))
        f = dict(batch.LAST_FLUSH)
        held(mask, sigs, 128)
        want = ("host_rlc", "cpu") if device is None else ("persig", "persig")
        if (f.get("mode"), f.get("path")) != want or not mask.all():
            raise SystemExit(f"{tag}: flush {f}, {int((~mask).sum())} rows False")
        if device is None and any(launches[tag].values()):
            raise SystemExit(f"host_small launched kernels: {launches[tag]}")
        out[tag] = statistics.median(times)
    bad = list(sigs)
    bad[150] = flip(bad[150])
    reset_launches()
    t0 = time.perf_counter()
    mask = batch.verify_batch(pks, msgs, bad)
    bisect_ms = (time.perf_counter() - t0) * 1e3
    launches["host_small_bisect"] = read_launches("host_small_bisect", ())
    f = dict(batch.LAST_FLUSH)
    held(mask, bad, 200)
    if (np.flatnonzero(~mask).tolist() != [150] or f.get("path") != "cpu"
            or f.get("mode") != "host_serial" or not f.get("recovery_flushes")
            or any(launches["host_small_bisect"].values())):
        raise SystemExit(f"host_small bisection: {f}, launches {launches['host_small_bisect']}")
    print(f"host_small (BASELINE config 1, 128 rows): Ed25519BatchVerifier() median_ms="
          f"{out['host_small']:.2f} mode=host_rlc path=cpu launches=0; "
          f"Ed25519BatchVerifier(device={dev}) median_ms="
          f"{out['host_small_cuda']:.2f} launches per call={launches['host_small_cuda']}; "
          f"200 rows, row 150 bad: ms={bisect_ms:.1f} host bisection "
          f"recovery_flushes={f['recovery_flushes']} launches=0; masks equal "
          f"ed25519_ref.verify_cofactored", flush=True)


def flip(sig: bytes) -> bytes:
    s = bytearray(sig)
    s[40] ^= 0x01
    return bytes(s)


def streamed_phase(dev, corpus, launches: dict) -> None:
    """verify_batch over the commit's signed rows tiled STREAM_TILES times
    (100,000 rows, 9 planner chunks of 24,576 lanes): once to warm, three
    timed runs, one profiled; then two tampered rows in different chunks."""
    from tendermint_tpu_torch.crypto import batch

    vals, _, commit, msgs = corpus
    pubkeys = [v.pub_key.bytes() for v in vals.validators] * STREAM_TILES
    sigs = [cs.signature for cs in commit.signatures] * STREAM_TILES
    msgs = list(msgs) * STREAM_TILES
    n = len(pubkeys)
    assert batch.planner_engaged(n)

    def run():
        reset_launches()
        t0 = time.perf_counter()
        mask = batch.verify_batch(pubkeys, msgs, sigs, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        f = dict(batch.LAST_FLUSH)
        if not mask.all() or mask.shape != (n,):
            raise SystemExit(f"streamed mask wrong: {int((~mask).sum())} rows False")
        if not (f.get("mode") == "streamed" and f.get("path") == "rlc-streamed"
                and f.get("fused") and "recovery_s" not in f
                and f["chunk_lanes"] == 24_576
                and 0 < f["peak_lanes_in_flight"] <= 2 * f["chunk_lanes"]):
            raise SystemExit(f"streamed flush detail wrong: {f}")
        return ms, f

    run()  # warm
    times, flushes = [], []
    for _ in range(3):
        ms, f = run()
        times.append(ms)
        flushes.append(f)
        same_counts(launches, "streamed", read_launches("streamed"))
    f = flushes[-1]
    print(f"streamed {n} rows: e2e_median_ms={statistics.median(times):.1f} "
          f"e2e_ms={[round(t, 1) for t in times]} chunks={f['chunks']} "
          f"chunk_lanes={f['chunk_lanes']} peak_lanes_in_flight={f['peak_lanes_in_flight']} "
          f"host_prep_ms={statistics.median(x['prep_s'] for x in flushes) * 1e3:.1f} "
          f"prep_wait_ms={statistics.median(x['prep_wait_s'] for x in flushes) * 1e3:.1f} "
          f"launches={launches['streamed']}", flush=True)

    bad_sigs = list(sigs)
    for i in STREAM_TAMPERED:
        bad_sigs[i] = flip(bad_sigs[i])
    reset_launches()
    t0 = time.perf_counter()
    mask = batch.verify_batch(pubkeys, msgs, bad_sigs, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches["streamed_tampered"] = read_launches("streamed_tampered")
    f = dict(batch.LAST_FLUSH)
    bad = tuple(int(i) for i in np.flatnonzero(~mask))
    if bad != STREAM_TAMPERED or "recovery_s" not in f or f.get("path") != "rlc-streamed-recovery":
        raise SystemExit(f"streamed tampered mask wrong: False at {bad}, expected "
                         f"{STREAM_TAMPERED}; flush {f}")
    chunks = [(c["rows"], c["path"], c["recovery_flushes"]) for c in f["recovered_chunks"]]
    print(f"streamed tampered rows {bad}: verify_batch ms={ms:.1f} path={f['path']} (chunk-wise "
          f"recovery ms={f['recovery_s'] * 1e3:.1f}, recovery_flushes="
          f"{f.get('recovery_flushes')}) chunks (rows, path, recovery flushes)={chunks} "
          f"launches={launches['streamed_tampered']}", flush=True)


def _sign_mixed_rows(args):
    """(pubkey, signature) of each (key type, seed, message): Ed25519 by
    ed25519_ref, sr25519 by the port's schnorrkel signer."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519

    out = []
    for kind, seed, msg in args:
        if kind == "sr25519":
            priv = sr25519.gen_sr25519(seed)
            out.append((priv.pub_key().bytes(), priv.sign(msg)))
        else:
            a, prefix = ref.secret_expand(seed)
            pk = ref.point_compress(ref.point_mul(a, ref.BASE))
            r = ref.sha512_mod_l(prefix + msg)
            r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
            h = ref.sha512_mod_l(r_enc + pk + msg)
            out.append((pk, r_enc + ((r + h * a) % ref.L).to_bytes(32, "little")))
    return out


def build_mixed_sr25519(rng):
    """BASELINE config 5 as bench.py's make_batch builds it: N_VALIDATORS
    rows of distinct seeded keys, the last N_SR sr25519 and the rest
    Ed25519, each signing its own 110-byte message (a 6-digit index, '|',
    random bytes). Signed on a process pool before the card is touched."""
    t0 = time.perf_counter()
    n_ed = N_VALIDATORS - N_SR
    types = ["ed25519"] * n_ed + ["sr25519"] * N_SR
    jobs = [(t, rng.bytes(32), b"%06d|" % i + rng.bytes(SR_MSG_LEN - 7))
            for i, t in enumerate(types)]
    workers = os.cpu_count() or 1
    with mp.get_context("fork").Pool(workers) as pool:
        parts = pool.map(_sign_mixed_rows, [jobs[i::workers] for i in range(workers)])
        pool.close()
        pool.join()
    rows = [None] * N_VALIDATORS
    for i, part in enumerate(parts):
        rows[i::workers] = part
    print(f"mixed sr25519 corpus: {N_VALIDATORS} rows ({N_SR} sr25519) signed in "
          f"{time.perf_counter() - t0:.1f} s ({workers} processes)", flush=True)
    return dict(pubkeys=[pk for pk, _ in rows], msgs=[m for _, _, m in jobs],
                sigs=[sig for _, sig in rows], types=types, seeds=[seed for _, seed, _ in jobs])


def mixed_sr25519_phase(dev, sr: dict, launches: dict) -> None:
    """verify_batch(key_types=...) on the mixed Ed25519 + sr25519 set, the
    reference's one-MSM route ("rlc-mixed", mode "mixed", no sr25519 row on
    the host): a cold call (the set's keys are new to the A cache: both
    types are filled), SR_REPS timed warm calls after one more, one
    profiled; the split arm (_verify_batch_mixed_exact, the route before
    this slice: the Ed25519 rows on the card, pipelined, the sr25519 rows by
    the native verifier) warmed once and timed SR_REPS times beside it; then
    one Ed25519 row and one sr25519 row tampered: the combined check fails
    and the split recovers the exact mask (path "mixed", rlc_fallback).
    Launch counts: SR_MIXED_COLD, SR_MIXED_WARM. A 64-row sample of each
    mask is held against the port's pure-Python verifiers."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.crypto import sr25519

    pks, msgs, types = sr["pubkeys"], sr["msgs"], sr["types"]
    n_ed = N_VALIDATORS - N_SR
    blocks = (batch._lane_bucket(N_VALIDATORS + 1), batch._lane_bucket(n_ed),
              batch._lane_bucket(N_SR))

    def call(sigs):
        reset_launches()
        t0 = time.perf_counter()
        mask = batch.verify_batch(pks, msgs, sigs, device=dev, key_types=types)
        torch.cuda.synchronize()
        return mask, (time.perf_counter() - t0) * 1e3, dict(batch.LAST_FLUSH)

    def split():
        reset_launches()
        t0 = time.perf_counter()
        mask = batch._verify_batch_mixed_exact(pks, msgs, sr["sigs"], types, dev, None)
        torch.cuda.synchronize()
        return mask, (time.perf_counter() - t0) * 1e3, dict(batch.LAST_FLUSH)

    def held(mask, sigs, rows):
        for i in rows:
            py = (sr25519._sr25519_verify_py if types[i] == "sr25519" else E.verify_cofactored)
            if bool(mask[i]) != py(pks[i], msgs[i], sigs[i]):
                raise SystemExit(f"mixed_sr25519_10k: row {i} ({types[i]}) differs from the "
                                 f"pure-Python verifier")

    def one_msm(flush, mask, tag):
        if (not mask.all() or flush.get("path") != "rlc-mixed" or flush.get("mode") != "mixed"
                or "sr25519_rows" in flush or flush.get("lanes") != sum(blocks)
                or flush.get("sr_rows") != N_SR):
            raise SystemExit(f"mixed_sr25519_10k {tag}: {int((~mask).sum())} rows False, "
                             f"flush {flush}")

    rng = np.random.default_rng(SEED + 7)
    sample = sorted(set(int(i) for i in rng.integers(0, n_ed, 32))
                    | set(int(i) for i in rng.integers(n_ed, N_VALIDATORS, 32)))
    mask, cold_ms, cold = call(sr["sigs"])  # the keys are new: both A fills run
    one_msm(cold, mask, "cold")
    counts = launches["mixed_sr25519_10k cold"] = read_launches("mixed_sr25519_10k cold")
    if {k: counts[k] for k in SR_MIXED_COLD} != SR_MIXED_COLD:
        raise SystemExit(f"mixed_sr25519_10k cold launches {counts}, predicted {SR_MIXED_COLD}")
    call(sr["sigs"])  # warm
    times, flushes = [], []
    for _ in range(SR_REPS):
        mask, ms, flush = call(sr["sigs"])
        same_counts(launches, "mixed_sr25519_10k", read_launches("mixed_sr25519_10k"))
        one_msm(flush, mask, "warm")
        times.append(ms)
        flushes.append(flush)
    if {k: launches["mixed_sr25519_10k"][k] for k in SR_MIXED_WARM} != SR_MIXED_WARM:
        raise SystemExit(f"mixed_sr25519_10k launches {launches['mixed_sr25519_10k']}, "
                         f"predicted {SR_MIXED_WARM}")
    held(mask, sr["sigs"], sample)
    split()  # warm
    s_times, s_flushes = [], []
    for _ in range(SR_REPS):
        s_mask, ms, flush = split()
        same_counts(launches, "mixed_sr25519_10k split", read_launches("mixed_sr25519_10k split"))
        if (not s_mask.all() or flush.get("sr25519_rows") != N_SR
                or flush.get("mode") != "pipelined"):
            raise SystemExit(f"mixed_sr25519_10k split: {int((~s_mask).sum())} rows False, "
                             f"flush {flush}")
        s_times.append(ms)
        s_flushes.append(flush)

    def med(fl, key):
        return statistics.median(f[key] for f in fl) * 1e3

    print(f"mixed_sr25519_10k ({N_SR} sr25519 of {N_VALIDATORS}), one-MSM route rlc-mixed: "
          f"cold_ms={cold_ms:.1f} (A fills {cold['a_fill_s'] * 1e3:.1f} ms) median_ms="
          f"{statistics.median(times):.1f} ms={[round(t, 1) for t in times]} host_prep_ms="
          f"{med(flushes, 'prep_s'):.1f} (sr25519 challenges {med(flushes, 'challenge_s'):.1f} "
          f"ms) lanes={sum(blocks)} ({blocks[0]} A + {blocks[1]} Ed25519 R + {blocks[2]} "
          f"sr25519 R) "
          f"fused={flushes[0]['fused']}; launches cold={launches['mixed_sr25519_10k cold']} "
          f"warm per call={launches['mixed_sr25519_10k']}", flush=True)
    print(f"mixed_sr25519_10k split arm (Ed25519 rows pipelined on the card, sr25519 rows on "
          f"the host): median_ms={statistics.median(s_times):.1f} "
          f"ms={[round(t, 1) for t in s_times]} sr25519_host_ms={med(s_flushes, 'sr25519_s'):.1f}"
          f"; launches per call={launches['mixed_sr25519_10k split']}; card route / split "
          f"median {statistics.median(times) / statistics.median(s_times):.3f}", flush=True)
    profile_path("mixed_sr25519_10k", lambda: call(sr["sigs"]), statistics.median(times))
    profile_path("mixed_sr25519_10k split", split, statistics.median(s_times))

    bad_sigs = list(sr["sigs"])
    for i in SR_TAMPERED:
        bad_sigs[i] = flip(bad_sigs[i])
    mask, bad_ms, flush = call(bad_sigs)
    counts = launches["mixed_sr25519_10k tampered"] = read_launches("mixed_sr25519_10k tampered")
    bad = tuple(int(i) for i in np.flatnonzero(~mask))
    if (bad != SR_TAMPERED or flush.get("path") != "mixed" or not flush.get("rlc_fallback")
            or "recovery_s" not in flush or flush.get("sr25519_rows") != N_SR):
        raise SystemExit(f"mixed_sr25519_10k tampered: False at {bad}, expected {SR_TAMPERED}; "
                         f"flush {flush}")
    held(mask, bad_sigs, sorted(set(sample) | set(SR_TAMPERED)))
    print(f"mixed_sr25519_10k tampered rows {bad}: ms={bad_ms:.1f} (the failed combined check "
          f"{flush['combined_s'] * 1e3:.1f} ms, then the split: path {flush['path']}, "
          f"rlc_fallback, Ed25519 recovery ms={flush['recovery_s'] * 1e3:.1f} with "
          f"{flush.get('recovery_flushes')} recovery flushes, sr25519 host ms="
          f"{flush['sr25519_s'] * 1e3:.1f}) launches={counts}; masks equal the pure-Python "
          f"verifiers on {len(sample) + len(SR_TAMPERED)} rows", flush=True)


def build_mixed_commit(corpus):
    """A 10,000-validator set of N_MIXED_BLS BLS validators and the commit's
    first 10,000 - N_MIXED_BLS Ed25519 validators (power 10 each), with a
    plain Commit: each Ed25519 row keeps its signed CommitSig (sign bytes
    depend on the row's timestamp, not its index), each BLS row signs its own
    precommit sign bytes with bls_ref. Built before the card is touched."""
    from tendermint_tpu_torch.crypto import keys as K
    from tendermint_tpu_torch.types.basic import BlockIDFlag
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    vals, block_id, commit, _ = corpus
    privs = [K.gen_bls12_381(bytes([0x70 + i]) * 32) for i in range(N_MIXED_BLS)]
    ed = vals.validators[: N_VALIDATORS - N_MIXED_BLS]
    mixed = ValidatorSet(ed + [Validator(p.pub_key(), 10) for p in privs])
    by_addr = {cs.validator_address: cs for cs in commit.signatures}
    bls_by_addr = {p.pub_key().address(): p for p in privs}
    ts0 = 1_700_000_100_000_000_000
    rows = [by_addr.get(v.address) or CommitSig(BlockIDFlag.COMMIT, v.address, ts0 + i, b"")
            for i, v in enumerate(mixed.validators)]
    stub = Commit(HEIGHT, 0, block_id, rows)
    bls_idx = [i for i, v in enumerate(mixed.validators) if v.address in bls_by_addr]
    for i in bls_idx:
        cs = rows[i]
        rows[i] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                            bls_by_addr[cs.validator_address].sign(stub.vote_sign_bytes(CHAIN_ID, i)))
    print(f"mixed corpus: {N_VALIDATORS} validators ({N_MIXED_BLS} BLS at rows {bls_idx}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(vals=mixed, block_id=block_id, rows=rows, bls_idx=bls_idx)


def mixed_commit_phase(dev, mixed: dict, launches: dict) -> None:
    """verify_commit on the mixed set: honest, one bad BLS row, one bad
    Ed25519 row. The Ed25519 rows run the card path (all six kernels; the
    pipelined stream and, on the bad Ed25519 row, the bisection, since
    slice 9), the
    BLS rows bls_ref.verify on the host; the per-row verdicts
    (verify_batch(key_types=...)) are held against bls_ref on every BLS row
    and ed25519_ref on the tampered Ed25519 row and a sample of 64 others."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import bls_ref as B
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import CommitVerifyError

    vals, bid, bls_idx = mixed["vals"], mixed["block_id"], mixed["bls_idx"]
    ed_bad = next(i for i in range(N_VALIDATORS // 2, N_VALIDATORS) if i not in bls_idx)
    bls_bad = bls_idx[1]

    def commit_with(bad=None):
        rows = [CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                          flip(cs.signature) if i == bad else cs.signature)
                for i, cs in enumerate(mixed["rows"])]
        return Commit(HEIGHT, 0, bid, rows)

    def host_verdicts(c, rows):
        msgs = c.vote_sign_bytes_many(CHAIN_ID, rows)
        out = []
        for i, m in zip(rows, msgs):
            pk, sig = vals.validators[i].pub_key.bytes(), c.signatures[i].signature
            out.append(B.verify(pk, m, sig) if i in bls_idx else E.verify_cofactored(pk, m, sig))
        return out

    rng = np.random.default_rng(SEED + 3)
    sample = sorted(set(bls_idx) | {ed_bad} | set(int(i) for i in rng.integers(0, N_VALIDATORS, 64)))
    times = {}
    for case, bad in (("honest", None), ("bad_bls", bls_bad), ("bad_ed25519", ed_bad)):
        c = commit_with(bad)
        reset_launches()
        t0 = time.perf_counter()
        try:
            vals.verify_commit(CHAIN_ID, bid, HEIGHT, c, device=dev)
            got = "ok"
        except CommitVerifyError as e:
            got = str(e)
        torch.cuda.synchronize()
        times[case] = (time.perf_counter() - t0) * 1e3
        counts = read_launches(f"mixed_commit {case}")
        if case == "honest":
            launches["mixed_commit"] = counts
        want = "ok" if bad is None else f"wrong signature (#{bad})"
        if got != want:
            raise SystemExit(f"mixed_commit {case}: {got!r}, expected {want!r}")
        keys = [v.pub_key for v in vals.validators]
        mask = batch.verify_batch([k.bytes() for k in keys], c.vote_sign_bytes_many(
            CHAIN_ID, range(N_VALIDATORS)), [cs.signature for cs in c.signatures], device=dev,
            key_types=[k.type_name() for k in keys])
        host = host_verdicts(c, sample)
        if [bool(mask[i]) for i in sample] != host or int((~mask).sum()) != (bad is not None):
            raise SystemExit(f"mixed_commit {case}: card mask disagrees with bls_ref/ed25519_ref")
    print(f"mixed_commit {N_VALIDATORS} ({N_MIXED_BLS} BLS): verify_commit ms "
          + " ".join(f"{k}={v:.1f}" for k, v in times.items())
          + f"; verdicts equal bls_ref on every BLS row and ed25519_ref on {len(sample)} rows; "
          f"launches honest={launches['mixed_commit']}", flush=True)


def torsion_defect_row(rng, msg: bytes):
    """(A, signature) whose only defect is the order-2 point T2 in R:
    R = [r]B + T2, s = r + h a. Cofactored verification accepts it,
    cofactorless rejects it. A depends on `rng`'s state only."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    a = int.from_bytes(rng.bytes(32), "little") % ref.L
    r = int.from_bytes(rng.bytes(32), "little") % ref.L
    a_enc = ref.point_compress(ref.point_mul(a, ref.BASE))
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.BASE), (0, ref.P - 1, 1, 0)))
    h = ref.sha512_mod_l(r_enc + a_enc + msg)
    return a_enc, r_enc + ((r + h * a) % ref.L).to_bytes(32, "little")


def build_cofactorless_commit(corpus):
    """A set of the commit's first N_COFACTORLESS - 1 Ed25519 validators and
    one torsion-defect key (power 10 each), and a plain Commit: each Ed25519
    row keeps its signed CommitSig, the torsion key's row carries a
    torsion-defect signature over its own precommit sign bytes."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.basic import BlockIDFlag
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    vals, block_id, commit, _ = corpus
    seed = SEED + 6
    a_enc, _ = torsion_defect_row(np.random.default_rng(seed), b"")
    vset = ValidatorSet(vals.validators[: N_COFACTORLESS - 1] + [Validator(Ed25519PubKey(a_enc), 10)])
    by_addr = {cs.validator_address: cs for cs in commit.signatures}
    rows = [by_addr.get(v.address) or CommitSig(BlockIDFlag.COMMIT, v.address,
                                                1_700_000_200_000_000_000, b"")
            for v in vset.validators]
    k = next(i for i, v in enumerate(vset.validators) if v.pub_key.bytes() == a_enc)
    msg = Commit(HEIGHT, 0, block_id, rows).vote_sign_bytes(CHAIN_ID, k)
    cs = rows[k]
    rows[k] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                        torsion_defect_row(np.random.default_rng(seed), msg)[1])
    return dict(vals=vset, block_id=block_id, commit=Commit(HEIGHT, 0, block_id, rows), row=k)


def cofactorless_phase(dev, cf: dict, launches: dict) -> None:
    """The torsion-defect commit under verify mode cofactorless: refused on
    the host serial loop, with no kernel launched; an explicit
    backend="cuda" call accepts every row on the card (cofactored); then in
    cofactored mode the same commit passes on the card (the per-signature
    ladder: fewer than RLC_MIN rows)."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import keys
    from tendermint_tpu_torch.types.validator_set import CommitVerifyError

    vals, bid, commit, k = cf["vals"], cf["block_id"], cf["commit"], cf["row"]
    before = keys._VERIFY_MODE
    try:
        keys.set_verify_mode("cofactorless")
        reset_launches()
        t0 = time.perf_counter()
        try:
            vals.verify_commit(CHAIN_ID, bid, HEIGHT, commit, device=dev)
            got = "ok"
        except CommitVerifyError as e:
            got = str(e)
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches("cofactorless", ())
        launches["cofactorless"] = counts
        flush = dict(batch.LAST_FLUSH)
        if got != f"wrong signature (#{k})" or flush.get("mode") != "host_serial" or any(
                counts.values()):
            raise SystemExit(f"cofactorless: {got!r}, flush {flush}, launches {counts}; expected "
                             f"row {k} refused on the host serial loop with no launch")
        msgs = commit.vote_sign_bytes_many(CHAIN_ID, range(len(vals.validators)))
        mask = batch.verify_batch([v.pub_key.bytes() for v in vals.validators], msgs,
                                  [cs.signature for cs in commit.signatures], device=dev,
                                  backend="cuda")
        if not mask.all() or batch.LAST_FLUSH.get("mode") != "persig":
            raise SystemExit(f"cofactorless: backend='cuda' refused rows "
                             f"{np.flatnonzero(~mask).tolist()} on {batch.LAST_FLUSH}")
        keys.set_verify_mode("cofactored")
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, bid, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        launches["cofactored_300"] = read_launches("cofactored_300",
                                                   ("padd", "pdbl", "fsquare_chain"))
    finally:
        keys.set_verify_mode(before)
    print(f"cofactorless {len(vals.validators)} validators: torsion row #{k} refused on the host "
          f"serial loop in {host_ms:.1f} ms with no launch (OpenSSL: {keys._HAVE_OPENSSL}); "
          f"backend='cuda' accepts every row; cofactored on the card {card_ms:.1f} ms, "
          f"launches={launches['cofactored_300']}", flush=True)


def _sign_known(args):
    """Signatures of (seed, pubkey, message) rows by ed25519_ref, the key
    already known."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    out = []
    for seed, pk, msg in args:
        a, prefix = ref.secret_expand(seed)
        r = ref.sha512_mod_l(prefix + msg)
        r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
        h = ref.sha512_mod_l(r_enc + pk + msg)
        out.append(r_enc + ((r + h * a) % ref.L).to_bytes(32, "little"))
    return out


def _verify_cofactored_rows(args):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    return [ref.verify_cofactored(pk, msg, sig) for pk, msg, sig in args]


def pool_map(pool, fn, jobs, workers: int) -> list:
    """fn over jobs on the pool in `workers` strided parts, in job order."""
    parts = pool.map(fn, [jobs[i::workers] for i in range(workers)])
    out = [None] * len(jobs)
    for i, part in enumerate(parts):
        out[i::workers] = part
    return out


def light_header(h: int, vals, next_vals, last_hash: bytes):
    """A header of the light chains: seeded-free field hashes, time
    LIGHT_T0 + h s, the set's proposer."""
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.block import ConsensusVersion, Header

    return Header(
        version=ConsensusVersion(), chain_id=CHAIN_ID, height=h, time_ns=LIGHT_T0 + h * NANOS,
        last_block_id=(BlockID(last_hash, PartSetHeader(1, tmhash.sum256(last_hash)))
                       if last_hash else BlockID()),
        last_commit_hash=tmhash.sum256(b"lc%d" % h), data_hash=tmhash.sum256(b"d%d" % h),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=tmhash.sum256(b"c"), app_hash=tmhash.sum256(b"a%d" % h),
        last_results_hash=tmhash.sum256(b"r%d" % h), evidence_hash=tmhash.sum256(b"e"),
        proposer_address=vals.get_proposer().address)


def _commit_rows(header, vals, seed_of):
    """(block ID, CommitSig metadata, signing jobs) of every validator's
    precommit for `header`, each at its own timestamp."""
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader
    from tendermint_tpu_torch.types.block import Commit, CommitSig

    bid = BlockID(header.hash(), PartSetHeader(1, tmhash.sum256(header.hash())))
    meta = [(v.address, header.time_ns + 1_000 * i) for i, v in enumerate(vals.validators)]
    stub = Commit(header.height, 0, bid, [CommitSig(BlockIDFlag.COMMIT, a, ts, b"")
                                          for a, ts in meta])
    msgs = stub.vote_sign_bytes_many(CHAIN_ID, range(len(meta)))
    return bid, meta, [(seed_of[v.pub_key.bytes()], v.pub_key.bytes(), m)
                       for v, m in zip(vals.validators, msgs)]


def build_light(rng):
    """The light paths' chains, signed on a fork pool before the card is
    touched: the trusted (height 1, LIGHT_N validators) and untrusted
    (height 5, LIGHT_REPLACED of them replaced) light blocks of
    light_trusting_4k, the untrusted commit with LIGHT_TAMPERED bad rows of
    known validators and ed25519_ref.verify_cofactored's verdict on each of
    its rows, and the SKIP_HEIGHTS-block chain of SKIP_N validators whose
    whole set rotates at SKIP_ROTATION."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.basic import BlockIDFlag
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    n_keys = LIGHT_N + LIGHT_REPLACED + 2 * SKIP_N
    seeds = [rng.bytes(32) for _ in range(n_keys)]
    workers = os.cpu_count() or 1
    with mp.get_context("fork").Pool(workers) as pool:
        pubs = pool_map(pool, _pubkey_rows, [(s, b"") for s in seeds], workers)
        seed_of = dict(zip(pubs, seeds))

        def vset(lo, hi):
            return ValidatorSet([Validator(Ed25519PubKey(pk), 10) for pk in pubs[lo:hi]])

        trusted_vals = vset(0, LIGHT_N)
        untrusted_vals = vset(LIGHT_REPLACED, LIGHT_N + LIGHT_REPLACED)
        s1 = vset(LIGHT_N + LIGHT_REPLACED, LIGHT_N + LIGHT_REPLACED + SKIP_N)
        s2 = vset(LIGHT_N + LIGHT_REPLACED + SKIP_N, n_keys)
        headers = [(light_header(1, trusted_vals, trusted_vals, b""), trusted_vals),
                   (light_header(5, untrusted_vals, untrusted_vals, rng.bytes(32)),
                    untrusted_vals)]
        last = b""
        for h in range(1, SKIP_HEIGHTS + 1):
            vals, nxt = (s1 if h < SKIP_ROTATION else s2), (s1 if h + 1 < SKIP_ROTATION else s2)
            headers.append((light_header(h, vals, nxt, last), vals))
            last = headers[-1][0].hash()
        rows = [_commit_rows(hd, vals, seed_of) for hd, vals in headers]
        sigs = pool_map(pool, _sign_known, [j for _, _, jobs in rows for j in jobs], workers)
        blocks, k = [], 0
        for (hd, vals), (bid, meta, jobs) in zip(headers, rows):
            commit = Commit(hd.height, 0, bid, [
                CommitSig(BlockIDFlag.COMMIT, a, ts, sig)
                for (a, ts), sig in zip(meta, sigs[k:k + len(meta)])])
            k += len(meta)
            blocks.append(LightBlock(SignedHeader(hd, commit), vals))
        # the tampered commit: bad rows of validators the trusted set knows
        untrusted = blocks[1]
        known = [i for i, v in enumerate(untrusted_vals.validators)
                 if trusted_vals.has_address(v.address)]
        bad = sorted(int(i) for i in rng.choice(known, LIGHT_TAMPERED, replace=False))
        commit = untrusted.signed_header.commit
        tampered = Commit(commit.height, commit.round, commit.block_id, [
            CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                      flip(cs.signature) if i in bad else cs.signature)
            for i, cs in enumerate(commit.signatures)])
        jobs = rows[1][2]
        verdicts = pool_map(pool, _verify_cofactored_rows, [
            (pk, msg, cs.signature) for (_, pk, msg), cs in zip(jobs, tampered.signatures)],
            workers)
        pool.close()
        pool.join()
    print(f"light corpus: {n_keys} keys, {len(sigs)} signatures and {len(verdicts)} host "
          f"verdicts in {time.perf_counter() - t0:.1f} s ({workers} processes)", flush=True)
    return dict(trusted=blocks[0], untrusted=untrusted, tampered=tampered, bad=bad,
                verdicts=np.array(verdicts, dtype=bool),
                chain={lb.height: lb for lb in blocks[2:]})


def _mixed_pubkeys(args):
    """The pubkey of each (key type, seed): Ed25519 by ed25519_ref, sr25519
    by the port's schnorrkel key derivation."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519

    return [sr25519.gen_sr25519(seed).pub_key().bytes() if kind == "sr25519"
            else ref.point_compress(ref.point_mul(ref.secret_expand(seed)[0], ref.BASE))
            for kind, seed in args]


def build_light_mixed(rng):
    """The mixed light check's corpus, signed on a fork pool before the card
    is touched: LIGHT_N validators of power 10, LIGHT_MIXED_SR of them
    sr25519 (the last keys made), a light header at height 1, every
    validator's precommit for it, and the commit with row LIGHT_MIXED_BAD's
    signature flipped."""
    from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
    from tendermint_tpu_torch.types.basic import BlockIDFlag
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    kinds = ["ed25519"] * (LIGHT_N - LIGHT_MIXED_SR) + ["sr25519"] * LIGHT_MIXED_SR
    keys = [(k, rng.bytes(32)) for k in kinds]
    workers = os.cpu_count() or 1
    with mp.get_context("fork").Pool(workers) as pool:
        pubs = pool_map(pool, _mixed_pubkeys, keys, workers)
        vals = ValidatorSet([Validator(pubkey_from_type_and_bytes(k, pk), 10)
                             for (k, _), pk in zip(keys, pubs)])
        header = light_header(1, vals, vals, b"")
        bid, meta, jobs = _commit_rows(header, vals, dict(zip(pubs, keys)))
        signed = pool_map(pool, _sign_mixed_rows, [(k, seed, m) for (k, seed), _, m in jobs],
                          workers)
        pool.close()
        pool.join()
    sigs = [sig for _, sig in signed]
    commit = Commit(1, 0, bid, [CommitSig(BlockIDFlag.COMMIT, a, ts, sig)
                                for (a, ts), sig in zip(meta, sigs)])
    tampered = Commit(1, 0, bid, [
        CommitSig(BlockIDFlag.COMMIT, a, ts, flip(sig) if i == LIGHT_MIXED_BAD else sig)
        for i, ((a, ts), sig) in enumerate(zip(meta, sigs))])
    bad = jobs[LIGHT_MIXED_BAD]
    print(f"light mixed corpus: {LIGHT_N} validators ({LIGHT_MIXED_SR} sr25519) signed in "
          f"{time.perf_counter() - t0:.1f} s ({workers} processes)", flush=True)
    return dict(vals=vals, commit=commit, tampered=tampered,
                bad_row=(bad[0][0], bad[1], bad[2], flip(sigs[LIGHT_MIXED_BAD])))


@contextlib.contextmanager
def captured_finishes():
    """Every verify_batch_finish inside the block: its mask and the flush's
    route label, in finish order."""
    from tendermint_tpu_torch.crypto import batch

    seen, real = [], batch.verify_batch_finish

    def finish(h):
        mask = real(h)
        seen.append((mask, batch.LAST_FLUSH.get("path")))
        return mask

    batch.verify_batch_finish = finish
    try:
        yield seen
    finally:
        batch.verify_batch_finish = real


@contextlib.contextmanager
def counted(module, *names):
    """Calls of module.<name> inside the block, by name."""
    counts, saved = dict.fromkeys(names, 0), {n: getattr(module, n) for n in names}

    def wrap(name):
        def call(*a, **k):
            counts[name] += 1
            return saved[name](*a, **k)
        return call

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield counts
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


@contextlib.contextmanager
def tracked_submits():
    """Each batch._rlc_submit inside the block: its host ms, the six
    Ed25519 kernels' launches it queued, and whether an _rlc_finish synced
    it (a refused skipping step drops its light check unfinished)."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    subs, submit, finish = [], batch._rlc_submit, batch._rlc_finish

    def launched():
        return sum(cuda_fe.LAUNCHES.values()) + sum(cuda_msm.LAUNCHES.values())

    def sub(*a, **k):
        n0, t0 = launched(), time.perf_counter()
        call = submit(*a, **k)
        subs.append({"call": call, "ms": (time.perf_counter() - t0) * 1e3,
                     "launches": launched() - n0, "finished": False})
        return call

    def fin(call):
        for s in subs:
            s["finished"] |= s["call"] is call
        return finish(call)

    batch._rlc_submit, batch._rlc_finish = sub, fin
    try:
        yield subs
    finally:
        batch._rlc_submit, batch._rlc_finish = submit, finish
        for s in subs:
            s.pop("call")


def skipping_heights(lo: int, hi: int, rotation: int) -> list:
    """The heights the Client's bisection (light/client.py _verify_skipping)
    trusts from `lo` to `hi` on a chain whose whole set changes at
    `rotation`: a step is verified when it is adjacent or both ends have
    the same set; otherwise the midpoint is pushed."""
    trusted, current, stack = [lo], lo, [hi]
    while stack:
        cand = stack[-1]
        if cand == current + 1 or (cand < rotation) == (current < rotation):
            stack.pop()
            trusted.append(cand)
            current = cand
        else:
            stack.append((current + cand) // 2)
    return trusted


def light_phase(dev, lc: dict, launches: dict) -> None:
    """The four light paths, each with its own launch counts."""
    import asyncio
    from fractions import Fraction

    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.light.client import SKIPPING, Client, TrustOptions
    from tendermint_tpu_torch.light.provider import MockProvider
    from tendermint_tpu_torch.light.store import LightStore

    t_phase = time.perf_counter()
    trusted, untrusted = lc["trusted"], lc["untrusted"]
    tvals, uvals = trusted.validator_set, untrusted.validator_set
    commit = untrusted.signed_header.commit
    level = Fraction(1, 3)
    n_trusting = sum(tvals.has_address(cs.validator_address) for cs in commit.signatures)

    def step(sh=None):
        verifier.verify_non_adjacent(
            CHAIN_ID, trusted.signed_header, tvals, sh or untrusted.signed_header, uvals,
            LIGHT_PERIOD, LIGHT_NOW, LIGHT_DRIFT, level, device=dev)
        torch.cuda.synchronize()

    def checks_overlapped():
        fin_t = tvals.begin_verify_commit_light_trusting(CHAIN_ID, commit, level, device=dev)
        fin_l = uvals.begin_verify_commit_light(CHAIN_ID, commit.block_id, commit.height, commit,
                                                device=dev)
        fin_t()
        fin_l()
        torch.cuda.synchronize()

    def checks_serial():
        tvals.verify_commit_light_trusting(CHAIN_ID, commit, level, device=dev)
        uvals.verify_commit_light(CHAIN_ID, commit.block_id, commit.height, commit, device=dev)
        torch.cuda.synchronize()

    def timed_call(fn, path=None):
        reset_launches()
        with captured_finishes() as seen:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        if path is not None:
            same_counts(launches, path, read_launches(path))
        return ms, seen

    # light_trusting_4k: the first call runs the plain kernels and fills the A cache
    cold_ms, seen = timed_call(step)
    note_shapes("light_trusting_4k")
    labels = [p for _, p in seen]
    if labels != ["rlc-async", "rlc-async"] or [len(m) for m, _ in seen] != [n_trusting, LIGHT_N]:
        raise SystemExit(f"light_trusting_4k cold: labels {labels}, rows "
                         f"{[len(m) for m, _ in seen]}")
    times = {"step": [], "overlapped": [], "serial": []}
    for r in range(LIGHT_ROUNDS):  # interleaved; the pair's order alternates by round
        pair = [("overlapped", checks_overlapped), ("serial", checks_serial)]
        for key, fn in [("step", step)] + (pair if r % 2 == 0 else pair[::-1]):
            ms, seen = timed_call(fn, "light_trusting_4k")
            if [p for _, p in seen] != ["rlc-async", "rlc-async"] or not all(
                    m.all() for m, _ in seen):
                raise SystemExit(f"light_trusting_4k {key}: {[(int(m.sum()), p) for m, p in seen]}")
            times[key].append(ms)
    med = {k: statistics.median(v) for k, v in times.items()}
    q = statistics.quantiles(times["serial"], n=4)
    wins = sum(o < t for o, t in zip(times["overlapped"], times["serial"]))
    print(f"light_trusting_4k ({LIGHT_N} validators, {LIGHT_REPLACED} replaced, trust 1/3; "
          f"trusting check {n_trusting} rows, light check {LIGHT_N} rows): "
          f"verify_non_adjacent median_ms={med['step']:.1f} ms={[round(t, 1) for t in times['step']]} "
          f"cold_ms={cold_ms:.1f}; the two checks submitted together median_ms="
          f"{med['overlapped']:.1f} ms={[round(t, 1) for t in times['overlapped']]} against one "
          f"after the other median_ms={med['serial']:.1f} "
          f"ms={[round(t, 1) for t in times['serial']]} (serial quartiles {q[0]:.1f}-{q[2]:.1f}; "
          f"together faster in {wins} of {LIGHT_ROUNDS} interleaved rounds); labels rlc-async, "
          f"rlc-async; lanes "
          f"{2 * batch._lane_bucket(n_trusting + 1)} and {2 * batch._lane_bucket(LIGHT_N + 1)}; "
          f"launches per call={launches['light_trusting_4k']}", flush=True)
    profile_path("light_trusting_4k", step, med["step"])
    profile_path("light_trusting_4k serial", checks_serial, med["serial"])

    # light_tampered: both combined checks fail; each finish recovers by one
    # per-signature pass, and the step passes on the power left
    tampered_sh = type(untrusted.signed_header)(untrusted.signed_header.header, lc["tampered"])
    tvals_rows = [i for i, cs in enumerate(commit.signatures)
                  if tvals.has_address(cs.validator_address)]
    step(tampered_sh)  # warm: the ladder's shapes
    t_ms = []
    for _ in range(3):
        ms, seen = timed_call(lambda: step(tampered_sh), "light_tampered")
        t_ms.append(ms)
        (m_trust, p_trust), (m_light, p_light) = seen
        want = lc["verdicts"]
        if (p_trust, p_light) != ("persig-async", "persig-async") or (
                m_light.tobytes() != want.tobytes()
                or m_trust.tobytes() != want[tvals_rows].tobytes()):
            raise SystemExit(f"light_tampered: labels {p_trust}, {p_light}; light mask False at "
                             f"{np.flatnonzero(~m_light).tolist()}, expected {lc['bad']}")
    if np.flatnonzero(~lc["verdicts"]).tolist() != lc["bad"]:
        raise SystemExit("light_tampered: ed25519_ref refuses other rows than the tampered ones")
    print(f"light_tampered (rows {lc['bad']} bad): verify_non_adjacent median_ms="
          f"{statistics.median(t_ms):.1f} ms={[round(t, 1) for t in t_ms]}; labels persig-async, "
          f"persig-async; both masks equal ed25519_ref.verify_cofactored on all "
          f"{LIGHT_N} rows; launches per call={launches['light_tampered']}", flush=True)

    # light_skipping: a Client bisecting across the chain's full rotation
    chain = lc["chain"]
    client = Client(CHAIN_ID, TrustOptions(LIGHT_PERIOD, 1, chain[1].hash()),
                    MockProvider(CHAIN_ID, chain), [], LightStore(MemDB()),
                    verification_mode=SKIPPING, device=dev)
    want = skipping_heights(1, SKIP_HEIGHTS, SKIP_ROTATION)
    reset_launches()
    with counted(verifier, "verify_adjacent", "verify_non_adjacent") as steps, \
            counted(batch, "_persig_flush") as persig, tracked_submits() as subs:
        t0 = time.perf_counter()

        async def go():
            await client.initialize(LIGHT_NOW)
            return await client.verify_light_block_at_height(SKIP_HEIGHTS, LIGHT_NOW)

        lb = asyncio.run(go())
        torch.cuda.synchronize()
        skip_ms = (time.perf_counter() - t0) * 1e3
    launches["light_skipping"] = read_launches("light_skipping")
    if lb.hash() != chain[SKIP_HEIGHTS].hash() or client.store.heights() != want:
        raise SystemExit(f"light_skipping: trusted heights {client.store.heights()}, "
                         f"expected {want}")
    dropped = [s for s in subs if not s["finished"]]
    print(f"light_skipping ({SKIP_HEIGHTS} heights x {SKIP_N} validators, rotation at "
          f"{SKIP_ROTATION}): Client.verify_light_block_at_height({SKIP_HEIGHTS}) with "
          f"initialize ms={skip_ms:.1f}; trusted heights {client.store.heights()} (the "
          f"bisection's rule: {want}); steps {steps}; card flushes: {len(subs)} combined checks "
          f"submitted, {persig['_persig_flush']} per-signature passes; launches="
          f"{launches['light_skipping']}", flush=True)
    print(f"light_skipping: {len(dropped)} of {len(subs)} combined checks submitted and never "
          f"finished (the light checks of refused steps): host ms in their submits "
          f"{sum(s['ms'] for s in dropped):.1f} ({[round(s['ms'], 1) for s in dropped]}), "
          f"six-kernel launches {sum(s['launches'] for s in dropped)}; the finished ones' "
          f"submits {sum(s['ms'] for s in subs if s['finished']):.1f} ms", flush=True)

    # one light check submitted and dropped, as a refused step drops it: the
    # host ms of its submit, and under the profiler every kernel it queues
    top = chain[SKIP_HEIGHTS]
    c_top = top.signed_header.commit

    def drop():
        top.validator_set.begin_verify_commit_light(CHAIN_ID, c_top.block_id, c_top.height,
                                                    c_top, device=dev)

    drop_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        drop()
        drop_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    print(f"light_skipping dropped submit: host ms {[round(t, 1) for t in drop_ms]}", flush=True)
    profile_path("light_skipping dropped submit", drop, statistics.median(drop_ms))

    # light_accumulated: heights 1-8's commits in one flush, a bad row in commit 3
    hs = list(range(1, ACC_COMMITS + 1))
    commits = {}
    for h in hs:
        c = chain[h].signed_header.commit
        if h == ACC_BAD[0]:
            c = type(c)(c.height, c.round, c.block_id, [
                type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                         flip(cs.signature) if i == ACC_BAD[1] else cs.signature)
                for i, cs in enumerate(c.signatures)])
        commits[h] = c

    def begin(h):
        c = commits[h]
        return chain[h].validator_set.begin_verify_commit_light(CHAIN_ID, c.block_id, c.height,
                                                                c, device=dev)

    with captured_finishes() as separate:
        t0 = time.perf_counter()
        for h in hs:
            begin(h)()
        torch.cuda.synchronize()
        sep_ms = (time.perf_counter() - t0) * 1e3
    reset_launches()
    with captured_finishes() as seen:
        t0 = time.perf_counter()
        with batch.accumulate_flushes(device=dev) as acc:
            fins = [begin(h) for h in hs]
        acc.flush()
        acc_path = dict(batch.LAST_FLUSH)
        for fin in fins:
            fin()
        torch.cuda.synchronize()
        acc_ms = (time.perf_counter() - t0) * 1e3
    launches["light_accumulated"] = read_launches("light_accumulated")
    bad_flat = (ACC_BAD[0] - 1) * SKIP_N + ACC_BAD[1]
    if (acc.flush_count != 1 or acc.lanes != ACC_COMMITS * SKIP_N
            or [m.tobytes() for m, _ in seen] != [m.tobytes() for m, _ in separate]
            or np.flatnonzero(~acc.flush()).tolist() != [bad_flat]
            or acc_path.get("path") != "rlc-bisect"):
        raise SystemExit(f"light_accumulated: flush_count {acc.flush_count}, path "
                         f"{acc_path.get('path')}, False at {np.flatnonzero(~acc.flush()).tolist()}")
    print(f"light_accumulated ({ACC_COMMITS} commits x {SKIP_N} rows, row {ACC_BAD[1]} of commit "
          f"{ACC_BAD[0]} bad): one flush (flush_count 1) of {acc.lanes} rows, path "
          f"{acc_path['path']}, recovery_flushes={acc_path.get('recovery_flushes')}, "
          f"ms={acc_ms:.1f}; slices equal the separate submits' masks ({ACC_COMMITS} submits "
          f"and finishes one after the other: ms={sep_ms:.1f}, labels "
          f"{[p for _, p in separate]}); launches={launches['light_accumulated']}", flush=True)
    print(f"light phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def light_mixed_phase(dev, lm: dict, launches: dict) -> None:
    """The mixed asynchronous light check: begin_verify_commit_light_trusting
    and its finish (trust 1/3) over a 4,096-validator set holding
    LIGHT_MIXED_SR sr25519 validators, the one-MSM mixed flush submitted
    unsynced ("rlc-async", mode "mixed"): a cold call (both A fills), one
    more to warm, 5 timed, one profiled; then the commit with one tampered
    row, whose combined check fails and whose finish recovers by the exact
    per-type split (path "mixed", rlc_fallback): False exactly at that row,
    which the port's pure-Python verifier refuses too."""
    from fractions import Fraction

    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.crypto import sr25519

    vals, level = lm["vals"], Fraction(1, 3)
    n_sr = sum(v.pub_key.type_name() == "sr25519" for v in vals.validators)

    def check(commit, path):
        reset_launches()
        with captured_finishes() as seen:
            t0 = time.perf_counter()
            vals.begin_verify_commit_light_trusting(CHAIN_ID, commit, level, device=dev)()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches(path)
        (mask, label), = seen
        return mask, label, ms, dict(batch.LAST_FLUSH), counts

    def passing(mask, label, flush, tag):
        if (label != "rlc-async" or flush.get("mode") != "mixed" or not mask.all()
                or len(mask) != LIGHT_N or flush.get("sr_rows") != n_sr):
            raise SystemExit(f"light_mixed {tag}: label {label}, {int((~mask).sum())} rows "
                             f"False, flush {flush}")

    mask, label, cold_ms, flush, counts = check(lm["commit"], "light_mixed cold")
    launches["light_mixed cold"] = counts
    passing(mask, label, flush, "cold")
    check(lm["commit"], "light_mixed")  # warm
    times, flushes = [], []
    for _ in range(5):
        mask, label, ms, flush, counts = check(lm["commit"], "light_mixed")
        same_counts(launches, "light_mixed", counts)
        passing(mask, label, flush, "warm")
        times.append(ms)
        flushes.append(flush)
    mask, label, bad_ms, flush, counts = check(lm["tampered"], "light_mixed tampered")
    launches["light_mixed tampered"] = counts
    kind, pk, msg, sig = lm["bad_row"]
    py = sr25519._sr25519_verify_py if kind == "sr25519" else E.verify_cofactored
    if (label != "mixed" or not flush.get("rlc_fallback")
            or np.flatnonzero(~mask).tolist() != [LIGHT_MIXED_BAD] or py(pk, msg, sig)):
        raise SystemExit(f"light_mixed tampered: label {label}, False at "
                         f"{np.flatnonzero(~mask).tolist()}, flush {flush}")
    print(f"light_mixed ({LIGHT_N} validators, {n_sr} sr25519; trusting check of "
          f"{LIGHT_N} rows, {flushes[0]['lanes']} lanes): begin/finish label rlc-async mode "
          f"mixed, cold_ms={cold_ms:.1f} median_ms={statistics.median(times):.1f} "
          f"ms={[round(t, 1) for t in times]} host_prep_ms="
          f"{statistics.median(f['prep_s'] for f in flushes) * 1e3:.1f} (sr25519 challenges "
          f"{statistics.median(f['challenge_s'] for f in flushes) * 1e3:.1f} ms); launches cold="
          f"{launches['light_mixed cold']} per call={launches['light_mixed']}; tampered row "
          f"{LIGHT_MIXED_BAD} ({kind}): ms={bad_ms:.1f} label {label}, rlc_fallback, False "
          f"there only (the pure-Python verifier refuses it); launches="
          f"{launches['light_mixed tampered']}", flush=True)
    profile_path("light_mixed", lambda: check(lm["commit"], "light_mixed"),
                 statistics.median(times))


def catchup_block(h: int, vals_hash: bytes, proposer: bytes, last_bid, last_commit, rng):
    """A real block at height h: CATCHUP_TXS seeded transactions, the header
    over them, the previous block's ID and its commit."""
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices
    from tendermint_tpu_torch.types.block import Block, ConsensusVersion, Header, txs_hash

    txs = [rng.bytes(200) for _ in range(CATCHUP_TXS)]
    header = Header(
        version=ConsensusVersion(), chain_id=CHAIN_ID, height=h, time_ns=LIGHT_T0 + h * NANOS,
        last_block_id=last_bid, last_commit_hash=last_commit.hash(), data_hash=txs_hash(txs),
        validators_hash=vals_hash, next_validators_hash=vals_hash,
        consensus_hash=tmhash.sum256(b"c"), app_hash=tmhash.sum256(b"a%d" % h),
        last_results_hash=tmhash.sum256(b"r%d" % h), evidence_hash=hash_from_byte_slices([]),
        proposer_address=proposer)
    return Block(header, txs, (), last_commit)


def build_catchup(rng):
    """The catch-up chains of CATCHUP, signed on a fork pool before the card
    is touched: for each, n_blocks + 1 real blocks with their part sets,
    block h + 1 carrying every validator's precommit for block h (each at
    its own timestamp), so the run of triples (block, parts, next block)
    commits blocks 1..n_blocks. A block's ID holds its last commit's hash,
    so the chain is built height by height, each commit signed on the pool."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag
    from tendermint_tpu_torch.types.block import EMPTY_COMMIT, Commit, CommitSig
    from tendermint_tpu_torch.types.part_set import PartSet
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    workers = os.cpu_count() or 1
    out, n_sigs = {}, 0
    with mp.get_context("fork").Pool(workers) as pool:
        for name, (n_blocks, n_vals, per_run) in CATCHUP.items():
            seeds = [rng.bytes(32) for _ in range(n_vals)]
            pubs = pool_map(pool, _pubkey_rows, [(s, b"") for s in seeds], workers)
            seed_of = dict(zip(pubs, seeds))
            vals = ValidatorSet([Validator(Ed25519PubKey(pk), 10) for pk in pubs])
            vals_hash, proposer = vals.hash(), vals.get_proposer().address
            last_bid, last_commit, blocks = BlockID(), EMPTY_COMMIT, []
            for h in range(1, n_blocks + 2):
                block = catchup_block(h, vals_hash, proposer, last_bid, last_commit, rng)
                parts = PartSet.from_data(block.encode())
                blocks.append((block, parts))
                last_bid = BlockID(block.hash(), parts.header)
                meta = [(v.address, block.header.time_ns + 1_000 * i)
                        for i, v in enumerate(vals.validators)]
                stub = Commit(h, 0, last_bid, [CommitSig(BlockIDFlag.COMMIT, a, ts, b"")
                                               for a, ts in meta])
                if h <= n_blocks:
                    msgs = stub.vote_sign_bytes_many(CHAIN_ID, range(n_vals))
                    sigs = pool_map(pool, _sign_known, [
                        (seed_of[v.pub_key.bytes()], v.pub_key.bytes(), m)
                        for v, m in zip(vals.validators, msgs)], workers)
                    n_sigs += len(sigs)
                    last_commit = Commit(h, 0, last_bid, [
                        CommitSig(BlockIDFlag.COMMIT, a, ts, sig)
                        for (a, ts), sig in zip(meta, sigs)])
            triples = [(blocks[i][0], blocks[i][1], blocks[i + 1][0]) for i in range(n_blocks)]
            out[name] = dict(vals=vals, runs=[triples[i:i + per_run]
                                              for i in range(0, n_blocks, per_run)])
        pool.close()
        pool.join()
    sizes = ", ".join(f"{k} {v[0]} blocks x {v[1]} validators" for k, v in CATCHUP.items())
    print(f"catchup corpus: {sizes}: {n_sigs} signatures in {time.perf_counter() - t0:.1f} s "
          f"({workers} processes)", flush=True)
    return out


@contextlib.contextmanager
def memo_rows(rows: int):
    """The verified-row memo at `rows` inside the block (the timed phases run
    with it off, as bench.py times), off again after it."""
    from tendermint_tpu_torch.crypto import batch

    batch.configure_verified_memo(rows)
    try:
        yield
    finally:
        batch.configure_verified_memo(0)


def commit_1k_phase(dev, corpus, launches: dict) -> None:
    """verify_commit_1k: the first N_1K corpus validators and their own
    signatures, one height: cold (A cache reset: the plain kernel), then 5
    warm calls (cached A), both the single flush ("rlc": at least 256 rows
    and below the 2,048-row stream floor); one warm call profiled."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    vals, block_id, commit, _ = corpus
    vals1k = ValidatorSet(vals.validators[:N_1K])
    commit1k = Commit(HEIGHT, 0, block_id, commit.signatures[:N_1K])

    def verify(tag: str) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        vals1k.verify_commit(CHAIN_ID, block_id, HEIGHT, commit1k, device=dev)
        torch.cuda.synchronize()
        return dict(batch.LAST_FLUSH, ms=(time.perf_counter() - t0) * 1e3,
                    counts=read_launches(tag))

    batch.reset_a_cache()
    cold = verify("verify_commit_1k cold")
    launches["verify_commit_1k cold"] = cold["counts"]
    warm = [verify("verify_commit_1k") for _ in range(6)][1:]
    for f in warm:
        same_counts(launches, "verify_commit_1k", f["counts"])
    if (cold.get("path"), cold.get("mode")) != ("rlc", "plain") or any(
            (f.get("path"), f.get("mode")) != ("rlc", "cached") for f in warm):
        raise SystemExit(f"verify_commit_1k route wrong: cold {cold}, warm {warm[0]}")
    wms = statistics.median(f["ms"] for f in warm)
    print(f"verify_commit_1k ({N_1K} validators x power 10): cold_ms={cold['ms']:.1f} "
          f"warm_median_ms={wms:.1f} warm_ms={[round(f['ms'], 1) for f in warm]} "
          f"path={warm[0]['path']} modes cold={cold['mode']} warm={warm[0]['mode']} "
          f"lanes={warm[0]['lanes']} launches cold={cold['counts']} "
          f"warm per call={launches['verify_commit_1k']}", flush=True)
    profile_path("verify_commit_1k", lambda: vals1k.verify_commit(
        CHAIN_ID, block_id, HEIGHT, commit1k, device=dev), wms)


def storm_votes(vals, block_id, commit):
    """The corpus commit's signatures as the precommits of a vote stream:
    a precommit's sign bytes are the commit row's (height, round, block ID,
    timestamp), whatever the validator's index."""
    from tendermint_tpu_torch.types.basic import SignedMsgType
    from tendermint_tpu_torch.types.vote import Vote

    return [Vote(SignedMsgType.PRECOMMIT, HEIGHT, 0, block_id, cs.timestamp_ns,
                 cs.validator_address, i, cs.signature)
            for i, cs in enumerate(commit.signatures)]


def six_launches() -> dict:
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    return {**cuda_fe.LAUNCHES, **cuda_msm.LAUNCHES}


def run_storm(dev, vals, votes, defer: bool = True, peers: bool = False):
    """Every vote into a fresh VoteSet, flushed every DRAIN adds when
    deferred: (vote set, [(rows, ms, label, recovery flushes, failed,
    launches)], total ms). With `peers` vote k comes from peer p<k % PEERS>,
    the provenance of its row."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.basic import SignedMsgType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    vs = VoteSet(CHAIN_ID, HEIGHT, 0, SignedMsgType.PRECOMMIT, vals,
                 defer_verification=defer, device=dev)
    flushes = []
    t0 = time.perf_counter()
    want = "pending" if defer else True
    for k, vote in enumerate(votes, 1):
        got = vs.add_vote(vote, f"p{k % PEERS}" if peers else "")
        if got != want:
            raise SystemExit(f"vote {k - 1}: add_vote gave {got!r}, expected {want!r}")
        if defer and (k % DRAIN == 0 or k == len(votes)):
            rows = vs.pending_count()
            n0, tf = six_launches(), time.perf_counter()
            _, failed = vs.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - tf) * 1e3
            n1 = six_launches()
            flushes.append((rows, ms, batch.LAST_FLUSH.get("path"),
                            batch.LAST_FLUSH.get("recovery_flushes"), failed,
                            {name: n1[name] - n0[name] for name in ED25519_KERNELS}))
    return vs, flushes, (time.perf_counter() - t0) * 1e3


def vote_storm_phase(dev, corpus, launches: dict, memo_default: int) -> None:
    """vote_storm_10k: the 10k corpus's precommits into a deferred VoteSet,
    flushed every DRAIN adds (19 flushes of 512 rows, one of 272), with the
    memo off: each flush's rows, ms and label, votes/s; +2/3 and
    make_commit's bytes against the corpus commit. Beside it the
    verify-at-add arm (one host verify a vote, no launch) on the first
    AT_ADD_VOTES votes. With the default memo the storm again, and the
    commit it makes verified from the memo: path "memo", 0 launches. Then
    the tampered round: one bad vote in a drain, an equivocating pair
    (pop_conflicts), and DuplicateVoteEvidence checked through verify_batch,
    then refused with vote B's signature flipped."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.vote import Vote

    vals, block_id, commit, _ = corpus
    votes = storm_votes(vals, block_id, commit)
    run_storm(dev, vals, votes)  # warm
    reset_launches()
    vs, flushes, total_ms = run_storm(dev, vals, votes)
    launches["vote_storm_10k"] = read_launches("vote_storm_10k")
    made = vs.make_commit().encode()
    drains = [DRAIN] * (N_VALIDATORS // DRAIN) + [N_VALIDATORS % DRAIN] * bool(N_VALIDATORS % DRAIN)
    if (not vs.has_two_thirds_majority() or made != commit.encode()
            or [r for r, *_ in flushes] != drains or any(f[4] for f in flushes)):
        raise SystemExit(f"vote_storm_10k: maj23 {vs.has_two_thirds_majority()}, commit equal "
                         f"{made == commit.encode()}, flushes {[f[:3] for f in flushes]}")
    flush_ms = [f[1] for f in flushes]
    print(f"vote_storm_10k ({N_VALIDATORS} precommits, a flush every {DRAIN} adds): "
          f"ms={total_ms:.1f} votes_per_s={N_VALIDATORS / total_ms * 1e3:.0f} "
          f"flushes={len(flushes)} flush_ms_sum={sum(flush_ms):.1f} "
          f"flush_512_median_ms={statistics.median(flush_ms[:-1]):.1f} "
          f"flush_{drains[-1]}_ms={flush_ms[-1]:.1f} labels={sorted(set(f[2] for f in flushes))} "
          f"({DRAIN}: {flushes[0][2]}, {drains[-1]}: {flushes[-1][2]}); +2/3 True; make_commit "
          f"bytes equal "
          f"the corpus commit's; launches={launches['vote_storm_10k']}", flush=True)
    print(f"vote_storm_10k flush ms: {[round(t, 1) for t in flush_ms]}", flush=True)
    reset_launches()
    _, _, at_add_ms = run_storm(dev, vals, votes[:AT_ADD_VOTES], defer=False)
    counts = read_launches("vote_storm_10k verify-at-add", kernels=())
    if any(counts[k] for k in ED25519_KERNELS):
        raise SystemExit(f"the verify-at-add arm launched kernels: {counts}")
    print(f"vote_storm_10k verify-at-add (defer_verification=False, one host verify a vote, "
          f"first {AT_ADD_VOTES} votes): ms={at_add_ms:.1f} "
          f"votes_per_s={AT_ADD_VOTES / at_add_ms * 1e3:.0f}, 0 launches", flush=True)

    with memo_rows(memo_default):
        vs, _, memo_ms = run_storm(dev, vals, votes)
        made = vs.make_commit()
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, made, device=dev)
        verify_ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches("vote_storm_10k memo commit", kernels=())
        f = dict(batch.LAST_FLUSH)
        stats = batch.verified_memo_stats()
    if f.get("path") != "memo" or f.get("memo_hits") != N_VALIDATORS or any(
            counts[k] for k in ED25519_KERNELS):
        raise SystemExit(f"the storm's commit did not come from the memo: {f}, {counts}")
    print(f"vote_storm_10k -> verify_commit with the default memo: storm ms={memo_ms:.1f}, "
          f"verify_commit ms={verify_ms:.2f} path=memo memo_hits={f['memo_hits']} 0 launches; "
          f"memo {stats}", flush=True)

    # the tampered round: a bad vote, then an equivocation by the key of seed 0
    seed0 = np.random.default_rng(SEED + 1).bytes(32)
    pk0 = E.public_key(seed0)
    idx0, val0 = vals.get_by_address(Ed25519PubKey(pk0).address())
    bad_votes = list(votes[:DRAIN])
    bad_votes[STORM_BAD] = bad_votes[STORM_BAD].with_signature(
        flip(bad_votes[STORM_BAD].signature))
    reset_launches()
    vs, flushes, tampered_ms = run_storm(dev, vals, bad_votes)
    launches["vote_storm_10k tampered"] = read_launches("vote_storm_10k tampered")
    rows, _, label, recovery, failed, _ = flushes[0]
    if failed != [STORM_BAD]:
        raise SystemExit(f"vote_storm_10k tampered: failed {failed}, expected [{STORM_BAD}]")
    other = BlockID(b"\x0b" * 32, PartSetHeader(1, b"\x0c" * 32))
    vote_a = votes[idx0]
    vote_b = Vote(vote_a.type, HEIGHT, 0, other, vote_a.timestamp_ns, vote_a.validator_address,
                  idx0)
    vote_b = vote_b.with_signature(E.sign(seed0, vote_b.sign_bytes(CHAIN_ID)))
    for v in (vote_a, vote_b):
        vs.add_vote(v)
        vs.flush()
    conflicts = vs.pop_conflicts()
    if [(c.vote_a.encode(), c.vote_b.encode()) for c in conflicts] != [
            (vote_a.encode(), vote_b.encode())]:
        raise SystemExit(f"vote_storm_10k: pop_conflicts gave {len(conflicts)} conflicts")
    ev = DuplicateVoteEvidence.from_votes(conflicts[0].vote_a, conflicts[0].vote_b,
                                          commit.signatures[0].timestamp_ns,
                                          vals.total_voting_power(), val0.voting_power)
    reset_launches()
    ev.verify(CHAIN_ID, val0.pub_key, batch_verifier=lambda p, m, s, kt: batch.verify_batch(
        p, m, s, key_types=kt))
    ev_path = batch.LAST_FLUSH.get("path")
    forged = DuplicateVoteEvidence(ev.vote_a, ev.vote_b.with_signature(flip(ev.vote_b.signature)),
                                   ev.total_voting_power, ev.validator_power, ev.timestamp_ns)
    try:
        forged.verify(CHAIN_ID, val0.pub_key, batch_verifier=lambda p, m, s, kt:
                      batch.verify_batch(p, m, s, key_types=kt))
    except ValueError as e:
        refusal = str(e)
    else:
        raise SystemExit("DuplicateVoteEvidence with a flipped signature was accepted")
    counts = read_launches("vote_storm_10k evidence", kernels=())
    if refusal != "verifying VoteB: invalid signature" or any(
            counts[k] for k in ED25519_KERNELS):
        raise SystemExit(f"evidence check: {refusal!r}, launches {counts}")
    print(f"vote_storm_10k tampered: vote {STORM_BAD} bad -> failed {failed}, drain of {rows} "
          f"rows path={label} recovery_flushes={recovery} (storm ms={tampered_ms:.1f}, "
          f"launches={launches['vote_storm_10k tampered']}); validator {idx0} equivocates: "
          f"pop_conflicts gave the pair; DuplicateVoteEvidence.verify through verify_batch "
          f"passed (path {ev_path}, 0 launches), with vote B's signature flipped: {refusal!r}",
          flush=True)


def catchup_phase(dev, cu: dict, launches: dict) -> None:
    """catchup_128 (3 runs of 16 blocks, 2,048 rows each: the pipelined
    stream) and super_batch_1k (one run of 16 blocks, 16,384 rows: the
    streamed planner) through blocksync.verify.verify_run_batched on the
    card: every run warm once, then timed, per-run ms, blocks/s, labels and
    launches per run, one run profiled. Then the tampered catchup_128 run:
    bad signatures on CATCHUP_BAD_ROWS of block CATCHUP_BAD_BLOCK's rows
    (more than a third of the power) and a wrong block ID in block
    CATCHUP_WRONG_ID's commit: the index is CATCHUP_BAD_BLOCK, and
    CATCHUP_WRONG_ID once that block is repaired."""
    import dataclasses

    from tendermint_tpu_torch.blocksync.verify import verify_run_batched
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.basic import BlockID

    def check(vals, run, path=None):
        reset_launches()
        t0 = time.perf_counter()
        got = verify_run_batched(vals, CHAIN_ID, run, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches(path) if path else None
        return got, ms, dict(batch.LAST_FLUSH), counts

    for name, (n_blocks, n_vals, per_run) in CATCHUP.items():
        vals, runs = cu[name]["vals"], cu[name]["runs"]
        for run in runs:
            check(vals, run)  # warm
        timed_runs = [check(vals, run, name) for run in runs]
        for got, _, f, counts in timed_runs:
            same_counts(launches, name, counts)
            if got is not None:
                raise SystemExit(f"{name}: an honest run failed at {got}: {f}")
        ms = [t for _, t, _, _ in timed_runs]
        labels = sorted({f.get("path") for _, _, f, _ in timed_runs})
        f0 = timed_runs[0][2]
        print(f"{name} ({n_blocks} blocks x {n_vals} validators, runs of {per_run}: "
              f"{per_run * n_vals} rows a run): run_ms={[round(t, 1) for t in ms]} "
              f"blocks_per_s={n_blocks / sum(ms) * 1e3:.1f} labels={labels} mode={f0.get('mode')} "
              f"chunks={f0.get('chunks')} launches per run={launches[name]}", flush=True)
        profile_path(name, lambda: verify_run_batched(vals, CHAIN_ID, runs[0], device=dev),
                     statistics.median(ms))

    vals, run = cu["catchup_128"]["vals"], list(cu["catchup_128"]["runs"][0])
    first, parts, second = run[CATCHUP_BAD_BLOCK]
    lc = second.last_commit
    sigs = [flip(cs.signature) if i < 2 * CATCHUP_BAD_ROWS and i % 2 == 0 else cs.signature
            for i, cs in enumerate(lc.signatures)]
    bad_commit = dataclasses.replace(lc, signatures=tuple(
        dataclasses.replace(cs, signature=sg) for cs, sg in zip(lc.signatures, sigs)))
    run[CATCHUP_BAD_BLOCK] = (first, parts, dataclasses.replace(second, last_commit=bad_commit))
    first, parts, second = run[CATCHUP_WRONG_ID]
    wrong = BlockID(b"\x0e" * 32, second.last_commit.block_id.part_set_header)
    run[CATCHUP_WRONG_ID] = (first, parts, dataclasses.replace(
        second, last_commit=dataclasses.replace(second.last_commit, block_id=wrong)))
    got, ms, f, launches["catchup_128 tampered"] = check(vals, run, "catchup_128 tampered")
    repaired = list(run)
    repaired[CATCHUP_BAD_BLOCK] = cu["catchup_128"]["runs"][0][CATCHUP_BAD_BLOCK]
    got2, ms2, f2, _ = check(vals, repaired, "catchup_128 repaired")
    if (got, got2) != (CATCHUP_BAD_BLOCK, CATCHUP_WRONG_ID):
        raise SystemExit(f"catchup tampered run: index {got} then {got2}, expected "
                         f"{CATCHUP_BAD_BLOCK} then {CATCHUP_WRONG_ID}")
    print(f"catchup_128 tampered run ({CATCHUP_BAD_ROWS} bad signatures in block "
          f"{CATCHUP_BAD_BLOCK}, a wrong block ID in block {CATCHUP_WRONG_ID}): index {got} "
          f"(ms={ms:.1f}, path={f.get('path')}, recovery_flushes={f.get('recovery_flushes')}, "
          f"launches={launches['catchup_128 tampered']}); block {CATCHUP_BAD_BLOCK} repaired: "
          f"index {got2} (ms={ms2:.1f}, path={f2.get('path')})", flush=True)


def memo_phase(dev, corpus, launches: dict, memo_default: int) -> None:
    """With the default memo: the 10k commit verified twice, the second
    answered from the memo (path "memo", 0 launches), and verify_batch over
    the same rows answered the same way, all True."""
    from tendermint_tpu_torch.crypto import batch

    vals, block_id, commit, msgs = corpus
    with memo_rows(memo_default):
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        first = batch.LAST_FLUSH.get("path")
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        second = dict(batch.LAST_FLUSH)
        mask = batch.verify_batch([v.pub_key.bytes() for v in vals.validators], msgs,
                                  [cs.signature for cs in commit.signatures], device=dev)
        third = batch.LAST_FLUSH.get("path")
        counts = read_launches("memo", kernels=())
        stats = batch.verified_memo_stats()
    if (second.get("path"), third, bool(mask.all()), mask.shape) != (
            "memo", "memo", True, (N_VALIDATORS,)) or any(counts[k] for k in ED25519_KERNELS):
        raise SystemExit(f"memo: {second}, {third}, all {mask.all()}, launches {counts}")
    launches["memo"] = counts
    print(f"memo (default {memo_default} rows): verify_commit 10k first path={first}, repeated "
          f"path=memo in {ms:.2f} ms with 0 launches; verify_batch of its rows path=memo, "
          f"all {N_VALIDATORS} True; memo {stats}", flush=True)


def build_poisoned(corpus):
    """poisoned_votes' batches, before the card is touched: the first
    POISON_ROWS corpus rows, and the same rows with round(POISON_ROWS x
    POISON_RATE) of them poisoned as bench.py bench_poisoned_flush poisons
    them (a real signature lifted from the next row, source peer:poisoner;
    the other rows peer:honest<i % 8>), with ed25519_ref's verdict on every
    row of both, on the fork pool."""
    vals, _, commit, msgs = corpus
    pks = [v.pub_key.bytes() for v in vals.validators[:POISON_ROWS]]
    msgs = list(msgs[:POISON_ROWS])
    sigs = [cs.signature for cs in commit.signatures[:POISON_ROWS]]
    rng = np.random.default_rng(POISON_SEED)
    k = int(round(POISON_ROWS * POISON_RATE))
    bad = {int(i) for i in rng.choice(POISON_ROWS, size=k, replace=False)}
    psigs = [sigs[(i + 1) % POISON_ROWS] if i in bad else sigs[i] for i in range(POISON_ROWS)]
    srcs = ["peer:poisoner" if i in bad else f"peer:honest{i % 8}" for i in range(POISON_ROWS)]
    workers = os.cpu_count() or 1
    with mp.get_context("fork").Pool(workers) as pool:
        want = [np.array(pool_map(pool, _verify_cofactored_rows, list(zip(pks, msgs, sg)),
                                  workers), dtype=bool) for sg in (sigs, psigs)]
        pool.close()
        pool.join()
    return dict(pks=pks, msgs=msgs, arms={"clean": (sigs, [f"peer:honest{i % 8}" for i in
                                                           range(POISON_ROWS)], want[0]),
                                          "1%": (psigs, srcs, want[1])}, bad=sorted(bad))


@contextlib.contextmanager
def installed_scheduler(dev):
    """A VerifyScheduler on the card installed as the process default inside
    the block; closed and uninstalled after it."""
    from tendermint_tpu_torch.crypto import scheduler

    sched = scheduler.VerifyScheduler(device=dev)
    scheduler.set_default(sched)
    try:
        yield sched
    finally:
        scheduler.set_default(None)
        sched.close()


def recorded_flushes(fn):
    """fn(), the (rows, route label) of every flush the recorder
    (libs/trace.py) took during it, in order, and their ms in all."""
    from tendermint_tpu_torch.libs import trace

    trace.tracer.clear()
    out = fn()
    events = [e["attrs"] for e in trace.tracer.dump() if e["name"] == "batch_verify.flush"]
    return out, [(e["n"], e["path"]) for e in events], sum(e["total_ms"] for e in events)


ALONE: dict = {}  # the scheduler paths' numbers alone, for scheduler_mixed


def scheduler_lanes_phase(dev, corpus, cu, lc, launches) -> None:
    """scheduler_lanes: one consumer at a time through its lane of a default
    scheduler on the card, each against its direct call on the same rows
    (the memo off): vote_storm_10k's 20 drains (VoteSet.flush -> the votes
    lane, rows tagged peer:<id>), catchup_128's three runs and
    super_batch_1k's run (verify_run_batched(scheduler=) -> the catch-up
    lane; super_batch_1k's 16,384 rows split at planner_chunk_rows() into
    two flushes), and light_trusting_4k's step under
    accumulate_flushes(sched.accumulate("light")) against a FlushAccumulator.
    Masks, failed indices and returned indices equal the direct call's; so
    do labels and launch counts, but super_batch_1k's. Printed: each lane's
    end-to-end ms, flush wall and queue wait against the direct call's
    end-to-end ms and flush wall (the recorder's), and the handoff: the
    lane's end-to-end ms less its queue wait, less the direct call's."""
    from fractions import Fraction

    from tendermint_tpu_torch.blocksync.verify import verify_run_batched
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.light import verifier

    vals, block_id, commit, _ = corpus
    votes = storm_votes(vals, block_id, commit)
    (_, direct, direct_ms), _, direct_flush_ms = recorded_flushes(
        lambda: run_storm(dev, vals, votes, peers=True))
    with installed_scheduler(dev) as sched:
        reset_launches()
        vs, lane, lane_ms = run_storm(dev, vals, votes, peers=True)
        launches["scheduler_lanes votes"] = read_launches("scheduler_lanes votes")
        walls = [f["wall_s"] * 1e3 for f in sched.flush_log]
        def route(flushes):  # rows, label, recovery flushes, failed, launches of each drain
            return [(f[0], *f[2:]) for f in flushes]

        if (route(lane) != route(direct)
                or vs.make_commit().encode() != commit.encode()
                or [set(f["rows"]) for f in sched.flush_log] != [{"votes"}] * len(lane)):
            raise SystemExit(f"scheduler_lanes votes: lane {route(lane)} vs direct "
                             f"{route(direct)}")
        ALONE["votes_per_s"] = N_VALIDATORS / lane_ms * 1e3
        print(f"scheduler_lanes votes ({len(lane)} drains of vote_storm_10k, VoteSet.flush on the "
              f"votes lane, inline): ms={lane_ms:.1f} ({ALONE['votes_per_s']:.0f} votes/s) "
              f"against direct ms={direct_ms:.1f}; flush wall {sum(walls):.1f} (direct "
              f"{direct_flush_ms:.1f}), queue wait 0; handoff {lane_ms - direct_ms:.1f} ms; "
              f"drain ms median {statistics.median(f[1] for f in lane):.1f} (direct "
              f"{statistics.median(f[1] for f in direct):.1f}); labels and per-drain launches "
              f"equal the direct "
              f"call's ({lane[0][2]} {lane[0][5]}, {lane[-1][2]} {lane[-1][5]}); make_commit "
              f"bytes equal the corpus commit's", flush=True)

        for name in CATCHUP:
            cvals, runs = cu[name]["vals"], cu[name]["runs"]
            direct_runs = []
            for run in runs:
                t0 = time.perf_counter()
                got, flushes, flush_ms = recorded_flushes(
                    lambda: verify_run_batched(cvals, CHAIN_ID, run, device=dev))
                torch.cuda.synchronize()
                direct_runs.append((got, (time.perf_counter() - t0) * 1e3, flushes, flush_ms))
            lane_runs = []
            for run in runs:
                mark = len(sched.flush_log)
                reset_launches()
                t0 = time.perf_counter()
                got, flushes, _ = recorded_flushes(
                    lambda: verify_run_batched(cvals, CHAIN_ID, run, scheduler=sched))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_launches(f"scheduler_lanes {name}")
                same_counts(launches, f"scheduler_lanes {name}", counts)
                lane_runs.append((got, ms, flushes, list(sched.flush_log)[mark:]))
            direct_labels = [f for _, _, f, _ in direct_runs]
            lane_labels = [f for _, _, f, _ in lane_runs]
            want_labels, want_counts = direct_labels, launches[name]
            if name == "super_batch_1k":  # split at planner_chunk_rows(): two pipelined flushes
                chunk = batch.planner_chunk_rows()
                n = sum(r for r, _ in direct_labels[0])
                want_labels = [[(chunk, "rlc-pipelined"), (n - chunk, "rlc-pipelined")]]
                want_counts = {k: 2 * v for k, v in launches["catchup_128"].items()}
            six = {k: launches[f"scheduler_lanes {name}"][k] for k in ED25519_KERNELS}
            if (any(g is not None for g, *_ in direct_runs + lane_runs)
                    or lane_labels != want_labels
                    or six != {k: want_counts[k] for k in ED25519_KERNELS}
                    or any([set(e["rows"]) for e in log] != [{"catchup"}] * len(log)
                           for *_, log in lane_runs)):
                raise SystemExit(f"scheduler_lanes {name}: lane {lane_labels} {six}, expected "
                                 f"{want_labels} {want_counts}")
            lane_ms = [ms for _, ms, _, _ in lane_runs]
            wall = [sum(e["wall_s"] for e in log) * 1e3 for *_, log in lane_runs]
            wait = [max(e["wait_s"]["catchup"] for e in log) * 1e3 for *_, log in lane_runs]
            direct_ms = [t for _, t, _, _ in direct_runs]
            handoff = statistics.median(t - w for t, w in zip(lane_ms, wait)) - statistics.median(
                direct_ms)
            ALONE[name] = len(runs) * CATCHUP[name][2] / sum(lane_ms) * 1e3
            print(f"scheduler_lanes {name} ({len(runs)} runs on the catch-up lane): run ms "
                  f"{[round(t, 1) for t in lane_ms]} ({ALONE[name]:.1f} blocks/s), flush wall "
                  f"{[round(t, 1) for t in wall]}, queue wait {[round(t, 1) for t in wait]} "
                  f"against direct ms {[round(t, 1) for t in direct_ms]}, flush wall "
                  f"{[round(f, 1) for *_, f in direct_runs]}; handoff {handoff:.1f} ms (median); "
                  f"flushes {lane_labels[0]} (direct {direct_labels[0]}); launches per run={six}",
                  flush=True)

        trusted, untrusted = lc["trusted"], lc["untrusted"]

        def step(acc):
            with captured_finishes() as seen:
                t0 = time.perf_counter()
                with batch.accumulate_flushes(acc):
                    verifier.verify_non_adjacent(
                        CHAIN_ID, trusted.signed_header, trusted.validator_set,
                        untrusted.signed_header, untrusted.validator_set, LIGHT_PERIOD,
                        LIGHT_NOW, LIGHT_DRIFT, Fraction(1, 3), device=dev)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            return ms, [(m.tobytes(), p) for m, p in seen]

        step(batch.FlushAccumulator(device=dev))  # warm
        reset_launches()
        (d_ms, d_seen), _, d_flush_ms = recorded_flushes(
            lambda: step(batch.FlushAccumulator(device=dev)))
        d_counts = read_launches("scheduler_lanes light direct")
        mark = len(sched.flush_log)
        reset_launches()
        l_ms, l_seen = step(sched.accumulate("light"))
        launches["scheduler_lanes light"] = read_launches("scheduler_lanes light")
        log = list(sched.flush_log)[mark:]
        if (l_seen != d_seen or [set(e["rows"]) for e in log] != [{"light"}]
                or {k: launches["scheduler_lanes light"][k] for k in ED25519_KERNELS}
                != {k: d_counts[k] for k in ED25519_KERNELS}):
            raise SystemExit(f"scheduler_lanes light: {[p for _, p in l_seen]} vs "
                             f"{[p for _, p in d_seen]}, log {log}")
        wait_ms = log[0]["wait_s"]["light"] * 1e3
        print(f"scheduler_lanes light (light_trusting_4k's step, both checks in one "
              f"{log[0]['rows']['light']}-row flush): ms={l_ms:.1f} (flush wall "
              f"{log[0]['wall_s'] * 1e3:.1f}, queue wait {wait_ms:.1f}) against a "
              f"FlushAccumulator's ms={d_ms:.1f} (flush wall {d_flush_ms:.1f}); handoff "
              f"{l_ms - wait_ms - d_ms:.1f} ms; labels {[p for _, p in l_seen]}; "
              f"launches={launches['scheduler_lanes light']}", flush=True)
        if sched.fallbacks:
            raise SystemExit(f"scheduler_lanes: {sched.fallbacks} inline fallbacks")


def zipf_requests(heights: int, n: int, seed: int) -> list:
    """bench.py bench_light_serve's draw: Zipf(1.1) over heights 2..heights."""
    import random

    rng = random.Random(seed)
    ranks = list(range(2, heights + 1))
    return rng.choices(ranks, [1.0 / (i + 1) ** 1.1 for i in range(len(ranks))], k=n)


def light_service(dev, chain, scheduler=None):
    from tendermint_tpu_torch.config import LightServiceConfig
    from tendermint_tpu_torch.light.provider import MockProvider
    from tendermint_tpu_torch.light.service import LightService

    cfg = LightServiceConfig(coalesce_window=SERVE_WINDOW, max_heights_per_flush=SKIP_HEIGHTS + 1,
                             max_pending=0, trust_period=LIGHT_PERIOD / NANOS)
    return LightService(CHAIN_ID, MockProvider(CHAIN_ID, chain), cfg, now_ns=lambda: LIGHT_NOW,
                        scheduler=scheduler, device=dev)


def serve(svc, chain, reqs, clients: int):
    """`clients` concurrent clients, each asking its share of `reqs` in turn:
    (wall s, latencies s, answers (height, source)); every answer must be
    the chain's header at that height."""
    import asyncio

    lats, answers = [], []

    async def client(mine):
        for h in mine:
            t1 = time.perf_counter()
            lb, source = await svc.verify_height(h)
            lats.append(time.perf_counter() - t1)
            if lb.hash() != chain[h].hash():
                raise SystemExit(f"light service answered height {h} with another header")
            answers.append((h, source))

    async def go():
        t1 = time.perf_counter()
        await asyncio.gather(*[client(reqs[i::clients]) for i in range(clients)])
        return time.perf_counter() - t1

    wall = asyncio.run(go())
    torch.cuda.synchronize()
    return wall, sorted(lats), answers


def pct_ms(vals, p: float) -> float:
    return vals[min(len(vals) - 1, int(p * len(vals)))] * 1e3


def light_serve_phase(dev, lc, launches) -> None:
    """light_serve_1k: a LightService on the card (its own scheduler, the
    light lane) over MockProvider on light_skipping's chain (16 heights x
    1,024 validators, the set rotating at 9: heights 9 and up take the
    bisection fallback), bench.py bench_light_serve's traffic; every answer
    the chain's header. Printed: client_verifs/s, p50/p99 latency, card
    flushes, lanes, cache hits, single-flight waits, bisections, the stage
    percentiles; then bench's serial arm (a fresh skipping Client per
    request from the anchor, sampled) and the speedup."""
    import asyncio

    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.light.client import Client, TrustOptions
    from tendermint_tpu_torch.light.provider import MockProvider
    from tendermint_tpu_torch.light.store import LightStore

    chain = lc["chain"]
    reqs = zipf_requests(SKIP_HEIGHTS, SERVE_REQUESTS, SERVE_SEED)
    svc = light_service(dev, chain)
    reset_launches()
    try:
        wall, lats, answers = serve(svc, chain, reqs, SERVE_CLIENTS)
        launches["light_serve_1k"] = read_launches("light_serve_1k")
        st = svc.stats()
        sched_st = svc.scheduler.stats()
    finally:
        svc.close()
    if sched_st["inline_fallbacks"] or len(answers) != len(reqs):
        raise SystemExit(f"light_serve_1k: {len(answers)} answers, {sched_st['inline_fallbacks']} "
                         f"fallbacks")
    ALONE["light_per_s"] = len(reqs) / wall
    print(f"light_serve_1k ({SERVE_CLIENTS} clients, {len(reqs)} Zipf(1.1) requests over heights "
          f"2-{SKIP_HEIGHTS} of {SKIP_N} validators, window {SERVE_WINDOW} s): "
          f"client_verifs_per_s={len(reqs) / wall:.1f} wall_s={wall:.3f} p50_ms="
          f"{pct_ms(lats, 0.5):.1f} p99_ms={pct_ms(lats, 0.99):.1f}; flushes={st['flushes']} "
          f"lanes_total={st['lanes_total']} cache_hits={st['cache_hits']} singleflight_waits="
          f"{st['singleflight_waits']} bisections={st['bisections']} outcomes={st['outcomes']} "
          f"windows={st['coalescer']['windows_fired']}; light-lane flushes "
          f"{sched_st['lanes']['light']['flushes']} of {sched_st['lanes']['light']['rows_total']} "
          f"rows; launches={launches['light_serve_1k']}", flush=True)
    print(f"light_serve_1k stages: {json.dumps(st['stage_percentiles'])}", flush=True)

    anchor = chain[1]
    sample, serial = reqs[:SERVE_SERIAL], []
    for h in sample:
        client = Client(CHAIN_ID, TrustOptions(LIGHT_PERIOD, 1, anchor.hash()),
                        MockProvider(CHAIN_ID, chain), [], LightStore(MemDB()), device=dev)

        async def go(client=client, h=h):
            await client.initialize(LIGHT_NOW)
            return await client.verify_light_block_at_height(h, LIGHT_NOW)

        t0 = time.perf_counter()
        lb = asyncio.run(go())
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
        if lb.hash() != chain[h].hash():
            raise SystemExit(f"light_serve_1k serial arm: height {h} verified another header")
    per_req = sum(serial) / len(serial)
    print(f"light_serve_1k serial arm (a fresh skipping Client per request from the anchor, "
          f"first {len(sample)} requests): per_request_ms={per_req * 1e3:.1f} "
          f"(heights < {SKIP_ROTATION}: one step; from {SKIP_ROTATION}: the bisection) against "
          f"coalesced per_request_ms={wall / len(reqs) * 1e3:.2f}: speedup "
          f"{per_req / (wall / len(reqs)):.1f}x", flush=True)


def scheduler_mixed_phase(dev, corpus, cu, lc, launches) -> None:
    """scheduler_mixed: one default scheduler on the card shared at once by
    vote_storm_10k storms on one thread (VoteSet.flush, the votes lane,
    inline), super_batch_1k catch-up runs looping on a second
    (verify_run_batched(scheduler=): the catch-up lane, two chunks a run),
    light_serve_1k's clients on the event loop (a fresh LightService on the
    shared scheduler's light lane), and vote rows queued through a votes-lane
    LaneAccumulator every second on a fourth (the queued form of the lane,
    which the between-chunk preemption point serves). Every mask, index and
    answer must equal its deterministic result; no vote flush may carry
    another lane's rows; at least one between-chunk preemption; no inline
    fallback; every Ed25519 kernel launched. Printed: votes/s and catch-up
    blocks/s alone (scheduler_lanes) against under load, light requests/s,
    the lanes' wait percentiles; then one short window of the three
    consumers under torch.profiler: device busy and idle share."""
    import threading

    from tendermint_tpu_torch.blocksync.verify import verify_run_batched
    from tendermint_tpu_torch.crypto import batch

    vals, block_id, commit, _ = corpus
    votes = storm_votes(vals, block_id, commit)
    sb_vals, sb_run = cu["super_batch_1k"]["vals"], cu["super_batch_1k"]["runs"][0]
    q_rows = ([v.pub_key.bytes() for v in vals.validators[:DRAIN]], list(corpus[3][:DRAIN]),
              [cs.signature for cs in commit.signatures[:DRAIN]])
    chain = lc["chain"]
    reqs = zipf_requests(SKIP_HEIGHTS, SERVE_REQUESTS, SERVE_SEED)
    drains = [DRAIN] * (N_VALIDATORS // DRAIN) + [N_VALIDATORS % DRAIN]

    def storm():
        vs, flushes, ms = run_storm(dev, vals, votes, peers=True)
        if ([f[0] for f in flushes] != drains or any(f[4] for f in flushes)
                or vs.make_commit().encode() != commit.encode()):
            raise SystemExit(f"scheduler_mixed: a storm gave {[f[:3] for f in flushes]}")
        return ms

    def catchup():
        t0 = time.perf_counter()
        got = verify_run_batched(sb_vals, CHAIN_ID, sb_run, scheduler=sched)
        torch.cuda.synchronize()
        if got is not None:
            raise SystemExit(f"scheduler_mixed: the super_batch_1k run failed at {got}")
        return (time.perf_counter() - t0) * 1e3

    def queued():
        acc = sched.accumulate("votes")
        acc.add(*q_rows, None)
        if not acc.flush().all():
            raise SystemExit("scheduler_mixed: queued vote rows refused")

    def worker(fn, out, stop, pause=0.0):
        try:
            while not stop.is_set():
                out.append(fn())
                if pause:
                    stop.wait(pause)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    errors = []
    with installed_scheduler(dev) as sched:
        between = [0]
        real_preempt = sched._preempt_votes_between_chunks

        def preempt():
            with sched._cv:
                queued_votes = bool(sched._lanes["votes"].queue)
            real_preempt()
            between[0] += queued_votes

        sched._preempt_votes_between_chunks = preempt
        stop = threading.Event()
        storms, runs, qs = [], [], []
        threads = [threading.Thread(target=worker, args=a) for a in
                   ((storm, storms, stop), (catchup, runs, stop), (queued, qs, stop, 1.0))]
        reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        svc = light_service(dev, chain, scheduler=sched)
        try:
            wall, lats, answers = serve(svc, chain, reqs, SERVE_CLIENTS)
        finally:
            svc.close()
        deadline = time.perf_counter() + 60  # the window stays open for one preemption
        while not between[0] and not errors and time.perf_counter() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join()
        window = time.perf_counter() - t0
        torch.cuda.synchronize()
        if errors:
            raise errors[0]
        launches["scheduler_mixed"] = read_launches("scheduler_mixed")
        log = list(sched.flush_log)
        mixed_votes = [f["rows"] for f in log if "votes" in f["rows"] and len(f["rows"]) > 1]
        st = sched.stats()
        # each catch-up flush's (queue wait s, flush wall s): a ticket's wait
        # is their sum, held to the scheduler's wait_timeout
        cu_flushes = [(round(f["wait_s"]["catchup"], 1), round(f["wall_s"], 1)) for f in log
                      if "catchup" in f["rows"]]
        if mixed_votes or not between[0] or sched.fallbacks or not storms or not runs:
            raise SystemExit(f"scheduler_mixed: vote flushes with other rows {mixed_votes}, "
                             f"between-chunk preemptions {between[0]}, fallbacks "
                             f"{sched.fallbacks}, storms {len(storms)}, runs {len(runs)}, "
                             f"catch-up flushes (wait s, wall s) {cu_flushes}")
        lanes = {lane: (v["flushes"], v["rows_total"]) for lane, v in st["lanes"].items()}
        votes_s = N_VALIDATORS * len(storms) / sum(storms) * 1e3
        blocks_s = CATCHUP["super_batch_1k"][0] * len(runs) / sum(runs) * 1e3
        print(f"scheduler_mixed (window {window:.1f} s): votes_per_s alone "
              f"{ALONE['votes_per_s']:.0f}, under load {votes_s:.0f} ({len(storms)} storms, ms "
              f"{[round(t, 1) for t in storms]}); super_batch_1k blocks_per_s alone "
              f"{ALONE['super_batch_1k']:.1f}, under load {blocks_s:.1f} ({len(runs)} runs, ms "
              f"{[round(t, 1) for t in runs]}); light requests/s alone {ALONE['light_per_s']:.1f}, "
              f"under load {len(reqs) / wall:.1f} (p50 {pct_ms(lats, 0.5):.1f} ms, p99 "
              f"{pct_ms(lats, 0.99):.1f} ms); queued vote flushes {len(qs)}; preemptions "
              f"{st['preemptions']} ({between[0]} between chunks); fallbacks 0; flushes by lane "
              f"(flushes, rows) {lanes}; launches={launches['scheduler_mixed']}", flush=True)
        print(f"scheduler_mixed lane waits: {json.dumps(st['lane_wait_percentiles'])}; catch-up "
              f"flushes (wait s, wall s) {cu_flushes}", flush=True)

        # one short window under the profiler: a catch-up run, two drains, 32
        # light requests of heights below the rotation on a fresh service
        few = [h for h in reqs if h < SKIP_ROTATION][:32]
        svc = light_service(dev, chain, scheduler=sched)

        def window_fn():
            side = [threading.Thread(target=catchup),
                    threading.Thread(target=run_storm, args=(dev, vals, votes[:2 * DRAIN]))]
            for t in side:
                t.start()
            serve(svc, chain, few, SERVE_CLIENTS)
            for t in side:
                t.join()

        try:
            profile_window("scheduler_mixed window", window_fn)
        finally:
            svc.close()


def profile_window(path: str, fn) -> None:
    """fn() under torch.profiler, device activity only: its wall, the device
    busy time (the kernel records of every thread), the idle share and the
    kernel count."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.libs.profiler import device_rows

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if busy_ms <= 0:
        print(f"profile {path}: the profiler recorded no device time (device busy: not measured)")
        return
    print(f"profile {path}: wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.2f} kernels="
          f"{sum(e.count for e in rows)} idle_share={1 - busy_ms / wall_ms:.3f}", flush=True)


def poisoned_votes_phase(dev, pz, launches) -> None:
    """poisoned_votes: the POISON_ROWS-row batch through the votes lane of a
    scheduler on the card, with sources, POISON_CALLS calls clean and
    POISONED_CALLS at 1% poison (a fresh suspicion scorer each arm): the
    first poisoned call's combined check fails and recovers on the card, the scorer quarantines
    peer:poisoner, and every later call partitions its rows onto the
    quarantine lane. Every mask equals ed25519_ref's verdicts. Printed per
    arm: the votes-lane flush wall p50/p99/max, quarantine flushes, recovery
    flushes and quarantined rows (the recorder's counters), labels."""
    from tendermint_tpu_torch.crypto import provenance, scheduler
    from tendermint_tpu_torch.libs import trace

    sched = scheduler.VerifyScheduler(device=dev)
    prev = provenance.set_default(provenance.SuspicionScorer())
    out = {}
    try:
        for arm, (sigs, srcs, want) in pz["arms"].items():
            provenance.default_scorer().reset()
            mark = len(sched.flush_log)
            c0 = trace.verify_stats()["counters"]
            path = f"poisoned_votes {arm}"
            reset_launches()
            t0 = time.perf_counter()

            def calls(n=POISON_CALLS if arm == "clean" else POISONED_CALLS):
                for _ in range(n):
                    mask = sched.verify_rows("votes", pz["pks"], pz["msgs"], sigs, None, srcs)
                    if mask.tobytes() != want.tobytes():
                        raise SystemExit(f"{path}: False at {np.flatnonzero(~mask).tolist()}, "
                                         f"ed25519_ref {np.flatnonzero(~want).tolist()}")

            _, flushes, _ = recorded_flushes(calls)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches[path] = read_launches(path)
            c1 = trace.verify_stats()["counters"]
            log = list(sched.flush_log)[mark:]
            walls = sorted(f["wall_s"] for f in log if "votes" in f["rows"])
            out[arm] = dict(
                ms=ms, p50=pct_ms(walls, 0.5), p99=pct_ms(walls, 0.99), max=walls[-1] * 1e3,
                vote_flushes=len(walls),
                quarantine_flushes=sum(1 for f in log if "quarantine" in f["rows"]),
                recovery=c1["recovery_flushes"] - c0["recovery_flushes"],
                quarantined_rows=c1["quarantined_rows"] - c0["quarantined_rows"],
                sources=provenance.default_scorer().stats()["quarantined"],
                labels=sorted({p for _, p in flushes}), first=flushes[:3])
        if (out["1%"]["sources"] != ["peer:poisoner"] or out["clean"]["sources"]
                or not out["1%"]["quarantine_flushes"] or sched.fallbacks):
            raise SystemExit(f"poisoned_votes: {out}")
    finally:
        provenance.set_default(prev)
        sched.close()
    for arm, o in out.items():
        print(f"poisoned_votes {arm} ({o['vote_flushes']} calls of {POISON_ROWS} rows"
              + (f", rows {pz['bad']} poisoned" if arm != "clean" else "") + f"): ms={o['ms']:.1f} "
              f"votes-lane flush wall p50_ms={o['p50']:.1f} p99_ms={o['p99']:.1f} "
              f"max_ms={o['max']:.1f} ({o['vote_flushes']} flushes); quarantine flushes "
              f"{o['quarantine_flushes']}, recovery flushes {o['recovery']}, quarantined rows "
              f"{o['quarantined_rows']}, quarantined sources {o['sources']}; labels {o['labels']}, "
              f"first flushes {o['first']}; launches={launches[f'poisoned_votes {arm}']}",
              flush=True)
    print(f"poisoned_votes: vote-lane p99 at 1% over clean "
          f"{out['1%']['p99'] / out['clean']['p99']:.2f}x; every mask equals ed25519_ref's",
          flush=True)


def build_bls_set():
    """10,000 BLS validators built as bench.py's _bls_bench_valset builds them
    (keys sk_i = sk0 + i, so pk_{i+1} = pk_i + G1), power 10 each, and three
    aggregate commits over one message: the full bitmap signed with
    (sum sk_i) H(m), the same bitmap with the wrong signature
    (sum sk_i + 1) H(m) (a valid G2 point), and the first 6,666 validators
    (<= 2/3 of the power) correctly signed."""
    from tendermint_tpu_torch.crypto import bls_ref as B
    from tendermint_tpu_torch.crypto import keys as K
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.block import AggregateCommit
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    t0 = time.perf_counter()
    sk0 = B.keygen(b"\x5a" * 32)
    sks, pubs, pt = [], [], B._jac_mul(B.G1_GEN, sk0)
    for i in range(N_VALIDATORS):
        sks.append((sk0 + i) % B.R)
        pubs.append(B.g1_to_bytes(pt))
        pt = B._jac_add(pt, B.G1_GEN)
    vals = ValidatorSet([Validator(K.Bls12381PubKey(pk), 10) for pk in pubs])
    # A proof-of-possession check is a pairing per key (hours for 10k keys in
    # Python); registration happens once per validator lifetime, so the
    # entries go straight into the registry, as ingestion would leave them.
    K._POP_VERIFIED.update(pubs)
    by_pk = dict(zip(pubs, sks))
    ordered = [by_pk[v.pub_key.bytes()] for v in vals.validators]
    bid = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
    full = range(N_VALIDATORS)
    msg = AggregateCommit(BLS_HEIGHT, 0, bid, BLS_TS, b"", b"").sign_bytes(CHAIN_ID)
    h = B.hash_to_g2(msg)

    def signed(signers, scalar):
        return AggregateCommit(BLS_HEIGHT, 0, bid, BLS_TS,
                               AggregateCommit.bitmap_of(signers, N_VALIDATORS),
                               B.g2_to_bytes(B._jac_mul(h, scalar % B.R)))

    total = sum(ordered)
    out = dict(vals=vals, bid=bid, good=signed(full, total), wrong=signed(full, total + 1),
               sub=signed(range(BLS_SUB_SIGNERS), sum(ordered[:BLS_SUB_SIGNERS])))
    print(f"bls corpus: {N_VALIDATORS} BLS validators and 3 aggregate signatures in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def bls_host_checks(stages: dict, want_ok: bool) -> float:
    """The card's pairing verdict against bls_ref.pairings_are_one on the
    same pairs (its Miller loops, then one final exponentiation), and both
    against the expected verdict. Returns the host Miller loops' ms: the
    host routing that the card's Miller loop replaces."""
    from tendermint_tpu_torch.crypto import bls_ref as B

    t0 = time.perf_counter()
    f = B.FP12_ONE
    for p, q in stages["pairs"]:
        f = f * B.miller_loop(q, p)
    host_miller_ms = (time.perf_counter() - t0) * 1e3
    if stages["pairing_ok"] is not want_ok or B.final_exponentiation(f).is_one() is not want_ok:
        raise SystemExit(f"pairing verdict: card {stages['pairing_ok']}, expected {want_ok}")
    return host_miller_ms


def bls_apk_check(vals, stages: dict) -> None:
    """The card's apk against the host Jacobian sum of the signers' cached
    affine keys, by compressed encoding (the signers are a prefix of the
    set on every path here)."""
    from tendermint_tpu_torch.crypto import bls_ref as B
    from tendermint_tpu_torch.types.validator_set import _bls_pubkey_coords

    acc = B.G1_IDENTITY
    for v in vals.validators[: stages["signers"]]:
        x, y = _bls_pubkey_coords(v.pub_key.bytes())
        acc = B._jac_add(acc, (B._G1Field(x), B._G1Field(y), B._G1Field(1)))
    apk = stages["apk"]
    if B.g1_to_bytes((B._G1Field(apk[0]), B._G1Field(apk[1]), B._G1Field(1))) != B.g1_to_bytes(acc):
        raise SystemExit("the card's aggregate pubkey differs from the host Jacobian sum")


STAGES = ("keys_s", "fold_s", "sig_decode_s", "hash_to_g2_s", "miller_s", "final_exp_s")


def bls_phase(dev, bls: dict, launches: dict) -> None:
    """The three BLS paths, each with its own launch counts."""
    from tendermint_tpu_torch.types import validator_set as VS

    vals, bid = bls["vals"], bls["bid"]

    def call(commit):
        vals.verify_aggregate_commit(CHAIN_ID, bid, BLS_HEIGHT, commit, device=dev)
        torch.cuda.synchronize()

    # Cold: the host decodes every key (sqrt and subgroup check) into the cache.
    VS._BLS_COORD_CACHE.clear()
    reset_launches()
    t0 = time.perf_counter()
    call(bls["good"])
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches["bls_cold"] = read_launches("bls_cold", BLS_KERNELS)
    cold = dict(VS.LAST_AGGREGATE)
    bls_host_checks(cold, True)
    bls_apk_check(vals, cold)
    print(f"bls_cold {N_VALIDATORS}: ms={cold_ms:.1f} (key decode and checks "
          f"{cold['keys_s'] * 1e3:.1f} ms) launches={launches['bls_cold']}", flush=True)

    warm, stages = [], []
    for _ in range(5):
        reset_launches()
        t0 = time.perf_counter()
        call(bls["good"])
        warm.append((time.perf_counter() - t0) * 1e3)
        same_counts(launches, "bls_warm", read_launches("bls_warm", BLS_KERNELS))
        stages.append(dict(VS.LAST_AGGREGATE))
    host_miller_ms = bls_host_checks(stages[-1], True)
    bls_apk_check(vals, stages[-1])
    split = " ".join(f"{k[:-2]}_ms={statistics.median(st[k] for st in stages) * 1e3:.1f}"
                     for k in STAGES)
    print(f"bls_warm {N_VALIDATORS}: median_ms={statistics.median(warm):.1f} "
          f"ms={[round(w, 1) for w in warm]} {split} "
          f"host_bls_ref_miller_ms={host_miller_ms:.1f} (the same pairs) "
          f"launches per call={launches['bls_warm']}", flush=True)
    print("bls apk equals the host Jacobian sum (compressed); card pairing verdicts equal "
          "bls_ref.pairings_are_one", flush=True)
    profile_path("bls_warm", lambda: call(bls["good"]), statistics.median(warm))

    # Rejected: the wrong signature, then a correctly signed bitmap at <= 2/3.
    reset_launches()
    t0 = time.perf_counter()
    try:
        call(bls["wrong"])
    except VS.CommitVerifyError as e:
        if "aggregate signature mismatch" not in str(e):
            raise
        print(f"bls wrong signature rejected: {e}", flush=True)
    else:
        raise SystemExit("a wrong aggregate signature was accepted")
    bls_host_checks(VS.LAST_AGGREGATE, False)
    try:
        call(bls["sub"])
    except VS.NotEnoughVotingPowerError as e:
        print(f"bls subthreshold bitmap rejected: {e}", flush=True)
    else:
        raise SystemExit("a subthreshold aggregate commit was accepted")
    rejected_ms = (time.perf_counter() - t0) * 1e3
    sub = dict(VS.LAST_AGGREGATE)
    launches["bls_rejected"] = read_launches("bls_rejected", BLS_KERNELS)
    bls_host_checks(sub, True)
    bls_apk_check(vals, sub)
    print(f"bls_rejected (2 calls): ms={rejected_ms:.1f} launches={launches['bls_rejected']}",
          flush=True)


# ---------------------------------------------------------------------------
# The general-base G1 MSM, the verify path's metrics and the profile report.

G1_REPS = 5  # timed g1_msm calls
G1_PREFIX = 512  # keys of the check against bls_ref's sums of scalar multiples
RECORDER_CALLS = 10_000  # record_flush calls timed for the recorder's own cost
PROFILE_TRIES = 3  # capture sessions until CUPTI keeps every launch's record


@contextlib.contextmanager
def recorded_products():
    """Inside the block every fp381_mul call of ops/bls12_torch notes its
    shape (products a lane, lanes) and keeps the arguments of the first
    call of each shape: yields {shape: (a, b)}."""
    from tendermint_tpu_torch.ops import bls12_torch

    real = bls12_torch.fp381_mul
    seen: dict = {}

    def call(a, b):
        key = (a.numel() // (33 * a.shape[-1]), a.shape[-1])
        if key not in seen:
            seen[key] = (a.clone(), b.clone())
        return real(a, b)

    bls12_torch.fp381_mul = call
    try:
        yield seen
    finally:
        bls12_torch.fp381_mul = real


def fp381_case_of(path, a, b, variant):
    """fp381_mul against its plain version on recorded arguments, routed as
    shipped."""
    from tendermint_tpu_torch.ops import cuda_bls

    products = a.numel() // 33
    return dict(name="fp381_mul", path=path, variant=variant, lanes=products,
                symbol=ENTRY_SYMBOL[cuda_bls.fp381_mul_entry(products)],
                kern=lambda: cuda_bls.fp381_mul(a, b), plain=lambda: cuda_bls.fp381_mul_plain(a, b),
                mads=FP381_MUL, items=products, bytes=3 * FP_BYTES * products)


def g1_stage(shape, n: int) -> str:
    """Which step of g1_msm gives fp381_mul this (products, lanes) shape."""
    k, lanes = shape
    if lanes == 8 * n:
        return f"segment sums: {k} x {lanes:,} rows (8 windows x {n:,} keys)"
    if lanes == 32 * 256:
        return f"window sums, doubling rounds: {k} x {lanes:,} (32 windows x 256 buckets)"
    if lanes == 1:
        return f"window combine: {k} x 1 lane (8 doublings and an add a window)"
    return f"window sums, halving round: {k} x {lanes:,}"


def g1_msm_phase(dev, bls: dict, card: dict, launches: dict) -> list:
    """g1_msm_10k: the general-base G1 MSM (ops/bls12_torch.g1_msm) over
    the 10,000 keys of the aggregate-commit set, scalars below r from the
    seed. All-ones scalars give the fold's aggregate key and the host
    Jacobian sum; the limb tail and the host tail agree on the same card
    buckets; a 512-key prefix equals bls_ref's sum of scalar multiples;
    g1_msm(P, s) + g1_msm(P, t) = g1_msm(P, s + t mod r). Then G1_REPS timed
    calls, each with its B7 launch count (the same on every call), one
    profiled, and a kernel row for every fp381_mul shape the path gives
    (returned)."""
    from tendermint_tpu_torch.crypto import bls_ref as B
    from tendermint_tpu_torch.ops import bls12_torch as G
    from tendermint_tpu_torch.types.validator_set import _bls_pubkey_entry

    entries = [_bls_pubkey_entry(v.pub_key.bytes()) for v in bls["vals"].validators]
    coords = [e[0] for e in entries]
    n = len(coords)
    rng = np.random.default_rng(SEED + 14)

    def scalars(m):
        return [int.from_bytes(rng.bytes(32), "little") % B.R for _ in range(m)]

    def jac(aff):
        return B.G1_IDENTITY if aff is None else (B._G1Field(aff[0]), B._G1Field(aff[1]),
                                                   B._G1Field(1))

    def affine(pt):
        a = B._jac_to_affine(pt)
        return None if a is None else (a[0].v, a[1].v)

    ones = G.g1_msm(coords, [1] * n, dev)
    fold = G.fold_points(np.stack([e[1] for e in entries], axis=-1), dev)
    acc = B.G1_IDENTITY
    for c in coords:
        acc = B._jac_add(acc, jac(c))
    if not ones == fold == affine(acc):
        raise SystemExit("g1_msm with all-ones scalars differs from the fold or the host sum")
    s, t = scalars(n), scalars(n)
    buckets = G.g1_buckets(coords, s, dev)
    limb = G.point_to_affine_int(G._combine_windows(G._weighted_window_sums(buckets)))
    if limb != G._host_tail(buckets):
        raise SystemExit("g1_msm: the limb tail and the host tail differ on the card's buckets")
    sp = scalars(G1_PREFIX)
    want = B.G1_IDENTITY
    for c, k in zip(coords, sp):
        want = B._jac_add(want, B._jac_mul(jac(c), k))
    if G.g1_msm(coords[:G1_PREFIX], sp, dev) != affine(want):
        raise SystemExit(f"g1_msm on {G1_PREFIX} keys differs from bls_ref's sum")
    gs, gt = G.g1_msm(coords, s, dev), G.g1_msm(coords, t, dev)
    gst = G.g1_msm(coords, [(a + b) % B.R for a, b in zip(s, t)], dev)
    if gs != limb or affine(B._jac_add(jac(gs), jac(gt))) != gst:
        raise SystemExit("g1_msm is not linear: P.s + P.t != P.(s + t)")
    print(f"g1_msm_10k checks: all-ones == fold == host sum; limb tail == host tail; "
          f"{G1_PREFIX}-key prefix == bls_ref; linear in the scalars", flush=True)
    times = []
    for _ in range(G1_REPS):
        sc = scalars(n)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        G.g1_msm(coords, sc, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        same_counts(launches, "g1_msm_10k", read_launches("g1_msm_10k", ("fp381_mul",)))
    med = statistics.median(times)
    print(f"g1_msm_10k {n}: median_ms={med:.1f} ms={[round(x, 1) for x in times]} "
          f"B7 launches per call={launches['g1_msm_10k']['fp381_mul']}", flush=True)
    profile_path("g1_msm_10k", lambda: G.g1_msm(coords, s, dev), med)
    with recorded_products() as seen:
        G.g1_msm(coords, s, dev)
    print(f"g1_msm_10k gives fp381_mul {len(seen)} shapes: {sorted(seen)}", flush=True)
    return check_cases([fp381_case_of("g1_msm_10k", a, b, g1_stage(key, n))
                        for key, (a, b) in sorted(seen.items(), key=lambda kv: -kv[0][1])], card)


def metrics_phase(dev, corpus, bls: dict, launches: dict) -> None:
    """The verify path's Prometheus series, read as exposition text before
    and after one warm 10k verify_commit (the default route), one 10k
    verify_aggregate_commit, and one votes-lane flush of DRAIN rows through
    an installed scheduler built with metrics= and slo= (the SLO engine
    also the flush feed's default): every delta must be exact. Then the
    device block of verify_stats() and the recorder's own cost, µs a
    record_flush over RECORDER_CALLS calls with the SLO engine registered."""
    from tendermint_tpu_torch import config
    from tendermint_tpu_torch.crypto import batch, scheduler
    from tendermint_tpu_torch.libs import metrics, slo, trace
    from tendermint_tpu_torch.types import validator_set as VS

    vals, block_id, commit, msgs = corpus
    ns = "tendermint_batch_verify_"

    def scrape(reg) -> dict:
        return {(name, tuple(sorted(labels.items()))): v
                for body in metrics.parse_exposition(reg.expose()).values()
                for name, labels, v in body["samples"]}

    def key(name, **labels):
        return (name, tuple(sorted(labels.items())))

    def expect(before, after, name, want, **labels):
        got = after.get(key(name, **labels), 0.0) - before.get(key(name, **labels), 0.0)
        if got != want:
            raise SystemExit(f"metrics: {name}{labels} moved by {got}, expected {want}")

    def flushes_moved(before, after):
        return sum(v - before.get(k, 0.0) for k, v in after.items()
                   if k[0] == ns + "flushes_total")

    g = metrics.global_registry()
    now = scrape(g)
    built = {kind: now.get(key(ns + "compile_seconds_total", kind=kind), 0.0)
             for kind in ("build", "load")}
    if not sum(built.values()) > 0:
        raise SystemExit(f"metrics: no kernel build or load seconds recorded: {built}")

    def commit_call():
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()

    commit_call()  # warm
    reset_launches()
    b = scrape(g)
    commit_call()
    launches["metrics_commit"] = read_launches("metrics_commit")
    a, last = scrape(g), trace.verify_stats()["last_flush"]
    backend, path = commit_route = last["backend"], last["path"]
    if path != batch.LAST_FLUSH["path"]:
        raise SystemExit(f"metrics: the recorder's path {path} != LAST_FLUSH's")
    expect(b, a, ns + "flushes_total", 1, backend=backend, path=path)
    expect(b, a, ns + "sigs_total", N_VALIDATORS, backend=backend, path=path)
    expect(b, a, ns + "backend_rows_total", N_VALIDATORS, backend="ed25519")
    expect(b, a, ns + "backend_flushes_total", 1, backend="ed25519")
    expect(b, a, ns + "batch_size_count", 1)
    expect(b, a, ns + "flush_seconds_count", 1, path=path)
    if flushes_moved(b, a) != 1 or a[key("tendermint_device_up")] != 1:
        raise SystemExit("metrics: the commit moved other flush series, or device_up is not 1")

    reset_launches()
    b = scrape(g)
    bls["vals"].verify_aggregate_commit(CHAIN_ID, bls["bid"], BLS_HEIGHT, bls["good"], device=dev)
    torch.cuda.synchronize()
    launches["metrics_bls"] = read_launches("metrics_bls", BLS_KERNELS)
    a, signers = scrape(g), VS.LAST_AGGREGATE["signers"]
    expect(b, a, ns + "backend_rows_total", signers, backend="bls12_381")
    expect(b, a, ns + "backend_flushes_total", 1, backend="bls12_381")
    if a[key(ns + "aggregate_size")] != signers or flushes_moved(b, a) != 0:
        raise SystemExit(f"metrics: aggregate_size {a[key(ns + 'aggregate_size')]} != {signers}, "
                         "or the aggregate commit moved a flush series")

    reg = metrics.Registry()
    engine = slo.SLOEngine(config.SLOConfig(), metrics=metrics.SLOMetrics(reg))
    sched = scheduler.VerifyScheduler(device=dev, metrics=metrics.SchedulerMetrics(reg), slo=engine)
    pks = [v.pub_key.bytes() for v in vals.validators[:DRAIN]]
    sigs = [cs.signature for cs in commit.signatures[:DRAIN]]
    scheduler.set_default(sched)
    slo.set_default(engine)
    try:
        sched.verify_rows("votes", pks, msgs[:DRAIN], sigs)  # warm
        reset_launches()
        b, bl = scrape(g), scrape(reg)
        mask = sched.verify_rows("votes", pks, msgs[:DRAIN], sigs)
        torch.cuda.synchronize()
        launches["metrics_votes"] = read_launches("metrics_votes")
        a, al, stats = scrape(g), scrape(reg), trace.verify_stats()
        backend, path = stats["last_flush"]["backend"], stats["last_flush"]["path"]
    finally:
        scheduler.set_default(None)
        slo.set_default(None)
        sched.close()
    if not mask.all():
        raise SystemExit("metrics: the votes-lane rows did not all verify")
    if stats["last_flush"].get("device_dispatches") != sum(launches["metrics_votes"].values()):
        raise SystemExit(f"metrics: the votes flush recorded {stats['last_flush'].get('device_dispatches')} "
                         f"dispatches, its launches were {launches['metrics_votes']}")
    expect(b, a, ns + "flushes_total", 1, backend=backend, path=path)
    expect(b, a, ns + "sigs_total", DRAIN, backend=backend, path=path)
    expect(b, a, ns + "backend_rows_total", DRAIN, backend="ed25519")
    lane = "tendermint_verify_lane_"
    expect(bl, al, lane + "wait_seconds_count", 1, lane="votes")
    expect(bl, al, lane + "wait_seconds_sum", 0, lane="votes")
    expect(bl, al, lane + "flush_rows_count", 1, lane="votes")
    expect(bl, al, lane + "flush_rows_sum", DRAIN, lane="votes")
    expect(bl, al, "tendermint_slo_observations_total", 1, slo="verify_lane_wait_votes",
           verdict="good")
    walls = sum(al.get(key("tendermint_slo_observations_total", slo="verify_flush_wall",
                           verdict=v), 0.0) - bl.get(key("tendermint_slo_observations_total",
                                                         slo="verify_flush_wall", verdict=v), 0.0)
                for v in ("good", "breach"))
    if walls != 1:
        raise SystemExit(f"metrics: verify_flush_wall took {walls} observations, expected 1")
    print(f"metrics: commit ({N_VALIDATORS} rows, {'/'.join(commit_route)}), aggregate "
          f"({signers} signers) and votes lane ({DRAIN} rows, {backend}/{path}): every "
          f"delta exact; compile_seconds build={built['build']:.2f} load={built['load']:.4f}; "
          f"launches commit={launches['metrics_commit']} votes={launches['metrics_votes']}",
          flush=True)
    print(f"metrics: verify_stats device={stats['device']} votes lane series: " + "; ".join(
        line for line in reg.expose().splitlines() if 'lane="votes"' in line
        and not line.startswith(lane + "wait_seconds_bucket")), flush=True)

    slo.set_default(engine)
    try:
        t0 = time.perf_counter()
        for _ in range(RECORDER_CALLS):
            trace.record_flush(backend="recorder", path="recorder-cost", n=DRAIN, total_s=0.01,
                               n_valid=DRAIN, prep_s=0.002, transfer_s=0.001, jit_bucket=1024,
                               padding_lanes=1024 - DRAIN - 1, cache_hits=DRAIN, cache_misses=0,
                               fused=True, h2d_bytes=1 << 16, device_dispatches=5_000, chunks=1,
                               chunk_lanes=2048, prep_overlap_s=0.0)
        us = (time.perf_counter() - t0) / RECORDER_CALLS * 1e6
    finally:
        slo.set_default(None)
    n_rec = scrape(g)[key(ns + "flushes_total", backend="recorder", path="recorder-cost")]
    if n_rec != RECORDER_CALLS:
        raise SystemExit(f"metrics: {n_rec} recorder flushes counted, expected {RECORDER_CALLS}")
    print(f"metrics: record_flush costs {us:.2f} us a call ({RECORDER_CALLS} calls, series, "
          f"SLO feed and stats; tracer off)", flush=True)


def profile_report_phase(dev, corpus, launches: dict) -> None:
    """profile_report: libs/profiler.trace_function around one warm 10k
    single flush (stream off), then tools/profile_report.report on its run
    directory. Every Ed25519 kernel launch the counters saw must be in the
    trace in a named stage (the point kernels by their record_function
    range), and uptree, fenwick_reduce and bucket_fold must each hold
    exactly one launch. Up to PROFILE_TRIES sessions, until CUPTI keeps
    every launch's record, and fails after that; a recorded kernel outside
    its stage, or a launched kernel with no record at all, fails at once. Prints the stage table and the share that fell to no stage."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.libs import profiler
    from tendermint_tpu_torch.tools import profile_report

    vals, block_id, commit, _ = corpus

    def call():
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)

    base = os.environ.get("TMTPU_PROFILE_DIR") or profiler.default_base_dir()
    stream = batch._stream_enabled()
    batch.configure_prep(stream=False)
    try:
        call()  # warm: the cached-A single flush
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_TRIES + 1):
            reset_launches()
            t0 = time.perf_counter()
            _, run_dir = profiler.trace_function(call, base_dir=base)
            capture_s = time.perf_counter() - t0
            same_counts(launches, "profile_warm", read_launches("profile_warm"))
            if batch.LAST_FLUSH.get("mode") != "cached":
                raise SystemExit(f"profile_report: not the cached single flush: {batch.LAST_FLUSH}")
            rep = profile_report.report(run_dir, top=1 << 30)
            found = {}
            for name in ED25519_KERNELS:
                ops = [o for o in rep["ops"] if any(sym in o["name"] for sym in KERNEL_SYMBOL[name])]
                found[name] = {o["stage"]: o["count"] for o in ops}
                wrong = set(found[name]) & {"other", "glue"}
                if wrong or sum(found[name].values()) > launches["profile_warm"][name]:
                    raise SystemExit(f"profile_report: {name} misattributed: {found[name]}")
                if launches["profile_warm"][name] and not found[name]:
                    raise SystemExit(f"profile_report: {name} launched "
                                     f"{launches['profile_warm'][name]} times, none in the trace")
            complete = all(sum(found[k].values()) == launches["profile_warm"][k]
                           for k in ED25519_KERNELS)
            print(f"profile_report try {attempt}: {run_dir} ({capture_s:.1f} s), kernels found "
                  f"by stage {found}, launched {launches['profile_warm']}", flush=True)
            if complete:
                break
        else:
            raise SystemExit(f"profile_report: kernel records missing in {PROFILE_TRIES} "
                             "sessions; not every launch is attributed")
        stages = {r["name"]: r["count"] for r in rep["stages"]}
        for name in ("uptree", "fenwick_reduce", "bucket_fold"):
            if stages.get(name) != 1:
                raise SystemExit(f"profile_report: stage {name} holds {stages.get(name)} launches")
        with open(os.path.join(run_dir, "report.json"), "w") as f:
            json.dump(rep, f)
        table = profile_report.render_markdown(dict(rep, ops=rep["ops"][:12]))
        print("\n".join(f"profile_report: {line}" for line in table.splitlines() if line),
              flush=True)
    finally:
        batch.configure_prep(stream=stream)



_COMB = None  # j * 16^i * B for i < 64, j < 16: _base_mul's table, built once a process


def _base_mul(s: int):
    """s * B for the Ed25519 base point (extended coordinates): one addition
    a 4-bit digit of s from a fixed-base table, 64 in all, in place of
    ed25519_ref.point_mul's ~380 doublings and additions."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    global _COMB
    if _COMB is None:
        rows, p = [], ref.BASE
        for _ in range(64):
            row = [ref.IDENTITY, p]
            for _ in range(14):
                row.append(ref.point_add(row[-1], p))
            rows.append(row)
            p = ref.point_add(row[-1], p)
        _COMB = rows
    q = ref.IDENTITY
    for i in range(64):
        nib = (s >> (4 * i)) & 15
        if nib:
            q = ref.point_add(q, _COMB[i][nib])
    return q


def _sign_votes(jobs):
    """(key type, seed, public key, message) -> signature: Ed25519 as
    ed25519_ref signs, sr25519 as crypto/sr25519.sr25519_sign does (its
    witness draws os.urandom), each nonce point by _base_mul. Runs on the
    consensus phase's signing pool."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519 as sr

    out = []
    for kind, seed, pk, msg in jobs:
        if kind == "sr25519":
            priv = sr.Sr25519PrivKey(seed)
            t = sr._sign_transcript(sr._context_transcript(msg), pk)
            wt = t.clone()
            wt.append_message(b"signing-nonce", priv._nonce + os.urandom(32))
            r = sr._scalar_from_wide(wt.challenge_bytes(b"witness", 64))
            r_bytes = sr.ristretto_encode(_base_mul(r))
            t.append_message(b"sign:R", r_bytes)
            k = sr._scalar_from_wide(t.challenge_bytes(b"sign:c", 64))
            s_bytes = bytearray(((k * priv._scalar + r) % ref.L).to_bytes(32, "little"))
            s_bytes[31] |= 0x80  # schnorrkel marker
            out.append(r_bytes + bytes(s_bytes))
        else:
            a, prefix = ref.secret_expand(seed)
            r = ref.sha512_mod_l(prefix + msg)
            r_enc = ref.point_compress(_base_mul(r))
            h = ref.sha512_mod_l(r_enc + pk + msg)
            out.append(r_enc + ((r + h * a) % ref.L).to_bytes(32, "little"))
    return out


def _host_masks(flushes):
    """Each flush's rows (pubkeys, messages, signatures, key types) on the
    port's host arm, verify_batch(backend="cpu") with the memo off: the
    masks. Runs on the consensus phase's signing pool."""
    from tendermint_tpu_torch.crypto import batch

    batch.configure_verified_memo(0)
    return [batch.verify_batch(pks, msgs, sigs, key_types=kts, backend="cpu").tolist()
            for pks, msgs, sigs, kts in flushes]


def consensus_10k_phase(dev, sr: dict, pool, workers: int, launches: dict,
                        memo_default: int) -> dict:
    """consensus_10k: the port's ConsensusState (consensus/cs_state.py) on
    BASELINE config 5's validator set, mixed_sr25519_10k's 10,000 keys, with
    deferred vote verification and `device` None (the reference's routing:
    the card from 256 rows), the verified-row memo on as a node runs it, the
    kvstore app over local ABCI, memory stores, a WAL in a temporary
    directory and CONSENSUS_TXS txs in the mempool. The node is one Ed25519
    validator with a FilePV. For each of STATESYNC_HEIGHTS heights: the
    proposal block from the node's executor (or the node's own, when it
    proposes) injected with its parts, every other validator's prevote and
    precommit signed on the signing pool (outside the timed window), then
    the votes injected in bursts of DRAIN, one asyncio.sleep(0) between
    bursts (one receive-loop drain each). At height CONSENSUS_HEIGHTS the
    first CONSENSUS_BAD precommits carry a bad signature. Prints each height's
    injection-to-commit time and launches, each deferred flush (rows, route,
    ms), the LastCommit checks (path "memo", 0 launches), height 2's device
    busy time and idle share, and holds every flush's mask to the host
    arm's, each committed LastCommit and the seen commits of heights
    CONSENSUS_HEIGHTS and STATESYNC_HEIGHTS to the host arm, and consensus to
    not having halted. Returns the genesis, the app hash and copies of the
    state and block stores' databases as they stood after CONSENSUS_HEIGHTS
    heights (for rpc_light_10k and p2p_sync_10k), and under "ext" the app
    hash and the stores after STATESYNC_HEIGHTS (for statesync_10k)."""
    import asyncio
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch import config
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus import cs_state
    from tendermint_tpu_torch.consensus.messages import (BlockPartMessage, ProposalMessage,
                                                         VoteMessage)
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.consensus.round_state import RoundStepType
    from tendermint_tpu_torch.consensus.wal import WAL
    from tendermint_tpu_torch.crypto import batch, keys, scheduler
    from tendermint_tpu_torch.evidence.pool import EvidencePool
    from tendermint_tpu_torch.libs import hotstats
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.libs.profiler import device_rows
    from tendermint_tpu_torch.mempool.mempool import Mempool
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.proxy.multi import AppConns, local_client_creator
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.sm_state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.types import canonical, vote_set
    from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.part_set import PartSet
    from tendermint_tpu_torch.types.proposal import Proposal
    from tendermint_tpu_torch.types.vote import Vote

    if scheduler.default_scheduler() is not None:
        raise SystemExit("consensus_10k: a default scheduler is still installed")
    t_phase = time.perf_counter()
    cs_dev = None if dev.type == "cuda" else dev
    seed_of = dict(zip(sr["pubkeys"], sr["seeds"]))
    type_of = dict(zip(sr["pubkeys"], sr["types"]))
    gen = GenesisDoc(chain_id=CHAIN_ID, validators=[
        GenesisValidator(keys.pubkey_from_type_and_bytes(t, pk), 10)
        for t, pk in zip(sr["types"], sr["pubkeys"])])
    gen.validate_and_complete()
    state = state_from_genesis(gen)
    vals = state.validators.validators
    own = next(i for i, v in enumerate(vals) if v.pub_key.type_name() == "ed25519")
    app = KVStoreApplication()
    proxy = AppConns(local_client_creator(app))
    state_store, block_store = StateStore(MemDB()), BlockStore(MemDB())
    state_store.save(state)
    mempool = Mempool(proxy.mempool)
    rng = np.random.default_rng(SEED + 15)
    for i in range(CONSENSUS_TXS):
        tx = (b"tx%06d=" % i + rng.bytes(CONSENSUS_TX_BYTES).hex().encode())[:CONSENSUS_TX_BYTES]
        if mempool.check_tx(tx).code != 0:
            raise SystemExit(f"consensus_10k: check_tx refused tx {i}")
    evpool = EvidencePool(MemDB(), state_store, block_store)
    evpool.set_state(state)
    ex = BlockExecutor(state_store, proxy.consensus, mempool, evpool, block_store=block_store,
                       device=cs_dev)
    state = Handshaker(state_store, state, block_store, gen, device=cs_dev).handshake(proxy)
    cfg = config.test_config().consensus
    cfg.defer_vote_verification = True
    cfg.vote_flush_interval = 0.05
    cfg.timeout_propose = CONSENSUS_PROPOSE_S
    wal_dir = tempfile.mkdtemp(prefix="consensus_10k-")
    cs = cs_state.ConsensusState(
        cfg, state, ex, block_store, mempool, evpool,
        WAL(os.path.join(wal_dir, "wal"), group_commit=cfg.wal_group_commit,
            group_commit_max_latency=cfg.wal_group_commit_max_latency),
        priv_validator=FilePV(keys.gen_ed25519(seed_of[vals[own].pub_key.bytes()])),
        device=cs_dev)
    setup_s = time.perf_counter() - t_phase

    cur = {"h": 0}
    flushes, checks, commit_at = [], [], {}
    real_vb, real_apply, real_validate = vote_set.verify_batch, ex.apply_block, ex.validate_block

    def recorded_verify_batch(pks, msgs, sigs, **kw):
        t0 = time.perf_counter()
        mask = real_vb(pks, msgs, sigs, **kw)
        f = batch.LAST_FLUSH
        flushes.append(dict(h=cur["h"], rows=len(pks), path=f.get("path"), mode=f.get("mode"),
                            ms=(time.perf_counter() - t0) * 1e3, mask=np.asarray(mask, bool),
                            args=(list(pks), list(msgs), list(sigs), list(kw["key_types"]))))
        return mask

    def apply_block(st, block_id, block, **kw):
        out = real_apply(st, block_id, block, **kw)
        commit_at.setdefault(block.header.height, time.perf_counter())
        return out

    def validate_block(st, block, **kw):
        n0 = sum(six_launches().values())
        real_validate(st, block, **kw)
        if block.header.height > 1:
            checks.append((block.header.height, batch.LAST_FLUSH.get("path"),
                           sum(six_launches().values()) - n0,
                           sum(not s.absent() for s in block.last_commit.signatures)))

    vote_set.verify_batch = recorded_verify_batch
    ex.apply_block, ex.validate_block = apply_block, validate_block
    batch.configure_verified_memo(memo_default)
    per_height, sign_s, planted = {}, [], set()
    busy, hot = {}, {}

    async def height(h: int) -> None:
        while not (cs.rs.height == h and cs.rs.step >= RoundStepType.PROPOSE):
            if cs.halt_error is not None:
                return
            await asyncio.sleep(0.002)
        rs = cs.rs
        proposer = rs.validators.get_proposer()
        if proposer.address == vals[own].address:  # the node proposes: read its block
            while rs.proposal_block is None:
                if cs.halt_error is not None:
                    return
                await asyncio.sleep(0.002)
            block, parts = rs.proposal_block, rs.proposal_block_parts
        else:
            commit = Commit(0, 0, BlockID(), ()) if h == 1 else rs.last_commit.make_commit()
            block = ex.create_proposal_block(h, cs.state, commit, proposer.address,
                                             time.time_ns())
            parts = PartSet.from_data(block.encode())
            prop = Proposal(h, 0, -1, BlockID(block.hash(), parts.header), time.time_ns())
            pk = proposer.pub_key.bytes()
            prop = prop.with_signature(_sign_votes(
                [(type_of[pk], seed_of[pk], pk, prop.sign_bytes(CHAIN_ID))])[0])
            await cs.add_peer_message(ProposalMessage(prop), "proposer")
            for i in range(parts.total):
                await cs.add_peer_message(BlockPartMessage(h, 0, parts.get_part(i)), "proposer")
        bid = BlockID(block.hash(), parts.header)
        t_sign = time.perf_counter()
        ts = max(time.time_ns(), cs.state.last_block_time_ns + 1_000_000)
        others = [i for i in range(len(vals)) if i != own]
        votes = []
        for t in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            msgs = canonical.vote_sign_bytes_many(CHAIN_ID, t, h, 0, [(bid, ts)] * len(others))
            jobs = [(type_of[vals[i].pub_key.bytes()], seed_of[vals[i].pub_key.bytes()],
                     vals[i].pub_key.bytes(), m) for i, m in zip(others, msgs)]
            sigs = await asyncio.get_running_loop().run_in_executor(
                None, pool_map, pool, _sign_votes, jobs, workers)
            for k, (i, m, sig) in enumerate(zip(others, msgs, sigs)):
                if h == CONSENSUS_HEIGHTS and t == SignedMsgType.PRECOMMIT and k < CONSENSUS_BAD:
                    sig = flip(sig)
                    planted.add((vals[i].pub_key.bytes(), sig))
                v = Vote(t, h, 0, bid, ts, vals[i].address, i, sig)
                v.seed_sign_bytes(CHAIN_ID, m)
                votes.append(v)
        sign_s.append(time.perf_counter() - t_sign)
        cur["h"] = h
        n_flush0 = len(flushes)
        prof = profile(activities=[ProfilerActivity.CUDA]) if h == 2 and dev.type == "cuda" else None
        if prof is not None:
            prof.__enter__()
        if h == 2:  # the host time around the flushes, split by stage
            hotstats.stats.reset()
            hotstats.stats.enabled = True
        reset_launches()
        t0 = time.perf_counter()
        for b in range(0, len(votes), DRAIN):
            for v in votes[b:b + DRAIN]:
                await cs.add_peer_message(VoteMessage(v), f"p{b // DRAIN % PEERS}")
            await asyncio.sleep(0)
            if cs.halt_error is not None:
                break
        while h not in commit_at and cs.halt_error is None:
            await asyncio.sleep(0.001)
        while cs.halt_error is None and (cs._queue.qsize() or (
                cs.rs.height == h and cs.rs.votes.has_pending()) or (
                cs.rs.last_commit is not None and cs.rs.last_commit.pending_count())):
            await asyncio.sleep(0.002)
        t_end = time.perf_counter()
        if h == 2:
            hotstats.stats.enabled = False
            hot.update(hotstats.stats.snapshot(), wall_s=t_end - t0)
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            rows = device_rows(prof)
            busy.update(us=sum(e.self_device_time_total for e in rows),
                        kernels=sum(e.count for e in rows), wall_s=t_end - t0)
        if cs.halt_error is not None:
            return
        per_height[h] = dict(commit_ms=(commit_at[h] - t0) * 1e3, window_ms=(t_end - t0) * 1e3,
                             flushes=flushes[n_flush0:], votes=len(votes),
                             launches=read_launches(f"consensus_10k h{h}"))
        launches[f"consensus_10k h{h}"] = per_height[h]["launches"]

    served = {}

    def stores_now() -> dict:
        out = {}
        for name, db in (("state", state_store.db), ("blockstore", block_store.db)):
            out[name] = MemDB()
            out[name].write_batch(list(db.iterate_prefix(b"")))
        return out

    async def drive() -> None:
        await cs.start()
        try:
            for h in range(1, STATESYNC_HEIGHTS + 1):
                await height(h)
                if cs.halt_error is not None:
                    break
                if h == CONSENSUS_HEIGHTS:  # the chain the next phases serve
                    served.update(app_hash=cs.state.app_hash, dbs=stores_now())
        finally:
            await cs.stop()

    try:
        asyncio.run(drive())
    finally:
        vote_set.verify_batch = real_vb
        ex.apply_block, ex.validate_block = real_apply, real_validate
        batch.configure_verified_memo(0)
        shutil.rmtree(wal_dir, ignore_errors=True)
    if cs.halt_error is not None:
        raise SystemExit(f"consensus_10k: consensus halted: {cs.halt_error!r}")
    run_s = time.perf_counter() - t_phase - setup_s - sum(sign_s)

    for h, ph in sorted(per_height.items()):
        fl = ph["flushes"]
        wide = [f for f in fl if f["rows"] >= DRAIN]
        rows = sum(f["rows"] for f in fl)
        print(f"consensus_10k h{h}: injection to commit {ph['commit_ms']:.1f} ms, all "
              f"{len(fl)} flushes done {ph['window_ms']:.1f} ms; {ph['votes']} votes injected, "
              f"{rows} rows verified ({rows / (sum(f['ms'] for f in fl) / 1e3):.0f} rows/s of "
              f"flush time, {ph['votes'] / (ph['window_ms'] / 1e3):.0f} votes/s of window); "
              f"flush median {statistics.median(f['ms'] for f in fl):.1f} ms over "
              f"{len(fl)}, at >= {DRAIN} rows {statistics.median(f['ms'] for f in wide):.1f} ms "
              f"over {len(wide)}; launches {ph['launches']}", flush=True)
        print(f"consensus_10k h{h} flushes (rows, route/mode, ms): " + ", ".join(
            f"({f['rows']}, {f['path']}/{f['mode']}, {f['ms']:.1f})" for f in fl), flush=True)
    all_fl = [f for ph in per_height.values() for f in ph["flushes"]]
    print(f"consensus_10k: {len(all_fl)} deferred flushes, median "
          f"{statistics.median(f['ms'] for f in all_fl):.1f} ms, "
          f"{sum(f['rows'] for f in all_fl) / (sum(f['ms'] for f in all_fl) / 1e3):.0f} "
          f"votes/s of flush time", flush=True)

    # every flush's mask against the host arm's on the same rows, the rows in
    # pieces of DRAIN so that the pool's workers share the large flushes
    t_host = time.perf_counter()
    pieces = [(k, lo) for k, f in enumerate(all_fl) for lo in range(0, f["rows"], DRAIN)]
    masks = pool_map(pool, _host_masks, [tuple(a[lo:lo + DRAIN] for a in all_fl[k]["args"])
                                           for k, lo in pieces], workers)
    host = [[] for _ in all_fl]
    for (k, _), m in zip(pieces, masks):
        host[k] += m
    bad = 0
    for f, want in zip(all_fl, host):
        if f["mask"].tolist() != want:
            raise SystemExit(f"consensus_10k: a {f['rows']}-row flush ({f['path']}) differs "
                             "from the host arm's mask")
        pks, _, sigs, _ = f["args"]
        for ok, pk, sig in zip(want, pks, sigs):
            if ok == ((pk, sig) in planted):
                raise SystemExit("consensus_10k: a verdict other than the planted rows' is False, "
                                 "or a planted row passed")
            bad += not ok
    if bad != CONSENSUS_BAD or sum((~f["mask"]).sum() for f in per_height[CONSENSUS_HEIGHTS]["flushes"]) != CONSENSUS_BAD:
        raise SystemExit(f"consensus_10k: {bad} rows rejected, expected the {CONSENSUS_BAD} planted")
    # the LastCommit checks of heights 2.. are answered from the memo
    want_checks = {h for h in range(2, STATESYNC_HEIGHTS + 1)}
    if {c[0] for c in checks} != want_checks or any(
            c[1] != "memo" or c[2] != 0 for c in checks):
        raise SystemExit(f"consensus_10k: LastCommit checks not all from the memo: {checks}")
    # each committed LastCommit, and the seen commits the two chains end on,
    # on the host arm
    commits = [(f"block {h}'s LastCommit", block_store.load_block(h).last_commit)
               for h in range(2, STATESYNC_HEIGHTS + 1)]
    commits += [(f"the seen commit of height {h}", block_store.load_seen_commit(h))
                for h in (CONSENSUS_HEIGHTS, STATESYNC_HEIGHTS)]
    jobs, owner = [], []
    for h, c in commits:
        idxs = [i for i, s in enumerate(c.signatures) if not s.absent()]
        rows = ([vals[i].pub_key.bytes() for i in idxs], c.vote_sign_bytes_many(CHAIN_ID, idxs),
                [c.signatures[i].signature for i in idxs], [vals[i].pub_key.type_name() for i in idxs])
        for lo in range(0, len(idxs), DRAIN):
            jobs.append(tuple(a[lo:lo + DRAIN] for a in rows))
            owner.append(h)
    for h, mask in zip(owner, pool_map(pool, _host_masks, jobs, workers)):
        if not all(mask):
            raise SystemExit(f"consensus_10k: {h} fails on the host arm")
    excluded = sum(1 for _, c in commits for i, s in enumerate(c.signatures)
                   if (vals[i].pub_key.bytes(), s.signature) in planted)
    if excluded:
        raise SystemExit(f"consensus_10k: the commits hold {excluded} planted rows")
    last = commits[-2][1]
    host_s = time.perf_counter() - t_host
    print(f"consensus_10k checks: {len(all_fl)} flush masks equal the host arm's "
          f"({sum(f['rows'] for f in all_fl)} rows, only the {CONSENSUS_BAD} planted rows False); "
          f"LastCommit checks (height, path, launches, rows) {checks}; the commits carried by "
          f"heights 2-{STATESYNC_HEIGHTS} and the seen commits of heights {CONSENSUS_HEIGHTS} "
          f"({sum(not s.absent() for s in last.signatures)} rows) and {STATESYNC_HEIGHTS} "
          f"verify on the host arm, none holding a planted row; app hash "
          f"{served['app_hash'].hex()} at height {CONSENSUS_HEIGHTS}, "
          f"{cs.state.app_hash.hex()} at {STATESYNC_HEIGHTS} ({app.size} txs); consensus did "
          f"not halt", flush=True)
    if hot:
        print(f"consensus_10k h2 hotstats (window {hot['wall_s'] * 1e3:.1f} ms; stages nest, "
              f"verify holds the flushes): " + ", ".join(
                  f"{st} {hot['seconds'][st] * 1e3:.1f} ms / {hot['counts'][st]}"
                  for st in ("encode", "verify", "pubsub", "wal")), flush=True)
    if busy:
        if busy["us"] > 0:
            print(f"consensus_10k h2 profile: device_busy_ms={busy['us'] / 1e3:.2f} "
                  f"kernels={busy['kernels']} idle_share={1 - busy['us'] / 1e6 / busy['wall_s']:.3f} "
                  f"(window {busy['wall_s'] * 1e3:.1f} ms, profiled)", flush=True)
        else:
            print("consensus_10k h2 profile: the profiler recorded no device time (device busy: "
                  "not measured)", flush=True)
    print(f"consensus_10k: {time.perf_counter() - t_phase:.1f} s (setup {setup_s:.1f}, signing "
          f"{sum(sign_s):.1f} = {[round(x, 1) for x in sign_s]}, consensus {run_s:.1f}, host "
          f"checks {host_s:.1f}); node validator {own} ({vals[own].pub_key.type_name()}), "
          f"proposers {[block_store.load_block(h).header.proposer_address == vals[own].address for h in range(1, STATESYNC_HEIGHTS + 1)]}",
          flush=True)
    return {"genesis": gen, "app_hash": served["app_hash"], "dbs": served["dbs"],
            "ext": {"app_hash": cs.state.app_hash,
                    "dbs": {"state": state_store.db, "blockstore": block_store.db}}}


def poisoned_commit_json(com: dict, power_of: dict, total: int) -> tuple:
    """The `commit` route's answer with bits 5 and 6 of byte 63 flipped in
    each of the first for-block signatures (s >= 2^253 > L, for Ed25519 and
    sr25519 alike), until the signatures left valid hold no more than 2/3 of
    `total`: (the answer, the flipped signatures)."""
    import base64
    import copy

    out = copy.deepcopy(com)
    sigs = out["signed_header"]["commit"]["signatures"]
    valid = sum(power_of[s["validator_address"]] for s in sigs if s["signature"])
    flipped = set()
    for s in sigs:
        if valid <= total * 2 // 3:
            break
        if s["signature"]:
            raw = bytearray(base64.b64decode(s["signature"]))
            raw[63] ^= 0x60
            raw = bytes(raw)
            s["signature"] = base64.b64encode(raw).decode()
            flipped.add(raw)
            valid -= power_of[s["validator_address"]]
    return out, flipped


def observatory_scrape(url: str) -> dict:
    """The observatory over RPC, in the calling worker thread (each call runs
    its own asyncio loop): the CLI `chain_observatory --nodes <url>` into a
    temporary directory (its exit code, the chain report it wrote, its
    seconds), then one scrape_node of the same node (the dump the CLI merged;
    the CLI keeps it in memory only)."""
    import asyncio
    import io
    import shutil
    import tempfile

    from tendermint_tpu_torch.tools import chain_observatory as obs

    out_dir = tempfile.mkdtemp(prefix="observatory_scrape-")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = obs.main(["--nodes", url, "--out", out_dir, "--heights", "0"])
        cli_s = time.perf_counter() - t0
        with open(os.path.join(out_dir, "chain_report.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    dump = asyncio.run(obs.scrape_node(url))
    return dict(rc=rc, report=report, cli_s=cli_s, dump=dump,
                scrape_s=time.perf_counter() - t0)


def rpc_light_10k_phase(dev, chain: dict, pool, workers: int, launches: dict) -> None:
    """rpc_light_10k: the port's Node (node/node.py) as a full node over
    consensus_10k's stores (3 heights of BASELINE config 5's set, 8,000
    Ed25519 + 2,000 sr25519 validators, copied key by key into SQLite files
    of a temporary root), the kvstore app replayed to height 3 by the
    Handshaker, `device` None, the verified-row memo off (each check
    flushes), its RPC server (rpc/server.py) on 127.0.0.1:0 with the light
    service on and Prometheus (libs/prometheus_server.py) on another free
    port; no p2p. Traffic, each part its own launch window: RPC_CLIENT_RUNS
    light clients (light/client.py, SKIPPING) on HTTPProvider trust height 1
    and verify height 3 (the initialize check, then the trusting and light
    checks of one skipping step); RPC_CLIENTS concurrent HTTP clients of
    light_verify / light_block; the light proxy's (light/proxy.py) verified
    commit and validators at RPC_PROXY_HEIGHT; /metrics from both listeners,
    /debug/light and /debug/verify_stats; a light client whose provider's
    HTTP client poisons the height-3 commit (poisoned_commit_json), which
    must be refused with an invalid-commit error. Prints each run's step
    (fetch and parse beside the checks), the service's latency p50/p99 cold
    (answered by a flush) and cached, requests/s, the flushes (rows, route,
    ms) of each window, the RPC metrics' per-method counts and the
    transport. Holds every recorded mask to the host arm's on the same rows,
    the clients' trusted heights and hashes to the node's block IDs, each
    service answer to LocalNodeProvider's light block, every route to no
    error, and the poisoned rows to False."""
    import asyncio
    import shutil
    import tempfile

    import aiohttp

    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.libs.metrics import parse_exposition
    from tendermint_tpu_torch.light.client import Client, TrustOptions
    from tendermint_tpu_torch.light.provider import HTTPProvider
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.light.service import LocalNodeProvider
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.light.verifier import ErrInvalidHeader
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.light import (commit_to_json, header_to_json,
                                                  validator_set_to_json)

    t_phase = time.perf_counter()
    node_dev = None if dev.type == "cuda" else dev
    root = tempfile.mkdtemp(prefix="rpc_light_10k-")
    copy_chain_stores(chain["dbs"], root)
    cfg = test_config()
    cfg.root_dir, cfg.base.db_backend, cfg.base.abci = root, "sqlite", "kvstore"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.light_service.enabled = True
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    cfg.instrumentation.forensics_dir = ""
    cfg.instrumentation.trace_ring_size = 1 << 16
    cfg.crypto.verified_memo_rows = 0
    node = Node(cfg, chain["genesis"], device=node_dev)
    if node.state.last_block_height != CONSENSUS_HEIGHTS or node.state.app_hash != chain["app_hash"]:
        raise SystemExit(f"rpc_light_10k: the node restarted at height "
                         f"{node.state.last_block_height}, app hash {node.state.app_hash.hex()}")
    setup_s = time.perf_counter() - t_phase
    vals = node.state_store.load_validators(1)
    power_of = {v.address.hex().upper(): v.voting_power for v in vals.validators}
    bids = {h: node.block_store.load_block_meta(h)[0].hash for h in range(1, CONSENSUS_HEIGHTS + 1)}

    # every mask the crypto API hands back during the phase, with its rows:
    # verify_batch (the scheduler's lane flushes), verify_batch_submit /
    # finish (the light client's checks, and the service's inside its lane)
    recorded, pending = [], {}
    real_vb, real_sub, real_fin = batch.verify_batch, batch.verify_batch_submit, batch.verify_batch_finish

    def rows_of(pks, msgs, sigs, key_types):
        return (list(pks), list(msgs), list(sigs),
                list(key_types) if key_types is not None else ["ed25519"] * len(pks))

    def vb(pks, msgs, sigs, device=None, key_types=None, backend=None, **kw):
        mask = real_vb(pks, msgs, sigs, device, key_types, backend, **kw)
        recorded.append((rows_of(pks, msgs, sigs, key_types), np.asarray(mask, bool)))
        return mask

    def sub(pks, msgs, sigs, device=None, key_types=None, backend=None):
        h = real_sub(pks, msgs, sigs, device, key_types, backend)
        pending[id(h)] = rows_of(pks, msgs, sigs, key_types)
        return h

    def fin(h):
        mask = real_fin(h)
        recorded.append((pending.pop(id(h)), np.asarray(mask, bool)))
        return mask

    windows, steps, lats, answers = {}, [], [], []
    metrics_seen = {}

    def window(name: str, per_run: bool = False) -> None:
        """The launches and the recorder's flushes since the last reset."""
        events = [e["attrs"] for e in trace.tracer.dump() if e["name"] == "batch_verify.flush"]
        fl = [(e["n"], e["path"], e["total_ms"]) for e in events]
        counts = read_launches(f"rpc_light_10k {name}")
        if per_run:
            same_counts(launches, f"rpc_light_10k {name}", counts)
            windows.setdefault(name, []).append(fl)
        else:
            launches[f"rpc_light_10k {name}"] = counts
            windows[name] = [fl]
        trace.tracer.clear()
        reset_launches()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    class TimedProvider(HTTPProvider):
        """HTTPProvider timing each fetch and JSON parse."""

        def __init__(self, client):
            super().__init__(CHAIN_ID, client)
            self.fetch_s = 0.0

        async def light_block(self, height):
            t0 = time.perf_counter()
            try:
                return await super().light_block(height)
            finally:
                self.fetch_s += time.perf_counter() - t0

    class PoisonedClient(HTTPClient):
        """An HTTP client whose height-3 commit comes back poisoned."""

        flipped: set = set()

        async def commit(self, height=None):
            com = await super().commit(height)
            if height == CONSENSUS_HEIGHTS:
                com, PoisonedClient.flipped = poisoned_commit_json(
                    com, power_of, vals.total_voting_power())
            return com

    def cli_light_call(url: str, home: str) -> tuple:
        """The port's command line `light` (cli/main.py) in this worker
        thread, as a user runs it: its exit code, stdout and seconds, and the
        seconds HTTPProvider spent fetching and parsing light blocks."""
        import io

        from tendermint_tpu_torch.cli.main import main as cli_main
        from tendermint_tpu_torch.light import provider as lprov

        fetch = [0.0]
        real_lb = lprov.HTTPProvider.light_block

        async def timed_lb(self, height):
            t0 = time.perf_counter()
            try:
                return await real_lb(self, height)
            finally:
                fetch[0] += time.perf_counter() - t0

        lprov.HTTPProvider.light_block = timed_lb
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli_main(["--home", home, "--device", "cuda", "light", CHAIN_ID,
                               "--primary", url, "--trust-height", "1",
                               "--trust-hash", bids[1].hex().upper(),
                               "--height", str(CONSENSUS_HEIGHTS)])
        finally:
            lprov.HTTPProvider.light_block = real_lb
        return rc, out.getvalue(), time.perf_counter() - t0, fetch[0]

    async def run_client(client, fresh_store=True):
        provider = TimedProvider(client)
        lc = Client(CHAIN_ID, TrustOptions(LIGHT_PERIOD, 1, bids[1]), provider, [],
                    LightStore(MemDB()), device=node_dev)
        t0 = time.perf_counter()
        await lc.initialize()
        t_init = time.perf_counter()
        lb = await lc.verify_light_block_at_height(CONSENSUS_HEIGHTS)
        sync()
        return lc, lb, dict(init_s=t_init - t0, step_s=time.perf_counter() - t_init,
                            fetch_s=provider.fetch_s)

    async def drive() -> dict:
        loop = asyncio.get_running_loop()
        await node.start()
        clients = []
        proxy = None
        try:
            t0 = time.perf_counter()
            if node._prewarm_thread is not None:
                await loop.run_in_executor(None, node._prewarm_thread.join)
            node._raise_stored()
            prewarm_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{node.rpc_server.port}"
            lnp = LocalNodeProvider(node)
            want = {}
            for h in range(1, CONSENSUS_HEIGHTS + 1):
                lb = await lnp.light_block(h)
                want[h] = ({"header": header_to_json(lb.header),
                            "commit": commit_to_json(lb.signed_header.commit)},
                           validator_set_to_json(lb.validator_set))
            trace.tracer.clear()
            reset_launches()

            # light clients over HTTP: trust 1, verify 3
            for _ in range(RPC_CLIENT_RUNS):
                c = HTTPClient(url)
                clients.append(c)
                lc, lb, st = await run_client(c)
                if lb.hash() != bids[CONSENSUS_HEIGHTS] or {
                        h: lc.store.light_block(h).hash() for h in lc.store.heights()} != {
                        1: bids[1], CONSENSUS_HEIGHTS: bids[CONSENSUS_HEIGHTS]}:
                    raise SystemExit(f"rpc_light_10k client: trusted {lc.store.heights()} differ "
                                     "from the node's block IDs")
                steps.append(st)
                window("client", per_run=True)

            # the light service: RPC_CLIENTS concurrent HTTP clients
            svc_clients = [HTTPClient(url) for _ in range(RPC_CLIENTS)]
            clients += svc_clients

            async def one(k, c):
                for j in range(RPC_REQUESTS):
                    h = 1 + (k + j) % CONSENSUS_HEIGHTS
                    method = "light_verify" if j % 2 == 0 else "light_block"
                    t1 = time.perf_counter()
                    res = await c.call(method, height=h)
                    lats.append((res["source"], time.perf_counter() - t1))
                    answers.append((h, method, res))

            t1 = time.perf_counter()
            await asyncio.gather(*[one(k, c) for k, c in enumerate(svc_clients)])
            sync()
            serve_s = time.perf_counter() - t1
            window("service")

            # the light proxy in front of the node
            backend = HTTPClient(url)
            clients.append(backend)
            plc = Client(CHAIN_ID, TrustOptions(LIGHT_PERIOD, 1, bids[1]),
                         HTTPProvider(CHAIN_ID, HTTPClient(url)), [], LightStore(MemDB()),
                         device=node_dev)
            clients.append(plc.primary.client)
            proxy = LightProxy(plc, backend)
            await proxy.start()
            proxied = {}
            async with aiohttp.ClientSession() as sess:
                for method in ("commit", "validators"):
                    async with sess.post(f"http://{proxy.addr}/", json={
                            "jsonrpc": "2.0", "id": 1, "method": method,
                            "params": {"height": RPC_PROXY_HEIGHT}}) as resp:
                        body = await resp.json()
                    if "error" in body or not body["result"].get("light_client_verified"):
                        raise SystemExit(f"rpc_light_10k proxy {method}: {str(body)[:300]}")
                    proxied[method] = body["result"]
                sync()
                window("proxy")

                # the metrics of both listeners and the debug pages
                pm = f"http://127.0.0.1:{node.prometheus_server.port}/metrics"
                for name, u in (("rpc", url + "/metrics"), ("prometheus", pm),
                                ("debug_light", url + "/debug/light"),
                                ("verify_stats", url + "/debug/verify_stats"),
                                ("debug_rpc", url + "/debug/rpc")):
                    async with sess.get(u) as resp:
                        if resp.status != 200:
                            raise SystemExit(f"rpc_light_10k: GET {u} answered {resp.status}")
                        metrics_seen[name] = (await resp.text() if name in ("rpc", "prometheus")
                                              else (await resp.json())["result"])

            # the poisoned commit
            pc = PoisonedClient(url)
            clients.append(pc)
            try:
                await run_client(pc)
                raise SystemExit("rpc_light_10k poisoned: the light client accepted the "
                                 "poisoned height-3 commit")
            except ErrInvalidHeader as e:
                refused = str(e)
            sync()
            window("poisoned")
            if "invalid commit" not in refused:
                raise SystemExit(f"rpc_light_10k poisoned: refused with {refused!r}")

            # cli_light_10k: the command line's light client, its own window
            home = tempfile.mkdtemp(prefix="cli_light_10k-")
            try:
                rc, text, cli_s, cli_fetch = await loop.run_in_executor(
                    None, cli_light_call, url, home)
                sync()
                cli_fl = [(e["attrs"]["n"], e["attrs"]["path"], e["attrs"]["total_ms"])
                          for e in trace.tracer.dump() if e["name"] == "batch_verify.flush"]
                launches["cli_light_10k"] = read_launches("cli_light_10k")
                trace.tracer.clear()
                reset_launches()
            finally:
                shutil.rmtree(home, ignore_errors=True)
            res = json.loads(text.strip().splitlines()[-1]) if rc == 0 and text.strip() else {}
            want_cli = {"height": CONSENSUS_HEIGHTS,
                        "hash": bids[CONSENSUS_HEIGHTS].hex().upper(),
                        "app_hash": node.block_store.load_block(
                            CONSENSUS_HEIGHTS).header.app_hash.hex().upper()}
            if rc != 0 or {k: res.get(k) for k in want_cli} != want_cli:
                raise SystemExit(f"cli_light_10k: exit {rc}, printed {text[-400:]!r}, want "
                                 f"{want_cli}")
            if not cli_fl or any(path == "cpu" for _, path, _ in cli_fl):
                raise SystemExit(f"cli_light_10k: a flush took the host arm or none ran: {cli_fl}")
            cli = dict(s=cli_s, fetch_s=cli_fetch, flushes=cli_fl, res=res)

            # the observatory's RPC scrape of this node, then /debug/mesh
            scrape = await loop.run_in_executor(None, observatory_scrape, url)
            async with aiohttp.ClientSession() as sess:
                async with sess.get(url + "/debug/mesh") as resp:
                    scrape["debug_mesh"] = (await resp.json())["result"]
            return dict(prewarm_s=prewarm_s, serve_s=serve_s, want=want, proxied=proxied,
                        refused=refused, svc=node.light_service.stats(), cli=cli,
                        scrape=scrape, url=url)
        finally:
            if proxy is not None:
                await proxy.stop()
            for c in clients:
                await c.close()
            await node.stop()

    batch.verify_batch, batch.verify_batch_submit, batch.verify_batch_finish = vb, sub, fin
    try:
        out = asyncio.run(drive())
    finally:
        batch.verify_batch, batch.verify_batch_submit, batch.verify_batch_finish = \
            real_vb, real_sub, real_fin
        shutil.rmtree(root, ignore_errors=True)
    run_s = time.perf_counter() - t_phase - setup_s

    # every answer of the service is the node's own light block
    for h, method, res in answers:
        sh_json, vs_json = out["want"][h]
        if (res["hash"] != bids[h].hex().upper() or res["signed_header"] != sh_json
                or not res["light_client_verified"]
                or (method == "light_block" and res["validator_set"] != vs_json)):
            raise SystemExit(f"rpc_light_10k service: the {method} answer at height {h} is "
                             "not LocalNodeProvider's light block")
    com = out["proxied"]["commit"]["signed_header"]
    if com != out["want"][RPC_PROXY_HEIGHT][0] or out["proxied"]["validators"]["validators"] != \
            out["want"][RPC_PROXY_HEIGHT][1]["validators"]:
        raise SystemExit("rpc_light_10k proxy: the verified answers are not the node's")
    # no route answered an error; nothing was shed or refused
    bad = {m: a for m, a in metrics_seen["debug_rpc"]["methods"].items()
           if a["error"] or a["shed"] or a["reject"]}
    if bad:
        raise SystemExit(f"rpc_light_10k: routes answered errors: {bad}")

    # every recorded mask against the host arm's: each distinct row verified
    # once on the pool, in pieces of DRAIN
    t_host = time.perf_counter()
    index = {}
    for args, _ in recorded:
        for row in zip(*args):
            index.setdefault(row, len(index))
    order = list(index)
    masks = pool_map(pool, _host_masks, [tuple(map(list, zip(*order[lo:lo + DRAIN])))
                                           for lo in range(0, len(order), DRAIN)], workers)
    verdict = dict(zip(order, (ok for m in masks for ok in m)))
    for args, mask in recorded:
        if mask.tolist() != [verdict[row] for row in zip(*args)]:
            raise SystemExit(f"rpc_light_10k: a {len(mask)}-row mask differs from the host "
                             "arm's")
    if any(ok == (row[2] in PoisonedClient.flipped) for row, ok in verdict.items()):
        raise SystemExit("rpc_light_10k: a verdict other than the poisoned rows' is False, or "
                         "a poisoned row passed")
    n_false = sum(not ok for ok in verdict.values())
    host_s = time.perf_counter() - t_host

    # the observatory's scrape: the CLI merged this one node, and the dump's
    # mesh block is /debug/mesh's answer
    sc = out["scrape"]
    rep, dump = sc["report"], sc["dump"]
    errors = {k: v["error"] for k, v in dump.items() if isinstance(v, dict) and "error" in v}
    if sc["rc"] != 0 or rep["coverage"] != {"expected": 1, "merged": 1, "missing": [],
                                            "partial": False}:
        raise SystemExit(f"observatory_scrape_10k: exit {sc['rc']}, coverage {rep['coverage']}")
    if errors or dump.get("scrape_error"):
        raise SystemExit(f"observatory_scrape_10k: the scrape failed: {errors} "
                         f"{dump.get('scrape_error')}")
    if dump["mesh"] != sc["debug_mesh"]:
        raise SystemExit(f"observatory_scrape_10k: the scraped mesh block {dump['mesh']} is not "
                         f"/debug/mesh's {sc['debug_mesh']}")

    card_line = card_name(dev)
    for k, st in enumerate(steps):
        print(f"rpc_light_10k client run {k}: initialize {st['init_s'] * 1e3:.1f} ms, step "
              f"1 -> {CONSENSUS_HEIGHTS} {st['step_s'] * 1e3:.1f} ms; fetch and JSON parse of "
              f"the commits and the sets {st['fetch_s'] * 1e3:.1f} ms of both, the checks "
              f"{(st['init_s'] + st['step_s'] - st['fetch_s']) * 1e3:.1f} ms; flushes (rows, "
              f"route, ms) {windows['client'][k]}", flush=True)
    cold = sorted(t for s, t in lats if s != "cache")
    cached = sorted(t for s, t in lats if s == "cache")
    svc = out["svc"]
    print(f"rpc_light_10k service ({RPC_CLIENTS} HTTP clients x {RPC_REQUESTS} requests, "
          f"light_verify and light_block in turn over heights 1-{CONSENSUS_HEIGHTS}): "
          f"requests_per_s={len(lats) / out['serve_s']:.1f} wall_s={out['serve_s']:.3f}; cold "
          f"(a flush) n={len(cold)} p50_ms={pct_ms(cold, 0.5) if cold else 0:.1f} "
          f"p99_ms={pct_ms(cold, 0.99) if cold else 0:.1f}; cached n={len(cached)} "
          f"p50_ms={pct_ms(cached, 0.5):.1f} p99_ms={pct_ms(cached, 0.99):.1f}; flushes "
          f"{windows['service'][0]}; cache_hits={svc['cache_hits']} singleflight_waits="
          f"{svc['singleflight_waits']} outcomes={svc['outcomes']}", flush=True)
    print(f"rpc_light_10k proxy: verified commit and validators at height {RPC_PROXY_HEIGHT}; "
          f"flushes {windows['proxy'][0]}", flush=True)
    print(f"rpc_light_10k poisoned: {len(PoisonedClient.flipped)} signatures flipped, refused "
          f"({out['refused'][:120]}); flushes {windows['poisoned'][0]}", flush=True)
    fams = parse_exposition(metrics_seen["rpc"])
    per_method = {lab["method"]: int(v) for name, lab, v in
                  fams["tendermint_rpc_requests_total"]["samples"] if lab["outcome"] == "ok"}
    prom = parse_exposition(metrics_seen["prometheus"])
    print(f"rpc_light_10k metrics: RPC requests by method (ok) {per_method}; /metrics "
          f"{len(fams)} families on the RPC listener, {len(prom)} on the Prometheus listener; "
          f"/debug/light requests={metrics_seen['debug_light']['requests']}; "
          f"/debug/verify_stats light requests="
          f"{metrics_seen['verify_stats']['light']['requests']}", flush=True)
    cli = out["cli"]
    cli_flush_ms = sum(ms for _, _, ms in cli["flushes"])
    print(f"cli_light_10k: `cli --device cuda light {CHAIN_ID} --trust-height 1 --height "
          f"{CONSENSUS_HEIGHTS}` {cli['s']:.3f} s of command: fetch and JSON parse of the "
          f"light blocks {cli['fetch_s'] * 1e3:.1f} ms, flushes {cli_flush_ms:.1f} ms, the rest "
          f"{cli['s'] * 1e3 - cli['fetch_s'] * 1e3 - cli_flush_ms:.1f} ms; flushes (rows, route, "
          f"ms) {cli['flushes']}; printed height {cli['res']['height']} hash "
          f"{cli['res']['hash'][:16]}... app_hash {cli['res']['app_hash'][:16]}... = the node's "
          f"block {CONSENSUS_HEIGHTS}; trusted {cli['res']['trusted_heights']}; launches "
          f"{launches['cli_light_10k']}", flush=True)
    print(f"observatory_scrape_10k: `chain_observatory --nodes {out['url']}` exit "
          f"{sc['rc']} in {sc['cli_s']:.3f} s, its report merging 1 node over "
          f"{rep['nodes'][0]['heights']} heights (range {rep['nodes'][0]['height_range']}, SLO "
          f"{'tripped' if rep['slo_any_tripped'] else 'held'}); a scrape_node of the same "
          f"node {sc['scrape_s'] * 1e3:.1f} ms, its sections "
          f"{sorted(k for k, v in dump.items() if isinstance(v, dict))}; its mesh block equals "
          f"/debug/mesh's (mesh {dump['mesh']['mesh']}, ladder {dump['mesh']['ladder']}, "
          f"health devices {dump['mesh']['health']['devices']})", flush=True)
    print(f"rpc_light_10k launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if k.startswith("rpc_light_10k")), flush=True)
    print(f"rpc_light_10k checks: {len(recorded)} masks over {len(order)} distinct rows "
          f"equal the host arm's ({n_false} rows False, all of them poisoned); the clients "
          f"trust heights 1 and {CONSENSUS_HEIGHTS} at the node's block IDs; "
          f"{len(answers)} service answers are LocalNodeProvider's light blocks; no route "
          f"answered an error", flush=True)
    print(f"rpc_light_10k: {time.perf_counter() - t_phase:.1f} s (setup {setup_s:.1f}, prewarm "
          f"{out['prewarm_s']:.1f}, traffic {run_s - out['prewarm_s']:.1f}, host checks "
          f"{host_s:.1f}); transport aiohttp {aiohttp.__version__}; card {card_line}", flush=True)


def copy_chain_stores(dbs: dict, root: str) -> None:
    """A chain's state and block stores (consensus_10k's MemDBs) as the
    SQLite files a Node with `root_dir` root opens."""
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB

    os.makedirs(os.path.join(root, "data"))
    for name, db in dbs.items():
        out = SQLiteDB(os.path.join(root, "data", f"{name}.db"))
        out.write_batch(list(db.iterate_prefix(b"")))
        out.close()


def p2p_node_config(phase: str, root: str, roots: list):
    """A port Node's config in the p2p phases: SQLite stores under `root`
    (memory stores and a temporary WAL, added to `roots`, when it is
    empty), p2p on a free loopback port, PEX, RPC and forensics off, the
    verified-row memo off, deferred vote verification."""
    import tempfile

    from tendermint_tpu_torch.config import test_config

    cfg = test_config()
    cfg.root_dir = root
    cfg.base.db_backend = "sqlite" if root else "memdb"
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.instrumentation.forensics_dir = ""
    cfg.crypto.verified_memo_rows = 0
    cfg.consensus.defer_vote_verification = True
    if not root:
        cfg.consensus.wal_path = os.path.join(tempfile.mkdtemp(prefix=f"{phase}-wal-"), "wal")
        roots.append(os.path.dirname(cfg.consensus.wal_path))
    return cfg


# the p2p channels by ID, as the port's node lists them
CHANNEL_NAMES = {"0x40": "blocksync", "0x21": "consensus data", "0x22": "consensus votes",
                 "0x20": "consensus state", "0x23": "vote set bits", "0x30": "mempool",
                 "0x38": "evidence", "0x0": "pex", "0x60": "snapshot", "0x61": "chunk"}


def channel_bytes(node) -> dict:
    """The bytes a node received by channel, from its p2p metrics."""
    return {lab[0]: int(v) for lab, v in node.metrics.p2p.peer_receive_bytes_total._values.items()}


def card_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
              ).splitlines()[0]


async def until_node(phase: str, node, cond, what: str, timeout: float) -> None:
    """Polls `cond` every 5 ms; exits when the node stored an error, its
    consensus halted or `timeout` seconds passed."""
    import asyncio

    t0 = time.perf_counter()
    while not cond():
        node._raise_stored()
        if node.consensus.halt_error is not None:
            raise SystemExit(f"{phase}: J's consensus halted: {node.consensus.halt_error!r}")
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"{phase}: timed out waiting for {what}")
        await asyncio.sleep(0.005)


class FlushRecorder:
    """Every verify flush of a node phase while `window` is one of
    `windows`: verify_batch as crypto/batch.py exports it (the scheduler's
    lanes) and as the vote sets, the commit checks and blocksync import it,
    and the asynchronous commit checks' verify_batch_submit / finish (timed
    from the submit). Each entry holds the window, the rows, the lane
    ("catchup" on the scheduler's dispatch thread, the lane that
    `track_lanes` saw on the caller's thread, else "direct": a direct call),
    the route, the ms, the mask and the rows themselves. install() swaps the
    recorders in and uninstall() puts the real functions back; close()
    reads a window's launches into `launches` as "<phase> <window>";
    host_check() holds every mask to the host arm's."""

    def __init__(self, phase: str, windows: tuple, launches: dict):
        from tendermint_tpu_torch.blocksync import verify as bs_verify
        from tendermint_tpu_torch.crypto import batch
        from tendermint_tpu_torch.types import validator_set as valset_mod
        from tendermint_tpu_torch.types import vote_set as vs_mod

        self.phase, self.windows, self.launches = phase, windows, launches
        self.window, self.recorded, self.counts = "setup", [], {}
        self._batch = batch
        self._users = (batch, vs_mod, valset_mod, bs_verify)
        self._real = [m.verify_batch for m in self._users]
        self._real_sub, self._real_fin = batch.verify_batch_submit, batch.verify_batch_finish
        self._pending = {}
        self._lane = threading.local()

    def lane_now(self) -> str:
        if threading.current_thread().name == "verify-scheduler":
            return "catchup"
        return getattr(self._lane, "lane", None) or "direct"

    @staticmethod
    def _rows(pks, msgs, sigs, key_types) -> tuple:
        return (list(pks), list(msgs), list(sigs),
                list(key_types) if key_types is not None else ["ed25519"] * len(pks))

    def _keep(self, t0: float, rows: tuple, mask) -> None:
        if self.window in self.windows:
            self.recorded.append(dict(
                window=self.window, rows=len(rows[0]), lane=self.lane_now(),
                path=self._batch.LAST_FLUSH.get("path"), mask=np.asarray(mask, bool),
                ms=(time.perf_counter() - t0) * 1e3, args=rows))

    def _recording(self, real):
        def vb(pks, msgs, sigs, device=None, key_types=None, backend=None, **kw):
            t0 = time.perf_counter()
            mask = real(pks, msgs, sigs, device, key_types, backend, **kw)
            self._keep(t0, self._rows(pks, msgs, sigs, key_types), mask)
            return mask
        return vb

    def _sub(self, pks, msgs, sigs, device=None, key_types=None, backend=None):
        t0 = time.perf_counter()
        h = self._real_sub(pks, msgs, sigs, device, key_types, backend)
        self._pending[id(h)] = (t0, self._rows(pks, msgs, sigs, key_types))
        return h

    def _fin(self, h):
        mask = self._real_fin(h)
        entry = self._pending.pop(id(h), None)
        if entry is not None:
            self._keep(*entry, mask)
        return mask

    def install(self) -> None:
        for m, real in zip(self._users, self._real):
            m.verify_batch = self._recording(real)
        self._batch.verify_batch_submit, self._batch.verify_batch_finish = self._sub, self._fin

    def uninstall(self) -> None:
        for m, real in zip(self._users, self._real):
            m.verify_batch = real
        self._batch.verify_batch_submit = self._real_sub
        self._batch.verify_batch_finish = self._real_fin

    def track_lanes(self, scheduler) -> None:
        """Labels the flushes that a scheduler's verify_rows runs inline on
        the caller's thread (the votes lane) with their lane."""
        real = scheduler.verify_rows

        def verify_rows(lane, *a, **kw):
            prev, self._lane.lane = getattr(self._lane, "lane", None), lane
            try:
                return real(lane, *a, **kw)
            finally:
                self._lane.lane = prev

        scheduler.verify_rows = verify_rows

    def close(self, name: str, kernels=ED25519_KERNELS) -> None:
        self.counts[name] = read_launches(f"{self.phase} {name}", kernels=kernels)
        self.launches[f"{self.phase} {name}"] = self.counts[name]
        reset_launches()

    def host_check(self, pool, workers: int) -> dict:
        """Every recorded mask against the host arm's, each distinct row
        verified once, in pieces of DRAIN; returns the host's verdict by row."""
        index = {}
        for r in self.recorded:
            for row in zip(*r["args"]):
                index.setdefault(row, len(index))
        order = list(index)
        masks = pool_map(pool, _host_masks, [tuple(map(list, zip(*order[lo:lo + DRAIN])))
                                               for lo in range(0, len(order), DRAIN)], workers)
        verdict = dict(zip(order, (ok for m in masks for ok in m)))
        for r in self.recorded:
            if r["mask"].tolist() != [verdict[row] for row in zip(*r["args"])]:
                raise SystemExit(f"{self.phase}: a {r['rows']}-row {r['window']} mask "
                                 f"({r['path']}) differs from the host arm's")
        return verdict

    def report(self, name: str) -> None:
        """One line for a window: each flush from 256 rows (rows, route,
        lane, ms, all rows True), the smaller ones grouped by lane and route,
        and the window's launches."""
        fl = [r for r in self.recorded if r["window"] == name]
        wide = [r for r in fl if r["rows"] >= 256]
        by_route = {}
        for r in fl:
            if r["rows"] < 256:
                by_route.setdefault((r["lane"], r["path"]), []).append(r)
        print(f"{self.phase} {name} flushes (rows, route, lane, ms, all rows True): " + ", ".join(
            f"({r['rows']}, {r['path']}, {r['lane']}, {r['ms']:.1f}, {bool(r['mask'].all())})"
            for r in wide) + "".join(
            f"; {len(rs)} below 256 rows on lane {lane}, route {route}: rows "
            f"{min(r['rows'] for r in rs)}-{max(r['rows'] for r in rs)} (sum "
            f"{sum(r['rows'] for r in rs)}), ms median "
            f"{statistics.median(r['ms'] for r in rs):.1f} sum {sum(r['ms'] for r in rs):.1f}"
            for (lane, route), rs in sorted(by_route.items(), key=lambda kv: str(kv[0])))
            + f"; launches {self.counts[name]}", flush=True)


class LieFaults:
    """L's serving faults, with the three methods of the reference's
    chaos/catchup.ServeFaults that blocksync/reactor.py calls: the first
    block request L receives is swallowed (block_stalled), so that the
    joiner's pool holds blocks 2 and 3 when it asks again after its peer
    timeout and the verify stage sees all three at once; the block at
    height 2 is served once with its last_commit (the commit of height 1)
    poisoned: bits 5 and 6 of byte 63 flipped (s >= L, for Ed25519 and
    sr25519 alike) in each of the first for-block signatures until the valid
    ones hold no more than 2/3 of the power. One flipped signature would not
    do: the commit check tallies valid power, and 9,998 of 10,000 still pass."""

    def __init__(self, power: list, total: int):
        self.power, self.total = power, total
        self.stalls, self.lied = 1, False
        self.flipped: set = set()
        self.fired: list = []

    def block_stalled(self) -> bool:
        if self.stalls:
            self.stalls -= 1
            self.fired.append(("stall", time.perf_counter()))
            return True
        return False

    def take_block_lie(self) -> bool:
        return not self.lied

    def corrupt_block(self, block):
        import dataclasses

        if block.header.height != 2:
            return block
        self.lied = True
        sigs = list(block.last_commit.signatures)
        valid = sum(p for s, p in zip(sigs, self.power) if s.for_block())
        for i, s in enumerate(sigs):
            if valid <= self.total * 2 // 3:
                break
            if s.for_block():
                raw = bytearray(s.signature)
                raw[63] ^= 0x60
                sigs[i] = dataclasses.replace(s, signature=bytes(raw))
                self.flipped.add(bytes(raw))
                valid -= self.power[i]
        self.fired.append(("lie", time.perf_counter()))
        return dataclasses.replace(block, last_commit=dataclasses.replace(
            block.last_commit, signatures=tuple(sigs)))


def p2p_sync_10k_phase(dev, chain: dict, pool, workers: int, launches: dict) -> None:
    """p2p_sync_10k: a new full node of consensus_10k's chain (3 heights of
    BASELINE config 5's set, 8,000 Ed25519 + 2,000 sr25519 validators)
    joins through the port's p2p fabric. Three port Nodes (node/node.py,
    `device` None, secret connections, the reference's rate defaults,
    deferred vote verification, RPC and PEX off, the verified-row memo
    off): S, an honest full node over
    SQLite copies of consensus_10k's stores with fast sync off (its
    consensus reactor gossips); L, the same over its own copies, whose
    blocksync reactor serves LieFaults; J, from genesis with empty stores,
    fast sync on, the kvstore app, no validator, `[fastsync] peer_timeout`
    P2P_PEER_TIMEOUT s. J dials L alone: it fetches blocks 1-3 (the first
    request after one peer timeout), and the verify stage refuses the run
    [(1, 2'), (2', 3)] on the catch-up lane; the pool redoes heights 1 and
    2, keeps block 3, and J drops L after reporting it to its trust scorer.
    J then dials S: one run of heights 1-2 verified on the catch-up lane,
    applied, the handoff to consensus at height 3, and height 3 from S's
    consensus catch-up gossip: the block's parts from S's store and the
    precommits of S's LastCommit as VoteMessages into the deferred vote
    flushes. Each part has its launch window ("lie", "blocksync",
    "consensus"). Prints the secret-connection handshakes, J's bytes
    received per channel, the transfer ms of the blocks, the parts and the
    votes, each flush (rows, route, lane, ms), the dial-of-S-to-commit time
    split into blocksync, handoff and consensus, L's punishment (the pool's
    score, the trust score, the time to the disconnect) and the phase's
    seconds. Holds every flush's mask to the host arm's on the same rows,
    the refused run's False rows to exactly the flipped signatures, J's
    blocks 1-3, their commits and J's app hash to S's, and J to not having
    halted or stored an error."""
    import asyncio
    import shutil
    import tempfile

    from tendermint_tpu_torch.blocksync import messages as bs_messages
    from tendermint_tpu_torch.consensus.messages import (BlockPartMessage, VoteMessage,
                                                         decode_message_traced)
    from tendermint_tpu_torch.libs.metrics import fleet_metrics
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.p2p.conn import secret_connection as scmod
    from tendermint_tpu_torch.tools import chain_observatory as obs
    from tendermint_tpu_torch.tools import fleet_referee

    t_phase = time.perf_counter()
    node_dev = None if dev.type == "cuda" else dev
    roots = []

    def config(root: str, fast_sync: bool):
        cfg = p2p_node_config("p2p_sync_10k", root, roots)
        cfg.base.abci = "kvstore"
        cfg.base.fast_sync = fast_sync
        cfg.fastsync.peer_timeout = P2P_PEER_TIMEOUT
        return cfg

    def served_node(name: str) -> Node:
        root = tempfile.mkdtemp(prefix=f"p2p_sync_10k-{name}-")
        roots.append(root)
        copy_chain_stores(chain["dbs"], root)
        node = Node(config(root, False), chain["genesis"], device=node_dev)
        if node.state.last_block_height != CONSENSUS_HEIGHTS or \
                node.state.app_hash != chain["app_hash"]:
            raise SystemExit(f"p2p_sync_10k {name}: restarted at height "
                             f"{node.state.last_block_height}")
        return node

    S = served_node("S")
    L = served_node("L")
    vals = S.state_store.load_validators(1)
    lie = LieFaults([v.voting_power for v in vals.validators], vals.total_voting_power())
    L.blocksync_reactor.serve_faults = lie
    J = Node(config("", True), chain["genesis"], device=node_dev)
    if not J.fast_sync or J.blocksync_reactor is None or J.scheduler is None:
        raise SystemExit("p2p_sync_10k: J is not fast-syncing on a scheduler")
    setup_s = time.perf_counter() - t_phase

    # every mask of the traffic with its rows and the window it fell in (not
    # the nodes' start-up: the prewarm rows); the votes lane runs inline in
    # J's scheduler's verify_rows, the catch-up lane on its dispatch thread,
    # validate_block's LastCommit check is a direct call
    WINDOWS = ("lie", "blocksync", "consensus")
    rec = FlushRecorder("p2p_sync_10k", WINDOWS, launches)
    rec.track_lanes(J.scheduler)

    # the secret-connection handshakes (both sides of each dial)
    hs = []
    real_upgrade = scmod.SecretConnection.__dict__["upgrade"]

    async def upgrade(reader, writer, priv_key):
        t0 = time.perf_counter()
        sc = await real_upgrade.__func__(scmod.SecretConnection, reader, writer, priv_key)
        side = "J" if priv_key == J.node_key.priv_key else "S/L"
        hs.append((side, (time.perf_counter() - t0) * 1e3))
        return sc

    # what J receives, by channel and time
    rx = {"blocks": [], "parts": [], "votes": []}
    real_bs_rx, real_cs_rx = J.blocksync_reactor.receive, J.consensus_reactor.receive

    async def bs_receive(chan_id, peer, msg_bytes):
        if isinstance(bs_messages.decode_message(msg_bytes), bs_messages.BlockResponse):
            rx["blocks"].append((peer.id, time.perf_counter(), len(msg_bytes)))
        await real_bs_rx(chan_id, peer, msg_bytes)

    async def cs_receive(chan_id, peer, msg_bytes):
        msg, _ = decode_message_traced(msg_bytes)
        if isinstance(msg, VoteMessage):
            rx["votes"].append((time.perf_counter(), len(msg_bytes)))
        elif isinstance(msg, BlockPartMessage):
            rx["parts"].append((time.perf_counter(), len(msg_bytes)))
        await real_cs_rx(chan_id, peer, msg_bytes)

    punished = []
    real_punish = J.blocksync_reactor._punish_peer

    async def punish(peer_id, reason):
        stats = J.blocksync_reactor.pool.peer_stats().get(peer_id, {})
        await real_punish(peer_id, reason)
        punished.append((peer_id, time.perf_counter(), stats, reason,
                         J.switch.reporter.score(peer_id)))

    requests = []
    real_l_rx = L.blocksync_reactor.receive

    async def l_receive(chan_id, peer, msg_bytes):
        msg = bs_messages.decode_message(msg_bytes)
        if isinstance(msg, bs_messages.BlockRequest):
            requests.append((msg.height, time.perf_counter(), lie.stalls))
        await real_l_rx(chan_id, peer, msg_bytes)

    J.blocksync_reactor.receive, J.consensus_reactor.receive = bs_receive, cs_receive
    J.blocksync_reactor._punish_peer = punish
    L.blocksync_reactor.receive = l_receive
    marks = {}

    def until(cond, what: str, timeout: float):
        return until_node("p2p_sync_10k", J, cond, what, timeout)

    async def drive() -> dict:
        loop = asyncio.get_running_loop()
        started = []
        try:
            for node in (S, L, J):
                await node.start()
                started.append(node)
            t0 = time.perf_counter()
            for node in started:
                if node._prewarm_thread is not None:
                    await loop.run_in_executor(None, node._prewarm_thread.join)
                node._raise_stored()
            prewarm_s = time.perf_counter() - t0
            lid, sid = L.node_key.id, S.node_key.id
            if dev.type == "cuda":
                torch.cuda.synchronize()
            reset_launches()

            # 1. J dials L alone: the lie is refused on the card, L dropped
            rec.window = "lie"
            marks["dial_L"] = time.perf_counter()
            await J.switch.dial_peer(f"{lid}@{L.p2p_addr}")
            await until(lambda: punished and not J.switch.peers.has(lid), "L's punishment",
                        4 * P2P_PEER_TIMEOUT + 30)
            marks["L_dropped"] = time.perf_counter()
            rec.close("lie")
            kept = sorted(h for h, req in J.blocksync_reactor.pool._requesters.items()
                          if req.block is not None)

            # 2. J dials S: blocksync of heights 1-2, the handoff at height 3
            rec.window = "blocksync"
            real_switch = J.blocksync_reactor._switch_to_consensus

            async def switch_to_consensus():
                # the handoff: the pool stops, consensus takes the state and
                # rebuilds its LastCommit (serial verifies, as the reference
                # does), then starts and announces its round state
                marks["handoff_begin"] = time.perf_counter()
                await real_switch()
                marks["handoff_end"] = time.perf_counter()

            J.blocksync_reactor._switch_to_consensus = switch_to_consensus
            marks["dial_S"] = time.perf_counter()
            await J.switch.dial_peer(f"{sid}@{S.p2p_addr}")
            await until(lambda: "handoff_end" in marks, "J's handoff to consensus", 60)
            synced_at = J.blocksync_reactor.state.last_block_height
            rec.close("blocksync")

            # 3. height 3 from S's consensus catch-up gossip
            rec.window = "consensus"
            await until(lambda: J.block_store.height >= CONSENSUS_HEIGHTS, "J's height 3", 90)
            marks["commit_3"] = time.perf_counter()
            await until(lambda: not (J.consensus.rs.last_commit is not None
                                     and J.consensus.rs.last_commit.pending_count()),
                        "J's last flushes", 30)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            routes = {r["path"] for r in rec.recorded if r["window"] == "consensus"}
            card = bool(routes - {"cpu", "memo"})
            rec.close("consensus", kernels=ED25519_KERNELS if card else ())
            rec.window = "after"
            J._raise_stored()
            # the observatory: S's and J's dumps, and the referee over them
            t_obs = time.perf_counter()
            dump_dir = tempfile.mkdtemp(prefix="p2p_sync_10k-observatory-")
            roots.append(dump_dir)
            for node in (S, J):
                obs.write_node_dump(node, dump_dir)
            checks0 = fleet_metrics().safety_checks._values.get((), 0.0)
            dumps = obs.load_dumps(dump_dir)
            report = fleet_referee.build_report(dumps)
            observatory = dict(
                report=report, s=time.perf_counter() - t_obs,
                checks=fleet_metrics().safety_checks._values.get((), 0.0) - checks0,
                bytes=sum(os.path.getsize(d["source_file"]) for d in dumps),
                labels={"S": S.node_key.id[:10], "J": J.node_key.id[:10]})
            rxb = channel_bytes(J)
            heights = range(1, CONSENSUS_HEIGHTS + 1)
            return dict(j_blocks=[J.block_store.load_block(h).encode() for h in heights],
                        s_blocks=[S.block_store.load_block(h).encode() for h in heights],
                        j_commits=[J.block_store.load_block_commit(h).encode() for h in heights[:-1]],
                        s_commits=[S.block_store.load_block_commit(h).encode() for h in heights[:-1]],
                        j_seen=J.block_store.load_seen_commit(CONSENSUS_HEIGHTS),
                        s_seen=S.block_store.load_seen_commit(CONSENSUS_HEIGHTS),
                        s3=S.block_store.load_block_meta(CONSENSUS_HEIGHTS)[0],
                        prewarm_s=prewarm_s, kept=kept, synced_at=synced_at, rx_bytes=rxb,
                        trust_L=J.switch.reporter.score(lid), L_peers=L.switch.num_peers(),
                        sched_log=list(J.scheduler.flush_log) if J.scheduler else [],
                        app_hash=J.state_store.load().app_hash,
                        s_app_hash=S.state_store.load().app_hash,
                        halt=J.consensus.halt_error, observatory=observatory)
        finally:
            for node in reversed(started):
                await node.stop()

    rec.install()
    scmod.SecretConnection.upgrade = staticmethod(upgrade)
    try:
        out = asyncio.run(drive())
    finally:
        rec.uninstall()
        scmod.SecretConnection.upgrade = real_upgrade
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    run_s = time.perf_counter() - t_phase - setup_s
    if out["halt"] is not None:
        raise SystemExit(f"p2p_sync_10k: J's consensus halted: {out['halt']!r}")
    # blocks 1-3, their commits and the seen commit of 3, against S's
    if out["j_blocks"] != out["s_blocks"] or out["j_commits"] != out["s_commits"]:
        raise SystemExit("p2p_sync_10k: J's blocks 1-3 or their commits differ from S's")
    if out["app_hash"] != out["s_app_hash"] or out["app_hash"] != chain["app_hash"]:
        raise SystemExit("p2p_sync_10k: J's app hash differs from S's")
    s_sigs = {s.signature for s in out["s_seen"].signatures if not s.absent()}
    j_sigs = [s.signature for s in out["j_seen"].signatures if not s.absent()]
    if out["j_seen"].block_id != out["s3"] or not set(j_sigs) <= s_sigs:
        raise SystemExit("p2p_sync_10k: J's seen commit of height 3 is not S's block's")

    t_host = time.perf_counter()
    verdict = rec.host_check(pool, workers)
    if any(ok == (row[2] in lie.flipped) for row, ok in verdict.items()):
        raise SystemExit("p2p_sync_10k: a verdict other than the flipped rows' is False, or a "
                         "flipped row passed")
    refused = [r for r in rec.recorded if r["window"] == "lie" and not r["mask"].all()]
    if not refused or not lie.flipped or sum(int((~r["mask"]).sum()) for r in refused) != len(
            lie.flipped):
        raise SystemExit(f"p2p_sync_10k: the lie was not refused on its {len(lie.flipped)} "
                         "flipped rows")
    host_s = time.perf_counter() - t_host
    if out["kept"] != [3] or out["synced_at"] != CONSENSUS_HEIGHTS - 1:
        raise SystemExit(f"p2p_sync_10k: after L the pool kept {out['kept']}, and blocksync "
                         f"handed off after height {out['synced_at']} (want [3] and 2)")
    if not punished or punished[0][0] != L.node_key.id:
        raise SystemExit("p2p_sync_10k: L was not punished")
    ob = out["observatory"]
    rep = ob["report"]
    safety = rep["safety"]
    if (rep["verdict"] != "pass" or safety["violations"] or safety["nodes_audited"] != 2
            or safety["heights_checked"] < CONSENSUS_HEIGHTS
            or ob["checks"] != safety["heights_checked"]):
        raise SystemExit(f"p2p_sync_10k observatory: verdict {rep['verdict']}, safety {safety}, "
                         f"fleet_safety_checks_total +{ob['checks']}; SLO {rep['role_slo']}")

    card_line = card_name(dev)
    print(f"p2p_sync_10k handshakes (secret connection, ms; J's side and the listener's): "
          f"{[(side, round(ms, 3)) for side, ms in hs]}", flush=True)
    print("p2p_sync_10k J's bytes received by channel: " + ", ".join(
        f"{CHANNEL_NAMES.get(k, k)} ({k}) {v}" for k, v in sorted(out["rx_bytes"].items())), flush=True)
    by_peer = {}
    for pid, t, n in rx["blocks"]:
        by_peer.setdefault("L" if pid == L.node_key.id else "S", []).append((t, n))
    for who, items in sorted(by_peer.items()):
        start = marks["dial_L"] if who == "L" else marks["dial_S"]
        print(f"p2p_sync_10k blocks from {who}: {len(items)} BlockResponses, "
              f"{sum(n for _, n in items)} bytes, last {(items[-1][0] - start) * 1e3:.1f} ms "
              f"after the dial; requests L saw (height, ms after the dial, stall left) "
              f"{[(h, round((t - marks['dial_L']) * 1e3, 1), s) for h, t, s in requests]}"
              if who == "L" else
              f"p2p_sync_10k blocks from {who}: {len(items)} BlockResponses, "
              f"{sum(n for _, n in items)} bytes, last {(items[-1][0] - start) * 1e3:.1f} ms "
              f"after the dial", flush=True)
    for kind in ("parts", "votes"):
        items = rx[kind]
        if items:
            print(f"p2p_sync_10k consensus {kind}: {len(items)} messages, "
                  f"{sum(n for _, n in items)} bytes, first {(items[0][0] - marks['handoff_end']) * 1e3:.1f} "
                  f"ms after the handoff, transfer {(items[-1][0] - items[0][0]) * 1e3:.1f} ms "
                  f"(first to last)", flush=True)
    lanes = {}
    for f in out["sched_log"]:
        lanes.setdefault(tuple(sorted(f["rows"])), []).append(sum(f["rows"].values()))
    for name in WINDOWS:
        rec.report(name)
    print(f"p2p_sync_10k scheduler flush_log by lanes (rows of each flush): {lanes}", flush=True)
    pid, t_pun, stats, reason, trust = punished[0]
    print(f"p2p_sync_10k L punished {(t_pun - marks['dial_L']) * 1e3:.1f} ms after the dial "
          f"({reason}); the pool's view of L then {stats}; trust score {trust:.4f} "
          f"(after the disconnect {out['trust_L']:.4f}); dropped "
          f"{(marks['L_dropped'] - marks['dial_L']) * 1e3:.1f} ms after the dial; the pool kept "
          f"heights {out['kept']}; stalls/lies fired {[(k, round((t - marks['dial_L']) * 1e3, 1)) for k, t in lie.fired]}",
          flush=True)
    bs_ms = (marks["handoff_begin"] - marks["dial_S"]) * 1e3
    ho_ms = (marks["handoff_end"] - marks["handoff_begin"]) * 1e3
    cs_ms = (marks["commit_3"] - marks["handoff_end"]) * 1e3
    print(f"p2p_sync_10k dial of S to J's commit of height {CONSENSUS_HEIGHTS}: "
          f"{bs_ms + ho_ms + cs_ms:.1f} ms = blocksync {bs_ms:.1f} (heights 1-{out['synced_at']}) "
          f"+ handoff {ho_ms:.1f} + consensus {cs_ms:.1f}", flush=True)
    print(f"p2p_sync_10k checks: {len(rec.recorded)} masks over {len(verdict)} distinct rows equal "
          f"the host arm's; the refused run's {len(lie.flipped)} False rows are the flipped "
          f"signatures; J's blocks 1-{CONSENSUS_HEIGHTS}, their commits and its app hash "
          f"{out['app_hash'].hex()} equal S's; J's seen commit of height "
          f"{CONSENSUS_HEIGHTS} holds {len(j_sigs)} of S's signatures; J did not halt or store "
          f"an error", flush=True)
    print(f"p2p_sync_10k observatory: S's and J's dumps ({ob['bytes']} bytes) written and the "
          f"referee's report built in {ob['s'] * 1e3:.1f} ms; verdict {rep['verdict']} (exit "
          f"{rep['exit_code']}); safety audit over {safety['nodes_audited']} nodes: "
          f"{safety['heights_checked']} shared heights compared, {len(safety['violations'])} "
          f"violations, tendermint_fleet_safety_checks_total +{ob['checks']:.0f}; waterfall "
          f"{rep['waterfall']['per_node']} ({ob['labels']}); SLO tripped "
          f"{rep['slo_any_tripped']}", flush=True)
    print(f"p2p_sync_10k: {time.perf_counter() - t_phase:.1f} s (setup {setup_s:.1f}, prewarm "
          f"{out['prewarm_s']:.1f}, traffic {run_s - out['prewarm_s'] - host_s:.1f}, host checks "
          f"{host_s:.1f}); card {card_line}", flush=True)


def statesync_10k_phase(dev, chain: dict, pool, workers: int, launches: dict) -> None:
    """statesync_10k: a new full node of consensus_10k's chain (BASELINE
    config 5's set, 8,000 Ed25519 + 2,000 sr25519 validators, here at its
    STATESYNC_HEIGHTS heights) joins by snapshot instead of by replay. Two
    port Nodes (node/node.py, `device` None, secret connections, PEX off,
    the verified-row memo off): S, a full node over SQLite copies of the
    chain's stores with fast sync off and RPC on a free port, whose app
    (the kvstore, a snapshot every height) runs behind a port SocketServer
    (abci/socket.py) and is reached through `base.proxy_app`; its
    Handshaker replays heights 1-4 into it over the socket, after which the
    app's ListSnapshots answers only the snapshot of height 1 (the state
    provider's state(1) needs the light blocks 1-3, and a snapshot at 1
    leaves the joiner blocks to fetch). J, fresh, with `statesync.enable`,
    `[statesync] rpc_servers` naming S's RPC and trust height 1 with block
    1's hash, whose kvstore runs behind a port GrpcServer (abci/grpc.py,
    `base.abci = "grpc"`), so the restore crosses gRPC. After both
    prewarms J dials S: its statesync reactor (statesync/reactor.py)
    discovers the snapshot in STATESYNC_DISCOVERY_S, its
    LightClientStateProvider (statesync/stateprovider.py, HTTPProvider over
    HTTPClient) verifies heights 1-3 on the card, its syncer fetches the
    chunks on 0x61 and applies them over gRPC, the node bootstraps its
    stores at height 1 and switches to block sync: its pool (at height 2)
    fetches blocks 2-4 from S, the verify stage checks height 2 (and 3 when
    block 4 is in) on the catch-up lane, the blocks are applied over gRPC,
    and J hands off to consensus once within one block of S's head
    (blocksync/reactor.py `_caught_up`), where the phase ends (the rest
    would come by consensus gossip, what p2p_sync_10k measures). Launch
    windows: "light" (the dial to the restore), "blocksync" (the restore to
    the handoff) and "handoff" (the LastCommit rebuild, which verifies on
    the host: no launch). Prints each light block's fetch and parse beside
    each light check's rows, route and ms, the chunks, bytes and apply ms,
    each flush, dial to handoff split into discovery, light and restore,
    block sync and the handoff, J's bytes per channel and the phase's
    seconds. Holds every mask to the host arm's on the same rows, J's
    restored state (validators, last_block_id, app_hash, last_results_hash)
    and app hash to S's at height 1, J's block store to block 1's seen
    commit and S's blocks from 2 to the handoff, J's app hash then to S's,
    and J to no halt, no stored error and no fallback."""
    import asyncio
    import shutil
    import tempfile

    from tendermint_tpu_torch.abci import types as abci_types
    from tendermint_tpu_torch.abci.grpc import GrpcServer
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.abci.socket import SocketServer
    from tendermint_tpu_torch.light.provider import HTTPProvider
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.statesync import stateprovider as sp_mod
    from tendermint_tpu_torch.statesync import syncer as syncer_mod

    class AdvertisingKVStore(KVStoreApplication):
        """The kvstore whose ListSnapshots answers only the heights in
        `advertised` (every snapshot it holds while that is None)."""

        advertised = None

        def list_snapshots(self):
            resp = super().list_snapshots()
            if self.advertised is not None:
                resp.snapshots = [s for s in resp.snapshots if s.height in self.advertised]
            return resp

    t_phase = time.perf_counter()
    node_dev = None if dev.type == "cuda" else dev
    roots = []

    # S: the chain's stores, its kvstore behind the ABCI socket
    ext = chain["ext"]
    root = tempfile.mkdtemp(prefix="statesync_10k-S-")
    roots.append(root)
    copy_chain_stores(ext["dbs"], root)
    s_app = AdvertisingKVStore(snapshot_interval=1, snapshot_keep=STATESYNC_HEIGHTS)
    s_server = SocketServer("tcp://127.0.0.1:0", s_app)
    s_server.start()
    j_app = KVStoreApplication()
    j_server = GrpcServer("tcp://127.0.0.1:0", j_app)
    j_server.start()
    s_cfg = p2p_node_config("statesync_10k", root, roots)
    s_cfg.base.fast_sync = False
    s_cfg.base.proxy_app = f"tcp://127.0.0.1:{s_server.bound_addr[1]}"
    s_cfg.rpc.laddr = "tcp://127.0.0.1:0"
    S = Node(s_cfg, chain["genesis"], device=node_dev)
    if S.state.last_block_height != STATESYNC_HEIGHTS or S.state.app_hash != ext["app_hash"]:
        raise SystemExit(f"statesync_10k S: restarted at height {S.state.last_block_height}")
    replayed = sorted(s.height for s in s_app.list_snapshots().snapshots)
    if replayed != list(range(1, STATESYNC_HEIGHTS + 1)):
        raise SystemExit(f"statesync_10k S: snapshots at {replayed} after the replay over the "
                         "socket")
    s_app.advertised = {1}
    snap, = s_app.list_snapshots().snapshots
    snap_bytes = sum(len(s_app.load_snapshot_chunk(abci_types.RequestLoadSnapshotChunk(
        height=snap.height, format=snap.format, chunk=i)).chunk) for i in range(snap.chunks))
    bid1 = S.block_store.load_block_meta(1)[0]
    want = dict(validators=S.state_store.load_validators(2).hash(),
                next_validators=S.state_store.load_validators(3).hash(),
                last_validators=S.state_store.load_validators(1).hash(),
                last_block_id=bid1, app_hash=S.block_store.load_block(2).header.app_hash,
                last_results_hash=S.block_store.load_block(2).header.last_results_hash)
    setup_s = time.perf_counter() - t_phase

    WINDOWS = ("light", "blocksync", "handoff")
    rec = FlushRecorder("statesync_10k", WINDOWS, launches)
    fetches, checks_t, applies, marks = [], [], [], {}
    real_light_block = HTTPProvider.light_block

    async def light_block(self, height):
        t0 = time.perf_counter()
        try:
            return await real_light_block(self, height)
        finally:
            fetches.append((height, (time.perf_counter() - t0) * 1e3))

    def timed_provider(name):
        real = getattr(sp_mod.LightClientStateProvider, name)

        async def call(self, height):
            t0 = time.perf_counter()
            marks.setdefault("light_begin", t0)
            try:
                return await real(self, height)
            finally:
                checks_t.append((name, height, t0, time.perf_counter()))
        return real, call

    real_add = syncer_mod.Syncer.add_snapshot

    def add_snapshot(self, peer_id, snapshot):
        added = real_add(self, peer_id, snapshot)
        if added:
            marks.setdefault("snapshot_added", time.perf_counter())
        return added

    async def drive() -> dict:
        loop = asyncio.get_running_loop()
        started, out = [], {}
        try:
            await S.start()
            started.append(S)
            j_cfg = p2p_node_config("statesync_10k", "", roots)
            j_cfg.base.fast_sync = True
            j_cfg.base.abci = "grpc"
            j_cfg.base.proxy_app = f"tcp://127.0.0.1:{j_server.port}"
            j_cfg.statesync.enable = True
            j_cfg.statesync.rpc_servers = [f"http://127.0.0.1:{S.rpc_server.port}"]
            j_cfg.statesync.trust_height = 1
            j_cfg.statesync.trust_hash = bid1.hash.hex()
            j_cfg.statesync.discovery_time = STATESYNC_DISCOVERY_S
            J = Node(j_cfg, chain["genesis"], device=node_dev)
            if not J.state_sync or J.statesync_reactor is None or J.scheduler is None:
                raise SystemExit("statesync_10k: J is not state-syncing on a scheduler")
            gate = asyncio.Event()
            real_sync = J.statesync_reactor.sync

            async def sync(provider, discovery_time, **kw):
                # the discovery window opens once J has dialed S (after the
                # prewarms), so the window measures discovery alone
                await gate.wait()
                marks["sync_begin"] = time.perf_counter()
                state, commit = await real_sync(provider, discovery_time, **kw)
                marks["restored"] = time.perf_counter()
                out["state"], out["commit"] = state, commit
                out["j_app_hash"] = J.proxy_app.query.info(
                    abci_types.RequestInfo()).last_block_app_hash
                rec.close("light")
                rec.window = "blocksync"
                return state, commit

            J.statesync_reactor.sync = sync
            real_apply = J.proxy_app.snapshot.apply_snapshot_chunk

            def apply_chunk(req):
                t0 = time.perf_counter()
                resp = real_apply(req)
                applies.append((req.index, len(req.chunk), (time.perf_counter() - t0) * 1e3))
                return resp

            J.proxy_app.snapshot.apply_snapshot_chunk = apply_chunk
            real_switch = J.blocksync_reactor._switch_to_consensus

            async def switch_to_consensus():
                # the handoff: the pool stops, consensus takes the state and
                # rebuilds its LastCommit (serial verifies, as the reference does)
                marks["handoff_begin"] = time.perf_counter()
                out["synced_at"] = J.blocksync_reactor.state.last_block_height
                rec.close("blocksync")
                rec.window = "handoff"
                await real_switch()
                rec.close("handoff", kernels=())
                rec.window = "after"
                marks["handoff_end"] = time.perf_counter()

            J.blocksync_reactor._switch_to_consensus = switch_to_consensus
            await J.start()
            started.append(J)
            t0 = time.perf_counter()
            for node in started:
                if node._prewarm_thread is not None:
                    await loop.run_in_executor(None, node._prewarm_thread.join)
                node._raise_stored()
            out["prewarm_s"] = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.synchronize()
            reset_launches()
            rec.window = "light"
            marks["dial"] = time.perf_counter()
            await J.switch.dial_peer(f"{S.node_key.id}@{S.p2p_addr}")
            gate.set()
            await until_node("statesync_10k", J, lambda: "handoff_end" in marks,
                             "J's handoff to consensus", 180)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            J._raise_stored()
            synced = range(2, out["synced_at"] + 1)
            out.update(
                rx_bytes=channel_bytes(J), j_block1=J.block_store.load_block(1),
                j_blocks=[J.block_store.load_block(h).encode() for h in synced],
                s_blocks=[S.block_store.load_block(h).encode() for h in synced],
                s_next_app_hash=S.block_store.load_block(out["synced_at"] + 1).header.app_hash,
                j_app_hash_synced=J.proxy_app.query.info(
                    abci_types.RequestInfo()).last_block_app_hash,
                j_seen1=J.block_store.load_seen_commit(1), base=J.block_store.base,
                j_height=J.block_store.height,
                fallbacks=J.metrics.statesync.fallbacks_total._values.get((), 0.0),
                sched_log=list(J.scheduler.flush_log),
                halt=J.consensus.halt_error, error=J.statesync_error)
            return out
        finally:
            for node in reversed(started):
                await node.stop()

    real_ah, ah = timed_provider("app_hash")
    real_st, st = timed_provider("state")
    real_cm, cm = timed_provider("commit")
    rec.install()
    HTTPProvider.light_block = light_block
    sp_mod.LightClientStateProvider.app_hash = ah
    sp_mod.LightClientStateProvider.state = st
    sp_mod.LightClientStateProvider.commit = cm
    syncer_mod.Syncer.add_snapshot = add_snapshot
    try:
        out = asyncio.run(drive())
    finally:
        rec.uninstall()
        HTTPProvider.light_block = real_light_block
        sp_mod.LightClientStateProvider.app_hash = real_ah
        sp_mod.LightClientStateProvider.state = real_st
        sp_mod.LightClientStateProvider.commit = real_cm
        syncer_mod.Syncer.add_snapshot = real_add
        s_server.stop()
        j_server.stop()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    run_s = time.perf_counter() - t_phase - setup_s
    if out["halt"] is not None or out["error"] is not None or out["fallbacks"]:
        raise SystemExit(f"statesync_10k: J halted ({out['halt']!r}), stored "
                         f"{out['error']!r} or fell back to block sync ({out['fallbacks']})")
    state = out["state"]
    got = dict(validators=state.validators.hash(), next_validators=state.next_validators.hash(),
               last_validators=state.last_validators.hash(), last_block_id=state.last_block_id,
               app_hash=state.app_hash, last_results_hash=state.last_results_hash)
    if got != want or state.last_block_height != 1 or out["j_app_hash"] != want["app_hash"]:
        raise SystemExit(f"statesync_10k: J's restored state or app hash differs from S's at "
                         f"height 1: {[k for k in want if got[k] != want[k]]}")
    if out["commit"].height != 1 or out["commit"].block_id != bid1 or out["j_seen1"] is None:
        raise SystemExit("statesync_10k: J's seen commit of height 1 is not block 1's")
    if out["j_block1"] is not None or out["base"] != 2 or out["j_height"] != out["synced_at"] \
            or not 2 <= out["synced_at"] < STATESYNC_HEIGHTS:
        raise SystemExit(f"statesync_10k: J's block store runs {out['base']}-{out['j_height']} "
                         f"(block 1 {'present' if out['j_block1'] is not None else 'absent'}) "
                         f"and it handed off after height {out['synced_at']} (want blocks from "
                         f"2 to the handoff, 2 or 3)")
    if out["j_blocks"] != out["s_blocks"] or out["j_app_hash_synced"] != out["s_next_app_hash"]:
        raise SystemExit("statesync_10k: J's blocks or app hash after block sync differ from S's")
    card_routes = lambda rs: [r for r in rs if r["rows"] >= 256 and r["path"] not in ("cpu", "memo")]
    light = [r for r in rec.recorded if r["window"] == "light"]
    caught = [r for r in rec.recorded if r["window"] == "blocksync" and r["lane"] == "catchup"]
    if len(card_routes(light)) < 3 or len(card_routes(light)) != len(
            [r for r in light if r["rows"] >= 256]) or not card_routes(caught):
        raise SystemExit(f"statesync_10k: the light checks or the catch-up flush did not run on "
                         f"the card: light {[(r['rows'], r['path']) for r in light]}, catch-up "
                         f"{[(r['rows'], r['path']) for r in caught]}")

    t_host = time.perf_counter()
    verdict = rec.host_check(pool, workers)
    host_s = time.perf_counter() - t_host

    card_line = card_name(dev)
    print(f"statesync_10k S: kvstore over the ABCI socket, {len(replayed)} snapshots replayed, "
          f"ListSnapshots answering height {snap.height}: {snap.chunks} chunk(s), {snap_bytes} "
          f"bytes; J's kvstore over gRPC", flush=True)
    print(f"statesync_10k light blocks fetched and parsed (height, ms): "
          f"{[(h, round(ms, 1)) for h, ms in fetches]}", flush=True)
    print(f"statesync_10k provider calls (call, height, ms): "
          f"{[(n, h, round((t1 - t0) * 1e3, 1)) for n, h, t0, t1 in checks_t]}", flush=True)
    for name in WINDOWS:
        rec.report(name)
    print(f"statesync_10k restore: {len(applies)} chunk(s) applied over gRPC (index, bytes, ms) "
          f"{[(i, n, round(ms, 2)) for i, n, ms in applies]}", flush=True)
    print("statesync_10k J's bytes received by channel: " + ", ".join(
        f"{CHANNEL_NAMES.get(k, k)} ({k}) {v}" for k, v in sorted(out["rx_bytes"].items())),
        flush=True)
    lanes = {}
    for f in out["sched_log"]:
        lanes.setdefault(tuple(sorted(f["rows"])), []).append(sum(f["rows"].values()))
    print(f"statesync_10k scheduler flush_log by lanes (rows of each flush): {lanes}", flush=True)
    disc_ms = (marks["light_begin"] - marks["dial"]) * 1e3
    lr_ms = (marks["restored"] - marks["light_begin"]) * 1e3
    # light: the union of the provider calls (state and commit overlap);
    # restore: the rest of the window (chunk fetches and applies)
    light_ms, end = 0.0, 0.0
    for _, _, t0, t1 in sorted(checks_t, key=lambda c: c[2]):
        light_ms += max(0.0, t1 - max(t0, end)) * 1e3
        end = max(end, t1)
    bs_ms = (marks["handoff_begin"] - marks["restored"]) * 1e3
    ho_ms = (marks["handoff_end"] - marks["handoff_begin"]) * 1e3
    synced_heights = ("height 2" if out["synced_at"] == 2 else
                      f"heights 2-{out['synced_at']}")
    print(f"statesync_10k dial of S to J's handoff: {disc_ms + lr_ms + bs_ms + ho_ms:.1f} ms = "
          f"discovery {disc_ms:.1f} (snapshot added "
          f"{(marks['snapshot_added'] - marks['dial']) * 1e3:.1f} ms after the dial; window "
          f"{STATESYNC_DISCOVERY_S} s) + light {light_ms:.1f} (the checks' submit to finish "
          f"{sum(r['ms'] for r in light):.1f}, fetch and parse "
          f"{sum(ms for _, ms in fetches):.1f}) + restore {lr_ms - light_ms:.1f} (chunk applies "
          f"{sum(ms for *_, ms in applies):.1f}) + bootstrap and block sync {bs_ms:.1f} ({synced_heights}, the "
          f"catch-up flushes {sum(r['ms'] for r in caught):.1f}) + handoff {ho_ms:.1f} "
          f"(LastCommit of height {out['synced_at']} rebuilt)", flush=True)
    print(f"statesync_10k checks: {len(rec.recorded)} masks over {len(verdict)} distinct rows "
          f"equal the host arm's; J's restored state (validators, last_block_id, app_hash, "
          f"last_results_hash) and app hash {out['j_app_hash'].hex()} equal S's at height 1; "
          f"J's block store holds block 1's seen commit and S's {synced_heights.replace('height', 'block')}, "
          f"its app hash then {out['j_app_hash_synced'].hex()} is S's; no halt, no stored "
          f"error, no fallback", flush=True)
    print(f"statesync_10k: {time.perf_counter() - t_phase:.1f} s (setup {setup_s:.1f}, prewarm "
          f"{out['prewarm_s']:.1f}, traffic {run_s - out['prewarm_s'] - host_s:.1f}, host checks "
          f"{host_s:.1f}); card {card_line}", flush=True)


def device_fault_check(dev, corpus, pool, workers: int, launches: dict) -> None:
    """device_fault: chaos/device.py's DeviceFaultInjector on the card path.
    One armed error on a warm 10,000-validator verify_commit (the commit
    phase's corpus, the default pipelined route): it must raise
    DeviceFaultError at rlc_submit (the injector's `fired` names the site),
    marked as a device error, with no fallback, and leave libs/trace's
    device_up at 0; after heal() the next verify_batch of the same rows
    gives the host arm's mask (path "device_fault healed", all six kernels
    launched) and marks the device up."""
    from tendermint_tpu_torch.chaos import DeviceFaultError, DeviceFaultInjector
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.libs import trace

    t0 = time.perf_counter()
    vals, block_id, commit, msgs = corpus
    pks = [v.pub_key.bytes() for v in vals.validators]
    sigs = [s.signature for s in commit.signatures]
    memo = batch.verified_memo_stats()["capacity"]
    batch.configure_verified_memo(0)
    vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize()
    inj = DeviceFaultInjector().install()
    try:
        inj.arm_errors(1)
        reset_launches()
        try:
            vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        except DeviceFaultError as e:
            if not batch.is_device_error(e):
                raise SystemExit("device_fault: the injected error is not marked as a device error")
            raised = repr(e)
        else:
            raise SystemExit("device_fault: the armed error did not raise")
        faulted = launches["device_fault armed"] = read_launches("device_fault armed", kernels=())
        up = trace.device_health()["device_up"]
        if inj.fired != [("rlc_submit", "error")] or up != 0:
            raise SystemExit(f"device_fault: fired {inj.fired}, device_up {up} (want rlc_submit "
                             "and 0)")
        inj.heal()
        reset_launches()
        t1 = time.perf_counter()
        mask = batch.verify_batch(pks, msgs, sigs, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        healed_ms = (time.perf_counter() - t1) * 1e3
        launches["device_fault healed"] = read_launches("device_fault healed")
        path = batch.LAST_FLUSH.get("path")
        up_after = trace.device_health()["device_up"]
    finally:
        inj.uninstall()
        batch.configure_verified_memo(memo)
    host = pool_map(pool, _host_masks, [(pks[lo:lo + DRAIN], msgs[lo:lo + DRAIN],
                                         sigs[lo:lo + DRAIN], ["ed25519"] * len(pks[lo:lo + DRAIN]))
                                        for lo in range(0, len(pks), DRAIN)], workers)
    if mask.tolist() != [ok for m in host for ok in m] or up_after != 1:
        raise SystemExit(f"device_fault: after heal() the mask differs from the host arm's or "
                         f"device_up is {up_after}")
    print(f"device_fault: {raised} at {inj.fired[0][0]} (injector calls {inj.calls}), "
          f"device_up 0 after it, launches before the fault {sum(faulted.values())}; after "
          f"heal() {len(pks)} rows on path {path} in {healed_ms:.1f} ms, mask equal to the host "
          f"arm's, device_up {up_after}; {time.perf_counter() - t0:.1f} s", flush=True)


def build_tx_admission(pool, workers: int) -> dict:
    """tx_admission's corpus, signed on the fork pool before the card is
    touched (_sign_votes, whose nonce points _base_mul computes): the serial
    arm's, the batched arm's and the tampered batch's signed-tx envelopes
    (types/signed_tx.py) under ADM_KEYS keys, payloads as bench.py's."""
    from tendermint_tpu_torch.crypto import keys
    from tendermint_tpu_torch.types import signed_tx

    t0 = time.perf_counter()
    seeds = [bytes([k + 1]) * 32 for k in range(ADM_KEYS)]
    pks = [keys.gen_ed25519(s).pub_key().bytes() for s in seeds]
    out = {}
    for tag, count in (("ser", ADM_SERIAL_TXS), ("bat", ADM_BATCHED_TXS), ("tam", ADM_BATCH)):
        payloads = [b"%s-%d=x" % (tag.encode(), i) for i in range(count)]
        jobs = [("ed25519", seeds[i % ADM_KEYS], pks[i % ADM_KEYS], signed_tx.SIGN_PREFIX + p)
                for i, p in enumerate(payloads)]
        sigs = pool_map(pool, _sign_votes, jobs, workers)
        out[tag] = [signed_tx.MAGIC + pks[i % ADM_KEYS] + sig + p
                    for i, (sig, p) in enumerate(zip(sigs, payloads))]
    for i in ADM_TAMPERED:
        tx = out["tam"][i]
        out["tam"][i] = tx[:36] + flip(tx[36:100]) + tx[100:]
    out["sign_s"] = time.perf_counter() - t0
    print(f"tx_admission corpus: {sum(len(out[t]) for t in ('ser', 'bat', 'tam'))} signed txs "
          f"from {ADM_KEYS} keys on {workers} workers, {out['sign_s']:.1f} s", flush=True)
    return out


def tx_admission_phase(dev, adm: dict, pool, workers: int, launches: dict,
                       memo_default: int) -> None:
    """tx_admission: bench.py bench_tx_admission on the port's Node
    (node/node.py) with `device` None, the reference's routing (the card
    from 256 rows): a single validator running signed_kvstore, deferred
    vote verification (the votes lane), memdb, no RPC, mempool size 500,000,
    cache 1,000,000, TTL 2 blocks, recheck off, the scheduler at its
    defaults, prewarm off. A baseline window of ADM_BASELINE heights, then
    the serial arm (sig_precheck off: the app verifies each tx) and the
    batched arm (the admission lane; under torch.profiler on the card), each
    from ADM_SENDERS threads through check_tx_batch for at most ADM_FLOOD_S,
    then the tampered batch. Prints each arm's admissions/s and their ratio,
    the app's counters, the admission flushes (the wrapper's own record, the
    flight recorder's labels and the scheduler's flush_log), the votes
    lane's p99 flush wall at baseline and under the flood, each arm's
    launches, the batched arm's device busy time and idle share, whether
    OpenSSL verifies the serial arm, the node's exposition for the mempool,
    consensus height and scheduler series, one tx's journey and the phase's
    seconds. Holds every admission flush's mask to the host arm's on the
    same rows, the batched arm to no app-side verify, the tampered batch to
    exactly its planted rejections, each committed LastCommit to the host
    arm, and the node to not having halted."""
    import asyncio
    import shutil
    import tempfile
    import threading
    from collections import Counter, deque

    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.abci.kvstore import SignedKVStoreApplication
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto import batch, keys, scheduler, tmhash
    from tendermint_tpu_torch.libs import forensics, trace
    from tendermint_tpu_torch.libs.profiler import device_rows
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types import signed_tx
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    if scheduler.default_scheduler() is not None:
        raise SystemExit("tx_admission: a default scheduler is still installed")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tx_admission-")
    cfg = test_config()
    cfg.base.db_backend = "memdb"
    cfg.rpc.laddr = ""
    cfg.root_dir = ""
    cfg.consensus.wal_path = os.path.join(tmp, "wal")
    cfg.instrumentation.forensics_dir = os.path.join(tmp, "forensics")
    cfg.consensus.defer_vote_verification = True
    cfg.mempool.size, cfg.mempool.cache_size = 500_000, 1_000_000
    cfg.mempool.ttl_num_blocks, cfg.mempool.recheck = 2, False
    app = SignedKVStoreApplication()
    priv = FilePV(keys.gen_ed25519(b"\x72" * 32))
    gen = GenesisDoc(chain_id="bench-tx-admission",
                     validators=[GenesisValidator(priv.get_pub_key(), 10)])
    node = Node(cfg, gen, priv_validator=priv, app=app,
                device=None if dev.type == "cuda" else dev)
    node._start_crypto_prewarm = lambda: None  # prewarm off, as bench.py has it
    sched, mp_ = node.scheduler, node.mempool
    # the phase's flushes all stay in the journal and the recorder's ring
    # (the votes lane flushes once a vote: thousands of flushes an arm)
    sched.flush_log = deque(sched.flush_log, maxlen=1 << 20)
    trace.tracer.configure(ring_size=1 << 17)

    # every flush of admission rows, recorded on the dispatch thread: rows,
    # route label and mode, ms, mask, and the rows themselves
    adm_flushes, arm = [], {"name": "baseline"}
    real_verify = sched._verify_chunked

    def recorded(pks, msgs, sigs, kt, sources=None):
        t0 = time.perf_counter()
        mask = real_verify(pks, msgs, sigs, kt, sources)
        n_adm = sum(m.startswith(signed_tx.SIGN_PREFIX) for m in msgs)
        if n_adm:
            f = batch.LAST_FLUSH
            adm_flushes.append(dict(arm=arm["name"], rows=len(pks), adm=n_adm,
                                    path=f.get("path"), mode=f.get("mode"),
                                    ms=(time.perf_counter() - t0) * 1e3,
                                    mask=np.asarray(mask, bool),
                                    args=(list(pks), list(msgs), list(sigs),
                                          list(kt) if kt is not None else ["ed25519"] * len(pks))))
        return mask

    sched._verify_chunked = recorded
    batches = {t: [adm[t][i:i + ADM_BATCH] for i in range(0, len(adm[t]), ADM_BATCH)]
               for t in ("ser", "bat")}

    def flood(bl, stop_t):
        counts, lock, idx = {"ok": 0, "rej": 0}, threading.Lock(), {"i": 0}

        def worker():
            while True:
                with lock:
                    i = idx["i"]
                    idx["i"] += 1
                if i >= len(bl) or time.monotonic() >= stop_t:
                    return
                out = mp_.check_tx_batch(bl[i], sender="bench-%d" % (i % ADM_SENDERS))
                ok = sum(1 for r in out if r is not None and r.code == 0)
                with lock:
                    counts["ok"] += ok
                    counts["rej"] += len(out) - ok

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(ADM_SENDERS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return counts["ok"], counts["rej"], time.perf_counter() - t0

    def vote_walls(t0, t1):
        return [f["wall_s"] for f in list(sched.flush_log)
                if "votes" in f["rows"] and t0 <= f["t"] <= t1]

    res, busy = {}, {}

    async def run():
        loop = asyncio.get_running_loop()
        await node.start()
        try:
            await node.wait_for_height(2, timeout=120)
            reset_launches()
            tb0, h0 = time.monotonic(), node.block_store.height
            await node.wait_for_height(h0 + ADM_BASELINE, timeout=180)
            res["baseline"] = (vote_walls(tb0, time.monotonic()), node.block_store.height - h0)
            launches["tx_admission baseline"] = read_launches("tx_admission baseline", ())

            for name, tag, precheck in (("serial", "ser", False), ("batched", "bat", True)):
                arm["name"] = name
                mp_.sig_precheck = precheck
                before = (app.serial_verifies, app.precheck_consumed, mp_.prechecked_total)
                trace.tracer.clear()
                prof = (profile(activities=[ProfilerActivity.CUDA])
                        if name == "batched" and dev.type == "cuda" else None)
                if prof is not None:
                    prof.__enter__()
                reset_launches()
                tf0, h1 = time.monotonic(), node.block_store.height
                out = await loop.run_in_executor(None, flood, batches[tag],
                                                 time.monotonic() + ADM_FLOOD_S)
                tf1 = time.monotonic()
                if prof is not None:
                    torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                    rows = device_rows(prof)
                    busy.update(us=sum(e.self_device_time_total for e in rows),
                                kernels=sum(e.count for e in rows), wall_s=out[2])
                arm_fl = [f for f in adm_flushes if f["arm"] == name]
                ladder = ("padd", "pdbl", "fsquare_chain")
                need = (() if dev.type != "cuda" or not arm_fl else
                        ED25519_KERNELS if any(str(f["path"]).startswith("rlc") for f in arm_fl)
                        else ladder if any(f["path"] == "persig" for f in arm_fl) else ())
                launches[f"tx_admission {name}"] = read_launches(f"tx_admission {name}", need)
                events = [e["attrs"] for e in trace.tracer.dump()
                          if e["name"] == "batch_verify.flush" and e["attrs"]["n"] > 1]
                res[name] = dict(out=out, before=before, after=(
                    app.serial_verifies, app.precheck_consumed, mp_.prechecked_total),
                    votes=vote_walls(tf0, tf1), heights=node.block_store.height - h1,
                    events=events, log=[f for f in list(sched.flush_log) if tf0 <= f["t"] <= tf1])

            # the tampered batch: exactly its planted rows refused
            arm["name"] = "tampered"
            reset_launches()
            out = await loop.run_in_executor(None, lambda: mp_.check_tx_batch(
                adm["tam"], sender="tx-admission-tamper"))
            launches["tx_admission tampered"] = read_launches(
                "tx_admission tampered", () if dev.type != "cuda" else ("padd", "pdbl",
                                                                         "fsquare_chain"))
            res["tampered"] = [r.code if r is not None else None for r in out]
            key = tmhash.sum256(adm["tam"][0])
            for _ in range(40):  # its journey ends delivered within a few heights
                j = node.tx_tracker.waterfall(key)
                if j is not None and j["terminal"] is not None:
                    break
                await node.wait_for_height(node.block_store.height + 1, timeout=120)
            res["journey"] = node.tx_tracker.waterfall(key)
            res["exposition"] = [line for line in node.metrics.expose().splitlines()
                                 if line.startswith(("tendermint_mempool_",
                                                     "tendermint_consensus_height",
                                                     "tendermint_verify_lane_"))
                                 and "_bucket" not in line]
            res["scheduler"] = sched.stats()
        finally:
            await node.stop()

    try:
        asyncio.run(run())
        # the batched arm's widest flush and the tampered batch alone on a
        # quiet process (node stopped, memo off), warm: the same work with
        # no consensus loop or sender thread holding the GIL
        batch.configure_verified_memo(0)
        alone = {}
        for tag, f in (("widest", max((f for f in adm_flushes if f["arm"] == "batched"),
                                      key=lambda f: f["rows"], default=None)),
                       ("tampered", next((f for f in adm_flushes if f["arm"] == "tampered"),
                                         None))):
            if f is None:
                continue
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                mask = batch.verify_batch(*f["args"][:3], device=None if dev.type == "cuda"
                                          else dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if mask.tolist() != f["mask"].tolist():
                raise SystemExit(f"tx_admission: the {tag} flush alone gives another mask")
            alone[tag] = (f["rows"], batch.LAST_FLUSH.get("path"), times, f["ms"])
    finally:
        sched._verify_chunked = real_verify
        trace.tracer.configure(ring_size=cfg.instrumentation.trace_ring_size)
        batch.configure_verified_memo(0)
        forensics.configure(None)  # the node's heartbeat ring lives in tmp
        shutil.rmtree(tmp, ignore_errors=True)
    if node.consensus.halt_error is not None:
        raise SystemExit(f"tx_admission: consensus halted: {node.consensus.halt_error!r}")
    if node.prewarm_error is not None:
        raise SystemExit(f"tx_admission: prewarm error stored: {node.prewarm_error!r}")
    errors = [f for f in list(sched.flush_log) + res["batched"]["log"] if f["error"]]
    if errors:
        raise SystemExit(f"tx_admission: {len(errors)} scheduler flushes failed: {errors[0]}")
    run_s = time.perf_counter() - t_phase

    def pct(xs, p):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None

    def ms(x):
        return "n/a" if x is None else f"{x * 1e3:.3f} ms"

    rates = {}
    for name in ("serial", "batched"):
        r = res[name]
        ok, rej, wall = r["out"]
        rates[name] = ok / wall if wall else 0.0
        d = [a - b for a, b in zip(r["after"], r["before"])]
        print(f"tx_admission {name}: {ok} admitted, {rej} refused in {wall:.3f} s = "
              f"{rates[name]:.1f} admissions/s; {r['heights']} heights committed meanwhile; "
              f"serial_verifies +{d[0]}, precheck_consumed +{d[1]}, prechecked_total +{d[2]}; "
              f"launches {launches[f'tx_admission {name}']}", flush=True)
        if name == "serial" and (d[1] or d[2] or d[0] != ok + rej):
            raise SystemExit(f"tx_admission: the serial arm consumed verdicts: {d}")
        if name == "batched" and (d[0] or d[1] != ok + rej or d[2] != ok + rej):
            raise SystemExit(f"tx_admission: a batched-arm admission paid an app-side verify "
                             f"or consumed no verdict: {d}")
    print(f"tx_admission: batched/serial {rates['batched'] / rates['serial']:.2f}x; the serial "
          f"arm's per-tx verify is {'OpenSSL' if keys._HAVE_OPENSSL else 'pure Python'} "
          f"(keys._HAVE_OPENSSL={keys._HAVE_OPENSSL}); app serial_verifies="
          f"{app.serial_verifies} precheck_consumed={app.precheck_consumed} "
          f"mempool prechecked_total={mp_.prechecked_total}", flush=True)

    bat = [f for f in adm_flushes if f["arm"] == "batched"]
    if not bat:
        raise SystemExit("tx_admission: the batched arm made no admission flush")
    rows = [f["rows"] for f in bat]
    print(f"tx_admission batched flushes: {len(bat)}, rows min/median/max {min(rows)}/"
          f"{statistics.median(rows)}/{max(rows)}, routes "
          f"{dict(Counter(f'{f['path']}/{f['mode']}' for f in bat))}, ms median "
          f"{statistics.median(f['ms'] for f in bat):.1f} max {max(f['ms'] for f in bat):.1f}, "
          f"{sum(rows) / (sum(f['ms'] for f in bat) / 1e3):.0f} rows/s of flush time", flush=True)
    print("tx_admission batched flushes (rows, route/mode, ms): " + ", ".join(
        f"({f['rows']}, {f['path']}/{f['mode']}, {f['ms']:.1f})" for f in bat), flush=True)
    ev = res["batched"]["events"]
    print(f"tx_admission recorder (batched arm, flushes of more than 1 row): {len(ev)} flushes, "
          f"labels {dict(Counter(e['path'] for e in ev))}, "
          f"{sum(e['total_ms'] for e in ev):.1f} ms in all", flush=True)
    log_adm = [f for f in res["batched"]["log"] if "admission" in f["rows"]]
    print(f"tx_admission flush_log (batched arm): {len(log_adm)} flushes with admission rows, rows "
          f"min/median/max {min(f['rows']['admission'] for f in log_adm)}/"
          f"{statistics.median(f['rows']['admission'] for f in log_adm)}/"
          f"{max(f['rows']['admission'] for f in log_adm)}, wall median "
          f"{statistics.median(f['wall_s'] for f in log_adm) * 1e3:.1f} ms, admission wait p99 "
          f"{ms(pct([f['wait_s']['admission'] for f in log_adm], 0.99))}", flush=True)
    base_votes, base_h = res["baseline"]
    flood_votes = res["batched"]["votes"]
    print(f"tx_admission votes lane: baseline {len(base_votes)} flushes over {base_h} heights, "
          f"wall p99 {ms(pct(base_votes, 0.99))}; under the batched flood {len(flood_votes)} "
          f"flushes, wall p99 {ms(pct(flood_votes, 0.99))}; serial arm "
          f"{ms(pct(res['serial']['votes'], 0.99))}; preemptions "
          f"{res['scheduler']['preemptions']}", flush=True)
    print(f"tx_admission launches: baseline {launches['tx_admission baseline']}; tampered "
          f"{launches['tx_admission tampered']}", flush=True)
    if busy:
        if busy["us"] > 0:
            print(f"tx_admission batched profile: device_busy_ms={busy['us'] / 1e3:.2f} "
                  f"kernels={busy['kernels']} idle_share="
                  f"{1 - busy['us'] / 1e6 / busy['wall_s']:.3f} (window "
                  f"{busy['wall_s'] * 1e3:.1f} ms, the whole batched arm, profiled)", flush=True)
        else:
            print("tx_admission batched profile: the profiler recorded no device time (device "
                  "busy: not measured)", flush=True)

    for tag, (n, path, times, node_ms) in alone.items():
        print(f"tx_admission {tag} flush alone: {n} rows, {path}, "
              f"{', '.join(f'{t:.1f}' for t in times)} ms (warm, no node running) against "
              f"{node_ms:.1f} ms inside the node", flush=True)

    codes = res["tampered"]
    want = SignedKVStoreApplication.CODE_BAD_SIGNATURE
    if [i for i, c in enumerate(codes) if c == want] != list(ADM_TAMPERED) or any(
            c != 0 for i, c in enumerate(codes) if i not in ADM_TAMPERED):
        raise SystemExit(f"tx_admission: the tampered batch's codes are not exactly its planted "
                         f"rejections: {Counter(codes)}")
    tam = [f for f in adm_flushes if f["arm"] == "tampered"]
    print(f"tx_admission tampered: {len(codes) - len(ADM_TAMPERED)} admitted, rows "
          f"{list(ADM_TAMPERED)} refused with CODE_BAD_SIGNATURE; its flushes (rows, route/mode, "
          f"ms) " + ", ".join(f"({f['rows']}, {f['path']}/{f['mode']}, {f['ms']:.1f})"
                              for f in tam), flush=True)

    # every admission flush's mask against the host arm's on the same rows
    t_host = time.perf_counter()
    pieces = [(k, lo) for k, f in enumerate(adm_flushes) for lo in range(0, f["rows"], DRAIN)]
    masks = pool_map(pool, _host_masks, [tuple(a[lo:lo + DRAIN] for a in adm_flushes[k]["args"])
                                           for k, lo in pieces], workers)
    host = [[] for _ in adm_flushes]
    for (k, _), m in zip(pieces, masks):
        host[k] += m
    for f, want_mask in zip(adm_flushes, host):
        if f["mask"].tolist() != want_mask:
            raise SystemExit(f"tx_admission: a {f['rows']}-row admission flush ({f['path']}) "
                             "differs from the host arm's mask")
    # each committed block's LastCommit on the host arm
    bs = node.block_store
    jobs = []
    for h in range(2, bs.height + 1):
        c = bs.load_block(h).last_commit
        vals = node.state_store.load_validators(h - 1)
        idxs = [i for i, sg in enumerate(c.signatures) if not sg.absent()]
        jobs.append(([vals.validators[i].pub_key.bytes() for i in idxs],
                     c.vote_sign_bytes_many(gen.chain_id, idxs),
                     [c.signatures[i].signature for i in idxs], ["ed25519"] * len(idxs)))
    if not all(all(m) for m in pool_map(pool, _host_masks, jobs, workers)):
        raise SystemExit("tx_admission: a committed LastCommit fails on the host arm")
    host_s = time.perf_counter() - t_host
    print(f"tx_admission checks: {len(adm_flushes)} admission flushes "
          f"({sum(f['rows'] for f in adm_flushes)} rows) equal the host arm's masks; the "
          f"LastCommits of heights 2-{bs.height} verify on the host arm; no flush error, no "
          f"prewarm error, consensus did not halt", flush=True)
    print("tx_admission exposition: " + "; ".join(res["exposition"]), flush=True)
    j = res["journey"]
    print("tx_admission journey of tx " + (j["hash"][:16] if j else "?") + ": " + (", ".join(
        f"{st['stage']} +{st['offset_ms']:.1f} ms" for st in j["stages"]) if j else "not tracked"),
          flush=True)
    if not j or [st["stage"] for st in j["stages"]][-3:] != ["proposed", "committed", "delivered"]:
        raise SystemExit(f"tx_admission: the tracked tx's journey does not reach committed: {j}")
    print(f"tx_admission: {time.perf_counter() - t_phase + adm['sign_s']:.1f} s with signing "
          f"{adm['sign_s']:.1f} s apart (node run {run_s:.1f}, host checks {host_s:.1f})",
          flush=True)


LOCALNET_NODES, LOCALNET_HEIGHT, LOCALNET_TIMEOUT = 4, 3, 300.0


def free_port_block(n: int, seed: int) -> int:
    """A base port b with b .. b + n - 1 all free on 127.0.0.1 now."""
    import random
    import socket

    rng = random.Random(seed)
    for _ in range(200):
        base = rng.randrange(20_000, 60_000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise SystemExit(f"no {n} consecutive free ports")


def rpc_call(laddr: str, method: str, **params):
    import urllib.request

    req = urllib.request.Request(
        "http://" + laddr.replace("tcp://", ""),
        json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.load(resp)["result"]


def cli_localnet_phase(dev, launches: dict) -> None:
    """cli_localnet (module docstring 22b): the command line as a user runs
    it, four processes on one card."""
    import io
    import shutil
    import signal
    import tempfile
    import urllib.request

    from tendermint_tpu_torch.cli.main import load_home
    from tendermint_tpu_torch.cli.main import main as cli_main
    from tendermint_tpu_torch.config.toml import save_config
    from tendermint_tpu_torch.libs.metrics import parse_exposition

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cli_localnet-")
    base = free_port_block(3 * LOCALNET_NODES, SEED + 30)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["testnet", "--v", str(LOCALNET_NODES), "--output-dir",
                       os.path.join(root, "net"), "--chain-id", "cli-localnet",
                       "--starting-port", str(base)])
    nodes = json.loads(out.getvalue())
    if rc != 0 or len(nodes) != LOCALNET_NODES:
        raise SystemExit(f"cli_localnet: testnet exit {rc}: {out.getvalue()[-300:]}")
    prom = {}
    for i, nd in enumerate(nodes):
        cfg = load_home(nd["home"])
        cfg.instrumentation.prometheus = True
        prom[nd["home"]] = base + 2 * LOCALNET_NODES + i
        cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{prom[nd['home']]}"
        save_config(cfg, os.path.join(nd["home"], "config", "config.toml"))
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs, spawned = [], [], []

    def tail(i: int, n: int = 30) -> str:
        with open(logs[i], errors="replace") as f:
            return "".join(f.readlines()[-n:])

    try:
        for nd in nodes:
            logs.append(os.path.join(nd["home"], "node.log"))
            with open(logs[-1], "w") as log:
                spawned.append(time.perf_counter())
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tendermint_tpu_torch.cli", "--device", "cuda",
                     "--home", nd["home"], "start"],
                    cwd=here, stdout=log, stderr=subprocess.STDOUT))
        started, reached = [None] * LOCALNET_NODES, [None] * LOCALNET_NODES
        deadline = time.perf_counter() + LOCALNET_TIMEOUT
        while None in reached:
            if time.perf_counter() > deadline:
                raise SystemExit(f"cli_localnet: heights not all {LOCALNET_HEIGHT} after "
                                 f"{LOCALNET_TIMEOUT} s; started {started}\n" + "".join(
                                     f"--- node{i}\n{tail(i)}" for i in range(LOCALNET_NODES)))
            for i, nd in enumerate(nodes):
                if procs[i].poll() is not None:
                    raise SystemExit(f"cli_localnet: node{i} exited {procs[i].returncode}:\n"
                                     + tail(i))
                now = time.perf_counter()
                if started[i] is None:
                    with open(logs[i], errors="replace") as f:
                        if re.search(r"^node \S* ?started; chain", f.read(), re.M):
                            started[i] = now - spawned[i]
                if reached[i] is None and started[i] is not None:
                    try:
                        h = int(rpc_call(nd["rpc"], "status")["sync_info"]["latest_block_height"])
                    except OSError:
                        continue
                    if h >= LOCALNET_HEIGHT:
                        reached[i] = now - spawned[i]
            time.sleep(0.25)
        hashes = [[rpc_call(nd["rpc"], "block", height=h)["block_id"]["hash"]
                   for h in range(1, LOCALNET_HEIGHT + 1)] for nd in nodes]
        if any(hs != hashes[0] for hs in hashes):
            raise SystemExit(f"cli_localnet: blocks 1-{LOCALNET_HEIGHT} differ: {hashes}")
        card_flushes, paths = [], []
        for nd in nodes:
            url = f"http://127.0.0.1:{prom[nd['home']]}/metrics"
            with urllib.request.urlopen(url, timeout=5) as resp:
                fams = parse_exposition(resp.read().decode())
            fam = fams.get("tendermint_batch_verify_flushes_total", {"samples": []})
            by_path = {lab["path"]: int(v) for _, lab, v in fam["samples"]
                       if lab.get("backend") == "cuda"}
            card_flushes.append(sum(v for path, v in by_path.items() if path != "memo"))
            paths.append(by_path)
        if not all(card_flushes):  # the memo's answers launch nothing
            raise SystemExit(f"cli_localnet: a child ran no card flush: {paths}")
        for p in procs:
            p.send_signal(signal.SIGINT)
        codes = []
        for i, p in enumerate(procs):
            try:
                codes.append(p.wait(60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        if any(codes):
            raise SystemExit(f"cli_localnet: exit codes {codes} on SIGINT:\n" + "".join(
                f"--- node{i}\n{tail(i)}" for i, c in enumerate(codes) if c))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    print(f"cli_localnet: `cli testnet --v {LOCALNET_NODES}`, then {LOCALNET_NODES} children "
          f"`cli --device cuda --home <h> start`: spawn to \"node ... started\" "
          f"{[round(x, 1) for x in started]} s, to height {LOCALNET_HEIGHT} "
          f"{[round(x, 1) for x in reached]} s; blocks 1-{LOCALNET_HEIGHT} equal across the "
          f"{LOCALNET_NODES} ({hashes[0][-1][:16]}... at {LOCALNET_HEIGHT}); card flushes per "
          f"child {card_flushes} (by route {paths}); exit codes on SIGINT {codes}; "
          f"{time.perf_counter() - t_phase:.1f} s; card {card_name(dev)}", flush=True)


CHAOS_NODES, CHAOS_POISON, CHAOS_TIMEOUT = 4, 10_000, 240.0


def chaos_poison_10k_phase(dev, pool, workers: int, launches: dict) -> None:
    """chaos_poison_10k (module docstring 22c)."""
    import asyncio
    import random
    import shutil
    import tempfile

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.chaos import ChaosEngine, ChaosSchedule, FaultEvent
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto import batch, provenance
    from tendermint_tpu_torch.crypto import scheduler as sched
    from tendermint_tpu_torch.crypto.keys import gen_ed25519
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.p2p.behaviour import BAD_MESSAGE
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    t_phase = time.perf_counter()
    node_dev = None if dev.type == "cuda" else dev
    root = tempfile.mkdtemp(prefix="chaos_poison_10k-")
    privs = [gen_ed25519(bytes([40 + i]) * 32) for i in range(CHAOS_NODES)]
    gen = GenesisDoc(chain_id="chaos-poison-10k",
                     validators=[GenesisValidator(p.pub_key(), 10) for p in privs])

    def make_node(i):
        cfg = test_config()
        cfg.base.db_backend = "sqlite"  # a crashed node restarts from its own stores
        cfg.base.fast_sync = False
        cfg.rpc.laddr = ""
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.plaintext = True
        cfg.p2p.pex = False
        cfg.root_dir = os.path.join(root, f"node{i}")
        os.makedirs(cfg.root_dir, exist_ok=True)
        cfg.consensus.defer_vote_verification = True
        cfg.instrumentation.forensics_dir = ""
        cfg.crypto.verified_memo_rows = 0
        return Node(cfg, gen, priv_validator=FilePV(
            privs[i], state_file=os.path.join(root, f"pv_state_{i}.json")),
            app=KVStoreApplication(), device=node_dev)

    # the schedule: seeded times and targets; the poisoner is never crashed
    rng = random.Random(SEED + 40)
    order = rng.sample(range(CHAOS_NODES), CHAOS_NODES)
    poisoner, crashed, lonely = order[0], order[1], order[2]
    t = 1.0 + round(rng.uniform(0.0, 0.5), 3)
    part = round(rng.uniform(1.0, 2.0), 3)
    down = round(rng.uniform(1.0, 2.0), 3)
    events = [
        FaultEvent.make(t, "partition", groups=[[i for i in range(CHAOS_NODES) if i != lonely],
                                                [lonely]]),
        FaultEvent.make(t + part, "heal"),
        FaultEvent.make(t + part + 0.5, "crash", target=crashed, wal_fault="truncate"),
        FaultEvent.make(t + part + 0.5 + down, "restart", target=crashed),
        FaultEvent.make(t + part + 1.5 + down, "sig_poison", target=poisoner,
                        count=CHAOS_POISON, burst=True),
    ]
    schedule = ChaosSchedule(SEED + 40, events)
    poison_sigs = {privs[poisoner].sign(b"tmtpu-sig-poison:" + i.to_bytes(4, "big"))
                   for i in range(CHAOS_POISON)}

    # every verify_batch call (the scheduler's lane flushes): rows, mask,
    # route, lane, ms
    flushes = []
    lanes_now = threading.local()
    real_vb, real_flush = batch.verify_batch, sched.VerifyScheduler._flush

    def vb(pks, msgs, sigs, device=None, key_types=None, backend=None, **kw):
        t0 = time.perf_counter()
        mask = real_vb(pks, msgs, sigs, device, key_types, backend, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        flushes.append(dict(rows=(list(pks), list(msgs), list(sigs),
                                  list(key_types) if key_types is not None else
                                  ["ed25519"] * len(pks)),
                            mask=np.asarray(mask, bool), path=batch.LAST_FLUSH.get("path"),
                            lane=",".join(sorted(getattr(lanes_now, "lanes", ()) or ("-",))),
                            ms=ms))
        return mask

    def flush(self, entries, lanes):
        lanes_now.lanes = tuple(lanes)
        try:
            return real_flush(self, entries, lanes)
        finally:
            lanes_now.lanes = ()

    punished = []

    def on_punish(src, info):
        punished.append((time.perf_counter(), src, dict(info)))

    flood = {}
    state = {}

    async def drive():
        net = LocalChaosNet(make_node, CHAOS_NODES)
        real_poison = net.sig_poison

        async def sig_poison(**kw):
            flood["t0"] = time.perf_counter()
            flood["height"] = net.nodes[poisoner].consensus.rs.height
            await real_poison(**kw)
            flood["sent"] = time.perf_counter()

        net.sig_poison = sig_poison
        await net.start()
        try:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            while net.min_height() < 1:
                if loop.time() - t0 > CHAOS_TIMEOUT:
                    raise SystemExit("chaos_poison_10k: the net did not commit height 1")
                await asyncio.sleep(0.05)
            for node in net.live_nodes():
                if node._prewarm_thread is not None:
                    await loop.run_in_executor(None, node._prewarm_thread.join)
            reset_launches()
            engine = ChaosEngine(schedule, net)
            t_run = time.perf_counter()
            await engine.start()
            state["schedule_s"] = time.perf_counter() - t_run
            if engine.errors:
                raise SystemExit(f"chaos_poison_10k: engine errors {engine.errors}")
            top = net.max_height()
            t1 = loop.time()
            while not all(n.block_store.height >= top + 2 for n in net.live_nodes()):
                for n in net.live_nodes():
                    n.raise_failures()
                if loop.time() - t1 > CHAOS_TIMEOUT:
                    raise SystemExit(f"chaos_poison_10k: stalled at "
                                     f"{[n.block_store.height for n in net.live_nodes()]} "
                                     f"(top {top})")
                await asyncio.sleep(0.05)
            state["after_s"] = time.perf_counter() - t_run
            if dev.type == "cuda":
                torch.cuda.synchronize()
            net.assert_safety()
            state["heights"] = [n.block_store.height for n in net.live_nodes()]
            state["top"] = top
            state["applied"] = [e.kind for e in engine.applied]
            state["poisoner_id"] = net.nodes[poisoner].node_key.id
            state["reports"] = {i: [(pb.peer_id, pb.kind) for pb in n.switch.reporter.history]
                                for i, n in enumerate(net.nodes) if i != poisoner}
            for n in net.live_nodes():
                n.raise_failures()
        finally:
            await net.stop()

    provenance.default_scorer().reset()
    provenance.default_scorer().add_punish_callback(on_punish)
    batch.verify_batch, sched.VerifyScheduler._flush = vb, flush
    try:
        asyncio.run(drive())
    finally:
        batch.verify_batch, sched.VerifyScheduler._flush = real_vb, real_flush
        provenance.default_scorer().remove_punish_callback(on_punish)
        shutil.rmtree(root, ignore_errors=True)
    run_s = time.perf_counter() - t_phase

    src = f"peer:{state['poisoner_id']}"
    mine = [(t, info) for t, s_, info in punished if s_ == src]
    if not mine or mine[0][1].get("quarantines", 0) < 1:
        raise SystemExit(f"chaos_poison_10k: {src} was not quarantined and punished: "
                         f"{punished}; scorer {provenance.default_scorer().stats()}")
    for i, reps in state["reports"].items():
        if (state["poisoner_id"], BAD_MESSAGE) not in reps:
            raise SystemExit(f"chaos_poison_10k: node{i}'s reporter holds no {BAD_MESSAGE} of "
                             f"the poisoner: {reps[:8]}")
    poisoned = []
    for f in flushes:
        idx = [k for k, sg in enumerate(f["rows"][2]) if sg in poison_sigs]
        if idx:
            f["poisoned"] = idx
            poisoned.append(f)
    if not poisoned:
        raise SystemExit("chaos_poison_10k: no flush held a poisoned row")
    for f in poisoned:
        n = len(f["mask"])
        if f["mask"][f["poisoned"]].any():
            raise SystemExit(f"chaos_poison_10k: a poisoned row passed in a {n}-row flush")
        if n >= 256 and f["path"] == "cpu":
            raise SystemExit(f"chaos_poison_10k: a {n}-row poisoned flush took the host arm")
    card = [f for f in poisoned if f["path"] != "cpu"]
    if not card:
        raise SystemExit("chaos_poison_10k: no poisoned flush ran on the card")
    kernels = (ED25519_KERNELS if any(f["path"].startswith("rlc") for f in card)
               else ("padd", "pdbl", "fsquare_chain"))
    launches["chaos_poison_10k"] = read_launches("chaos_poison_10k", kernels)
    reset_launches()

    # every flush's mask against the host arm's: each distinct row once
    t_host = time.perf_counter()
    index = {}
    for f in flushes:
        for row in zip(*f["rows"]):
            index.setdefault(row, len(index))
    order_rows = list(index)
    masks = pool_map(pool, _host_masks, [tuple(map(list, zip(*order_rows[lo:lo + DRAIN])))
                                           for lo in range(0, len(order_rows), DRAIN)], workers)
    verdict = dict(zip(order_rows, (ok for m in masks for ok in m)))
    for f in flushes:
        if f["mask"].tolist() != [verdict[row] for row in zip(*f["rows"])]:
            raise SystemExit(f"chaos_poison_10k: a {len(f['mask'])}-row mask differs from the "
                             "host arm's")
    host_s = time.perf_counter() - t_host

    n_rows = sum(len(f["poisoned"]) for f in poisoned)
    print(f"chaos_poison_10k schedule: seed {schedule.seed} fingerprint "
          f"{schedule.fingerprint()}, {[(e.at, e.kind, e.param_dict()) for e in schedule]}; "
          f"poisoner node{poisoner}, crashed node{crashed}, partitioned node{lonely}; applied "
          f"{state['applied']}; schedule {state['schedule_s']:.1f} s, two heights past its top "
          f"({state['top']}) at {state['after_s']:.1f} s; heights {state['heights']}", flush=True)
    print(f"chaos_poison_10k flood: {CHAOS_POISON} votes at height {flood['height']} into "
          f"{CHAOS_NODES - 1} peers, built and written in "
          f"{(flood['sent'] - flood['t0']) * 1e3:.1f} ms; {n_rows} poisoned rows reached "
          f"{len(poisoned)} flushes ({len(card)} on the card); the flood to the punishment "
          f"{(mine[0][0] - flood['t0']) * 1e3:.1f} ms (punish info {mine[0][1]}); poisoned "
          f"flushes (rows, poisoned, route, lane, ms) "
          f"{[(len(f['mask']), len(f['poisoned']), f['path'], f['lane'], round(f['ms'], 1)) for f in poisoned]}",
          flush=True)
    other = [f for f in flushes if "poisoned" not in f]
    print(f"chaos_poison_10k: {len(other)} other flushes (rows {sum(len(f['mask']) for f in other)}, "
          f"routes {sorted({f['path'] for f in other})}); launches "
          f"{launches['chaos_poison_10k']}; {len(flushes)} masks over {len(order_rows)} distinct "
          f"rows equal the host arm's ({sum(not v for v in verdict.values())} False, all "
          f"poisoned); {run_s:.1f} s (host checks {host_s:.1f}); card {card_name(dev)}",
          flush=True)
    if any(not v and row[2] not in poison_sigs for row, v in verdict.items()):
        raise SystemExit("chaos_poison_10k: a row other than the poisoned ones is False")


# fleet_smoke_7: the reference's tier-1 fleet smoke spec (tests/test_fleet_soak.py
# _smoke_spec), seed 20260807; its acceptance soak's 50 nodes and 20 heights cut
# to 7 nodes and the smoke's 6 heights
FLEET_SEED, FLEET_NODES, FLEET_MIN_HEIGHTS, FLEET_DEADLINE_S = 20260807, 7, 6, 240.0
FLEET_SPEC_KW = dict(validator_frac=0.58, light_frac=0.15, joiner_frac=0.5, bls_validators=0,
                     statesync_joiners=0, poisoners=1, peer_degree=3, episodes=2, min_gap=0.5,
                     max_gap=1.0, min_episode=0.8, max_episode=1.5, start_delay=0.5,
                     join_window=(2.0, 4.0),
                     chaos_kinds=("partition", "peer_stall", "sig_poison"))


def fleet_smoke_7_phase(dev, pool, workers: int, launches: dict) -> None:
    """fleet_smoke_7 (module docstring 22d)."""
    import asyncio
    import io
    import shutil
    import tempfile

    from tendermint_tpu_torch.chaos import fleet
    from tendermint_tpu_torch.chaos.harness import LocalChaosNet
    from tendermint_tpu_torch.crypto import provenance
    from tendermint_tpu_torch.libs.metrics import fleet_metrics
    from tendermint_tpu_torch.tools import chain_observatory as obs
    from tendermint_tpu_torch.tools import fleet_referee, release_gate

    t_phase = time.perf_counter()
    # the card with the reference's routing, as the other node phases: with
    # every node's device the card the in-process fleet does not fit the
    # limit (tools/fleet_probe.py measures it)
    node_dev = None if dev.type == "cuda" else dev
    spec = fleet.FleetSpec.generate(FLEET_SEED, FLEET_NODES, **FLEET_SPEC_KW)
    root = tempfile.mkdtemp(prefix="fleet_smoke_7-")
    fm = fleet_metrics()

    def fleet_series() -> dict:
        return {"safety_checks": fm.safety_checks._values.get((), 0.0),
                **{f"verdict {k[0]}": v for k, v in fm.referee_verdicts._values.items()}}

    # the suspicion scorer is process-global and chaos_poison_10k left its
    # poisoner quarantined: this fleet's adversary starts from a clean slate
    scorer = provenance.default_scorer()
    scorer.reset()
    marks, ever = {}, set()  # every source quarantined during the soak
    real_record = scorer.record_rows

    def record_rows(sources, mask):
        real_record(sources, mask)
        q = scorer.quarantined_sources()
        ever.update(q)
        if "quarantine" not in marks and q:
            marks["quarantine"] = (time.perf_counter(), sorted(q))

    def on_punish(src, info):
        marks.setdefault("punish", (time.perf_counter(), src))

    real_poison = LocalChaosNet.sig_poison

    async def sig_poison(self, **kw):
        marks.setdefault("flood", time.perf_counter())
        await real_poison(self, **kw)

    # each node's scheduler flushes carry its index into the recorder's lane
    rec = FlushRecorder("fleet_smoke_7", ("soak",), launches)
    node_now = threading.local()
    rec.lane_now = lambda: getattr(node_now, "label", None) or "direct"
    real_start = fleet.FleetNet._start_node

    async def start_node(self, i):
        await real_start(self, i)
        sch = self.nodes[i].scheduler
        real_flush = sch._flush

        def flush(entries, lanes, _i=i, _real=real_flush):
            prev = getattr(node_now, "label", None)
            node_now.label = f"node{_i} {'+'.join(sorted(lanes))}"
            try:
                return _real(entries, lanes)
            finally:
                node_now.label = prev

        sch._flush = flush
        real_rows = sch.verify_rows

        def verify_rows(lane, *a, _i=i, _real=real_rows, **kw):
            # the votes lane flushes inline on the caller's thread
            prev = getattr(node_now, "label", None)
            node_now.label = f"node{_i} {lane}"
            try:
                return _real(lane, *a, **kw)
            finally:
                node_now.label = prev

        sch.verify_rows = verify_rows

    before = fleet_series()
    scorer.record_rows = record_rows
    scorer.add_punish_callback(on_punish)
    LocalChaosNet.sig_poison, fleet.FleetNet._start_node = sig_poison, start_node
    rec.install()
    try:
        rec.window = "soak"
        reset_launches()
        t_run = time.perf_counter()
        res = asyncio.run(fleet.run_fleet_soak(spec, root, min_heights=FLEET_MIN_HEIGHTS,
                                               deadline_s=FLEET_DEADLINE_S, device=node_dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        soak_s = time.perf_counter() - t_run
        routes = {r["path"] for r in rec.recorded}
        rec.close("soak", kernels=("padd", "pdbl", "fsquare_chain")
                  if routes - {"cpu", "memo"} else ())
        rec.window = "after"
        after = fleet_series()
        dumps_dir = res["dumps_dir"]
        dumps = obs.load_dumps(dumps_dir)
        with contextlib.redirect_stdout(io.StringIO()):
            cli_rc = fleet_referee.main(["--dumps", dumps_dir, "--check"])
        with open(os.path.join(dumps_dir, "fleet_report.json")) as f:
            cli_report = json.load(f)
        gate = release_gate.evaluate(fleet_dumps=dumps_dir, skip_perf=True)
    finally:
        rec.uninstall()
        LocalChaosNet.sig_poison, fleet.FleetNet._start_node = real_poison, real_start
        scorer.record_rows = real_record
        scorer.remove_punish_callback(on_punish)
        shutil.rmtree(root, ignore_errors=True)

    report = res["report"]
    poisoner = next(ns.index for ns in spec.nodes if ns.poisoner)
    tag = f"peer:{res['poisoners'][poisoner]}"
    sus = res["suspicion"]
    (joiner,) = res["joiners"].values()
    card = [r for r in rec.recorded if r["path"] not in ("cpu", "memo")]
    checks = after["safety_checks"] - before["safety_checks"]
    card_line = card_name(dev)
    heights = {d.get("moniker"): (d.get("chain") or {}).get("height") for d in dumps}
    print(f"fleet_smoke_7 spec: seed {spec.seed} fingerprint {spec.fingerprint()} schedule "
          f"{spec.schedule.fingerprint()} {[(e.at, e.kind, e.param_dict()) for e in spec.schedule]}"
          f"; roles {[(ns.index, ns.role, ns.sync_mode, ns.join_at, ns.poisoner) for ns in spec.nodes]}",
          flush=True)
    print(f"fleet_smoke_7 heights by node: {heights}; head {res['heights']}, the joiner "
          f"{joiner}; soak {soak_s:.1f} s ({res['elapsed_s']} s in run_fleet_soak); "
          f"workload {res['workload']}; chaos applied {res['chaos_applied']}", flush=True)
    by_node = {}
    for r in rec.recorded:
        by_node.setdefault(r["lane"], []).append(r)
    for label, rs in sorted(by_node.items()):
        print(f"fleet_smoke_7 flushes of {label}: {len(rs)} flushes, {sum(r['rows'] for r in rs)} "
              f"rows, {sum(r['ms'] for r in rs):.1f} ms (median "
              f"{statistics.median(r['ms'] for r in rs):.1f}); (rows, route, ms), the first 24 "
              f"{[(r['rows'], r['path'], round(r['ms'], 1)) for r in rs[:24]]}", flush=True)
    flood = marks.get("flood")
    q_at, q_src = marks.get("quarantine", (None, None))
    p_at, p_src = marks.get("punish", (None, None))
    print(f"fleet_smoke_7 poison: {tag} (node{poisoner}); flood to quarantine "
          f"{(q_at - flood) * 1e3 if flood and q_at else float('nan'):.1f} ms (quarantined "
          f"{q_src}), flood to punishment "
          f"{(p_at - flood) * 1e3 if flood and p_at else float('nan'):.1f} ms ({p_src}); "
          f"scorer {sus}", flush=True)
    print(f"fleet_smoke_7 fleet series: before {before}, after {after}; nodes_by_role "
          f"{ {k[0]: v for k, v in fm.nodes_by_role._values.items()} }", flush=True)
    print(f"fleet_smoke_7 referee: verdict {report['verdict']}, safety "
          f"{report['safety']['heights_checked']} heights over "
          f"{report['safety']['nodes_audited']} nodes, {len(report['safety']['violations'])} "
          f"violations; waterfall {report['waterfall']['per_node']}; role SLO "
          f"{report['role_slo']}; tripped objectives "
          f"{[(e['node'], e['objective'], e['breaches'], e['worst_s']) for e in report['observatory']['slo'] if e['tripped']]}; "
          f"quarantine {report['quarantine']}; the CLI exit {cli_rc} "
          f"and the release gate ({gate['verdict']}, exit {gate['exit_code']}, perf "
          f"{gate['gates']['perf']['status']}) agree", flush=True)
    if res["verdict"] != "pass" or res["safety_violations"] != 0:
        raise SystemExit(f"fleet_smoke_7: verdict {res['verdict']}, "
                         f"{res['safety_violations']} safety violations; SLO "
                         f"{report['role_slo']}; coverage {report['coverage']}")
    # a source is paroled after 64 clean rows (the poisoner votes honestly
    # too): what was quarantined during the soak is the record
    if ever != {tag} or sus["punished"] < 1 or (tag not in sus["quarantined"]
                                                and sus["paroles"] < 1):
        raise SystemExit(f"fleet_smoke_7: the poisoner {tag} was not the one source quarantined "
                         f"and punished: quarantined during the soak {sorted(ever)}; {sus}")
    if (res["heights"] < FLEET_MIN_HEIGHTS or res["live_nodes"] != FLEET_NODES
            or res["chaos_errors"] or res["chaos_applied"] < len(spec.schedule)):
        raise SystemExit(f"fleet_smoke_7: heights {res['heights']}, live {res['live_nodes']}, "
                         f"chaos {res['chaos_applied']} applied, errors {res['chaos_errors']}")
    if joiner["height"] is None or joiner["height"] < res["heights"] - 2:
        raise SystemExit(f"fleet_smoke_7: the joiner is at {joiner['height']}, the head at "
                         f"{res['heights']}")
    if report["coverage"]["partial"] or report["waterfall"]["uncovered"]:
        raise SystemExit(f"fleet_smoke_7: coverage {report['coverage']}, uncovered "
                         f"{report['waterfall']['uncovered']}")
    if (cli_rc != 0 or cli_report["verdict"] != report["verdict"]
            or cli_report["safety"] != report["safety"]
            or gate["exit_code"] != 0 or gate["verdict"] != "pass"
            or gate["gates"]["fleet"]["status"] != report["verdict"]
            or gate["gates"]["perf"]["status"] != "skipped"):
        raise SystemExit(f"fleet_smoke_7: the referee CLI (exit {cli_rc}, "
                         f"{cli_report['verdict']}) and the release gate ({gate['verdict']}, "
                         f"{gate['gates']}) do not agree with the soak's {report['verdict']}")
    if checks != report["safety"]["heights_checked"] or checks < 1:
        raise SystemExit(f"fleet_smoke_7: fleet_safety_checks_total moved {checks}, the audit "
                         f"compared {report['safety']['heights_checked']} heights")

    t_host = time.perf_counter()
    verdict = rec.host_check(pool, workers)
    host_s = time.perf_counter() - t_host

    print(f"fleet_smoke_7 checks: {len(rec.recorded)} masks ({len(card)} on the card, routes "
          f"{sorted({r['path'] for r in rec.recorded})}) over {len(verdict)} distinct rows equal "
          f"the host arm's ({sum(not v for v in verdict.values())} False); launches "
          f"{launches['fleet_smoke_7 soak']}; {time.perf_counter() - t_phase:.1f} s (soak "
          f"{soak_s:.1f}, host checks {host_s:.1f}); card {card_line}", flush=True)


MESH_SHARDS = 4  # shards of the one card: the reference's mesh of 4 chips
MESH_TAMPERED = 4_242  # the one flipped signature of the sharded bisection
MESH_STREAM_TILES = 2  # the commit's rows twice: 20,000 rows, 2 planner chunks


def mesh_auto_arm(dev, corpus, host, host_tampered, run) -> None:
    """The several-card arm of mesh_10k: the reference's "auto" mesh
    (batch._sharded_env unpinned) over the distinct healthy cards, on a
    machine with two or more: the clean rows ("rlc-sharded"), the rows with
    MESH_TAMPERED flipped (the bisection over the real mesh) and the rows
    tiled MESH_STREAM_TILES times ("rlc-sharded-streamed"), each mask equal
    to the host arm's (`host`, `host_tampered`). `run(path, fn)` zeroes the
    counts before fn and reads them after. On one card the mesh must not
    stand, and the arm prints that it did not run."""
    from tendermint_tpu_torch.crypto import batch

    vals, _, commit, msgs = corpus
    pks = [v.pub_key.bytes() for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    env = batch._sharded_env()
    if cards < 2:
        if env is not None:
            raise SystemExit("mesh_10k: the auto mesh stood on one card")
        print(f"mesh_10k auto: not run ({cards} card; the several-card arm needs 2 or "
              f"more), _sharded_env() is None, ladder {batch.mesh_ladder_state()}", flush=True)
        return
    nd = 1 << (cards.bit_length() - 1)
    if env is None or env.nd != nd or env.mesh.keys != [f"cuda:{i}" for i in range(nd)]:
        raise SystemExit(f"mesh_10k auto: {cards} cards gave the mesh {env and env.mesh.keys}")
    bad = list(sigs)
    bad[MESH_TAMPERED % len(sigs)] = flip(bad[MESH_TAMPERED % len(sigs)])
    tiles = MESH_STREAM_TILES
    for path, rows, want, label in (
            ("mesh auto", (pks, msgs, sigs), host, "rlc-sharded"),
            ("mesh auto tampered", (pks, msgs, bad), host_tampered, "rlc-bisect"),
            ("mesh auto streamed", tuple(list(x) * tiles for x in (pks, msgs, sigs)),
             np.tile(host, tiles), "rlc-sharded-streamed")):
        mask, ms, f = run(path, lambda: batch.verify_batch(*rows, device=dev))
        if mask.tobytes() != want.tobytes() or f.get("path") != label:
            raise SystemExit(f"{path} over {nd} cards: mask or path wrong: {f}")
        print(f"{path}: {nd} cards {env.mesh.keys}, {len(rows[0])} rows, {ms:.1f} ms, path "
              f"{f['path']}, mask == host arm", flush=True)
    print(f"mesh_10k auto: ladder {batch.mesh_ladder_state()}", flush=True)


def mesh_10k_phase(dev, corpus, bls: dict, pool, workers: int, launches: dict,
                   card: dict, rows: list) -> list:
    """mesh_10k (module docstring 22e): the sharded mesh on MESH_SHARDS
    shards of the one card, pinned as the reference's tests pin theirs
    (batch._sharded_env -> _build_sharded_env([card] * 4)). Returns the
    kernel rows of the fp381_mul shapes its sharded BLS fold gives that no
    row of `rows` has (the Ed25519 shapes get theirs from recorded_rows)."""
    from tendermint_tpu_torch.chaos import DeviceFaultInjector
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import bls_ref as B
    from tendermint_tpu_torch.ops import bls12_torch as G
    from tendermint_tpu_torch.parallel import health, sharded
    from tendermint_tpu_torch.parallel import telemetry as mesh_tm
    from tendermint_tpu_torch.types.validator_set import _bls_pubkey_entry

    t_phase = time.perf_counter()
    vals, block_id, commit, msgs = corpus
    pks = [v.pub_key.bytes() for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    powers = [v.voting_power for v in vals.validators]
    n = len(pks)
    card0 = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    shard_devs = [card0] * MESH_SHARDS
    lanes = 2 * batch._sharded_lanes(n, MESH_SHARDS)  # 20,480 at 10k rows: 4 x 5,120
    tampered = MESH_TAMPERED % n

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def host_mask(p, m, s):
        part = pool_map(pool, _host_masks, [
            (p[lo:lo + DRAIN], m[lo:lo + DRAIN], s[lo:lo + DRAIN], ["ed25519"] * len(p[lo:lo + DRAIN]))
            for lo in range(0, len(p), DRAIN)], workers)
        return np.array([ok for f in part for ok in f], dtype=bool)

    def run(path, fn, kernels=ED25519_KERNELS, per_call=False):
        """fn() with the counts zeroed just before and read just after;
        per_call: the counts must be the same on every call of the path."""
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches(path, kernels)
        if per_call:
            same_counts(launches, path, counts)
        else:
            launches[path] = counts
        return out, ms, dict(batch.LAST_FLUSH)

    def pin(env):
        batch._sharded_env = lambda: env
        return env

    real_env = batch._sharded_env
    memo = batch.verified_memo_stats()["capacity"]
    stream = batch._stream_enabled()
    batch.configure_verified_memo(0)
    health.MESH_HEALTH.reset()
    mesh_tm.reset()
    inj = None
    new_rows = []
    steps = {}  # seconds of each step, for the phase's breakdown

    def step(name, t0):
        steps[name] = round(time.perf_counter() - t0, 1)
        return time.perf_counter()

    t_step = time.perf_counter()
    try:
        # the single-card rlc mask and the host arm's, before the mesh stands
        batch.configure_prep(stream=False)
        single, single_ms, f = run("mesh single rlc", lambda: batch.verify_batch(
            pks, msgs, sigs, device=dev))
        if f.get("path") != "rlc":
            raise SystemExit(f"mesh_10k: the single-card flush took {f.get('path')}, not rlc")
        host = host_mask(pks, msgs, sigs)
        if single.tobytes() != host.tobytes() or not single.all():
            raise SystemExit("mesh_10k: the single-card rlc mask differs from the host arm's")
        t_step = step("single card and host", t_step)

        env = pin(batch._build_sharded_env(shard_devs))
        mesh = env.mesh
        print(f"mesh_10k: mesh of {mesh.size} shards {mesh.keys} on {card0}", flush=True)
        batch.verify_batch(pks, msgs, sigs, device=dev)  # warm: the sharded shapes
        times = []
        for _ in range(3):
            mask, ms, f = run("mesh_rlc_sharded", lambda: batch.verify_batch(
                pks, msgs, sigs, device=dev), per_call=True)
            times.append(ms)
            if mask.tobytes() != single.tobytes():
                raise SystemExit("mesh_10k: the rlc-sharded mask differs from the single-card one")
            lf = mesh_tm.mesh_stats()["last_flush"]
            if not (f.get("path") == "rlc-sharded" and f.get("shards") == MESH_SHARDS
                    and f.get("lanes") == lanes and f.get("shard_lanes") == lanes // MESH_SHARDS
                    and lf["kind"] == "rlc" and lf["shards"] == MESH_SHARDS
                    and lf["lanes_per_shard"] == lanes // MESH_SHARDS and lf["ok"] is True):
                raise SystemExit(f"mesh_10k: rlc-sharded flush wrong: {f}, mesh record {lf}")
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        sync()
        commit_ms = (time.perf_counter() - t0) * 1e3
        launches["mesh verify_commit"] = read_launches("mesh verify_commit")
        if batch.LAST_FLUSH.get("path") != "rlc-sharded":
            raise SystemExit(f"mesh_10k: verify_commit took {batch.LAST_FLUSH.get('path')}")
        tally = sum(p for p, ok in zip(powers, single) if ok)
        print(f"mesh_10k rlc-sharded {n} rows: median_ms={statistics.median(times):.1f} "
              f"ms={[round(t, 1) for t in times]} (single-card rlc {single_ms:.1f} ms) "
              f"verify_commit_ms={commit_ms:.1f} tally={tally} lanes {MESH_SHARDS} x "
              f"{lanes // MESH_SHARDS}, "
              f"mask == single-card rlc == host arm; launches per call="
              f"{launches['mesh_rlc_sharded']}", flush=True)
        t_step = step("rlc-sharded", t_step)

        # one flipped signature: the combined check fails, the bisection runs
        # over sharded halves, the leaf on the sharded ladder
        bad = list(sigs)
        bad[tampered] = flip(bad[tampered])
        mask, ms, f = run("mesh_tampered", lambda: batch.verify_batch(pks, msgs, bad, device=dev))
        host_bad = host_mask(pks, msgs, bad)
        if (mask.tobytes() != host_bad.tobytes()
                or tuple(np.flatnonzero(~mask)) != (tampered,)
                or f.get("path") != "rlc-bisect" or not f.get("rlc_fallback")):
            raise SystemExit(f"mesh_10k tampered: False at {np.flatnonzero(~mask)}, flush {f}")
        print(f"mesh_10k tampered row {tampered}: ms={ms:.1f} path={f['path']} "
              f"recovery_flushes={f['recovery_flushes']} recovery_ms="
              f"{f['recovery_s'] * 1e3:.1f}, mask == host arm; launches="
              f"{launches['mesh_tampered']}", flush=True)
        t_step = step("tampered", t_step)

        # over the planner's budget: the combined check streams across the mesh
        spks, smsgs, ssigs = (list(x) * MESH_STREAM_TILES for x in (pks, msgs, sigs))
        smask, ms, f = run("mesh_streamed", lambda: batch.verify_batch(
            spks, smsgs, ssigs, device=dev))
        if (smask.tobytes() != np.tile(host, MESH_STREAM_TILES).tobytes()
                or f.get("path") != "rlc-sharded-streamed"
                or f.get("chunks") != len(batch._planner_chunks(len(spks)))
                or f.get("shards") != MESH_SHARDS
                or f.get("shard_lanes") != batch.planner_budget() // MESH_SHARDS):
            raise SystemExit(f"mesh_10k streamed: mask or flush wrong: {f}")
        print(f"mesh_10k rlc-sharded-streamed {len(spks)} rows: ms={ms:.1f} chunks={f['chunks']} "
              f"chunk_lanes={f['chunk_lanes']} shard_lanes={f['shard_lanes']} "
              f"peak_lanes_in_flight={f['peak_lanes_in_flight']} prep_ms={f['prep_s'] * 1e3:.1f} "
              f"prep_wait_ms={f['prep_wait_s'] * 1e3:.1f}, mask == host arm; launches="
              f"{launches['mesh_streamed']}", flush=True)
        t_step = step("streamed", t_step)

        # the commit step: the ladder per shard and the power planes' tally
        a, r, s_d, h_d, precheck, _ = batch.prepare_batch(pks, msgs, sigs)
        planes = sharded.split_powers(powers + [0] * (a.shape[1] - n))
        (cmask, ok), ms, _ = run("mesh_commit_step", lambda: sharded.sharded_commit_step(mesh)(
            a, r, s_d, h_d, planes), kernels=("padd", "pdbl", "fsquare_chain"))
        cmask = cmask[:n] & precheck
        step_tally = sum(p for p, v in zip(powers, cmask) if v)
        if cmask.tobytes() != host.tobytes() or step_tally != tally or ok is not True:
            raise SystemExit(f"mesh_10k commit step: ok {ok}, tally {step_tally} vs "
                             f"verify_commit's {tally}, or its mask differs")
        print(f"mesh_10k sharded_commit_step {n} rows ({a.shape[1] // MESH_SHARDS} lanes a "
              f"shard): ms={ms:.1f} ok={ok} tally={step_tally} == verify_commit's, mask == host "
              f"arm; launches={launches['mesh_commit_step']}", flush=True)
        t_step = step("commit step", t_step)

        # the BLS aggregate key folded a shard at a time
        entries = [_bls_pubkey_entry(v.pub_key.bytes()) for v in bls["vals"].validators]
        coords = [e[0] for e in entries]
        bitmap = [True] * len(coords)
        apk, ms, _ = run("mesh_bls_fold", lambda: sharded.aggregate_bitmap_sharded(
            coords, bitmap, mesh=mesh), kernels=("fp381_mul",))
        whole = G.fold_points(np.stack([e[1] for e in entries], axis=-1), dev)
        acc = B.G1_IDENTITY
        for x, y in coords:
            acc = B._jac_add(acc, (B._G1Field(x), B._G1Field(y), B._G1Field(1)))
        ref = B._jac_to_affine(acc)
        if not apk == whole == (ref[0].v, ref[1].v):
            raise SystemExit("mesh_10k: aggregate_bitmap_sharded differs from the single-card "
                             "fold or bls_ref's sum")
        with recorded_products() as seen:
            sharded.aggregate_bitmap_sharded(coords, bitmap, mesh=mesh)
        print(f"mesh_10k aggregate_bitmap_sharded {len(coords)} keys on {mesh.size} shards: "
              f"ms={ms:.1f} == single-card fold == bls_ref; fp381_mul shapes {sorted(seen)}; "
              f"launches={launches['mesh_bls_fold']}", flush=True)
        have = {(r["name"], r["lanes"]) for r in rows}
        new_rows = check_cases([
            fp381_case_of("mesh_bls_fold", x, y, f"shard fold: {k[0]} x {k[1]}")
            for k, (x, y) in sorted(seen.items(), key=lambda kv: -kv[0][1])
            if ("fp381_mul", k[0] * k[1]) not in have], card)
        t_step = step("bls fold and its new rows", t_step)

        # an armed shard error: the flush raises a device error (no replay),
        # the health model strikes that shard; a freshly pinned env passes
        inj = DeviceFaultInjector().install()
        inj.arm_shard_error(2)
        reset_launches()
        try:
            batch.verify_batch(pks, msgs, sigs, device=dev)
        except sharded.ShardFaultError as e:
            if not batch.is_device_error(e) or e.device != mesh.keys[2]:
                raise SystemExit(f"mesh_10k: the shard fault is not a device error of shard 2: {e!r}")
            raised, site = repr(e), e.site
        else:
            raise SystemExit("mesh_10k: the armed shard error did not raise")
        launches["mesh shard_fault armed"] = read_launches("mesh shard_fault armed", kernels=())
        struck = health.MESH_HEALTH.snapshot()["devices"][mesh.keys[2]]
        if struck["failures_total"] != 1 or inj.fired[-1] != ("mesh_rlc_submit", "shard_error:2"):
            raise SystemExit(f"mesh_10k: shard 2 not struck once: {struck}, fired {inj.fired}")
        inj.uninstall()
        inj = None
        batch._RUNNER_CACHE.pop(tuple(str(d) for d in shard_devs), None)
        pin(batch._build_sharded_env(shard_devs))
        mask, ms, f = run("mesh shard_fault healed", lambda: batch.verify_batch(
            pks, msgs, sigs, device=dev))
        if mask.tobytes() != host.tobytes() or f.get("path") != "rlc-sharded":
            raise SystemExit(f"mesh_10k: the flush after the fault: {f}")
        print(f"mesh_10k shard fault: {raised} at {site}, {mesh.keys[2]} struck "
              f"(failures_total 1, state {struck['state']}), no replay; the next flush on a "
              f"fresh pin: {ms:.1f} ms, path {f['path']}, mask == host arm", flush=True)
        t_step = step("shard fault", t_step)

        st = mesh_tm.mesh_stats()
        t = st["totals"]
        print(f"mesh_10k /debug/mesh: flushes={st['flushes']} last_pad={st['last_pad']} "
              f"submit_s={t['submit_seconds']} finish_s={t['finish_seconds']} "
              f"all_gathers={t['all_gathers']} all_gather_bytes={t['all_gather_bytes']} "
              f"prep_s={t['prep_seconds']} prep_calls={t['prep_calls']} "
              f"ladder={st['ladder']}", flush=True)

        batch._sharded_env = real_env
        batch.invalidate_sharded_env()
        mesh_auto_arm(dev, corpus, host, host_bad, run)
        t_step = step("auto", t_step)
    finally:
        if inj is not None:
            inj.uninstall()
        batch._sharded_env = real_env
        batch.invalidate_sharded_env()
        batch.configure_prep(stream=stream)
        batch.configure_verified_memo(memo)
    print(f"mesh_10k_phase steps (s): {steps}; {len(new_rows)} new fp381_mul rows; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return new_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The signing pools fork before this process first touches the card.
    corpus = build_commit(np.random.default_rng(SEED + 1))
    mixed = build_mixed_commit(corpus)
    mixed_sr = build_mixed_sr25519(np.random.default_rng(SEED + 8))
    cofactorless = build_cofactorless_commit(corpus)
    light = build_light(np.random.default_rng(SEED + 10))
    light_mixed = build_light_mixed(np.random.default_rng(SEED + 12))
    catchup = build_catchup(np.random.default_rng(SEED + 11))
    poisoned = build_poisoned(corpus)
    bls = build_bls_set()
    # consensus_10k signs each height's votes once its block is known, after
    # the card is in use: its pool forks now
    workers = os.cpu_count() or 1
    signing_pool = mp.get_context("fork").Pool(workers)
    try:
        adm = build_tx_admission(signing_pool, workers)
        return run_phases(corpus, mixed, mixed_sr, cofactorless, light, light_mixed, catchup,
                          poisoned, bls, adm, signing_pool, workers)
    finally:
        signing_pool.terminate()
        signing_pool.join()


def run_phases(corpus, mixed, mixed_sr, cofactorless, light, light_mixed, catchup, poisoned,
               bls, adm, signing_pool, workers: int) -> int:
    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    dev = torch.device("cuda")
    from tendermint_tpu_torch.libs import trace

    t_init = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device=dev)
    trace.record_device_init(time.perf_counter() - t_init)
    card_line = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card_line = card_line.splitlines()[0]
    clock_mhz = float(sh(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"]).splitlines()[0])
    props = torch.cuda.get_device_properties(0)
    card = {"sms": props.multi_processor_count, "clock_hz": clock_mhz * 1e6}
    print(f"card: {card_line}; {props.multi_processor_count} SMs, max SM clock {clock_mhz} MHz",
          flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{sh([cuda_fe._nvcc(), '--version']).splitlines()[-1]}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:  # one nvcc per library, and gcc, at once
        for f in [ex.submit(fn) for fn in (cuda_fe.build, cuda_msm.build, cuda_bls.build,
                                           native._lib)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in cuda_fe.BUILD_LOG.items()) + ")", flush=True)
    for lib, log in cuda_fe.BUILD_LOG.items():
        for line in log["ptxas"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {lib}:", line.strip(), flush=True)

    from tendermint_tpu_torch.crypto import batch

    # every timed phase runs with the verified-row memo off, as bench.py times;
    # the memo checks put the default back inside their own blocks
    memo_default = batch.verified_memo_stats()["capacity"]
    batch.configure_verified_memo(0)
    rng = np.random.default_rng(SEED)
    rows, base = kernel_checks(dev, rng, card)
    rows += bls_kernel_checks(dev, rng, card)
    msm_reference_check(dev, rng, base)
    ristretto_check(dev, rng)
    record_shapes(rows)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s since the build began", flush=True)
    launches = {}
    for phase, args in (
            (commit_phase, (corpus, launches)), (device_sort_phase, (corpus, launches)),
            (streamed_phase, (corpus, launches)),
            (host_small_phase, (corpus, launches)), (mixed_commit_phase, (mixed, launches)),
            (mixed_sr25519_phase, (mixed_sr, launches)), (bls_phase, (bls, launches)),
            (cofactorless_phase, (cofactorless, launches)), (light_phase, (light, launches)),
            (light_mixed_phase, (light_mixed, launches)),
            (commit_1k_phase, (corpus, launches)),
            (vote_storm_phase, (corpus, launches, memo_default)),
            (catchup_phase, (catchup, launches)), (memo_phase, (corpus, launches, memo_default)),
            (scheduler_lanes_phase, (corpus, catchup, light, launches)),
            (light_serve_phase, (light, launches)),
            (scheduler_mixed_phase, (corpus, catchup, light, launches)),
            (poisoned_votes_phase, (poisoned, launches))):
        t_phase = time.perf_counter()
        phase(dev, *args)
        print(f"{phase.__name__}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    rows += g1_msm_phase(dev, bls, card, launches)
    print(f"g1_msm_phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    for phase, args in ((metrics_phase, (corpus, bls, launches)),
                        (profile_report_phase, (corpus, launches))):
        t_phase = time.perf_counter()
        phase(dev, *args)
        print(f"{phase.__name__}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    chain10k = consensus_10k_phase(dev, mixed_sr, signing_pool, workers, launches, memo_default)
    print(f"consensus_10k_phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    for phase, args in ((rpc_light_10k_phase, (chain10k, signing_pool, workers, launches)),
                        (p2p_sync_10k_phase, (chain10k, signing_pool, workers, launches)),
                        (statesync_10k_phase, (chain10k, signing_pool, workers, launches)),
                        (device_fault_check, (corpus, signing_pool, workers, launches)),
                        (tx_admission_phase, (adm, signing_pool, workers, launches,
                                              memo_default)),
                        (cli_localnet_phase, (launches,)),
                        (chaos_poison_10k_phase, (signing_pool, workers, launches)),
                        (fleet_smoke_7_phase, (signing_pool, workers, launches))):
        t_phase = time.perf_counter()
        phase(dev, *args)
        print(f"{phase.__name__}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    rows += mesh_10k_phase(dev, corpus, bls, signing_pool, workers, launches, card, rows)
    print(f"mesh_10k_phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    rows += recorded_rows(card, launches)
    coverage(rows)
    for r in rows:  # the count on the path whose shape the row checks; none off the path
        r["launches"] = 0 if r["path"] is None else launches.get(r["path"], {}).get(r["name"], 0)
    print(json.dumps({"kernels": rows, "launches_by_path": launches}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
