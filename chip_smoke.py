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
     lanes;
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
  5. the "tampered" path: three tampered signatures, so the pipelined
     combined check fails and the bisection gives the mask (20 flushes:
     17 combined checks and 3 per-signature leaves, as the reference's
     recursion gives on these rows), which must be False exactly there;
     "tampered_persig", the same rows with TMTPU_BISECT=0 (one per-signature
     pass over all rows); each arm warmed once, timed once, profiled once;
     verify_commit raises CommitVerifyError;
  6. the "streamed" path: verify_batch over 100,000 rows (the commit's signed
     rows tiled ten times) through the flush planner, 9 chunks of 24,576
     lanes, once to warm and three timed runs, one more under torch.profiler;
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
     verify_batch(key_types=...): warm, 3 timed calls (the Ed25519 rows on
     the card, pipelined since slice 9, the sr25519 rows by the native
     verifier on the host), then an
     Ed25519 and an sr25519 row tampered (exact mask); 64 rows of each mask
     held against the port's pure-Python verifiers;
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
     ed25519_ref.verify_cofactored on every row, and the step passes);
     "light_skipping" (a light.client.Client in skipping mode over a
     MockProvider chain of 16 heights x 1,024 validators whose whole set
     rotates at height 9: the trusted heights must be the bisection's,
     steps and card flushes printed); "light_accumulated" (heights 1-8's
     commits submitted under accumulate_flushes with a bad row in commit
     3: one flush, the default 8,192-row route with bisection, each slice
     equal to that commit's own submit and finish); the light checks that
     light_skipping's refused steps submit and never finish (count, host ms,
     launches), and one such dropped submit timed and profiled; the phase's
     seconds;
  13. the consensus and catch-up paths: "verify_commit_1k" (BASELINE
     config 2: the first 1,000 corpus validators with their own
     signatures, cold and 5 warm calls, the single flush "rlc", one
     profiled); "vote_storm_10k" (BASELINE config 5's vote stream: the 10k
     corpus's commit signatures as precommits into a deferred
     types.vote_set.VoteSet, flushed every 512 adds, 19 flushes of 512 rows
     and one of 272, each flush's ms and label, votes/s, +2/3 and
     make_commit's bytes equal to the corpus commit's, a storm of one drain
     of each kind profiled;
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
  14. the shape check: from phase 4 on, each call of the six Ed25519
     wrappers notes its shape (the lanes of its batch, uptree's windows and
     chunk, fenwick_reduce's storage segments and Kf, bucket_fold's windows;
     not the loop counts), and every shape a path gave a kernel must be the
     shape of a phase-3 row, or the script exits naming it;
  15. a `kernels` JSON line (a row off every path counts 0 launches), the
     card line, and last the `ok` JSON line.
The launch counts are zeroed just before each path and read just after it
(the warm, pipelined and streamed paths per call); every kernel of a path must
launch on it: the six Ed25519 kernels on the Ed25519 paths (pipelined,
tampered, tampered_persig, mixed_commit, mixed_sr25519_10k, the four light
paths and the consensus and catch-up paths included), the two BLS kernels on
the BLS paths, none on host_small, the verify-at-add arm, the evidence check
and the memo's answers. Exits non-zero without a result when no CUDA device
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def which(label: str):
        return next((sym for sym in KERNEL_SYMBOL[name] if sym in label), None)

    durs, syms, other_us = [], set(), 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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


def kernel_checks(dev, rng, card: dict) -> list:
    """Each kernel against its plain version at the shapes of each path:
    warm (cached A: R decompressed on 10,240 lanes, the fused MSM over
    20,480 lanes), cold (A and R decompressed on 20,480), tampered_persig
    (the per-signature ladder on the 16,384-lane bucket), tampered (the
    bisection's ladder leaf on 1,024 lanes), streamed and pipelined
    (24,576-lane chunks: A and R decompressed, the fused MSM)."""
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm, msm_torch
    from tendermint_tpu_torch.ops.msm_geometry import chunk_geometry, tree_written_positions

    enc = seeded_points(2048, rng)
    p0, ok = msm_torch.decompress_rows(enc, dev)
    assert bool(ok.all()), "seeded points failed to decompress"
    base = torch.cat([p0, cuda_fe.pdbl_plain(p0, 1)], dim=-1)  # reduced + carried limbs
    nb = base.shape[-1]

    def pick(n):
        return base[..., torch.from_numpy(rng.integers(0, nb, size=n)).to(dev)].contiguous()

    def padd_case(path, lanes, where, few_lanes=None):
        """`few_lanes` pins cuda_fe.PADD_FEW_LANES around each call to force
        one kernel (the sweep); None keeps the routing as shipped."""
        p, q = pick(lanes), pick(lanes)
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

    def pdbl_case(path, lanes, times, where):
        p = pick(lanes)
        return dict(name="pdbl", path=path, variant=f"times={times}, {where}", lanes=lanes,
                    kern=lambda: cuda_fe.pdbl(p, times), plain=lambda: cuda_fe.pdbl_plain(p, times),
                    key=shape_key("pdbl", p, times),
                    mads=pdbl_mads(times), items=lanes,
                    bytes=(3 * 80 + POINT_BYTES) * lanes)  # x, y, z in (t is not read), 4 out

    def bucket_fold_case(path, prefix, t_):
        m = 256 * t_
        return dict(name="bucket_fold", path=path, variant=f"T={t_}", lanes=m,
                    kern=lambda: cuda_msm.bucket_fold(prefix, t_),
                    plain=lambda: cuda_msm.bucket_fold_plain(prefix, t_),
                    key=shape_key("bucket_fold", prefix, t_),
                    mads=PADD_MADS, items=255 * t_, bytes=(m + 2 * t_) * POINT_BYTES,
                    bound_note="operations: 255 adds a window x PADD_MADS over the whole card; "
                               "the adds form a chain 8 levels deep, which this bound does not "
                               "count")

    def fsq_case(path, lanes, where):
        x = pick(lanes)[1].contiguous()
        return dict(name="fsquare_chain", path=path, variant=f"k=50, {where}", lanes=lanes,
                    kern=lambda: cuda_fe.fsquare_chain(x, 50),
                    plain=lambda: cuda_fe.fsquare_chain_plain(x, 50),
                    key=shape_key("fsquare_chain", x, 50),
                    mads=50 * SQR, items=lanes, bytes=2 * 80 * lanes)

    def uptree_case(path, n, ch, where):
        t_ = 32
        x = pick(n)
        perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(t_)])
                                .astype(np.int32)).to(dev)
        nchunks = t_ * n // ch
        pos = torch.from_numpy(tree_written_positions(ch)).to(dev)

        def written(t):  # level 0, and the chunk-tree positions that hold a node
            return t[0], t[1].reshape(4, 20, nchunks, chunk_geometry(ch).rows_out * 128)[..., pos]

        return dict(name="uptree", path=path, variant=f"ch={ch}, {where}", lanes=t_ * n,
                    kern=lambda: cuda_msm.uptree(x, perm, ch),
                    plain=lambda: cuda_msm.uptree_plain(x, perm, ch),
                    key=shape_key("uptree", x, perm, ch),
                    view=written, mads=PADD_MADS, items=nchunks * (ch - 1),
                    # table and perm read once; level 0 and the chunk trees written once
                    bytes=n * POINT_BYTES + t_ * n * 4 + (t_ * n + nchunks * (ch - 1)) * POINT_BYTES)

    def fenwick_case(path, n, where):
        """fenwick_reduce on the fused storage of an n-lane MSM; returns the
        case and the storage (its prefix points feed bucket_fold)."""
        fs = fused_storage(pick(n), rng, n)
        m, kf = fs["idx"].shape
        fw_args = (fs["lvl0"], fs["ctree"], fs["top"], fs["idx"])
        # the gather's floor: the distinct 32-B sectors of the nodes' limb rows
        sectors = fenwick_gather_sectors(fs["idx"].cpu().numpy(), *(
            fs[k].shape[-1] for k in ("lvl0", "ctree", "top")))
        return dict(name="fenwick_reduce", path=path,
                    variant=f"Kf={kf}, 256 buckets x {fs['t']} windows, {n:,}-lane MSM, {where}",
                    lanes=m, kern=lambda: cuda_msm.fenwick_reduce(*fw_args),
                    plain=lambda: cuda_msm.fenwick_reduce_plain(*fw_args),
                    key=shape_key("fenwick_reduce", *fw_args),
                    t_ops=work_seconds(m * (kf - 1) * PADD_MADS, card),
                    bytes=sectors * 32 + m * kf * 4 + m * POINT_BYTES, sectors=sectors,
                    bound_note=f"operations: (Kf-1) x PADD_MADS a lane over the whole card; "
                               f"bytes: {sectors} gather sectors x 32 B, the index table and "
                               f"the output once"), fs

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
        bucket_fold_case("warm", fs["prefix"], fs["t"]),
        bucket_fold_case(None, pick(256), 1),
        bucket_fold_case(None, pick(256 * 33), 33),
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
        bucket_fold_case("light_trusting_4k", trusting_fs["prefix"], trusting_fs["t"]),
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
    """One call of a path under torch.profiler: device busy time (sum of
    kernel times; one stream, so kernels do not overlap), the idle share
    against the path's unprofiled median, and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        print(f"profile {path}: the profiler recorded no device time (device busy: not measured)")
        return
    n_kernels = sum(e.count for e in rows)
    print(f"profile {path}: device_busy_ms={busy_us / 1e3:.2f} kernels={n_kernels} "
          f"idle_share={1 - busy_us / 1e3 / median_ms:.3f} (vs median {median_ms:.1f} ms)")
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


def record_shapes() -> None:
    """From here on each call of the six Ed25519 wrappers adds its shape
    to SHAPES_SEEN (a dict lookup and a set add a call; the wrappers and
    their launch counts are unchanged)."""
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    def shim(module, name):
        real = getattr(module, name)

        def call(*a, **k):
            SHAPES_SEEN.add(shape_key(name, *a, **k))
            return real(*a, **k)
        setattr(module, name, call)

    for name in ED25519_KERNELS:
        shim(cuda_fe if name in cuda_fe.LAUNCHES else cuda_msm, name)


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
            profile_path(path, lambda: batch.verify_batch(pubkeys, msgs, sigs, device=dev),
                         batch_ms)
        finally:
            del os.environ["TMTPU_BISECT"]


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
    profile_path("streamed", lambda: batch.verify_batch(pubkeys, msgs, sigs, device=dev),
                 statistics.median(times))

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
                sigs=[sig for _, sig in rows], types=types)


def mixed_sr25519_phase(dev, sr: dict, launches: dict) -> None:
    """verify_batch(key_types=...) on the mixed Ed25519 + sr25519 set: once
    to warm, 3 timed calls (launch counts the same on each; the 8,000
    Ed25519 rows run the pipelined 2-chunk stream, the default route since
    slice 9, where they ran the cached single flush before), then one
    Ed25519 row and one sr25519 row tampered, whose mask must be False
    exactly there (the Ed25519 rows' bisection on the card). The Ed25519 rows run the card path, the sr25519 rows the
    native verifier on the host; a 64-row sample of each mask is held
    against the port's pure-Python verifiers."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519_ref as E
    from tendermint_tpu_torch.crypto import sr25519

    pks, msgs, types = sr["pubkeys"], sr["msgs"], sr["types"]

    def call(sigs):
        reset_launches()
        t0 = time.perf_counter()
        mask = batch.verify_batch(pks, msgs, sigs, device=dev, key_types=types)
        torch.cuda.synchronize()
        return mask, (time.perf_counter() - t0) * 1e3, dict(batch.LAST_FLUSH)

    def held(mask, sigs, rows):
        for i in rows:
            py = (sr25519._sr25519_verify_py if types[i] == "sr25519" else E.verify_cofactored)
            if bool(mask[i]) != py(pks[i], msgs[i], sigs[i]):
                raise SystemExit(f"mixed_sr25519_10k: row {i} ({types[i]}) differs from the "
                                 f"pure-Python verifier")

    rng = np.random.default_rng(SEED + 7)
    n_ed = N_VALIDATORS - N_SR
    sample = sorted(set(int(i) for i in rng.integers(0, n_ed, 32))
                    | set(int(i) for i in rng.integers(n_ed, N_VALIDATORS, 32)))
    call(sr["sigs"])  # warm
    times, sr_ms = [], []
    for _ in range(3):
        mask, ms, flush = call(sr["sigs"])
        same_counts(launches, "mixed_sr25519_10k", read_launches("mixed_sr25519_10k"))
        if not mask.all() or flush.get("sr25519_rows") != N_SR or flush.get("mode") != "pipelined":
            raise SystemExit(f"mixed_sr25519_10k: {int((~mask).sum())} rows False, flush {flush}")
        times.append(ms)
        sr_ms.append(flush["sr25519_s"] * 1e3)
    held(mask, sr["sigs"], sample)
    bad_sigs = list(sr["sigs"])
    for i in SR_TAMPERED:
        bad_sigs[i] = flip(bad_sigs[i])
    mask, bad_ms, flush = call(bad_sigs)
    counts = launches["mixed_sr25519_10k tampered"] = read_launches("mixed_sr25519_10k tampered")
    bad = tuple(int(i) for i in np.flatnonzero(~mask))
    if bad != SR_TAMPERED or "recovery_s" not in flush:
        raise SystemExit(f"mixed_sr25519_10k tampered mask: False at {bad}, expected {SR_TAMPERED}")
    held(mask, bad_sigs, sorted(set(sample) | set(SR_TAMPERED)))
    print(f"mixed_sr25519_10k ({N_SR} sr25519 of {N_VALIDATORS}): median_ms="
          f"{statistics.median(times):.1f} ms={[round(t, 1) for t in times]} "
          f"sr25519_host_ms={statistics.median(sr_ms):.1f} "
          f"launches per call={launches['mixed_sr25519_10k']}; tampered rows {bad}: "
          f"ms={bad_ms:.1f} (recovery ms={flush['recovery_s'] * 1e3:.1f}, sr25519 host ms="
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
    profile_path("light_tampered", lambda: step(tampered_sh), statistics.median(t_ms))

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


def run_storm(dev, vals, votes, defer: bool = True):
    """Every vote into a fresh VoteSet, flushed every DRAIN adds when
    deferred: (vote set, [(rows, ms, label, recovery flushes, failed)],
    total ms)."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.basic import SignedMsgType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    vs = VoteSet(CHAIN_ID, HEIGHT, 0, SignedMsgType.PRECOMMIT, vals,
                 defer_verification=defer, device=dev)
    flushes = []
    t0 = time.perf_counter()
    want = "pending" if defer else True
    for k, vote in enumerate(votes, 1):
        got = vs.add_vote(vote)
        if got != want:
            raise SystemExit(f"vote {k - 1}: add_vote gave {got!r}, expected {want!r}")
        if defer and (k % DRAIN == 0 or k == len(votes)):
            rows = vs.pending_count()
            tf = time.perf_counter()
            _, failed = vs.flush()
            torch.cuda.synchronize()
            flushes.append((rows, (time.perf_counter() - tf) * 1e3, batch.LAST_FLUSH.get("path"),
                            batch.LAST_FLUSH.get("recovery_flushes"), failed))
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
    # profiled: one drain of each kind (a whole storm is ~143,000 kernels,
    # which the profiler takes tens of seconds to read)
    sub = votes[:DRAIN + drains[-1]]
    _, _, sub_ms = run_storm(dev, vals, sub)
    profile_path(f"vote_storm_10k, first {len(sub)} votes (drains of {DRAIN} and "
                 f"{drains[-1]})", lambda: run_storm(dev, vals, sub), sub_ms)

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
    rows, _, label, recovery, failed = flushes[0]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    # The signing pool forks before this process first touches the card.
    corpus = build_commit(np.random.default_rng(SEED + 1))
    mixed = build_mixed_commit(corpus)
    mixed_sr = build_mixed_sr25519(np.random.default_rng(SEED + 8))
    cofactorless = build_cofactorless_commit(corpus)
    light = build_light(np.random.default_rng(SEED + 10))
    catchup = build_catchup(np.random.default_rng(SEED + 11))
    bls = build_bls_set()
    dev = torch.device("cuda")
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
    record_shapes()
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s since the build began", flush=True)
    launches = {}
    for phase, args in (
            (commit_phase, (corpus, launches)), (streamed_phase, (corpus, launches)),
            (host_small_phase, (corpus, launches)), (mixed_commit_phase, (mixed, launches)),
            (mixed_sr25519_phase, (mixed_sr, launches)), (bls_phase, (bls, launches)),
            (cofactorless_phase, (cofactorless, launches)), (light_phase, (light, launches)),
            (commit_1k_phase, (corpus, launches)),
            (vote_storm_phase, (corpus, launches, memo_default)),
            (catchup_phase, (catchup, launches)), (memo_phase, (corpus, launches, memo_default))):
        t_phase = time.perf_counter()
        phase(dev, *args)
        print(f"{phase.__name__}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    coverage(rows)
    for r in rows:  # the count on the path whose shape the row checks; none off the path
        r["launches"] = 0 if r["path"] is None else launches[r["path"]][r["name"]]
    print(json.dumps({"kernels": rows, "launches_by_path": launches}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
