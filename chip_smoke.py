#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (tendermint_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card, nvcc and gcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. the card (nvidia-smi name and power limit), torch / CUDA / nvcc versions;
  2. build the CUDA kernel libraries (one nvcc each, started together, sm_90a)
     and the native host prep (gcc);
  3. each of the six kernels against its plain torch version on the card at
     the shapes the paths below give it (uptree at 2,048-lane chunks on the
     warm and streamed paths and at 1,024; pdbl at all six window-fold
     shapes and on the ladder), tolerance zero (integer arithmetic), with
     its device time (the profiler's kernel records, median per launch;
     where CUPTI keeps none in two sessions, CUDA events around calls
     queued behind a device sleep, and the row says which),
     its call time by CUDA events, the plain version's time, its bound
     (fenwick_reduce's byte count is the distinct 32-B sectors its gather
     touches, counted on the host from the index table and printed), ptxas's
     registers and spills, and for the fenwick_reduce and fp12_sparse_mul
     rows the card ms recorded before their redesigns (text line only);
     the unfused MSM total against the integer reference on a small input,
     and the fused total against the unfused one at the 10k commit's 20,480
     lanes;
  4. a 10,000-validator commit (random keys from a seed, real signatures over
     each row's precommit sign bytes) through ValidatorSet.verify_commit on
     two paths: "cold" (plain kernel: A and R decompressed together, fills
     the A cache) and "warm" (cached-A kernel), then one more warm call under
     torch.profiler (device busy time, idle share, kernels by device time);
     both run the fused MSM (uptree, fenwick_reduce, bucket_fold);
  5. the "tampered" path: three tampered signatures, so verify_batch's
     combined check fails and the per-signature recovery gives the mask, which
     must be False exactly there; verify_commit raises CommitVerifyError;
  6. the "streamed" path: verify_batch over 100,000 rows (the commit's signed
     rows tiled ten times) through the flush planner, 9 chunks of 24,576
     lanes, once to warm and three timed runs, one more under torch.profiler;
     then "streamed_tampered": two tampered rows in different chunks, the
     chunk-wise recovery, a mask False exactly there;
  7. "mixed_commit": a 10,000-validator set holding 4 BLS validators, a
     plain Commit through verify_commit honest, with one bad BLS row and with
     one bad Ed25519 row (Ed25519 rows on the card, BLS rows by bls_ref on
     the host), verdicts held against bls_ref / ed25519_ref;
  8. the BLS kernels fp381_mul and fp12_sparse_mul against their plain
     versions at the BLS paths' shapes (the fold's widest stacked launch, a
     Miller step's widest, the Miller loop's 2 lanes, and one wide row off
     the path), printed as in phase 3 (fp12_sparse_mul bound by its 54
     products a lane over the whole card, or one product's multiply-adds
     issued one a clock, whichever is longer);
  9. a 10,000-validator BLS set (keys sk0 + i, one aggregate signature over
     the full bitmap, built before the card is touched) through
     ValidatorSet.verify_aggregate_commit on three paths: "bls_cold" (the
     host decode of 10k keys fills the key cache), "bls_warm" (5 timed calls,
     then one under torch.profiler; host time split by stage) and
     "bls_rejected" (a valid G2 point that is the wrong signature, and a
     correctly signed bitmap at <= 2/3 of the power); the card's aggregate
     pubkey and pairing verdicts are held against the host bls_ref, whose
     Miller loops on the warm call's pairs are timed beside the card's;
  10. a `kernels` JSON line (a row off every path counts 0 launches), the
     card line, and last the `ok` JSON line.
The launch counts are zeroed just before each path and read just after it
(the warm and streamed paths per call); every kernel of a path must launch on
it: the six Ed25519 kernels on the Ed25519 paths (mixed_commit included),
the two BLS kernels on the BLS paths. Exits non-zero without a result when
no CUDA device is available.
"""

from __future__ import annotations

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
SM_PARTITIONS = 4  # a warp issues on one of an SM's 4 sub-partitions (16 int32 lanes each)
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


def work_seconds(mads: int, warps: int, card: dict) -> float:
    """Least time for `mads` int32 multiply-adds in all, spread evenly over
    the sub-partitions that `warps` warps occupy (528 at most)."""
    parts = min(warps, card["sms"] * SM_PARTITIONS)
    return mads / (parts * INT32_MAD_PER_SM_PER_CLK / SM_PARTITIONS * card["clock_hz"])


def imad_seconds(mads_per_lane: int, lanes: int, card: dict) -> float:
    """Least time for `lanes` threads of `mads_per_lane` int32 multiply-adds
    each. A warp instruction takes a sub-partition's 16 lanes per clock for
    all 32 lanes, active or not, and a launch of a few warps occupies only
    that many sub-partitions, not the whole card."""
    warps = -(-lanes // 32)
    return work_seconds(warps * 32 * mads_per_lane, warps, card)


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


# Card ms recorded before the fenwick_reduce and fp12_sparse_mul redesigns
# (PERF.md's kernel table, "before" column; NVIDIA H100 80GB HBM3, 700.00 W).
# Printed on the row's text line only, labelled as recorded: the `kernels`
# JSON line holds only what this run measured.
RECORDED_BEFORE_MS = {
    ("fenwick_reduce", 8_192): 0.3327,
    ("fp12_sparse_mul", 2): 0.1221, ("fp12_sparse_mul", 16_384): 0.4642,
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
    "padd": ("padd_kernel",), "pdbl": ("pdbl_kernel", "pdbl_lanes_kernel"),
    "fsquare_chain": ("fsquare_chain_kernel",), "uptree": ("uptree_kernel",),
    "fenwick_reduce": ("fenwick_kernel",), "bucket_fold": ("bucket_fold_kernel",),
    "fp381_mul": ("fp381_mul_kernel",), "fp12_sparse_mul": ("fp12_sparse_mul_kernel",),
}


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
    from tendermint_tpu_torch.ops import cuda_fe

    if name == "pdbl":
        return "pdbl_lanes_kernel" if cuda_fe.pdbl_entry(lanes) == "tm_pdbl_lanes" else "pdbl_kernel"
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


def device_ms(fn, name: str, lanes: int, reps: int = 10):
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
    return queued_ms(fn, reps), launched_symbol(name, lanes), None, "events, queued calls"


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
    20,480 lanes), cold (A and R decompressed on 20,480), tampered (the
    per-signature ladder on the 16,384-lane bucket) and streamed (24,576-lane
    chunks: A and R decompressed, the fused MSM)."""
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm, msm_torch
    from tendermint_tpu_torch.ops.msm_geometry import chunk_geometry, tree_written_positions

    enc = seeded_points(2048, rng)
    p0, ok = msm_torch.decompress_rows(enc, dev)
    assert bool(ok.all()), "seeded points failed to decompress"
    base = torch.cat([p0, cuda_fe.pdbl_plain(p0, 1)], dim=-1)  # reduced + carried limbs
    nb = base.shape[-1]

    def pick(n):
        return base[..., torch.from_numpy(rng.integers(0, nb, size=n)).to(dev)].contiguous()

    def padd_case(path, lanes, where):
        p, q = pick(lanes), pick(lanes)
        return dict(name="padd", path=path, variant=where, lanes=lanes,
                    kern=lambda: cuda_fe.padd(p, q), plain=lambda: cuda_fe.padd_plain(p, q),
                    mads=PADD_MADS, items=lanes, bytes=3 * POINT_BYTES * lanes)

    def pdbl_case(path, lanes, times, where):
        p = pick(lanes)
        few = cuda_fe.pdbl_entry(lanes) == "tm_pdbl_lanes"
        case = dict(name="pdbl", path=path, variant=f"times={times}, {where}", lanes=lanes,
                    kern=lambda: cuda_fe.pdbl(p, times), plain=lambda: cuda_fe.pdbl_plain(p, times),
                    mads=pdbl_mads(times), items=lanes,
                    bytes=(3 * 80 + POINT_BYTES) * lanes)  # x, y, z in (t is not read), 4 out
        if few:  # a warp per lane: the lane's work spread over its warp's 32 threads
            case.update(mads=-(-pdbl_mads(times) // 32), items=32 * lanes,
                        bound_note=f"operations: pdbl_mads({times}) per lane over the {lanes} "
                                   f"sub-partitions the launch occupies (a warp per lane)")
        return case

    def fsq_case(path, lanes, where):
        x = pick(lanes)[1].contiguous()
        return dict(name="fsquare_chain", path=path, variant=f"k=50, {where}", lanes=lanes,
                    kern=lambda: cuda_fe.fsquare_chain(x, 50),
                    plain=lambda: cuda_fe.fsquare_chain_plain(x, 50),
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
                    view=written, mads=PADD_MADS, items=nchunks * (ch - 1),
                    # table and perm read once; level 0 and the chunk trees written once
                    bytes=n * POINT_BYTES + t_ * n * 4 + (t_ * n + nchunks * (ch - 1)) * POINT_BYTES)

    fs = fused_storage(pick(20_480), rng, 20_480)
    m, kf = fs["idx"].shape
    fw_args = (fs["lvl0"], fs["ctree"], fs["top"], fs["idx"])
    t_ = fs["t"]
    # the gather's floor: the distinct 32-B sectors of the nodes' limb rows
    sectors = fenwick_gather_sectors(fs["idx"].cpu().numpy(), *(
        fs[k].shape[-1] for k in ("lvl0", "ctree", "top")))
    cases = [
        uptree_case("warm", 20_480, 2048, "10k commit: 32 windows x 10 chunks"),
        uptree_case("streamed", 24_576, 2048, "planner chunk: 32 windows x 12 chunks"),
        uptree_case(None, 3_072, 1024, "1,536-lane A bucket: 32 windows x 3 chunks, off the path"),
        dict(name="fenwick_reduce", path="warm", variant=f"Kf={kf}, 256 buckets x {t_} windows",
             lanes=m, kern=lambda: cuda_msm.fenwick_reduce(*fw_args),
             plain=lambda: cuda_msm.fenwick_reduce_plain(*fw_args),
             t_ops=work_seconds(m * (kf - 1) * PADD_MADS, 4 * m // 32, card),
             bytes=sectors * 32 + m * kf * 4 + m * POINT_BYTES, sectors=sectors,
             bound_note=f"operations: (Kf-1) x PADD_MADS a lane over the sub-partitions of "
                        f"4 warps per 32 lanes; bytes: {sectors} gather sectors x 32 B, the "
                        f"index table and the output once"),
        dict(name="bucket_fold", path="warm", variant=f"T={t_}", lanes=m,
             kern=lambda: cuda_msm.bucket_fold(fs["prefix"], t_),
             plain=lambda: cuda_msm.bucket_fold_plain(fs["prefix"], t_),
             mads=PADD_MADS, items=255 * t_, bytes=(m + 2 * t_) * POINT_BYTES),
        padd_case("warm", 32 * 5, "top tree level 1: 32 windows x 5 root pairs"),
        padd_case("streamed", 32 * 6, "top tree level 1: 32 windows x 6 root pairs"),
        padd_case("warm", 32, "[255] P_255 and W per window"),
        padd_case("tampered", 16_384, "per-signature ladder"),
        pdbl_case("warm", 32, 8, "[256] P_255 per window"),
        pdbl_case("warm", 16, 8, "window fold level 1"),
        pdbl_case("warm", 8, 16, "window fold level 2"),
        pdbl_case("warm", 4, 32, "window fold level 3"),
        pdbl_case("warm", 2, 64, "window fold level 4"),
        pdbl_case("warm", 1, 128, "last window-fold level"),
        pdbl_case("tampered", 16_384, 4, "per-signature ladder"),
        fsq_case("warm", 10_240, "R decompression"),
        fsq_case("cold", 20_480, "A and R decompression"),
        fsq_case("streamed", 24_576, "A and R decompression per chunk"),
        fsq_case("tampered", 16_384, "per-signature A or R decompression"),
    ]

    return check_cases(cases, card), base


def check_cases(cases, card: dict) -> list:
    """Each case's kernel against its plain version (max |err| must be 0),
    then both timed, with the bound of the case's work (`t_ops` where the
    case counts its operations itself, else `mads` a thread over `items`
    threads), ptxas's registers and spills, and on the text line the card ms
    recorded before the redesign where the row has one (RECORDED_BEFORE_MS)."""
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
        ms, symbol, other_ms, ms_by = device_ms(c["kern"], c["name"], c["lanes"])
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
        rows.append(row)
        print(f"kernel {row['name']} [{row['path']}] {row['variant']} lanes={row['lanes']} "
              f"{symbol}: ms={ms:.4f} ({ms_by}) "
              f"wrapper_other_ms={'in ms' if other_ms is None else f'{other_ms:.4f}'} "
              f"call_ms={call_ms:.4f} "
              f"(events) plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.5f} "
              f"({c.get('bound_note', row['bound_by'])}) "
              f"max_abs_err={err} library_ms=null regs={row['regs']} "
              f"spill_bytes={row['spill_bytes']}"
              + (f" sectors={c['sectors']}" if "sectors" in c else "")
              + (f" recorded_before_ms={RECORDED_BEFORE_MS[c['name'], c['lanes']]} (PERF.md, "
                 "not this run)" if (c["name"], c["lanes"]) in RECORDED_BEFORE_MS else ""),
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


def bls_kernel_checks(dev, rng, card: dict) -> list:
    """B7 at the fold's widest stacked launch (the first of 14 levels over
    the 16,384-lane padded set: 6 products x 8,192 pairs) and at a Miller
    step's widest (square12: 36 Fp2 x 3 products x 2 lanes); B8 at the Miller
    loop's 2 lanes and at 16,384 lanes (off the path: throughput)."""
    from tendermint_tpu_torch.ops import cuda_bls

    def mul_case(shape, variant):
        a, b = carried_limbs(shape, rng).to(dev), carried_limbs(shape, rng).to(dev)
        products = int(np.prod(shape))
        return dict(name="fp381_mul", path="bls_warm", variant=variant, lanes=products,
                    kern=lambda: cuda_bls.fp381_mul(a, b),
                    plain=lambda: cuda_bls.fp381_mul_plain(a, b),
                    mads=FP381_MUL, items=products, bytes=3 * FP_BYTES * products)

    def sparse_case(n, variant, path):
        f = carried_limbs((6, 2, n), rng).to(dev)
        line = carried_limbs((3, 2, n), rng).to(dev)
        # The function's floor, not the launch's: its 54 products a lane over
        # the whole card, or the chain of one product as one thread issues
        # it (FP381_MUL multiply-adds, one a clock), whichever is longer.
        t_card = work_seconds(n * SPARSE_PRODUCTS * FP381_MUL, card["sms"] * SM_PARTITIONS, card)
        t_chain = FP381_MUL / card["clock_hz"]
        return dict(name="fp12_sparse_mul", path=path, variant=variant, lanes=n,
                    kern=lambda: cuda_bls.fp12_sparse_mul(f, line),
                    plain=lambda: cuda_bls.fp12_sparse_mul_plain(f, line),
                    t_ops=max(t_card, t_chain), bytes=(18 + 12) * FP_BYTES * n,
                    bound_note=(f"operations: one product's FP381_MUL issued one a clock"
                                if t_chain >= t_card else
                                f"operations: {SPARSE_PRODUCTS} x FP381_MUL a lane over the "
                                f"whole card"))

    return check_cases([
        mul_case((6, 8_192), "fold level 1: 6 products x 8,192 pairs"),
        mul_case((36, 3, 2), "Miller step square12: 36 Fp2 x 3 products x 2 lanes"),
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


def reset_launches() -> None:
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    cuda_fe.reset_launches()
    cuda_msm.reset_launches()
    cuda_bls.reset_launches()


def read_launches(path: str, kernels=ED25519_KERNELS) -> dict:
    """The launch counts of all eight kernels since the last reset; every
    kernel of the path (`kernels`) must have run."""
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    counts = {**cuda_fe.LAUNCHES, **cuda_msm.LAUNCHES, **cuda_bls.LAUNCHES}
    for name in kernels:
        if counts[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the {path} path")
    return counts


def same_counts(launches: dict, path: str, counts: dict) -> None:
    if launches.setdefault(path, counts) != counts:
        raise SystemExit(f"{path} calls launched different counts: {launches[path]} vs {counts}")


def commit_phase(dev, corpus) -> dict:
    """The three commit paths, each with its own launch counts:
    {path: {kernel: n}}."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import CommitVerifyError

    vals, block_id, commit, msgs = corpus
    batch.reset_a_cache()
    launches = {}

    # Cold: the plain kernel decompresses A and R together and fills the cache.
    reset_launches()
    t0 = time.perf_counter()
    vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches["cold"] = read_launches("cold")
    cold = dict(batch.LAST_FLUSH)
    assert cold.get("mode") == "plain" and cold.get("fused") and "recovery_s" not in cold, cold

    # Warm: the cached-A kernel; counts per call, the same on every call.
    warm, warm_flush = [], []
    for _ in range(7):
        reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        same_counts(launches, "warm", read_launches("warm"))
        warm_flush.append(dict(batch.LAST_FLUSH))
    for f in warm_flush:
        assert f.get("mode") == "cached" and f.get("fused") and "recovery_s" not in f, f
    prep = statistics.median(f["prep_s"] for f in warm_flush) * 1e3
    total = statistics.median(f["total_s"] for f in warm_flush) * 1e3
    sign_bytes = []
    for _ in range(3):  # the commit API's own host work before the flush
        t0 = time.perf_counter()
        commit.vote_sign_bytes_many(CHAIN_ID, range(N_VALIDATORS))
        sign_bytes.append((time.perf_counter() - t0) * 1e3)
    print(f"verify_commit 10k: cold_ms={cold_ms:.1f} warm_median_ms={statistics.median(warm):.1f} "
          f"warm_ms={[round(w, 1) for w in warm]} sign_bytes_ms={statistics.median(sign_bytes):.1f} "
          f"host_prep_ms={prep:.1f} submit_to_sync_ms={total - prep:.1f} lanes={cold['lanes']} "
          f"(A block {cold['lanes'] // 2}) fused={cold['fused']}", flush=True)
    print(f"launches cold={launches['cold']} warm per call={launches['warm']}", flush=True)
    profile_path("warm", lambda: vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev),
                 statistics.median(warm))

    # Tampered: the cached flush fails, the per-signature recovery gives the mask.
    pubkeys = [vals.validators[i].pub_key.bytes() for i in range(N_VALIDATORS)]
    sigs = [cs.signature for cs in commit.signatures]
    for i in TAMPERED:
        sigs[i] = flip(sigs[i])
    reset_launches()
    t0 = time.perf_counter()
    mask = batch.verify_batch(pubkeys, msgs, sigs, device=dev)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches["tampered"] = read_launches("tampered")
    recovery_ms = batch.LAST_FLUSH["recovery_s"] * 1e3
    bad = tuple(int(i) for i in np.flatnonzero(~mask))
    if bad != TAMPERED:
        raise SystemExit(f"tampered mask wrong: False at {bad}, expected {TAMPERED}")
    tampered = Commit(HEIGHT, 0, block_id, [
        CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns, s)
        for cs, s in zip(commit.signatures, sigs)])
    try:
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, tampered, device=dev)
    except CommitVerifyError as e:
        print(f"tampered commit rejected: {e}", flush=True)
    else:
        raise SystemExit("tampered commit was accepted")
    print(f"tampered rows {bad}: verify_batch ms={batch_ms:.1f} (per-signature recovery "
          f"ms={recovery_ms:.1f}) launches={launches['tampered']}", flush=True)
    return launches


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
        if not (f.get("mode") == "streamed" and f.get("fused") and "recovery_s" not in f
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
    bad = tuple(int(i) for i in np.flatnonzero(~mask))
    if bad != STREAM_TAMPERED or "recovery_s" not in batch.LAST_FLUSH:
        raise SystemExit(f"streamed tampered mask wrong: False at {bad}, expected {STREAM_TAMPERED}")
    print(f"streamed tampered rows {bad}: verify_batch ms={ms:.1f} (chunk-wise recovery "
          f"ms={batch.LAST_FLUSH['recovery_s'] * 1e3:.1f}) "
          f"launches={launches['streamed_tampered']}", flush=True)


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
    Ed25519 row. The Ed25519 rows run the card path (all six kernels), the
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

    rng = np.random.default_rng(SEED)
    rows, base = kernel_checks(dev, rng, card)
    rows += bls_kernel_checks(dev, rng, card)
    msm_reference_check(dev, rng, base)
    launches = commit_phase(dev, corpus)
    streamed_phase(dev, corpus, launches)
    mixed_commit_phase(dev, mixed, launches)
    bls_phase(dev, bls, launches)
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
