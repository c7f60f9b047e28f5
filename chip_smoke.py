#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (tendermint_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card, nvcc and gcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. the card (nvidia-smi name and power limit), torch / CUDA / nvcc versions;
  2. build the CUDA kernels (nvcc, sm_90a) and the native host prep (gcc);
  3. each kernel against its plain torch version on the card at the shapes
     each of the three paths below gives it, tolerance zero (integer
     arithmetic), with its time, the plain version's time and its bound;
     plus the MSM total against the integer reference on a small input;
  4. a 10,000-validator commit (random keys from a seed, real signatures over
     each row's precommit sign bytes) through ValidatorSet.verify_commit on
     two paths: "cold" (plain kernel: A and R decompressed together, fills
     the A cache) and "warm" (cached-A kernel), then one more warm call under
     torch.profiler (device busy time, idle share, kernels by device time);
  5. the "tampered" path: three tampered signatures, so verify_batch's
     combined check fails and the per-signature recovery gives the mask, which
     must be False exactly there; verify_commit raises CommitVerifyError;
  6. a `kernels` JSON line, the card line, and last the `ok` JSON line.
The launch counts are zeroed just before each path and read just after it
(the warm path per call); every kernel must launch on every path.
Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
N_VALIDATORS = 10_000
CHAIN_ID = "chip-smoke-chain"
HEIGHT = 7
TAMPERED = (17, 4242, 9_999)

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


def imad_seconds(mads_per_lane: int, lanes: int, card: dict) -> float:
    """Least time for `lanes` threads of `mads_per_lane` int32 multiply-adds
    each. A warp instruction takes a sub-partition's 16 lanes per clock for
    all 32 lanes, active or not, and a launch of a few warps occupies only
    that many sub-partitions, not the whole card."""
    warps = -(-lanes // 32)
    parts = min(warps, card["sms"] * SM_PARTITIONS)
    per_part = INT32_MAD_PER_SM_PER_CLK / SM_PARTITIONS
    return warps * 32 * mads_per_lane / (parts * per_part * card["clock_hz"])


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, reps: int = 5):
    """Warm median of `reps` runs in ms, by CUDA events."""
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


def kernel_checks(dev, rng, card: dict) -> list:
    """Each kernel against its plain version at the shapes of each path:
    warm (cached A: R decompressed on 10,240 lanes), cold (A and R on 20,480)
    and tampered (the per-signature ladder on the 16,384-lane bucket)."""
    from tendermint_tpu_torch.ops import cuda_fe, msm_torch

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
                    replaces="tendermint_tpu/ops/pallas_fe.py:249",
                    kern=lambda: cuda_fe.padd(p, q), plain=lambda: cuda_fe.padd_plain(p, q),
                    mads=PADD_MADS, bytes=3 * POINT_BYTES * lanes)

    def pdbl_case(path, lanes, times, where):
        p = pick(lanes)
        return dict(name="pdbl", path=path, variant=f"times={times}, {where}", lanes=lanes,
                    replaces="tendermint_tpu/ops/pallas_fe.py:262",
                    kern=lambda: cuda_fe.pdbl(p, times), plain=lambda: cuda_fe.pdbl_plain(p, times),
                    mads=pdbl_mads(times),
                    bytes=(3 * 80 + POINT_BYTES) * lanes)  # x, y, z in (t is not read), 4 out

    def fsq_case(path, lanes, where):
        x = pick(lanes)[1].contiguous()
        return dict(name="fsquare_chain", path=path, variant=f"k=50, {where}", lanes=lanes,
                    replaces="tendermint_tpu/ops/pallas_fe.py:275",
                    kern=lambda: cuda_fe.fsquare_chain(x, 50),
                    plain=lambda: cuda_fe.fsquare_chain_plain(x, 50),
                    mads=50 * SQR, bytes=2 * 80 * lanes)

    cases = [
        padd_case("warm", 32 * 10_240, "MSM tree level 1: 32 windows x 10,240 pairs"),
        padd_case("tampered", 16_384, "per-signature ladder"),
        pdbl_case("warm", 32, 8, "[256] P_255 per window"),
        pdbl_case("warm", 1, 128, "last window-fold level"),
        pdbl_case("tampered", 16_384, 4, "per-signature ladder"),
        fsq_case("warm", 10_240, "R decompression"),
        fsq_case("cold", 20_480, "A and R decompression"),
        fsq_case("tampered", 16_384, "per-signature A or R decompression"),
    ]

    rows = []
    for c in cases:
        got = c["kern"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:  # limb-identical, so equal after freeze too
            raise SystemExit(f"kernel {c['name']} {c['variant']} disagrees with its "
                             f"plain version: max |err| {err}")
        ms = timed(c["kern"])
        plain_ms = timed(c["plain"])
        t_ops = imad_seconds(c["mads"], c["lanes"], card) * 1e3
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        row = dict(
            name=c["name"], path=c["path"], variant=c["variant"], lanes=c["lanes"], route="cuda",
            source="tendermint_tpu_torch/csrc/point_kernels.cu", replaces=c["replaces"],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
        )
        rows.append(row)
        print(f"kernel {row['name']} [{row['path']}] {row['variant']} lanes={row['lanes']}: "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) max_abs_err={err} library_ms=null", flush=True)
    return rows


def msm_reference_check(dev, rng) -> None:
    """The unfused MSM total on the card against the integer MSM at 64 lanes
    (A block with ~2^253 scalars, R block with < 2^128), by canonical encoding."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import ed25519_torch, msm_torch

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
    got = bytes(ed25519_torch.compress(total.reshape(4, 20, 1).contiguous())[:, 0].cpu().numpy())
    if got != ref.point_compress(want):
        raise SystemExit("MSM total on the card differs from the integer reference")
    print("msm total (64 lanes) equals the ed25519_ref integer MSM", flush=True)


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


def profile_warm(fn, warm_ms: float) -> None:
    """One warm verify_commit under torch.profiler: device busy time (sum of
    kernel times; one stream, so kernels do not overlap), the idle share
    against the unprofiled warm median, and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        print("profile: the profiler recorded no device time (device busy: not measured)")
        return
    n_kernels = sum(e.count for e in rows)
    print(f"profile: device_busy_ms={busy_us / 1e3:.2f} kernels={n_kernels} "
          f"idle_share={1 - busy_us / 1e3 / warm_ms:.3f} (vs warm median {warm_ms:.1f} ms)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def read_launches(path: str) -> dict:
    """The launch counts since the last reset; every kernel must have run."""
    from tendermint_tpu_torch.ops import cuda_fe

    counts = dict(cuda_fe.LAUNCHES)
    for name, count in counts.items():
        if count <= 0:
            raise SystemExit(f"kernel {name} was not launched on the {path} path")
    return counts


def commit_phase(dev, corpus) -> dict:
    """The three paths, each with its own launch counts: {path: {kernel: n}}."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_fe
    from tendermint_tpu_torch.types.block import Commit, CommitSig
    from tendermint_tpu_torch.types.validator_set import CommitVerifyError

    vals, block_id, commit, msgs = corpus
    batch.reset_a_cache()
    launches = {}

    # Cold: the plain kernel decompresses A and R together and fills the cache.
    cuda_fe.reset_launches()
    t0 = time.perf_counter()
    vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches["cold"] = read_launches("cold")
    cold = dict(batch.LAST_FLUSH)
    assert cold.get("mode") == "plain" and "recovery_s" not in cold, cold

    # Warm: the cached-A kernel; counts per call, the same on every call.
    warm, warm_flush = [], []
    for _ in range(7):
        cuda_fe.reset_launches()
        t0 = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        counts = read_launches("warm")
        if launches.setdefault("warm", counts) != counts:
            raise SystemExit(f"warm calls launched different counts: {launches['warm']} vs {counts}")
        warm_flush.append(dict(batch.LAST_FLUSH))
    for f in warm_flush:
        assert f.get("mode") == "cached" and "recovery_s" not in f, f
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
          f"(A block {cold['lanes'] // 2})", flush=True)
    print(f"launches cold={launches['cold']} warm per call={launches['warm']}", flush=True)
    profile_warm(lambda: vals.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, device=dev),
                 statistics.median(warm))

    # Tampered: the cached flush fails, the per-signature recovery gives the mask.
    pubkeys = [vals.validators[i].pub_key.bytes() for i in range(N_VALIDATORS)]
    sigs = [cs.signature for cs in commit.signatures]
    for i in TAMPERED:
        s = bytearray(sigs[i])
        s[40] ^= 0x01
        sigs[i] = bytes(s)
    cuda_fe.reset_launches()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.ops import cuda_fe

    # The signing pool forks before this process first touches the card.
    corpus = build_commit(np.random.default_rng(SEED + 1))
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
    cuda_fe.build()
    native._lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {cuda_fe.BUILD_LOG['seconds']:.1f} s)",
          flush=True)
    for line in cuda_fe.BUILD_LOG["ptxas"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)

    rng = np.random.default_rng(SEED)
    rows = kernel_checks(dev, rng, card)
    msm_reference_check(dev, rng)
    launches = commit_phase(dev, corpus)
    for r in rows:  # the count on the path whose shape the row checks
        r["launches"] = launches[r["path"]][r["name"]]
    print(json.dumps({"kernels": rows, "launches_by_path": launches}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
