"""Batch Ed25519 verification on the card: `verify_batch -> bool mask`.

The counterpart of tendermint_tpu/crypto/batch.py's `verify_batch_jax` in the
single-device configuration with TMTPU_PREP_STREAM=0 and TMTPU_BISECT=0.
Routing on the card (backend "cuda"):

- fewer than RLC_MIN rows: the per-signature ladder (ops/ed25519_torch.py);
- RLC_MIN to planner_chunk_rows() rows (12,287 at the default budget): ONE
  random-linear-combination flush (ops/msm_torch.py), on the fused MSM
  schedule whenever a chunk tiles its lanes (every lane bucket of 1,024
  A lanes or more, so every flush this module makes). If the combined check
  fails, one per-signature flush over all rows gives the exact mask (the
  reference's non-bisect recovery);
- more rows: the streamed flush planner. Fixed chunks of planner_budget()
  lanes, each with its own B lane, are prepared on a worker thread one chunk
  ahead, run as partial MSMs, summed on the device with one padd each, and
  checked once. If that check fails, the exact mask is recovered chunk by
  chunk through the in-budget path above.

A kernel or launch failure raises: there is no retry on another schedule
and no recovery from a device error (ROADMAP.md section C).

The card path is COFACTORED with canonical encodings and s < L on every
route, so its mask never depends on the route
(crypto/ed25519_ref.verify_cofactored). `backend` picks the path, as the
reference's does: None follows the verify mode (`backend_default`), "cuda"
is the card path on `device`, "cpu" the host serial loop
(keys.Ed25519PubKey.verify, one row at a time, under the mode). In
cofactorless mode (TMTPU_ED25519_MODE, keys.set_verify_mode) the default is
the host loop, which then gives the Go reference's verdicts; an explicit
"cuda" stays on the card and cofactored.

Host prep runs in native C (native/): challenge hashes, RLC scalars, the
window sort. Decompressed public keys are cached ON THE DEVICE across calls
(consensus re-verifies one validator set every height): the first flush of a
set runs the plain kernel, which decompresses A in-kernel and fills the
cache; once every included key is cached, the cached-A kernel decompresses
only R. The streamed path decompresses A and R in every chunk, as the
reference's does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto.ed25519_ref import BASE, L, point_compress
from tendermint_tpu_torch.device import resolve

RLC_MIN = 512

BACKENDS = ("cuda", "cpu")


def backend_default() -> str:
    """The path of a verify_batch call that names no backend: the host serial
    loop in cofactorless mode (the card's kernels are cofactored by
    construction), else the card path."""
    from tendermint_tpu_torch.crypto.keys import cofactorless_mode

    return "cpu" if cofactorless_mode() else "cuda"

# RLC lane buckets (A-block size Na; total lanes = 2 Na): ~25% max padding.
_LANE_BUCKETS = [
    64, 256, 512, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 8192,
    10240, 12288, 16384, 20480, 24576, 32768,
]
_BUCKET_SIZES = [2**i for i in range(17)]  # per-signature pow2 buckets


def _bucket(n: int) -> int:
    for b in _BUCKET_SIZES:
        if n <= b:
            return b
    return n


def _lane_bucket(m: int) -> int:
    for b in _LANE_BUCKETS:
        if m <= b:
            return b
    return m


# Timings and shape of the last flush (host prep, device + sync, schedule),
# for chip_smoke.py.
LAST_FLUSH: dict = {}

# ---------------------------------------------------------------------------
# Streamed flush planner: a flush above the lane budget runs as fixed chunks
# of the budget. Each chunk carries its own B lane with scalar (L - u_k): B
# has order L, so the per-chunk B terms sum to a single flush's one term and
# the combined verdict equals a single flush's.

_PLANNER = {"max_flush_lanes": 24576}


def configure_planner(max_flush_lanes: Optional[int] = None) -> None:
    """Set the device budget per flush, in MSM lanes (process-global)."""
    if max_flush_lanes is not None:
        v = int(max_flush_lanes)
        if v < 8:  # >= 1 row + the B lane per half
            raise ValueError(f"max_flush_lanes {v} < 8")
        _PLANNER["max_flush_lanes"] = v & ~1  # even: A block + R block


def planner_budget() -> int:
    """Device budget per flush, in MSM lanes (A + B + R + pads)."""
    return _PLANNER["max_flush_lanes"]


def planner_chunk_rows() -> int:
    """Signature rows per streamed chunk: half the budget is the A block
    (rows + the chunk's B lane), the other half the R block."""
    return planner_budget() // 2 - 1


def planner_engaged(n: int) -> bool:
    """Does an n-row flush stream? Exactly when one flush would exceed the
    budget."""
    return n > planner_chunk_rows()


def _planner_chunks(n: int) -> list:
    """[(lo, hi), ...] row spans; every chunk pads to the same lanes."""
    c = planner_chunk_rows()
    return [(lo, min(lo + c, n)) for lo in range(0, n, c)]


_PREP_POOL = None  # the planner's single prep worker, made at first use
_PREP_POOL_LOCK = threading.Lock()


def _prep_pool():
    global _PREP_POOL
    if _PREP_POOL is None:
        with _PREP_POOL_LOCK:
            if _PREP_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _PREP_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="flush-prep")
    return _PREP_POOL


# ---------------------------------------------------------------------------
# Host prep (native C).


def _signed_radix16(vals: np.ndarray) -> np.ndarray:
    """uint8[N, 32] little-endian scalars (< 2^253) -> int8[64, N] signed
    radix-16 digits in [-8, 8], LSB first."""
    n = vals.shape[0]
    digits = np.empty((n, 64), dtype=np.int16)
    digits[:, 0::2] = vals & 0x0F
    digits[:, 1::2] = vals >> 4
    carry = np.zeros(n, dtype=np.int16)
    for i in range(64):
        d = digits[:, i] + carry
        carry = (d > 8).astype(np.int16)
        digits[:, i] = d - 16 * carry
    assert not carry.any()
    return np.ascontiguousarray(digits.T.astype(np.int8))


_L_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)


def _s_canonical_rows(s_rows: np.ndarray) -> np.ndarray:
    """s < L per (n, 32) little-endian row."""
    n = s_rows.shape[0]
    s_be = s_rows[:, ::-1]
    neq = s_be != _L_BE
    first = neq.argmax(axis=1)
    return neq.any(axis=1) & (s_be[np.arange(n), first] < _L_BE[first])


def _precheck_rows_fast(pubkeys, msgs, sigs):
    """Length and canonical-s checks plus the blobs the hasher takes.
    Returns (precheck bool[n], a_rows, r_rows, s_rows,
    (sigs_blob, pks_blob, msgs_blob, moffs))."""
    n = len(pubkeys)
    pubkeys = [bytes(p) for p in pubkeys]
    sigs = [bytes(s) for s in sigs]
    len_ok = np.fromiter(
        (len(p) == 32 and len(s) == 64 for p, s in zip(pubkeys, sigs)), dtype=bool, count=n
    )
    if not len_ok.all():
        zpk, zsig = bytes(32), bytes(64)
        pubkeys = [p if k else zpk for p, k in zip(pubkeys, len_ok)]
        sigs = [s if k else zsig for s, k in zip(sigs, len_ok)]
        msgs = [m if k else b"" for m, k in zip(msgs, len_ok)]
    pks_blob = b"".join(pubkeys)
    sigs_blob = b"".join(sigs)
    msgs = [bytes(m) for m in msgs]
    moffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, msgs), dtype=np.int64, count=n), out=moffs[1:])
    sig_arr = np.frombuffer(sigs_blob, dtype=np.uint8).reshape(n, 64)
    a_rows = np.frombuffer(pks_blob, dtype=np.uint8).reshape(n, 32)
    precheck = len_ok & _s_canonical_rows(sig_arr[:, 32:])
    return precheck, a_rows, sig_arr[:, :32], sig_arr[:, 32:], (
        sigs_blob, pks_blob, b"".join(msgs), moffs)


def _precheck_and_hash_fast(pubkeys, msgs, sigs):
    """Precheck + native challenge hashes h_i = SHA512(R||A||M) mod L.
    Returns (precheck, a_rows, r_rows, s_rows, h_rows); h is zero where the
    precheck fails."""
    precheck, a_rows, r_rows, s_rows, blobs = _precheck_rows_fast(pubkeys, msgs, sigs)
    h_rows = native.ed25519_h_batch(*blobs)
    h_rows[~precheck] = 0
    return precheck, a_rows, r_rows, s_rows, h_rows


def _rlc_scalars_fast(precheck: np.ndarray, s_rows: np.ndarray, h_rows: np.ndarray):
    """RLC coefficients z_i: ~124-bit, nonzero, z ≡ 0 (mod 8) so every lane's
    cofactor-torsion component is annihilated exactly; 0 for excluded rows.
    Returns (z16 (n,16) u8, w (n,32) u8 = z h mod 8L, u = sum z s mod L)."""
    n = s_rows.shape[0]
    rng = np.random.default_rng()  # OS entropy per call
    zw = rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)
    a = zw[:, 0] & np.uint64((1 << 57) - 1)
    b = zw[:, 1] | np.uint64(1)
    z = np.empty((n, 2), dtype="<u8")
    z[:, 0] = b << np.uint64(3)
    z[:, 1] = (a << np.uint64(3)) | (b >> np.uint64(61))
    z16 = z.view(np.uint8).reshape(n, 16)
    z16[~precheck] = 0
    w_rows, u = native.rlc_scalars(z16, h_rows, s_rows)
    return z16, w_rows, u


def prepare_batch(pubkeys, msgs, sigs):
    """Per-signature prep -> (a_bytes[32,B], r_bytes[32,B], s_digits[64,B],
    h_digits[64,B], precheck[n], n), B = the pow2 bucket of n."""
    n = len(pubkeys)
    b = _bucket(max(n, 1))
    a = np.zeros((b, 32), dtype=np.uint8)
    r = np.zeros((b, 32), dtype=np.uint8)
    s = np.zeros((b, 32), dtype=np.uint8)
    h = np.zeros((b, 32), dtype=np.uint8)
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(pubkeys, msgs, sigs)
    a[:n][precheck] = a_rows[precheck]
    r[:n][precheck] = r_rows[precheck]
    s[:n][precheck] = s_rows[precheck]
    h[:n][precheck] = h_rows[precheck]
    return (np.ascontiguousarray(a.T), np.ascontiguousarray(r.T), _signed_radix16(s),
            _signed_radix16(h), precheck, n)


# ---------------------------------------------------------------------------
# Decompressed-pubkey cache on the device: pubkey bytes -> column of
# _A["store"] (None = invalid encoding). Fills hold the lock and never rewrite
# a column of a store in use: the store grows by copy, and a full reset
# starts a new tensor. So (columns, store) read in one locked section stay a
# consistent pair for the flush that read them.

_A_LOCK = threading.Lock()
_A_CACHE: dict = {}
_A = {"store": None, "len": 0}
_A_CACHE_MAX = 65536


def reset_a_cache() -> None:
    with _A_LOCK:
        _A_CACHE.clear()
        _A["store"] = None
        _A["len"] = 0


def fill_a_cache(rows: np.ndarray, pts: torch.Tensor, ok) -> None:
    """Cache decompressed pubkeys: rows (m, 32) uint8 encodings, pts
    (4, 20, m) int32 coordinates on the device, ok (m,) bool (False = invalid
    encoding, cached as None)."""
    ok = np.asarray(ok.cpu() if isinstance(ok, torch.Tensor) else ok, dtype=bool)
    with _A_LOCK:
        store = _A["store"]
        if store is not None and store.device != pts.device:
            _A_CACHE.clear()
            store, _A["len"] = None, 0
        new_cols, new_src = [], []
        for j in range(rows.shape[0]):
            key = rows[j].tobytes()
            if key in _A_CACHE:
                continue
            if not ok[j]:
                _A_CACHE[key] = None
                continue
            if _A["len"] >= _A_CACHE_MAX:  # store exhausted: full reset
                _A_CACHE.clear()
                _A["len"] = 0
                new_cols, new_src = [], []
                store = None  # a fresh tensor: flushes in flight keep reading the old one
            _A_CACHE[key] = _A["len"]
            new_cols.append(_A["len"])
            new_src.append(j)
            _A["len"] += 1
        if not new_cols:
            return
        need = _A["len"]
        if store is None or store.shape[-1] < need:
            cap = max(1024, 1 << (need - 1).bit_length())
            grown = torch.empty((4, 20, min(cap, _A_CACHE_MAX)), dtype=torch.int32,
                                device=pts.device)
            if store is not None:
                grown[..., : store.shape[-1]] = store
            store = grown
        src = torch.tensor(new_src, dtype=torch.int64, device=pts.device)
        dst = torch.tensor(new_cols, dtype=torch.int64, device=pts.device)
        store[..., dst] = pts[..., src]
        _A["store"] = store


def _a_block(rows: np.ndarray, cols: np.ndarray, store: torch.Tensor, na: int,
             device) -> torch.Tensor:
    """(4, 20, Na) A block: store columns `cols` at included rows `rows`, the
    basepoint everywhere else (the B lane at row n, excluded rows, pads).
    `cols` and `store` are read in one locked section with the decision to
    run the cached-A kernel, so a concurrent cache reset cannot move them."""
    from tendermint_tpu_torch.ops import msm_torch

    base = torch.from_numpy(msm_torch.basepoint_coords()).to(device)
    block = base.unsqueeze(-1).repeat(1, 1, na)
    if len(rows):
        block[..., torch.from_numpy(rows).to(device)] = store[..., torch.from_numpy(cols).to(device)]
    return block


# ---------------------------------------------------------------------------
# The RLC flush.


class _RlcCall:
    """An RLC flush submitted to the device, not yet synced."""

    __slots__ = ("precheck", "n", "na", "mode", "dev", "pts", "a_rows", "prep_s", "t0")

    def __init__(self, precheck, n, na, mode, dev, pts, a_rows, prep_s, t0):
        self.precheck, self.n, self.na, self.mode = precheck, n, na, mode
        self.dev, self.pts, self.a_rows, self.prep_s, self.t0 = dev, pts, a_rows, prep_s, t0


def _rlc_lanes(precheck, a_rows, r_rows, s_rows, h_rows, na: int):
    """Lanes and window sort of one RLC flush over n = len(precheck) rows:
    [A_0..A_{n-1}, B, pads -> na | R_0..R_{n-1}, pads -> na]; excluded and pad
    lanes carry the basepoint with scalar 0 (bucket 0 is never summed).
    Returns (pts (2 na, 32) uint8, perm, ends)."""
    from tendermint_tpu_torch.ops import msm_torch

    n = len(precheck)
    z16, w_rows, u = _rlc_scalars_fast(precheck, s_rows, h_rows)
    b_enc = np.frombuffer(point_compress(BASE), dtype=np.uint8)
    pts = np.tile(b_enc, (2 * na, 1))
    pts[:n][precheck] = a_rows[precheck]
    pts[na : na + n][precheck] = r_rows[precheck]
    scalars = np.zeros((2 * na, 32), dtype=np.uint8)
    scalars[:n] = w_rows
    scalars[n] = np.frombuffer(((L - u) % L).to_bytes(32, "little"), dtype=np.uint8)
    scalars[na : na + n, :16] = z16
    perm, ends = msm_torch.sort_windows(scalars, zero16_from=na)
    return pts, perm, ends


def _rlc_submit(pubkeys, msgs, sigs, device) -> _RlcCall:
    """Host prep + device submit of the combined check (no sync)."""
    from tendermint_tpu_torch.ops import msm_torch

    t0 = time.perf_counter()
    n = len(pubkeys)
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(pubkeys, msgs, sigs)
    keys = [bytes(p) for p in pubkeys]
    with _A_LOCK:
        for i in np.flatnonzero(precheck):
            if _A_CACHE.get(keys[i], True) is None:  # cached-invalid encoding
                precheck[i] = False
        rows = np.flatnonzero(precheck)
        store = _A["store"]
        cached = (len(rows) > 0 and store is not None and store.device.type == device.type
                  and all(keys[i] in _A_CACHE for i in rows))
        if cached:  # the columns are valid only together with this store
            cols = np.fromiter((_A_CACHE[keys[i]] for i in rows), dtype=np.int64, count=len(rows))
    na = _lane_bucket(n + 1)
    pts, perm, ends = _rlc_lanes(precheck, a_rows, r_rows, s_rows, h_rows, na)
    prep_s = time.perf_counter() - t0
    if cached:
        dev = msm_torch.rlc_check_cached_submit(
            _a_block(rows, cols, store, na, device), pts[na:], perm, ends)
        return _RlcCall(precheck, n, na, "cached", dev, None, None, prep_s, t0)
    dev, dpts = msm_torch.rlc_check_submit(pts, perm, ends, device)
    return _RlcCall(precheck, n, na, "plain", dev, dpts, a_rows, prep_s, t0)


def _rlc_finish(call: _RlcCall) -> Optional[np.ndarray]:
    """ONE device-to-host copy; the mask when the combined check passes, None
    when the caller must recover per signature."""
    from tendermint_tpu_torch.ops import msm_torch

    out = call.dev.cpu().numpy()  # [batch_ok, lane_ok...]
    precheck, n, na = call.precheck, call.n, call.na
    ok = out[1:]
    if call.mode == "cached":
        lanes_ok = bool(ok[:n][precheck].all())
    else:
        lanes_ok = bool(ok[:n][precheck].all() and ok[na : na + n][precheck].all())
        if precheck.any():  # steady state then runs the cached-A kernel
            rows = np.flatnonzero(precheck)
            fill_a_cache(call.a_rows[rows], call.pts[..., torch.from_numpy(rows).to(call.pts.device)],
                         ok[rows])
    LAST_FLUSH.update(mode=call.mode, prep_s=call.prep_s, total_s=time.perf_counter() - call.t0,
                      lanes=2 * na, fused=msm_torch.fused_for_lanes(2 * na))
    return precheck if (bool(out[0]) and lanes_ok) else None


def _verify_serial_host(pubkeys, msgs, sigs) -> np.ndarray:
    """The host serial loop (the reference's _verify_serial_host): each row
    through keys.Ed25519PubKey.verify, under the verify mode."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey

    out = np.zeros(len(pubkeys), dtype=bool)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        try:
            out[i] = Ed25519PubKey(bytes(pk)).verify(bytes(msg), bytes(sig))
        except ValueError:  # a key that is not 32 bytes
            out[i] = False
    return out


def _persig_flush(pubkeys, msgs, sigs, device) -> np.ndarray:
    """The per-signature ladder over all rows: device mask & host precheck."""
    from tendermint_tpu_torch.ops.ed25519_torch import verify_prepared

    a, r, s_d, h_d, precheck, n = prepare_batch(pubkeys, msgs, sigs)
    t = [torch.from_numpy(x).to(device) for x in (a, r, s_d, h_d)]
    mask = verify_prepared(*t).cpu().numpy()[:n]
    return mask & precheck


def _prep_stream_chunk(pubkeys, msgs, sigs, lo: int, hi: int, na_c: int):
    """Host prep of one planner chunk on the prep worker: rows [lo, hi) in
    the plain-kernel lane layout with the chunk's own B lane. Returns
    (precheck (hi-lo,), pts (2 na_c, 32), perm, ends, prep seconds)."""
    t0 = time.perf_counter()
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(
        pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi])
    pts, perm, ends = _rlc_lanes(precheck, a_rows, r_rows, s_rows, h_rows, na_c)
    return precheck, pts, perm, ends, time.perf_counter() - t0


def _verify_batch_rlc_streamed(pubkeys, msgs, sigs, device) -> Optional[np.ndarray]:
    """The streamed combined check: chunk k+1's host prep runs on the prep
    worker while chunk k's kernels run; each chunk's partial point is added
    to a device accumulator with one padd; at most 2 chunks are in flight
    (the older chunk's lane flags are synced before a third is submitted);
    one identity check at the end. Returns the mask when the check passes,
    None when the caller must recover the exact mask."""
    from tendermint_tpu_torch.ops import msm_torch

    t0 = time.perf_counter()
    n = len(pubkeys)
    na_c = planner_budget() // 2
    chunks = _planner_chunks(n)
    pool = _prep_pool()
    prechecks: list = [None] * len(chunks)
    inflight: deque = deque()  # (chunk index, lane flags, event or None)
    acc = None
    lanes_ok = True
    prep_s = wait_s = 0.0
    peak = 0

    def sync_oldest():
        k, flags, ev = inflight.popleft()
        if ev is not None:
            ev.synchronize()  # this chunk's kernels and flag copy, not later ones
        ok = flags.numpy()
        pc = prechecks[k]
        c = chunks[k][1] - chunks[k][0]
        return not pc.any() or bool(ok[:c][pc].all() and ok[na_c : na_c + c][pc].all())

    fut = pool.submit(_prep_stream_chunk, pubkeys, msgs, sigs, *chunks[0], na_c)
    for k in range(len(chunks)):
        tw = time.perf_counter()
        precheck, pts, perm, ends, chunk_prep_s = fut.result()
        wait_s += time.perf_counter() - tw
        prep_s += chunk_prep_s
        prechecks[k] = precheck
        if k + 1 < len(chunks):
            fut = pool.submit(_prep_stream_chunk, pubkeys, msgs, sigs, *chunks[k + 1], na_c)
        part, ok = msm_torch.rlc_partial_submit(pts, perm, ends, device)
        acc = part if acc is None else msm_torch.partial_fold_submit(acc, part)
        if device.type == "cuda":
            flags = torch.empty(ok.shape, dtype=torch.bool, pin_memory=True)
            flags.copy_(ok, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            flags, ev = ok, None
        inflight.append((k, flags, ev))
        peak = max(peak, len(inflight) * 2 * na_c)
        if len(inflight) >= 2:
            lanes_ok &= sync_oldest()
    while inflight:
        lanes_ok &= sync_oldest()
    batch_ok = bool(msm_torch.partial_identity_submit(acc).item())
    LAST_FLUSH.update(mode="streamed", fused=msm_torch.fused_for_lanes(2 * na_c),
                      chunks=len(chunks), chunk_lanes=2 * na_c, peak_lanes_in_flight=peak,
                      lanes=len(chunks) * 2 * na_c, prep_s=prep_s, prep_wait_s=wait_s,
                      total_s=time.perf_counter() - t0)
    if batch_ok and lanes_ok:
        return np.concatenate(prechecks)
    return None


def _verify_batch_streamed(pubkeys, msgs, sigs, device) -> np.ndarray:
    """Planner-engaged verification: the streamed combined check; when it
    fails, the exact mask chunk by chunk through the in-budget path (each
    chunk at most the budget, so recovery never exceeds it either)."""
    mask = _verify_batch_rlc_streamed(pubkeys, msgs, sigs, device)
    if mask is not None:
        return mask
    detail = dict(LAST_FLUSH)
    t0 = time.perf_counter()
    parts = [verify_batch(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], device=device,
                          backend="cuda")
             for lo, hi in _planner_chunks(len(pubkeys))]
    LAST_FLUSH.clear()
    LAST_FLUSH.update(detail, recovery_s=time.perf_counter() - t0)
    return np.concatenate(parts)


def _verify_sr25519_rows(pubkeys, msgs, sigs, idx) -> np.ndarray:
    """The rows `idx` by the native schnorrkel verifier, in one call on the
    prep threads. A row whose signature is not 64 bytes or whose key is not
    32 is False before packing: the blobs are fixed-stride, and upstream
    ValidateBasic bounds signatures only at <= 64 bytes."""
    out = np.zeros(len(idx), dtype=bool)
    ok = [j for j, i in enumerate(idx)
          if len(bytes(sigs[i])) == 64 and len(bytes(pubkeys[i])) == 32]
    if ok:
        rows = [idx[j] for j in ok]
        srm = [bytes(msgs[i]) for i in rows]
        moffs = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, srm), dtype=np.int64, count=len(srm)), out=moffs[1:])
        out[ok] = native.sr25519_verify_batch(
            b"".join(bytes(pubkeys[i]) for i in rows), b"".join(srm), moffs,
            b"".join(bytes(sigs[i]) for i in rows))
    return out


def _verify_batch_mixed_exact(pubkeys, msgs, sigs, key_types, device, backend) -> np.ndarray:
    """Per-type routing of a set that holds non-ed25519 rows (the reference's
    _verify_batch_mixed_exact): ed25519 rows through verify_batch on
    `backend`, sr25519 rows by the native schnorrkel verifier on the host,
    bls12_381 rows through bls_ref.verify on the host (a signature that is
    not 96 bytes is False), any unknown type False. LAST_FLUSH holds the
    ed25519 flush's detail (none without ed25519 rows) and the sr25519 row
    count and host seconds."""
    out = np.zeros(len(pubkeys), dtype=bool)
    bls_idx = [i for i, t in enumerate(key_types) if t == "bls12_381"]
    ed_idx = [i for i, t in enumerate(key_types) if t == "ed25519"]
    sr_idx = [i for i, t in enumerate(key_types) if t == "sr25519"]
    if bls_idx:
        from tendermint_tpu_torch.crypto import bls_ref

        for i in bls_idx:
            sig = bytes(sigs[i])
            out[i] = len(sig) == bls_ref.SIGNATURE_SIZE and bls_ref.verify(
                bytes(pubkeys[i]), bytes(msgs[i]), sig)
    LAST_FLUSH.clear()
    if ed_idx:
        out[ed_idx] = verify_batch([pubkeys[i] for i in ed_idx], [msgs[i] for i in ed_idx],
                                   [sigs[i] for i in ed_idx], device=device, backend=backend)
    if sr_idx:
        t0 = time.perf_counter()
        out[sr_idx] = _verify_sr25519_rows(pubkeys, msgs, sigs, sr_idx)
        LAST_FLUSH.update(sr25519_rows=len(sr_idx), sr25519_s=time.perf_counter() - t0)
    return out


def verify_batch(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], device=None,
    key_types: Optional[Sequence[str]] = None, backend: Optional[str] = None,
) -> np.ndarray:
    """Verify N (pubkey, msg, sig) triples; returns bool[N]. key_types: per-row
    key type, None meaning all ed25519; a set with other types takes the
    per-type routing of _verify_batch_mixed_exact. backend: "cuda" (the card
    path on `device`), "cpu" (the host serial loop) or None
    (backend_default(): the verify mode decides)."""
    if not (len(pubkeys) == len(msgs) == len(sigs)):
        raise ValueError("pubkeys/msgs/sigs length mismatch")
    be = backend_default() if backend is None else backend
    if be not in BACKENDS:
        raise ValueError(f"unknown crypto backend {be!r}")
    dev = resolve(device) if be == "cuda" else None
    n = len(pubkeys)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if key_types is not None and any(t != "ed25519" for t in key_types):
        return _verify_batch_mixed_exact(pubkeys, msgs, sigs, key_types, device, backend)
    LAST_FLUSH.clear()
    if be == "cpu":
        t0 = time.perf_counter()
        mask = _verify_serial_host(pubkeys, msgs, sigs)
        LAST_FLUSH.update(mode="host_serial", total_s=time.perf_counter() - t0)
        return mask
    if n < RLC_MIN:
        LAST_FLUSH.update(mode="persig")
        return _persig_flush(pubkeys, msgs, sigs, dev)
    if planner_engaged(n):
        return _verify_batch_streamed(pubkeys, msgs, sigs, dev)
    mask = _rlc_finish(_rlc_submit(pubkeys, msgs, sigs, dev))
    if mask is not None:
        return mask
    t0 = time.perf_counter()
    mask = _persig_flush(pubkeys, msgs, sigs, dev)
    LAST_FLUSH.update(recovery_s=time.perf_counter() - t0)
    return mask
