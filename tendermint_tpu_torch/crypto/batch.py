"""Batch Ed25519 verification: `verify_batch -> bool mask`.

The counterpart of tendermint_tpu/crypto/batch.py's `verify_batch`, with
the reference's knobs, defaults and route labels (LAST_FLUSH["path"]: the
third value of the reference's `_verify_batch_routed`), on one card or on a
mesh of cards (below).

`backend` picks the arm, as the reference's does. None follows
`backend_default`: the host in cofactorless mode, else TMTPU_CRYPTO_BACKEND
when it is set, else the card; on the card, a call of fewer than
_CUDA_MIN_BATCH = 256 rows (env TMTPU_JAX_MIN) runs on the host unless its
`device` names a card (the reference has no device argument: a caller who
names the card gets it). "cpu" is the host arm at every size, "cuda" the
card arm at every size ("jax", the reference's name for its device arm, is
read as "cuda", in the variable and in `backend=`); any other name raises
ValueError. TMTPU_RLC=0 turns the combined check off, as in the reference:
the card arm runs one per-signature pass at every size. The
arm is chosen by row count, verify mode and the caller's `device` only,
never by whether a card is present: a card call resolves `device`
(device.resolve raises without a card).

The host arm (`verify_batch_cpu`, path "cpu"): from _HOST_RLC_MIN = 48 rows
(env TMTPU_HOST_RLC_MIN), and not in cofactorless mode, the combined check
on host points (a Pippenger MSM over crypto/ed25519_ref), striped on the
prep worker above the stream floor; when it fails, the host bisection over
host sub-checks and serial leaves. Fewer rows, and cofactorless mode, run the
serial loop (keys.Ed25519PubKey.verify under the mode).

The card arm (`verify_batch_cuda`):

- fewer than RLC_MIN rows: the per-signature ladder (ops/ed25519_torch.py),
  path "persig";
- RLC_MIN to planner_chunk_rows() rows (12,287 at the default budget): from
  the stream floor (TMTPU_PREP_STREAM_FLOOR = 2,048) with the stream on
  (TMTPU_PREP_STREAM = 1), the pipelined 2-chunk stream (head max(RLC_MIN,
  n // 8) rows, the tail's host prep on the prep worker while the head's
  kernels run; "rlc-pipelined"); below it, or with the stream off, ONE
  random-linear-combination flush (ops/msm_torch.py; "rlc"), with its
  challenge hashing on the prep worker when staged (TMTPU_PREP_STAGED = 1).
  If the combined check fails, bisection (TMTPU_BISECT = 1;
  "rlc-bisect") or one per-signature flush over all rows
  (TMTPU_BISECT = 0) gives the exact mask;
- more rows: the streamed flush planner ("rlc-streamed"). Fixed chunks of
  planner_budget() lanes, each with its own B lane, are prepared on the prep
  worker one chunk ahead, run as partial MSMs, summed on the device with one
  padd each, and checked once. If that check fails, each chunk runs the
  in-budget path above ("rlc-streamed-recovery").

While a mesh stands (`_sharded_env`: two healthy cards or more, the
largest power of two of them; or a mesh a caller pinned) the card arm's
flushes run sharded across it (parallel/sharded.py) at the reference's
points: the combined check ("rlc-sharded"), the per-signature ladder
("sharded"), the bisection's halves and the streamed planner
("rlc-sharded-streamed"). A failed sharded flush strikes its shard in the
health model (parallel/health.py), drops the mesh and raises.

A kernel or launch failure raises: there is no retry on another schedule,
no replay on another mesh and no recovery from a device error (ROADMAP.md
section C). The host arm's two catches (a host combined check that raises
counts as failed) touch no device.

A set holding other key types (`key_types`) takes, as the reference's does,
ONE mixed combined check on the card ("rlc-mixed": Ed25519 R lanes
decompressed as Edwards points, sr25519 R lanes decoded as ristretto255
points, both types' keys from the typed A cache, the sr25519 challenges
from merlin transcripts run in lockstep) when it is on the card arm, holds
RLC_MIN rows or more, is within the planner's budget and has only Ed25519
and sr25519 rows; when that check fails, or the set is not eligible, the
exact per-type split (`_verify_batch_mixed_exact`, "mixed": Ed25519 rows
through verify_batch, sr25519 rows by the native schnorrkel verifier,
BLS12-381 rows by bls_ref, others False).

Submit / finish (`verify_batch_submit`, `verify_batch_finish`, the
reference's rule): a set of Ed25519 (or Ed25519 and sr25519) rows, RLC_MIN
or more on the card arm and within the planner's budget, queues one
combined check and returns; its finish syncs it ("rlc-async") or recovers
the exact mask by one per-signature pass ("persig-async"), a mixed set by
the per-type split. Anything else runs verify_batch at submit. Inside
`accumulate_flushes()` (thread-local) submits join a FlushAccumulator,
whose one verify_batch call every finish slices.

Before any route, the verified-row memo (`VerifiedRowMemo`, 65,536 rows,
env TMTPU_VERIFIED_MEMO_ROWS, on by default as in the reference) answers
rows that verified True before: a call whose rows all hit takes path
"memo" with no flush, a partial hit verifies only the rest, and the True
rows of every flush and finish are inserted.

Then, as in the reference, a lane router installed by crypto/scheduler.py
(`set_lane_router`) takes the rows of a call made inside a scheduler's
`lane_scope` to that lane. Every flush and finish is recorded by
libs/trace.py's `record_flush` (its span gated on one tracer flag read),
and `verify_batch(..., sources=)` feeds the rows' verdicts to the
suspicion scorer (crypto/provenance.py). The reference's circuit breaker
has no counterpart (ROADMAP D1). `_PATH.label`, the route label, is kept
per thread: a vote flush on its caller's thread and the scheduler's
dispatch thread route at the same time, while LAST_FLUSH stays
process-global (last flush wins).

Observability, as in the reference: every flush's record_flush carries the
prep, transfer and build seconds, the lane bucket and padding, the A
cache's hits and misses, the bytes uploaded and the launches the submit
made (`h2d_bytes`, `device_dispatches`: deltas of per-thread counters, so
each flush counts its own thread's launches), and feeds the flush series of libs/metrics.py;
`record_backend_rows` counts each row once under its own scheme; the
verified-row memo counts its hits; and each device round trip (the single
flush's finish, the per-signature ladder, the streamed planner's sync) is a
libs/trace.mark_device_call: a device error marks the device down and
re-raises. Each of them stamps its site into the forensics heartbeat first
(libs/forensics.beat), then calls the device fault hook
(set_device_fault_hook, chaos/device.py), as the reference's
`_device_fault(site)` does; the reference's "probe" site belongs to its
circuit breaker, which the port leaves out (ROADMAP D1).

Every route is COFACTORED with canonical encodings and s < L, except the
serial loop in cofactorless mode, so a mask never depends on the route
(crypto/ed25519_ref.verify_cofactored).

Host prep runs in native C (native/): challenge hashes, RLC scalars, the
window sort (on the device instead with TMTPU_DEVICE_SORT=1, cached-A
Ed25519 flushes only, off by default as in the reference). Decoded public
keys are cached ON THE DEVICE across calls, keyed by key type: the first
single flush of a set runs the plain kernel, which decompresses A in-kernel
and fills the cache; once every included key is cached, the cached-A kernel
decompresses only R. A mixed flush fills the cache for both types first.
The pipelined and streamed paths decompress A and R in every chunk, as the
reference's do.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict, deque, namedtuple
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from tendermint_tpu_torch import native
from tendermint_tpu_torch.libs.profiler import PERSIG
from tendermint_tpu_torch.crypto.ed25519_ref import BASE, L, point_compress
from tendermint_tpu_torch.device import resolve
from tendermint_tpu_torch.libs import forensics as _forensics
from tendermint_tpu_torch.libs import trace as _trace

RLC_MIN = 512
L8 = 8 * L  # full curve-group order: the A-lane scalar modulus
RLC_KEY_TYPES = ("ed25519", "sr25519")  # the key types a combined check takes

BACKENDS = ("cuda", "cpu")

# A call that names no backend runs on the host below this many rows.
_CUDA_MIN_BATCH = int(os.environ.get("TMTPU_JAX_MIN", "256"))


def record_backend_rows(backend: str, rows: int) -> None:
    """One (rows, flush) observation on the per-scheme series
    (tendermint_batch_verify_backend_*): each routing site that settles rows
    of a scheme calls it once for them; verify_aggregate_commit counts each
    signer as one bls12_381 row."""
    from tendermint_tpu_torch.libs import metrics as _metrics

    m = _metrics.batch_metrics()
    m.backend_rows.labels(backend).inc(rows)
    m.backend_flushes.labels(backend).inc()


_DEVICE_FAULT_HOOK = None  # callable(site: str) -> None; may raise or sleep

# the attribute `_on_device` sets on an error raised inside it (the site's
# name), which is_device_error reads
DEVICE_ERROR_ATTR = "tmtpu_device_site"


def set_device_fault_hook(fn) -> None:
    """Install (or clear, with None) the device fault hook
    (chaos/device.DeviceFaultInjector), as in the reference."""
    global _DEVICE_FAULT_HOOK
    _DEVICE_FAULT_HOOK = fn


def _device_fault(site: str) -> None:
    """The reference's entry-point call: the forensics beat, then the hook."""
    _forensics.beat(site)
    hook = _DEVICE_FAULT_HOOK
    if hook is not None:
        hook(site)


def device_error_of(exc: BaseException) -> Optional[BaseException]:
    """The error in `exc`'s chain (itself, or one it was raised from or
    during) that came out of device work (`_on_device` marked it), else
    None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if getattr(exc, DEVICE_ERROR_ATTR, None) is not None:
            return exc
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None


def is_device_error(exc: BaseException) -> bool:
    """True when `exc`, or an exception it was raised from or during, came
    out of device work. Callers that turn protocol failures into something
    else (statesync's snapshot rejection, the node's fallback) let such
    errors through (ROADMAP D1)."""
    return device_error_of(exc) is not None


@contextlib.contextmanager
def _on_device(site: str, sync: bool = False, hook: bool = True):
    """Device work at `site` (rlc_submit, rlc_finish, persig, the mesh's
    sites): the forensics heartbeat stamps the site first, before anything
    that can hang (libs/forensics.py; one None check when forensics is off),
    then the device fault hook runs, as the reference's `_device_fault` does
    (`hook=False` at the sharded sites where the reference calls no hook:
    parallel/sharded.py's shard hook fires there). An error, injected or
    real, is marked (is_device_error), marks the device down
    (libs/trace.mark_device_call) and re-raises, with no fallback (ROADMAP
    D1); a completed round trip (`sync`) marks it up."""
    try:
        if hook:
            _device_fault(site)
        else:
            _forensics.beat(site)
        yield
    except Exception as e:
        try:
            setattr(e, DEVICE_ERROR_ATTR, site)
        except AttributeError:  # an exception type without a __dict__
            pass
        _trace.mark_device_call(ok=False, error=repr(e))
        raise
    if sync:
        _trace.mark_device_call(ok=True)


def _names_card(device) -> bool:
    """An explicit card `device` asks for the card arm at every row count."""
    return device is not None and torch.device(device).type == "cuda"


def _card_alias(backend: Optional[str]) -> Optional[str]:
    """The reference's name of its device arm, "jax", is the card arm here."""
    return "cuda" if backend == "jax" else backend


def _rlc_enabled() -> bool:
    """TMTPU_RLC=0 turns the combined check off: the card arm runs one
    per-signature pass at every size and no submit is asynchronous."""
    return os.environ.get("TMTPU_RLC", "1") != "0"


def backend_default() -> str:
    """The arm of a verify_batch call that names no backend: the host in
    cofactorless mode (the card's kernels are cofactored by construction),
    else TMTPU_CRYPTO_BACKEND when set ("jax", the reference's device arm,
    read as "cuda"; an unknown name is returned as it is and refused by
    verify_batch), else the card (below _CUDA_MIN_BATCH rows, the host all
    the same)."""
    from tendermint_tpu_torch.crypto.keys import cofactorless_mode

    if cofactorless_mode():
        return "cpu"
    env = os.environ.get("TMTPU_CRYPTO_BACKEND")
    if env:
        return _card_alias(env)
    return "cuda"

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
# Verified-row memo (the reference's VerifiedRowMemo): a bounded LRU of
# digests of rows that verified True. A commit made from votes that a
# deferred VoteSet flush already verified is answered from it with no flush.
# Only True rows enter (a flush that raises inserts nothing); the digest is
# length-framed over the verify mode, key type, key, message and signature,
# so a changed byte or a mode flip misses; capacity 0 turns it off.


class VerifiedRowMemo:
    """Bounded LRU of verified-row digests; thread-safe."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(0, int(capacity))
        self._rows: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def digest_rows(self, pubkeys, msgs, sigs, key_types=None) -> list:
        """SHA-256 per row of the mode byte, then each of key type, key,
        message and signature framed by its 4-byte little-endian length."""
        from tendermint_tpu_torch.crypto.keys import cofactorless_mode

        mode = b"\x01" if cofactorless_mode() else b"\x00"
        out = []
        for i in range(len(pubkeys)):
            kt = (key_types[i] if key_types is not None else "ed25519").encode()
            h = hashlib.sha256(mode)
            for part in (kt, bytes(pubkeys[i]), bytes(msgs[i]), bytes(sigs[i])):
                h.update(len(part).to_bytes(4, "little"))
                h.update(part)
            out.append(h.digest())
        return out

    def lookup(self, digests) -> np.ndarray:
        """Per-row hit mask; hits are refreshed in the LRU order."""
        out = np.zeros(len(digests), dtype=bool)
        if self.capacity == 0 or not digests:
            return out
        with self._lock:
            for i, d in enumerate(digests):
                if d in self._rows:
                    self._rows.move_to_end(d)
                    out[i] = True
            nh = int(out.sum())
            self.hits += nh
            self.misses += len(digests) - nh
        if nh:
            from tendermint_tpu_torch.libs import metrics as _metrics

            _metrics.batch_metrics().memo_hits.inc(nh)
        return out

    def insert(self, digests, mask) -> None:
        """Record the rows whose verdict is True, evicting the oldest past
        the capacity."""
        if self.capacity == 0 or digests is None:
            return
        with self._lock:
            for i, d in enumerate(digests):
                if not mask[i]:
                    continue
                if d in self._rows:
                    self._rows.move_to_end(d)
                    continue
                self._rows[d] = None
                self.insertions += 1
                if len(self._rows) > self.capacity:
                    self._rows.popitem(last=False)
                    self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def __contains__(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._rows

    def stats(self) -> dict:
        with self._lock:
            size = len(self._rows)
        return {"capacity": self.capacity, "rows": size, "hits": self.hits,
                "misses": self.misses, "insertions": self.insertions,
                "evictions": self.evictions}


def _memo_env_rows() -> int:
    try:
        return int(os.environ.get("TMTPU_VERIFIED_MEMO_ROWS", "65536"))
    except ValueError:
        return 65536


_MEMO = VerifiedRowMemo(_memo_env_rows())


def configure_verified_memo(rows: Optional[int] = None) -> None:
    """Resize the memo (0 turns it off). Resizing replaces it: no verdict
    outlives a capacity change."""
    global _MEMO
    if rows is not None:
        _MEMO = VerifiedRowMemo(rows)


def verified_memo_stats() -> dict:
    return _MEMO.stats()


def configure_mesh_health(**kwargs) -> None:
    """Apply `[crypto] mesh_health_*` config (node/node.py): the mesh health
    model's scoring thresholds and rejoin hysteresis (parallel/health.py)."""
    from tendermint_tpu_torch.parallel import health as _mh

    _mh.MESH_HEALTH.configure(**kwargs)

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
# Prep pipeline configuration: the reference's env names and defaults, so one
# node config drives both packages.
#
#   staged        a single flush hashes its challenges on the prep worker while
#                 the dispatch thread builds the A block (TMTPU_PREP_STAGED);
#   stream        an in-budget flush of stream_floor rows or more runs as the
#                 pipelined 2-chunk stream (TMTPU_PREP_STREAM);
#   stream_floor  TMTPU_PREP_STREAM_FLOOR, default 2,048 rows;
#   host_stripe   the host combined check above the stream floor runs in
#                 stripes whose prep overlaps the previous stripe's MSM
#                 (TMTPU_HOST_STRIPE: "auto" = only on a host of more than one
#                 core, "0" = never, anything else = always).


def _prep_env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) != "0"


def _host_stripe_env(default: str = "auto"):
    v = os.environ.get("TMTPU_HOST_STRIPE", default)
    if v == "0":
        return False
    if v in ("auto", ""):
        return "auto"
    return True


_PREP_CFG = {
    "staged": _prep_env_flag("TMTPU_PREP_STAGED", "1"),
    "stream": _prep_env_flag("TMTPU_PREP_STREAM", "1"),
    "stream_floor": max(1, int(os.environ.get("TMTPU_PREP_STREAM_FLOOR", "2048") or 2048)),
    "host_stripe": _host_stripe_env(),
}


def configure_prep(prep_threads: Optional[int] = None, staged: Optional[bool] = None,
                   stream: Optional[bool] = None, stream_floor: Optional[int] = None,
                   host_stripe=None) -> None:
    """Set the prep pipeline (process-global, like configure_planner).
    prep_threads resizes the native worker pool (0 / None = the host default,
    min(cores, 8)); host_stripe takes True, False or "auto"."""
    if prep_threads is not None:
        native.configure_prep_threads(prep_threads or None)
    if staged is not None:
        _PREP_CFG["staged"] = bool(staged)
    if stream is not None:
        _PREP_CFG["stream"] = bool(stream)
    if stream_floor is not None:
        _PREP_CFG["stream_floor"] = max(1, int(stream_floor))
    if host_stripe is not None:
        _PREP_CFG["host_stripe"] = "auto" if host_stripe == "auto" else bool(host_stripe)


def _staged_enabled() -> bool:
    return _PREP_CFG["staged"]


def _stream_enabled() -> bool:
    return _PREP_CFG["stream"]


def _stream_floor() -> int:
    return _PREP_CFG["stream_floor"]


def _host_stripe_on() -> bool:
    v = _PREP_CFG["host_stripe"]
    if v == "auto":
        return (os.cpu_count() or 1) > 1
    return bool(v)


# Rows challenge-hashed, ever: a clean flush hashes each row at most once.
HASH_ROWS_HASHED = [0]
_HASH_COUNT_LOCK = threading.Lock()


def _count_hashed(rows: int) -> None:
    with _HASH_COUNT_LOCK:  # the prep worker and the calling thread both count
        HASH_ROWS_HASHED[0] += rows


def _overlap_seconds(spans, busy) -> float:
    """Sum over the prep spans [s, e) of their intersection with the union
    of the device-busy intervals."""
    if not spans or not busy:
        return 0.0
    merged = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    total = 0.0
    for s, e in spans:
        for bs, be in merged:
            lo, hi = max(s, bs), min(e, be)
            if lo < hi:
                total += hi - lo
    return total


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
    _count_hashed(len(pubkeys))
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
    LAST_FLUSH.update(jit_bucket=b, padding_lanes=b - n)
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
# Decoded-pubkey cache on the device: key -> column of _A["store"] (None =
# invalid encoding). The key is typed, because one 32-byte string decodes
# differently as an Edwards point and as a ristretto255 point: an Ed25519 key
# is its 32 bytes, an sr25519 key b"s" + its 32 bytes (33 bytes, so the two
# never collide; _cache_key). Fills hold the lock and never rewrite a column
# of a store in use: the store grows by copy, and a full reset starts a new
# tensor. So (columns, store) read in one locked section stay a consistent
# pair for the flush that read them.

_A_LOCK = threading.Lock()
_A_CACHE: dict = {}
_A = {"store": None, "len": 0}
_A_CACHE_MAX = 65536


def reset_a_cache() -> None:
    with _A_LOCK:
        _A_CACHE.clear()
        _A["store"] = None
        _A["len"] = 0


def _cache_key(pk: bytes, key_type: str = "ed25519") -> bytes:
    """The A cache's key: the encoding for Ed25519, b"s" + it for sr25519."""
    return b"s" + pk if key_type == "sr25519" else pk


def fill_a_cache(rows: np.ndarray, pts: torch.Tensor, ok, key_type: str = "ed25519") -> None:
    """Cache decoded pubkeys of one key type: rows (m, 32) uint8 encodings,
    pts (4, 20, m) int32 coordinates on the device (Edwards decompression
    for "ed25519", ristretto255 decode for "sr25519"), ok (m,) bool (False =
    invalid encoding, cached as None)."""
    ok = np.asarray(ok.cpu() if isinstance(ok, torch.Tensor) else ok, dtype=bool)
    with _A_LOCK:
        store = _A["store"]
        if store is not None and store.device != pts.device:
            _A_CACHE.clear()
            store, _A["len"] = None, 0
        new_cols, new_src = [], []
        for j in range(rows.shape[0]):
            key = _cache_key(rows[j].tobytes(), key_type)
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
    """An RLC flush submitted to the device, not yet synced. A mixed flush
    ("mixed") also carries the rows of its Ed25519 and sr25519 R lanes and
    their lane buckets; `detail` holds what its finish adds to LAST_FLUSH."""

    __slots__ = ("precheck", "n", "na", "mode", "dev", "pts", "a_rows", "prep_s", "t0",
                 "overlap_s", "ed_pos", "sr_pos", "ne", "ns", "detail")

    def __init__(self, precheck, n, na, mode, dev, pts, a_rows, prep_s, t0, overlap_s,
                 ed_pos=None, sr_pos=None, ne=0, ns=0, detail=None):
        self.precheck, self.n, self.na, self.mode = precheck, n, na, mode
        self.dev, self.pts, self.a_rows, self.prep_s, self.t0 = dev, pts, a_rows, prep_s, t0
        self.overlap_s = overlap_s  # staged: hashing overlapped with the A block; else None
        self.ed_pos, self.sr_pos, self.ne, self.ns = ed_pos, sr_pos, ne, ns
        self.detail = detail or {}


def _rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na: int):
    """Lanes and scalars of one RLC flush over n = len(precheck) rows:
    [A_0..A_{n-1}, B, pads -> na | R_0..R_{n-1}, pads -> na]; excluded and pad
    lanes carry the basepoint with scalar 0 (bucket 0 is never summed).
    Returns (pts (2 na, 32) uint8, scalars (2 na, 32) uint8)."""
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
    return pts, scalars


def _rlc_lanes(precheck, a_rows, r_rows, s_rows, h_rows, na: int):
    """_rlc_layout and its window sort: (pts (2 na, 32) uint8, perm, ends)."""
    from tendermint_tpu_torch.ops import msm_torch

    pts, scalars = _rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na)
    perm, ends = msm_torch.sort_windows(scalars, zero16_from=na)
    return pts, perm, ends


def _rlc_submit(pubkeys, msgs, sigs, device, key_types=None) -> _RlcCall:
    """Host prep + device submit of the combined check (no sync). A set
    holding sr25519 rows (`key_types`) is the mixed flush (_rlc_submit_mixed).

    Staged (the default): the precheck and the hasher's blobs on this
    thread, the challenge hashes on the prep worker while the cache decision
    is made and, on the cached-A kernel, the A block is built; the hashes
    are awaited just before the scalars need them (a hashing failure
    re-raises here). The mask is the same either way: w = z h is 0 wherever
    z is, so zeroing h after the cache exclusion equals zeroing it before.
    With TMTPU_DEVICE_SORT=1 the cached-A kernel sorts its windows on the
    device (msm_torch.sort_windows_device) and the host sort is skipped."""
    from tendermint_tpu_torch.ops import msm_torch

    if key_types is not None and any(t == "sr25519" for t in key_types):
        return _rlc_submit_mixed(pubkeys, msgs, sigs, key_types, device)
    t0 = time.perf_counter()
    counters0 = msm_torch.flush_counters()
    n = len(pubkeys)
    staged = _staged_enabled()
    if staged:
        precheck, a_rows, r_rows, s_rows, blobs = _precheck_rows_fast(pubkeys, msgs, sigs)

        def _hash_task(blobs=blobs, rows=n):
            ts = time.perf_counter()
            h = native.ed25519_h_batch(*blobs)
            _count_hashed(rows)
            return h, ts, time.perf_counter()

        hash_fut = _prep_pool().submit(_hash_task)
    else:
        precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(pubkeys, msgs, sigs)
    keys = [bytes(p) for p in pubkeys]
    with _A_LOCK:
        # the A cache's hit rate, sampled before any fill or exclusion
        hits = sum(1 for i in np.flatnonzero(precheck) if keys[i] in _A_CACHE)
        cache = dict(cache_hits=hits, cache_misses=int(precheck.sum()) - hits)
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
    detail = dict(cache, jit_bucket=na, padding_lanes=2 * na - (2 * n + 1))
    a_dev = a_span = overlap_s = None
    if staged:
        if cached:  # the A block is built while the prep worker hashes
            t_a = time.perf_counter()
            with _on_device("rlc_submit"):
                a_dev = _a_block(rows, cols, store, na, device)
            a_span = (t_a, time.perf_counter())
        h_rows, h_t0, h_t1 = hash_fut.result()
        h_rows[~precheck] = 0
        overlap_s = _overlap_seconds([(h_t0, h_t1)], [a_span] if a_span else [])
    pts, scalars = _rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na)
    dsort = cached and msm_torch._device_sort_enabled()
    if not dsort:
        perm, ends = msm_torch.sort_windows(scalars, zero16_from=na)
    prep_s = time.perf_counter() - t0
    with _on_device("rlc_submit"):
        if cached:
            if a_dev is None:
                a_dev = _a_block(rows, cols, store, na, device)
            if dsort:
                dev = msm_torch.rlc_check_cached_dsort_submit(a_dev, pts[na:], scalars)
                detail["device_sort"] = True
            else:
                dev = msm_torch.rlc_check_cached_submit(a_dev, pts[na:], perm, ends)
            dpts, mode = None, "cached"
        else:
            dev, dpts = msm_torch.rlc_check_submit(pts, perm, ends, device)
            mode = "plain"
    _submit_counters(detail, counters0)
    return _RlcCall(precheck, n, na, mode, dev, dpts, None if cached else a_rows, prep_s, t0,
                    overlap_s, detail=detail)


def _submit_counters(detail: dict, before: dict) -> None:
    """The submit's device traffic into its flush detail: the bytes it
    uploaded and the kernels it launched (msm_torch.flush_counters deltas)."""
    from tendermint_tpu_torch.ops import msm_torch

    now = msm_torch.flush_counters()
    detail["h2d_bytes"] = now["h2d_bytes"] - before["h2d_bytes"]
    detail["device_dispatches"] = now["dispatches"] - before["dispatches"]


# ---------------------------------------------------------------------------
# The mixed flush: Ed25519 and sr25519 rows in ONE combined check, lanes
# [A block | Ed25519 R | sr25519 R] (the reference's mixed _rlc_submit). An
# sr25519 row is a Schnorr equation of the same form over ristretto255,
# [s]B = R + [k]A with k the merlin challenge, so it enters the sum as an
# Ed25519 row does, with k in place of h: z = 0 (mod 8) removes the torsion
# by which ristretto's quotient group differs from the curve.


def _precheck_and_challenge_sr(pubkeys, msgs, sigs):
    """schnorrkel rows' precheck and challenges: the signature is 64 bytes
    and the key 32, the marker bit sig[63] & 0x80 is set, s = sig[32:63] +
    (sig[63] & 0x7f) is below L; k = the merlin challenge "sign:c" mod L of
    the signing-context transcript, the transcripts of each message length
    advanced in lockstep (merlin.BatchTranscript). Returns (precheck,
    a_rows, r_rows, s_rows, k_rows), the last three (n, 32) uint8; k is zero
    where the precheck fails."""
    from tendermint_tpu_torch.crypto.merlin import BatchTranscript
    from tendermint_tpu_torch.crypto.sr25519 import SIGNING_CTX

    n = len(pubkeys)
    pubkeys = [bytes(p) for p in pubkeys]
    sigs = [bytes(s) for s in sigs]
    msgs = [bytes(m) for m in msgs]
    len_ok = np.fromiter(
        (len(p) == 32 and len(s) == 64 for p, s in zip(pubkeys, sigs)), dtype=bool, count=n)
    a_rows = np.frombuffer(b"".join(p if k else bytes(32) for p, k in zip(pubkeys, len_ok)),
                           dtype=np.uint8).reshape(n, 32)
    sig_arr = np.frombuffer(b"".join(s if k else bytes(64) for s, k in zip(sigs, len_ok)),
                            dtype=np.uint8).reshape(n, 64)
    s_rows = sig_arr[:, 32:].copy()
    marker = (s_rows[:, 31] & 0x80) != 0
    s_rows[:, 31] &= 0x7F
    precheck = len_ok & marker & _s_canonical_rows(s_rows)
    k_rows = np.zeros((n, 32), dtype=np.uint8)
    groups: dict = {}
    for i in np.flatnonzero(precheck):
        groups.setdefault(len(msgs[i]), []).append(i)
    for mlen, idx in groups.items():
        idx = np.asarray(idx)
        m = len(idx)
        bt = BatchTranscript(b"SigningContext", m)
        bt.append_message(b"", SIGNING_CTX)
        bt.append_message(b"sign-bytes", np.frombuffer(b"".join(msgs[i] for i in idx),
                                                       dtype=np.uint8).reshape(m, mlen))
        bt.append_message(b"proto-name", b"Schnorr-sig")
        bt.append_message(b"sign:pk", a_rows[idx])
        bt.append_message(b"sign:R", sig_arr[idx, :32])
        wide = bt.challenge_bytes(b"sign:c", 64)
        k_rows[idx] = np.frombuffer(b"".join(
            (int.from_bytes(w.tobytes(), "little") % L).to_bytes(32, "little") for w in wide),
            dtype=np.uint8).reshape(m, 32)
    return precheck, a_rows, sig_arr[:, :32], s_rows, k_rows


def _prefill_typed(a_rows, precheck, sr, ckeys, device) -> None:
    """Decode every included key missing from the A cache, Ed25519 keys by
    Edwards decompression and sr25519 keys by the ristretto255 decode, in
    two passes: a full cache reset during the second type's fill drops the
    first type's new entries, and the second pass refills them (after a
    reset the store holds the whole set)."""
    from tendermint_tpu_torch.ops import msm_torch, ristretto_torch

    for _attempt in range(2):
        for kt, of_type in (("ed25519", ~sr), ("sr25519", sr)):
            with _A_LOCK:
                missing = [i for i in np.flatnonzero(precheck & of_type)
                           if ckeys[i] not in _A_CACHE]
            if missing:
                uniq = {a_rows[i].tobytes(): i for i in missing}
                enc = a_rows[list(uniq.values())]
                decode = (ristretto_torch.decode_rows if kt == "sr25519"
                          else msm_torch.decompress_rows)
                pts, ok = decode(enc, device)
                fill_a_cache(enc, pts, ok, kt)
        with _A_LOCK:
            if all(ckeys[i] in _A_CACHE for i in np.flatnonzero(precheck)):
                return


def _rlc_submit_mixed(pubkeys, msgs, sigs, key_types, device) -> _RlcCall:
    """Host prep + device submit of the mixed combined check (no sync):
    the Ed25519 rows' precheck and native hashes, the sr25519 rows' precheck
    and batched merlin challenges (timed on their own: LAST_FLUSH
    challenge_s), both key types' A entries prefilled and cached-invalid
    keys excluded; na = _lane_bucket(n + 1), Ne and Ns the lane buckets of
    each type's rows (at least 1); Ed25519 R pads are the basepoint
    encoding, sr25519 R pads 32 zero bytes (the ristretto identity), both
    with scalar 0. Scalars [w..., (L - u) mod L, pads | z of Ed25519 R | z
    of sr25519 R]; the window sort on the host."""
    from tendermint_tpu_torch.ops import msm_torch

    t0 = time.perf_counter()
    counters0 = msm_torch.flush_counters()
    n = len(pubkeys)
    sr = np.fromiter((t == "sr25519" for t in key_types), dtype=bool, count=n)
    ed_pos, sr_pos = np.flatnonzero(~sr), np.flatnonzero(sr)
    precheck = np.zeros(n, dtype=bool)
    a_rows, r_rows, s_rows, h_rows = (np.zeros((n, 32), dtype=np.uint8) for _ in range(4))
    challenge_s = 0.0
    for idx, prep in ((ed_pos, _precheck_and_hash_fast), (sr_pos, _precheck_and_challenge_sr)):
        if idx.size:
            tp = time.perf_counter()
            out = prep([pubkeys[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx])
            for dst, src in zip((precheck, a_rows, r_rows, s_rows, h_rows), out):
                dst[idx] = src
            if prep is _precheck_and_challenge_sr:
                challenge_s = time.perf_counter() - tp
    ckeys = [_cache_key(a_rows[i].tobytes(), key_types[i]) for i in range(n)]
    with _A_LOCK:  # the hit rate, sampled before the fill
        hits = sum(1 for i in np.flatnonzero(precheck) if ckeys[i] in _A_CACHE)
    misses = int(precheck.sum()) - hits
    t_fill = time.perf_counter()
    with _on_device("rlc_submit"):
        _prefill_typed(a_rows, precheck, sr, ckeys, device)
    fill_s = time.perf_counter() - t_fill
    with _A_LOCK:
        for i in np.flatnonzero(precheck):
            if _A_CACHE[ckeys[i]] is None:  # cached-invalid encoding
                precheck[i] = False
        rows = np.flatnonzero(precheck)
        store = _A["store"]
        cols = np.fromiter((_A_CACHE[ckeys[i]] for i in rows), dtype=np.int64, count=len(rows))
    na = _lane_bucket(n + 1)
    ne, ns = _lane_bucket(max(len(ed_pos), 1)), _lane_bucket(max(len(sr_pos), 1))
    z16, w_rows, u = _rlc_scalars_fast(precheck, s_rows, h_rows)
    ed_r = np.tile(np.frombuffer(point_compress(BASE), dtype=np.uint8), (ne, 1))
    sr_r = np.zeros((ns, 32), dtype=np.uint8)
    for blk, pos in ((ed_r, ed_pos), (sr_r, sr_pos)):
        pc = precheck[pos]
        blk[: len(pos)][pc] = r_rows[pos][pc]
    scalars = np.zeros((na + ne + ns, 32), dtype=np.uint8)
    scalars[:n] = w_rows
    scalars[n] = np.frombuffer(((L - u) % L).to_bytes(32, "little"), dtype=np.uint8)
    scalars[na : na + len(ed_pos), :16] = z16[ed_pos]
    scalars[na + ne : na + ne + len(sr_pos), :16] = z16[sr_pos]
    perm, ends = msm_torch.sort_windows(scalars, zero16_from=na)
    prep_s = time.perf_counter() - t0
    with _on_device("rlc_submit"):
        a_dev = _a_block(rows, cols, store, na, device)
        dev = msm_torch.rlc_check_cached_mixed_submit(a_dev, ed_r, sr_r, perm, ends)
    detail = dict(challenge_s=challenge_s, a_fill_s=fill_s, ed_rows=len(ed_pos),
                  sr_rows=len(sr_pos), cache_hits=hits, cache_misses=misses, jit_bucket=na,
                  padding_lanes=na + ne + ns - (2 * n + 1))
    _submit_counters(detail, counters0)
    return _RlcCall(precheck, n, na, "mixed", dev, None, None, prep_s, t0, None,
                    ed_pos=ed_pos, sr_pos=sr_pos, ne=ne, ns=ns, detail=detail)


def _rlc_finish(call: _RlcCall) -> Optional[np.ndarray]:
    """ONE device-to-host copy; the mask when the combined check passes, None
    when the caller must recover the exact mask."""
    from tendermint_tpu_torch.ops import msm_torch

    t_sync = time.perf_counter()
    with _on_device("rlc_finish", sync=True):
        out = call.dev.cpu().numpy()  # [batch_ok, lane_ok...]
    transfer_s = time.perf_counter() - t_sync
    precheck, n, na = call.precheck, call.n, call.na
    ok = out[1:]
    lanes = 2 * na
    if call.mode == "mixed":
        lanes = na + call.ne + call.ns
        lanes_ok = all(bool(blk[: len(pos)][precheck[pos]].all()) for blk, pos in (
            (ok[: call.ne], call.ed_pos), (ok[call.ne : call.ne + call.ns], call.sr_pos)))
    elif call.mode == "cached":
        lanes_ok = bool(ok[:n][precheck].all())
    else:
        lanes_ok = bool(ok[:n][precheck].all() and ok[na : na + n][precheck].all())
        if precheck.any():  # steady state then runs the cached-A kernel
            rows = np.flatnonzero(precheck)
            fill_a_cache(call.a_rows[rows], call.pts[..., torch.from_numpy(rows).to(call.pts.device)],
                         ok[rows])
    LAST_FLUSH.update(mode=call.mode, prep_s=call.prep_s, total_s=time.perf_counter() - call.t0,
                      transfer_s=transfer_s, lanes=lanes, fused=msm_torch.fused_for_lanes(lanes),
                      **call.detail)
    if call.overlap_s is not None:
        LAST_FLUSH.update(prep_overlap_s=call.overlap_s, chunks=1, chunk_lanes=2 * na)
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


# ---------------------------------------------------------------------------
# The host arm: the card's combined check on host points (crypto/ed25519_ref),
# a Pippenger MSM in Python. z = 0 (mod 8) annihilates every lane's
# cofactor-torsion component, so an all-pass batch satisfies the cofactored
# equation exactly; a failure falls back to the host bisection or the serial
# loop for the exact mask.

_HOST_RLC_MIN = int(os.environ.get("TMTPU_HOST_RLC_MIN", "48"))

# decompressed host points, shared across flushes (None = invalid encoding)
_HOST_PT_CACHE: dict = {}
_HOST_PT_CACHE_MAX = 8192


def _host_point(enc: bytes):
    """Cached ed25519_ref decompression (None = invalid encoding)."""
    pt = _HOST_PT_CACHE.get(enc, False)
    if pt is False:
        from tendermint_tpu_torch.crypto.ed25519_ref import point_decompress

        pt = point_decompress(enc)
        if len(_HOST_PT_CACHE) >= _HOST_PT_CACHE_MAX:
            _HOST_PT_CACHE.clear()
        _HOST_PT_CACHE[enc] = pt
    return pt


def _host_msm(pairs, window: int = 0):
    """Sum of s P over ed25519_ref extended points: a windowed bucket
    (Pippenger) MSM, most significant window first. `pairs`: [(point, int)];
    zero scalars are skipped. window = 0 picks the width with the fewest
    modelled adds. Returns the extended sum, or None when nothing is summed."""
    from tendermint_tpu_torch.crypto.ed25519_ref import point_add, point_double

    pairs = [(p, s) for p, s in pairs if s]
    if not pairs:
        return None
    nbits = max(s.bit_length() for _, s in pairs)
    if window <= 0:
        n = len(pairs)
        window = min(range(3, 11), key=lambda w: ((nbits + w - 1) // w) * (n + (1 << (w + 1))))
    nwin = (nbits + window - 1) // window
    nbuckets = (1 << window) - 1
    acc = None
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(window):
                acc = point_double(acc)
        shift = w * window
        buckets = [None] * (nbuckets + 1)
        for p, s in pairs:
            d = (s >> shift) & nbuckets
            if d:
                buckets[d] = p if buckets[d] is None else point_add(buckets[d], p)
        running = total = None
        for b in range(nbuckets, 0, -1):
            if buckets[b] is not None:
                running = buckets[b] if running is None else point_add(running, buckets[b])
            if running is not None:
                total = running if total is None else point_add(total, running)
        if total is not None:
            acc = total if acc is None else point_add(acc, total)
    return acc


def _sample_z(rng, n: int, precheck) -> list:
    """RLC coefficients as ints: ~124-bit, nonzero, z = 0 (mod 8); 0 for
    excluded rows (the same draw as _rlc_scalars_fast)."""
    zw = rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)
    return [((((int(zw[i, 0]) & ((1 << 57) - 1)) << 64) | int(zw[i, 1]) | 1) << 3)
            if precheck[i] else 0 for i in range(n)]


def _verify_batch_cpu_rlc(pubkeys, msgs, sigs) -> Optional[np.ndarray]:
    """Host combined check: sum w_i A_i + ((L - u) mod L) B + sum z_i R_i == O
    with w_i = z_i h_i mod 8L and u = sum z_i s_i mod L, the card's equation
    on host points. Returns the mask when it holds, None when the caller
    must recover the exact mask (a row failed, or the sum has Z = 0).

    Chunked at planner_chunk_rows(): each chunk is a partial MSM with its own
    B term, summed with point_add. Above the stream floor, with the stream
    on and striping allowed (_host_stripe_on), the stripes are at most
    max(1024, n // 8) rows and stripe k+1's prep (precheck, hashing, z) runs
    on the prep worker while stripe k's MSM runs here; LAST_FLUSH then
    carries prep_overlap_s. A-lane coefficients collapse per distinct key."""
    from tendermint_tpu_torch.crypto.ed25519_ref import IDENTITY, P, point_add, point_equal

    n = len(pubkeys)
    rng = np.random.default_rng()  # OS entropy per call
    stream = _stream_enabled() and n >= _stream_floor() and _host_stripe_on()
    chunk = planner_chunk_rows()
    if stream:
        chunk = min(chunk, max(1024, n // 8))
    stripes = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    pipelined = stream and len(stripes) > 1

    def _stripe_prep(lo: int, hi: int):
        """Everything before the point work for rows [lo, hi) (indices
        stripe-local); on the prep worker when pipelined, which serializes
        the shared rng."""
        t0s = time.perf_counter()
        m = hi - lo
        pc, _a, _r, s_rows, h_rows = _precheck_and_hash_fast(pubkeys[lo:hi], msgs[lo:hi],
                                                             sigs[lo:hi])
        s_i = [int.from_bytes(s_rows[i].tobytes(), "little") if pc[i] else 0 for i in range(m)]
        h_i = [int.from_bytes(h_rows[i].tobytes(), "little") if pc[i] else 0 for i in range(m)]
        z = _sample_z(rng, m, pc)
        return pc, s_i, h_i, z, (t0s, time.perf_counter())

    acc = None
    prechecks, prep_spans, msm_spans = [], [], []
    if pipelined:
        fut = _prep_pool().submit(_stripe_prep, *stripes[0])
    for k, (lo, hi) in enumerate(stripes):
        if pipelined:
            pc, s_i, h_i, z, span = fut.result()
            if k + 1 < len(stripes):
                fut = _prep_pool().submit(_stripe_prep, *stripes[k + 1])
        else:
            pc, s_i, h_i, z, span = _stripe_prep(lo, hi)
        prep_spans.append(span)
        t_msm = time.perf_counter()
        m = hi - lo
        pts = [None] * m
        for i in range(m):  # invalid encodings drop out of the precheck
            if not pc[i]:
                continue
            a = _host_point(bytes(pubkeys[lo + i]))
            r = _host_point(bytes(sigs[lo + i])[:32])
            if a is None or r is None:
                pc[i] = False
                continue
            pts[i] = (a, r)
        a_coef, a_by_key, pairs = {}, {}, []
        u = 0
        for i in range(m):
            if not pc[i]:
                continue
            pkb = bytes(pubkeys[lo + i])
            a_coef[pkb] = (a_coef.get(pkb, 0) + z[i] * h_i[i]) % L8
            a_by_key[pkb] = pts[i][0]
            pairs.append((pts[i][1], z[i]))
            u += z[i] * s_i[i]
        prechecks.append(pc)
        if pairs:
            pairs.extend((a_by_key[pkb], c) for pkb, c in a_coef.items())
            # the stripe's own B term: the sum of (L - u_k) is L - sum u_k mod L
            pairs.append((BASE, (L - u % L) % L))
            part = _host_msm(pairs)
            if part is not None:
                acc = part if acc is None else point_add(acc, part)
        msm_spans.append((t_msm, time.perf_counter()))
    precheck = np.concatenate(prechecks)
    LAST_FLUSH["prep_s"] = sum(e - s for s, e in prep_spans)
    if pipelined:
        LAST_FLUSH["prep_overlap_s"] = _overlap_seconds(prep_spans, msm_spans)
    if not precheck.any():
        return precheck  # nothing verifiable: every verdict is already False
    if len(stripes) > 1:
        LAST_FLUSH.update(chunks=len(stripes), chunk_lanes=2 * (chunk + 1))
    res = acc if acc is not None else IDENTITY
    if res[2] % P == 0:
        return None  # an exceptional addition on crafted torsion inputs: the serial loop decides
    return precheck if point_equal(res, IDENTITY) else None


def _bisect_recover_host(pubkeys, msgs, sigs):
    """The host twin of _bisect_recover after a failed host combined check:
    host sub-checks over power-of-two halves, the serial loop at leaves of
    max(TMTPU_BISECT_LEAF // 4, 1) rows, below 2 * _HOST_RLC_MIN rows and
    after TMTPU_BISECT_MAX_BAD bad leaves. Returns (mask, flushes)."""

    def _combined(lo, hi):
        try:
            return _verify_batch_cpu_rlc(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi])
        except Exception:  # no device here: the serial leaves below give the mask
            logging.getLogger(__name__).exception("host sub-check failed; recovering serially")
            return None

    mask, flushes, _ = _bisect(len(pubkeys), _combined,
                               lambda lo, hi: _verify_serial_host(pubkeys[lo:hi], msgs[lo:hi],
                                                                  sigs[lo:hi]),
                               max(_bisect_leaf_rows() // 4, 1), _HOST_RLC_MIN)
    return mask, flushes


def verify_batch_cpu(pubkeys: Sequence[bytes], msgs: Sequence[bytes],
                     sigs: Sequence[bytes]) -> np.ndarray:
    """The host arm. From _HOST_RLC_MIN rows, and not in cofactorless mode
    (whose predicate is stricter than the combined check's), the host
    combined check (LAST_FLUSH mode "host_rlc" when it passes); when it
    fails, the host bisection (TMTPU_BISECT = 1) or one serial pass
    (TMTPU_BISECT = 0), mode "host_serial" with recovery_flushes. Fewer rows,
    and cofactorless mode, run the serial loop (mode "host_serial")."""
    from tendermint_tpu_torch.crypto.keys import cofactorless_mode

    t0 = time.perf_counter()
    if len(pubkeys) >= _HOST_RLC_MIN and not cofactorless_mode():
        try:
            mask = _verify_batch_cpu_rlc(pubkeys, msgs, sigs)
        except Exception:
            logging.getLogger(__name__).exception("host RLC failed; recovering on the host")
            mask = None
        if mask is not None:
            LAST_FLUSH.update(mode="host_rlc", total_s=time.perf_counter() - t0)
            return mask
        detail = dict(LAST_FLUSH)
        t1 = time.perf_counter()
        if _bisect_enabled():
            mask, flushes = _bisect_recover_host(pubkeys, msgs, sigs)
        else:
            mask, flushes = _verify_serial_host(pubkeys, msgs, sigs), 1
        LAST_FLUSH.clear()
        LAST_FLUSH.update(detail, mode="host_serial", recovery_flushes=flushes,
                          recovery_s=time.perf_counter() - t1, total_s=time.perf_counter() - t0)
        return mask
    mask = _verify_serial_host(pubkeys, msgs, sigs)
    LAST_FLUSH.update(mode="host_serial", total_s=time.perf_counter() - t0)
    return mask


# ---------------------------------------------------------------------------
# The card arm.

# The route label of this thread's last card flush (the reference's
# LAST_JAX_PATH). Per thread: the scheduler's dispatch thread and a vote
# flush on its caller's thread route at the same time.
_PATH = threading.local()


def _persig_flush(pubkeys, msgs, sigs, device, env=None) -> np.ndarray:
    """The per-signature ladder over all rows: device mask & host precheck.
    With a mesh `env` the ladder runs sharded (its per-signature runner,
    path "sharded"); a sharded failure is scored and drops the mesh
    (_mesh_failed), then raises."""
    from tendermint_tpu_torch.ops.ed25519_torch import verify_prepared

    a, r, s_d, h_d, precheck, n = prepare_batch(pubkeys, msgs, sigs)
    t_dev = time.perf_counter()
    with _on_device("persig", sync=True), record_function(PERSIG):
        if env is not None:
            _PATH.label = "sharded"
            try:
                mask = env[1](a, r, s_d, h_d)[:n]
            except Exception as exc:
                _mesh_failed(env, exc)
                raise
        else:
            t = [torch.from_numpy(x).to(device) for x in (a, r, s_d, h_d)]
            _PATH.label = "persig"
            mask = verify_prepared(*t).cpu().numpy()[:n]
    LAST_FLUSH["transfer_s"] = time.perf_counter() - t_dev
    return mask & precheck


def _prep_stream_chunk(pubkeys, msgs, sigs, lo: int, hi: int, na_c: int):
    """Host prep of one planner chunk on the prep worker: rows [lo, hi) in
    the plain-kernel lane layout with the chunk's own B lane. Returns
    (precheck (hi-lo,), pts (2 na_c, 32), perm, ends, (start, end))."""
    t0 = time.perf_counter()
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(
        pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi])
    pts, perm, ends = _rlc_lanes(precheck, a_rows, r_rows, s_rows, h_rows, na_c)
    return precheck, pts, perm, ends, (t0, time.perf_counter())


def _verify_batch_rlc_streamed(pubkeys, msgs, sigs, device, chunks=None,
                               mode: str = "streamed") -> Optional[np.ndarray]:
    """The streamed combined check: chunk k+1's host prep runs on the prep
    worker while chunk k's kernels run; each chunk's partial point is added
    to a device accumulator with one padd; at most 2 chunks are in flight
    (the older chunk's lane flags are synced before a third is submitted);
    one identity check at the end. `chunks` overrides the planner's row
    spans (the pipelined stream's [(0, head), (head, n)]); every chunk pads
    to the planner's one chunk bucket. prep_overlap_s intersects the prep
    spans with the device-busy intervals, each chunk's from its submit's
    return to its sync, as the reference counts them. The port's submit
    returns only after its thousands of launches, so prep that overlaps
    the launch loop is not counted (prep_wait_s shows how little of it the
    next chunk waited for). Returns the mask when the check passes, None
    when the caller must recover the exact mask."""
    from tendermint_tpu_torch.ops import msm_torch

    t0 = time.perf_counter()
    counters0 = msm_torch.flush_counters()
    n = len(pubkeys)
    na_c = planner_budget() // 2
    if chunks is None:
        chunks = _planner_chunks(n)
    pool = _prep_pool()
    prechecks: list = [None] * len(chunks)
    submit_t: list = [None] * len(chunks)
    inflight: deque = deque()  # (chunk index, lane flags, event or None)
    acc = None
    lanes_ok = True
    wait_s = 0.0
    peak = 0
    prep_spans, dev_busy = [], []

    def sync_oldest():
        k, flags, ev = inflight.popleft()
        if ev is not None:
            with _on_device("rlc_finish"):
                ev.synchronize()  # this chunk's kernels and flag copy, not later ones
        ok = flags.numpy()
        dev_busy.append((submit_t[k], time.perf_counter()))
        pc = prechecks[k]
        c = chunks[k][1] - chunks[k][0]
        return not pc.any() or bool(ok[:c][pc].all() and ok[na_c : na_c + c][pc].all())

    fut = pool.submit(_prep_stream_chunk, pubkeys, msgs, sigs, *chunks[0], na_c)
    for k in range(len(chunks)):
        tw = time.perf_counter()
        precheck, pts, perm, ends, span = fut.result()
        wait_s += time.perf_counter() - tw
        prep_spans.append(span)
        prechecks[k] = precheck
        if k + 1 < len(chunks):
            fut = pool.submit(_prep_stream_chunk, pubkeys, msgs, sigs, *chunks[k + 1], na_c)
        with _on_device("rlc_submit"):
            part, ok = msm_torch.rlc_partial_submit(pts, perm, ends, device)
            submit_t[k] = time.perf_counter()
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
    t_sync = time.perf_counter()
    with _on_device("rlc_finish", sync=True):
        batch_ok = bool(msm_torch.partial_identity_submit(acc).item())
    dev_busy.append((t_sync, time.perf_counter()))
    detail = {}
    _submit_counters(detail, counters0)
    LAST_FLUSH.update(mode=mode, fused=msm_torch.fused_for_lanes(2 * na_c),
                      chunks=len(chunks), chunk_lanes=2 * na_c, peak_lanes_in_flight=peak,
                      lanes=len(chunks) * 2 * na_c, prep_s=sum(e - s for s, e in prep_spans),
                      prep_wait_s=wait_s, prep_overlap_s=_overlap_seconds(prep_spans, dev_busy),
                      transfer_s=dev_busy[-1][1] - t_sync, jit_bucket=na_c,
                      padding_lanes=len(chunks) * 2 * na_c - (2 * n + len(chunks)),
                      total_s=time.perf_counter() - t0, **detail)
    if batch_ok and lanes_ok:
        return np.concatenate(prechecks)
    return None


def _verify_batch_pipelined(pubkeys, msgs, sigs, device) -> Optional[np.ndarray]:
    """The in-budget 2-chunk stream: a head of max(RLC_MIN, n // 8) rows is
    submitted first, so the tail's hashing, scalars and sort run on the prep
    worker while the head's kernels run; both chunks pad to the planner's
    chunk bucket. Declines (None, no flush) when the head is not shorter
    than n or the tail exceeds a chunk. Returns the mask when the combined
    check passes, else None."""
    n = len(pubkeys)
    head = max(RLC_MIN, n // 8)
    if not (head < n and n - head <= planner_chunk_rows()):
        return None
    mask = _verify_batch_rlc_streamed(pubkeys, msgs, sigs, device, chunks=[(0, head), (head, n)],
                                      mode="pipelined")
    LAST_FLUSH["head_rows"] = head
    return mask


def _verify_batch_streamed(pubkeys, msgs, sigs, device) -> np.ndarray:
    """Planner-engaged verification: the streamed combined check; when it
    fails, each planner chunk runs the in-budget card path (pipelined, then
    bisection), so recovery never exceeds the budget either. LAST_FLUSH
    keeps the streamed flush's detail and gains recovered_chunks (each
    chunk's rows, path, mode and recovery flushes) and, where a chunk
    recovered, recovery_flushes, their sum (as the reference counts). On a
    mesh the combined check streams across it
    (_verify_batch_rlc_sharded_streamed, path "rlc-sharded-streamed"), and
    a failed one goes straight to the chunk-wise recovery, whose chunks
    take the sharded arms."""
    env = _mesh_env(device)
    if env is not None:
        mask = _verify_batch_rlc_sharded_streamed(pubkeys, msgs, sigs, env)
        if mask is not None:
            _PATH.label = "rlc-sharded-streamed"
            return mask
    else:
        mask = _verify_batch_rlc_streamed(pubkeys, msgs, sigs, device)
        if mask is not None:
            _PATH.label = "rlc-streamed"
            return mask
    detail = dict(LAST_FLUSH)
    t0 = time.perf_counter()
    parts, recovered = [], []
    for lo, hi in _planner_chunks(len(pubkeys)):
        LAST_FLUSH.clear()
        parts.append(verify_batch_cuda(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], device))
        recovered.append(dict(rows=hi - lo, path=_PATH.label, mode=LAST_FLUSH.get("mode"),
                              recovery_flushes=LAST_FLUSH.get("recovery_flushes", 0)))
    last = {k: LAST_FLUSH[k] for k in _RECOVERY_KEYS if k in LAST_FLUSH}
    LAST_FLUSH.clear()
    LAST_FLUSH.update(detail, **last, rlc_fallback=True, recovery_s=time.perf_counter() - t0,
                      recovered_chunks=recovered)
    flushes = sum(c["recovery_flushes"] for c in recovered)
    if flushes:
        LAST_FLUSH["recovery_flushes"] = flushes
    _PATH.label = "rlc-streamed-recovery"
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# The sharded mesh (the reference's _sharded_env and its arms): while the
# process sees two healthy cards or more, a card flush spreads over a mesh of
# the largest power of two of them (parallel/sharded.py). A caller may pin
# the env instead (tests, chip_smoke.py), over a mesh that repeats one
# device. Under D1 nothing replays a sharded flush that failed: the failure
# is scored, the mesh is dropped so the next is built on the healthy cards,
# and the error raises as a device error.

MeshEnv = namedtuple("MeshEnv", "nd persig rlc stream mesh")
MeshEnv.__doc__ = """A mesh's runners: its shard count, the per-signature
runner, the combined check's, the streamed planner's (run_chunk, finish)
and the mesh (parallel/sharded.Mesh). Indexed like the reference's
(n_devices, persig_run, rlc_run, (run_chunk, finish)) tuple."""

_SHARDED_RUNNER = None  # cached ((n_devices, health generation), env)
_SHARDED_BUILD_LOCK = threading.Lock()  # non-blocking: a flush never waits on a build
_RUNNER_CACHE: dict = {}  # device-key tuple -> env; survives rebuilds, so
# re-selecting a topology built before (a rejoin to the full mesh, the
# prewarmed half mesh) reuses its runners
_LAST_MESH_ND = [0]  # the mesh size built before (rebuild telemetry)


def _mesh_health():
    from tendermint_tpu_torch.parallel import health as _mh

    return _mh.MESH_HEALTH


def _visible_cards() -> list:
    from tendermint_tpu_torch.parallel import health as _mh

    return _mh._visible_devices()


def invalidate_sharded_env() -> None:
    """Drop the cached mesh runner (a health-generation change, a shard
    failure): the next _sharded_env() call re-selects the healthy topology.
    Runners persist in _RUNNER_CACHE."""
    global _SHARDED_RUNNER
    _SHARDED_RUNNER = None


def mesh_ladder_state() -> str:
    """The degrade-ladder rung: full | survivor | single (parallel/health.py;
    gauge tendermint_mesh_ladder_state). The reference's breaker arguments
    are False: the breaker is not ported (D1), so "host" never shows."""
    cur = _SHARDED_RUNNER
    mesh_nd = cur[1][0] if cur is not None else 0
    return _mesh_health().ladder_state(len(_visible_cards()), mesh_nd, False, False)


def _publish_mesh_health() -> None:
    """Push per-device health and the ladder rung into mesh telemetry (the
    /debug/mesh and verify_stats `mesh` health block and the
    tendermint_mesh_device_health / _ladder_state gauges)."""
    try:
        from tendermint_tpu_torch.parallel import telemetry as _mesh_tm

        _mesh_tm.record_mesh_health(_mesh_health().snapshot(), mesh_ladder_state())
    except Exception:  # observability must never break the verify path
        pass


def _on_mesh_rejoin() -> None:
    """Health-prober callback: a dead device passed its clean probes, so
    drop the survivor runner and the next flush rebuilds toward the full
    mesh."""
    invalidate_sharded_env()
    _publish_mesh_health()


def _build_sharded_env(devs) -> MeshEnv:
    """Construct (or fetch from _RUNNER_CACHE) the runners for an exact
    device list; a device may repeat (parallel/sharded.make_mesh)."""
    key = tuple(str(d) for d in devs)
    env = _RUNNER_CACHE.get(key)
    if env is None:
        from tendermint_tpu_torch.parallel.sharded import (
            make_mesh, sharded_rlc_check, sharded_rlc_stream, sharded_verify)

        mesh = make_mesh(list(devs), axis_names=("vals",))
        env = MeshEnv(len(devs), sharded_verify(mesh), sharded_rlc_check(mesh),
                      sharded_rlc_stream(mesh), mesh)
        _RUNNER_CACHE[key] = env
    return env


def _env_devices(env) -> list:
    """An env's shard keys (health attribution for a failure that surfaced
    outside sharded.py's guard, at a sync); [] for an env without a mesh
    (test fakes), whose attribution rides the exception's own stamp."""
    mesh = env[4] if len(env) > 4 else None
    return list(mesh.keys) if mesh is not None else []


def _sharded_env():
    """The mesh a card flush shards across, or None: TMTPU_SHARDED "0"
    never; "auto" (the default) and "1" when the healthy cards
    (parallel/health.py) number two or more, a 1D mesh of the largest power
    of two of them. (The reference's "1" also lets its virtual CPU devices
    form a mesh; the port has none: a CPU mesh is pinned by its caller.) The
    cache is keyed on (mesh size, health generation), and a rebuild happens
    behind a NON-BLOCKING lock: a flush arriving mid-rebuild gets None and
    runs on one card instead of waiting. Returns a MeshEnv or None."""
    global _SHARDED_RUNNER
    if os.environ.get("TMTPU_SHARDED", "auto") == "0":
        return None
    hm = _mesh_health()
    hm.add_rejoin_listener(_on_mesh_rejoin)
    healthy = hm.healthy_devices(_visible_cards())
    if not healthy:
        return None
    nd = 1 << (len(healthy).bit_length() - 1)  # largest power of two <= healthy
    if nd < 2:
        return None
    key = (nd, hm.generation)
    cur = _SHARDED_RUNNER
    if cur is not None and cur[0] == key:
        return cur[1]
    if not _SHARDED_BUILD_LOCK.acquire(blocking=False):
        return None  # a rebuild is in flight: this flush runs on one card
    try:
        cur = _SHARDED_RUNNER
        if cur is not None and cur[0] == key:
            return cur[1]
        t0 = time.perf_counter()
        env = _build_sharded_env(healthy[:nd])
        _SHARDED_RUNNER = (key, env)
        prev = _LAST_MESH_ND[0]
        _LAST_MESH_ND[0] = nd
        if prev and prev != nd:
            from tendermint_tpu_torch.parallel import telemetry as _mesh_tm

            _mesh_tm.record_rebuild(prev, nd, time.perf_counter() - t0)
    finally:
        _SHARDED_BUILD_LOCK.release()
    _publish_mesh_health()
    return env


def _sharded_runner():
    env = _sharded_env()
    return env[1] if env is not None else None


def _mesh_env(device):
    """The mesh a flush on `device` runs on: _sharded_env()'s when its
    devices are of `device`'s type (the cards for a card flush; a CPU mesh
    only where a caller pinned one), else None. A cpu flush never meets the
    card mesh."""
    env = _sharded_env()
    if env is None:
        return None
    mesh = env[4] if len(env) > 4 else None
    if mesh is not None and mesh.platform != torch.device(device).type:
        return None
    return env


def _mesh_failed(env, exc: BaseException) -> None:
    """A sharded flush raised: score it against the shards unless
    parallel/sharded.py's guard did, drop the mesh (the next is built on
    the healthy devices) and publish the health. The caller re-raises,
    marked as a device error (D1): where the reference replays the flush on
    the survivor mesh or on one chip, the port does not."""
    if not getattr(exc, "_mesh_scored", False):
        _mesh_health().record_failure(_env_devices(env), exc)
    invalidate_sharded_env()
    _publish_mesh_health()
    logging.getLogger("tendermint_tpu_torch.crypto.batch").error(
        "sharded flush failed on %s: %r", _env_devices(env), exc)


def _sharded_lanes(n: int, nd: int) -> int:
    """The A-block lanes of a sharded combined check over n rows, the
    reference's padding: the lane bucket of n + 1 raised until 2 na tiles
    the nd shards, then rounded up to whole 1,024-lane chunks a shard (the
    fused schedule) when that pads at most 25% more."""
    from tendermint_tpu_torch.ops import msm_torch

    na = _lane_bucket(n + 1)
    while (2 * na) % nd:
        na += 1
    if msm_torch.fused_for_lanes(nd * 1024):
        target = nd * 1024
        padded = -(-2 * na // target) * target
        if 4 * padded <= 5 * (2 * na):
            na = padded // 2
    return na


def _verify_batch_rlc_sharded(pubkeys, msgs, sigs, env) -> Optional[np.ndarray]:
    """ONE combined check with its lanes sharded across the mesh
    (parallel/sharded.sharded_rlc_check): each shard runs the MSM over its
    lanes, the partial points are gathered and added on the first device.
    No A cache on this path, as in the reference. Returns the mask when the
    check passes (path "rlc-sharded"), None when the caller must recover
    the exact mask; a device error raises (_mesh_failed, D1)."""
    from tendermint_tpu_torch.ops import msm_torch
    from tendermint_tpu_torch.parallel import telemetry as _mesh_tm
    from tendermint_tpu_torch.parallel.sharded import prepare_rlc_shards

    t0 = time.perf_counter()
    n = len(pubkeys)
    nd, rlc_run = env[0], env[2]
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(pubkeys, msgs, sigs)
    na = _sharded_lanes(n, nd)
    # the padding is decided here (sharded.py sees only padded arrays)
    _mesh_tm.record_pad(requested_lanes=2 * n + 1, padded_lanes=2 * na)
    pts, scalars = _rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na)
    shards = prepare_rlc_shards(pts, scalars, nd)
    prep_s = time.perf_counter() - t0
    try:
        with _on_device("mesh_rlc_submit", sync=True, hook=False):
            bok, ok = rlc_run(*shards)
    except Exception as exc:
        _mesh_failed(env, exc)
        raise
    lanes_ok = (bool(ok[:n][precheck].all() and ok[na : na + n][precheck].all())
                if precheck.any() else True)
    LAST_FLUSH.update(mode="sharded", shards=nd, lanes=2 * na, shard_lanes=2 * na // nd,
                      fused=msm_torch.fused_for_lanes(2 * na // nd), jit_bucket=na,
                      padding_lanes=2 * na - (2 * n + 1), prep_s=prep_s,
                      total_s=time.perf_counter() - t0)
    if bok and lanes_ok:
        _PATH.label = "rlc-sharded"
        return precheck
    return None


def _prep_stream_chunk_sharded(pubkeys, msgs, sigs, lo: int, hi: int, na_c: int, nd: int):
    """Host prep of one planner chunk for the mesh, on the prep worker: the
    chunk's lanes (_rlc_layout, its own B lane) split into nd shards, each
    with its window sort (prepare_rlc_shards). Returns (precheck, shards,
    (start, end))."""
    from tendermint_tpu_torch.parallel.sharded import prepare_rlc_shards

    t0 = time.perf_counter()
    precheck, a_rows, r_rows, s_rows, h_rows = _precheck_and_hash_fast(
        pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi])
    pts, scalars = _rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na_c)
    return precheck, prepare_rlc_shards(pts, scalars, nd), (t0, time.perf_counter())


def _verify_batch_rlc_sharded_streamed(pubkeys, msgs, sigs, env) -> Optional[np.ndarray]:
    """The planner's mesh arm: fixed-bucket chunks stream ACROSS the mesh
    (parallel/sharded.sharded_rlc_stream): each chunk's lanes split into
    shards (the bucket raised until it tiles the mesh), each shard's
    partial folded into that shard's accumulator on its device, ONE gather
    at the end. Host prep double-buffers on the prep worker as on one card;
    at most 2 chunks are in flight. A bad signature is not a fault: the
    check returns None and the caller recovers the exact mask. A device
    error raises (_mesh_failed, D1), where the reference replays the flush
    from chunk 0 on the survivor topology."""
    from tendermint_tpu_torch.ops import msm_torch
    from tendermint_tpu_torch.parallel import telemetry as _mesh_tm

    t0 = time.perf_counter()
    nd = env[0]
    run_chunk, finish = env[3]
    n = len(pubkeys)
    na_c = planner_budget() // 2
    while (2 * na_c) % nd:
        na_c += 1  # per-shard lane slices must tile the mesh exactly
    chunks = _planner_chunks(n)
    _mesh_tm.record_pad(requested_lanes=2 * n + len(chunks),
                        padded_lanes=len(chunks) * 2 * na_c)
    pool = _prep_pool()
    prechecks: list = [None] * len(chunks)
    inflight: deque = deque()  # (chunk index, lane flags)
    lanes_ok = True
    prep_spans, wait_s, overlap_s, peak = [], 0.0, 0.0, 0

    def sync_oldest():
        k, dev_ok = inflight.popleft()
        with _on_device("rlc_finish"):
            ok = np.asarray(dev_ok).reshape(-1)
        pc = prechecks[k]
        c = chunks[k][1] - chunks[k][0]
        return not pc.any() or bool(ok[:c][pc].all() and ok[na_c : na_c + c][pc].all())

    try:
        acc = None
        fut = pool.submit(_prep_stream_chunk_sharded, pubkeys, msgs, sigs, *chunks[0], na_c, nd)
        for k in range(len(chunks)):
            tw = time.perf_counter()
            precheck, shards, span = fut.result()
            blocked = time.perf_counter() - tw
            wait_s += blocked
            prep_spans.append(span)
            if k > 0:
                overlap_s += max(0.0, span[1] - span[0] - blocked)
            prechecks[k] = precheck
            if k + 1 < len(chunks):
                fut = pool.submit(_prep_stream_chunk_sharded, pubkeys, msgs, sigs,
                                  *chunks[k + 1], na_c, nd)
            with _on_device("mesh_rlc_stream_submit", hook=False):
                acc, dev_ok = run_chunk(*shards, acc)
            inflight.append((k, dev_ok))
            peak = max(peak, len(inflight) * 2 * na_c)
            if len(inflight) >= 2:
                lanes_ok &= sync_oldest()
        while inflight:
            lanes_ok &= sync_oldest()
        t_sync = time.perf_counter()
        with _on_device("mesh_rlc_stream_finish", sync=True, hook=False):
            batch_ok = bool(finish(acc).item())
    except Exception as exc:
        _mesh_failed(env, exc)
        raise
    LAST_FLUSH.update(mode="streamed", shards=nd, fused=msm_torch.fused_for_lanes(2 * na_c // nd),
                      chunks=len(chunks), chunk_lanes=2 * na_c, shard_lanes=2 * na_c // nd,
                      peak_lanes_in_flight=peak, lanes=len(chunks) * 2 * na_c,
                      prep_s=sum(e - s for s, e in prep_spans), prep_wait_s=wait_s,
                      prep_overlap_s=overlap_s, transfer_s=time.perf_counter() - t_sync,
                      jit_bucket=na_c, padding_lanes=len(chunks) * 2 * na_c - (2 * n + len(chunks)),
                      total_s=time.perf_counter() - t0)
    if batch_ok and lanes_ok:
        return np.concatenate(prechecks)
    return None


def _prewarm_survivor_mesh(pk: bytes, msg: bytes, sig: bytes, device) -> None:
    """Build the HALF-mesh runners (the next power of two down, the
    topology one card's loss rebuilds to) and push one minimal 2-chunk
    streamed flush through them, so the first flush on a survivor mesh
    finds its runners in _RUNNER_CACHE and its kernels built. Only on a
    mesh of 4 cards or more with enough healthy cards (a 2-card mesh falls
    to one card). A failure raises, as every prewarm failure does (D1)."""
    env = _mesh_env(device)
    if env is None or env[0] < 4:
        return
    nd2 = env[0] // 2
    healthy = _mesh_health().healthy_devices(_visible_cards())
    if len(healthy) < nd2:
        return
    surv = _build_sharded_env(healthy[:nd2])
    rows = planner_chunk_rows() + 1
    _verify_batch_rlc_sharded_streamed([pk] * rows, [msg] * rows, [sig] * rows, surv)


# ---------------------------------------------------------------------------
# Exact-mask recovery after a failed combined check, knobs read per call.


# The flush-detail keys whose last values after a recovery are the
# recovery's last flush's, as the reference's shared detail ends.
_RECOVERY_KEYS = ("jit_bucket", "padding_lanes", "transfer_s", "cache_hits", "cache_misses",
                  "h2d_bytes", "device_dispatches")


def _bisect_enabled() -> bool:
    """TMTPU_BISECT=0 restores the one per-signature pass over all rows."""
    return os.environ.get("TMTPU_BISECT", "1") != "0"


def _bisect_leaf_rows() -> int:
    """Ranges of at most this many rows are recovered per signature."""
    try:
        return max(1, int(os.environ.get("TMTPU_BISECT_LEAF", "256")))
    except ValueError:
        return 256


def _bisect_max_bad() -> int:
    """After this many bad leaves the remaining ranges skip their combined
    checks and go straight per signature."""
    try:
        return max(1, int(os.environ.get("TMTPU_BISECT_MAX_BAD", "8")))
    except ValueError:
        return 8


def _bisect(n: int, combined, leaf, leaf_rows: int, min_rows: int):
    """The exact mask of rows [0, n), whose combined check failed, in
    O(bad rows x log(chunks)) flushes; both arms' recursion. A failed range
    splits at the largest power of two below its size; each half gets one
    combined check (`combined(lo, hi)`: the mask, or None when it fails), a
    passing half is done, a failing half recurses, and when the first half
    passes the second is known bad and descends unchecked. Ranges of at most
    `leaf_rows` rows, under 2 `min_rows` rows, or after _bisect_max_bad()
    bad leaves take `leaf(lo, hi)` (the exact mask). Each call of either is
    one flush. Returns (mask, flushes, bad leaves)."""
    out = np.zeros(n, dtype=bool)
    max_bad = _bisect_max_bad()
    flushes = bad_leaves = 0

    def _check(lo, hi):
        nonlocal flushes
        flushes += 1
        return combined(lo, hi)

    def _go(lo, hi):  # [lo, hi) holds at least one bad row
        nonlocal flushes, bad_leaves
        m = hi - lo
        if m <= leaf_rows or m < 2 * min_rows or bad_leaves >= max_bad:
            flushes += 1
            bad_leaves += 1
            out[lo:hi] = leaf(lo, hi)
            return
        mid = lo + (1 << ((m - 1).bit_length() - 1))  # the largest power of two < m
        first = _check(lo, mid)
        if first is not None:
            out[lo:mid] = first
            _go(mid, hi)  # the parent failed and the first half passed
            return
        _go(lo, mid)
        if hi - mid >= min_rows and bad_leaves < max_bad:
            second = _check(mid, hi)
            if second is not None:
                out[mid:hi] = second
                return
        _go(mid, hi)

    _go(0, n)
    return out, flushes, bad_leaves


def _bisect_recover(pubkeys, msgs, sigs, device):
    """The card arm's bisection (_bisect): combined checks by _rlc_submit /
    _rlc_finish, leaves of TMTPU_BISECT_LEAF rows on the per-signature
    ladder, no sub-check under 2 RLC_MIN rows. While a mesh stands both are
    sharded (_verify_batch_rlc_sharded, the sharded ladder), as in the
    reference; the mesh is read again at each flush. One bad row over
    C = ceil(n / leaf) chunks costs at most 2 ceil(log2 C) + 1 flushes.
    Returns (mask, flushes); the path becomes "rlc-bisect" unless the
    recovery was one leaf."""

    def combined(lo, hi):
        env = _mesh_env(device)
        if env is not None:
            return _verify_batch_rlc_sharded(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], env)
        return _rlc_finish(_rlc_submit(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], device))

    mask, flushes, bad_leaves = _bisect(
        len(pubkeys), combined,
        lambda lo, hi: _persig_flush(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], device,
                                     _mesh_env(device)),
        _bisect_leaf_rows(), RLC_MIN)
    if bad_leaves > 1 or flushes > 1:
        _PATH.label = "rlc-bisect"
    return mask, flushes


def verify_batch_cuda(pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
                      device: torch.device) -> np.ndarray:
    """The card arm on a resolved `device` (the reference's verify_batch_jax
    on one device); _PATH.label names the route. After a failed single or
    pipelined combined check (or a pipelined geometry that declines, as in
    the reference), the exact mask comes from the bisection or, with
    TMTPU_BISECT=0, one per-signature pass; LAST_FLUSH keeps the failed
    flush's detail, the recovery's last values of _RECOVERY_KEYS (as the
    reference's detail ends), rlc_fallback, recovery_flushes and recovery_s.
    With TMTPU_RLC=0 every size runs one per-signature pass, as the
    reference's does. While a mesh of `device`'s kind stands (_mesh_env),
    the combined check, the ladder, the bisection's halves and the streamed
    planner run sharded across it ("rlc-sharded", "sharded",
    "rlc-sharded-streamed"), as the reference's verify_batch_jax consults
    its mesh; a sharded failure raises (D1)."""
    n = len(pubkeys)
    env = _mesh_env(device)
    if n < RLC_MIN or not _rlc_enabled():
        LAST_FLUSH.update(mode="persig")
        return _persig_flush(pubkeys, msgs, sigs, device, env)
    if planner_engaged(n):
        return _verify_batch_streamed(pubkeys, msgs, sigs, device)
    if env is not None:
        mask = _verify_batch_rlc_sharded(pubkeys, msgs, sigs, env)
        if mask is not None:
            return mask
    elif _stream_enabled() and n >= _stream_floor():
        mask = _verify_batch_pipelined(pubkeys, msgs, sigs, device)
        if mask is not None:
            _PATH.label = "rlc-pipelined"
            return mask
    else:
        mask = _rlc_finish(_rlc_submit(pubkeys, msgs, sigs, device))
        if mask is not None:
            _PATH.label = "rlc"
            return mask
    detail = dict(LAST_FLUSH)
    t0 = time.perf_counter()
    if _bisect_enabled():
        mask, flushes = _bisect_recover(pubkeys, msgs, sigs, device)
    else:
        mask, flushes = _persig_flush(pubkeys, msgs, sigs, device, _mesh_env(device)), 1
    last = {k: LAST_FLUSH[k] for k in _RECOVERY_KEYS if k in LAST_FLUSH}
    LAST_FLUSH.clear()
    LAST_FLUSH.update(detail, **last, rlc_fallback=True, recovery_flushes=flushes,
                      recovery_s=time.perf_counter() - t0)
    return mask


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
    if sr_idx:
        record_backend_rows("sr25519", len(sr_idx))
    if bls_idx:
        record_backend_rows("bls12_381", len(bls_idx))
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


def _mixed_rlc_eligible(n: int, key_types, be: str) -> bool:
    """The reference's rule for the one-MSM mixed flush: the card arm,
    TMTPU_RLC on, RLC_MIN rows or more, within the planner's budget (an
    over-budget mixed set takes the split, whose Ed25519 rows stream), and
    every row Ed25519 or sr25519 (the split refuses any other type)."""
    return (be == "cuda" and _rlc_enabled() and n >= RLC_MIN and not planner_engaged(n)
            and all(t in RLC_KEY_TYPES for t in key_types))


def _record_typed_rows(key_types) -> None:
    """A settled combined check's rows, once under each of its two types."""
    for kt in RLC_KEY_TYPES:
        kn = sum(1 for t in key_types if t == kt)
        if kn:
            record_backend_rows(kt, kn)


def _verify_batch_mixed_routed(pubkeys, msgs, sigs, key_types, device, backend) -> tuple:
    """verify_batch's routing of a set holding other key types (the
    reference's _verify_batch_routed, mixed branch): (mask, arm, label). An
    eligible set (_mixed_rlc_eligible) runs ONE mixed combined check on the
    card ("rlc-mixed"); when it fails, the exact per-type split gives the
    mask ("mixed", LAST_FLUSH rlc_fallback and the failed check's seconds
    in combined_s). Anything else takes the split directly, a set on a mesh
    too (its Ed25519 rows then take the sharded arms, as the reference's
    mixed route steps aside for its mesh). A device error raises (D1)."""
    be = backend_default() if backend is None else _card_alias(backend)
    if _mixed_rlc_eligible(len(pubkeys), key_types, be) and _mesh_env(resolve(device)) is None:
        t0 = time.perf_counter()
        mask = _rlc_finish(_rlc_submit(pubkeys, msgs, sigs, resolve(device), key_types))
        if mask is not None:
            _PATH.label = "rlc-mixed"
            _record_typed_rows(key_types)
            return mask, "cuda", "rlc-mixed"
        combined_s = time.perf_counter() - t0
        mask = _verify_batch_mixed_exact(pubkeys, msgs, sigs, key_types, device, backend)
        LAST_FLUSH.update(rlc_fallback=True, combined_s=combined_s)
        return mask, be, "mixed"
    return _verify_batch_mixed_exact(pubkeys, msgs, sigs, key_types, device, backend), be, "mixed"


def _verify_batch_routed(pubkeys, msgs, sigs, device, backend) -> tuple:
    """verify_batch's routing of an all-Ed25519 set (the reference's
    _verify_batch_routed): (mask, arm, route label). An arm that is neither
    the host nor the card raises ValueError."""
    be = backend_default() if backend is None else _card_alias(backend)
    record_backend_rows("ed25519", len(pubkeys))
    if (backend is None and be == "cuda" and len(pubkeys) < _CUDA_MIN_BATCH
            and not _names_card(device)):
        be = "cpu"
    if be == "cpu":
        return verify_batch_cpu(pubkeys, msgs, sigs), "cpu", "cpu"
    if be != "cuda":
        raise ValueError(f"unknown crypto backend {be!r}")
    mask = verify_batch_cuda(pubkeys, msgs, sigs, resolve(device))
    return mask, "cuda", _PATH.label


def _score_rows(sources, mask) -> Optional[int]:
    """The provenance feed (the reference's, batch.py:3200-3215): the rows
    whose source was already quarantined when this flush ran (None for
    none), then the scorer advances on the flush's verdicts. Advisory: it
    never raises into the verify path."""
    from tendermint_tpu_torch.crypto import provenance as _prov

    try:
        scorer = _prov.default_scorer()
        q = scorer.quarantined_sources()
        quarantined = (sum(1 for s in sources if s in q) or None) if q else None
        scorer.record_rows(sources, mask)
    except Exception:
        return None
    return quarantined


_DETAIL_FIELDS = ("transfer_s", "jit_bucket", "padding_lanes", "cache_hits", "cache_misses",
                  "fused", "h2d_bytes", "device_dispatches", "chunks", "chunk_lanes",
                  "prep_overlap_s")


def _detail_fields(detail: dict) -> dict:
    """The flush detail's record_flush fields (absent: None)."""
    return {k: detail.get(k) for k in _DETAIL_FIELDS}


def _record_memo_hits(nh: int, t_memo: float, sources) -> None:
    """A memo answer's flush record; rows answered clean still count toward
    their sources' parole."""
    _trace.record_flush(backend="memo", path="memo", n=nh, total_s=time.perf_counter() - t_memo,
                        n_valid=nh, memo_hits=nh)
    if sources is not None:
        _score_rows(sources, np.ones(nh, dtype=bool))


def verify_batch(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], device=None,
    key_types: Optional[Sequence[str]] = None, backend: Optional[str] = None, *,
    sources: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Verify N (pubkey, msg, sig) triples; returns bool[N]. key_types: per-row
    key type, None meaning all ed25519; a set with other types takes the
    one-MSM mixed flush (path "rlc-mixed") or the per-type split (path
    "mixed"), as _verify_batch_mixed_routed decides. backend:
    "cuda" (the card arm on `device`; "jax", the reference's name, is read
    as "cuda"), "cpu" (the host arm) or None (TMTPU_CRYPTO_BACKEND, the
    verify mode, the row count and a card `device` decide; see the module
    docstring). sources: optional per-row provenance tags
    (crypto/provenance.py); the flush's verdicts feed the suspicion scorer,
    None skips scoring. Tags never change a verdict.

    The verified-row memo is read first, as in the reference: when every
    row verified True before, the mask comes from it with no flush (path
    "memo"); when some did, only the others are verified (LAST_FLUSH is
    that flush's, with memo_hits). The rows of a flush that verify True are
    inserted after it; a flush that raises inserts nothing. Then, inside a
    scheduler's lane_scope on this thread, the rows go to that lane
    (crypto/scheduler.py) instead of flushing here. LAST_FLUSH["path"] is
    the route's label; every flush is also recorded by libs/trace.py's
    record_flush (one span when tracing is on)."""
    if not (len(pubkeys) == len(msgs) == len(sigs)):
        raise ValueError("pubkeys/msgs/sigs length mismatch")
    if len(pubkeys) == 0:
        return np.zeros(0, dtype=bool)
    digests = None
    if _MEMO.capacity:
        digests = _MEMO.digest_rows(pubkeys, msgs, sigs, key_types)
        t_memo = time.perf_counter()
        hit = _MEMO.lookup(digests) if len(_MEMO) else np.zeros(len(digests), dtype=bool)
        nh = int(hit.sum())
        if nh == len(pubkeys):
            LAST_FLUSH.clear()
            LAST_FLUSH.update(path="memo", memo_hits=nh)
            _record_memo_hits(nh, t_memo, sources)
            return np.ones(nh, dtype=bool)
        if nh:
            _record_memo_hits(nh, t_memo, None if sources is None else
                              [sources[i] for i in np.flatnonzero(hit)])
            idx = np.flatnonzero(~hit)
            out = np.ones(len(pubkeys), dtype=bool)
            out[idx] = verify_batch(
                [pubkeys[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx],
                device=device, backend=backend,
                key_types=None if key_types is None else [key_types[i] for i in idx],
                sources=None if sources is None else [sources[i] for i in idx])
            LAST_FLUSH["memo_hits"] = nh
            return out
    if _LANE_ROUTER is not None:
        mask = _LANE_ROUTER(pubkeys, msgs, sigs, backend, key_types, sources)
        if mask is not None:
            return mask
    tr = _trace.tracer if _trace.tracer.enabled else None  # one flag read
    compile0 = _trace.compile_seconds_total()
    t0 = time.perf_counter()
    span = None
    if tr is not None:
        span = tr.span("verify_batch", n=len(pubkeys))
        span.__enter__()
    try:
        LAST_FLUSH.clear()
        if key_types is not None and any(t != "ed25519" for t in key_types):
            mask, be, path = _verify_batch_mixed_routed(pubkeys, msgs, sigs, key_types, device,
                                                        backend)
        else:
            mask, be, path = _verify_batch_routed(pubkeys, msgs, sigs, device, backend)
    except BaseException as e:
        if span is not None:
            span.set(error=type(e).__name__)
            span.__exit__(None, None, None)
        raise
    LAST_FLUSH["path"] = path
    _MEMO.insert(digests, mask)
    detail = dict(LAST_FLUSH)
    compile_s = _trace.compile_seconds_total() - compile0
    quarantined = None if sources is None else _score_rows(sources, mask)
    _trace.record_flush(
        backend=be, path=path, n=len(pubkeys), total_s=time.perf_counter() - t0,
        n_valid=int(mask.sum()), prep_s=detail.get("prep_s"),
        compile_s=compile_s if compile_s > 0 else None, **_detail_fields(detail),
        rlc_fallback=bool(detail.get("rlc_fallback")),
        recovery_flushes=detail.get("recovery_flushes"), quarantined=quarantined, tracer_=tr)
    if span is not None:
        span.set(path=path, backend=be)
        span.__exit__(None, None, None)
    return mask


# ---------------------------------------------------------------------------
# Scheduler lane hook (crypto/scheduler.py): inside a scheduler's
# lane_scope, verify_batch and verify_batch_submit send their rows to that
# lane instead of flushing themselves. One global read and a None check on
# every call when no scheduler is installed.

_LANE_ROUTER = None


def set_lane_router(router) -> None:
    """Install the scheduler's row router: callable(pubkeys, msgs, sigs,
    backend, key_types, sources) -> mask, or None to route normally."""
    global _LANE_ROUTER
    _LANE_ROUTER = router


# ---------------------------------------------------------------------------
# Submit / finish: a flush whose device work is queued before the caller
# syncs it, so independent checks (the light client's trusting and light
# pair) put both flushes on the card before reading either. Cross-request
# accumulation (FlushAccumulator) lets many submits share one flush.


class FlushAccumulator:
    """While installed on this thread by `accumulate_flushes()`, every
    verify_batch_submit appends its rows here instead of flushing, and
    `flush()` verifies all of them with ONE verify_batch call; each
    submit's verify_batch_finish returns its own slice of that mask. The
    slices equal separate requests' masks: every route gives the exact
    per-row mask, so a bad row in one request never changes another's."""

    __slots__ = ("backend", "device", "pubkeys", "msgs", "sigs", "key_types", "_mask",
                 "_flushed", "_error", "flush_count")

    def __init__(self, backend: Optional[str] = None, device=None):
        self.backend = backend
        self.device = device
        self.pubkeys: list = []
        self.msgs: list = []
        self.sigs: list = []
        self.key_types: list = []
        self._mask: Optional[np.ndarray] = None
        self._flushed = False
        self._error: Optional[BaseException] = None
        self.flush_count = 0  # verify_batch calls this accumulator made

    @property
    def lanes(self) -> int:
        return len(self.pubkeys)

    def add(self, pubkeys, msgs, sigs, key_types) -> tuple:
        """Append one submit's rows; returns its (start, end) slice."""
        if self._flushed:
            raise RuntimeError("FlushAccumulator already flushed")
        start = len(self.pubkeys)
        self.pubkeys.extend(pubkeys)
        self.msgs.extend(msgs)
        self.sigs.extend(sigs)
        self.key_types.extend(key_types if key_types is not None else ["ed25519"] * len(pubkeys))
        return start, len(self.pubkeys)

    def flush(self) -> np.ndarray:
        """Verify every accumulated row in one verify_batch call. Idempotent:
        a failed flush latches its error and re-raises it at every later
        call. Call it outside the accumulate_flushes() scope, or on an
        accumulator no longer installed."""
        if self._flushed:
            if self._error is not None:
                raise self._error
            return self._mask
        self._flushed = True
        if not self.pubkeys:
            self._mask = np.zeros(0, dtype=bool)
            return self._mask
        kt = self.key_types if any(t != "ed25519" for t in self.key_types) else None
        self.flush_count += 1
        try:
            self._mask = verify_batch(self.pubkeys, self.msgs, self.sigs, device=self.device,
                                      key_types=kt, backend=self.backend)
        except BaseException as e:
            self._error = e
            raise
        return self._mask


_ACC_TLS = threading.local()


def current_accumulator() -> Optional[FlushAccumulator]:
    return getattr(_ACC_TLS, "current", None)


@contextlib.contextmanager
def accumulate_flushes(acc: Optional[FlushAccumulator] = None, backend: Optional[str] = None,
                       device=None):
    """Install a FlushAccumulator on THIS thread: verify_batch_submit calls
    inside the scope accumulate instead of flushing. Leaving the scope does
    not flush: the caller flushes, or the first verify_batch_finish does.
    Thread-local, so an accumulator never captures another thread's
    submits."""
    acc = acc or FlushAccumulator(backend=backend, device=device)
    prev = getattr(_ACC_TLS, "current", None)
    _ACC_TLS.current = acc
    try:
        yield acc
    finally:
        _ACC_TLS.current = prev


class BatchHandle:
    """A verify_batch_submit in flight: resolved (`_mask`), a combined check
    queued on the device (`_call`, with the rows for recovery in `_args` and
    their memo digests in `_digests`), or a slice of an accumulator's flush
    (`_acc`, `_acc_range`)."""

    __slots__ = ("_mask", "_call", "_args", "_acc", "_acc_range", "_digests")

    def __init__(self, mask=None, call=None, args=None, acc=None, acc_range=None,
                 digests=None):
        self._mask = mask
        self._call = call
        self._args = args
        self._acc = acc
        self._acc_range = acc_range
        self._digests = digests


def verify_batch_submit(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], device=None,
    key_types: Optional[Sequence[str]] = None, backend: Optional[str] = None,
) -> BatchHandle:
    """Start a verification; pair with verify_batch_finish. Inside an
    accumulate_flushes() scope the rows join the accumulator. Otherwise
    the submit is eligible for the asynchronous single flush (the
    reference's rule, tendermint_tpu/crypto/batch.py verify_batch_submit)
    when the backend resolves to "cuda", TMTPU_RLC is not "0", every row is
    Ed25519 or sr25519, the set holds at least max(RLC_MIN, _CUDA_MIN_BATCH)
    rows (RLC_MIN alone when a backend or a card `device` is named) and it
    is not planner-engaged. An eligible submit whose rows are all in the
    verified-row memo comes back resolved (path "memo"); else _rlc_submit
    queues the combined check on `device` (the mixed flush for a set with
    sr25519 rows) and returns without syncing. Anything else runs
    verify_batch eagerly, whose own memo reading covers it, and the handle
    comes back resolved. Inside a scheduler's lane_scope (and outside an accumulator)
    the rows go to that lane and the handle comes back resolved: the lane's
    combined flush is the overlap. While a mesh of the device's kind stands
    (_sharded_env), the submit runs verify_batch eagerly on the sharded
    arms, as the reference's does. The reference's circuit breaker is not
    ported, nor its catch around the submit (D1): a failure raises."""
    if not (len(pubkeys) == len(msgs) == len(sigs)):
        raise ValueError("pubkeys/msgs/sigs length mismatch")
    acc = current_accumulator()
    if acc is not None:
        return BatchHandle(acc=acc, acc_range=acc.add(pubkeys, msgs, sigs, key_types))
    n = len(pubkeys)
    if _LANE_ROUTER is not None and n > 0:
        mask = _LANE_ROUTER(pubkeys, msgs, sigs, backend, key_types)
        if mask is not None:
            return BatchHandle(mask=mask)
    be = backend_default() if backend is None else _card_alias(backend)
    mixed = key_types is not None and any(t != "ed25519" for t in key_types)
    floor = _CUDA_MIN_BATCH if backend is None and not _names_card(device) else 0
    if not (be == "cuda" and _rlc_enabled() and n >= max(RLC_MIN, floor)
            and not planner_engaged(n)
            and (not mixed or all(t in RLC_KEY_TYPES for t in key_types))):
        return BatchHandle(mask=verify_batch(pubkeys, msgs, sigs, device=device,
                                             key_types=key_types, backend=backend))
    digests = None
    if _MEMO.capacity:
        digests = _MEMO.digest_rows(pubkeys, msgs, sigs, key_types)
        t_memo = time.perf_counter()
        if len(_MEMO) and _MEMO.lookup(digests).all():
            LAST_FLUSH.clear()
            LAST_FLUSH.update(path="memo", memo_hits=n)
            _record_memo_hits(n, t_memo, None)
            return BatchHandle(mask=np.ones(n, dtype=bool))
    dev = resolve(device)
    if _mesh_env(dev) is not None:
        return BatchHandle(mask=verify_batch(pubkeys, msgs, sigs, device=device,
                                             key_types=key_types, backend=backend))
    t0 = time.perf_counter()
    kt = key_types if mixed else None
    return BatchHandle(call=_rlc_submit(pubkeys, msgs, sigs, dev, kt),
                       args=(pubkeys, msgs, sigs, dev, t0, kt, device, backend),
                       digests=digests)


def verify_batch_finish(h: BatchHandle) -> np.ndarray:
    """The mask of a submitted verification. A queued combined check is
    synced (LAST_FLUSH path "rlc-async", mode "mixed" for a mixed set);
    when it fails, one per-signature pass over all rows gives the exact mask
    (path "persig-async", one recovery flush), as the reference's finish
    recovers: it does not bisect. A failed mixed check recovers by the exact
    per-type split instead (path "mixed", rlc_fallback). Either way the
    rows that verified True enter the verified-row memo. Finishing twice
    returns the same mask. Handles in flight share no device buffer (each
    flush allocates its own tensors; the A cache grows by copy and never
    rewrites a column a queued flush reads), so they may finish in any
    order; LAST_FLUSH is the last finish's."""
    if h._mask is not None:
        return h._mask
    if h._acc is not None:
        start, end = h._acc_range
        h._mask = h._acc.flush()[start:end]
        return h._mask
    pubkeys, msgs, sigs, dev, t0, key_types, device, backend = h._args
    tr = _trace.tracer if _trace.tracer.enabled else None  # one flag read
    LAST_FLUSH.clear()
    if tr is not None:
        with tr.span("rlc.finish", n=len(pubkeys), async_=True):
            mask = _rlc_finish(h._call)
    else:
        mask = _rlc_finish(h._call)
    detail = dict(LAST_FLUSH)
    if key_types is None:
        record_backend_rows("ed25519", len(pubkeys))
    elif mask is not None:  # a failed mixed check's split records its own rows
        _record_typed_rows(key_types)
    if mask is None and key_types is not None:
        # the mixed check failed: the exact per-type split, whose own flushes
        # record themselves, as the reference's finish recovers
        t_rec = time.perf_counter()
        mask = _verify_batch_mixed_exact(pubkeys, msgs, sigs, key_types, device, backend)
        LAST_FLUSH.update(path="mixed", rlc_fallback=True, combined_s=detail.get("total_s"),
                          recovery_s=time.perf_counter() - t_rec)
    elif mask is not None:
        LAST_FLUSH["path"] = "rlc-async"
        _trace.record_flush(
            backend="cuda", path="rlc-async", n=len(pubkeys), total_s=time.perf_counter() - t0,
            n_valid=int(mask.sum()), prep_s=detail.get("prep_s"), **_detail_fields(detail),
            tracer_=tr)
    else:
        t_rec = time.perf_counter()
        mask = _persig_flush(pubkeys, msgs, sigs, dev)
        LAST_FLUSH.update(path="persig-async", recovery_flushes=1,
                          recovery_s=time.perf_counter() - t_rec)
        _trace.record_flush(
            backend="cuda", path="persig-async", n=len(pubkeys),
            total_s=time.perf_counter() - t0, n_valid=int(mask.sum()),
            transfer_s=LAST_FLUSH.get("transfer_s"), jit_bucket=LAST_FLUSH.get("jit_bucket"),
            padding_lanes=LAST_FLUSH.get("padding_lanes"), rlc_fallback=True, tracer_=tr)
    _MEMO.insert(h._digests, mask)
    h._mask, h._call, h._args, h._digests = mask, None, None, None
    return mask


def _prewarm_bls(device) -> None:
    """Warm the aggregate path: bls_ref's derived tables (a keygen, a
    signature, a verify) and one 4-point fold on `device` through
    ops/bls12_torch.py. A throwaway key from OS entropy."""
    from tendermint_tpu_torch.crypto import bls_ref
    from tendermint_tpu_torch.ops import bls12_torch

    sk = bls_ref.gen_sk()
    pk = bls_ref.sk_to_pk(sk)
    sig = bls_ref.sign(sk, b"prewarm")
    aff = bls_ref._jac_to_affine(bls_ref.g1_from_bytes(pk))
    bls12_torch.fold_points(bls12_torch.affine_limbs([(aff[0].v, aff[1].v)] * 4), device)
    bls_ref.verify(pk, b"prewarm", sig)


def prewarm(n_vals: int, backend: Optional[str] = None, pubkeys: Optional[Sequence[bytes]] = None,
            planner_chunk: bool = True, bls: bool = False, device=None) -> None:
    """Do ahead of a node's first flush what its first flushes would pay:
    the nvcc builds (on a card), the prep worker and the native pool, one
    plain single flush and one cached-A single flush of n_vals rows (the
    stream off for both, restored after), one flush of planner_chunk_rows()
    + 1 rows (the chunk bucket the pipelined and streamed paths run), and,
    with `pubkeys`, the A cache filled from the real keys. bls=True also
    warms the aggregate path (_prewarm_bls). Nothing off the card arm, nor
    below _CUDA_MIN_BATCH validators unless `device` names a card (the rule
    verify_batch routes by). On a mesh the flushes run its sharded arms, and
    the half mesh is warmed too (_prewarm_survivor_mesh). The throwaway key
    comes from OS entropy."""
    if bls:
        _prewarm_bls(device)
    be = _card_alias(backend) or backend_default()
    if be != "cuda" or (n_vals < _CUDA_MIN_BATCH and not _names_card(device)):
        return  # small sets run on the host: nothing to warm
    from tendermint_tpu_torch.crypto import ed25519_ref
    from tendermint_tpu_torch.ops import msm_torch

    dev = resolve(device)
    if dev.type == "cuda":
        from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

        cuda_fe.build()
        cuda_msm.build()
    seed = os.urandom(32)
    pk = ed25519_ref.public_key(seed)
    msg = b"prewarm"
    sig = ed25519_ref.sign(seed, msg)
    _prep_pool()
    native.prep_pool_size()
    stream_prev = _PREP_CFG["stream"]
    _PREP_CFG["stream"] = False
    try:
        verify_batch_cuda([pk] * n_vals, [msg] * n_vals, [sig] * n_vals, dev)  # plain, fills A
        verify_batch_cuda([pk] * n_vals, [msg] * n_vals, [sig] * n_vals, dev)  # cached-A
    finally:
        _PREP_CFG["stream"] = stream_prev
    if planner_chunk:
        rows = planner_chunk_rows() + 1
        verify_batch_cuda([pk] * rows, [msg] * rows, [sig] * rows, dev)
        _prewarm_survivor_mesh(pk, msg, sig, dev)
    good = [np.frombuffer(bytes(k), dtype=np.uint8) for k in (pubkeys or ()) if len(k) == 32]
    if good:
        enc = np.stack(good)
        pts, ok = msm_torch.decompress_rows(enc, device=dev)
        fill_a_cache(enc, pts, ok)
    LAST_FLUSH.clear()


class Ed25519BatchVerifier:
    """Accumulate-and-flush batch verifier (the reference's interface for
    the vote path and commit verification); `device` is passed to
    verify_batch."""

    def __init__(self, backend: Optional[str] = None, device=None) -> None:
        self._backend = backend
        self._device = device
        self._pubkeys: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []

    def add(self, pubkey: bytes, msg: bytes, sig: bytes) -> None:
        self._pubkeys.append(bytes(pubkey))
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def __len__(self) -> int:
        return len(self._pubkeys)

    def verify(self) -> np.ndarray:
        """Verify every triple added; the batch stays until reset()."""
        return verify_batch(self._pubkeys, self._msgs, self._sigs, device=self._device,
                            backend=self._backend)

    def reset(self) -> None:
        self._pubkeys.clear()
        self._msgs.clear()
        self._sigs.clear()
