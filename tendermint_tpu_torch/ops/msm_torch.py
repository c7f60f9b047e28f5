"""Random-linear-combination (RLC) batch check: the Pippenger MSM.

The counterpart of tendermint_tpu/ops/msm_jax.py. One group equation over
random coefficients z_i (multiples of 8, scalars mod 8L) replaces N ladders:

    sum [w_i] A_i + [(L - u) mod L] B + sum [z_i] R_i == identity

Host: per 8-bit window, stable-sort lane indices by digit and take the
bucket boundaries (`sort_windows`). Device, two schedules of one sum:

- fused (`_msm_total_fused`, every flush whose lane count a 1024- or
  2048-lane chunk tiles: `fused_for_lanes`): one `uptree` kernel gathers
  the lanes into sorted order, bit-reversed within each chunk, and builds
  every chunk's pair tree; a small top tree over the chunk roots; one `fenwick_reduce`
  kernel sums each bucket boundary's tree nodes into prefix points P_v; one
  `bucket_fold` kernel gives sum_{v<255} P_v and P_255 per window
  (ops/cuda_msm.py);
- unfused (`_msm_total`, the reference's differential reference): one tree
  level per padd launch over the concatenated levels, a gathered
  (T, 256, 17) node tensor, pair-tree sums.

Both end in the telescoped weighted bucket sum 255 P_255 - sum_{v<255} P_v
and the pairwise window fold, on ops/cuda_fe.padd / pdbl. The tree levels are
plain Python loops (no scan forms: those existed for the XLA:CPU compiler).

The submit functions return one packed bool tensor `[batch_ok, lane_ok...]`
on the device, so the caller's finish does one device-to-host copy. The
decompression and the MSM of every submit run inside
torch.profiler.record_function ranges named "decompress" and "msm", the
reference's stage names, so a profile attributes the point kernels that
both launch (tools/profile_report.py); a range adds no launch. Two
cached-A variants: the mixed Ed25519 + sr25519 flush
(`rlc_check_cached_mixed_submit`: lanes [A | Ed25519 R | sr25519 R], the
sr25519 R lanes decoded by ops/ristretto_torch.py) and, under
TMTPU_DEVICE_SORT=1, the window sort on the device (`sort_windows_device`,
torch.argsort and searchsorted: a sort stage, not a ported kernel). The
streamed flush planner (crypto/batch.py) uses the partial trio instead:
`rlc_partial_submit` (the MSM without its identity check),
`partial_fold_submit` and `partial_identity_submit`.
"""

from __future__ import annotations

import os
import threading
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from tendermint_tpu_torch import native
from tendermint_tpu_torch.libs.profiler import DECOMPRESS, MSM
from tendermint_tpu_torch.ops import cuda_fe, cuda_msm
from tendermint_tpu_torch.ops import fe25519 as fe
from tendermint_tpu_torch.ops.ed25519_torch import decompress, identity, point_neg, point_select
from tendermint_tpu_torch.ops.msm_geometry import (
    LANE, brev, chunk_for_lanes, chunk_geometry)
from tendermint_tpu_torch.ops.ristretto_torch import ristretto_decode

WINDOW_BITS = 8
NWIN = 32  # 256 bits / 8
NBUCKETS = 1 << WINDOW_BITS
FENWICK_K = 17  # max tree levels: boundary prefixes reach N <= 2^16 lanes


# --------------------------------------------------------------------------
# Level geometry (shared host/device so Fenwick indices line up).


def level_widths(n_lanes: int) -> list:
    """Pair-tree level widths: level 0 = n_lanes, each next level halves
    (odd widths padded up by one identity lane first)."""
    widths = [n_lanes]
    w = n_lanes
    while w > 1:
        w = (w + 1) // 2
        widths.append(w)
    return widths


def level_offsets(n_lanes: int) -> Tuple[list, int]:
    offs, total = [], 0
    for w in level_widths(n_lanes):
        offs.append(total)
        total += w
    return offs, total


def fenwick_node_indices(ends: np.ndarray, n_lanes: int) -> np.ndarray:
    """ends (T, NBUCKETS) -> (T, NBUCKETS, FENWICK_K) int32 indices into the
    concatenated tree levels: slot l holds the level-l node of the Fenwick
    decomposition of the prefix [0, ends[w, v]), or the identity lane
    (index = total width) when bit l of the boundary is clear. The prefix
    [0, e) is one aligned block per set bit l of e: node (e >> (l+1)) << 1."""
    offs, total = level_offsets(n_lanes)
    e = ends.astype(np.int64)
    out = np.full((*ends.shape, FENWICK_K), total, dtype=np.int32)
    for lvl in range(min(FENWICK_K, len(offs))):
        bit = (e >> lvl) & 1
        idx = offs[lvl] + ((e >> (lvl + 1)) << 1)
        out[..., lvl] = np.where(bit == 1, idx, total).astype(np.int32)
    return out


_INDEX_CONSTS: dict = {}


def _index_const(key, device, make) -> torch.Tensor:
    """A host-built index table on `device`, uploaded once per process. A
    blocking host-to-device copy in the middle of a flush waits for every
    kernel queued before it, so none is made there."""
    k = (key, str(device))
    t = _INDEX_CONSTS.get(k)
    if t is None:
        t = _INDEX_CONSTS[k] = make().to(device)
    return t


def fenwick_nodes_device(ends: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """fenwick_node_indices on the device: ends (T, NBUCKETS) int32 tensor ->
    (T, NBUCKETS, FENWICK_K) int64."""
    offs, total = level_offsets(n_lanes)
    lvls = min(FENWICK_K, len(offs))
    e = ends.to(torch.int64).unsqueeze(-1)
    lvl = torch.arange(lvls, dtype=torch.int64, device=ends.device)
    bit = (e >> lvl) & 1
    offs_t = _index_const(("offs", n_lanes), ends.device,
                          lambda: torch.tensor(offs[:lvls], dtype=torch.int64))
    idx = offs_t + ((e >> (lvl + 1)) << 1)
    out = torch.where(bit == 1, idx, torch.full_like(idx, total))
    if lvls < FENWICK_K:
        pad = torch.full((*out.shape[:-1], FENWICK_K - lvls), total, dtype=torch.int64,
                         device=ends.device)
        out = torch.cat([out, pad], dim=-1)
    return out


def sort_windows(digits: np.ndarray, zero16_from: int = 0):
    """digits (n_lanes, NWIN) uint8 (window w digit = byte w of the scalar) ->
    (perm (NWIN, N) uint16 or int32, ends (NWIN, NBUCKETS) int32), by the
    native counting sort."""
    n, t = digits.shape
    if t != NWIN:
        raise ValueError(f"sort_windows: expected {NWIN} windows, got {t}")
    perm32, ends = native.sort_windows(digits, zero16_from)
    return np.ascontiguousarray(perm32.astype(np.uint16 if n < (1 << 16) else np.int32)), ends


def scalars_to_bytes(scalars, n_lanes: int) -> np.ndarray:
    """Little-endian (n_lanes, 32) uint8; rows past len(scalars) are zero.
    A ready (m, 32) uint8 array is taken as is."""
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint8:
        out = scalars
    else:
        blob = b"".join(int(s).to_bytes(32, "little") for s in scalars)
        out = np.frombuffer(blob, dtype=np.uint8).reshape(len(scalars), 32)
    if out.shape[0] == n_lanes:
        return out
    padded = np.zeros((n_lanes, 32), dtype=np.uint8)
    padded[: out.shape[0]] = out
    return padded


# --------------------------------------------------------------------------
# Device schedule. Points are (4, 20, ...batch); the reduced axis is last.


def _pad_lanes(p: torch.Tensor, to: int) -> torch.Tensor:
    w = p.shape[-1]
    if w == to:
        return p
    return torch.cat([p, identity(p.shape[2:-1] + (to - w,), p.device)], dim=-1)


def _halve(p: torch.Tensor) -> torch.Tensor:
    """One tree level: pairwise add over the (even-width) last axis."""
    return cuda_fe.padd(p[..., 0::2].contiguous(), p[..., 1::2].contiguous())


def _pdbl_n(p: torch.Tensor, n: int) -> torch.Tensor:
    return cuda_fe.pdbl(p.contiguous(), n)


def _tree_levels(p: torch.Tensor) -> torch.Tensor:
    """The concatenated pair-tree over the last axis plus one trailing
    identity lane (the Fenwick pad target). p (4, 20, T, N) ->
    (4, 20, T, Wtot + 1); geometry = level_offsets(N)."""
    levels = [p]
    cur = p
    while cur.shape[-1] > 1:
        w = cur.shape[-1]
        if w % 2 == 1:
            cur = _pad_lanes(cur, w + 1)
        cur = _halve(cur)
        levels.append(cur)
    levels.append(identity(p.shape[2:-1] + (1,), p.device))
    return torch.cat(levels, dim=-1)


def _row_table(p: torch.Tensor) -> torch.Tensor:
    """(4, 20, ...batch, W) -> (...batch, W, 80): each lane's 80 limbs
    contiguous, so a gather moves whole 320-byte rows."""
    nb = p.dim() - 2
    return p.permute(*range(2, 2 + nb), 0, 1).reshape(*p.shape[2:], 4 * fe.NLIMBS)


def _from_rows(rows: torch.Tensor) -> torch.Tensor:
    """(...batch, 80) -> (4, 20, ...batch), contiguous."""
    nb = rows.dim() - 1
    return rows.reshape(*rows.shape[:-1], 4, fe.NLIMBS).permute(nb, nb + 1, *range(nb)).contiguous()


def _gather_lanes(p: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """p (4, 20, N); perm (T, N) -> (4, 20, T, N): lane perm[w, i] of p at
    window w, position i (a row gather of the (N, 80) table)."""
    return _from_rows(_row_table(p)[perm.to(torch.int64)])


def _gather_nodes(tree: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """tree (4, 20, T, W); node_idx (T, NBUCKETS, K) -> (4, 20, T, NBUCKETS, K)."""
    t_, w = tree.shape[2], tree.shape[3]
    rows = _row_table(tree).reshape(t_ * w, 4 * fe.NLIMBS)
    base = (torch.arange(t_, device=tree.device, dtype=torch.int64) * w).reshape(t_, 1, 1)
    flat = (node_idx.to(torch.int64) + base).reshape(-1)
    return _from_rows(rows.index_select(0, flat).reshape(*node_idx.shape, 4 * fe.NLIMBS))


def _reduce_last_axis(p: torch.Tensor) -> torch.Tensor:
    """Pair-tree sum over the last axis (odd widths identity-padded)."""
    while p.shape[-1] > 1:
        w = p.shape[-1]
        if w % 2 == 1:
            p = _pad_lanes(p, w + 1)
        p = _halve(p)
    return p[..., 0]


def _bucket_tail(s: torch.Tensor, p_last: torch.Tensor) -> torch.Tensor:
    """Per-window W = 255 P_255 - sum_{v<255} P_v from s = sum_{v<255} P_v
    and p_last = P_255, each (4, 20, T)."""
    m = _pdbl_n(p_last, WINDOW_BITS)  # [256] P_255
    m = cuda_fe.padd(m, point_neg(p_last).contiguous())  # [255] P_255
    return cuda_fe.padd(m, point_neg(s).contiguous())


def _weighted_bucket_sum(prefix: torch.Tensor) -> torch.Tensor:
    """prefix (4, 20, T, NBUCKETS): P_v = sum of sorted lanes with digit <= v.
    Returns per-window W = sum_{v>=1} v (P_v - P_{v-1}) = 255 P_255 -
    sum_{v<255} P_v, shape (4, 20, T). Bucket 0 (zero scalars, pads) cancels."""
    p_last = prefix[..., -1].contiguous()
    s = _reduce_last_axis(prefix[..., :-1])  # the reference's _sum_last_axis
    return _bucket_tail(s, p_last)


def _fold_windows(w_pts: torch.Tensor) -> torch.Tensor:
    """sum_w [256^w] W_w as the pairwise fold: level k computes
    V_i = U_{2i} + [2^(8 * 2^k)] U_{2i+1}. w_pts (4, 20, T) -> (4, 20)."""
    p = w_pts
    shift = WINDOW_BITS
    while p.shape[-1] > 1:
        w = p.shape[-1]
        if w % 2 == 1:
            p = _pad_lanes(p, w + 1)
        odd = _pdbl_n(p[..., 1::2], shift)
        p = cuda_fe.padd(p[..., 0::2].contiguous(), odd)
        shift *= 2
    return p[..., 0]


def _msm_total(pts: torch.Tensor, perm: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """pts (4, 20, N) valid points; perm (T, N); node_idx (T, NBUCKETS, K).
    Returns the multiscalar sum as one point (4, 20)."""
    gathered = _gather_lanes(pts, perm)  # (4, 20, T, N)
    tree = _tree_levels(gathered)  # (4, 20, T, Wtot + 1)
    nodes = _gather_nodes(tree, node_idx)  # (4, 20, T, NBUCKETS, K)
    prefix = _reduce_last_axis(nodes)  # (4, 20, T, NBUCKETS)
    return _fold_windows(_weighted_bucket_sum(prefix))


def point_is_identity(total: torch.Tensor) -> torch.Tensor:
    """Projective identity check with the degenerate-output guard: an
    exceptional unified addition (crafted torsion inputs only) yields
    (0, 0, 0, 0), which must read as "check failed", not as the identity."""
    return fe.is_zero(total[0]) & fe.eq(total[1], total[2]) & ~fe.is_zero(total[2])


# --------------------------------------------------------------------------
# Fused schedule. Storage map (global node indices, one index space):
#   [0, T*N)                       level-0 lanes, bit-reversed within chunks
#   [G1, G1 + T*ncw*rows_out*128)  chunk trees (levels 1..lc, chunk-major)
#   [G2, G2 + T*(Wtop+1))          top tree over chunk roots + identity lane
# A bucket boundary e decomposes into the full chunks [0, e >> lc), as
# Fenwick nodes of the top tree, plus the set bits of e & (ch-1), as level-0
# or chunk-tree nodes of the partial chunk at bit-reversed positions.


def fused_for_lanes(n_lanes: int) -> bool:
    """Route this lane count through the fused schedule: a chunk tiles it."""
    return chunk_for_lanes(n_lanes) is not None


def fused_node_indices_device(ends: torch.Tensor, n_lanes: int, ch: int) -> torch.Tensor:
    """ends (T, NBUCKETS) -> (NBUCKETS, T, Kf) int32 global node indices,
    bucket-major (v-major), so the prefix points come out at lane v*T + t."""
    g = chunk_geometry(ch)
    ncw = n_lanes // ch
    t_ = ends.shape[0]
    dev = ends.device
    toffs, ttot = level_offsets(ncw)
    wtop1 = ttot + 1
    g1 = t_ * n_lanes
    g2 = g1 + t_ * ncw * g.rows_out * LANE

    e = ends.to(torch.int32).T.unsqueeze(-1)  # (NB, T, 1)
    w = torch.arange(t_, dtype=torch.int32, device=dev).reshape(1, t_, 1)
    ce = e >> g.lc
    r = e & (ch - 1)
    idn = g2 + w * wtop1 + ttot  # per-window identity lane

    # partial-chunk part: levels 0..lc-1, present iff bit l of r
    lvl = torch.arange(g.lc, dtype=torch.int32, device=dev)
    bit = (r >> lvl) & 1
    j = (r >> (lvl + 1)) << 1
    q = brev(j, g.lc - lvl)  # in-level bit-reversed position
    roff = _index_const(("row_off", ch), dev, lambda: torch.tensor(g.row_off, dtype=torch.int32))
    idx0 = w * n_lanes + ce * ch + q
    idxl = g1 + (w * ncw + ce) * (g.rows_out * LANE) + (roff[lvl] + (q >> 7)) * LANE + (q & 127)
    cidx = torch.where(lvl == 0, idx0, idxl)
    cidx = torch.where(bit == 1, cidx, idn)

    # full-chunks part: the Fenwick decomposition over the ncw chunk totals
    lvl2 = torch.arange(len(toffs), dtype=torch.int32, device=dev)
    bit2 = (ce >> lvl2) & 1
    jt = (ce >> (lvl2 + 1)) << 1
    toffs_t = _index_const(("top_offs", ncw), dev, lambda: torch.tensor(toffs, dtype=torch.int32))
    tidx = g2 + w * wtop1 + toffs_t[lvl2] + jt
    tidx = torch.where(bit2 == 1, tidx, idn)
    return torch.cat([cidx, tidx], dim=-1).to(torch.int32)


def _fused_stages(pts: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor):
    """The fused schedule up to its Fenwick sums: pts (4, 20, N); perm (T, N)
    in natural sorted order (the bit reversal is composed in here); ends
    (T, NBUCKETS). Returns the storage map's three segments, level 0
    (4, 20, T*N), chunk trees and top tree, and the v-major node indices
    (NBUCKETS*T, Kf)."""
    t_, n = perm.shape
    ch = chunk_for_lanes(n)
    g = chunk_geometry(ch)
    ncw = n // ch
    lvl0, ctree = cuda_msm.uptree(pts, perm.to(torch.int32).contiguous(), ch)
    roots = ctree.reshape(4, fe.NLIMBS, t_ * ncw, g.rows_out * LANE)[..., g.row_off[g.lc] * LANE]
    top = _tree_levels(roots.reshape(4, fe.NLIMBS, t_, ncw).contiguous())  # (4, 20, T, Wtop+1)
    node_idx = fused_node_indices_device(ends, n, ch)  # (NB, T, Kf)
    return (lvl0, ctree, top.reshape(4, fe.NLIMBS, -1),
            node_idx.reshape(NBUCKETS * t_, -1))


def _msm_total_fused(pts: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The fused schedule of _msm_total: the same group element, another
    evaluation order (arguments as _fused_stages)."""
    prefix = cuda_msm.fenwick_reduce(*_fused_stages(pts, perm, ends))
    s, p_last = cuda_msm.bucket_fold(prefix, perm.shape[0])
    return _fold_windows(_bucket_tail(s, p_last))


def _msm_check(pts: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor,
               fused: bool) -> torch.Tensor:
    if fused:
        return point_is_identity(_msm_total_fused(pts, perm, ends))
    node_idx = fenwick_nodes_device(ends, pts.shape[-1])
    return point_is_identity(_msm_total(pts, perm, node_idx))


def _rlc_core(pts_bytes: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor, fused: bool):
    """pts_bytes (32, N) uint8 [A block | R block]. Returns (packed bool
    (1+N,) [batch_ok, lane_ok...], decompressed points (4, 20, N) with
    invalid lanes as the identity)."""
    with record_function(DECOMPRESS):
        p, ok = decompress(pts_bytes)
        p = point_select(ok, p, identity(ok.shape, ok.device))
    with record_function(MSM):
        bok = _msm_check(p, perm, ends, fused)
    return torch.cat([bok.reshape(1), ok]), p


def _rlc_core_cached(a_pts: torch.Tensor, r_bytes: torch.Tensor, perm: torch.Tensor,
                     ends: torch.Tensor, fused: bool) -> torch.Tensor:
    """Cached-A variant: lanes = [A block (predecompressed) | R block].
    Returns packed bool (1+Nr,): [batch_ok, r_ok...]."""
    with record_function(DECOMPRESS):
        r, r_ok = decompress(r_bytes)
        r = point_select(r_ok, r, identity(r_ok.shape, r_ok.device))
    with record_function(MSM):
        bok = _msm_check(torch.cat([a_pts, r], dim=-1), perm, ends, fused)
    return torch.cat([bok.reshape(1), r_ok])


def sort_windows_device(digits: torch.Tensor):
    """The window sort on the device, sort_windows' twin: digits (N, NWIN)
    uint8 tensor (window w = byte w of the scalar) -> (perm (NWIN, N) int32,
    ends (NWIN, NBUCKETS) int32), by argsort and searchsorted. Not stable:
    bucket sums and Fenwick prefixes depend only on the set of lanes at each
    digit value, never on their order within a bucket."""
    d_t = digits.T.to(torch.int32).contiguous()  # (T, N)
    perm = torch.argsort(d_t, dim=1)
    sorted_d = torch.gather(d_t, 1, perm)
    vals = torch.arange(NBUCKETS, dtype=torch.int32, device=digits.device)
    ends = torch.searchsorted(sorted_d, vals.expand(d_t.shape[0], NBUCKETS).contiguous(),
                              right=True)
    return perm.to(torch.int32), ends.to(torch.int32)


def _rlc_core_cached_dsort(a_pts: torch.Tensor, r_bytes: torch.Tensor, digits: torch.Tensor,
                           fused: bool) -> torch.Tensor:
    """_rlc_core_cached with the window sort on the device: the host sends
    the scalars' digit rows (N, NWIN) uint8 and perm / ends are derived
    here (sort_windows_device)."""
    perm, ends = sort_windows_device(digits)
    return _rlc_core_cached(a_pts, r_bytes, perm, ends, fused)


def _rlc_core_cached_mixed(a_pts: torch.Tensor, ed_r_bytes: torch.Tensor,
                           sr_r_bytes: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor,
                           fused: bool) -> torch.Tensor:
    """Mixed-key cached-A variant: lanes = [A block (both key types,
    predecoded) | Ed25519 R (32, Ne) | sr25519 R (32, Ns)]; Ed25519 R lanes
    are decompressed as Edwards points, sr25519 R lanes decoded as
    ristretto255 points, invalid lanes of either selected to the identity.
    Returns packed bool (1+Ne+Ns,): [batch_ok, ed_r_ok..., sr_r_ok...]."""
    with record_function(DECOMPRESS):
        er, er_ok = decompress(ed_r_bytes)
        er = point_select(er_ok, er, identity(er_ok.shape, er_ok.device))
        sr, sr_ok = ristretto_decode(sr_r_bytes)
        sr = point_select(sr_ok, sr, identity(sr_ok.shape, sr_ok.device))
    with record_function(MSM):
        bok = _msm_check(torch.cat([a_pts, er, sr], dim=-1), perm, ends, fused)
    return torch.cat([bok.reshape(1), er_ok, sr_ok])


def _device_sort_enabled() -> bool:
    """TMTPU_DEVICE_SORT (read per call, default off as in the reference):
    the pure-Ed25519 cached-A flush sorts its windows on the device. The
    mixed flush always sorts on the host."""
    return os.environ.get("TMTPU_DEVICE_SORT", "0") != "0"


def _rlc_partial_core(pts_bytes: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor,
                      fused: bool):
    """One streamed-planner chunk: the MSM over this chunk's lanes without
    its identity check. Returns (partial point (4, 20), lane ok (N,))."""
    with record_function(DECOMPRESS):
        p, ok = decompress(pts_bytes)
        p = point_select(ok, p, identity(ok.shape, ok.device))
    with record_function(MSM):
        if fused:
            return _msm_total_fused(p, perm, ends), ok
        return _msm_total(p, perm, fenwick_nodes_device(ends, p.shape[-1])), ok


def _partial_fold_core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fold two (4, 20) partial points: one unified add."""
    with record_function(MSM):
        return cuda_fe.padd(a.contiguous(), b.contiguous())


def _partial_identity_core(a: torch.Tensor) -> torch.Tensor:
    """The streamed flush's combined-check verdict on the accumulated point."""
    with record_function(MSM):
        return point_is_identity(a)


def basepoint_coords() -> np.ndarray:
    """The ed25519 basepoint in extended limbs, (4, 20) int32."""
    from tendermint_tpu_torch.crypto.ed25519_ref import BASE

    return np.stack([fe.from_int(c) for c in BASE])


def decompress_rows(rows: np.ndarray, device=None):
    """rows (m, 32) uint8 -> (points (4, 20, m) int32 tensor, ok (m,) bool
    tensor) on `device`."""
    from tendermint_tpu_torch.device import resolve

    dev = resolve(device)
    b = torch.from_numpy(np.ascontiguousarray(rows.T)).to(dev)
    with record_function(DECOMPRESS):
        return decompress(b)


class _FlushThreadState(threading.local):
    def __init__(self):
        self.h2d_bytes = 0


_FLUSH_TLS = _FlushThreadState()


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`; its bytes count toward this thread's
    h2d_bytes (flush_counters)."""
    arr = np.ascontiguousarray(arr)
    _FLUSH_TLS.h2d_bytes += arr.nbytes
    return torch.from_numpy(arr).to(device)


def flush_counters() -> dict:
    """The submit path's device traffic so far, both counted per thread:
    "h2d_bytes", the bytes this thread's submits uploaded, and "dispatches",
    the kernel launches this thread made through the eight wrappers.
    crypto/batch.py records the deltas over a submit in its flush detail,
    so two threads flushing at once each count their own."""
    return {"h2d_bytes": _FLUSH_TLS.h2d_bytes, "dispatches": cuda_fe.THREAD_LAUNCHES.count}


def _upload(perm: np.ndarray, ends: np.ndarray, device):
    return _to_device(perm.astype(np.int32), device), _to_device(ends, device)


def rlc_check_submit(pts_bytes: np.ndarray, perm: np.ndarray, ends: np.ndarray, device):
    """Plain flush: pts_bytes (N, 32) [A block | R block]; perm/ends from
    sort_windows. Returns (packed bool (1+N,), decompressed points) on the
    device, unsynced."""
    b = _to_device(pts_bytes.T, device)
    return _rlc_core(b, *_upload(perm, ends, device), fused_for_lanes(pts_bytes.shape[0]))


def rlc_check_cached_submit(a_pts: torch.Tensor, r_bytes: np.ndarray, perm: np.ndarray,
                            ends: np.ndarray) -> torch.Tensor:
    """Cached-A flush: a_pts (4, 20, Na) on the device, r_bytes (Nr, 32).
    Returns packed bool (1+Nr,) on the device, unsynced."""
    dev = a_pts.device
    b = _to_device(r_bytes.T, dev)
    return _rlc_core_cached(a_pts, b, *_upload(perm, ends, dev),
                            fused_for_lanes(a_pts.shape[-1] + r_bytes.shape[0]))


def rlc_check_cached_dsort_submit(a_pts: torch.Tensor, r_bytes: np.ndarray,
                                  digits: np.ndarray) -> torch.Tensor:
    """Cached-A flush with the window sort on the device: digits (Na+Nr, 32)
    uint8, the scalars' bytes. Returns packed bool (1+Nr,) on the device,
    unsynced."""
    dev = a_pts.device
    b = _to_device(r_bytes.T, dev)
    d = _to_device(digits, dev)
    return _rlc_core_cached_dsort(a_pts, b, d, fused_for_lanes(a_pts.shape[-1] + r_bytes.shape[0]))


def rlc_check_cached_mixed_submit(a_pts: torch.Tensor, ed_r_bytes: np.ndarray,
                                  sr_r_bytes: np.ndarray, perm: np.ndarray,
                                  ends: np.ndarray) -> torch.Tensor:
    """Mixed Ed25519 + sr25519 cached-A flush: a_pts (4, 20, Na) on the
    device, ed_r_bytes (Ne, 32), sr_r_bytes (Ns, 32), perm / ends over the
    Na+Ne+Ns lanes. Returns packed bool (1+Ne+Ns,) on the device, unsynced."""
    dev = a_pts.device
    eb = _to_device(ed_r_bytes.T, dev)
    sb = _to_device(sr_r_bytes.T, dev)
    n = a_pts.shape[-1] + ed_r_bytes.shape[0] + sr_r_bytes.shape[0]
    return _rlc_core_cached_mixed(a_pts, eb, sb, *_upload(perm, ends, dev), fused_for_lanes(n))


def rlc_partial_submit(pts_bytes: np.ndarray, perm: np.ndarray, ends: np.ndarray, device):
    """One streamed chunk: pts_bytes (N, 32) [A block | R block]. Returns
    (partial point (4, 20), lane ok (N,)) on the device, unsynced."""
    b = _to_device(pts_bytes.T, device)
    return _rlc_partial_core(b, *_upload(perm, ends, device),
                             fused_for_lanes(pts_bytes.shape[0]))


def partial_fold_submit(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """Device-resident accumulation of streamed-chunk partials (no sync)."""
    return _partial_fold_core(acc, part)


def partial_identity_submit(acc: torch.Tensor) -> torch.Tensor:
    """The streamed flush's verdict as an unsynced device bool scalar."""
    return _partial_identity_core(acc)
