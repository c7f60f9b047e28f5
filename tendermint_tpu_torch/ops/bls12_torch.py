"""BLS12-381 G1 points, the bitmap aggregate-pubkey fold and the
general-base G1 MSM on torch tensors.

The counterpart of tendermint_tpu/ops/bls12_msm.py. A point batch is a
tensor (3, 33, n): homogeneous projective (X, Y, Z) in ops/fp381 Montgomery
limbs; the identity is (0 : 1 : 0). `padd` is the complete addition of
Renes, Costello and Batina (2015, algorithm 7, a = 0, b3 = 12) in the
reference's operation order, its 12 products in two stacked product calls
(two B7 launches on the card), so the limbs equal the reference's numpy
twin.

`fold_points` is the aggregate-pubkey sum of an aggregate commit (its
unsynced form `fold_points_submit` runs a shard at a time in
parallel/sharded.py): the signers' keys, identity-padded to a power of two,
folded by a halving tree (lo = first half, hi = second half) as the
reference's g1_aggregate_bitmap /
g1_aggregate_bitmap_device do.

`g1_msm` is the general-base MSM sum s_i P_i on the reference's schedule:
the Ed25519 engine's 8-bit x 32-window digits and native counting sort
(ops/msm_torch.scalars_to_bytes / sort_windows), then, a block of
WINDOW_GROUP windows at a time, each window's lanes gathered in sorted
order and reduced by `_segment_sums` (ceil(log2 n) distance-doubling
rounds of `padd`, partners identity-padded and tagged -1), the bucket sums
read at the segment heads (`g1_buckets`). Two tails turn the (32, 256)
buckets into the sum: the limb tail (`_weighted_window_sums`, 8 doubling
and 8 halving rounds over all windows at once, then `_combine_windows`, 8
doublings and an add a window), the reference's device tail and the card's
here; and the host tail (`_host_tail`, one batched inversion, then bls_ref
Jacobian arithmetic), the reference's numpy twin's and the CPU's here: the
device picks the tail, as the array backend does in the reference. Every
product is one B7 launch's (ops/cuda_bls.fp381_mul).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops.cuda_bls import fp381_mul
from tendermint_tpu_torch.ops.msm_torch import NBUCKETS, NWIN, scalars_to_bytes, sort_windows

B3 = 12  # 3 * b, b = 4
NL = F.NLIMBS
WINDOW_GROUP = 8  # windows per segmented-sum block (memory bound)


def identity(n: int, device) -> torch.Tensor:
    out = torch.zeros((3, NL, n), dtype=torch.int32, device=device)
    out[1] = F.const("one", device)
    return out


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition of two (3, 33, n) batches: P + Q, P + P, P + (-P)
    and either operand the identity, branch-free. b3 is applied to both sub
    operands of y3 before the subtraction (the fp381 bound discipline)."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    s1 = torch.cat([p, F.add(torch.stack([X1, Y1, X1]), torch.stack([Y1, Z1, Z1]))])
    s2 = torch.cat([q, F.add(torch.stack([X2, Y2, X2]), torch.stack([Y2, Z2, Z2]))])
    t0, t1, t2, m3, m4, txz = fp381_mul(s1, s2)
    t3, t4 = F.sub(torch.stack([m3, m4]), F.add(torch.stack([t0, t1]), torch.stack([t1, t2])))
    t0_3 = F.add(F.add(t0, t0), t0)
    t2b = F.mul_small(t2, B3)
    z3 = F.add(t1, t2b)
    t1s = F.sub(t1, t2b)
    y3 = F.sub(*F.mul_small(torch.stack([txz, F.add(t0, t2)]), B3))
    u = fp381_mul(torch.stack([t3, t4, t1s, y3, z3, t0_3]),
                  torch.stack([t1s, y3, z3, t0_3, t4, t3]))
    X3 = F.sub(u[0], u[1])
    Y3, Z3 = F.add(u[2:6:2], u[3:6:2])
    return torch.stack([X3, Y3, Z3])


def pselect(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b lane by lane, cond shaped like the lanes."""
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# host conversions


def affine_limbs(coords: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[(x, y), ...] affine ints -> (2, 33, n) Montgomery x, y limbs."""
    return np.stack([F.mont_from_ints([c[0] for c in coords]),
                     F.mont_from_ints([c[1] for c in coords])])


def points_from_affine_ints(coords: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[(x, y), ...] affine ints -> (3, 33, n) Montgomery point block (Z = 1)."""
    return xy_to_points(affine_limbs(coords))


def xy_to_points(xy: np.ndarray) -> np.ndarray:
    """(2, 33, n) Montgomery x, y limbs -> (3, 33, n) points with Z = 1."""
    one = np.broadcast_to(F.mont_from_int(1)[None, :, None], (1, NL, xy.shape[-1]))
    return np.concatenate([np.asarray(xy, dtype=np.int32), one])


def point_to_affine_int(pt: torch.Tensor, lane: int = 0) -> Optional[Tuple[int, int]]:
    """One lane of a (3, 33, n) batch -> affine (x, y) ints, or None for the
    identity (host python-int inversion)."""
    host = pt[..., lane : lane + 1].cpu().numpy()
    x, y, z = (F.mont_to_int(host[c]) for c in range(3))
    if z == 0:
        return None
    zinv = pow(z, F.P - 2, F.P)
    return (x * zinv % F.P, y * zinv % F.P)


# ---------------------------------------------------------------------------
# the bitmap fold


def fold_points_submit(xy: np.ndarray, device=None) -> Optional[torch.Tensor]:
    """Sum of k affine points given as (2, 33, k) Montgomery limbs: padded
    with the identity to m = 2^max(1, ceil(log2 k)) lanes, then log2 m
    halving levels of `padd` on `device`. Returns the (3, 33, 1) sum,
    unsynced, or None for k = 0."""
    dev = resolve(device)
    k = xy.shape[-1]
    if k == 0:
        return None
    m = 1 << max(1, (max(k, 2) - 1).bit_length())
    pts = torch.cat([F.to_tensor(xy_to_points(xy), dev), identity(m - k, dev)], dim=-1)
    while pts.shape[-1] > 1:
        half = pts.shape[-1] // 2
        pts = padd(pts[..., :half], pts[..., half:])
    return pts


def fold_points(xy: np.ndarray, device=None) -> Optional[Tuple[int, int]]:
    """fold_points_submit's sum as affine ints, or None."""
    pts = fold_points_submit(xy, device)
    return None if pts is None else point_to_affine_int(pts)


# ---------------------------------------------------------------------------
# The general-base MSM


def _gather(pt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return pt.index_select(-1, idx)


def _segment_sums(pt: torch.Tensor, seg: torch.Tensor, n_rounds: int) -> torch.Tensor:
    """Rows sorted by segment id; after ceil(log2(max segment length))
    distance-doubling rounds the row at each segment head holds the segment
    sum. Identity-padded partners carry segment id -1 (never equal)."""
    m = seg.shape[0]
    step = 1
    for _ in range(n_rounds):
        if step >= m:
            break
        part = torch.cat([pt[..., step:], identity(step, pt.device)], dim=-1)
        pseg = torch.cat([seg[step:], seg.new_full((step,), -1)])
        pt = pselect(seg == pseg, padd(pt, part), pt)
        step *= 2
    return pt


def g1_buckets(coords: Sequence[Tuple[int, int]], scalars: Sequence[int],
               device=None) -> torch.Tensor:
    """The bucket sums of sum scalar_i P_i: (3, 33, NWIN * NBUCKETS) points,
    window-major, bucket d of window t at lane t * 256 + d (the identity
    where no lane has digit d). coords: affine (x, y) ints of subgroup
    points; scalars: ints, taken mod r; len(coords) == len(scalars) > 0."""
    dev = resolve(device)
    n = len(coords)
    digits = scalars_to_bytes([s % F.R_ORDER for s in scalars], n)
    perm, ends = sort_windows(digits)
    perm = perm.astype(np.int64)
    pts = F.to_tensor(points_from_affine_ints(coords), dev)
    n_rounds = max(1, (max(n, 2) - 1).bit_length())  # ceil(log2 n)
    blocks = []
    for g0 in range(0, NWIN, WINDOW_GROUP):
        g1 = min(g0 + WINDOW_GROUP, NWIN)
        gw = g1 - g0
        # each window's sorted lanes; segment id = window * 256 + digit
        idx = perm[g0:g1].reshape(-1)
        segs = np.concatenate([(t - g0) * NBUCKETS + digits[perm[t], t].astype(np.int64)
                               for t in range(g0, g1)])
        rows = _segment_sums(_gather(pts, torch.from_numpy(idx).to(dev)),
                             torch.from_numpy(segs).to(dev), n_rounds)
        # bucket heads: segment starts from the sorted-ends table; an empty
        # bucket's start may equal the row count, so it is clamped for the
        # gather and masked to the identity
        e = ends[g0:g1].astype(np.int64)
        starts = np.concatenate([np.zeros((gw, 1), dtype=np.int64), e[:, :-1]], axis=1)
        heads = np.minimum(np.arange(gw, dtype=np.int64)[:, None] * n + starts, gw * n - 1)
        nonempty = torch.from_numpy((e - starts > 0).reshape(-1)).to(dev)
        blocks.append(pselect(nonempty, _gather(rows, torch.from_numpy(heads.reshape(-1)).to(dev)),
                              identity(gw * NBUCKETS, dev)))
    return torch.cat(blocks, dim=-1)


def _weighted_window_sums(buckets: torch.Tensor) -> torch.Tensor:
    """buckets (3, 33, T * 256) -> the T window sums sum_d d B[d], (3, 33, T),
    by the suffix-sum identity sum_d d B[d] = sum_{j>=1} S_j, S_j = sum_{d>=j}
    B[d], in log depth: 8 distance-doubling rounds build every suffix sum,
    then S_0 (weight 0) is dropped, one identity padded, and 8 halving
    rounds reduce S_1..S_255. Every round is one padd over all windows."""
    t = buckets.shape[-1] // NBUCKETS
    s = buckets.reshape(3, NL, t, NBUCKETS)
    step = 1
    while step < NBUCKETS:
        part = torch.cat([s[..., step:], identity(t * step, s.device).reshape(3, NL, t, step)],
                         dim=-1)
        s = padd(s.reshape(3, NL, -1), part.reshape(3, NL, -1)).reshape(3, NL, t, NBUCKETS)
        step *= 2
    s = torch.cat([s[..., 1:], identity(t, s.device).reshape(3, NL, t, 1)], dim=-1)
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = padd(s[..., :half].reshape(3, NL, -1),
                 s[..., half:].reshape(3, NL, -1)).reshape(3, NL, t, half)
    return s[..., 0]


def _combine_windows(w_sums: torch.Tensor) -> torch.Tensor:
    """Horner over the 8-bit windows: acc = 2^8 acc + W[t], t = T-1 .. 0;
    each doubling is padd(acc, acc). Returns a (3, 33, 1) point."""
    t = w_sums.shape[-1]
    acc = w_sums[..., t - 1 : t]
    for wi in range(t - 2, -1, -1):
        for _ in range(8):
            acc = padd(acc, acc)
        acc = padd(acc, w_sums[..., wi : wi + 1])
    return acc


def _host_tail(buckets: torch.Tensor) -> Optional[Tuple[int, int]]:
    """The weighted-bucket and window-combine tail as host ints: one batched
    inversion (Montgomery's trick) takes every nonzero-Z bucket to affine,
    then bls_ref Jacobian arithmetic sums the running suffixes and combines
    the windows. Returns affine ints or None for the identity."""
    from tendermint_tpu_torch.crypto import bls_ref as B

    host = buckets.cpu().numpy()
    t = host.shape[-1] // NBUCKETS
    xs, ys, zs = (F.mont_to_ints(host[c]) for c in range(3))
    nz = [i for i, z in enumerate(zs) if z != 0]
    prefix = [1]
    for i in nz:
        prefix.append(prefix[-1] * zs[i] % F.P)
    inv_all = pow(prefix[-1], F.P - 2, F.P)
    zinv = {}
    for k in range(len(nz) - 1, -1, -1):
        i = nz[k]
        zinv[i] = inv_all * prefix[k] % F.P
        inv_all = inv_all * zs[i] % F.P
    total = B.G1_IDENTITY
    for wi in range(t - 1, -1, -1):
        if wi != t - 1:
            for _ in range(8):
                total = B._jac_double(total)
        running = B.G1_IDENTITY
        wsum = B.G1_IDENTITY
        for d in range(NBUCKETS - 1, 0, -1):
            j = wi * NBUCKETS + d
            if zs[j] != 0:
                zi = zinv[j]
                running = B._jac_add(running, (B._G1Field(xs[j] * zi % F.P),
                                               B._G1Field(ys[j] * zi % F.P), B._G1Field(1)))
            wsum = B._jac_add(wsum, running)
        total = B._jac_add(total, wsum)
    aff = B._jac_to_affine(total)
    return None if aff is None else (aff[0].v, aff[1].v)


def g1_msm(coords: Sequence[Tuple[int, int]], scalars: Sequence[int],
           device=None) -> Optional[Tuple[int, int]]:
    """General-base MSM: sum scalar_i P_i -> affine ints (None = identity).

    coords: affine (x, y) ints (subgroup-checked by the caller: keys are
    validated at ingestion); scalars: ints, taken mod r. The buckets are
    summed on `device` and combined by the limb tail on a card, by the host
    tail on the CPU, as the reference takes its device tail under jax and
    its host tail under numpy. An empty set returns None; a length mismatch
    raises ValueError."""
    n = len(coords)
    if n == 0:
        return None
    if n != len(scalars):
        raise ValueError("coords/scalars length mismatch")
    dev = resolve(device)
    buckets = g1_buckets(coords, scalars, dev)
    if dev.type != "cuda":
        return _host_tail(buckets)
    return point_to_affine_int(_combine_windows(_weighted_window_sums(buckets)))
