"""CUDA kernels of the fused Pippenger MSM and their plain torch versions.

The counterpart of tendermint_tpu/ops/pallas_msm.py. Three hand-written
Hopper kernels (csrc/msm_kernels.cu, field arithmetic in csrc/fe25519.cuh;
bucket_fold's adds split over a warp by csrc/fe25519_warp.cuh):

- `uptree(pts, perm, ch)`   the level-0 gather into chunk-wise bit-reversed
                            order and every pair-tree level 1..lc of each
                            chunk, written once at the storage map's positions
- `fenwick_reduce(...)`     per (bucket, window): the sum of its Kf gathered
                            tree nodes, in order k = 0..Kf-1
- `bucket_fold(prefix, T)`  per window: sum_{v<255} P_v and P_255

Point batches are contiguous int32 `(4, 20, n)` tensors, which is the
reference's packed `(4, 20, n/128, 128)` layout reshaped. Each wrapper, for a
tensor on the CPU, returns its plain version (`*_plain`, the same pairing
over `cuda_fe.padd_plain`). For a CUDA tensor it checks dtype, shape and
contiguity, allocates the outputs, launches the kernel on the current stream,
raises if the launch failed, and adds one to `LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from tendermint_tpu_torch.ops import cuda_fe
from tendermint_tpu_torch.ops.ed25519_torch import identity
from tendermint_tpu_torch.ops.msm_geometry import LANE, brev_positions, chunk_geometry

NL = cuda_fe.NL
NBUCKETS = 256

LAUNCHES = {"uptree": 0, "fenwick_reduce": 0, "bucket_fold": 0}

SOURCES = ("fe25519.cuh", "fe25519_warp.cuh", "msm_kernels.cu")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.


def gather_level0(pts: torch.Tensor, perm: torch.Tensor, ch: int) -> torch.Tensor:
    """pts (4, 20, N); perm (T, N) natural sorted order -> level 0
    (4, 20, T * N): position p of each ch-lane chunk holds the chunk's
    sorted lane rev(p) (msm_geometry.brev_positions)."""
    t_, n = perm.shape
    pos = torch.from_numpy(brev_positions(n, ch)).to(device=perm.device, dtype=torch.int64)
    lanes = perm.to(torch.int64)[:, pos].reshape(-1)
    return pts.permute(2, 0, 1)[lanes].permute(1, 2, 0).contiguous()


def chunk_trees_plain(lvl0: torch.Tensor, ch: int) -> torch.Tensor:
    """lvl0 (4, 20, nchunks * ch) bit-reversed level-0 lanes -> (4, 20,
    nchunks * rows_out * 128): level l position q < ch >> l at chunk-local
    offset row_off[l] * 128 + q is level l-1's q + (q + ch >> l). Positions
    that hold no node are zero here (msm_geometry.tree_written_positions)."""
    g = chunk_geometry(ch)
    nchunks = lvl0.shape[-1] // ch
    out = torch.zeros((4, NL, nchunks, g.rows_out * LANE), dtype=torch.int32,
                      device=lvl0.device)
    cur = lvl0.reshape(4, NL, nchunks, ch)
    for lvl in range(1, g.lc + 1):
        width = ch >> lvl
        cur = cuda_fe.padd_plain(cur[..., :width], cur[..., width:])
        off = g.row_off[lvl] * LANE
        out[..., off : off + width] = cur
    return out.reshape(4, NL, nchunks * g.rows_out * LANE)


def uptree_plain(pts: torch.Tensor, perm: torch.Tensor, ch: int):
    """(level 0, chunk trees) of the fused MSM: gather_level0, then
    chunk_trees_plain."""
    lvl0 = gather_level0(pts, perm, ch)
    return lvl0, chunk_trees_plain(lvl0, ch)


def fenwick_reduce_plain(lvl0: torch.Tensor, ctree: torch.Tensor, top: torch.Tensor,
                         node_idx: torch.Tensor) -> torch.Tensor:
    """node_idx (m, Kf) global indices into [lvl0 | ctree | top] (each
    (4, 20, n_seg)) -> (4, 20, m): acc = node 0, acc += node k, k = 1..Kf-1."""
    table = torch.cat([lvl0, ctree, top], dim=-1)
    idx = node_idx.to(torch.int64)
    acc = table[..., idx[:, 0]]
    for k in range(1, idx.shape[1]):
        acc = cuda_fe.padd_plain(acc, table[..., idx[:, k]])
    return acc


def bucket_fold_plain(prefix: torch.Tensor, t_windows: int):
    """prefix (4, 20, 256 * T), v-major (lane v * T + t) -> (sum_{v<255} P_v,
    P_255), each (4, 20, T): bucket 255 masked to the identity, then bucket v
    paired with v + h for h = 128, 64, ..., 1."""
    x = prefix.reshape(4, NL, NBUCKETS, t_windows)
    p255 = x[:, :, NBUCKETS - 1].contiguous()
    x = torch.cat([x[:, :, : NBUCKETS - 1],
                   identity((1, t_windows), prefix.device)], dim=2)
    h = NBUCKETS // 2
    while h >= 1:
        x = cuda_fe.padd_plain(x[:, :, :h], x[:, :, h : 2 * h])
        h //= 2
    return x[:, :, 0].contiguous(), p255


# ---------------------------------------------------------------------------
# Build, bind and launch.


def _bind(lib) -> None:
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_uptree.argtypes = [vp, vp, i64, i64, ci, ci, vp, vp, vp, vp]
    lib.tm_fenwick_reduce.argtypes = [vp, i64, vp, i64, vp, i64, vp, ci, vp, i64, ci, vp]
    lib.tm_bucket_fold.argtypes = [vp, ci, vp, vp, vp, vp, vp]
    for fn in (lib.tm_uptree, lib.tm_fenwick_reduce, lib.tm_bucket_fold):
        fn.restype = ci


def build() -> ctypes.CDLL:
    """The MSM-kernel library (csrc/msm_kernels.cu)."""
    return cuda_fe.build_library("msm_kernels", SOURCES, _bind)


def _points(x: torch.Tensor, what: str) -> int:
    if x.dim() != 3:
        raise ValueError(f"{what}: expected (4, {NL}, n), got {tuple(x.shape)}")
    return cuda_fe._check(x, (4, NL), what)


def _same_device(dev, *xs) -> None:
    for x in xs:
        if x.device != dev:
            raise ValueError(f"tensor on {x.device}, expected {dev}")


def uptree(pts: torch.Tensor, perm: torch.Tensor, ch: int):
    """Point table (4, 20, N) and natural sorted permutation (T, N) int32 ->
    (level 0 (4, 20, T * N), chunk trees (4, 20, T * N / ch * rows_out * 128)).
    On the card one kernel gathers level 0 and builds every chunk tree;
    positions of the chunk trees that hold no node are left unwritten."""
    if pts.device.type == "cpu":
        return uptree_plain(pts, perm, ch)
    g = chunk_geometry(ch)
    n = _points(pts, "uptree pts")
    _same_device(pts.device, perm)
    if perm.dtype != torch.int32 or perm.dim() != 2 or not perm.is_contiguous():
        raise ValueError("uptree: perm must be a contiguous (T, N) int32 tensor")
    t_, n_p = perm.shape
    if n_p != n or ch not in (1024, 2048) or n % ch:
        raise ValueError(f"uptree: {n_p} sorted lanes of {n} points in chunks of {ch}")
    nchunks = t_ * n // ch
    rows = pts.permute(2, 0, 1).reshape(n, 4 * NL).contiguous()  # (N, 80): a point per row
    lvl0 = torch.empty((4, NL, t_ * n), dtype=torch.int32, device=pts.device)
    out = torch.empty((4, NL, nchunks * g.rows_out * LANE), dtype=torch.int32,
                      device=pts.device)
    # per chunk ch / 128 group arrival counts, then the work queue's head
    counters = torch.zeros(nchunks * (ch // 128) + 1, dtype=torch.int32, device=pts.device)
    if nchunks:
        with cuda_fe._on_card(pts):
            cuda_fe._launched("uptree", build().tm_uptree(
                rows.data_ptr(), perm.data_ptr(), n, t_, ch, g.rows_out, lvl0.data_ptr(),
                out.data_ptr(), counters.data_ptr(), cuda_fe._stream(pts)), LAUNCHES)
    return lvl0, out


def fenwick_reduce(lvl0: torch.Tensor, ctree: torch.Tensor, top: torch.Tensor,
                   node_idx: torch.Tensor) -> torch.Tensor:
    """Per output lane i: the sum of the Kf nodes node_idx[i] of the storage
    map [lvl0 | ctree | top], in order. node_idx (m, Kf) int32; the indices
    are trusted to lie in range (msm_torch.fused_node_indices_device)."""
    if lvl0.device.type == "cpu":
        return fenwick_reduce_plain(lvl0, ctree, top, node_idx)
    _same_device(lvl0.device, ctree, top, node_idx)
    n0 = _points(lvl0, "fenwick_reduce lvl0")
    n1 = _points(ctree, "fenwick_reduce ctree")
    n2 = _points(top, "fenwick_reduce top")
    if node_idx.dtype != torch.int32 or node_idx.dim() != 2 or not node_idx.is_contiguous():
        raise ValueError("fenwick_reduce: node_idx must be a contiguous (m, Kf) int32 tensor")
    m, kf = node_idx.shape
    if kf < 1 or m % NBUCKETS:
        raise ValueError(f"fenwick_reduce: {m} lanes of Kf = {kf}, expected {NBUCKETS} x T "
                         f"and Kf >= 1")
    out = torch.empty((4, NL, m), dtype=torch.int32, device=lvl0.device)
    # v-major rows v * T + t: a block of the kernel takes 32 buckets of one window
    t_windows = m // NBUCKETS
    if m:
        with cuda_fe._on_card(lvl0):
            cuda_fe._launched("fenwick_reduce", build().tm_fenwick_reduce(
                lvl0.data_ptr(), n0, ctree.data_ptr(), n1, top.data_ptr(), n2,
                node_idx.data_ptr(), kf, out.data_ptr(), m, t_windows, cuda_fe._stream(lvl0)),
                LAUNCHES)
    return out


def bucket_fold(prefix: torch.Tensor, t_windows: int):
    """v-major prefix points (4, 20, 256 * T) -> (sum_{v<255} P_v, P_255),
    each (4, 20, T)."""
    if prefix.device.type == "cpu":
        return bucket_fold_plain(prefix, t_windows)
    n = _points(prefix, "bucket_fold prefix")
    if t_windows < 1 or n != NBUCKETS * t_windows:
        raise ValueError(f"bucket_fold: {n} lanes, expected {NBUCKETS} x {t_windows}")
    s = torch.empty((4, NL, t_windows), dtype=torch.int32, device=prefix.device)
    p255 = torch.empty_like(s)
    # the nodes a window's blocks hand to each other (64 of level 2, 32 of
    # level 3) and the window's three arrival counters
    nodes = torch.empty((t_windows, 96, 4 * NL), dtype=torch.int32, device=prefix.device)
    arrived = torch.zeros(3 * t_windows, dtype=torch.int32, device=prefix.device)
    with cuda_fe._on_card(prefix):
        cuda_fe._launched("bucket_fold", build().tm_bucket_fold(
            prefix.data_ptr(), int(t_windows), nodes.data_ptr(), arrived.data_ptr(),
            s.data_ptr(), p255.data_ptr(), cuda_fe._stream(prefix)), LAUNCHES)
    return s, p255
