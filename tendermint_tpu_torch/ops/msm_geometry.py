"""Host-side geometry of the fused Pippenger schedule.

The port's own copy of the host half of tendermint_tpu/ops/pallas_msm.py
(`chunk_for_lanes`, `brev_np`, `brev_positions`, `ChunkGeometry` /
`chunk_geometry`, `fused_node_position`) plus a torch `brev` for the device
index math (the reference's `_brev16_jnp` / `brev_jnp`).

A fused MSM cuts each window's N sorted lanes into chunks of `ch` lanes (a
power of two). Within a chunk, sorted lane j sits at position rev(j), so every
tree level pairs contiguous halves: level l position q < ch >> l holds
level l-1's q + (q + ch >> l). Node k of level l then sits at in-level
position rev_{lc-l}(k). A chunk's levels 1..lc are stored as rows of 128
lanes: a level of width >= 128 takes width / 128 rows, a narrower one one row
with its nodes in lanes [0, width). Row counts pad to a multiple of 8.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

LANE = 128


def chunk_for_lanes(n_lanes: int):
    """Largest supported chunk that tiles n_lanes, or None (unfused MSM).
    2048 is preferred (a deeper chunk tree); 1024 covers the 1536-lane
    A-block bucket."""
    for ch in (2048, 1024):
        if n_lanes >= ch and n_lanes % ch == 0:
            return ch
    return None


def brev_np(x, m: int) -> np.ndarray:
    """rev_m(x): the low m bits of x reversed."""
    x = np.asarray(x).astype(np.int64)
    r = np.zeros_like(x)
    for b in range(m):
        r |= ((x >> b) & 1) << (m - 1 - b)
    return r


def brev(x: torch.Tensor, m) -> torch.Tensor:
    """rev_m(x) on an int32/int64 tensor for m <= 16 bits; m may be a
    tensor of bit counts broadcast against x."""
    x = x & 0xFFFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> (16 - m)


@functools.lru_cache(maxsize=32)
def brev_positions(n_lanes: int, ch: int) -> np.ndarray:
    """Within-window gather order: position p reads sorted lane
    (p & ~(ch-1)) | rev(p & (ch-1)), so each chunk's lanes land bit-reversed."""
    lc = ch.bit_length() - 1
    i = np.arange(n_lanes, dtype=np.int64)
    out = (i & ~(ch - 1)) | brev_np(i & (ch - 1), lc)
    return out.astype(np.int32)


class ChunkGeometry(NamedTuple):
    ch: int  # lanes per chunk (power of two)
    lc: int  # log2(ch): tree levels above level 0
    rows_in: int  # ch // 128
    rows_out: int  # stored rows per chunk (a multiple of 8)
    row_off: Tuple[int, ...]  # row_off[l] = first stored row of level l (l >= 1)


@functools.lru_cache(maxsize=8)
def chunk_geometry(ch: int) -> ChunkGeometry:
    lc = ch.bit_length() - 1
    assert ch == 1 << lc and ch >= 256
    offs = [0]  # index 0 unused: level 0 is the gathered input itself
    total = 0
    for lvl in range(1, lc + 1):
        offs.append(total)
        total += max((ch >> lvl) // LANE, 1)
    rows_out = -(-total // 8) * 8
    return ChunkGeometry(ch, lc, ch // LANE, rows_out, tuple(offs))


def fused_node_position(g: ChunkGeometry, lvl: int, k) -> np.ndarray:
    """Flat in-level position of chunk-tree node k at level lvl."""
    return brev_np(np.asarray(k), g.lc - lvl)


@functools.lru_cache(maxsize=8)
def tree_written_positions(ch: int) -> np.ndarray:
    """Chunk-local positions of the stored chunk tree that hold a node
    (row_off[l] * 128 + q for q < ch >> l). The rest of a chunk's
    rows_out * 128 positions is never indexed, and the uptree kernel leaves
    it unwritten."""
    g = chunk_geometry(ch)
    return np.concatenate([g.row_off[lvl] * LANE + np.arange(ch >> lvl)
                           for lvl in range(1, g.lc + 1)])
