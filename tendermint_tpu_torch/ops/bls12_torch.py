"""BLS12-381 G1 points and the bitmap aggregate-pubkey fold on torch tensors.

The counterpart of tendermint_tpu/ops/bls12_msm.py:43-344 and :367-394 (the
general MSM and its tails are not ported yet). A point batch is a tensor
(3, 33, n): homogeneous projective (X, Y, Z) in ops/fp381 Montgomery limbs;
the identity is (0 : 1 : 0). `padd` is the complete addition of Renes,
Costello and Batina (2015, algorithm 7, a = 0, b3 = 12) in the reference's
operation order, its 12 products in two stacked product calls (two B7
launches on the card), so the limbs equal the reference's numpy twin.

`fold_points` is the aggregate-pubkey sum of an aggregate commit: the
signers' keys, identity-padded to a power of two, folded by a halving tree
(lo = first half, hi = second half) as the reference's g1_aggregate_bitmap /
g1_aggregate_bitmap_device do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops.cuda_bls import fp381_mul

B3 = 12  # 3 * b, b = 4
NL = F.NLIMBS


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


def fold_points(xy: np.ndarray, device=None) -> Optional[Tuple[int, int]]:
    """Sum of k affine points given as (2, 33, k) Montgomery limbs: padded
    with the identity to m = 2^max(1, ceil(log2 k)) lanes, then log2 m
    halving levels of `padd` on `device`. Returns affine ints or None."""
    dev = resolve(device)
    k = xy.shape[-1]
    if k == 0:
        return None
    m = 1 << max(1, (max(k, 2) - 1).bit_length())
    pts = torch.cat([F.to_tensor(xy_to_points(xy), dev), identity(m - k, dev)], dim=-1)
    while pts.shape[-1] > 1:
        half = pts.shape[-1] // 2
        pts = padd(pts[..., :half], pts[..., half:])
    return point_to_affine_int(pts)
