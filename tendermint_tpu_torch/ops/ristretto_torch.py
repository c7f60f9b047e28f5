"""Batched ristretto255 decode in torch, for sr25519 keys and R values.

The counterpart of tendermint_tpu/ops/ristretto_jax.py, limb for limb: the
RFC 9496 section 4.3.1 decode of a batch of 32-byte encodings into the
extended (X, Y, Z = 1, T) layout of ops/ed25519_torch.decompress, so
ristretto lanes join Ed25519 lanes in one Pippenger MSM (ops/msm_torch.py
_rlc_core_cached_mixed):

    s      <- field element; fail if non-canonical or negative (odd)
    ss     = s^2; u1 = 1 - ss; u2 = 1 + ss
    v      = -(d*u1^2) - u2^2
    I      = invsqrt(v * u2^2)        (SQRT_RATIO_M1 with numerator 1)
    x      = |2*s * I*u2|;  y = u1 * I^2 * u2 * v;  t = x*y
    fail if not was_square, y == 0, or t negative

The ok mask ANDs four checks: the encoding is canonical, its top bit is
clear, s is even, and was_square & y != 0 & t even. The one square chain,
pow_p58, runs through fe25519._pow2k, so a decode launches the
fsquare_chain kernel six times on the card (its plain version on the CPU).
Ristretto's quotient-group equality is the RLC layer's business: every lane
coefficient is a multiple of 8, which removes the torsion component.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import fe25519 as fe
from tendermint_tpu_torch.ops.ed25519_torch import Point


def _sqrt_ratio_1v(v: torch.Tensor):
    """SQRT_RATIO_M1(1, v): (was_square, r) with r the non-negative
    sqrt(1/v) when v is square, sqrt(sqrt_m1/v) otherwise; r = 0 for v = 0."""
    dev, nd = v.device, v.dim()
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    r = fe.mul(v3, fe.pow_p58(v7))
    # fe.eq(check, c) for the three constants, with check frozen once: each
    # constant is canonical, so comparing limbs is the same test
    check = fe.freeze(fe.mul(v, fe.square(r)))

    def eq(value: int) -> torch.Tensor:
        return torch.all(check == fe.const(value, dev, nd), dim=0)

    correct = eq(1)
    flipped = eq(fe.P - 1)
    flipped_i = eq(fe.P - fe.SQRT_M1)
    r = fe.select(flipped | flipped_i, fe.mul(r, fe.const("sqrt_m1", dev, nd)), r)
    r = fe.freeze(r)  # the non-negative representative
    r = fe.select(fe.bit(r, 0) == 1, fe.neg(r), r)
    return correct | flipped, r


def ristretto_decode(s_bytes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8[32, ...batch] -> (point (4, 20, ...batch), ok bool[...batch]).
    Invalid lanes hold junk coordinates under ok = False (callers select
    the identity)."""
    dev, nd = s_bytes.device, s_bytes.dim()
    high_bit = (s_bytes[31] >> 7) & 1
    s = fe.from_bytes(s_bytes, mask_high_bit=True)
    # canonical (< p), top bit clear, and non-negative (even)
    ok = fe.is_canonical_bytes(s_bytes) & (high_bit == 0) & ((s_bytes[0] & 1) == 0)

    one = fe.const("one", dev, nd)
    ss = fe.square(s)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2_sqr = fe.square(u2)
    v = fe.sub(fe.neg(fe.mul(fe.const("d", dev, nd), fe.square(u1))), u2_sqr)
    was_square, invsqrt = _sqrt_ratio_1v(fe.mul(v, u2_sqr))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = fe.freeze(fe.mul(fe.mul_small(s, 2), den_x))
    x = fe.select(fe.bit(x, 0) == 1, fe.neg(x), x)  # CT_ABS
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    ok = ok & was_square & ~fe.is_zero(y) & (fe.bit(fe.freeze(t), 0) == 0)
    return Point(x, y, one.expand_as(y), t), ok


def decode_rows(rows: np.ndarray, device=None):
    """rows (m, 32) uint8 -> (points (4, 20, m) int32 tensor, ok (m,) bool
    tensor) on `device`: the batch padded to a power of two of at least 64
    lanes with odd (invalid) encodings, the result sliced back (the
    reference's decode_rows, which fills the A cache with sr25519 keys)."""
    from tendermint_tpu_torch.device import resolve

    m = rows.shape[0]
    pad = 1 << max(6, (m - 1).bit_length())
    buf = np.zeros((pad, 32), dtype=np.uint8)
    buf[:, 0] = 1  # odd: invalid, and sliced off below
    buf[:m] = rows
    b = torch.from_numpy(np.ascontiguousarray(buf.T)).to(resolve(device))
    p, ok = ristretto_decode(b)
    return p[..., :m], ok[:m]
