"""Batched Ed25519 points and the per-signature ladder in torch.

The counterpart of tendermint_tpu/ops/ed25519_jax.py. A point batch is one
int32 tensor `(4, 20, ...batch)` holding extended coordinates (x, y, z, t).
Field constants are small (20, 1, ...) tensors broadcast on the device (no
materialized per-shape context: that existed for the TPU compiler only).

Verification is COFACTORED with canonical encodings and s < L, as on every
path of the reference: accept iff [8]([s]B + [h](-A) - R) == identity.
`point_add` / `point_double` go through the padd / pdbl kernel wrappers
(ops/cuda_fe.py), which compute the same formulas; `add_niels` stays plain.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519_ref as _ref
from tendermint_tpu_torch.ops import cuda_fe
from tendermint_tpu_torch.ops import fe25519 as fe

NUM_DIGITS = 64  # signed radix-16 digits covering 256 bits
WINDOW = 8  # table holds j*P for j in 0..8; sign by negation


def Point(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack four (20, ...batch) coordinates into a (4, 20, ...batch) point."""
    return torch.stack([x, y, z, t])


def identity(batch_shape, device) -> torch.Tensor:
    p = torch.zeros((4, fe.NLIMBS, *batch_shape), dtype=torch.int32, device=device)
    p[1, 0] = 1
    p[2, 0] = 1
    return p


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified a=-1 extended addition (add-2008-hwcd-3)."""
    p, q = torch.broadcast_tensors(p, q)
    return cuda_fe.padd(p.contiguous(), q.contiguous())


def point_double(p: torch.Tensor, times: int = 1) -> torch.Tensor:
    """[2^times] p (dbl-2008-hwcd)."""
    return cuda_fe.pdbl(p.contiguous(), times)


def point_neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([fe.neg(p[0]), p[1], p[2], fe.neg(p[3])])


def point_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, cond shaped like the batch."""
    return torch.where(cond.reshape((1, 1) + cond.shape), a, b)


def decompress(s_bytes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8[32, ...batch] -> (point (4, 20, ...batch), ok bool[...batch]).
    RFC 8032 §5.1.3 with canonical-y enforcement."""
    dev = s_bytes.device
    nd = s_bytes.dim()
    sign = (s_bytes[31] >> 7).to(torch.int32)
    y = fe.from_bytes(s_bytes, mask_high_bit=True)
    canonical = fe.is_canonical_bytes(s_bytes)
    one = fe.const("one", dev, nd)
    yy = fe.square(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const("d", dev, nd)), one)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    t = fe.pow_p58(fe.mul(u, v7))
    x = fe.mul(fe.mul(u, v3), t)
    vxx = fe.mul(v, fe.square(x))
    ok_direct = fe.eq(vxx, u)
    ok_flipped = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok_direct, x, fe.mul(x, fe.const("sqrt_m1", dev, nd)))
    ok = canonical & (ok_direct | ok_flipped)
    x_frozen = fe.freeze(x)
    ok = ok & ~(fe.is_zero(x) & (sign == 1))
    flip = fe.bit(x_frozen, 0) != sign
    x = fe.select(flip, fe.neg(x), x)
    return Point(x, y, one.expand_as(y), fe.mul(x, y)), ok


def compress(p: torch.Tensor) -> torch.Tensor:
    """Point -> canonical encoding uint8[32, ...batch]."""
    zinv = fe.inv(p[2])
    x = fe.freeze(fe.mul(p[0], zinv))
    out = fe.to_bytes(fe.mul(p[1], zinv))
    out[31] |= (fe.bit(x, 0) << 7).to(torch.uint8)
    return out


def _basepoint_niels_table() -> np.ndarray:
    """j*B for j=0..8 in affine niels form (y+x, y-x, 2dxy), canonical limbs:
    (9, 3, 20) int32. Entry 0 is the identity (1, 1, 0)."""
    tab = np.zeros((WINDOW + 1, 3, fe.NLIMBS), dtype=np.int32)
    tab[0, 0] = fe.from_int(1)
    tab[0, 1] = fe.from_int(1)
    for j in range(1, WINDOW + 1):
        X, Y, Z, _T = _ref.point_mul(j, _ref.BASE)
        zinv = pow(Z, fe.P - 2, fe.P)
        x, y = X * zinv % fe.P, Y * zinv % fe.P
        tab[j, 0] = fe.from_int((y + x) % fe.P)
        tab[j, 1] = fe.from_int((y - x) % fe.P)
        tab[j, 2] = fe.from_int(2 * fe.D * x * y % fe.P)
    return tab


_B_NIELS_HOST = _basepoint_niels_table()
_B_NIELS: dict = {}


def _bniels(device) -> torch.Tensor:
    key = str(device)
    t = _B_NIELS.get(key)
    if t is None:
        t = torch.from_numpy(_B_NIELS_HOST).to(device)
        _B_NIELS[key] = t
    return t


def _select_b_niels(digit: torch.Tensor):
    """Signed select from the basepoint table; digit int32 [N] in [-8, 8]."""
    tab = _bniels(digit.device)  # (9, 3, 20)
    sel = tab[digit.abs().long()].permute(1, 2, 0)  # (3, 20, N)
    neg = digit < 0
    yplus = fe.select(neg, sel[1], sel[0])
    yminus = fe.select(neg, sel[0], sel[1])
    xy2d = fe.select(neg, fe.neg(sel[2]), sel[2])
    return yplus, yminus, xy2d


def add_niels(p: torch.Tensor, yplus, yminus, xy2d) -> torch.Tensor:
    """Mixed add of an affine niels point (Z2 = 1)."""
    a = fe.mul(fe.sub(p[1], p[0]), yminus)
    b = fe.mul(fe.add(p[1], p[0]), yplus)
    c = fe.mul(p[3], xy2d)
    d = fe.mul_small(p[2], 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def _select_point_table(table: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """Signed select from a per-lane table (9, 4, 20, N): |digit|*P, negated
    (x -> -x, t -> -t) where digit < 0."""
    idx = digit.abs().long()
    lanes = torch.arange(digit.shape[0], device=digit.device)
    p = table[idx, :, :, lanes].permute(1, 2, 0)  # (4, 20, N)
    neg = digit < 0
    return torch.stack(
        [fe.select(neg, fe.neg(p[0]), p[0]), p[1], p[2], fe.select(neg, fe.neg(p[3]), p[3])]
    )


def verify_prepared(
    a_bytes: torch.Tensor,  # (32, N) uint8
    r_bytes: torch.Tensor,  # (32, N) uint8
    s_digits: torch.Tensor,  # (64, N) int8 signed radix-16, LSB first
    h_digits: torch.Tensor,  # (64, N) int8
) -> torch.Tensor:
    """Batched cofactored check [8]([s]B + [h](-A) - R) == identity -> bool[N]
    (ed25519_jax._verify_core): a joint signed radix-16 ladder scanned
    MSB-first, 4 doublings + one basepoint niels add + one table add per
    digit pair."""
    n = a_bytes.shape[1]
    dev = a_bytes.device
    s_digits = s_digits.to(torch.int32)
    h_digits = h_digits.to(torch.int32)

    neg_a, ok_a = decompress(a_bytes)
    neg_a = point_neg(neg_a)
    r_pt, ok_r = decompress(r_bytes)
    r_pt = point_select(ok_r, r_pt, identity((n,), dev))

    entries = [identity((n,), dev), neg_a, point_double(neg_a)]
    for _ in range(3, WINDOW + 1):
        entries.append(point_add(entries[-1], neg_a))
    table = torch.stack(entries)  # (9, 4, 20, N)

    acc = identity((n,), dev)
    for i in range(NUM_DIGITS - 1, -1, -1):
        acc = point_double(acc, 4)
        acc = add_niels(acc, *_select_b_niels(s_digits[i]))
        acc = point_add(acc, _select_point_table(table, h_digits[i]))
    q = point_add(acc, point_neg(r_pt))
    q = point_double(q, 3)
    is_id = fe.is_zero(q[0]) & fe.eq(q[1], q[2]) & ~fe.is_zero(q[2])
    return ok_a & ok_r & is_id
