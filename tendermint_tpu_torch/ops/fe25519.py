"""GF(2^255-19) field arithmetic on int32 torch tensors.

The counterpart of tendermint_tpu/ops/fe25519.py, limb for limb: a field
element is `int32[20, ...batch]` in uniform radix 2^13 (limb i holds bits
[13i, 13i+13)), the wrap factor at limb 20 is 2^260 mod p = 608, and every op
runs the reference's exact carry schedule, so the limbs this module returns
are bit-identical to the JAX ops on the same input (tests/test_torch_fe25519.py).

All public ops return "carried" limbs: limb_i <= 2^13 (limb0 <= 2^13 + 607).
`freeze` gives the canonical representative. Products of carried limbs summed
over 20 rows stay below 2^31, so every intermediate is a non-negative int32.

`mul` is two large tensor ops: the (20, 20, ...) outer product and one
index_add_ of its rows onto the 39 diagonals. Long square chains (k >= 10 in
`_pow2k`) go to ops/cuda_fe.fsquare_chain, which launches the CUDA kernel for
a tensor on the card and runs `square` k times for one on the CPU. The
kernel squares in 8 x 32-bit words (csrc/fe25519_w32.cuh): 89 multiply
instructions and 131 SASS instructions a squaring (tools/fe_probe.py),
against this module's 210 limb products and 572 instructions. It returns
the same field element in canonical limbs, a carried form that `freeze`,
`eq` and `is_zero` read alike.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2**255 - 19
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

NLIMBS = 20
RADIX = 13
WRAP = (1 << (NLIMBS * RADIX)) % P  # 2^260 mod p = 608
assert WRAP == 608
MASK = (1 << RADIX) - 1


def from_int(x: int) -> np.ndarray:
    """Host-side: python int -> canonical limbs, shape (20,) int32."""
    x %= P
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMBS)], dtype=np.int32)


def to_int(limbs) -> int:
    """Host-side: limbs (20,) -> python int mod p (limbs need not be canonical)."""
    arr = np.asarray(limbs.cpu() if isinstance(limbs, torch.Tensor) else limbs).astype(np.int64)
    return sum(int(arr[i]) << (RADIX * i) for i in range(arr.shape[0])) % P


# Subtraction by limb-wise complement (see the reference module): a - b ==
# a + (COMP - b) + CORR (mod p), with COMP dominating every carried limb.
_COMP = np.array([(1 << RADIX) + 608] + [1 << RADIX] * (NLIMBS - 1), dtype=np.int32)
_COMP_VAL = sum(int(_COMP[i]) << (RADIX * i) for i in range(NLIMBS))
_CORR = from_int(-_COMP_VAL % P)

_CONST_CACHE: dict = {}


def const(name_or_value, device, ndim: int = 2) -> torch.Tensor:
    """A (20,) constant as a (20, 1, ..., 1) tensor on `device`, broadcast
    against rank-`ndim` operands. Names: "comp", "corr", "one", "d", "d2",
    "sqrt_m1"; an int is taken as a field value."""
    key = (name_or_value, str(device), ndim)
    t = _CONST_CACHE.get(key)
    if t is None:
        host = {
            "comp": _COMP,
            "corr": _CORR,
            "one": from_int(1),
            "d": from_int(D),
            "d2": from_int(D2),
            "sqrt_m1": from_int(SQRT_M1),
        }.get(name_or_value) if isinstance(name_or_value, str) else from_int(name_or_value)
        t = torch.from_numpy(host.copy()).to(device).reshape((NLIMBS,) + (1,) * (ndim - 1))
        _CONST_CACHE[key] = t
    return t


def carry(x: torch.Tensor) -> torch.Tensor:
    """Four parallel carry passes + the 2^260 wrap (fe25519.carry)."""
    for _ in range(4):
        c = x >> RADIX
        x = (x & MASK) + torch.cat([c[NLIMBS - 1 :] * WRAP, c[: NLIMBS - 1]], dim=0)
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p). Inputs carried."""
    nd = max(a.dim(), b.dim())
    return carry(a + (const("comp", a.device, nd) - b) + const("corr", a.device, nd))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


_DIAG_CACHE: dict = {}


def _diag_index(device) -> torch.Tensor:
    key = str(device)
    t = _DIAG_CACHE.get(key)
    if t is None:
        i = torch.arange(NLIMBS)
        t = (i[:, None] + i[None, :]).reshape(-1).to(device)
        _DIAG_CACHE[key] = t
    return t


def _reduce39(acc: torch.Tensor) -> torch.Tensor:
    """fe25519.mul's reduction of the 39-row product: two parallel carry
    passes (the top carry folds onto row 19 with 608), fold rows >= 20 down
    with 608, then carry."""
    n = 2 * NLIMBS - 1
    for _ in range(2):
        c = acc >> RADIX
        acc = (acc & MASK) + torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)
        acc[NLIMBS - 1] += WRAP * c[n - 1]
    out = acc[:NLIMBS].clone()
    out[: NLIMBS - 1] += WRAP * acc[NLIMBS:]
    return carry(out)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply. Inputs carried; output carried."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(NLIMBS * NLIMBS, -1)
    acc = torch.zeros((2 * NLIMBS - 1, prod.shape[1]), dtype=torch.int32, device=a.device)
    acc.index_add_(0, _diag_index(a.device), prod)
    return _reduce39(acc.reshape((2 * NLIMBS - 1,) + batch))


def square(a: torch.Tensor) -> torch.Tensor:
    """Field square. The reference's symmetric convolution sums the same
    integers as mul(a, a) row for row, so the result is bit-identical."""
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    assert 0 < k < (1 << 17)
    return carry(a * k)


def _carry_pass(limbs):
    """One sequential carry pass -> (in-range limbs, final carry)."""
    out = []
    c = torch.zeros_like(limbs[0])
    for x in limbs:
        x = x + c
        c = x >> RADIX
        out.append(x & MASK)
    return out, c


def _fold255(limbs):
    hi = limbs[NLIMBS - 1] >> 8
    limbs = list(limbs)
    limbs[NLIMBS - 1] = limbs[NLIMBS - 1] & 0xFF
    limbs[0] = limbs[0] + 19 * hi
    return limbs


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p). Input carried."""
    limbs = list(a.unbind(0))
    limbs, c = _carry_pass(limbs)
    limbs[0] = limbs[0] + WRAP * c
    limbs, c = _carry_pass(limbs)
    limbs = _fold255(limbs)
    limbs, _ = _carry_pass(limbs)
    limbs = _fold255(limbs)
    limbs, _ = _carry_pass(limbs)
    ylimbs = list(limbs)
    ylimbs[0] = ylimbs[0] + 19
    ylimbs, _ = _carry_pass(ylimbs)
    yhi = ylimbs[NLIMBS - 1] >> 8
    ylimbs[NLIMBS - 1] = ylimbs[NLIMBS - 1] & 0xFF
    return torch.where(yhi.unsqueeze(0) > 0, torch.stack(ylimbs), torch.stack(limbs))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == freeze(b), dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b with cond shaped like the batch."""
    return torch.where(cond.unsqueeze(0), a, b)


def bit(a: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i of the canonical value. Input frozen."""
    return (a[i // RADIX] >> (i % RADIX)) & 1


def from_bytes(b: torch.Tensor, mask_high_bit: bool = True) -> torch.Tensor:
    """Little-endian bytes uint8[32, ...batch] -> carried limbs (not reduced).
    mask_high_bit drops bit 255 (the ed25519 sign bit)."""
    b = b.to(torch.int32)
    if mask_high_bit:
        b = torch.cat([b[:31], (b[31] & 0x7F).unsqueeze(0)], dim=0)
    limbs = []
    for i in range(NLIMBS):
        lo_bit = RADIX * i
        acc = None
        for byte_i in range(lo_bit // 8, min((lo_bit + RADIX + 7) // 8, 32)):
            shift = byte_i * 8 - lo_bit
            v = b[byte_i]
            piece = (v << shift) if shift >= 0 else (v >> -shift)
            acc = piece if acc is None else acc + piece
        limbs.append(acc & MASK)
    out = torch.stack(limbs)
    if not mask_high_bit:
        hi = (b[31] >> 7) & 1
        out[NLIMBS - 1] = out[NLIMBS - 1] & 0xFF
        out[0] = out[0] + 19 * hi
    return carry(out)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian encoding uint8[32, ...batch]."""
    f = freeze(a)
    out = []
    for byte_i in range(32):
        lo_bit = byte_i * 8
        acc = None
        for limb_i in range(lo_bit // RADIX, min((lo_bit + 8 + RADIX - 1) // RADIX, NLIMBS)):
            shift = limb_i * RADIX - lo_bit
            v = f[limb_i]
            piece = (v << shift) if shift >= 0 else (v >> -shift)
            acc = piece if acc is None else acc + piece
        out.append(acc & 0xFF)
    return torch.stack(out).to(torch.uint8)


def is_canonical_bytes(b: torch.Tensor) -> torch.Tensor:
    """True iff the 255-bit value encoded (sign bit ignored) is < p."""
    v = from_bytes(b, mask_high_bit=True)
    limbs = list(v.unbind(0))
    limbs[0] = limbs[0] + 19
    limbs, _ = _carry_pass(limbs)
    return (limbs[NLIMBS - 1] >> 8) == 0


_POW2K_KERNEL_MIN = 10


def _pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(2^k). Runs of k >= 10 go to the fsquare_chain kernel wrapper (one
    launch with k as a run-time count); short runs stay plain."""
    if k >= _POW2K_KERNEL_MIN:
        from tendermint_tpu_torch.ops import cuda_fe

        return cuda_fe.fsquare_chain(a, k)
    for _ in range(k):
        a = square(a)
    return a


def _z250(a: torch.Tensor):
    """Shared ladder: (x^(2^250 - 1), x^11, x^9). Classic 25519 chain."""
    z2 = square(a)
    z8 = _pow2k(z2, 2)
    z9 = mul(a, z8)
    z11 = mul(z2, z9)
    z22 = square(z11)
    z_5_0 = mul(z9, z22)
    z_10_5 = _pow2k(z_5_0, 5)
    z_10_0 = mul(z_10_5, z_5_0)
    z_20_10 = _pow2k(z_10_0, 10)
    z_20_0 = mul(z_20_10, z_10_0)
    z_40_20 = _pow2k(z_20_0, 20)
    z_40_0 = mul(z_40_20, z_20_0)
    z_50_40 = _pow2k(z_40_0, 10)
    z_50_0 = mul(z_50_40, z_10_0)
    z_100_50 = _pow2k(z_50_0, 50)
    z_100_0 = mul(z_100_50, z_50_0)
    z_200_100 = _pow2k(z_100_0, 100)
    z_200_0 = mul(z_200_100, z_100_0)
    z_250_200 = _pow2k(z_200_0, 50)
    z_250_0 = mul(z_250_200, z_50_0)
    return z_250_0, z11, z9


def inv(a: torch.Tensor) -> torch.Tensor:
    """x^(p-2). inv(0) = 0."""
    z_250_0, z11, _ = _z250(a)
    return mul(_pow2k(z_250_0, 5), z11)


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3)."""
    z_250_0, _, _ = _z250(a)
    return mul(_pow2k(z_250_0, 2), a)
