"""BLS12-381 base-field arithmetic on int32 torch tensors.

The counterpart of tendermint_tpu/ops/fp381.py, limb for limb: a field
element is 33 int32 limbs in uniform radix 2^12 (396 bits of capacity),
kept in the Montgomery domain (value * 2^396 mod p). A batch is a tensor
`(..., 33, n)`: the limb axis is the second to last, lanes last, and any
leading axes stack independent batches (the Fp2 components, the Fp12
coefficients, the products of one formula stage). Every op runs the
reference's exact carry schedule, so the limbs returned here equal the
reference's numpy ops on the same input (tests/test_torch_fp381.py).

Value discipline (the reference's; every op documents its part there):
carried limbs are <= 2^12; the product wants input values < 2^388 and
returns a carried value < 2p; `add` is the plain sum with one carry pass;
`sub` adds the graded complement COMP (+ CORR = -COMP mod p) and re-folds
the top limb through W384 = 2^384 mod p, as does `mul_small`. Every
intermediate stays a non-negative int32.

The Montgomery product (and the square, as a product of a value with
itself: the reference's symmetric square sums the same terms) is
ops/cuda_bls.fp381_mul: the CUDA kernel for a tensor on the card, its plain
torch version for one on the CPU. The host conversions (python ints <->
limbs) and the packed transfer layout (`pack` / `unpack`: 13 words of
radix 2^30) are numpy.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # G1/G2 order r

RADIX = 12
NLIMBS = 33
MASK = (1 << RADIX) - 1
NBITS = RADIX * NLIMBS  # 396
R_MONT = (1 << NBITS) % P
R_INV = pow(1 << NBITS, P - 2, P)
PPRIME = (-pow(P, -1, 1 << RADIX)) % (1 << RADIX)  # -p^-1 mod 2^12

PACK_RADIX = 30
PACK_WORDS = 13  # 13 * 30 = 390 bits >= 381


def _limbs_of(x: int) -> List[int]:
    return [(x >> (RADIX * i)) & MASK for i in range(NLIMBS)]


P_LIMBS = _limbs_of(P)
# The graded sub complement (limbs 0..31 hold 2^13, the top limb 16), its
# correction -COMP mod p, and 2^384 mod p for the top-limb fold.
COMP_LIMBS = [1 << (RADIX + 1)] * (NLIMBS - 1) + [16]
_COMP_VAL = sum(c << (RADIX * i) for i, c in enumerate(COMP_LIMBS))
CORR_LIMBS = _limbs_of(-_COMP_VAL % P)
W384_LIMBS = _limbs_of((1 << (RADIX * (NLIMBS - 1))) % P)
assert W384_LIMBS[-1] == 0  # p < 2^381: the fold's top limb is hi * 0


# ---------------------------------------------------------------------------
# Host conversions (python ints <-> limbs, Montgomery domain).


def from_int(x: int) -> np.ndarray:
    """python int -> canonical (non-Montgomery) limbs, shape (33,)."""
    return np.array(_limbs_of(x % P), dtype=np.int32)


def to_int(limbs) -> int:
    """limbs (33, ...) -> python int of lane 0 mod p (limbs need not be canonical)."""
    arr = _host(limbs).reshape(NLIMBS, -1)[:, 0]
    return sum(int(arr[i]) << (RADIX * i) for i in range(NLIMBS)) % P


def mont_from_int(x: int) -> np.ndarray:
    """python int -> Montgomery-domain limbs (x * R mod p), shape (33,)."""
    return from_int(x % P * R_MONT % P)


def mont_to_int(limbs) -> int:
    return to_int(limbs) * R_INV % P


def mont_from_ints(xs: Sequence[int]) -> np.ndarray:
    """ints -> (33, n) int32 Montgomery limb block: each x * R mod p as 50
    little-endian bytes, unpacked to bits and regrouped 12 a limb."""
    n = len(xs)
    if n == 0:
        return np.zeros((NLIMBS, 0), dtype=np.int32)
    blob = b"".join((x % P * R_MONT % P).to_bytes(50, "little") for x in xs)
    bits = np.unpackbits(np.frombuffer(blob, dtype=np.uint8).reshape(n, 50), axis=1,
                         bitorder="little")[:, :NBITS].reshape(n, NLIMBS, RADIX)
    return np.ascontiguousarray((bits.astype(np.int32) @ (1 << np.arange(RADIX, dtype=np.int32))).T)


def mont_to_ints(limbs) -> List[int]:
    """(33, n) Montgomery limbs (numpy or tensor) -> n python ints."""
    arr = _host(limbs).reshape(NLIMBS, -1)
    out = []
    for j in range(arr.shape[1]):
        v = sum(int(arr[i, j]) << (RADIX * i) for i in range(NLIMBS)) % P
        out.append(v * R_INV % P)
    return out


# ---------------------------------------------------------------------------
# Packed transfer layout: 13 int32 words of radix 2^30 (canonical values only).


def pack(values: Sequence[int]) -> np.ndarray:
    """canonical ints -> (13, n) int32 packed words (radix 2^30)."""
    out = np.zeros((PACK_WORDS, len(values)), dtype=np.int32)
    m = (1 << PACK_RADIX) - 1
    for j, v in enumerate(values):
        if not 0 <= v < P:
            raise ValueError("pack expects canonical field elements")
        for i in range(PACK_WORDS):
            out[i, j] = (v >> (PACK_RADIX * i)) & m
    return out


def unpack(words) -> List[int]:
    """(13, n) packed words -> n python ints."""
    arr = np.asarray(words, dtype=np.int64).reshape(PACK_WORDS, -1)
    return [sum(int(arr[i, j]) << (PACK_RADIX * i) for i in range(PACK_WORDS))
            for j in range(arr.shape[1])]


def _host(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    return np.asarray(limbs, dtype=np.int64)


# ---------------------------------------------------------------------------
# Torch ops on (..., 33, n) tensors.

_CONST_CACHE: dict = {}


def const(name: str, device) -> torch.Tensor:
    """A (33, 1) limb column on `device`: "p", "w384" (with -1 in the top
    limb, see fold_top), "comp_corr" (COMP + CORR, limb-wise), "one"
    (Montgomery 1)."""
    key = (name, str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        host = {
            "p": P_LIMBS,
            "w384": W384_LIMBS[:-1] + [W384_LIMBS[-1] - 1],
            "comp_corr": [k + c for k, c in zip(COMP_LIMBS, CORR_LIMBS)],
            "one": [int(v) for v in mont_from_int(1)],
        }[name]
        t = torch.tensor(host, dtype=torch.int32).reshape(NLIMBS, 1).to(device)
        _CONST_CACHE[key] = t
    return t


def carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes along the limb axis, no top wrap (the reference's
    carry_rows): limb i becomes (x_i & MASK) + (x_{i-1} >> 12); the carry out
    of limb 32 is dropped (impossible for in-discipline values)."""
    for _ in range(passes):
        c = x >> RADIX
        x = x & MASK
        x[..., 1:, :] += c[..., :-1, :]
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, 1)


def fold_top(a: torch.Tensor) -> torch.Tensor:
    """Fold limb 32 through W384 = 2^384 mod p: limb i += top * W384_i for
    i < 32, limb 32 = top * W384_32 (= 0); two carry passes. The constant's
    top entry is W384_32 - 1, so one multiply-add does both."""
    hi = a[..., NLIMBS - 1 :, :]
    return carry(a + hi * const("w384", a.device), 2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p: a + (COMP - b) + CORR, two carry passes, the top fold."""
    return fold_top(carry(a - b + const("comp_corr", a.device), 2))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for a small constant k (limbs * k < 2^31), two carry passes, the
    top fold."""
    return fold_top(carry(a * k, 2))


def to_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    """A host limb array (a copy: broadcast views are read-only) on `device`."""
    return torch.from_numpy(np.array(limbs, dtype=np.int32, order="C")).to(device)
