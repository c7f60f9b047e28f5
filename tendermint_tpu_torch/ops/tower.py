"""Fp2 ops and the Fp12 product fold, over any base-field product.

The layer below both ops/cuda_bls.py (whose plain version of kernel B8 is
`sparse_mul12_formula` over the plain fp381 product) and
ops/pairing_torch.py (the tower and the Miller loop over kernel B7). The
counterpart of tendermint_tpu/ops/pallas_bls.py:65-198, limb for limb. An
Fp2 batch is a tensor (..., 2, 33, n) (components c0, c1 of ops/fp381
limbs); an Fp12 batch is (6, 2, 33, n), the w-basis coefficients {1, w,
..., w^5} with w^6 = XI = 1 + u.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tendermint_tpu_torch.ops import fp381 as F

NL = F.NLIMBS


def add2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.add(a, b)


def sub2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.sub(a, b)


def mul2_small(a: torch.Tensor, k: int) -> torch.Tensor:
    return F.mul_small(a, k)


def neg2(a: torch.Tensor) -> torch.Tensor:
    return F.sub(torch.zeros_like(a), a)


def mul2_by_xi(a: torch.Tensor) -> torch.Tensor:
    """(c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u, c1 folded."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    return torch.stack([F.sub(a0, a1), F.fold_top(F.add(a0, a1))], dim=-3)


def mul2(a: torch.Tensor, b: torch.Tensor, mul) -> torch.Tensor:
    """Karatsuba over any batch of Fp2 pairs, one call of the base product
    `mul` with 3 products per pair: t0 = a0 b0, t1 = a1 b1,
    t2 = (a0 + a1)(b0 + b1); c0 = t0 - t1, c1 = t2 - (t0 + t1)."""
    a, b = torch.broadcast_tensors(a, b)
    ea = torch.cat([a, F.add(a[..., 0:1, :, :], a[..., 1:2, :, :])], dim=-3)
    eb = torch.cat([b, F.add(b[..., 0:1, :, :], b[..., 1:2, :, :])], dim=-3)
    t = mul(ea, eb)
    t0, t1, t2 = t[..., 0:1, :, :], t[..., 1:2, :, :], t[..., 2:3, :, :]
    return F.sub(torch.cat([t0, t2], dim=-3), torch.cat([t1, F.add(t0, t1)], dim=-3))


# ---------------------------------------------------------------------------
# Fp12 product fold (w-basis)

_IDX_CACHE: dict = {}


def _idx(key, rows, device) -> torch.Tensor:
    k = (key, str(device))
    t = _IDX_CACHE.get(k)
    if t is None:
        t = torch.tensor(rows, dtype=torch.long, device=device)
        _IDX_CACHE[k] = t
    return t


def fold_terms(t: torch.Tensor, terms: Sequence[Sequence[int]], key: str) -> torch.Tensor:
    """acc[k] = the products t[terms[k]] summed in the listed order, as the
    reference's `acc[k] = t if acc[k] is None else add2(acc[k], t)`; then
    out[k] = add2(acc[k], mul2_by_xi(acc[k + 6])) for k < 5, out[5] = acc[5]
    (w^6 = XI). Each round adds the next term of every k that has one."""
    dev = t.device
    acc = t[_idx((key, 0), [tk[0] for tk in terms], dev)]
    for r in range(1, max(len(tk) for tk in terms)):
        ks = [k for k, tk in enumerate(terms) if len(tk) > r]
        rows = _idx((key, r, "k"), ks, dev)
        acc[rows] = add2(acc[rows], t[_idx((key, r), [terms[k][r] for k in ks], dev)])
    return torch.cat([add2(acc[0:5], mul2_by_xi(acc[6:11])), acc[5:6]])


# mul12: products (i, j) at flat index 6 i + j; the terms of w^k in the
# reference's loop order (i outer, j inner).
MUL12_TERMS = [[6 * i + (k - i) for i in range(6) if 0 <= k - i < 6] for k in range(11)]
# sparse_mul12: products in the reference's loop order (line coefficient
# j in (0, 3, 5) outer, f index i inner) at flat index 6 l + i.
_SPARSE_J = (0, 3, 5)
SPARSE_TERMS = [[6 * l + (k - j) for l, j in enumerate(_SPARSE_J) if 0 <= k - j < 6]
                for k in range(11)]


def sparse_mul12_formula(f: torch.Tensor, line: torch.Tensor, mul) -> torch.Tensor:
    """f * (c0 + c3 w^3 + c5 w^5): 18 Fp2 products in one call of the base
    product `mul`; with ops/cuda_bls.fp381_mul_plain it is kernel B8's plain
    version."""
    n = f.shape[-1]
    t = mul2(f[None, :].expand(3, 6, 2, NL, n), line[:, None].expand(3, 6, 2, NL, n), mul)
    return fold_terms(t.reshape(18, 2, NL, n), SPARSE_TERMS, "sparse")
