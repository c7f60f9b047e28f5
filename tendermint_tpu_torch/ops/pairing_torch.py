"""Fp2 / Fp12 tower arithmetic and the batched Miller loop on torch tensors.

The counterpart of tendermint_tpu/ops/pallas_bls.py:65-290, limb for limb.
An Fp2 batch is a tensor (..., 2, 33, n) (components c0, c1 of ops/fp381
limbs); an Fp12 batch is (6, 2, 33, n), the w-basis coefficients {1, w, ...,
w^5} with w^6 = XI = 1 + u; a G2 point is (3, 2, 33, n), homogeneous
projective (X, Y, Z); a sparse Miller line (c0, c3, c5) is (3, 2, 33, n).
The Fp2 ops and the Fp12 product fold are ops/tower.py's.

Every op replays the reference's exact sequence of fp381 adds, subs, folds
and products, so the limbs equal the reference's numpy forms. The products
of one formula stage are independent lanes, so each stage stacks them along
a leading axis and makes one fp381 product call: one B7 launch on the card
(ops/cuda_bls.fp381_mul) instead of one per product; the Miller step's
f * line product is kernel B8 (ops/cuda_bls.fp12_sparse_mul).

`miller_product(pairs, device)` is the Miller half of the reference's
bls_ref.pairings_are_one: the pairs with no identity point become lanes of
one `miller_loop_rows` call and the lanes are multiplied as bls_ref.Fp12
values; the caller's host final exponentiation decides. The Miller values
differ from bls_ref.miller_loop's by Fp2-subfield factors, which the final
exponentiation kills (their order divides p^2 - 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve
from tendermint_tpu_torch.ops import cuda_bls
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops import tower
from tendermint_tpu_torch.ops.cuda_bls import fp381_mul
from tendermint_tpu_torch.ops.tower import add2, mul2_by_xi, mul2_small, neg2, sub2

NL = F.NLIMBS

# XI^-1 = (1 + u)^-1 = (1 - u) / 2: components (1/2, -1/2).
_INV2 = pow(2, F.P - 2, F.P)
XI_INV_C0 = _INV2
XI_INV_C1 = (-_INV2) % F.P
X_PARAM_ABS = 0xD201000000010000


def _const2(c0: int, c1: int, n: int, device) -> torch.Tensor:
    """An Fp2 constant broadcast over n lanes: (2, 33, n)."""
    host = np.stack([F.mont_from_int(c0), F.mont_from_int(c1)])[:, :, None]
    return F.to_tensor(np.broadcast_to(host, (2, NL, n)), device)


# ---------------------------------------------------------------------------
# Fp2 products (kernel B7 on the card)


def mul2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba (ops/tower.mul2) over any batch of Fp2 pairs: one fp381
    product call of 3 products per pair."""
    return tower.mul2(a, b, fp381_mul)


def mul2_many(pairs) -> List[torch.Tensor]:
    """Independent mul2 products (each pair of any matching batch shape) in
    one product call."""
    flat_a, flat_b, shapes = [], [], []
    for a, b in pairs:
        a, b = torch.broadcast_tensors(a, b)
        shapes.append(a.shape)
        flat_a.append(a.reshape(-1, 2, NL, a.shape[-1]))
        flat_b.append(b.reshape(-1, 2, NL, b.shape[-1]))
    out = mul2(torch.cat(flat_a), torch.cat(flat_b))
    res, at = [], 0
    for s in shapes:
        k = int(np.prod(s[:-3], dtype=np.int64))
        res.append(out[at : at + k].reshape(s))
        at += k
    return res


def mul2_fp(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fp2 (..., 2, 33, n) times base-field rows (33, n): both components in
    one product call."""
    a, s = torch.broadcast_tensors(a, s)
    return fp381_mul(a.contiguous(), s.contiguous())


# ---------------------------------------------------------------------------
# Complete G2 addition (RCB15 alg. 7 over Fp2, b3 = 12 XI); two product calls.


def padd2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p, q: (3, 2, 33, n) (X, Y, Z); complete (any inputs, the identity)."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    s1 = torch.cat([p, add2(torch.stack([X1, Y1, X1]), torch.stack([Y1, Z1, Z1]))])
    s2 = torch.cat([q, add2(torch.stack([X2, Y2, X2]), torch.stack([Y2, Z2, Z2]))])
    t0, t1, t2, m3, m4, txz = mul2(s1, s2)
    t3, t4 = sub2(torch.stack([m3, m4]), add2(torch.stack([t0, t1]), torch.stack([t1, t2])))
    t0_3 = add2(add2(t0, t0), t0)
    # b3 = 12 XI: the * 12 before the XI twist, in all three places
    t2b, y3a, y3b = mul2_by_xi(mul2_small(torch.stack([t2, txz, add2(t0, t2)]), 12))
    z3 = add2(t1, t2b)
    t1s = sub2(t1, t2b)
    y3 = sub2(y3a, y3b)
    u = mul2(torch.stack([t3, t4, t1s, y3, z3, t0_3]),
             torch.stack([t1s, y3, z3, t0_3, t4, t3]))
    X3 = sub2(u[0], u[1])
    Y3, Z3 = add2(u[2:6:2], u[3:6:2])
    return torch.stack([X3, Y3, Z3])


# ---------------------------------------------------------------------------
# Fp12 (w-basis)


def mul12(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 6 x 6 w-basis product (36 Fp2 products, one product call)."""
    n = a.shape[-1]
    t = mul2(a[:, None].expand(6, 6, 2, NL, n), b[None, :].expand(6, 6, 2, NL, n))
    return tower.fold_terms(t.reshape(36, 2, NL, n), tower.MUL12_TERMS, "mul12")


def square12(a: torch.Tensor) -> torch.Tensor:
    return mul12(a, a)


def sparse_mul12(f: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """Kernel B8 on the card, its plain version on the CPU."""
    return cuda_bls.fp12_sparse_mul(f.contiguous(), line.contiguous())


def conj12(a: torch.Tensor) -> torch.Tensor:
    """x -> x^(p^6): negate the odd w-basis coefficients."""
    out = a.clone()
    out[1::2] = neg2(a[1::2])
    return out


def one12(n: int, device) -> torch.Tensor:
    out = torch.zeros((6, 2, NL, n), dtype=torch.int32, device=device)
    out[0] = _const2(1, 0, n, device)
    return out


# ---------------------------------------------------------------------------
# Miller-loop lines (division-free, sparse (c0, c3, c5); see pallas_bls.py)


def line_dbl(T: torch.Tensor, xP: torch.Tensor, yP: torch.Tensor,
             xi_inv: torch.Tensor) -> torch.Tensor:
    """c0 = 2 Y Z^2 yP, c3 = (3 X^3 - 2 Y^2 Z) XI^-1, c5 = -(3 X^2 Z xP) XI^-1;
    four product calls."""
    X, Y, Z = T[0], T[1], T[2]
    X2, Y2, Z2 = mul2(T, T)
    X2_3 = add2(add2(X2, X2), X2)
    YZ2, a, b, c = mul2_many([(Y, Z2), (X2_3, X), (add2(Y2, Y2), Z), (X2_3, Z)])
    c0, d = mul2_fp(torch.stack([add2(YZ2, YZ2), c]), torch.stack([yP, xP])[:, None])
    c3, c5 = mul2(torch.stack([sub2(a, b), neg2(d)]), xi_inv)
    return torch.stack([c0, c3, c5])


def line_add(T: torch.Tensor, Qx: torch.Tensor, Qy: torch.Tensor, xP: torch.Tensor,
             yP: torch.Tensor, xi_inv: torch.Tensor) -> torch.Tensor:
    """N = Y - yQ Z, D = X - xQ Z; c0 = D yP, c3 = (N xQ - D yQ) XI^-1,
    c5 = -(N xP) XI^-1; four product calls."""
    X, Y, Z = T[0], T[1], T[2]
    qz = mul2(torch.stack([Qy, Qx]), Z)
    N, D = sub2(torch.stack([Y, X]), qz)
    nq, dq = mul2(torch.stack([N, D]), torch.stack([Qx, Qy]))
    c0, e = mul2_fp(torch.stack([D, N]), torch.stack([yP, xP])[:, None])
    c3, c5 = mul2(torch.stack([sub2(nq, dq), neg2(e)]), xi_inv)
    return torch.stack([c0, c3, c5])


def miller_loop_rows(q_coords: Sequence[Tuple[int, int, int, int]],
                     p_coords: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Batched Miller loop over independent lanes (pallas_bls.miller_loop_rows).

    q_coords: affine G2 points (x_c0, x_c1, y_c0, y_c1) as ints; p_coords:
    affine G1 points (x, y). Returns the unreduced values (6, 2, 33, n),
    equal to bls_ref.miller_loop up to subfield factors."""
    dev = resolve(device)
    n = len(q_coords)
    if n != len(p_coords):
        raise ValueError("q/p length mismatch")
    q = F.to_tensor(np.stack([F.mont_from_ints([c[i] for c in q_coords]) for i in range(4)])
                    .reshape(2, 2, NL, n), dev)
    p = F.to_tensor(np.stack([F.mont_from_ints([c[i] for c in p_coords]) for i in range(2)]), dev)
    Qx, Qy = q[0], q[1]
    xP, yP = p[0], p[1]
    one2 = _const2(1, 0, n, dev)
    xi_inv = _const2(XI_INV_C0, XI_INV_C1, n, dev)
    Q1 = torch.stack([Qx, Qy, one2])
    T = Q1
    f = one12(n, dev)
    for bit in bin(X_PARAM_ABS)[3:]:
        f = sparse_mul12(square12(f), line_dbl(T, xP, yP, xi_inv))
        T = padd2(T, T)
        if bit == "1":
            f = sparse_mul12(f, line_add(T, Qx, Qy, xP, yP, xi_inv))
            T = padd2(T, Q1)
    # negative BLS parameter: conjugate (bls_ref.miller_loop does the same)
    return conj12(f)


def fp12_rows_to_ref(f: torch.Tensor, lane: int = 0):
    """One lane of (6, 2, 33, n) -> a bls_ref.Fp12."""
    from tendermint_tpu_torch.crypto import bls_ref as B

    host = f[..., lane : lane + 1].cpu().numpy()
    return B.Fp12.from_wcoeffs([B.Fp2(F.mont_to_int(host[m, 0]), F.mont_to_int(host[m, 1]))
                                for m in range(6)])


def miller_product(pairs, device=None):
    """The product of the pairs' Miller values as a bls_ref.Fp12: (G1, G2)
    Jacobian point pairs of crypto/bls_ref.py, one lane each in one
    miller_loop_rows call; a pair with an identity point contributes 1
    (bls_ref.miller_loop)."""
    from tendermint_tpu_torch.crypto import bls_ref as B

    p_coords, q_coords = [], []
    for p, q in pairs:
        if B._jac_is_identity(p) or B._jac_is_identity(q):
            continue
        pa, qa = B._jac_to_affine(p), B._jac_to_affine(q)
        p_coords.append((pa[0].v, pa[1].v))
        q_coords.append((qa[0].c0, qa[0].c1, qa[1].c0, qa[1].c1))
    f = B.FP12_ONE
    if p_coords:
        rows = miller_loop_rows(q_coords, p_coords, device)
        for lane in range(len(p_coords)):
            f = f * fp12_rows_to_ref(rows, lane)
    return f
