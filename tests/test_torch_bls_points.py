"""Port BLS12-381 G1 points and the bitmap aggregate-pubkey fold
(tendermint_tpu_torch/ops/bls12_torch.py) against the JAX package's numpy
twin (tendermint_tpu/ops/bls12_msm.py) and crypto/bls_ref.py.

Tolerance: zero. `padd` must equal bls12_msm.padd limb for limb, on random
lanes and on the doubling, inverse and identity lanes the complete formula
absorbs; the fold (`fold_points`, as verify_aggregate_commit calls it) must
give the same affine ints as g1_aggregate_bitmap, and the aggregate pubkey's
compressed encoding must equal bls_ref's.
"""

import random

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls_ref as JB
from tendermint_tpu.ops import bls12_msm as JM
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import bls_ref as B
from tendermint_tpu_torch.ops import bls12_torch as BT
from tendermint_tpu_torch.ops import cuda_bls

torch.set_num_threads(2)


def aff(pt):
    a = B._jac_to_affine(pt)
    return (a[0].v, a[1].v)


def g1_points(n, seed):
    r = random.Random(seed)
    pts = [B._jac_mul(B.G1_GEN, r.randrange(1, B.R)) for _ in range(n)]
    return pts, [aff(p) for p in pts]


def chain_points(n, seed):
    """n points s0 G, (s0 + 1) G, ...: one Jacobian add each."""
    pt = B._jac_mul(B.G1_GEN, random.Random(seed).randrange(1, B.R))
    out = []
    for _ in range(n):
        out.append(pt)
        pt = B._jac_add(pt, B.G1_GEN)
    return out


def fold(coords, bitmap):
    """The bitmap's keys summed as verify_aggregate_commit sums them."""
    sel = [c for c, b in zip(coords, bitmap) if b]
    return BT.fold_points(BT.affine_limbs(sel), device="cpu")


def test_padd_random_lanes_equal_reference():
    _, coords = g1_points(8, seed=2)
    p0, p1 = JM.points_from_affine_ints(coords[:4]), JM.points_from_affine_ints(coords[4:])
    want = np.stack(JM.padd(p0, p1))
    got = BT.padd(convert.bls_point_to_tensor(p0, "cpu"), convert.bls_point_to_tensor(p1, "cpu"))
    assert np.array_equal(got.numpy(), want)
    # and a second level on the outputs (carried, non-normalized inputs)
    s = JM.padd(tuple(c[:, :2] for c in JM.padd(p0, p1)), tuple(c[:, 2:] for c in JM.padd(p0, p1)))
    assert np.array_equal(BT.padd(got[..., :2], got[..., 2:]).numpy(), np.stack(s))


def test_padd_double_inverse_identity_lanes():
    pts, coords = g1_points(2, seed=3)
    neg0 = (coords[0][0], (-coords[0][1]) % B.P)
    a4 = JM.points_from_affine_ints([coords[0]] * 4)
    b4 = JM.points_from_affine_ints([coords[0], neg0, coords[1], coords[1]])
    b4 = tuple(np.where(np.arange(4)[None] == 3, i, c) for c, i in zip(b4, JM.identity((4,))))
    want = JM.padd(a4, b4)
    got = BT.padd(convert.bls_point_to_tensor(a4, "cpu"), convert.bls_point_to_tensor(b4, "cpu"))
    assert np.array_equal(got.numpy(), np.stack(want))
    assert BT.point_to_affine_int(got, 0) == aff(B._jac_double(pts[0]))
    assert BT.point_to_affine_int(got, 1) is None
    assert BT.point_to_affine_int(got, 2) == aff(B._jac_add(pts[0], pts[1]))
    assert BT.point_to_affine_int(got, 3) == coords[0]


def test_identity_and_conversions_equal_reference():
    assert np.array_equal(BT.identity(3, "cpu").numpy(), np.stack(JM.identity((3,))))
    _, coords = g1_points(5, seed=4)
    assert np.array_equal(BT.points_from_affine_ints(coords), np.stack(JM.points_from_affine_ints(coords)))
    pts = torch.from_numpy(BT.points_from_affine_ints(coords))
    for j in range(5):
        assert BT.point_to_affine_int(pts, j) == JM.point_to_affine_int(JM.points_from_affine_ints(coords), j)


@pytest.mark.parametrize("n, seed", [(29, 6), (1, 7), (2, 8), (33, 9)])
def test_fold_equals_reference_with_random_bitmap(n, seed):
    pts, coords = g1_points(n, seed)
    r = random.Random(seed)
    bm = [r.random() < 0.7 for _ in range(n)]
    bm[0] = True
    got = fold(coords, bm)
    assert got == JM.g1_aggregate_bitmap(coords, bm)
    acc = B.G1_IDENTITY
    for p, b in zip(pts, bm):
        if b:
            acc = B._jac_add(acc, p)
    assert got == aff(acc)
    assert fold(coords, [False] * n) is None


def test_fold_at_1000_points_equals_reference():
    pts = chain_points(1000, seed=10)
    coords = [aff(p) for p in pts]
    bm = [i % 7 != 3 for i in range(1000)]
    cuda_bls.reset_launches()
    got = fold(coords, bm)
    assert got == JM.g1_aggregate_bitmap(coords, bm)
    assert cuda_bls.LAUNCHES["fp381_mul"] == 0  # CPU tensors: the plain version


def test_apk_compressed_bytes_equal_bls_ref_aggregate():
    """The fold's apk, compressed, equals bls_ref.aggregate_pubkeys over the
    same encoded keys (both the port's copy and the JAX package's)."""
    pts, coords = g1_points(12, seed=11)
    pks = [B.g1_to_bytes(p) for p in pts]
    apk = fold(coords, [True] * 12)
    apk_bytes = B.g1_to_bytes((B._G1Field(apk[0]), B._G1Field(apk[1]), B._G1Field(1)))
    assert apk_bytes == B.g1_to_bytes(B.aggregate_pubkeys(pks))
    assert apk_bytes == JB.g1_to_bytes(JB.aggregate_pubkeys(pks))


def test_fold_of_no_points_is_none():
    """An empty signer set has no aggregate pubkey (the caller's "empty
    aggregate pubkey" rejection), whatever the block's lane count."""
    assert BT.fold_points(np.zeros((2, 33, 0), dtype=np.int32), device="cpu") is None
    assert JM.g1_aggregate_bitmap([], []) is None
