"""The port's general-base G1 MSM (ops/bls12_torch.g1_msm) and fp381's packed
layout against the JAX package's numpy twins (ops/bls12_msm.g1_msm,
ops/fp381.pack / unpack) and crypto/bls_ref's Jacobian sums, on the CPU
(the B7 kernel's plain version). Inputs: subgroup points and scalars below
r made from numpy seeds. Tolerance: zero on limbs (the buckets and the limb
tail's window sums), on affine ints and on packed words.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls_ref as B
from tendermint_tpu.ops import bls12_msm as M
from tendermint_tpu.ops import fp381 as JF
from tendermint_tpu_torch.ops import bls12_torch as T
from tendermint_tpu_torch.ops import fp381 as TF


def aff(pt):
    a = B._jac_to_affine(pt)
    return None if a is None else (a[0].v, a[1].v)


def rand_scalars(n, seed, bound=B.R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]


def g1_points(n, seed):
    pts = [B._jac_mul(B.G1_GEN, k) for k in rand_scalars(n, seed + 1000)]
    return pts, [aff(p) for p in pts]


def host_sum(pts, scalars):
    acc = B.G1_IDENTITY
    for p, s in zip(pts, scalars):
        acc = B._jac_add(acc, B._jac_mul(p, s % B.R))
    return aff(acc)


def reference_buckets(coords, scalars):
    """The reference g1_msm's buckets (captured at its host tail) as one
    (3, 33, 32 * 256) array, and its result."""
    captured = {}
    orig = M._host_tail

    def capture(buckets):
        captured["b"] = buckets
        return orig(buckets)

    M._host_tail = capture
    try:
        got = M.g1_msm(coords, scalars)
    finally:
        M._host_tail = orig
    return np.stack([np.asarray(c).reshape(33, -1) for c in captured["b"]]), got


@pytest.mark.parametrize("n", [1, 12, 64])
def test_g1_msm_equals_the_reference(n):
    pts, coords = g1_points(n, seed=n)
    scalars = rand_scalars(n, seed=7 * n)
    want_buckets, want = reference_buckets(coords, scalars)
    got_buckets = T.g1_buckets(coords, scalars, "cpu")
    assert got_buckets.dtype == torch.int32
    assert np.array_equal(got_buckets.numpy(), want_buckets)
    assert T.g1_msm(coords, scalars, "cpu") == want == host_sum(pts, scalars)


def test_scalar_edges_duplicates_and_reduction():
    pts, coords = g1_points(12, seed=4)
    scalars = [0, 1, B.R - 1] + [7] * 9  # duplicates share buckets
    want = M.g1_msm(coords, scalars)
    assert T.g1_msm(coords, scalars, "cpu") == want == host_sum(pts, scalars)
    big = [s + B.R for s in scalars]  # taken mod r, as in the reference
    assert T.g1_msm(coords, big, "cpu") == M.g1_msm(coords, big) == want
    assert T.g1_msm(coords, [0] * 12, "cpu") is None is M.g1_msm(coords, [0] * 12)
    assert T.g1_msm([], [], "cpu") is None is M.g1_msm([], [])
    # a point and its negative cancel
    neg = (coords[0][0], (-coords[0][1]) % B.P)
    assert T.g1_msm([coords[0], neg], [5, 5], "cpu") is None


def test_length_mismatch_raises_and_empty_returns_none():
    _, coords = g1_points(3, seed=9)
    for mod, kw in ((M, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="length mismatch"):
            mod.g1_msm(coords, [1, 2], **kw)
    assert T.g1_msm([], [1], "cpu") is None  # empty first, as in the reference


def test_limb_tail_equals_host_tail_and_the_reference_limbs():
    """The limb tail (the card's) on the CPU: its window sums limb for limb
    equal to the reference's numpy _weighted_window_sums on the same
    buckets, and its result equal to the host tail's."""
    pts, coords = g1_points(8, seed=5)
    scalars = rand_scalars(8, seed=55)
    want_buckets, want = reference_buckets(coords, scalars)
    buckets = T.g1_buckets(coords, scalars, "cpu")
    w = T._weighted_window_sums(buckets)
    ref_w = M._weighted_window_sums(
        tuple(want_buckets[c].reshape(33, 32, 256) for c in range(3)), np)
    assert np.array_equal(w.numpy(), np.stack([np.asarray(c) for c in ref_w]))
    total = T._combine_windows(w)
    assert T.point_to_affine_int(total) == T._host_tail(buckets) == want == host_sum(pts, scalars)


def test_pack_unpack_equal_the_reference():
    vals = [0, 1, TF.P - 1] + rand_scalars(29, seed=3, bound=TF.P)
    got = TF.pack(vals)
    assert got.dtype == np.int32 and got.shape == (TF.PACK_WORDS, len(vals))
    assert np.array_equal(got, JF.pack(vals))
    assert TF.unpack(got) == JF.unpack(got) == vals
    assert (TF.PACK_RADIX, TF.PACK_WORDS) == (JF.PACK_RADIX, JF.PACK_WORDS)
    for bad in (TF.P, -1):
        for mod in (TF, JF):
            with pytest.raises(ValueError, match="canonical"):
                mod.pack([bad])


def test_mont_from_ints_equals_the_reference():
    vals = [0, 1, TF.P - 1, TF.P, TF.P + 5, -3] + rand_scalars(100, seed=11, bound=1 << 400)
    got = TF.mont_from_ints(vals)
    assert got.dtype == np.int32 and np.array_equal(got, JF.mont_from_ints(vals))
    assert TF.mont_from_ints([]).shape == (33, 0)
