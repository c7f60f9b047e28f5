"""Port RLC MSM (tendermint_tpu_torch/ops/msm_torch.py, the unfused
schedule) against the JAX package's host geometry and the ed25519_ref
integer MSM.

Tolerance: zero. Index arrays are compared for exact equality, MSM totals
through their canonical 32-byte encodings, verdict vectors elementwise.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import msm_jax
from tendermint_tpu_torch.ops import ed25519_torch as te
from tendermint_tpu_torch.ops import msm_torch as M

torch.set_num_threads(2)


def _points(seed: int, m: int):
    """m seeded curve points: consecutive multiples s0 B + k d B."""
    rng = np.random.default_rng(seed)
    p = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    step = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    out = []
    for _ in range(m):
        out.append(p)
        p = ref.point_add(p, step)
    return out


def _enc_rows(pts) -> np.ndarray:
    return np.stack([np.frombuffer(ref.point_compress(p), dtype=np.uint8) for p in pts])


def _scalars(seed: int, n: int):
    """A block (first half) ~2^253 scalars mod L, R block < 2^128."""
    rng = np.random.default_rng(seed)
    half = n // 2
    return ([int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(half)]
            + [int.from_bytes(rng.bytes(16), "little") for _ in range(n - half)])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 512, 2048, 20480])
def test_level_geometry_matches_jax(n):
    assert M.level_widths(n) == msm_jax.level_widths(n)
    assert M.level_offsets(n) == msm_jax.level_offsets(n)


@pytest.mark.parametrize("n", [512, 2048])
def test_sort_and_fenwick_indices_match_jax(n):
    digits = M.scalars_to_bytes(_scalars(n, n), n)
    np.testing.assert_array_equal(digits, msm_jax.scalars_to_bytes(_scalars(n, n), n))
    for z16 in (0, n // 2):
        perm, ends = M.sort_windows(digits, zero16_from=z16)
        jperm, jends = msm_jax.sort_windows(digits, zero16_from=z16)
        assert perm.dtype == jperm.dtype
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(ends, jends)
    idx = M.fenwick_node_indices(ends, n)
    np.testing.assert_array_equal(idx, msm_jax.fenwick_node_indices(jends, n))
    np.testing.assert_array_equal(M.fenwick_nodes_device(torch.from_numpy(ends), n).numpy(), idx)


@pytest.mark.parametrize("n", [512, 2048])
def test_msm_total_equals_integer_msm(n):
    pts = _points(n, n)
    scal = _scalars(n + 1, n)
    want = jbatch._host_msm(list(zip(pts, scal)))
    p, ok = M.decompress_rows(_enc_rows(pts), device="cpu")
    assert bool(ok.all())
    perm, ends = M.sort_windows(M.scalars_to_bytes(scal, n), zero16_from=n // 2)
    total = M._msm_total(p, torch.from_numpy(perm.astype(np.int32)),
                         M.fenwick_nodes_device(torch.from_numpy(ends), n))
    got = bytes(te.compress(total.reshape(4, 20, 1).contiguous())[:, 0].numpy())
    assert got == ref.point_compress(want)
    assert bool(M.point_is_identity(total)) is False


def _rlc_lanes(seed: int, na: int):
    """An honest RLC equation over na-1 (A, R) pairs: scalars w_i on A_i,
    z_i on R_i and (L - u) on B with sum w_i A_i + z_i R_i = u B, so the
    combined total is the identity. Lane na-1 of the A block is B; one R
    lane holds an invalid encoding with scalar 0."""
    rng = np.random.default_rng(seed)
    m = na - 1
    a = [int(rng.integers(1, 1 << 62)) for _ in range(m)]
    r = [int(rng.integers(1, 1 << 62)) for _ in range(m)]
    z = [int(rng.integers(1, 1 << 60)) * 8 for _ in range(m)]
    w = [int(rng.integers(1, 1 << 62)) for _ in range(m)]
    z[3] = 0  # R lane 3 gets an invalid encoding below
    u = sum(wi * ai + zi * ri for wi, ai, zi, ri in zip(w, a, z, r)) % ref.L
    a_enc = _enc_rows([ref.point_mul(k, ref.BASE) for k in a] + [ref.BASE])
    r_enc = _enc_rows([ref.point_mul(k, ref.BASE) for k in r] + [ref.BASE])
    r_enc[3] = np.frombuffer(ref.P.to_bytes(32, "little"), dtype=np.uint8)  # y = p: invalid
    scal = w + [(ref.L - u) % ref.L] + z + [0]
    return a_enc, r_enc, scal


def test_rlc_core_plain_and_cached_agree():
    na = 64
    a_enc, r_enc, scal = _rlc_lanes(7, na)
    perm, ends = M.sort_windows(M.scalars_to_bytes(scal, 2 * na), zero16_from=na)
    plain, pts = M.rlc_check_submit(np.concatenate([a_enc, r_enc]), perm, ends, "cpu")
    a_pts, a_ok = M.decompress_rows(a_enc, device="cpu")
    assert bool(a_ok.all())
    assert torch.equal(pts[..., :na], a_pts)
    cached = M.rlc_check_cached_submit(a_pts, r_enc, perm, ends)
    assert plain.shape == (1 + 2 * na,) and cached.shape == (1 + na,)
    assert bool(plain[0]) and bool(cached[0])
    assert torch.equal(plain[1 + na:], cached[1:])
    assert cached[1:].tolist() == [i != 3 for i in range(na)]
    # a wrong scalar breaks the equation for both variants alike
    scal[0] += 8
    perm, ends = M.sort_windows(M.scalars_to_bytes(scal, 2 * na), zero16_from=na)
    assert not bool(M.rlc_check_submit(np.concatenate([a_enc, r_enc]), perm, ends, "cpu")[0][0])
    assert not bool(M.rlc_check_cached_submit(a_pts, r_enc, perm, ends)[0])


def test_degenerate_total_is_not_identity():
    zero = torch.zeros((4, 20), dtype=torch.int32)
    assert bool(M.point_is_identity(zero)) is False
    ident = te.identity((), "cpu")
    assert bool(M.point_is_identity(ident)) is True
    base = torch.from_numpy(M.basepoint_coords())
    assert bool(M.point_is_identity(base)) is False
