"""Port fused MSM (tendermint_tpu_torch/ops/msm_geometry.py, cuda_msm.py and
msm_torch._msm_total_fused) against the JAX package's pallas_msm / msm_jax on
the same numpy-seeded inputs.

Tolerance: zero. Geometry and index arrays are compared for exact equality;
the plain kernel versions limb for limb with the reference's jnp twins (the
Pallas branch is off on the CPU); MSM totals through their canonical 32-byte
encodings. msm_jax._msm_total_fused itself is not called: its scan-form top
tree compiles for minutes on XLA:CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import msm_jax
from tendermint_tpu.ops import pallas_msm as PM
from tendermint_tpu_torch.ops import cuda_fe, cuda_msm
from tendermint_tpu_torch.ops import ed25519_torch as te
from tendermint_tpu_torch.ops import msm_geometry as G
from tendermint_tpu_torch.ops import msm_torch as M

torch.set_num_threads(2)

NL = 20


def _chain(seed: int, m: int):
    """m seeded curve points s0 B + k d B, as ed25519_ref extended points."""
    rng = np.random.default_rng(seed)
    p = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    step = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    out = []
    for _ in range(m):
        out.append(p)
        p = ref.point_add(p, step)
    return out


def _enc(pts) -> np.ndarray:
    return np.stack([np.frombuffer(ref.point_compress(p), dtype=np.uint8) for p in pts])


_TABLE = {}


def _picks(seed: int, lanes: int) -> torch.Tensor:
    """(4, 20, lanes) points drawn from 256 seeded ones, half of them
    doubled once (limbs that are carried but not reduced)."""
    if "pts" not in _TABLE:
        p, ok = M.decompress_rows(_enc(_chain(11, 128)), device="cpu")
        assert bool(ok.all())
        _TABLE["pts"] = torch.cat([p, te.point_double(p)], dim=-1)
    base = _TABLE["pts"]
    rng = np.random.default_rng(seed)
    return base[..., torch.from_numpy(rng.integers(0, base.shape[-1], size=lanes))].contiguous()


def _rows(x: torch.Tensor) -> np.ndarray:
    """(4, 20, m) -> the reference's (m, 80) point rows."""
    return x.reshape(4 * NL, -1).T.numpy()


def _packed(x: torch.Tensor):
    return jnp.asarray(x.reshape(4, NL, -1, G.LANE).numpy())


def _compress(total: torch.Tensor) -> bytes:
    return bytes(te.compress(total.reshape(4, NL, 1).contiguous())[:, 0].numpy())


def _window_sort(seed: int, n: int, t_: int = M.NWIN):
    """(perm (T, n) int64, ends (T, 256) int32) of seeded random digits."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(0, 256, size=(n, t_)).astype(np.uint8)
    if t_ == M.NWIN:
        perm, ends = M.sort_windows(digits)
        return perm.astype(np.int64), ends
    perm = np.stack([np.argsort(digits[:, w], kind="stable") for w in range(t_)])
    ends = np.stack([np.searchsorted(np.sort(digits[:, w]), np.arange(256), side="right")
                     for w in range(t_)]).astype(np.int32)
    return perm.astype(np.int64), ends


# ---------------------------------------------------------------------------
# Host geometry.


@pytest.mark.parametrize("n", [512, 1024, 1536, 2048, 2500, 3072, 20480, 24576, 32768])
def test_chunk_for_lanes_matches_jax(n):
    assert G.chunk_for_lanes(n) == PM.chunk_for_lanes(n)
    assert M.fused_for_lanes(n) == (PM.chunk_for_lanes(n) is not None)


@pytest.mark.parametrize("ch", [256, 1024, 2048])
def test_chunk_geometry_and_brev_match_jax(ch):
    assert tuple(G.chunk_geometry(ch)) == tuple(PM.chunk_geometry(ch))
    np.testing.assert_array_equal(G.brev_positions(4 * ch, ch), PM.brev_positions(4 * ch, ch))
    g = G.chunk_geometry(ch)
    k = np.arange(ch >> 1)
    np.testing.assert_array_equal(G.fused_node_position(g, 1, k), PM.fused_node_position(
        PM.chunk_geometry(ch), 1, k))
    j = np.arange(1 << 11)
    for m in range(1, 12):
        got = G.brev(torch.from_numpy(j % (1 << m)), m).numpy()
        np.testing.assert_array_equal(got, PM.brev_np(j % (1 << m), m))
    written = G.tree_written_positions(ch)
    assert len(written) == ch - 1 and len(set(written.tolist())) == ch - 1
    assert written.max() < g.rows_out * G.LANE


@pytest.mark.parametrize("n,ch", [(20480, 2048), (24576, 2048), (3072, 1024), (2048, 2048)])
def test_fused_node_indices_match_jax(n, ch):
    assert G.chunk_for_lanes(n) == ch
    _, ends = _window_sort(n, n)
    got = M.fused_node_indices_device(torch.from_numpy(ends), n, ch)
    want = np.asarray(msm_jax.fused_node_indices_device(ends, n, ch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[-1] == (16 if n in (20480, 24576) else want.shape[-1])


# ---------------------------------------------------------------------------
# Plain kernel versions against the reference's jnp twins.


@pytest.mark.parametrize("ch", [1024, 2048])
def test_uptree_plain_matches_jax(ch):
    g = G.chunk_geometry(ch)
    lvl0 = _picks(ch, 2 * ch)  # 2 windows of one chunk each
    got = cuda_msm.chunk_trees_plain(lvl0, ch).reshape(4, NL, 2, g.rows_out * G.LANE)
    want = np.asarray(PM._uptree_jnp(_packed(lvl0), PM.chunk_geometry(ch)))
    want = want.reshape(4, NL, 2, g.rows_out * G.LANE)
    pos = torch.from_numpy(G.tree_written_positions(ch))
    np.testing.assert_array_equal(got[..., pos].numpy(), want[..., pos.numpy()])


def _jax_gather_rows(pts: torch.Tensor, perm: np.ndarray, ch: int) -> np.ndarray:
    """msm_jax._msm_total_fused's level-0 gather: the (T * N, 80) point rows
    of the composed bit-reversed permutation."""
    n = pts.shape[-1]
    perm_f = jnp.take(jnp.asarray(perm), jnp.asarray(PM.brev_positions(n, ch)), axis=1)
    rowtab = jnp.asarray(pts.reshape(4 * NL, n).T.numpy())
    return np.asarray(rowtab[perm_f.reshape(-1)])


@pytest.mark.parametrize("ch", [1024, 2048])
def test_uptree_fused_gather_matches_jax_gather(ch):
    """uptree(pts, perm, ch) on the CPU: level 0 against the JAX package's
    own gather, the chunk trees against _uptree_jnp on that gather."""
    n, t_ = 2 * ch, 2  # 2 windows of 2 chunks each
    g = G.chunk_geometry(ch)
    pts = _picks(ch + 7, n)
    perm, _ = _window_sort(ch + 8, n, t_)
    lvl0, ctree = cuda_msm.uptree(pts, torch.from_numpy(perm.astype(np.int32)), ch)
    rows = _jax_gather_rows(pts, perm, ch)
    np.testing.assert_array_equal(_rows(lvl0), rows)
    want = np.asarray(PM._uptree_jnp(PM.rows_to_packed(jnp.asarray(rows)), PM.chunk_geometry(ch)))
    want = want.reshape(4, NL, 2 * t_, g.rows_out * G.LANE)
    pos = torch.from_numpy(G.tree_written_positions(ch))
    got = ctree.reshape(4, NL, 2 * t_, g.rows_out * G.LANE)[..., pos]
    np.testing.assert_array_equal(got.numpy(), want[..., pos.numpy()])


def _fused_storage(seed: int, n: int, t_: int):
    """Level 0, chunk trees, top tree and node indices of a fused MSM over n
    lanes and t_ windows (msm_torch._fused_stages)."""
    perm, ends = _window_sort(seed + 1, n, t_)
    return M._fused_stages(_picks(seed, n), torch.from_numpy(perm), torch.from_numpy(ends))


def test_fenwick_reduce_plain_matches_jax():
    t_ = 2
    lvl0, ctree, top, idx = _fused_storage(21, 2048, t_)  # ch 2048: Kf = 11 + 1
    got = cuda_msm.fenwick_reduce_plain(lvl0, ctree, top, idx)
    all_rows = np.concatenate([_rows(lvl0), _rows(ctree), _rows(top)])
    kf = idx.shape[1]
    gathered = all_rows[idx.numpy().reshape(-1)].reshape(-1, kf, 4 * NL)  # (NB*T, Kf, 80)
    gk = np.moveaxis(np.moveaxis(gathered, 1, 0), -1, 1).reshape(kf, 4, NL, -1, G.LANE)
    want = np.asarray(PM.fenwick_reduce(jnp.asarray(gk)))
    np.testing.assert_array_equal(got.numpy(), want.reshape(4, NL, -1))


def _sectors_brute(idx: np.ndarray, sizes) -> int:
    """Every (segment, 32-byte sector) that some limb row of some named node
    lies in, one address at a time."""
    seen = set()
    for g in idx.reshape(-1).tolist():
        seg = 0
        while g >= sizes[seg]:
            g -= sizes[seg]
            seg += 1
        for r in range(4 * NL):
            seen.add((seg, (r * sizes[seg] + g) * 4 // 32))
    return len(seen)


@pytest.mark.parametrize("case", ["fused_storage", "odd_segments"])
def test_fenwick_gather_sectors_equal_brute_force(case):
    """The host sector count that bounds kernel B5's gather, on a fused index
    table (2 windows, Kf = 12, identity slots included) and on random
    indices into segments whose lengths are not multiples of 8."""
    if case == "fused_storage":
        lvl0, ctree, top, idx = _fused_storage(21, 2048, 2)
        sizes = [x.shape[-1] for x in (lvl0, ctree, top)]
        idx = idx.numpy()
    else:
        sizes = [37, 50, 9]
        idx = np.random.default_rng(5).integers(0, sum(sizes), size=(40, 3))
    assert chip_smoke.fenwick_gather_sectors(idx, *sizes) == _sectors_brute(idx, sizes)


def test_bucket_fold_plain_matches_jax():
    t_ = M.NWIN
    prefix = _picks(33, M.NBUCKETS * t_)
    s, p255 = cuda_msm.bucket_fold_plain(prefix, t_)
    want = np.asarray(PM._bucket_jnp(_packed(prefix), t_))
    np.testing.assert_array_equal(s.numpy(), want[:, :, 0, :t_])
    np.testing.assert_array_equal(p255.numpy(), want[:, :, 1, :t_])


# ---------------------------------------------------------------------------
# The fused MSM total and the RLC flushes.


@pytest.mark.parametrize("n", [2048, 3072])
def test_fused_total_equals_integer_msm_and_unfused(n):
    pts = _chain(n, n)
    rng = np.random.default_rng(n + 1)
    scal = ([int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n // 2)]
            + [int.from_bytes(rng.bytes(16), "little") for _ in range(n - n // 2)])
    want = ref.point_compress(jbatch._host_msm(list(zip(pts, scal))))
    p, ok = M.decompress_rows(_enc(pts), device="cpu")
    assert bool(ok.all())
    perm, ends = M.sort_windows(M.scalars_to_bytes(scal, n), zero16_from=n // 2)
    perm_t, ends_t = torch.from_numpy(perm.astype(np.int32)), torch.from_numpy(ends)
    fused = M._msm_total_fused(p, perm_t, ends_t)
    unfused = M._msm_total(p, perm_t, M.fenwick_nodes_device(ends_t, n))
    assert _compress(fused) == want
    assert _compress(unfused) == want


def _points_of(k0: int, d: int, m: int):
    """k_i B for k_i = k0 + i d, i < m (one point add each)."""
    p = ref.point_mul(k0, ref.BASE)
    step = ref.point_mul(d, ref.BASE)
    out = []
    for _ in range(m):
        out.append(p)
        p = ref.point_add(p, step)
    return out


def _honest_lanes(seed: int, na: int):
    """An honest RLC equation over na-1 (A, R) pairs: A_i = a_i B, R_i = r_i B,
    sum w_i A_i + z_i R_i = u B, closed by (L - u) on the B lane. R lane 3
    holds an invalid encoding with scalar 0."""
    rng = np.random.default_rng(seed)
    m = na - 1
    a0, da, r0, dr = (int(x) for x in rng.integers(1, 1 << 62, size=4))
    w = [int(x) for x in rng.integers(1, 1 << 62, size=m)]
    z = [int(x) * 8 for x in rng.integers(1, 1 << 60, size=m)]
    z[3] = 0
    u = sum(wi * (a0 + i * da) + zi * (r0 + i * dr)
            for i, (wi, zi) in enumerate(zip(w, z))) % ref.L
    a_enc = _enc(_points_of(a0, da, m) + [ref.BASE])
    r_enc = _enc(_points_of(r0, dr, m) + [ref.BASE])
    r_enc[3] = np.frombuffer(ref.P.to_bytes(32, "little"), dtype=np.uint8)  # y = p: invalid
    return a_enc, r_enc, w + [(ref.L - u) % ref.L] + z + [0]


def test_rlc_flushes_route_fused_and_keep_their_masks(monkeypatch):
    na = 1024  # 2048 lanes: the smallest RLC flush (RLC_MIN rows)
    a_enc, r_enc, scal = _honest_lanes(5, na)
    calls = []
    fused_total = M._msm_total_fused

    def spy(*a):
        calls.append(a[0].shape[-1])
        return fused_total(*a)

    monkeypatch.setattr(M, "_msm_total_fused", spy)
    perm, ends = M.sort_windows(M.scalars_to_bytes(scal, 2 * na), zero16_from=na)
    lanes = np.concatenate([a_enc, r_enc])
    plain, pts = M.rlc_check_submit(lanes, perm, ends, "cpu")
    a_pts = pts[..., :na].contiguous()
    cached = M.rlc_check_cached_submit(a_pts, r_enc, perm, ends)
    assert calls == [2 * na, 2 * na]
    assert bool(plain[0]) and bool(cached[0])
    assert cached[1:].tolist() == [i != 3 for i in range(na)]
    # the unfused schedule gives the same packed verdicts
    b = torch.from_numpy(np.ascontiguousarray(lanes.T))
    perm_t, ends_t = torch.from_numpy(perm.astype(np.int32)), torch.from_numpy(ends)
    assert torch.equal(M._rlc_core(b, perm_t, ends_t, False)[0], plain)
    rb = torch.from_numpy(np.ascontiguousarray(r_enc.T))
    assert torch.equal(M._rlc_core_cached(a_pts, rb, perm_t, ends_t, False), cached)
    assert len(calls) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_msm_kernels_equal_plain_on_card(cuda_device):
    t_ = 2
    lvl0, ctree, top, idx = _fused_storage(21, 2048, t_)
    on = [x.to(cuda_device) for x in (lvl0, ctree, top, idx)]
    cuda_msm.reset_launches()
    pts = _picks(21, 2048)
    perm, _ = _window_sort(22, 2048, t_)
    perm = torch.from_numpy(perm.astype(np.int32))
    pos = torch.from_numpy(G.tree_written_positions(2048))
    got0, got = cuda_msm.uptree(pts.to(cuda_device), perm.to(cuda_device), 2048)
    assert torch.equal(got0.cpu(), lvl0)
    assert torch.equal(got.cpu().reshape(4, NL, t_, -1)[..., pos],
                       ctree.reshape(4, NL, t_, -1)[..., pos])
    assert torch.equal(cuda_msm.fenwick_reduce(*on).cpu(),
                       cuda_msm.fenwick_reduce_plain(lvl0, ctree, top, idx))
    prefix = _picks(33, M.NBUCKETS * M.NWIN)
    got = cuda_msm.bucket_fold(prefix.to(cuda_device), M.NWIN)
    want = cuda_msm.bucket_fold_plain(prefix, M.NWIN)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert cuda_msm.LAUNCHES == {"uptree": 1, "fenwick_reduce": 1, "bucket_fold": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("ch,chunks", [(1024, 6), (2048, 10)])
def test_uptree_kernel_equals_plain_on_card(cuda_device, ch, chunks):
    """The fused-gather kernel at several chunks per window (so a chunk's
    upper levels run in whichever block finishes it last): level 0 and every
    written chunk-tree position against the plain version."""
    t_ = 3
    n = chunks * ch
    pts = _picks(ch + 1, n)
    perm = torch.from_numpy(_window_sort(ch + 2, n, t_)[0].astype(np.int32))
    want0, want = cuda_msm.uptree_plain(pts, perm, ch)
    got0, got = cuda_msm.uptree(pts.to(cuda_device), perm.to(cuda_device), ch)
    pos = torch.from_numpy(G.tree_written_positions(ch))
    assert torch.equal(got0.cpu(), want0)
    assert torch.equal(got.cpu().reshape(4, NL, t_ * chunks, -1)[..., pos],
                       want.reshape(4, NL, t_ * chunks, -1)[..., pos])


def test_pdbl_routes_by_lane_count(monkeypatch):
    """The window fold's and [256]P_255's pdbl launches (32 lanes and fewer)
    and a small ladder's (up to 1,024 lanes) take the warp-per-lane kernel,
    the per-signature ladder's 16,384 lanes the 4-threads-a-lane kernel; on
    the CPU both are the plain version."""
    assert cuda_fe.PDBL_FEW_LANES == 1024
    assert [cuda_fe.pdbl_entry(n) for n in (1, 2, 16, 32, 33, 512, 1024)] == ["tm_pdbl_lanes"] * 7
    assert [cuda_fe.pdbl_entry(n) for n in (1025, 4096, 16_384)] == ["tm_pdbl"] * 3
    w = _picks(44, M.NWIN)
    p_last = _picks(45, M.NWIN)
    seen = []
    plain = cuda_fe.pdbl

    def spy(p, times=1):
        seen.append((p.shape[-1], times, cuda_fe.pdbl_entry(p.shape[-1])))
        return plain(p, times)

    monkeypatch.setattr(cuda_fe, "pdbl", spy)
    M._fold_windows(M._bucket_tail(w, p_last))
    assert seen[0] == (M.NWIN, 8, "tm_pdbl_lanes")
    assert [s[:2] for s in seen[1:]] == [(16, 8), (8, 16), (4, 32), (2, 64), (1, 128)]
    assert all(s[2] == "tm_pdbl_lanes" for s in seen)


def test_fsquare_chain_routes_by_lane_count(monkeypatch):
    """A decompression's pow chains (k = 10, 20, 50, 100) on few lanes take
    the 4-threads-a-lane kernel, the 10k paths' 10,240-24,576 lanes the
    thread-per-lane kernel; on the CPU both are the plain version, equal to
    the reference's decompression."""
    assert cuda_fe.FSQ_FEW_LANES == 4096
    few = (1, 40, 512, 4096)
    assert [cuda_fe.fsquare_chain_entry(n) for n in few] == ["tm_fsquare_chain_quad"] * 4
    wide = (4097, 10_240, 16_384, 20_480, 24_576)
    assert [cuda_fe.fsquare_chain_entry(n) for n in wide] == ["tm_fsquare_chain"] * 5
    seen = []
    plain = cuda_fe.fsquare_chain

    def spy(x, k):
        seen.append((x.shape[-1], k, cuda_fe.fsquare_chain_entry(x.shape[-1])))
        return plain(x, k)

    monkeypatch.setattr(cuda_fe, "fsquare_chain", spy)
    p, enc = ref.BASE, []
    for _ in range(40):
        enc.append(np.frombuffer(ref.point_compress(p), dtype=np.uint8))
        p = ref.point_add(p, ref.BASE)
    pts, ok = M.decompress_rows(np.stack(enc), device="cpu")
    assert bool(ok.all())
    assert sorted({k for _, k, _ in seen}) == [10, 20, 50, 100]
    assert all(n == 40 and e == "tm_fsquare_chain_quad" for n, _, e in seen)
    got = te.compress(pts)
    assert [bytes(got[:, i].numpy()) for i in range(40)] == [e.tobytes() for e in enc]


def test_padd_routes_by_lane_count(monkeypatch):
    """Every padd launch of the MSM schedule (the chunk-root top tree of a
    10k commit, the bucket tail, the window fold, the streamed partial sum:
    1-192 lanes) takes the warp-per-lane kernel, the per-signature ladder's
    16,384 lanes the 4-threads-a-lane kernel; on the CPU both are the plain
    version."""
    assert 192 <= cuda_fe.PADD_FEW_LANES < 16_384
    few = (1, 2, 4, 8, 16, 32, 64, 96, 160, 192, cuda_fe.PADD_FEW_LANES)
    assert [cuda_fe.padd_entry(n) for n in few] == ["tm_padd_lanes"] * len(few)
    assert [cuda_fe.padd_entry(n) for n in (cuda_fe.PADD_FEW_LANES + 1, 16_384)] == ["tm_padd"] * 2
    seen = []
    plain = cuda_fe.padd

    def spy(p, q):
        seen.append(p[0, 0].numel())  # the lanes the wrapper launches
        return plain(p, q)

    monkeypatch.setattr(cuda_fe, "padd", spy)
    roots = _picks(46, M.NWIN * 10).reshape(4, NL, M.NWIN, 10)  # 10 chunk roots a window
    M._tree_levels(roots)
    assert seen == [M.NWIN * 5, M.NWIN * 3, M.NWIN * 2, M.NWIN]  # 160, 96, 64, 32
    seen.clear()
    M._fold_windows(M._bucket_tail(_picks(47, M.NWIN), _picks(48, M.NWIN)))
    assert seen == [M.NWIN, M.NWIN, 16, 8, 4, 2, 1]
    seen.clear()
    M._partial_fold_core(_picks(49, 1)[..., 0], _picks(50, 1)[..., 0])
    assert seen == [1]


def test_padd_wrapper_checks_its_operands():
    p = _picks(51, 3)
    assert torch.equal(cuda_fe.padd(p, p), cuda_fe.padd_plain(p, p))  # CPU: the plain version
    with pytest.raises(ValueError, match="padd: q"):
        cuda_fe.padd(p.to("meta"), p[..., :2].to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,times", [(1, 128), (2, 64), (32, 8), (33, 3), (16_384, 4)])
def test_pdbl_kernels_equal_plain_on_card(cuda_device, lanes, times):
    """Both pdbl kernels, limb for limb against pdbl_plain, one launch each."""
    p = _picks(lanes + times, lanes)
    cuda_fe.reset_launches()
    got = cuda_fe.pdbl(p.to(cuda_device), times).cpu()
    assert torch.equal(got, cuda_fe.pdbl_plain(p, times))
    assert cuda_fe.LAUNCHES["pdbl"] == 1
