"""Port kernels against their plain torch versions at edge shapes, on the
card: B1 (fsquare_chain), B2 (padd), B3 (pdbl), B5 (fenwick_reduce), B6
(bucket_fold), B7 (fp381_mul), B8 (fp12_sparse_mul); that a malformed CUDA
input raises rather than taking a plain version; the verify-mode
routing of an explicit backend="cuda" request; and two asynchronous
submits in flight on the card, then accumulated into one flush.

B8 at 1, 2, 3, 129 and 16,384 lanes: a block holds 2 lanes, so these cover
a half block, one block, a ragged last block and many blocks. B5 at Kf = 1,
2, 12 and 16 nodes a lane and T = 1, 2 and 32 windows (256 T lanes): a
block takes 32 neighbouring buckets of one window, and Kf = 1 and 2 are the
kernel's no-add and single-add cases. The storage holds seeded carried limbs
and each window's last top-tree lane is the identity point, which the
indices name among random nodes of all three segments. B2 at 1, 31, 32, 33,
192, PADD_FEW_LANES, PADD_FEW_LANES + 1, 16,384, 16,385 and 16,391 lanes: a
block of the warp kernel holds 4 lanes, one of the 4-threads-a-lane kernel
16, so PADD_FEW_LANES + 1, 16,385 and 16,391 end in a part block; two shapes
sit on either side of the switch between the kernels; each shape also runs
both kernels, forced by pinning PADD_FEW_LANES. B7 at 1, 2, 31, 32, 33,
FP_FEW_PRODUCTS, FP_FEW_PRODUCTS + 1 and 49,152 products (groups x lanes: 2
lanes where the count is even, as on the Miller loop, else 1; 6 x 8,192 for
the fold's first level), routed and with each kernel forced by pinning
FP_FEW_PRODUCTS: the few-product kernel holds 4 products a block, one a
warp; and B7 on five products whose M keeps a digit of 4096 after 3 carry
passes, which the few-product kernel's vote loop settles. B6 at T = 1, 32 and 33 windows: 4 blocks a window,
with nodes handed over through device memory. B2 and B6 inputs are seeded points and their doubles
(carried limbs). B1 (fsquare_chain) at 1, 31, 32, 33, FSQ_FEW_LANES,
FSQ_FEW_LANES + 1, 10,240, 24,576 and 24,577 lanes with k = 1, 50 and 100,
routed and with each kernel forced: the 4-threads-a-lane kernel holds 32
lanes a block, the thread-per-lane kernel 128, so these cover part blocks,
ragged last warps and blocks, the switch between the kernels, and the 10k
commit's and the planner chunk's widths. B3 (pdbl) at 33,
PDBL_FEW_LANES, PDBL_FEW_LANES + 1, 16,384 and 16,385 lanes with times =
1-4, routed and with each kernel forced: the 4-threads-a-lane kernel holds
16 lanes a block, so 16,385 leaves one group in its last block. B1 and B3
inputs are the y coordinates and points of the same seeded points and their
doubles.

Tolerance: zero (integer arithmetic, limb for limb). Every test needs a
CUDA card and skips without one. The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed, without
tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_edges.py
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import batch, keys
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm, msm_torch
from tendermint_tpu_torch.ops.ed25519_torch import identity

NL = cuda_msm.NL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def carried_fp(shape, rng) -> torch.Tensor:
    """(*lead, 33, n) fp381 operands: limbs 0..31 in [0, 4096], the top one
    < 16 (the product's input discipline)."""
    lead, n = shape[:-1], shape[-1]
    x = rng.integers(0, 4097, size=(*lead, 33, n), dtype=np.int32)
    x[..., 32, :] = rng.integers(0, 16, size=(*lead, n), dtype=np.int32)
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 129, 16_384])
def test_fp12_sparse_mul_kernel_equals_plain_at_edge_lanes(cuda_device, n):
    rng = np.random.default_rng(n)
    f, line = carried_fp((6, 2, n), rng), carried_fp((3, 2, n), rng)
    cuda_bls.reset_launches()
    got = cuda_bls.fp12_sparse_mul(f.to(cuda_device), line.to(cuda_device)).cpu()
    assert torch.equal(got, cuda_bls.fp12_sparse_mul_plain(f, line))
    assert cuda_bls.LAUNCHES["fp12_sparse_mul"] == 1


def fenwick_inputs(kf: int, t_: int, rng):
    """Storage segments (4, 20, n_seg) of carried limbs, the top tree with an
    identity lane per window, and (256 T, Kf) indices over all three."""
    n0, n1, wtop = 2_000 + t_, 3_000 + 7 * t_, 33
    lvl0, ctree, top = (torch.from_numpy(rng.integers(0, 8192, size=(4, NL, k), dtype=np.int32))
                        for k in (n0, n1, wtop * t_))
    ident = (np.arange(t_) + 1) * wtop - 1  # each window's last top lane
    top[..., torch.from_numpy(ident)] = identity((t_,), "cpu")
    m = cuda_msm.NBUCKETS * t_
    idx = rng.integers(0, n0 + n1 + wtop * t_, size=(m, kf))
    holes = rng.random((m, kf)) < 0.25
    idx[holes] = n0 + n1 + ident[rng.integers(0, t_, size=int(holes.sum()))]
    return lvl0, ctree, top, torch.from_numpy(idx.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("t_", [1, 2, 32])
@pytest.mark.parametrize("kf", [1, 2, 12, 16])
def test_fenwick_reduce_kernel_equals_plain_at_edge_shapes(cuda_device, kf, t_):
    args = fenwick_inputs(kf, t_, np.random.default_rng(100 * kf + t_))
    cuda_msm.reset_launches()
    got = cuda_msm.fenwick_reduce(*(x.to(cuda_device) for x in args)).cpu()
    assert torch.equal(got, cuda_msm.fenwick_reduce_plain(*args))
    assert cuda_msm.LAUNCHES["fenwick_reduce"] == 1


_POINTS = {}


def carried_points(lanes: int, seed: int) -> torch.Tensor:
    """(4, 20, lanes) points drawn from 64 seeded multiples of B and their
    doubles (limbs carried, not reduced), on the CPU."""
    if "base" not in _POINTS:
        p, step, enc = ref.point_mul(9_001, ref.BASE), ref.point_mul(313, ref.BASE), []
        for _ in range(64):
            enc.append(np.frombuffer(ref.point_compress(p), dtype=np.uint8))
            p = ref.point_add(p, step)
        pts, ok = msm_torch.decompress_rows(np.stack(enc), device="cpu")
        assert bool(ok.all())
        _POINTS["base"] = torch.cat([pts, cuda_fe.pdbl_plain(pts, 1)], dim=-1)
    base = _POINTS["base"]
    rng = np.random.default_rng(seed)
    return base[..., torch.from_numpy(rng.integers(0, base.shape[-1], size=lanes))].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 192, "few", "few+1", 16_384, 16_385, 16_391])
def test_padd_kernels_equal_plain_at_edge_lanes(cuda_device, monkeypatch, n):
    n = {"few": cuda_fe.PADD_FEW_LANES, "few+1": cuda_fe.PADD_FEW_LANES + 1}.get(n, n)
    p, q = carried_points(n, 2 * n), carried_points(n, 2 * n + 1)
    want = cuda_fe.padd_plain(p, q)
    # the routing as shipped, then the warp kernel (n <= limit) and the
    # 4-threads-a-lane kernel (n > limit) forced
    for limit in (cuda_fe.PADD_FEW_LANES, n, n - 1):
        monkeypatch.setattr(cuda_fe, "PADD_FEW_LANES", limit)
        cuda_fe.reset_launches()
        got = cuda_fe.padd(p.to(cuda_device), q.to(cuda_device)).cpu()
        assert torch.equal(got, want), cuda_fe.padd_entry(n)
        assert cuda_fe.LAUNCHES["padd"] == 1


# Products whose M keeps a digit of 4096 after 3 carry passes: (seed,
# column) of a draw of 200,000 carried operand pairs (RIPPLE_DRAW_N); the
# last three leave it in the top digit. tests/test_torch_kernel_schedules.py
# holds their limbs.
RIPPLE_DRAWS = ((1, 173_109), (1, 184_620), (2, 45_235), (4, 74_824), (24, 10_511))
RIPPLE_DRAW_N = 200_000


def ripple_fp() -> tuple:
    """(a, b), each (33, 5) int32: the RIPPLE_DRAWS columns of
    default_rng(seed)'s a, then b, each integers(0, 4097, (33, n)) with its
    top row replaced by integers(0, 16, n)."""
    cols = ([], [])
    for seed, k in RIPPLE_DRAWS:
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 4097, size=(33, RIPPLE_DRAW_N))
        b = rng.integers(0, 4097, size=(33, RIPPLE_DRAW_N))
        a[32] = rng.integers(0, 16, RIPPLE_DRAW_N)
        b[32] = rng.integers(0, 16, RIPPLE_DRAW_N)
        cols[0].append(a[:, k])
        cols[1].append(b[:, k])
    return tuple(torch.from_numpy(np.stack(c, 1).astype(np.int32)) for c in cols)


@pytest.mark.cuda
@pytest.mark.parametrize("products", [1, 2, 31, 32, 33, "few", "few+1", 49_152, "ripple"])
def test_fp381_mul_kernels_equal_plain_at_edge_products(cuda_device, monkeypatch, products):
    if products == "ripple":
        a, b = ripple_fp()
        k = a.shape[-1]
    else:
        k = {"few": cuda_bls.FP_FEW_PRODUCTS, "few+1": cuda_bls.FP_FEW_PRODUCTS + 1}.get(
            products, products)
        shape = (6, 8_192) if k == 49_152 else (k // 2, 2) if k % 2 == 0 else (k, 1)
        rng = np.random.default_rng(k)
        a, b = carried_fp(shape, rng), carried_fp(shape, rng)
    want = cuda_bls.fp381_mul_plain(a, b)
    a, b = a.to(cuda_device), b.to(cuda_device)
    # the routing as shipped, then the few-product kernel (k <= limit) and
    # the thread-per-product kernel (k > limit) forced
    for limit in (cuda_bls.FP_FEW_PRODUCTS, k, k - 1):
        monkeypatch.setattr(cuda_bls, "FP_FEW_PRODUCTS", limit)
        cuda_bls.reset_launches()
        got = cuda_bls.fp381_mul(a, b).cpu()
        assert torch.equal(got, want), cuda_bls.fp381_mul_entry(k)
        assert cuda_bls.LAUNCHES["fp381_mul"] == 1


@pytest.mark.cuda
def test_malformed_cuda_inputs_raise_not_fall_back(cuda_device):
    """A CUDA tensor of the wrong type or layout raises in fp381_mul and
    padd, on either kernel's side of the routing; nothing is launched and no
    plain version is taken."""
    rng = np.random.default_rng(3)
    cuda_bls.reset_launches()
    cuda_fe.reset_launches()
    for shape in ((4, 2), (6, 8_192)):
        a = carried_fp(shape, rng).to(cuda_device)
        with pytest.raises(TypeError):
            cuda_bls.fp381_mul(a.long(), a.long())
        with pytest.raises(ValueError):
            cuda_bls.fp381_mul(a[..., ::2], a[..., ::2])
    for n in (32, 16_384):
        p = carried_points(n, 9).to(cuda_device)
        with pytest.raises(TypeError):
            cuda_fe.padd(p.long(), p.long())
        with pytest.raises(ValueError):
            cuda_fe.padd(p[..., ::2], p[..., ::2])
    assert cuda_bls.LAUNCHES["fp381_mul"] == 0 and cuda_fe.LAUNCHES["padd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 50, 100])
@pytest.mark.parametrize("n", [1, 31, 32, 33, "few", "few+1", 10_240, 24_576, 24_577])
def test_fsquare_chain_kernels_equal_plain_at_edge_lanes(cuda_device, monkeypatch, n, k):
    n = {"few": cuda_fe.FSQ_FEW_LANES, "few+1": cuda_fe.FSQ_FEW_LANES + 1}.get(n, n)
    x = carried_points(n, 3 * n + k)[1].contiguous().to(cuda_device)
    want = cuda_fe.fsquare_chain_plain(x, k)  # the plain version, on the card
    # the routing as shipped, then the 4-threads-a-lane kernel (n <= limit)
    # and the thread-per-lane kernel (n > limit) forced
    for limit in (cuda_fe.FSQ_FEW_LANES, n, n - 1):
        monkeypatch.setattr(cuda_fe, "FSQ_FEW_LANES", limit)
        cuda_fe.reset_launches()
        got = cuda_fe.fsquare_chain(x, k)
        assert torch.equal(got, want), cuda_fe.fsquare_chain_entry(n)
        assert cuda_fe.LAUNCHES["fsquare_chain"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("times", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [33, "few", "few+1", 16_384, 16_385])
def test_pdbl_kernels_equal_plain_at_edge_lanes(cuda_device, monkeypatch, n, times):
    n = {"few": cuda_fe.PDBL_FEW_LANES, "few+1": cuda_fe.PDBL_FEW_LANES + 1}.get(n, n)
    p = carried_points(n, 5 * n + times).to(cuda_device)
    want = cuda_fe.pdbl_plain(p, times)
    # the routing as shipped, then the warp kernel (n <= limit) and the
    # 4-threads-a-lane kernel (n > limit) forced
    for limit in (cuda_fe.PDBL_FEW_LANES, n, n - 1):
        monkeypatch.setattr(cuda_fe, "PDBL_FEW_LANES", limit)
        cuda_fe.reset_launches()
        got = cuda_fe.pdbl(p, times)
        assert torch.equal(got, want), cuda_fe.pdbl_entry(n)
        assert cuda_fe.LAUNCHES["pdbl"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t_", [1, 32, 33])
def test_bucket_fold_kernel_equals_plain_at_edge_windows(cuda_device, t_):
    prefix = carried_points(256 * t_, 500 + t_)
    want = cuda_msm.bucket_fold_plain(prefix, t_)
    cuda_msm.reset_launches()
    got = cuda_msm.bucket_fold(prefix.to(cuda_device), t_)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert cuda_msm.LAUNCHES["bucket_fold"] == 1


@pytest.mark.cuda
def test_explicit_cuda_backend_stays_cofactored_on_card(cuda_device, monkeypatch):
    """Under verify mode cofactorless a torsion-defect signature is refused
    by the default route (the host serial loop) and accepted by an explicit
    backend="cuda" request, which runs the card's cofactored ladder."""
    rng = np.random.default_rng(7)
    a = int.from_bytes(rng.bytes(32), "little") % ref.L
    r = int.from_bytes(rng.bytes(32), "little") % ref.L
    msg = b"torsion-on-card"
    a_enc = ref.point_compress(ref.point_mul(a, ref.BASE))
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.BASE), (0, ref.P - 1, 1, 0)))
    sig = r_enc + ((r + ref.sha512_mod_l(r_enc + a_enc + msg) * a) % ref.L).to_bytes(32, "little")
    monkeypatch.setattr(keys, "_VERIFY_MODE", keys._VERIFY_MODE)
    keys.set_verify_mode("cofactorless")
    rows = ([a_enc] * 3, [msg] * 3, [sig] * 3)
    assert not batch.verify_batch(*rows, device=cuda_device).any()
    assert batch.LAST_FLUSH["mode"] == "host_serial"
    assert batch.verify_batch(*rows, device=cuda_device, backend="cuda").all()
    assert batch.LAST_FLUSH["mode"] == "persig"


@pytest.mark.cuda
def test_card_device_launches_kernels_below_256_rows(cuda_device):
    """verify_batch(..., device=<card>) with 3 rows and no backend runs the
    card's per-signature ladder, as the caller asked: its kernels launch and
    the mask is ed25519_ref's; the same rows with no device take the host
    arm and launch none."""
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    msgs = [b"small-%d" % i for i in range(3)]
    pks = [ref.public_key(s) for s in seeds]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[1] = sigs[1][:32] + (1).to_bytes(32, "little")
    want = [ref.verify_cofactored(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert want == [True, False, True]
    cuda_fe.reset_launches()
    assert batch.verify_batch(pks, msgs, sigs, device=cuda_device).tolist() == want
    assert batch.LAST_FLUSH["path"] == "persig"
    assert all(cuda_fe.LAUNCHES[k] > 0 for k in ("padd", "pdbl", "fsquare_chain")), cuda_fe.LAUNCHES
    cuda_fe.reset_launches()
    assert batch.verify_batch(pks, msgs, sigs).tolist() == want
    assert batch.LAST_FLUSH["path"] == "cpu" and not any(cuda_fe.LAUNCHES.values())


@pytest.mark.cuda
def test_submits_in_flight_on_card(cuda_device):
    """Two 600-row submits queued on the card before either is finished,
    finished in reverse order: the honest one passes its combined check
    ("rlc-async"), the one with a bad row recovers by one per-signature
    pass ("persig-async"); then both as one FlushAccumulator flush, whose
    slices equal the separate masks."""
    seeds = [bytes([i + 1]) * 32 for i in range(16)]
    pks = [ref.public_key(seeds[i % 16]) for i in range(600)]
    msgs = [b"in-flight-%d" % i for i in range(600)]
    sigs = [ref.sign(seeds[i % 16], m) for i, m in enumerate(msgs)]
    bad = list(sigs)
    bad[77] = bad[77][:32] + (1).to_bytes(32, "little")
    h1 = batch.verify_batch_submit(pks, msgs, sigs, device=cuda_device)
    h2 = batch.verify_batch_submit(pks, msgs, bad, device=cuda_device)
    assert h1._call is not None and h2._call is not None
    m2 = batch.verify_batch_finish(h2)
    assert batch.LAST_FLUSH["path"] == "persig-async"
    m1 = batch.verify_batch_finish(h1)
    assert batch.LAST_FLUSH["path"] == "rlc-async"
    assert m1.all() and np.flatnonzero(~m2).tolist() == [77]
    with batch.accumulate_flushes(device=cuda_device) as acc:
        handles = [batch.verify_batch_submit(pks, msgs, s, device=cuda_device)
                   for s in (bad, sigs)]
    got = [batch.verify_batch_finish(h) for h in handles]
    assert acc.flush_count == 1
    assert got[0].tobytes() == m2.tobytes() and got[1].tobytes() == m1.tobytes()
