"""Schedules of the port's redesigned kernels, replayed on the CPU.

B7 `fp381_mul_few_kernel` (csrc/bls_kernels.cu; `fp_mul_group` in
csrc/fp381.cuh): a numpy model of the kernel's schedule, a warp a product
(32 lanes of 2 limb positions): per lane, the column sums of the rotated
first factor with the suffix of blocks picked at block 31 - t; T = a b mod
2^396 by 2 carry passes; M = the low columns of T N' carried to exact
digits; the columns of a b + M p; C, the carry into column 33, from columns
30..32; fp_carry<3>'s passes in the rotated output layout. Each run of K
carry passes runs as the kernel runs it: every lane repeats the passes over
the K limbs it fetches from the lanes before it. The model is held against
the reference's fp381._mul_np and _mul_rows_loop and the port's
fp381_mul_plain, its digits against the reference schedule's m_i, and every
partial sum below 2^31, on seeded limbs and on adversarial ones (every limb
4096, the top one 15; zeros; canonical values; inputs whose M needs a
fourth carry pass, found by a seeded search over random limbs).

B2 `padd_quad_kernel` (csrc/point_kernels.cu): the per-thread operand
tables read from the source and the three rounds replayed with the plain
field ops, against cuda_fe.padd_plain and pallas_fe._padd_rows (the body of
the reference's Pallas padd) on edge points.

Routing: cuda_bls.fp381_mul_entry and cuda_fe.padd_entry at their thresholds.

Tolerance: zero (integer arithmetic, limb for limb).
"""

import os
import re

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import fp381 as JF
from tendermint_tpu.ops import pallas_fe
from tendermint_tpu_torch.ops import cuda_bls, cuda_fe
from tendermint_tpu_torch.ops import ed25519_torch as te
from tendermint_tpu_torch.ops import fe25519 as tfe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tendermint_tpu_torch", "csrc")
NL, RADIX, MASK = 33, 12, 4095
NPRIME = (-pow(JF.P, -1, 1 << 396)) % (1 << 396)
NPRIME_LIMBS = [(NPRIME >> (RADIX * i)) & MASK for i in range(NL)]


def _src(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# B7: the group schedule.


class GroupModel:
    """fp_mul_group, a warp of G = 32 lanes of L = 2 positions (N = G L)
    a product, vectorized over products; int64, so that a sum past 2^31
    shows. `vote=False` leaves M after its 3 carry passes, without the
    kernel's vote loop; `unsettled` marks the products whose M those 3
    passes left with a digit above 4095."""

    G, L = 32, 2
    N = G * L

    def __init__(self, vote: bool = True):
        self.vote = vote
        self.peak = 0
        self.unsettled = None

    def _seen(self, *vals):
        for v in vals:
            v = np.asarray(v)
            assert int(v.min()) >= 0
            self.peak = max(self.peak, int(v.max()))

    def product(self, X, Y, high: bool):
        """Low (and high) columns of X (N, n) times Y (33 values or rows):
        thread t reads X rotated by L t; term m of its column j pairs rot[m]
        with Y[(j - m) mod N]; block d = m // L of the terms goes low when
        d >= G - t, which the running sum picked after block G - 1 - t
        splits off."""
        G, L, N = self.G, self.L, self.N
        lo, hi = np.zeros_like(X), np.zeros_like(X)
        for t in range(G):
            e = [-1 if d == G - 1 - t else 0 for d in range(G)]
            rot = [X[(L * t + m) % N] for m in range(N)]
            for j in range(L):
                p0 = q0 = s = snap = 0
                for m in range(L):
                    if m <= j:
                        p0 = p0 + rot[m] * Y[j - m]
                    elif high and j - m + N < NL:
                        q0 = q0 + rot[m] * Y[j - m + N]
                    self._seen(p0, q0)
                for d in range(1, G):
                    any_term = False
                    for mp in range(L):
                        x = j - L * d - mp + N
                        if x < NL:
                            s = s + rot[L * d + mp] * Y[x]
                            any_term = True
                            self._seen(s)
                    if any_term:
                        snap = snap | (s & e[d])
                lo[L * t + j] = p0 + s - snap
                hi[L * t + j] = q0 + snap
                self._seen(lo[L * t + j], hi[L * t + j])
        return lo, hi

    def passes(self, x, K: int, off: int):
        """K carry passes in one exchange (fpg_passes): thread t, whose slot
        0 holds limb k0 = (L t - off) mod N, fetches the raw limbs k0 - K ..
        k0 - 1 from the threads before it (cyclically) and repeats the
        passes over them and its own slots."""
        G, L, N = self.G, self.L, self.N
        out = np.empty_like(x)
        for t in range(G):
            k0 = (L * t - off + N) % N
            e = []
            for i in range(K, 0, -1):
                hop, slot = 1 + (i - 1) // L, L - 1 - (i - 1) % L
                v = x[L * ((t - hop) % G) + slot]
                e.append(v if k0 - i >= 0 and (k0 - i) % N < NL else np.zeros_like(v))
            e += [x[L * t + s] for s in range(L)]
            for _ in range(K):
                c = [v >> RADIX for v in e]
                e = [e[0] & MASK] + [(e[q] & MASK) + c[q - 1] for q in range(1, K + L)]
                e = [v if (u := k0 - K + q) >= 0 and u % N < NL else np.zeros_like(v)
                     for q, v in enumerate(e)]
                self._seen(*e)
            for s in range(L):
                out[L * t + s] = e[K + s]
        return out

    def mul(self, a: np.ndarray, b: np.ndarray):
        """(r (33, n), M's digits (33, n)) for a, b (33, n)."""
        N = self.N
        pos = np.arange(N)[:, None]
        A = np.zeros((N, a.shape[1]), np.int64)
        A[:NL] = a
        lo, hi = self.product(A, [b[i] for i in range(NL)], True)
        x = self.passes(np.where(pos < NL, lo, 0), 2, 0)
        lo_m, _ = self.product(x, NPRIME_LIMBS, False)
        x = self.passes(np.where(pos < NL, lo_m, 0), 3, 0)
        self.unsettled = (x > MASK).any(axis=0)
        while self.vote and (x > MASK).any():
            x = self.passes(x, 1, 0)
        digits = x[:NL].copy()
        lo_p, hi_p = self.product(x, JF.P_LIMBS, True)
        lo, hi = lo + lo_p, hi + hi_p
        self._seen(lo, hi)
        # the low columns sum to a multiple of 2^396: C from columns 30..32
        c = ((lo[32] << 24) + (lo[31] << 12) + lo[30] + (1 << 36) - 1) >> 36
        exact = sum(int(v) << (RADIX * k) for k, v in enumerate(lo[:NL, 0]))
        assert exact % (1 << 396) == 0 and exact >> 396 == int(c[0])
        limb = (pos[:, 0] - NL + N) % N
        x = np.where((limb < NL)[:, None], np.where(pos >= NL, lo, hi), 0)
        x[NL % N] += c
        self._seen(x)
        x = self.passes(x, 3, NL)
        r = np.zeros((NL, a.shape[1]), np.int64)
        for p in range(N):
            if limb[p] < NL:
                r[limb[p]] = x[p]
        return r, digits


def reference_digits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The m_i of the reference's interleaved schedule (fp381._mul_np)."""
    prod = np.zeros((2 * NL, a.shape[1]), np.int64)
    for i in range(NL):
        prod[i : i + NL] += a[i][None] * b
    ms = []
    for i in range(NL):
        m = (prod[i] & MASK) * JF.PPRIME & MASK
        ms.append(m)
        prod[i : i + NL] += m[None] * np.array(JF.P_LIMBS)[:, None]
        prod[i + 1] += prod[i] >> RADIX
    return np.stack(ms)


def operands(n: int, seed: int):
    """Carried limbs (<= 4096, top limb < 16): seeded draws, then a run of
    every-limb-4096 / top-15 operands, zeros, and a mix of the two."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4097, size=(NL, n))
    b = rng.integers(0, 4097, size=(NL, n))
    a[32] = rng.integers(0, 16, n)
    b[32] = rng.integers(0, 16, n)
    a[:, :6] = 4096
    a[32, :6] = 15
    b[:, :4] = 4096
    b[32, :4] = 15
    a[:, 6:8] = 0
    b[:, 8:10] = np.where(rng.integers(0, 2, size=(NL, 2)), 4096, 0)
    b[32, 8:10] = 15
    return a.astype(np.int64), b.astype(np.int64)


def _limbs(v: int) -> list:
    return [(v >> (RADIX * i)) & MASK for i in range(NL)]


# Products whose M keeps a digit of 4096 after 3 carry passes (a carry
# rippling through digits of 4095): column k of a seeded draw of 200,000
# carried operand pairs (rng = default_rng(seed); a, then b, each
# integers(0, 4097, (33, n)) with its top row replaced by integers(0, 16, n)).
# In the first two the digit is limb 28; in the last three it is limb 32,
# whose carry is dropped, so without the vote loop M is 2^396 too large.
RIPPLE_MID = (
    ([4032, 648, 863, 3590, 3737, 2055, 2646, 772, 1441, 2949, 3583, 985, 3330, 1422, 243,
      663, 600, 2896, 1926, 2047, 1597, 496, 1184, 776, 195, 3958, 2657, 306, 4010, 4060,
      3189, 2823, 5],
     [7, 1899, 2771, 3057, 2086, 1489, 2024, 229, 3781, 2916, 2977, 2391, 1903, 1175, 779,
      2667, 2143, 3175, 3698, 1917, 3164, 1524, 3830, 2161, 1961, 3110, 3066, 1211, 1401,
      2946, 3668, 3179, 7]),  # seed 1, k 173,109
    ([3101, 1481, 143, 3661, 3427, 1124, 1729, 1942, 3270, 502, 2430, 2261, 3497, 1953, 537,
      1067, 481, 1451, 2892, 3609, 1636, 3710, 609, 2407, 2646, 2592, 2382, 3950, 3880, 3252,
      3605, 3078, 12],
     [1793, 314, 887, 3556, 2159, 3417, 2400, 3957, 654, 3662, 2734, 1051, 2571, 3096, 3726,
      3390, 2300, 1011, 1845, 213, 2791, 2352, 1759, 2055, 2396, 149, 1325, 619, 3689, 1490,
      2434, 1996, 9]),  # seed 1, k 184,620
)
RIPPLE_TOP = (
    ([623, 882, 93, 3130, 2624, 2866, 771, 3878, 1905, 927, 1117, 3864, 981, 20, 2133, 733,
      3297, 1288, 1567, 375, 3393, 3587, 3303, 1230, 1015, 3152, 1762, 2735, 3757, 931, 3088,
      3679, 4],
     [2135, 2060, 3561, 123, 201, 3038, 901, 4067, 2276, 3629, 3262, 1014, 3835, 2361, 3824,
      4038, 3370, 4083, 1973, 2114, 3803, 4072, 59, 2476, 1332, 3396, 1270, 1711, 867, 2676,
      2629, 2556, 10]),  # seed 2, k 45,235
    ([1588, 1537, 542, 846, 2701, 655, 1939, 140, 464, 64, 2455, 4029, 1774, 35, 3368, 82,
      3053, 328, 3550, 831, 3703, 2454, 3231, 3076, 888, 1902, 507, 1172, 3303, 2570, 1142,
      545, 11],
     [3012, 1630, 939, 3516, 2159, 3684, 3148, 1195, 3019, 309, 3739, 63, 801, 1035, 3109,
      3479, 3976, 1736, 870, 2254, 984, 1353, 944, 3579, 1097, 1749, 3095, 1659, 1630, 3014,
      1612, 368, 13]),  # seed 4, k 74,824
    ([1051, 422, 3738, 1643, 2286, 1601, 3743, 1093, 1960, 3456, 413, 291, 2590, 2051, 2765,
      2368, 2117, 3275, 3349, 3499, 3567, 480, 2368, 1062, 434, 3478, 2558, 3279, 3621, 1802,
      2250, 2563, 14],
     [3259, 877, 2155, 1958, 3159, 487, 870, 605, 1608, 2166, 1641, 962, 2336, 2058, 1387,
      2229, 3931, 2855, 650, 252, 2000, 1400, 1385, 3368, 2103, 463, 1226, 3096, 444, 2712,
      3985, 2809, 4]),  # seed 24, k 10,511
)


def _pairs(pairs):
    return tuple(np.array([p[i] for p in pairs], np.int64).T for i in range(2))


def case_operands(case: str):
    """(a, b), each (33, n), for one input case of the schedule test."""
    if case == "seeded":
        return operands(48, 381)
    if case == "seeded_other":
        rng = np.random.default_rng(7)
        a = rng.integers(0, 4097, size=(NL, 64))
        b = rng.integers(0, 4097, size=(NL, 64))
        a[32], b[32] = rng.integers(0, 16, 64), rng.integers(0, 16, 64)
        return a.astype(np.int64), b.astype(np.int64)
    if case == "all_4096":
        a = np.full((NL, 2), 4096, np.int64)
        a[32] = 15
        return a, a.copy()
    if case == "one_side_4096":
        a, b = operands(16, 11)
        b[:] = 4096
        b[32] = 15
        return a, b
    if case == "canonical":
        vals = [0, 1, JF.P - 1, JF.P - 2, (1 << 381) - 1, (1 << 396) % JF.P, JF.P >> 1]
        a = np.array([_limbs(v) for v in vals for _ in vals], np.int64).T
        b = np.array([_limbs(v) for _ in vals for v in vals], np.int64).T
        return a, b
    if case == "ripple_mid":
        return _pairs(RIPPLE_MID)
    if case == "ripple_top":
        return _pairs(RIPPLE_TOP)
    raise ValueError(case)


CASES = ("seeded", "seeded_other", "all_4096", "one_side_4096", "canonical", "ripple_mid",
         "ripple_top")


@pytest.mark.parametrize("case", CASES)
def test_group_schedule_equals_reference(case):
    a, b = case_operands(case)
    model = GroupModel()
    got, digits = model.mul(a, b)
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    want = JF._mul_np(a32, b32)
    assert np.array_equal(got, want)
    assert np.array_equal(want, JF.stack(JF._mul_rows_loop(JF.rows_of(a32), JF.rows_of(b32))))
    assert np.array_equal(got, cuda_bls.fp381_mul_plain(torch.from_numpy(a32),
                                                        torch.from_numpy(b32)).numpy())
    assert np.array_equal(digits, reference_digits(a, b))
    assert model.peak < 1 << 31
    assert bool(model.unsettled.all()) == case.startswith("ripple")


def test_m_needs_the_vote_loop_for_exact_digits():
    """3 carry passes leave a digit of M at 4096 on the ripple inputs; left
    so (no vote loop), the digits differ from the reference's m_i, and where
    the digit is the top one the result differs from the reference's limbs
    (M is 2^396 too large, the value p too large), so the kernel keeps the
    loop."""
    for pairs, result_differs in ((RIPPLE_MID, False), (RIPPLE_TOP, True)):
        a, b = _pairs(pairs)
        want = JF._mul_np(a.astype(np.int32), b.astype(np.int32))
        model = GroupModel(vote=False)
        got, digits = model.mul(a, b)
        assert bool(model.unsettled.all())
        assert not (digits == reference_digits(a, b)).all(axis=0).any()
        assert (got != want).any(axis=0).tolist() == [result_differs] * len(pairs)
        if result_differs:
            value = lambda r, k: sum(int(v) << (RADIX * i) for i, v in enumerate(r[:, k]))  # noqa: E731
            assert [value(got, k) - value(want, k) for k in range(len(pairs))] == \
                [JF.P] * len(pairs)


def test_ripple_limbs_are_the_seeded_draws():
    """The RIPPLE limbs are the columns of seeded draws that
    tests/test_torch_kernel_edges.py rebuilds for the card."""
    a, b = _pairs(RIPPLE_MID + RIPPLE_TOP)
    for k, (seed, col) in enumerate(((1, 173_109), (1, 184_620), (2, 45_235), (4, 74_824),
                                     (24, 10_511))):
        rng = np.random.default_rng(seed)
        n = 200_000
        da = rng.integers(0, 4097, size=(NL, n))
        db = rng.integers(0, 4097, size=(NL, n))
        da[32], db[32] = rng.integers(0, 16, n), rng.integers(0, 16, n)
        assert da[:, col].tolist() == a[:, k].tolist() and db[:, col].tolist() == b[:, k].tolist()


def test_shipped_split_and_nprime_table():
    """fp381.cuh's split is the model's (a warp of 2 positions a lane);
    FP_NPRIME is -p^-1 mod 2^396, its low limb the reference's PPRIME."""
    head = _src("fp381.cuh")
    g = int(re.search(r"#define FPG_G (\d+)", head).group(1))
    l_ = int(re.search(r"#define FPG_L (\d+)", head).group(1))
    assert (g, l_) == (GroupModel.G, GroupModel.L) and g * l_ >= NL
    body = re.search(r"FP_NPRIME\[FP_NL\] = \{([^}]*)\}", head).group(1)
    assert [int(v) for v in body.replace("\n", " ").split(",")] == NPRIME_LIMBS
    assert NPRIME_LIMBS[0] == JF.PPRIME


def test_fp381_mul_routes_by_product_count():
    """The Miller loop's launches (8-216 products) and the fold's top levels
    take the few-product kernel, the fold's wide levels the thread kernel;
    the wrapper counts a launch's products as groups x lanes; on the CPU both
    are the plain version and nothing is launched."""
    few = cuda_bls.FP_FEW_PRODUCTS
    assert 216 <= few < 6 * 8_192
    assert [cuda_bls.fp381_mul_entry(k) for k in (1, 8, 12, 18, 24, 36, 216, few)] == \
        ["tm_fp381_mul_few"] * 8
    assert [cuda_bls.fp381_mul_entry(k) for k in (few + 1, 6 * 8_192)] == ["tm_fp381_mul"] * 2
    a, b = operands(16, 5)
    ta = torch.from_numpy(np.stack([a.astype(np.int32)] * 4))
    tb = torch.from_numpy(np.stack([b.astype(np.int32)] * 4))
    cuda_bls.reset_launches()
    assert torch.equal(cuda_bls.fp381_mul(ta, tb), cuda_bls.fp381_mul_plain(ta, tb))
    assert cuda_bls.LAUNCHES == {"fp381_mul": 0, "fp12_sparse_mul": 0}
    src = _src("bls_kernels.cu")
    assert re.search(r"tm_fp381_mul_few\(.*?fp381_mul_few_kernel<<<", src, re.S)


# ---------------------------------------------------------------------------
# B2: padd_quad_kernel's rounds.


def _table(src: str, name: str):
    return [int(v) for v in re.search(name + r"\[4\] = \{([^}]*)\}", src).group(1).split(",")]


def _edge_points() -> torch.Tensor:
    """(4, 20, 16): the identity, the order-2 point (0, -1), the base point
    and honest multiples, each decompressed (z = 1) and doubled once by the
    plain pdbl (carried limbs, z != 1)."""
    pts = [ref.IDENTITY, (0, ref.P - 1, 1, 0), ref.BASE] + [
        ref.point_mul(k, ref.BASE) for k in (9, 12345, 2 ** 200 + 7, 2 ** 252 - 1, 77)]
    enc = np.stack([np.frombuffer(ref.point_compress(p), dtype=np.uint8) for p in pts]).T.copy()
    p, ok = te.decompress(torch.from_numpy(enc))
    assert bool(ok.all())
    return torch.cat([p, cuda_fe.pdbl_plain(p, 1)], dim=-1).contiguous()


def test_padd_quad_tables_replay_reference():
    """The rounds of padd_quad_kernel, thread by thread, from its tables:
    round 1 u = p[C] + S p.x (+ CC, carried) for threads 0 and 1, p[C] as
    loaded for 2 and 3 (v the same of q), a product each, then 2d for
    thread 2 and a doubling for thread 3; round 2 slot 4 + r = A + S B
    (+ CC, carried); round 3 output r = slot MA x slot MB. Against
    padd_plain and the reference kernel's body on P + Q, P + P and P + (-P)
    over the edge points, limb for limb."""
    src = _src("point_kernels.cu")
    tab = {k: _table(src, k) for k in ("AQ_C", "AQ_S", "AQ_R2A", "AQ_R2B", "AQ_R2S",
                                       "AQ_MA", "AQ_MB")}
    cc = re.search(r"PQ_CC\[FE_NL\] = \{([^}]*)\}", src).group(1)
    cc = torch.tensor([int(v) for v in cc.replace("\n", " ").split(",")], dtype=torch.int32)
    assert cc.tolist() == [int(c) + int(r) for c, r in zip(tfe._COMP, tfe._CORR)]
    cc = cc[:, None]

    def replay(p, q):
        slots = [None] * 8
        for r in range(4):
            u, v = p[tab["AQ_C"][r]], q[tab["AQ_C"][r]]
            if r < 2:
                sg = tab["AQ_S"][r]
                u = tfe.carry(u + sg * p[0] + (cc if sg < 0 else 0))
                v = tfe.carry(v + sg * q[0] + (cc if sg < 0 else 0))
            x = tfe.mul(u, v)
            if r == 2:
                x = tfe.mul(x, tfe.const("d2", p.device, x.dim()))
            if r == 3:
                x = tfe.mul_small(x, 2)
            slots[r] = x
        for r in range(4):
            sg = tab["AQ_R2S"][r]
            slots[4 + r] = tfe.carry(slots[tab["AQ_R2A"][r]] + sg * slots[tab["AQ_R2B"][r]]
                                     + (cc if sg < 0 else 0))
        return torch.stack([tfe.mul(slots[tab["AQ_MA"][r]], slots[tab["AQ_MB"][r]])
                            for r in range(4)])

    pts = _edge_points()
    n = pts.shape[-1]
    neg = pts.clone()
    neg[0] = tfe.neg(pts[0])
    neg[3] = tfe.neg(pts[3])
    for p, q in ((pts, pts.roll(3, -1).contiguous()), (pts, pts), (pts, neg)):
        got = replay(p, q)
        assert torch.equal(got, cuda_fe.padd_plain(p, q))
        rows = lambda t: tuple([t[c, i].numpy() for i in range(20)] for c in range(4))  # noqa: E731
        want = np.stack([np.stack([np.asarray(r) for r in c])
                         for c in pallas_fe._padd_rows(rows(p), rows(q))])
        assert np.array_equal(got.numpy(), want), n


def test_padd_routes_to_the_quad_kernel_above_few_lanes():
    """padd_entry keeps its threshold: PADD_FEW_LANES lanes or fewer take
    the warp kernel, more (the ladder's 16,384) tm_padd, which launches
    padd_quad_kernel."""
    few = cuda_fe.PADD_FEW_LANES
    assert few == 4096
    assert cuda_fe.padd_entry(few) == "tm_padd_lanes"
    assert [cuda_fe.padd_entry(k) for k in (few + 1, 16_384, 16_385, 24_576)] == ["tm_padd"] * 4
    src = _src("point_kernels.cu")
    assert re.search(r"int tm_padd\(.*?padd_quad_kernel<<<", src, re.S)
    assert "padd_kernel(" not in src.replace("padd_quad_kernel(", "").replace(
        "padd_lanes_kernel(", "")
