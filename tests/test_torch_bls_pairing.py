"""Port Fp2 / Fp12 tower arithmetic, Miller-loop lines and the batched Miller
loop (tendermint_tpu_torch/ops/pairing_torch.py and the plain version of
kernel B8 in ops/cuda_bls.py) against the JAX package's numpy forms in
tendermint_tpu/ops/pallas_bls.py, which are the Pallas kernels' plain
reference in the JAX package's own tier-1 tests, and against bls_ref.

Tolerance: zero. Every tower op, line and step must equal pallas_bls's limb
for limb on seeded inputs; the full Miller loop must equal bls_ref.pairing
after the final exponentiation (the two loops differ by Fp2-subfield factors,
which the final exponentiation kills). The limb-for-limb comparison of the
whole loop with the 26 s numpy twin is slow-lane, like
tests/test_bls_kernels.py:265.
"""

import os
import re

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls_ref as JB
from tendermint_tpu.ops import fp381 as JF
from tendermint_tpu.ops import pallas_bls as PB
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import bls_ref as B
from tendermint_tpu_torch.ops import cuda_bls
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops import pairing_torch as PT
from tendermint_tpu_torch.ops import tower

torch.set_num_threads(2)

N = 3
rng = np.random.default_rng(12)


def rand_rows(n=N):
    return JF.rows_of(JF.mont_from_ints([int.from_bytes(rng.bytes(48), "little") % JF.P
                                         for _ in range(n)]))


def r2(n=N):
    return (rand_rows(n), rand_rows(n))


def t2(r):
    return convert.fp2_rows_to_tensor(r, "cpu")


def t12(f):
    return convert.fp12_rows_to_tensor(f, "cpu")


def tf(rows):
    return torch.from_numpy(np.stack(rows))


def same(got, want_tensor):
    assert got.dtype == torch.int32
    assert torch.equal(got, want_tensor)


@pytest.mark.parametrize("op", ["add2", "sub2", "mul2", "square2", "mul2_small",
                                "mul2_by_xi", "mul2_fp", "neg2"])
def test_fp2_op_equals_pallas_bls(op):
    a, b, s = r2(), r2(), rand_rows()
    want, got = {
        "add2": (lambda: PB.add2(a, b), lambda: PT.add2(t2(a), t2(b))),
        "sub2": (lambda: PB.sub2(a, b), lambda: PT.sub2(t2(a), t2(b))),
        "mul2": (lambda: PB.mul2(a, b), lambda: PT.mul2(t2(a), t2(b))),
        "square2": (lambda: PB.square2(a), lambda: PT.mul2(t2(a), t2(a))),
        "mul2_small": (lambda: PB.mul2_small(a, 12), lambda: PT.mul2_small(t2(a), 12)),
        "mul2_by_xi": (lambda: PB.mul2_by_xi(a), lambda: PT.mul2_by_xi(t2(a))),
        "mul2_fp": (lambda: PB.mul2_fp(a, s), lambda: PT.mul2_fp(t2(a), tf(s))),
        "neg2": (lambda: PB.neg2(a), lambda: PT.neg2(t2(a))),
    }[op]
    same(got(), t2(want()))


def test_const2_and_one12_equal_pallas_bls():
    same(PT._const2(PT.XI_INV_C0, PT.XI_INV_C1, N, "cpu"),
         t2(PB._const2(PB.XI_INV_C0, PB.XI_INV_C1, (N,))))
    same(PT.one12(N, "cpu"), t12(PB.one12((N,))))


def test_padd2_equals_pallas_bls():
    p, q = (r2(), r2(), r2()), (r2(), r2(), r2())
    same(PT.padd2(t12(p), t12(q)), t12(PB.padd2(p, q)))
    same(PT.padd2(t12(p), t12(p)), t12(PB.padd2(p, p)))


def test_mul12_conj12_equal_pallas_bls():
    fa, fb = [r2() for _ in range(6)], [r2() for _ in range(6)]
    same(PT.mul12(t12(fa), t12(fb)), t12(PB.mul12(fa, fb)))
    same(PT.square12(t12(fa)), t12(PB.square12(fa)))
    same(PT.conj12(t12(fa)), t12(PB.conj12(fa)))


def test_fp12_sparse_mul_plain_equals_pallas_bls():
    f, line = [r2() for _ in range(6)], tuple(r2() for _ in range(3))
    want = t12(PB.sparse_mul12(f, line))
    same(cuda_bls.fp12_sparse_mul_plain(t12(f), t12(line)), want)
    cuda_bls.reset_launches()
    same(PT.sparse_mul12(t12(f), t12(line)), want)  # the wrapper, on a CPU tensor
    assert cuda_bls.LAUNCHES == {"fp381_mul": 0, "fp12_sparse_mul": 0}


def _kernel_sparse_terms():
    """SPARSE_TERMS[11][3][2] as written in csrc/bls_kernels.cu: per w^k the
    (f index, line index) terms, -1 padded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tendermint_tpu_torch", "csrc", "bls_kernels.cu")) as fh:
        src = fh.read()
    body = re.search(r"SPARSE_TERMS\[11\]\[3\]\[2\] = \{(.*?)\n\};", src, re.S).group(1)
    vals = [int(v) for v in re.findall(r"-?\d+", re.sub(r"//[^\n]*", "", body))]
    table = np.array(vals).reshape(11, 3, 2)
    return [[(int(fi), int(li)) for fi, li in row if fi >= 0] for row in table]


def test_sparse_mul_kernel_schedule_table_follows_reference_loop_order(monkeypatch):
    """Kernel B8 folds its products by the SPARSE_TERMS table of
    bls_kernels.cu. Traced symbolically, pallas_bls.sparse_mul12's loops
    (line coefficient j in (0, 3, 5) outer, f index i inner) build each
    output from the table's terms in the table's order and association; the
    table equals the plain version's (tower.SPARSE_TERMS, product 6 l + i);
    and the kernel's phases replayed with the plain field ops over the table
    (products 3 (6 l + i) + s, Karatsuba finish, then the fold) equal
    sparse_mul12 limb for limb."""
    terms = _kernel_sparse_terms()
    monkeypatch.setattr(PB, "mul2", lambda a, b: ("mul", a, b))
    monkeypatch.setattr(PB, "add2", lambda a, b: ("add", a, b))
    monkeypatch.setattr(PB, "mul2_by_xi", lambda a: ("xi", a))
    traced = PB.sparse_mul12([("f", i) for i in range(6)], tuple(("c", l) for l in range(3)))
    monkeypatch.undo()

    def acc(k):
        e = None
        for fi, li in terms[k]:
            t = ("mul", ("f", fi), ("c", li))
            e = t if e is None else ("add", e, t)
        return e

    assert traced == [("add", acc(k), ("xi", acc(k + 6))) for k in range(5)] + [acc(5)]
    assert [[6 * li + fi for fi, li in row] for row in terms] == tower.SPARSE_TERMS

    f, line = [r2() for _ in range(6)], tuple(r2() for _ in range(3))
    tf_, tl = t12(f), t12(line)
    ops = [torch.stack([x[..., 0, :, :], x[..., 1, :, :], F.add(x[..., 0, :, :], x[..., 1, :, :])], 1)
           for x in (tf_, tl)]  # staged operands (c0, c1, c0 + c1) per Fp2
    prods = [cuda_bls.fp381_mul_plain(ops[0][i], ops[1][l]) for l in range(3) for i in range(6)]
    fin = [torch.stack([F.sub(p[0], p[1]), F.sub(p[2], F.add(p[0], p[1]))]) for p in prods]
    comp = [None] * 11
    for k in range(11):
        for fi, li in terms[k]:
            comp[k] = fin[6 * li + fi] if comp[k] is None else F.add(comp[k], fin[6 * li + fi])
    out = [F.add(comp[k], tower.mul2_by_xi(comp[k + 6])) for k in range(5)] + [comp[5]]
    same(torch.stack(out), t12(PB.sparse_mul12(f, line)))


def test_lines_equal_pallas_bls():
    T = (r2(), r2(), r2())
    Qx, Qy, xP, yP = r2(), r2(), rand_rows(), rand_rows()
    xi = PB._const2(PB.XI_INV_C0, PB.XI_INV_C1, (N,))
    same(PT.line_dbl(t12(T), tf(xP), tf(yP), t2(xi)), t12(PB.line_dbl(T, xP, yP, xi)))
    same(PT.line_add(t12(T), t2(Qx), t2(Qy), tf(xP), tf(yP), t2(xi)),
         t12(PB.line_add(T, Qx, Qy, xP, yP, xi)))


def _curve_lanes():
    g1 = [JB._jac_to_affine(JB._jac_mul(JB.G1_GEN, k)) for k in (5, 17)]
    g2 = [JB._jac_to_affine(JB._jac_mul(JB.G2_GEN, k)) for k in (9, 31)]
    rows = lambda vals: JF.rows_of(JF.mont_from_ints(vals))  # noqa: E731
    Qx = (rows([q[0].c0 for q in g2]), rows([q[0].c1 for q in g2]))
    Qy = (rows([q[1].c0 for q in g2]), rows([q[1].c1 for q in g2]))
    xP, yP = rows([p[0].v for p in g1]), rows([p[1].v for p in g1])
    return Qx, Qy, xP, yP, g1, g2


def test_one_doubling_and_one_addition_step_equal_pallas_bls():
    """The Miller loop's two step kinds on real curve points, as
    miller_loop_rows runs them, from f = 1 and T = Q."""
    Qx, Qy, xP, yP, _, _ = _curve_lanes()
    n = 2
    one2 = PB._const2(1, 0, (n,))
    xi = PB._const2(PB.XI_INV_C0, PB.XI_INV_C1, (n,))
    T = (Qx, Qy, one2)
    f = PB.one12((n,))
    f_d = PB.sparse_mul12(PB.square12(f), PB.line_dbl(T, xP, yP, xi))
    T_d = PB.padd2(T, T)
    f_a = PB.sparse_mul12(f_d, PB.line_add(T_d, Qx, Qy, xP, yP, xi))
    T_a = PB.padd2(T_d, (Qx, Qy, one2))

    tT, txP, tyP, txi = t12(T), tf(xP), tf(yP), t2(xi)
    g_d = PT.sparse_mul12(PT.square12(PT.one12(n, "cpu")), PT.line_dbl(tT, txP, tyP, txi))
    gT_d = PT.padd2(tT, tT)
    same(g_d, t12(f_d))
    same(gT_d, t12(T_d))
    g_a = PT.sparse_mul12(g_d, PT.line_add(gT_d, t2(Qx), t2(Qy), txP, tyP, txi))
    same(g_a, t12(f_a))
    same(PT.padd2(gT_d, t12((Qx, Qy, one2))), t12(T_a))


def wcoeffs(x):
    """An Fp12 of either bls_ref (the port's copy or the JAX package's) as
    ints, so the two packages' values compare."""
    return [(c.c0, c.c1) for c in x.wcoeffs()]


def test_miller_loop_rows_after_final_exponentiation_equals_pairing():
    _, _, _, _, g1, g2 = _curve_lanes()
    f = PT.miller_loop_rows([(q[0].c0, q[0].c1, q[1].c0, q[1].c1) for q in g2],
                            [(p[0].v, p[1].v) for p in g1], device="cpu")
    assert f.shape == (6, 2, 33, 2)
    for lane, (k1, k2) in enumerate(((5, 9), (17, 31))):
        want = JB.pairing(JB._jac_mul(JB.G1_GEN, k1), JB._jac_mul(JB.G2_GEN, k2))
        assert wcoeffs(B.final_exponentiation(PT.fp12_rows_to_ref(f, lane))) == wcoeffs(want)


def test_miller_product_verdict_equals_bls_ref_pairings_are_one():
    """The path's check, the card's Miller product then one host final
    exponentiation: e(-g1, [ab] g2) e([a] g1, [b] g2) == 1; a wrong factor
    is not; an identity pair contributes 1 (one Miller lane fewer). Each
    verdict equals the JAX package's bls_ref.pairings_are_one on the same
    pairs."""
    a, b = 7, 11

    def cases(R):
        good = [(R._jac_neg(R.G1_GEN), R._jac_mul(R.G2_GEN, a * b)),
                (R._jac_mul(R.G1_GEN, a), R._jac_mul(R.G2_GEN, b))]
        bad = [good[0], (R._jac_mul(R.G1_GEN, a + 1), good[1][1])]
        ident = [(R._jac_neg(R.G1_GEN), R.G2_IDENTITY), good[1]]
        return good, bad, ident

    for pairs, jpairs, want in zip(cases(B), cases(JB), (True, False, False)):
        got = B.final_exponentiation(PT.miller_product(pairs, device="cpu")).is_one()
        assert got is JB.pairings_are_one(jpairs) is want


@pytest.mark.slow
def test_miller_loop_rows_limb_for_limb_equals_pallas_bls():
    Qx, Qy, xP, yP, g1, g2 = _curve_lanes()
    q = [(c[0].c0, c[0].c1, c[1].c0, c[1].c1) for c in g2]
    p = [(c[0].v, c[1].v) for c in g1]
    same(PT.miller_loop_rows(q, p, device="cpu"), t12(PB.miller_loop_rows(q, p)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fp12_sparse_mul_kernel_equals_plain_on_card(cuda_device):
    f, line = t12([r2(200) for _ in range(6)]), t12(tuple(r2(200) for _ in range(3)))
    cuda_bls.reset_launches()
    got = cuda_bls.fp12_sparse_mul(f.to(cuda_device), line.to(cuda_device)).cpu()
    same(got, cuda_bls.fp12_sparse_mul_plain(f, line))
    assert cuda_bls.LAUNCHES["fp12_sparse_mul"] == 1
