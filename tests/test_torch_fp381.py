"""Port BLS12-381 field arithmetic (tendermint_tpu_torch/ops/fp381.py and the
plain version of kernel B7 in ops/cuda_bls.py) against the JAX package's
numpy ops (tendermint_tpu/ops/fp381.py).

Tolerance: zero. The limbs must be equal limb for limb, not only mod p: the
carried form is not unique, and kernel B7 must reproduce the reference's
schedule exactly. Inputs are seeded numpy draws, plus the near-bound limbs of
tests/test_bls_kernels.py:65.
"""

import os
import re

import numpy as np
import pytest
import torch

from tendermint_tpu.ops import fp381 as JF
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.ops import cuda_bls
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops.cuda_bls import fp381_mul as mul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
rng = np.random.default_rng(381)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(48), "little") % F.P for _ in range(n)]


def block(n=40):
    return JF.mont_from_ints(rand_ints(n))


def t(a):
    return convert.fp381_to_tensor(a, "cpu")


def carried_block(n=40):
    """Limbs as the ops leave them: carried, not canonical (limbs at 4096
    occur), values up to a few p."""
    a, b = block(n), block(n)
    return JF.sub(JF.add(a, b), JF.mul(a, b))


def test_constants_equal_reference():
    for name in ("P", "R_ORDER", "RADIX", "NLIMBS", "MASK", "NBITS", "R_MONT", "R_INV",
                 "PPRIME", "P_LIMBS", "COMP_LIMBS", "CORR_LIMBS", "W384_LIMBS"):
        assert getattr(F, name) == getattr(JF, name), name


def test_cuda_header_tables_equal_reference():
    """csrc/fp381.cuh holds p, COMP + CORR, W384 (top limb - 1) and PPRIME
    as literals; they must be the reference's."""
    with open(os.path.join(ROOT, "tendermint_tpu_torch", "csrc", "fp381.cuh")) as f:
        src = f.read()

    def table(name):
        m = re.search(name + r"\[FP_NL\] = \{([^}]*)\}", src)
        return [int(v) for v in m.group(1).replace("\n", " ").split(",")]

    assert table("FP_P") == JF.P_LIMBS
    assert table("FP_COMP_CORR") == [k + c for k, c in zip(JF.COMP_LIMBS, JF.CORR_LIMBS)]
    assert table("FP_W384") == JF.W384_LIMBS[:-1] + [JF.W384_LIMBS[-1] - 1]
    assert int(re.search(r"#define FP_PPRIME (\d+)", src).group(1)) == JF.PPRIME


def test_host_conversions_equal_reference():
    xs = rand_ints(9) + [0, 1, F.P - 1]
    for x in xs:
        assert (F.from_int(x) == JF.from_int(x)).all()
        assert (F.mont_from_int(x) == JF.mont_from_int(x)).all()
        assert F.mont_to_int(JF.mont_from_int(x)) == x
        assert F.to_int(JF.from_int(x)) == JF.to_int(JF.from_int(x))
    blk = JF.mont_from_ints(xs)
    assert (F.mont_from_ints(xs) == blk).all()
    assert F.mont_to_ints(blk) == JF.mont_to_ints(blk) == xs
    assert F.mont_to_ints(t(blk)) == xs  # a tensor converts too


@pytest.mark.parametrize("op", ["add", "sub", "fold_top", "mul_small", "carry", "mul", "square"])
def test_field_op_equals_reference(op):
    a, b = carried_block(), block()
    ra, rb = JF.rows_of(a), JF.rows_of(b)
    want, got = {
        "add": (lambda: JF.add(a, b), lambda: F.add(t(a), t(b))),
        "sub": (lambda: JF.sub(a, b), lambda: F.sub(t(a), t(b))),
        "fold_top": (lambda: JF.stack(JF.fold_top_rows(ra)), lambda: F.fold_top(t(a))),
        "mul_small": (lambda: JF.stack(JF.mul_small_rows(ra, 12)), lambda: F.mul_small(t(a), 12)),
        "carry": (lambda: JF.stack(JF.carry_rows([x * 3 for x in rb], passes=2)),
                  lambda: F.carry(t(b) * 3, 2)),
        "mul": (lambda: JF.mul(a, b), lambda: mul(t(a), t(b))),
        "square": (lambda: JF.stack(JF.square_rows(ra)), lambda: mul(t(a), t(a))),
    }[op]
    w, g = want(), got()
    assert g.dtype == torch.int32
    assert np.array_equal(g.numpy(), w)


def test_mul_plain_equals_mul_np_and_loop_form():
    a, b = carried_block(64), carried_block(64)
    got = cuda_bls.fp381_mul_plain(t(a), t(b)).numpy()
    assert np.array_equal(got, JF._mul_np(a, b))
    assert np.array_equal(got, JF.stack(JF._mul_rows_loop(JF.rows_of(a), JF.rows_of(b))))
    xs, ys = F.mont_to_ints(a), F.mont_to_ints(b)
    assert F.mont_to_ints(got) == [x * y % F.P for x, y in zip(xs, ys)]


def test_int32_bounds_under_adversarial_limbs():
    """tests/test_bls_kernels.py:65: dense 4095 limbs under the value
    discipline neither overflow int32 nor mis-reduce, limb for limb."""
    v = (1 << 384) - 1
    a = v % F.P
    z = JF.mont_from_ints([a] * 8)
    want = JF.mul(JF.sub(JF.add(z, z), JF.mul(z, z)), JF.add(JF.mul(z, z), z))
    tz = t(z)
    got = mul(F.sub(F.add(tz, tz), mul(tz, tz)), F.add(mul(tz, tz), tz))
    assert np.array_equal(got.numpy(), want)
    assert F.mont_to_ints(got)[0] == ((2 * a - a * a) % F.P) * ((a * a + a) % F.P) % F.P


def test_stacked_products_equal_separate_ones():
    """A formula stage stacks independent products on a leading axis: each
    slice must equal its own product (the wrapper's group axis)."""
    a = np.stack([carried_block(16) for _ in range(3)])
    b = np.stack([block(16) for _ in range(3)])
    got = mul(t(a), t(b)).numpy()
    for g in range(3):
        assert np.array_equal(got[g], JF.mul(a[g], b[g]))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    cuda_bls.reset_launches()
    a = t(block(8))
    assert torch.equal(cuda_bls.fp381_mul(a, a), cuda_bls.fp381_mul_plain(a, a))
    assert cuda_bls.LAUNCHES == {"fp381_mul": 0, "fp12_sparse_mul": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fp381_mul_kernel_equals_plain_on_card(cuda_device):
    a = np.stack([carried_block(300) for _ in range(4)])
    b = np.stack([carried_block(300) for _ in range(4)])
    cuda_bls.reset_launches()
    got = cuda_bls.fp381_mul(t(a).to(cuda_device), t(b).to(cuda_device)).cpu()
    assert torch.equal(got, cuda_bls.fp381_mul_plain(t(a), t(b)))
    assert cuda_bls.LAUNCHES["fp381_mul"] == 1
    with pytest.raises(ValueError):
        cuda_bls.fp381_mul(t(a[0]).to(cuda_device), t(b).to(cuda_device))
