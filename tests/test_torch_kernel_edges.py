"""Kernels B5 (fenwick_reduce) and B8 (fp12_sparse_mul) against their plain
torch versions at edge shapes, on the card.

B8 at 1, 2, 3, 129 and 16,384 lanes: a block holds 2 lanes, so these cover
a half block, one block, a ragged last block and many blocks. B5 at Kf = 1,
2, 12 and 16 nodes a lane and T = 1, 2 and 32 windows (256 T lanes): a
block takes 32 neighbouring buckets of one window, and Kf = 1 and 2 are the
kernel's no-add and single-add cases. The storage holds seeded carried limbs
and each window's last top-tree lane is the identity point, which the
indices name among random nodes of all three segments.

Tolerance: zero (integer arithmetic, limb for limb). Every test needs a
CUDA card and skips without one. The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed, without
tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_edges.py
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.ops import cuda_bls, cuda_msm
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
