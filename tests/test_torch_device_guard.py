"""The kernel wrappers launch under the tensor's own card.

The C launchers size their grids and keep per-device state by the current
CUDA device (cudaGetDevice, csrc/msm_kernels.cu), and each wrapper in
ops/cuda_fe.py, ops/cuda_msm.py and ops/cuda_bls.py makes its tensor's card
current around the launch (cuda_fe._on_card). With two cards or more, padd
and uptree launched on tensors on cuda:1, while cuda:0 is the current
device, must equal their plain versions limb for limb, and the current
device must be cuda:0 again afterwards.

Tolerance: zero. The test needs two CUDA cards and skips without them. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_guard.py
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import cuda_fe, cuda_msm, msm_torch
from tendermint_tpu_torch.ops.msm_geometry import chunk_geometry, tree_written_positions


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (the guard matters only off the current card)")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def seeded_points(m: int, rng) -> torch.Tensor:
    """m seeded multiples of the basepoint, decompressed on the CPU: (4, 20, m)."""
    p = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    step = ref.point_mul(int(rng.integers(1, 1 << 62)), ref.BASE)
    enc = []
    for _ in range(m):
        enc.append(np.frombuffer(ref.point_compress(p), dtype=np.uint8))
        p = ref.point_add(p, step)
    pts, ok = msm_torch.decompress_rows(np.stack(enc), device="cpu")
    assert bool(ok.all())
    return pts.contiguous()


@pytest.mark.cuda
def test_padd_and_uptree_launch_on_the_tensors_card(second_card):
    rng = np.random.default_rng(1)
    ch, t_, n = 1024, 2, 2048
    pts = seeded_points(n, rng)
    q = torch.roll(pts, 1, dims=-1).contiguous()
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(t_)]).astype(np.int32))
    cuda_fe.reset_launches()
    cuda_msm.reset_launches()

    got = cuda_fe.padd(pts.to(second_card), q.to(second_card))
    assert got.device == second_card and torch.cuda.current_device() == 0
    assert torch.equal(got.cpu(), cuda_fe.padd_plain(pts, q))

    lvl0, tree = cuda_msm.uptree(pts.to(second_card), perm.to(second_card), ch)
    assert torch.cuda.current_device() == 0
    want0, want_tree = cuda_msm.uptree_plain(pts, perm, ch)
    pos = torch.from_numpy(tree_written_positions(ch))
    nchunks = t_ * n // ch

    def written(t):
        return t.reshape(4, 20, nchunks, chunk_geometry(ch).rows_out * 128)[..., pos]

    assert torch.equal(lvl0.cpu(), want0)
    assert torch.equal(written(tree.cpu()), written(want_tree))
    assert cuda_fe.LAUNCHES["padd"] == 1 and cuda_msm.LAUNCHES["uptree"] == 1
