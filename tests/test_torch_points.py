"""Port point ops (ops/cuda_fe.py plain versions, ops/ed25519_torch.py)
against the JAX package's msm_jax._padd / _pdbl_n / fe._pow2k (Pallas off,
as the JAX tests run them on the CPU) and against ed25519_ref integers.

Tolerance: zero. Limbs are compared for exact equality; points through
their canonical 32-byte encodings.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import fe25519 as jfe
from tendermint_tpu.ops import msm_jax
from tendermint_tpu.ops.ed25519_jax import Point as JPoint
from tendermint_tpu_torch.ops import cuda_fe, ed25519_torch as te
from tendermint_tpu_torch.ops import fe25519 as tfe

torch.set_num_threads(2)

LANES = 16


def _ref_points(seed: int, m: int):
    rng = np.random.default_rng(seed)
    return [ref.point_mul(int(rng.integers(1, 1 << 62)) * 7919 + k, ref.BASE) for k in range(m)]


def _enc(pts) -> np.ndarray:
    return np.stack([np.frombuffer(ref.point_compress(p), dtype=np.uint8) for p in pts]).T.copy()


def _carried_points(seed: int) -> torch.Tensor:
    """(4, 20, LANES): decompressed points (z = 1) and one plain doubling of
    them (carried, non-canonical limbs, z != 1), interleaved."""
    p, ok = te.decompress(torch.from_numpy(_enc(_ref_points(seed, LANES // 2))))
    assert bool(ok.all())
    d = cuda_fe.pdbl_plain(p, 1)
    return torch.stack([p, d], dim=-1).reshape(4, 20, LANES).contiguous()


def _jpoint(t: torch.Tensor):
    a = t.numpy()
    return JPoint(a[0], a[1], a[2], a[3])


def _same_point(jp, tp: torch.Tensor):
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in jp]), tp.numpy())


def _encodings(tp: torch.Tensor):
    return [bytes(c) for c in te.compress(tp).numpy().T]


P1 = _carried_points(11)
P2 = _carried_points(12)


def test_padd_plain_matches_jax_and_ref():
    got = cuda_fe.padd_plain(P1, P2)
    _same_point(msm_jax._padd(msm_jax.make_small_ctx(), _jpoint(P1), _jpoint(P2)), got)
    a = _encodings(P1)
    b = _encodings(P2)
    want = [ref.point_compress(ref.point_add(ref.point_decompress(x), ref.point_decompress(y)))
            for x, y in zip(a, b)]
    assert _encodings(got) == want


@pytest.mark.parametrize("times", [1, 8, 13])
def test_pdbl_plain_matches_jax_and_ref(times):
    got = cuda_fe.pdbl_plain(P1, times)
    _same_point(msm_jax._pdbl_n(msm_jax.make_small_ctx(), _jpoint(P1), times), got)
    want = [ref.point_compress(ref.point_mul(1 << times, ref.point_decompress(x)))
            for x in _encodings(P1)]
    assert _encodings(got) == want


@pytest.mark.parametrize("k", [1, 10, 16, 50])
def test_fsquare_chain_plain_matches_jax_and_ref(k):
    x = P1[1]
    got = cuda_fe.fsquare_chain_plain(x, k)
    np.testing.assert_array_equal(np.asarray(jfe._pow2k(x.numpy(), k)), got.numpy())
    for j in range(LANES):
        assert tfe.to_int(got[:, j]) == pow(tfe.to_int(x[:, j]), 1 << k, ref.P)


def test_point_add_double_compose_like_ref():
    """point_add / point_double (through the CPU wrappers) and the niels add
    agree with ed25519_ref on decompressed points."""
    pts = _ref_points(5, 8)
    p, _ = te.decompress(torch.from_numpy(_enc(pts)))
    two = te.point_double(p)
    three = te.point_add(two, p)
    assert _encodings(three) == [ref.point_compress(ref.point_mul(3, q)) for q in pts]
    yplus, yminus, xy2d = te._select_b_niels(torch.tensor([1, -2, 0, 8, -8, 3, 5, -1]))
    got = _encodings(te.add_niels(p, yplus, yminus, xy2d))
    digits = [1, -2, 0, 8, -8, 3, 5, -1]
    want = []
    for q, dgt in zip(pts, digits):
        b = ref.point_mul(abs(dgt), ref.BASE)
        if dgt < 0:
            b = (ref.P - b[0], b[1], b[2], ref.P - b[3])
        want.append(ref.point_compress(ref.point_add(q, b)))
    assert got == want


# Edge encodings (tests/test_ed25519_edge_vectors.py): the order-2 point
# (0, -1), the identity encoded non-canonically (y = p + 1), y = p, x = 0 with
# the sign bit set, a y with no curve point, and honest points.
T2_ENC = ref.point_compress((0, ref.P - 1, 1, 0))
IDENTITY_NONCANONICAL = (ref.P + 1).to_bytes(32, "little")
X0_SIGN1 = (1 | (1 << 255)).to_bytes(32, "little")
Y_P = ref.P.to_bytes(32, "little")


def _not_on_curve() -> bytes:
    for y in range(2, 100):
        if ref.point_decompress(y.to_bytes(32, "little")) is None:
            return y.to_bytes(32, "little")
    raise AssertionError


EDGE = [T2_ENC, IDENTITY_NONCANONICAL, X0_SIGN1, Y_P, _not_on_curve(),
        ref.point_compress(ref.IDENTITY), ref.point_compress(ref.BASE),
        ref.point_compress(ref.point_mul(12345, ref.BASE))]


def test_decompress_compress_edge_vectors():
    enc = np.stack([np.frombuffer(e, dtype=np.uint8) for e in EDGE]).T.copy()
    p, ok = te.decompress(torch.from_numpy(enc))
    want_ok = [ref.point_decompress(e) is not None for e in EDGE]
    assert ok.tolist() == want_ok
    assert want_ok == [True, False, False, False, False, True, True, True]
    out = _encodings(p)
    for e, good, o in zip(EDGE, want_ok, out):
        if good:
            assert o == ref.point_compress(ref.point_decompress(e))


def test_cpu_wrappers_take_plain_path_without_launches():
    cuda_fe.reset_launches()
    assert torch.equal(cuda_fe.padd(P1, P2), cuda_fe.padd_plain(P1, P2))
    assert torch.equal(cuda_fe.pdbl(P1, 3), cuda_fe.pdbl_plain(P1, 3))
    x = P1[0].contiguous()
    assert torch.equal(cuda_fe.fsquare_chain(x, 12), cuda_fe.fsquare_chain_plain(x, 12))
    assert cuda_fe.LAUNCHES == {"padd": 0, "pdbl": 0, "fsquare_chain": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_plain_on_card(cuda_device):
    p, q = P1.to(cuda_device), P2.to(cuda_device)
    cuda_fe.reset_launches()
    assert torch.equal(cuda_fe.padd(p, q).cpu(), cuda_fe.padd_plain(P1, P2))
    assert torch.equal(cuda_fe.pdbl(p, 13).cpu(), cuda_fe.pdbl_plain(P1, 13))
    x = P1[1].contiguous()
    got = cuda_fe.fsquare_chain(x.to(cuda_device), 50).cpu()
    assert torch.equal(got, tfe.freeze(cuda_fe.fsquare_chain_plain(x, 50)))  # canonical limbs
    assert cuda_fe.LAUNCHES == {"padd": 1, "pdbl": 1, "fsquare_chain": 1}
