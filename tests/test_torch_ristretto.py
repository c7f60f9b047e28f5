"""The port's batched ristretto255 decode (tendermint_tpu_torch/ops/ristretto_torch.py
ristretto_decode, decode_rows) against the JAX package: its host decode
(tendermint_tpu/crypto/sr25519.py ristretto_decode) on seeded encodings of
random multiples of the basepoint, the identity and each kind of invalid
encoding, and its device decode (tendermint_tpu/ops/ristretto_jax.py) on
JAX-CPU, limb for limb. A `cuda` test holds the card decode against the plain
one (the same function on a CPU tensor) at 64, 4,096 and 4,097 lanes,
through fe25519.freeze (the fsquare_chain kernel writes canonical limbs).

Tolerance: zero. Coordinates are compared as field integers against the
host decode (whose point has Z = 1, as the port's) and re-encoded to the
input's canonical bytes; limbs are compared as integers against ristretto_jax.
The JAX package is imported inside the CPU tests only, so the `cuda` test
runs on a card host without JAX (`pytest --noconftest -m cuda`).
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519_ref as E
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import cuda_fe
from tendermint_tpu_torch.ops import fe25519 as fe
from tendermint_tpu_torch.ops import ristretto_torch as R

P = fe.P


def _multiples(m: int, seed: int) -> list:
    """Canonical encodings of m seeded multiples s0 B, (s0 + d) B, ...; the
    first is the identity (32 zero bytes)."""
    rng = np.random.default_rng(seed)
    step = E.point_mul(int(rng.integers(1, 1 << 62)), E.BASE)
    p = E.point_mul(int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)), E.BASE)
    out = [bytes(32)]
    for _ in range(m - 1):
        out.append(tsr.ristretto_encode(p))
        p = E.point_add(p, step)
    return out


def _rows(encs) -> np.ndarray:
    return np.stack([np.frombuffer(e, dtype=np.uint8) for e in encs])


def _held_against_host(encs, pts, ok) -> None:
    """Each lane against the JAX package's host decode: the same validity,
    the same (x, y, 1, t) as field integers, and the input's bytes again
    from ristretto_encode of the port's point."""
    from tendermint_tpu.crypto import sr25519 as jsr

    pts = pts.cpu()
    for j, e in enumerate(encs):
        want = jsr.ristretto_decode(e)
        assert bool(ok[j]) == (want is not None), j
        if want is None:
            continue
        got = tuple(fe.to_int(pts[c, :, j]) for c in range(4))
        assert got == tuple(c % P for c in want), j
        assert jsr.ristretto_encode(got) == e, j


def test_decode_seeded_multiples_and_identity():
    encs = _multiples(40, seed=1)
    pts, ok = R.ristretto_decode(torch.from_numpy(np.ascontiguousarray(_rows(encs).T)))
    assert pts.shape == (4, 20, 40) and bool(ok.all())
    _held_against_host(encs, pts, ok)
    assert tuple(fe.to_int(pts[c, :, 0]) for c in range(4)) == (0, 1, 1, 0)  # the identity


def _classify(s: int):
    """The host decode's failing checks for an even canonical s: (not
    was_square, t negative, y zero)."""
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((-(tsr.D * u1 % P * u1)) % P - u2_sqr) % P
    was_square, invsqrt = tsr._sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    x = tsr._ct_abs(2 * s % P * den_x % P)
    y = u1 * (invsqrt * den_x % P * v % P) % P
    return not was_square, bool(x * y % P & 1), y == 0


def _search(want, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    while True:
        s = (int.from_bytes(rng.bytes(32), "little") % P) & ~1
        if _classify(s) == want:
            return s.to_bytes(32, "little")


def _invalid(kind: str) -> bytes:
    valid = _multiples(3, seed=2)[2]
    if kind == "odd_s":
        return (int.from_bytes(valid, "little") | 1).to_bytes(32, "little")
    if kind == "s_ge_p":  # p + 1: even, below 2^255, not canonical
        return (P + 1).to_bytes(32, "little")
    if kind == "high_bit":
        return valid[:31] + bytes([valid[31] | 0x80])
    if kind == "non_square":
        return _search((True, False, False), seed=3)
    if kind == "negative_t":
        return _search((False, True, False), seed=4)
    if kind == "y_zero":  # s = p - 1: s^2 = 1, so u1 = 0 and y = 0
        return (P - 1).to_bytes(32, "little")
    raise KeyError(kind)


INVALID = ("odd_s", "s_ge_p", "high_bit", "non_square", "negative_t", "y_zero")


@pytest.mark.parametrize("kind", INVALID)
def test_decode_refuses_each_invalid_kind(kind):
    """The invalid encoding between two valid ones: its lane alone is
    refused, as the host decode refuses it; the others decode."""
    from tendermint_tpu.crypto import sr25519 as jsr

    bad = _invalid(kind)
    assert jsr.ristretto_decode(bad) is None
    encs = _multiples(2, seed=6) + [bad] + _multiples(2, seed=7)[1:]
    pts, ok = R.ristretto_decode(torch.from_numpy(np.ascontiguousarray(_rows(encs).T)))
    assert ok.tolist() == [True, True, False, True]
    _held_against_host(encs, pts, ok)


@pytest.mark.parametrize("m", [1, 63, 64, 65])
def test_decode_rows_pads_and_slices(m):
    """decode_rows pads to a power of two of at least 64 lanes with odd
    encodings and slices the result back to m lanes: the same lanes as an
    unpadded decode."""
    encs = _multiples(m, seed=10 + m)
    encs[-1] = _invalid("odd_s") if m > 1 else encs[-1]
    pts, ok = R.decode_rows(_rows(encs), "cpu")
    assert pts.shape == (4, 20, m) and ok.shape == (m,)
    _held_against_host(encs, pts, ok)
    whole, ok_w = R.ristretto_decode(torch.from_numpy(np.ascontiguousarray(_rows(encs).T)))
    assert torch.equal(pts, whole) and torch.equal(ok, ok_w)


def test_decode_equals_ristretto_jax_limb_for_limb():
    """One small batch (valid multiples, the identity, two invalid kinds)
    against ristretto_jax.ristretto_decode on JAX-CPU, eagerly: every limb
    of x, y, z, t and the ok mask."""
    from tendermint_tpu.ops import ristretto_jax
    from tendermint_tpu.ops.ed25519_jax import make_ctx

    encs = _multiples(6, seed=20) + [_invalid("odd_s"), _invalid("negative_t")]
    cols = np.ascontiguousarray(_rows(encs).T)
    jp, jok = ristretto_jax.ristretto_decode(make_ctx((len(encs),)), cols)
    pts, ok = R.ristretto_decode(torch.from_numpy(cols))
    assert np.asarray(jok).tolist() == ok.tolist()
    for c in range(4):
        want = np.asarray(jp[c]).astype(np.int64)
        assert np.array_equal(want, pts[c].numpy().astype(np.int64)), c


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fsquare_chain kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [64, 4096, 4097])
def test_card_decode_equals_plain(cuda_device, lanes):
    """ristretto_decode on the card (pow_p58's six fsquare_chain launches)
    against the same function on a CPU tensor (the plain chain), on valid
    multiples with every tenth lane invalid, through fe25519.freeze of each
    coordinate: the kernel's canonical limbs carry through the decode's
    later products."""
    encs = _multiples(64, seed=30)
    rows = _rows([encs[i % 64] if i % 10 else _invalid(INVALID[i % 6]) for i in range(lanes)])
    cols = torch.from_numpy(np.ascontiguousarray(rows.T))
    cuda_fe.reset_launches()
    got, ok = R.ristretto_decode(cols.to(cuda_device))
    assert cuda_fe.LAUNCHES["fsquare_chain"] == 6
    want, ok_w = R.ristretto_decode(cols)
    got, want = (torch.stack([fe.freeze(c) for c in t]) for t in (got.cpu(), want))
    assert torch.equal(got, want) and torch.equal(ok.cpu(), ok_w)
