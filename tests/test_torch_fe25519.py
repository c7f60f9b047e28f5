"""Port field ops (tendermint_tpu_torch/ops/fe25519.py) against the JAX
package's fe25519 ops, called eagerly, on the same seeded numpy limbs.

Tolerance: zero. Every comparison is exact integer equality of the limbs
(bit-identical), and freeze / to_bytes must match ed25519_ref integers.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import fe25519 as jfe
from tendermint_tpu_torch.ops import fe25519 as tfe

torch.set_num_threads(2)

P = ref.P
LANES = 24


def _limbs(v: int) -> np.ndarray:
    """Non-reduced limbs of v < 2^260 (radix 2^13, no mod p)."""
    return np.array([(v >> (13 * i)) & 8191 for i in range(20)], dtype=np.int32)


def _inputs(seed: int) -> np.ndarray:
    """(20, LANES) carried limbs: random columns plus 0, p-1, p, 2^255-1 and
    columns at the carried bounds (limb 0 = 2^13 + 607, others 2^13)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8192, size=(20, LANES)).astype(np.int32)
    x[0] += rng.integers(0, 608, size=LANES).astype(np.int32)
    edge = [_limbs(0), _limbs(P - 1), _limbs(P), _limbs(2**255 - 1)]
    bound = np.full(20, 8192, dtype=np.int32)
    bound[0] = 8192 + 607
    edge += [bound, np.where(np.arange(20) % 2 == 0, bound, 0).astype(np.int32)]
    for j, col in enumerate(edge):
        x[:, j] = col
    return x


def _value(limbs: np.ndarray, j: int) -> int:
    return sum(int(limbs[i, j]) << (13 * i) for i in range(20)) % P


X = _inputs(1)
Y = _inputs(2)[:, ::-1].copy()


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype or (a.dtype == np.bool_ and b.dtype == np.bool_)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_bit_identical(op):
    got = getattr(tfe, op)(torch.from_numpy(X), torch.from_numpy(Y))
    _same(getattr(jfe, op)(X, Y), got)
    for j in range(LANES):
        want = {"add": _value(X, j) + _value(Y, j), "sub": _value(X, j) - _value(Y, j),
                "mul": _value(X, j) * _value(Y, j)}[op] % P
        assert _value(got.numpy(), j) == want


@pytest.mark.parametrize("op", ["carry", "neg", "square", "freeze"])
def test_unary_ops_bit_identical(op):
    _same(getattr(jfe, op)(X), getattr(tfe, op)(torch.from_numpy(X)))


def test_mul_small_select_bit_eq_is_zero():
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    for k in (2, 121666, (1 << 17) - 1):
        _same(jfe.mul_small(X, k), tfe.mul_small(x, k))
    cond = np.arange(LANES) % 3 == 0
    _same(jfe.select(cond, X, Y), tfe.select(torch.from_numpy(cond), x, y))
    fx = jfe.freeze(X)
    for i in (0, 1, 12, 13, 254):
        _same(jfe.bit(fx, i), tfe.bit(tfe.freeze(x), i))
    _same(jfe.eq(X, X), tfe.eq(x, x))
    _same(jfe.eq(X, Y), tfe.eq(x, y))
    _same(jfe.is_zero(X), tfe.is_zero(x))
    assert bool(tfe.is_zero(x)[0]) and bool(tfe.is_zero(x)[2])  # 0 and p


def test_freeze_and_to_bytes_match_integers():
    b = tfe.to_bytes(torch.from_numpy(X))
    _same(jfe.to_bytes(X), b)
    fr = tfe.freeze(torch.from_numpy(X)).numpy()
    for j in range(LANES):
        v = _value(X, j)
        assert int.from_bytes(b[:, j].numpy().tobytes(), "little") == v
        assert sum(int(fr[i, j]) << (13 * i) for i in range(20)) == v


def test_from_bytes_and_canonical_bytes():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, size=(32, LANES), dtype=np.uint8)
    for j, v in enumerate([0, P - 1, P, P + 1, 2**255 - 1, 2**256 - 1, 2**255 + 5]):
        raw[:, j] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    t = torch.from_numpy(raw)
    for mask in (True, False):
        _same(jfe.from_bytes(raw, mask_high_bit=mask), tfe.from_bytes(t, mask_high_bit=mask))
    _same(jfe.is_canonical_bytes(raw), tfe.is_canonical_bytes(t))
    canon = tfe.is_canonical_bytes(t).numpy()
    for j in range(LANES):
        assert canon[j] == ((int.from_bytes(raw[:, j].tobytes(), "little") & (2**255 - 1)) < P)


@pytest.mark.parametrize("k", [2, 13, 50])
def test_pow2k_bit_identical(k):
    _same(jfe._pow2k(X, k), tfe._pow2k(torch.from_numpy(X), k))


@pytest.mark.parametrize("op", ["inv", "pow_p58"])
def test_inversion_chains_bit_identical(op):
    got = getattr(tfe, op)(torch.from_numpy(X))
    _same(getattr(jfe, op).__wrapped__(X), got)  # eager: no whole-chain XLA compile
    e = P - 2 if op == "inv" else (P - 5) // 8
    for j in range(LANES):
        assert _value(got.numpy(), j) == pow(_value(X, j), e, P)
