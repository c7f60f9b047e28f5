"""Port verify_batch (tendermint_tpu_torch/crypto/batch.py, device="cpu")
against the JAX package's verify_batch(..., backend="cpu") on the same rows.

Tolerance: zero. The two bool masks must be byte-identical. 200 rows run the
per-signature ladder (backend="cuda"); 600 rows run the RLC flush (lane bucket 1024), first
with the plain kernel and then, on the same keys, the cached-A kernel.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.crypto.keys import gen_ed25519
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.ops import msm_torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


@pytest.fixture(autouse=True)
def _default_arm(monkeypatch):
    """The reference's calls name backend="cpu"; the port's take its default
    arm, which TMTPU_CRYPTO_BACKEND (set to "cpu" by other test modules at
    import) would otherwise pick."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    tbatch.reset_a_cache()
    yield
    tbatch.reset_a_cache()


def make_rows(n: int, seed: int = 0):
    privs = [gen_ed25519(bytes([seed, i % 256, i // 256]) + bytes(29)) for i in range(n)]
    pks = [p.pub_key().bytes() for p in privs]
    msgs = [b"row-%d-%d" % (seed, i) for i in range(n)]
    return pks, msgs, [p.sign(m) for p, m in zip(privs, msgs)]


def _flip(sig: bytes, at: int = 40) -> bytes:
    s = bytearray(sig)
    s[at] ^= 0x01
    return bytes(s)


NOT_ON_CURVE = next(y.to_bytes(32, "little") for y in range(2, 100)
                    if ref.point_decompress(y.to_bytes(32, "little")) is None)
T2_ENC = ref.point_compress((0, ref.P - 1, 1, 0))


def _torsion_row(msg: bytes = b"torsion-row"):
    """A forged signature under the order-2 pubkey: [s]B - [h]A - R is pure
    torsion, so the cofactored predicate ACCEPTS it on every path."""
    r = 5
    r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
    return T2_ENC, msg, r_enc + r.to_bytes(32, "little")


def _case(name: str, n: int):
    pks, msgs, sigs = make_rows(n, seed=n % 251)
    pks, msgs, sigs = list(pks), list(msgs), list(sigs)
    if name == "one_bad":
        sigs[n // 3] = _flip(sigs[n // 3])
    elif name == "two_bad":
        sigs[1] = _flip(sigs[1], 3)
        msgs[n - 2] = msgs[n - 2] + b"!"
    elif name == "all_bad":
        sigs = [_flip(s) for s in sigs]
    elif name == "invalid_encodings":
        pks[2] = (ref.P + 1).to_bytes(32, "little")  # non-canonical A
        pks[5] = NOT_ON_CURVE  # A off the curve
        sigs[7] = NOT_ON_CURVE + sigs[7][32:]  # R off the curve
        sigs[9] = ref.P.to_bytes(32, "little") + sigs[9][32:]  # non-canonical R
        pks[11] = pks[11][:31]  # short key
    elif name == "s_ge_L":
        s = int.from_bytes(sigs[4][32:], "little")
        sigs[4] = sigs[4][:32] + (s + ref.L).to_bytes(32, "little")
        sigs[6] = sigs[6][:32] + ref.L.to_bytes(32, "little")
    elif name == "torsion":
        pks[8], msgs[8], sigs[8] = _torsion_row()
    return pks, msgs, sigs


def _check(pks, msgs, sigs, backend=None):
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu")
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend=backend)
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return got


@pytest.mark.parametrize(
    "name", ["honest", "one_bad", "two_bad", "all_bad", "invalid_encodings", "s_ge_L", "torsion"]
)
def test_persig_path_matches_jax(name):
    """200 rows on the card arm (backend="cuda"): a call that names no
    backend runs fewer than 256 rows on the host, as the reference's does."""
    mask = _check(*_case(name, 200), backend="cuda")
    assert tbatch.LAST_FLUSH["mode"] == "persig"
    if name in ("honest", "torsion"):
        assert mask.all()


def test_rlc_honest_then_cached_matches_jax():
    rows = _case("honest", 600)
    assert _check(*rows).all()
    assert tbatch.LAST_FLUSH["mode"] == "plain" and tbatch.LAST_FLUSH["lanes"] == 2048
    assert tbatch.LAST_FLUSH["fused"] is True and "recovery_s" not in tbatch.LAST_FLUSH
    assert _check(*rows).all()  # second call on the same set: cached A
    assert tbatch.LAST_FLUSH["mode"] == "cached" and "recovery_s" not in tbatch.LAST_FLUSH


def test_cached_flush_survives_a_cache_reset_mid_submit(monkeypatch):
    """Another thread's fill resets the full A cache after this flush chose
    the cached-A kernel and before it built its A block: the flush still
    reads its own keys' coordinates and passes without recovery."""
    rows = _case("honest", 600)
    assert _check(*rows).all()
    monkeypatch.setattr(tbatch, "_A_CACHE_MAX", 600)
    other = make_rows(1, seed=99)[0][0]
    enc = np.frombuffer(other, dtype=np.uint8).reshape(1, 32)
    scalars = tbatch._rlc_scalars_fast

    def scalars_then_reset(*a):
        pts, ok = msm_torch.decompress_rows(enc, device="cpu")
        tbatch.fill_a_cache(enc, pts, ok)  # 601st key: full reset
        return scalars(*a)

    monkeypatch.setattr(tbatch, "_rlc_scalars_fast", scalars_then_reset)
    assert _check(*rows).all()
    assert tbatch.LAST_FLUSH["mode"] == "cached" and "recovery_s" not in tbatch.LAST_FLUSH
    assert list(tbatch._A_CACHE) == [other]


def test_rlc_failure_recovers_exact_mask():
    """One flush holding a bad signature, invalid A and R encodings, a short
    key and s >= L: the combined check fails and the per-signature flush
    recovers the exact mask."""
    pks, msgs, sigs = _case("invalid_encodings", 600)
    sigs[300] = _flip(sigs[300])
    sigs[4] = sigs[4][:32] + ref.L.to_bytes(32, "little")
    mask = _check(pks, msgs, sigs)
    assert np.flatnonzero(~mask).tolist() == [2, 4, 5, 7, 9, 11, 300]
    assert tbatch.LAST_FLUSH["mode"] == "plain" and "recovery_s" in tbatch.LAST_FLUSH


def test_rlc_mixed_failures_on_cached_keys():
    """Bad signature, s >= L and an invalid R on a warm (cached-A) set."""
    pks, msgs, sigs = _case("honest", 600)
    _check(pks, msgs, sigs)
    sigs = list(sigs)
    sigs[0] = _flip(sigs[0])
    sigs[4] = sigs[4][:32] + ref.L.to_bytes(32, "little")
    sigs[599] = NOT_ON_CURVE + sigs[599][32:]
    mask = _check(pks, msgs, sigs)
    assert np.flatnonzero(~mask).tolist() == [0, 4, 599]
    assert tbatch.LAST_FLUSH["mode"] == "cached"


def test_rlc_accepts_pure_torsion_row():
    mask = _check(*_case("torsion", 600))
    assert mask.all() and "recovery_s" not in tbatch.LAST_FLUSH


def test_empty_and_mismatched_inputs():
    assert tbatch.verify_batch([], [], [], device="cpu").shape == (0,)
    assert jbatch.verify_batch([], [], [], backend="cpu").shape == (0,)
    with pytest.raises(ValueError):
        tbatch.verify_batch([b"x" * 32], [], [], device="cpu")


def test_oversized_flush_is_refused(monkeypatch):
    """A flush above the largest lane bucket is no longer refused: it goes to
    the streamed flush planner (tests/test_torch_planner.py checks its masks)."""
    n = tbatch._LANE_BUCKETS[-1]
    assert tbatch.planner_engaged(n)
    seen = []

    def streamed(pks, msgs, sigs, dev):
        seen.append((len(pks), dev.type))
        return np.ones(len(pks), dtype=bool)

    monkeypatch.setattr(tbatch, "_verify_batch_streamed", streamed)
    mask = tbatch.verify_batch([b"\0" * 32] * n, [b""] * n, [b"\0" * 64] * n, device="cpu")
    assert mask.shape == (n,) and seen == [(n, "cpu")]
