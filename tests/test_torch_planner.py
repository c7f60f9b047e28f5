"""Port streamed flush planner (tendermint_tpu_torch/crypto/batch.py,
device="cpu") against the JAX package's verify_batch(..., backend="cpu").

A budget of 1,024 lanes (511 rows per chunk, 1,024-lane fused chunks with
ch = 1024) makes a few hundred rows stream. Tolerance: zero. The two bool
masks must be byte-identical.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.crypto.keys import gen_ed25519
from tendermint_tpu_torch.crypto import batch as tbatch

torch.set_num_threads(2)

CHUNK_ROWS = 511
NOT_ON_CURVE = next(y.to_bytes(32, "little") for y in range(2, 100)
                    if ref.point_decompress(y.to_bytes(32, "little")) is None)


@pytest.fixture(autouse=True)
def _small_budget():
    budget = tbatch.planner_budget()
    tbatch.configure_planner(max_flush_lanes=1024)
    tbatch.reset_a_cache()
    yield
    tbatch.configure_planner(max_flush_lanes=budget)
    tbatch.reset_a_cache()


@pytest.fixture(scope="module")
def rows():
    """1,100 signed rows: two full chunks and a ragged tail of 78."""
    privs = [gen_ed25519(bytes([7, i % 256, i // 256]) + bytes(29)) for i in range(1100)]
    msgs = [b"planner-row-%d" % i for i in range(1100)]
    return ([p.pub_key().bytes() for p in privs], msgs,
            [p.sign(m) for p, m in zip(privs, msgs)])


def _flip(sig: bytes) -> bytes:
    s = bytearray(sig)
    s[40] ^= 0x01
    return bytes(s)


def _check(pks, msgs, sigs):
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu")
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu")
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return got


def test_planner_engaged_at_default_budget():
    tbatch.configure_planner(max_flush_lanes=24576)
    assert tbatch.planner_chunk_rows() == 12287
    assert not tbatch.planner_engaged(12287) and tbatch.planner_engaged(12288)
    spans = tbatch._planner_chunks(100_000)
    assert len(spans) == 9 and spans[-1] == (8 * 12287, 100_000)
    assert spans[-1][1] - spans[-1][0] == 1704
    with pytest.raises(ValueError):
        tbatch.configure_planner(max_flush_lanes=7)


@pytest.mark.parametrize("n,chunks", [(2 * CHUNK_ROWS, 2), (1100, 3)])
def test_streamed_honest_rows_match_jax(rows, n, chunks):
    """An exact multiple of the chunk, and a ragged tail."""
    pks, msgs, sigs = (x[:n] for x in rows)
    assert tbatch.planner_engaged(n)
    assert _check(pks, msgs, sigs).all()
    f = tbatch.LAST_FLUSH
    assert f["mode"] == "streamed" and f["fused"] is True and "recovery_s" not in f
    assert f["chunks"] == chunks and f["chunk_lanes"] == 1024
    assert 0 < f["peak_lanes_in_flight"] <= 2 * 1024


def test_streamed_boundary_corruption_recovers_exact_mask(rows):
    """Bad signatures on both sides of each chunk boundary, a pubkey off
    the curve and a short key: the combined check fails and the chunk-wise
    recovery gives the exact mask."""
    pks, msgs, sigs = (list(x[: 2 * CHUNK_ROWS]) for x in rows)
    for i in (0, CHUNK_ROWS - 1, CHUNK_ROWS, 2 * CHUNK_ROWS - 1):
        sigs[i] = _flip(sigs[i])
    pks[600] = NOT_ON_CURVE
    pks[7] = pks[7][:31]
    mask = _check(pks, msgs, sigs)
    assert np.flatnonzero(~mask).tolist() == [0, 7, 510, 511, 600, 1021]
    f = tbatch.LAST_FLUSH
    assert f["mode"] == "streamed" and f["chunks"] == 2 and "recovery_s" in f


def test_streamed_invalid_r_encoding_only(rows):
    """One non-canonical R in the ragged tail chunk and nothing else wrong."""
    pks, msgs, sigs = (list(x) for x in rows)
    sigs[1050] = ref.P.to_bytes(32, "little") + sigs[1050][32:]
    mask = _check(pks, msgs, sigs)
    assert np.flatnonzero(~mask).tolist() == [1050]
    assert "recovery_s" in tbatch.LAST_FLUSH
