"""The port's in-budget pipelined 2-chunk stream, staged single flush, prep
configuration and prewarm (tendermint_tpu_torch/crypto/batch.py) against
the JAX package's.

Mirrors tests/test_prep_pipeline.py. The pipelined path needs n at most
planner_chunk_rows() (else the planner streams) and a tail of
n - max(RLC_MIN, n // 8) rows that fits one chunk: a budget of 2,048 lanes
(1,023 rows a chunk) and a stream floor of 600 rows, set in both packages,
make 600 to 1,023 rows run pipelined with a head of 512 rows. The port runs
with device="cpu" (the kernels' plain versions); the reference gives masks
by its host path and route labels and recovery flush counts by its own
routing under its host twins (tests/torch_routing_util.py). Tolerance: zero.
"""

import os

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import check, knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)

N = 700


def precheck_rejects(n: int, at=(1, 5)):
    """rows_with(n) with an s >= L at at[0] and a short key at at[1]: rows the
    precheck refuses, so the combined check still passes."""
    pks, msgs, sigs = rows_with(n)
    s = int.from_bytes(sigs[at[0]][32:], "little")
    sigs[at[0]] = sigs[at[0]][:32] + (s + ref.L).to_bytes(32, "little")
    pks[at[1]] = pks[at[1]][:31]
    return pks, msgs, sigs


@pytest.fixture
def small(knobs):
    knobs.planner(2048)
    knobs.prep(stream_floor=600)
    return knobs


def test_pipelined_matches_reference(small):
    """700 rows, an s >= L in the head and a short key in the tail: two
    chunks of the 2,048-lane bucket, a head of 512 rows, the reference's
    route, each row hashed once."""
    hashed = tbatch.HASH_ROWS_HASHED[0]
    f = check(*precheck_rejects(N, at=(100, 600)))
    assert tbatch.HASH_ROWS_HASHED[0] - hashed == N
    assert f["path"] == "rlc-pipelined" and f["mode"] == "pipelined"
    assert f["chunks"] == 2 and f["head_rows"] == 512 and f["chunk_lanes"] == 2048
    assert f["prep_overlap_s"] >= 0 and f["prep_s"] > 0 and f["prep_wait_s"] >= 0
    assert np.flatnonzero(~f["mask"]).tolist() == [100, 600] and "recovery_flushes" not in f


def test_pipelined_bad_rows_recover_exactly(small):
    """A bad signature, an invalid A, a non-canonical R, a short key and a
    torsion-defect row: the pipelined check fails and the recovery gives
    the exact mask (at 700 rows the bisection is one per-signature leaf,
    path "persig", as in the reference)."""
    f = check(*rows_with(N, bad=(650,), edges=True))
    assert np.flatnonzero(~f["mask"]).tolist() == [1, 2, 4, 5, 650]
    assert f["mode"] == "pipelined" and f["recovery_flushes"] == 1 and "recovery_s" in f


def test_geometry_guard_declines(small):
    """A head not shorter than n, or a tail past one chunk, declines without a
    flush, in both packages; a 512-row call at a floor of 512 rows then takes
    the recovery path, as the reference's does."""
    small.prep(stream_floor=512)
    pks, msgs, sigs = rows_with(1600)
    tbatch.LAST_FLUSH.clear()
    for n in (512, 1600):  # head 512 = n; tail 1,088 > 1,023
        assert tbatch._verify_batch_pipelined(pks[:n], msgs[:n], sigs[:n], torch.device("cpu")) is None
        assert jbatch._verify_batch_pipelined(pks[:n], msgs[:n], sigs[:n]) is None
    assert tbatch.LAST_FLUSH == {}
    f = check(pks[:512], msgs[:512], sigs[:512])
    assert f["mask"].all() and f["path"] == "persig" and f["recovery_flushes"] == 1


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "serial"])
def test_stream_off_single_flush_staged_and_serial(small, staged):
    """configure_prep(stream=False) keeps the single cached-capable flush
    ("rlc"); staged (hashing on the prep worker) and serial submits give
    the reference's mask and hash each row once."""
    small.prep(stream=False, staged=staged)
    hashed = tbatch.HASH_ROWS_HASHED[0]
    f = check(*precheck_rejects(N))
    assert tbatch.HASH_ROWS_HASHED[0] - hashed == N
    assert f["path"] == "rlc" and f["mode"] == "plain"
    assert ("prep_overlap_s" in f) is staged
    assert np.flatnonzero(~f["mask"]).tolist() == [1, 5]


def test_staged_hash_failure_raises_and_pool_recovers(small, monkeypatch):
    """A hashing failure on the prep worker re-raises on the calling thread,
    and the worker runs the next flush."""
    small.prep(stream=False)
    pks, msgs, sigs = rows_with(16)
    real = native.ed25519_h_batch

    def boom(*a):
        raise RuntimeError("injected hash failure")

    monkeypatch.setattr(native, "ed25519_h_batch", boom)
    with pytest.raises(RuntimeError, match="injected hash failure"):
        tbatch._rlc_submit(pks, msgs, sigs, torch.device("cpu"))
    monkeypatch.setattr(native, "ed25519_h_batch", real)
    assert tbatch._prep_pool().submit(lambda: 7).result() == 7


def test_configure_prep_round_trip_and_defaults(small, monkeypatch):
    """The same env names and defaults as the reference; configure_prep sets
    and keeps each knob; prep_threads resizes the native pool (0 = the
    host default)."""
    for name, value in [("TMTPU_PREP_STREAM", "0"), ("TMTPU_PREP_STREAM", "1"),
                        ("TMTPU_PREP_STAGED", "0"), ("TMTPU_PREP_STAGED", "")]:
        monkeypatch.setenv(name, value)
        assert tbatch._prep_env_flag(name, "1") is jbatch._prep_env_flag(name, "1")
    for value in ("0", "auto", "", "1", "yes"):
        monkeypatch.setenv("TMTPU_HOST_STRIPE", value)
        assert tbatch._host_stripe_env() == jbatch._host_stripe_env()
    code = ("from tendermint_tpu_torch.crypto import batch; print(sorted(batch._PREP_CFG.items()))")
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if not k.startswith(("TMTPU_PREP", "TMTPU_HOST"))}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=dict(env, PYTHONPATH=root), cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(sorted({"staged": True, "stream": True, "stream_floor": 2048,
                                             "host_stripe": "auto"}.items())), out.stderr
    tbatch.configure_prep(staged=False, stream=False, stream_floor=0, host_stripe="auto")
    assert tbatch._PREP_CFG == {"staged": False, "stream": False, "stream_floor": 1,
                                "host_stripe": "auto"}
    tbatch.configure_prep(host_stripe=1)
    assert tbatch._host_stripe_on() is True
    try:
        tbatch.configure_prep(prep_threads=2)
        assert native.prep_threads() == native.prep_pool_size() == 2
        tbatch.configure_prep(prep_threads=3)
        assert native.prep_pool_size() == 3
    finally:
        tbatch.configure_prep(prep_threads=0)
    assert native.prep_pool_size() == native.prep_threads() == native._default_threads()


def test_prewarm_restores_the_stream_flag(small, monkeypatch):
    """prewarm runs its two single flushes with the stream off and restores
    the flag, also when a flush raises; it fills the A cache from the real
    keys; below 256 validators, or off the card arm, it warms nothing of
    the Ed25519 path (bls=True still warms the aggregate path)."""
    pks, _, _ = rows_with(8)
    calls = []
    card = tbatch.verify_batch_cuda
    monkeypatch.setattr(tbatch, "verify_batch_cuda",
                        lambda p, m, s, d: calls.append((len(p), tbatch._stream_enabled())))
    tbatch.prewarm(255, device="cpu", bls=True)  # the aggregate path only
    tbatch.prewarm(4096, backend="cpu", device="cpu")
    assert calls == []
    tbatch.prewarm(300, device="cpu", pubkeys=pks)
    assert calls == [(300, False), (300, False), (tbatch.planner_chunk_rows() + 1, True)]
    assert tbatch._stream_enabled() and all(k in tbatch._A_CACHE for k in pks)

    def boom(*a):
        raise RuntimeError("injected flush failure")

    monkeypatch.setattr(tbatch, "verify_batch_cuda", boom)
    with pytest.raises(RuntimeError, match="injected flush failure"):
        tbatch.prewarm(300, device="cpu")
    assert tbatch._stream_enabled()
    monkeypatch.setattr(tbatch, "verify_batch_cuda", card)
    tbatch.reset_a_cache()
    tbatch.prewarm(512, device="cpu", planner_chunk=False)  # plain, then cached-A
    assert tbatch._stream_enabled() and len(tbatch._A_CACHE) == 1  # the throwaway key
