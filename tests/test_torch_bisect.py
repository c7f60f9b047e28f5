"""The port's bisection recovery after a failed combined check
(tendermint_tpu_torch/crypto/batch.py _bisect_recover) against the JAX
package's, with the same knobs on both sides.

Mirrors tests/test_bisect_recovery.py. RLC_MIN = 64 and a leaf of 64 rows
(TMTPU_BISECT_LEAF) in both packages make a 256-row flush bisect over
C = 4 chunks. The port runs with device="cpu" (the kernels' plain
versions); the reference gives masks by its host path and route labels and
recovery flush counts by its own routing under its host twins
(tests/torch_routing_util.py). Tolerance: zero.
"""

import math

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import NOT_ON_CURVE, check, knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)

N = 256
LEAF = 64
BOUND = 2 * math.ceil(math.log2(N // LEAF)) + 1  # one bad row over C = 4 chunks


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


@pytest.fixture
def bisect_env(knobs, monkeypatch):
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", 64)
    monkeypatch.setenv("TMTPU_BISECT_LEAF", str(LEAF))
    return knobs


ARMS = ("bisect", "bisect_off", "pipelined", "streamed", "host")


@pytest.mark.parametrize("arm", ARMS)
def test_one_bad_row_every_arm(bisect_env, monkeypatch, arm):
    """One bad row (the last, in the last chunk) in 256 rows with an s >= L,
    a short key and a torsion-defect row: the same mask on the single-flush
    bisection (at most 2 ceil(log2 C) + 1 flushes, path "rlc-bisect"), the
    one per-signature
    pass of TMTPU_BISECT=0, the pipelined stream (floor 256, a budget of
    1,024 lanes: head 64 rows), the streamed planner (a budget of 512 lanes:
    chunks of 255 rows and 1) and the host arm, with the reference's path and flush count on
    each."""
    if arm == "bisect_off":
        monkeypatch.setenv("TMTPU_BISECT", "0")
    elif arm == "pipelined":
        bisect_env.prep(stream_floor=N)
        bisect_env.planner(1024)  # chunks of 511 rows: the tail of 192 fits one
    elif arm == "streamed":
        bisect_env.planner(512)
    rows = rows_with(N, bad=(N - 1,), edges=True, encodings=False)
    f = check(*rows, backend="cpu" if arm == "host" else None)
    assert np.flatnonzero(~f["mask"]).tolist() == [1, 5, N - 1]
    want = {"bisect": "rlc-bisect", "bisect_off": "persig", "pipelined": "rlc-bisect",
            "streamed": "rlc-streamed-recovery", "host": "cpu"}[arm]
    assert f["path"] == want
    if arm in ("bisect", "pipelined"):
        assert 1 < f["recovery_flushes"] <= BOUND
    elif arm == "bisect_off":
        assert f["recovery_flushes"] == 1
    elif arm == "streamed":  # the chunk of 255 rows passes its single flush
        assert [c["path"] for c in f["recovered_chunks"]] == ["rlc", "persig"]
        assert "recovery_flushes" not in f


def test_two_bad_rows_cost_at_most_two_descents(bisect_env, monkeypatch):
    """A bad signature in the second half and invalid A and R encodings in
    the first, at a leaf of 128 rows (C = 2): at most two descents'
    flushes."""
    monkeypatch.setenv("TMTPU_BISECT_LEAF", "128")
    pks, msgs, sigs = rows_with(N, bad=(255,))
    pks[127] = NOT_ON_CURVE
    sigs[126] = (2**255 - 19).to_bytes(32, "little") + sigs[126][32:]  # non-canonical R
    f = check(pks, msgs, sigs)
    assert np.flatnonzero(~f["mask"]).tolist() == [126, 127, 255]
    assert f["path"] == "rlc-bisect" and f["recovery_flushes"] <= 2 * (2 * 1 + 1)


def test_dense_flood_trips_the_bail(bisect_env, monkeypatch):
    """TMTPU_BISECT_MAX_BAD=1 with bad rows in both halves, at a leaf of 128
    rows: after the first bad leaf the second half goes straight per
    signature, without its combined check (3 flushes, not 4); the mask stays
    exact and the count is the reference's."""
    monkeypatch.setenv("TMTPU_BISECT_MAX_BAD", "1")
    monkeypatch.setenv("TMTPU_BISECT_LEAF", "128")
    bad = (0, 100, 150, 200)
    f = check(*rows_with(N, bad=bad))
    assert np.flatnonzero(~f["mask"]).tolist() == list(bad)
    assert f["path"] == "rlc-bisect" and f["recovery_flushes"] == 3
