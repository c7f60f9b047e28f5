"""The port's routing of a verify_batch call by row count, verify mode and device,
and its host arm (tendermint_tpu_torch/crypto/batch.py verify_batch_cpu,
the host combined check, the host bisection, the striped host check,
Ed25519BatchVerifier), against the JAX package's on the same seeded rows.

Mirrors the host cases of tests/test_bisect_recovery.py and
tests/test_prep_pipeline.py. The port runs with device="cpu"; the reference
gives the mask by its host path and the route label and recovery flush
count by its own routing under its host twins (tests/torch_routing_util.py).
Tolerance: zero. Masks byte-identical, route labels and recovery flush
counts equal.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import check, knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)

MODES = ("cofactored", "cofactorless")


@pytest.mark.parametrize("n", [3, 47, 48, 100, 255, 256])
@pytest.mark.parametrize("mode", MODES)
def test_default_route_by_row_count_and_mode(knobs, monkeypatch, mode, n):
    """No backend: the host below 256 rows and in cofactorless mode (the
    card arm is never entered), the card from 256 rows in cofactored mode.
    The rows hold a bad signature and every edge input."""
    knobs.mode(mode)
    entered = []
    card = tbatch.verify_batch_cuda
    monkeypatch.setattr(tbatch, "verify_batch_cuda",
                        lambda *a: entered.append(len(a[0])) or card(*a))
    f = check(*rows_with(n, bad=(n - 1,), edges=n > 8))
    host = mode == "cofactorless" or n < 256
    assert (f["path"] == "cpu") is host and entered == ([] if host else [n])
    if host:
        rlc = mode == "cofactored" and n >= 48
        assert f["mode"] == "host_serial"  # the serial loop gave the bad rows' verdicts
        assert ("recovery_flushes" in f) is rlc
    assert not f["mask"][n - 1]


@pytest.mark.parametrize("case", ["pass", "fail"])
def test_host_rlc_pass_and_fail(knobs, case):
    """backend="cpu" takes verify_batch_cpu at any size: 300 honest rows pass
    the host combined check; with two bad rows it fails and the host
    bisection gives the mask in the reference's number of flushes."""
    f = check(*rows_with(300, bad=() if case == "pass" else (40, 260)), backend="cpu")
    assert f["path"] == "cpu"
    if case == "pass":
        assert f["mode"] == "host_rlc" and f["mask"].all() and "recovery_flushes" not in f
    else:
        assert f["mode"] == "host_serial" and np.flatnonzero(~f["mask"]).tolist() == [40, 260]
        assert f["recovery_flushes"] > 1


@pytest.mark.parametrize("bisect,max_bad", [("1", "8"), ("1", "1"), ("0", "8")],
                         ids=["bisect", "bail", "bisect_off"])
def test_host_bisection_flushes_and_bail(knobs, monkeypatch, bisect, max_bad):
    """The host bisection (leaf = TMTPU_BISECT_LEAF // 4 rows) with one bad
    row in each quarter: the same flush count as the reference's; a bail of
    one bad leaf sends the remaining ranges straight to the serial loop;
    TMTPU_BISECT=0 is one serial pass, one recovery flush."""
    monkeypatch.setenv("TMTPU_BISECT", bisect)
    monkeypatch.setenv("TMTPU_BISECT_MAX_BAD", max_bad)
    monkeypatch.setenv("TMTPU_BISECT_LEAF", "128")
    bad = (10, 130, 190, 250)
    f = check(*rows_with(256, bad=bad), backend="cpu")
    assert np.flatnonzero(~f["mask"]).tolist() == list(bad)
    if bisect == "0":
        assert f["recovery_flushes"] == 1


def test_striped_host_rlc(knobs):
    """With the stream floor and the planner budget lowered, the host
    combined check runs in stripes on the prep worker (prep_overlap_s);
    honest rows pass in the reference's number of stripes, and a bad row
    recovers exactly."""
    knobs.prep(stream_floor=200, host_stripe=True)
    knobs.planner(256)  # stripes of 127 rows
    f = check(*rows_with(300), backend="cpu")
    assert f["mode"] == "host_rlc" and f["mask"].all()
    assert f["chunks"] == jbatch.LAST_FLUSH_DETAIL["chunks"] == 3
    assert f["prep_overlap_s"] >= 0 and f["prep_s"] > 0
    f = check(*rows_with(300, bad=(299,)), backend="cpu")
    assert np.flatnonzero(~f["mask"]).tolist() == [299]


def test_batch_verifier_add_verify_reset(knobs):
    """Ed25519BatchVerifier: rows added one at a time verify as the
    reference's verifier verifies them (the host arm below 256 rows); the
    batch stays until reset()."""
    from tendermint_tpu_torch.crypto.batch import Ed25519BatchVerifier

    pks, msgs, sigs = rows_with(64, bad=(9,), edges=True)
    ours, theirs = Ed25519BatchVerifier(device="cpu"), jbatch.Ed25519BatchVerifier(backend="cpu")
    for row in zip(pks, msgs, sigs):
        ours.add(*row)
        theirs.add(*row)
    assert len(ours) == len(theirs) == 64
    got = ours.verify()
    assert got.tobytes() == theirs.verify().tobytes() and not got[9]
    assert tbatch.LAST_FLUSH["path"] == "cpu" and len(ours) == 64
    assert ours.verify().tobytes() == got.tobytes()
    ours.reset()
    assert len(ours) == 0 and ours.verify().shape == (0,)


def test_card_arm_needs_a_card_and_the_host_arm_does_not(knobs):
    """The arm follows the row count, not the presence of a card: without a
    card a default call of 256 rows raises in device.resolve and one of 255
    rows runs on the host."""
    pks, msgs, sigs = rows_with(256)
    mask = tbatch.verify_batch(pks[:255], msgs[:255], sigs[:255])
    assert mask.all() and tbatch.LAST_FLUSH["path"] == "cpu"
    if torch.cuda.is_available():
        assert tbatch.verify_batch(pks, msgs, sigs).all()
        assert tbatch.LAST_FLUSH["path"] != "cpu"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.verify_batch(pks, msgs, sigs)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda"), "cpu", None],
                         ids=["cuda", "cuda0", "torch_cuda", "cpu", "none"])
@pytest.mark.parametrize("mode", MODES)
def test_card_device_asks_for_the_card(knobs, monkeypatch, mode, device):
    """A call that names no backend below 256 rows runs on the card arm when
    its `device` names a card (the reference has no device argument), through
    verify_batch and Ed25519BatchVerifier alike; "cpu" or no device keeps the
    reference's host arm, and cofactorless mode keeps the host whatever the
    device. The card arm's device.resolve is pointed at the CPU here, so the
    kernels' plain versions give its mask, byte-identical to the
    reference's."""
    from tendermint_tpu_torch.crypto.batch import Ed25519BatchVerifier

    knobs.mode(mode)
    resolved = []
    monkeypatch.setattr(tbatch, "resolve",
                        lambda d: resolved.append(d) or torch.device("cpu"))
    rows = rows_with(3, bad=(1,))
    want = jbatch.verify_batch(*rows, backend="cpu")
    card = mode == "cofactored" and device is not None and torch.device(device).type == "cuda"
    v = Ed25519BatchVerifier(device=device)
    for row in zip(*rows):
        v.add(*row)
    for got in (tbatch.verify_batch(*rows, device=device), v.verify()):
        assert got.tobytes() == want.tobytes() and not got[1]
        assert tbatch.LAST_FLUSH["path"] == ("persig" if card else "cpu")
    assert resolved == ([device] * 2 if card else [])


def test_concurrent_striped_host_checks_share_the_prep_worker(knobs):
    """More threads than cores (up to 18) run striped host checks at once:
    every stripe's prep goes to the one prep worker, no task waits on
    another, so each call ends (a bounded join) with the reference's mask;
    the hash counter, which the worker and the calling threads both bump,
    loses no update under a short switch interval."""
    import os
    import sys
    import threading

    knobs.prep(stream_floor=100, host_stripe=True)
    knobs.planner(128)  # stripes of 63 rows
    rows = rows_with(200, bad=(150,))
    want = jbatch.verify_batch(*rows, backend="cpu")
    n_threads = min((os.cpu_count() or 1) + 2, 18)  # every thread is bound by the GIL
    results, errors = [None] * n_threads, []
    hashed = tbatch.HASH_ROWS_HASHED[0]
    prev = sys.getswitchinterval()

    def run(k):
        try:
            results[k] = tbatch.verify_batch_cpu(*rows)
        except Exception as e:  # reported below
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert all(r is not None and r.tobytes() == want.tobytes() for r in results)
    # each call hashes its 200 rows once in the striped check, then its
    # recovery hashes each host sub-check's rows once more
    counted = tbatch.HASH_ROWS_HASHED[0] - hashed
    tbatch.HASH_ROWS_HASHED[0] = 0
    tbatch.verify_batch_cpu(*rows)
    assert counted == n_threads * tbatch.HASH_ROWS_HASHED[0]
