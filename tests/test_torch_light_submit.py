"""The port's submit / finish and cross-request accumulation
(tendermint_tpu_torch/crypto/batch.py verify_batch_submit,
verify_batch_finish, FlushAccumulator, accumulate_flushes) against the JAX
package on seeded rows.

The port runs with device="cpu": at 600 rows a submit is eligible for the
asynchronous single flush, which runs the card arm on the kernels' plain
versions. The reference's masks come from its host path
(verify_batch(backend="cpu")); its route labels ("rlc-async",
"persig-async") from its own verify_batch_submit / verify_batch_finish
under its host twins (tests/torch_routing_util.py). Each plain combined
check costs ~3-4 s here and a per-signature pass over 1,024 lanes ~10 s,
so the card-arm tests share their results. Tolerance: zero. Masks
byte-identical, labels and recovery flush counts equal.
"""

import threading

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)

N = 600
BAD = (5,)
_PORT: dict = {}


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


def reference_submit(pks, msgs, sigs, key_types=None):
    """The reference's submit / finish under its host twins: (mask, route
    label of its flush record, whether the handle came back resolved)."""
    jtrace.reset_stats()
    h = jbatch.verify_batch_submit(pks, msgs, sigs, None, key_types)
    resolved = h._mask is not None
    mask = jbatch.verify_batch_finish(h)
    return np.asarray(mask), jtrace.verify_stats()["last_flush"].get("path"), resolved


def port_separate(case: str):
    """The port's own submit and finish of the 600-row case (shared by the
    tests): (mask, LAST_FLUSH)."""
    if case not in _PORT:
        pks, msgs, sigs = rows_with(N, bad=BAD if case == "bad" else ())
        h = tbatch.verify_batch_submit(pks, msgs, sigs, device="cpu")
        assert h._mask is None and h._call is not None  # queued, not synced
        mask = tbatch.verify_batch_finish(h)
        assert tbatch.verify_batch_finish(h) is mask
        _PORT[case] = (mask, dict(tbatch.LAST_FLUSH))
    return _PORT[case]


@pytest.mark.parametrize("case", ["honest", "bad"])
def test_submit_finish_matches_reference(knobs, case):
    """600 rows: the combined check passes ("rlc-async") or fails and one
    per-signature pass gives the exact mask ("persig-async", one recovery
    flush); masks byte-identical to the reference's, labels equal to its
    own submit / finish's."""
    pks, msgs, sigs = rows_with(N, bad=BAD if case == "bad" else ())
    mask, flush = port_separate(case)
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu")
    ref_mask, ref_path, ref_resolved = reference_submit(pks, msgs, sigs)
    assert mask.dtype == np.bool_ and mask.tobytes() == want.tobytes() == ref_mask.tobytes()
    assert not ref_resolved
    assert flush["path"] == ref_path == {"honest": "rlc-async", "bad": "persig-async"}[case]
    assert flush.get("recovery_flushes") == (1 if case == "bad" else None)
    assert np.flatnonzero(~mask).tolist() == ([] if case == "honest" else list(BAD))


def test_two_handles_finished_in_reverse_order(knobs):
    """Two flushes in flight (the light client's pair): the second finished
    first; each mask equals its own separate submit's."""
    honest = rows_with(N)
    bad = rows_with(N, bad=BAD)
    h1 = tbatch.verify_batch_submit(*honest, device="cpu")
    h2 = tbatch.verify_batch_submit(*bad, device="cpu")
    m2 = tbatch.verify_batch_finish(h2)
    assert tbatch.LAST_FLUSH["path"] == "persig-async"
    m1 = tbatch.verify_batch_finish(h1)
    assert tbatch.LAST_FLUSH["path"] == "rlc-async"
    assert m1.tobytes() == port_separate("honest")[0].tobytes()
    assert m2.tobytes() == port_separate("bad")[0].tobytes()


@pytest.mark.parametrize("n,device", [(100, None), (255, None), (100, "cpu")])
def test_small_submit_resolves_on_the_host(knobs, n, device):
    """Below 256 rows (no backend, no card device) the handle comes back
    resolved from the host arm, as the reference's ineligible submit runs
    its eager verify_batch."""
    pks, msgs, sigs = rows_with(n, bad=(3,), edges=True)
    h = tbatch.verify_batch_submit(pks, msgs, sigs, device=device)
    assert h._mask is not None and h._call is None
    assert tbatch.LAST_FLUSH["path"] == "cpu"
    ref_mask, _, ref_resolved = reference_submit(pks, msgs, sigs)
    assert ref_resolved
    assert tbatch.verify_batch_finish(h).tobytes() == ref_mask.tobytes()


def test_cofactorless_submit_is_the_eager_host_loop(knobs):
    """Cofactorless mode: the backend resolves to the host, so even 600 rows
    on device="cpu" are not eligible; the serial loop refuses the
    torsion-defect row (row 7), as the reference's submit does."""
    knobs.mode("cofactorless")
    pks, msgs, sigs = rows_with(N, bad=BAD, edges=True)
    h = tbatch.verify_batch_submit(pks, msgs, sigs, device="cpu")
    assert h._mask is not None
    assert tbatch.LAST_FLUSH["mode"] == "host_serial" and tbatch.LAST_FLUSH["path"] == "cpu"
    ref_mask, _, ref_resolved = reference_submit(pks, msgs, sigs)
    assert ref_resolved
    got = tbatch.verify_batch_finish(h)
    assert got.tobytes() == ref_mask.tobytes()
    assert not got[7] and not got[5]


def _mixed_rows():
    """6 Ed25519 rows and 3 sr25519 rows, a bad row of each type."""
    pks, msgs, sigs = rows_with(6, bad=(2,), seed=3)
    types = ["ed25519"] * 6
    for i in range(3):
        priv = jsr.gen_sr25519(bytes([0x44, i]) * 16)
        msg = b"mixed-submit-%d" % i
        sig = priv.sign(msg)
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(sig[:-1] + bytes([sig[-1] ^ 1]) if i == 1 else sig)
        types.append("sr25519")
    return pks, msgs, sigs, types


def test_mixed_set_submit_is_the_eager_split(knobs, monkeypatch):
    """A set holding sr25519 rows takes the eager verify_batch (the exact
    per-type split, D3) even where an all-Ed25519 set of its size would be
    eligible (RLC_MIN lowered to 8, backend "cuda"): the handle comes back
    resolved, path "mixed", with the reference's mask."""
    monkeypatch.setattr(tbatch, "RLC_MIN", 8)
    pks, msgs, sigs, types = _mixed_rows()
    h = tbatch.verify_batch_submit(pks, msgs, sigs, device="cpu", key_types=types,
                                   backend="cuda")
    assert h._mask is not None and tbatch.LAST_FLUSH["path"] == "mixed"
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu", key_types=types)
    got = tbatch.verify_batch_finish(h)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert np.flatnonzero(~got).tolist() == [2, 7]


REQUESTS = ((40, (), 11), (60, (17,), 12), (50, (), 13))  # rows, bad rows, seed


def _requests():
    return [rows_with(n, bad=bad, seed=seed) for n, bad, seed in REQUESTS]


def test_accumulated_slices_equal_separate_requests(knobs):
    """Three requests, one bad row: one flush (flush_count 1), each slice
    byte-identical to that request's separate submit / finish and to the
    reference's accumulated slice."""
    reqs = _requests()
    with tbatch.accumulate_flushes(device="cpu") as acc:
        assert tbatch.current_accumulator() is acc
        handles = [tbatch.verify_batch_submit(*r, device="cpu") for r in reqs]
        assert acc.lanes == sum(n for n, _, _ in REQUESTS) and acc.flush_count == 0
    assert tbatch.current_accumulator() is None
    slices = [tbatch.verify_batch_finish(h) for h in handles]
    assert acc.flush_count == 1
    assert tbatch.LAST_FLUSH["path"] == "cpu"
    separate = [tbatch.verify_batch_finish(tbatch.verify_batch_submit(*r, device="cpu"))
                for r in reqs]
    with jbatch.accumulate_flushes() as jacc:
        jhandles = [jbatch.verify_batch_submit(*r) for r in reqs]
    jslices = [jbatch.verify_batch_finish(h) for h in jhandles]
    assert jacc.flush_count == 1
    for got, sep, want in zip(slices, separate, jslices):
        assert got.dtype == np.bool_ and got.tobytes() == sep.tobytes() == want.tobytes()
    assert [np.flatnonzero(~s).tolist() for s in slices] == [[], [17], []]
    assert acc.flush() is acc.flush() and acc.flush_count == 1
    with pytest.raises(RuntimeError, match="FlushAccumulator already flushed"):
        acc.add(*reqs[0], None)


def test_accumulator_latches_its_error(knobs):
    """A failed flush raises at the first finish and the same error at every
    later one, without a second verify_batch call."""
    reqs = _requests()
    with tbatch.accumulate_flushes(backend="bogus") as acc:
        handles = [tbatch.verify_batch_submit(*r) for r in reqs]
    with pytest.raises(ValueError, match="unknown crypto backend") as first:
        tbatch.verify_batch_finish(handles[0])
    for h in handles[1:]:
        with pytest.raises(ValueError) as again:
            tbatch.verify_batch_finish(h)
        assert again.value is first.value
    assert acc.flush_count == 1


def test_accumulator_is_thread_local(knobs):
    """Another thread's submit inside the scope is not captured: it gets a
    resolved handle of its own, and the accumulator's rows do not grow."""
    reqs = _requests()
    seen = {}

    def other():
        seen["acc"] = tbatch.current_accumulator()
        h = tbatch.verify_batch_submit(*reqs[1])
        seen["resolved"] = h._mask is not None and h._acc is None
        seen["mask"] = tbatch.verify_batch_finish(h)

    with tbatch.accumulate_flushes(device="cpu") as acc:
        tbatch.verify_batch_submit(*reqs[0], device="cpu")
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert acc.lanes == REQUESTS[0][0]
    assert seen["acc"] is None and seen["resolved"]
    assert np.flatnonzero(~seen["mask"]).tolist() == [17]
    empty = tbatch.FlushAccumulator()
    assert empty.flush().shape == (0,) and empty.flush_count == 0
