"""The port's verified-row memo (tendermint_tpu_torch/crypto/batch.py
VerifiedRowMemo) against the reference's (tendermint_tpu/crypto/batch.py).

Each test installs a memo of the same capacity in both packages, as
tests/test_verified_memo.py does in the reference, and sends the same
seeded rows through both: a full hit (path "memo", no flush), a partial hit
(only the rest verified), a bad row (never inserted), a verify-mode flip
(the digest changes, so every row misses), capacity 0, LRU eviction at a
small capacity, a submit answered whole from the memo and a finish that
inserts its rows. The port's small calls run on its host arm; the submits
run its card arm on device="cpu" (the kernels' plain versions) and the
reference's under its host twins (tests/torch_routing_util.py). Tolerance:
zero. Masks byte-identical; hits, misses, insertions, evictions, sizes and
route labels equal.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)


@pytest.fixture
def memo(knobs):
    """memo(rows) installs a memo of `rows` in both packages; the port's
    memo before the test is restored after it (tests/conftest.py restores
    the reference's)."""
    prev = tbatch._MEMO

    def install(rows=4096):
        tbatch.configure_verified_memo(rows)
        jbatch.configure_verified_memo(rows)
        return knobs

    yield install
    tbatch._MEMO = prev


def both(pks, msgs, sigs, **kw):
    """verify_batch in both packages: (port mask, port label, reference mask,
    reference label); the masks must be byte-identical."""
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", **kw)
    label = tbatch.LAST_FLUSH["path"]
    jtrace.reset_stats()
    want = jbatch.verify_batch(pks, msgs, sigs, **kw)
    assert got.dtype == np.bool_ and got.tobytes() == np.asarray(want).tobytes()
    return got, label, jtrace.verify_stats()["last_flush"]["path"]


def stats():
    got, want = tbatch.verified_memo_stats(), jbatch.verified_memo_stats()
    assert got == want
    return got


def test_full_hit_answers_without_a_flush(memo):
    memo()
    rows = rows_with(60)
    assert both(*rows)[1:] == ("cpu", "cpu")
    # an empty memo is not read, so the first call counts no misses
    assert stats() == dict(capacity=4096, rows=60, hits=0, misses=0, insertions=60, evictions=0)
    mask, label, ref_label = both(*rows)
    assert mask.all() and label == ref_label == "memo"
    assert tbatch.LAST_FLUSH["memo_hits"] == 60
    assert stats()["hits"] == 60


def test_partial_hit_verifies_only_the_rest(memo):
    memo()
    pks, msgs, sigs = rows_with(60, bad=(50,))
    both(pks[:40], msgs[:40], sigs[:40])
    mask, label, ref_label = both(pks, msgs, sigs)
    assert label == ref_label == "cpu"  # the residue's route
    assert tbatch.LAST_FLUSH["memo_hits"] == 40
    assert np.flatnonzero(~mask).tolist() == [50]
    # 20 misses in the call and the same 20 again in its residue's own call
    assert stats() == dict(capacity=4096, rows=59, hits=40, misses=40, insertions=59, evictions=0)


def test_bad_rows_never_enter(memo):
    """A bad row misses every time and stays False; the good rows hit."""
    memo()
    rows = rows_with(64, bad=(9, 33), edges=True)
    first = both(*rows)[0]
    bad = np.flatnonzero(~first).tolist()
    assert bad == [1, 2, 4, 5, 9, 33] and stats()["insertions"] == 64 - len(bad)
    mask, label, ref_label = both(*rows)
    assert mask.tobytes() == first.tobytes() and label == ref_label == "cpu"
    assert stats()["hits"] == 64 - len(bad)
    assert all(d not in tbatch._MEMO for d in tbatch._MEMO.digest_rows(
        *([x[i] for i in bad] for x in rows)))


def test_verify_mode_flip_misses(memo):
    """The digest holds the mode byte: after a flip the same rows miss, and
    flipping back they hit again."""
    knobs = memo()
    rows = rows_with(40)
    both(*rows)
    knobs.mode("cofactorless")
    assert both(*rows)[1:] == ("cpu", "cpu")
    assert stats()["hits"] == 0 and stats()["rows"] == 80
    knobs.mode("cofactored")
    assert both(*rows)[1:] == ("memo", "memo")
    assert stats()["hits"] == 40


def test_capacity_zero_is_off(memo):
    memo(0)
    rows = rows_with(30)
    both(*rows)
    assert both(*rows)[1:] == ("cpu", "cpu")
    assert stats() == dict(capacity=0, rows=0, hits=0, misses=0, insertions=0, evictions=0)


def test_lru_eviction_at_a_small_capacity(memo):
    """Capacity 8: 12 rows keep the last 8; the first 4 miss, the last 4 hit
    and refresh, so a later insert evicts rows 4-7 first."""
    memo(8)
    pks, msgs, sigs = rows_with(16)
    both(pks[:12], msgs[:12], sigs[:12])
    assert stats()["evictions"] == 4 and stats()["rows"] == 8
    assert both(pks[8:12], msgs[8:12], sigs[8:12])[1:] == ("memo", "memo")
    assert both(pks[12:16], msgs[12:16], sigs[12:16])[1:] == ("cpu", "cpu")
    digests = tbatch._MEMO.digest_rows(pks, msgs, sigs)
    assert [d in tbatch._MEMO for d in digests] == [False] * 8 + [True] * 8
    assert stats() == dict(capacity=8, rows=8, hits=4, misses=4, insertions=16, evictions=8)


def test_submit_full_hit_and_finish_insert(memo, monkeypatch):
    """RLC_MIN lowered to 256 in both packages: a 300-row submit is queued on
    the card arm and its finish inserts its rows; the same submit again is
    answered whole from the memo, resolved at submit (path "memo")."""
    memo()
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", 256)
    rows = rows_with(300)
    h = tbatch.verify_batch_submit(*rows, device="cpu")
    jh = jbatch.verify_batch_submit(*rows)
    assert h._call is not None and jh._mask is None
    jtrace.reset_stats()
    assert jbatch.verify_batch_finish(jh).all() and tbatch.verify_batch_finish(h).all()
    assert tbatch.LAST_FLUSH["path"] == jtrace.verify_stats()["last_flush"]["path"] == "rlc-async"
    assert stats()["insertions"] == 300 and stats()["misses"] == 0  # empty: not read
    jtrace.reset_stats()
    h = tbatch.verify_batch_submit(*rows, device="cpu")
    jh = jbatch.verify_batch_submit(*rows)
    assert h._mask is not None and jh._mask is not None
    assert tbatch.LAST_FLUSH["path"] == jtrace.verify_stats()["last_flush"]["path"] == "memo"
    assert tbatch.verify_batch_finish(h).tobytes() == jbatch.verify_batch_finish(jh).tobytes()
    assert stats()["hits"] == 300
