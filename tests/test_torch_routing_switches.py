"""The reference's two routing switches in the port: TMTPU_CRYPTO_BACKEND and
TMTPU_RLC (tendermint_tpu/crypto/batch.py backend_default, _rlc_enabled).

Each setting of TMTPU_CRYPTO_BACKEND (unset, "cpu", "jax", "bogus"), in
both verify modes, goes to both packages: backend_default() ("jax", the
reference's device arm, is the port's "cuda"), the route label and the mask
of a default verify_batch at 128 and 300 rows, or the same ValueError. With
RLC_MIN lowered to 256 in both packages, TMTPU_RLC=0 turns a 300-row call
on the card arm from the combined check into one per-signature pass, and a
submit from asynchronous to eager. The port runs its card arm on
device="cpu" (the kernels' plain versions); the reference runs its own
verify_batch and submit under its host twins (tests/torch_routing_util.py),
its labels read from its flight recorder. Tolerance: zero. Masks byte-identical, labels
and exceptions (type and message) equal.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.torch_routing_util import knobs, rows_with  # noqa: F401  (fixture)

torch.set_num_threads(2)

ENVS = (None, "cpu", "jax", "bogus")
MODES = ("cofactored", "cofactorless")


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _outcome(fn):
    """(mask bytes, route label) or (exception type name, message)."""
    try:
        mask, label = fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return np.asarray(mask).tobytes(), label


def _port(pks, msgs, sigs):
    mask = tbatch.verify_batch(pks, msgs, sigs, device="cpu")
    return mask, tbatch.LAST_FLUSH["path"]


def _reference(pks, msgs, sigs):
    jtrace.reset_stats()
    mask = jbatch.verify_batch(pks, msgs, sigs)
    return mask, jtrace.verify_stats()["last_flush"]["path"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("env", ENVS)
def test_backend_default_reads_the_variable(knobs, monkeypatch, env, mode):
    _set(monkeypatch, "TMTPU_CRYPTO_BACKEND", env)
    knobs.mode(mode)
    want = jbatch.backend_default()
    assert tbatch.backend_default() == {"jax": "cuda"}.get(want, want)
    assert want == ("cpu" if mode == "cofactorless" else env or "jax")


@pytest.mark.parametrize("n", [128, 300])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("env", ENVS)
def test_route_follows_the_variable(knobs, monkeypatch, env, mode, n):
    """The default call's arm: the host below 256 rows, in cofactorless mode
    and under "cpu"; the card's per-signature ladder ("persig": 300 rows is
    below RLC_MIN) under "jax" or unset; ValueError for an unknown name
    outside cofactorless mode (where the host is the arm whatever the
    variable says)."""
    _set(monkeypatch, "TMTPU_CRYPTO_BACKEND", env)
    knobs.mode(mode)
    pks, msgs, sigs = rows_with(n, bad=(3,) if n == 128 else ())
    got = _outcome(lambda: _port(pks, msgs, sigs))
    want = _outcome(lambda: _reference(pks, msgs, sigs))
    assert got == want
    if mode == "cofactorless" or env == "cpu" or (n < 256 and env != "bogus"):
        assert got[1] == "cpu"
    elif env == "bogus":
        assert got == ("ValueError", "unknown crypto backend 'bogus'")
    else:
        assert got[1] == "persig"


@pytest.mark.parametrize("rlc", ["1", "0"])
def test_rlc_switch_on_verify_batch(knobs, monkeypatch, rlc):
    """300 honest rows on the card arm, RLC_MIN lowered to 256 in both
    packages: the single combined check ("rlc") with the switch on, one
    per-signature pass ("persig") with TMTPU_RLC=0."""
    monkeypatch.setenv("TMTPU_RLC", rlc)
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", 256)
    pks, msgs, sigs = rows_with(300)
    got = _outcome(lambda: _port(pks, msgs, sigs))
    assert got == _outcome(lambda: _reference(pks, msgs, sigs))
    assert got[1] == {"1": "rlc", "0": "persig"}[rlc]
    assert "recovery_flushes" not in tbatch.LAST_FLUSH
    assert np.frombuffer(got[0], dtype=bool).all()


@pytest.mark.parametrize("rlc", ["1", "0"])
def test_rlc_switch_on_submit(knobs, monkeypatch, rlc):
    """A 300-row submit with RLC_MIN lowered to 256 in both packages: queued
    asynchronously ("rlc-async") with the switch on; with TMTPU_RLC=0 it is
    not eligible and comes back resolved from an eager per-signature pass,
    which finds the bad row 9."""
    monkeypatch.setenv("TMTPU_RLC", rlc)
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", 256)
    bad = (9,) if rlc == "0" else ()
    pks, msgs, sigs = rows_with(300, bad=bad)
    h = tbatch.verify_batch_submit(pks, msgs, sigs, device="cpu")
    resolved = h._mask is not None
    mask = tbatch.verify_batch_finish(h)
    jtrace.reset_stats()
    jh = jbatch.verify_batch_submit(pks, msgs, sigs)
    j_resolved = jh._mask is not None
    jmask = jbatch.verify_batch_finish(jh)
    assert mask.tobytes() == np.asarray(jmask).tobytes()
    assert resolved is j_resolved is (rlc == "0")
    assert tbatch.LAST_FLUSH["path"] == jtrace.verify_stats()["last_flush"]["path"] == (
        "persig" if rlc == "0" else "rlc-async")
    assert np.flatnonzero(~mask).tolist() == list(bad)
