"""The port's device fault hook (crypto/batch.set_device_fault_hook, called by
`_on_device`) and its injector (chaos/device.py) against the JAX package's.

The injector's counts, hangs, persistent mode and heal() behave as the
reference's (its tests/test_chaos.py:143-173, run on both packages). Then on
the card arm's plain versions (device="cpu", >= 256 rows, the routing
variable unset): an armed error raises at the flush's first device entry
(`rlc_submit` from RLC_MIN rows, `persig` below), is marked as a device
error, marks the device down, and is re-raised by the scheduler in every
ticket of the flush; the host arm never reaches the hook; after heal() the
same rows verify with the host arm's mask. The shard and mesh half of the
injector raises naming ROADMAP A6.
"""

import os
import time

import numpy as np
import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.chaos import device as ref_device  # noqa: E402
from tendermint_tpu.crypto import batch as ref_batch  # noqa: E402
from tendermint_tpu.crypto.keys import gen_ed25519  # noqa: E402
from tendermint_tpu_torch.chaos import DeviceFaultError, DeviceFaultInjector  # noqa: E402
from tendermint_tpu_torch.chaos import device as port_device  # noqa: E402
from tendermint_tpu_torch.config import SchedulerConfig  # noqa: E402
from tendermint_tpu_torch.crypto import batch  # noqa: E402
from tendermint_tpu_torch.crypto import scheduler as sched  # noqa: E402
from tendermint_tpu_torch.libs import trace  # noqa: E402

PACKAGES = {"port": port_device, "ref": ref_device}


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = batch._MEMO
    batch._MEMO = batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        batch._MEMO = prev


@pytest.fixture
def card_arm(monkeypatch):
    """The routing variable unset, so a call naming no backend takes the
    card arm from 256 rows; the hook cleared afterwards."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    yield
    batch.set_device_fault_hook(None)


def rows(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    keys = [gen_ed25519(bytes(rng.integers(0, 256, 32, np.uint8))) for _ in range(8)]
    msgs = [bytes(rng.integers(0, 256, 40, np.uint8)) for _ in range(n)]
    pks = [keys[i % 8].pub_key().bytes() for i in range(n)]
    sigs = [keys[i % 8].sign(m) for i, m in enumerate(msgs)]
    sigs[5] = sigs[5][:10] + bytes([sigs[5][10] ^ 1]) + sigs[5][11:]
    return pks, msgs, sigs


@pytest.mark.parametrize("which", ["port", "ref"])
def test_injector_counts_and_heal(which):
    mod = PACKAGES[which]
    inj = mod.DeviceFaultInjector()
    inj.arm_errors(2)
    with pytest.raises(mod.DeviceFaultError):
        inj("rlc_submit")
    with pytest.raises(mod.DeviceFaultError):
        inj("persig")
    inj("persig")  # armed count exhausted: passes
    assert inj.calls == 3
    assert [site for site, kind in inj.fired] == ["rlc_submit", "persig"]

    inj.set_persistent(True)
    for _ in range(3):
        with pytest.raises(mod.DeviceFaultError):
            inj("rlc_finish")
    inj.heal()
    inj("rlc_finish")  # healed
    assert inj.calls == 7 and len(inj.fired) == 5


@pytest.mark.parametrize("which", ["port", "ref"])
def test_injector_hang_delays_one_call(which):
    inj = PACKAGES[which].DeviceFaultInjector()
    inj.arm_hang(0.05)
    t0 = time.perf_counter()
    inj("rlc_submit")
    assert time.perf_counter() - t0 >= 0.045
    t0 = time.perf_counter()
    inj("rlc_submit")  # only the one call hangs
    assert time.perf_counter() - t0 < 0.04
    assert inj.fired == [("rlc_submit", "hang")]


@pytest.mark.parametrize("method,args", [
    ("arm_shard_error", (0,)), ("arm_shard_hang", (0, 0.1)), ("arm_device_lost", (1,)),
    ("revive_device", ()), ("shard_fault", ("rlc_submit", ["cuda:0"])),
    ("probe_intercept", ("cuda:0",)),
])
def test_shard_half_names_a6(method, args):
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        getattr(DeviceFaultInjector(), method)(*args)


def test_install_sets_the_batch_hook_only():
    inj = DeviceFaultInjector().install()
    try:
        assert batch._DEVICE_FAULT_HOOK is inj
        inj.arm_errors(1)
        with pytest.raises(DeviceFaultError):
            batch._device_fault("rlc_submit")
        batch._device_fault("rlc_submit")
    finally:
        inj.uninstall()
    assert batch._DEVICE_FAULT_HOOK is None
    # the reference's _device_fault calls its hook the same way
    ref_inj = ref_device.DeviceFaultInjector()
    ref_batch.set_device_fault_hook(ref_inj)
    try:
        ref_inj.arm_errors(1)
        with pytest.raises(ref_device.DeviceFaultError):
            ref_batch._device_fault("rlc_submit")
    finally:
        ref_batch.set_device_fault_hook(None)
    assert inj.fired == ref_inj.fired == [("rlc_submit", "error")]


@pytest.mark.parametrize("n,site", [(600, "rlc_submit"), (300, "persig")])
def test_armed_error_raises_on_the_card_arm(card_arm, n, site):
    """verify_batch on the card arm's plain versions: the armed error raises
    at the flush's first device entry, unchanged and marked, and marks the
    device down; the host arm of the same rows never calls the hook."""
    pks, msgs, sigs = rows(n)
    inj = DeviceFaultInjector().install()
    inj.arm_errors(1)
    with pytest.raises(DeviceFaultError) as e:
        batch.verify_batch(pks, msgs, sigs, device="cpu")
    assert inj.fired == [(site, "error")]
    assert batch.is_device_error(e.value)
    assert getattr(e.value, batch.DEVICE_ERROR_ATTR) == site
    assert trace.device_health()["device_up"] == 0
    assert "injected device fault" in trace.device_health()["last_error"]
    inj.set_persistent(True)
    host = batch.verify_batch(pks, msgs, sigs, backend="cpu")
    assert inj.calls == 1  # the host arm has no device entry
    assert host.tolist() == [i != 5 for i in range(n)]
    # a plain exception is not a device error, nor one raised from it
    assert not batch.is_device_error(RuntimeError("x"))
    try:
        try:
            raise e.value
        except DeviceFaultError as inner:
            raise ValueError("wrapped") from inner
    except ValueError as outer:
        assert batch.is_device_error(outer)


def test_scheduler_reraises_in_every_ticket_then_heals(card_arm):
    """Two tickets that share one 600-row light flush both raise the injected
    error; after heal() the next flush of the same rows gives the host
    arm's mask and marks the device up."""
    pks, msgs, sigs = rows(600)
    inj = DeviceFaultInjector().install()
    inj.arm_errors(1)
    # a wait long enough for the plain kernels on a loaded host: a ticket
    # that missed it would verify inline (a fallback)
    s = sched.VerifyScheduler(SchedulerConfig(wait_timeout=600.0), device="cpu")
    try:
        s.set_lane_wait("light", 30.0)
        t1 = s.submit("light", pks[:300], msgs[:300], sigs[:300])
        t2 = s.submit("light", pks[300:], msgs[300:], sigs[300:])
        s.set_lane_wait("light", 0.0)
        for t in (t1, t2):
            with pytest.raises(DeviceFaultError):
                t.wait(60)
        assert inj.fired == [("rlc_submit", "error")]
        assert s.flush_log[0]["rows"] == {"light": 600}
        assert trace.device_health()["device_up"] == 0
        inj.heal()
        mask = s.verify_rows("light", pks, msgs, sigs)
        assert mask.tolist() == batch.verify_batch(pks, msgs, sigs, backend="cpu").tolist()
        assert not mask[5] and mask.sum() == 599
        assert trace.device_health()["device_up"] == 1
        assert s.fallbacks == 0
    finally:
        s.close()
        inj.uninstall()
