"""ROADMAP D1 for a fleet: an injected device_error that meets a port node's
device work ends the port's fleet soak, where the reference's fleet commits
on.

Both packages run the same 4-validator spec (FleetSpec.generate: one
device_error episode at t=0, chaos_kinds=("device_error",)) with the vote
flushes on the card arm ([scheduler] backend "cuda" in the port, on the
plain versions here; "jax" in the reference, whose RLC_MIN is lowered so a
vote flush takes its device path) and no baseline gate (settle_height=0),
so the error is armed before the first flush.

- The port: a node's first vote flush raises the injected DeviceFaultError,
  its consensus halts, and run_fleet_soak raises that error, with a note
  naming the node and the heights, well inside deadline_s.
- The reference, beside it: its injector is made persistent (every device
  call raises, so no device program is ever built on this host) and its
  fallbacks verify on the host: its fleet commits on to the height gate and
  its referee hands down `pass`.
"""

import asyncio
import os
import time

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

import pytest  # noqa: E402

from tendermint_tpu.chaos import fleet as R_fleet  # noqa: E402
from tendermint_tpu.chaos import harness as R_harness  # noqa: E402
from tendermint_tpu.config import config as R_config  # noqa: E402
from tendermint_tpu.crypto import batch as R_batch  # noqa: E402
from tendermint_tpu_torch.chaos import fleet as T_fleet  # noqa: E402
from tendermint_tpu_torch.chaos.device import DeviceFaultError  # noqa: E402
from tendermint_tpu_torch.config import config as T_config  # noqa: E402
from tendermint_tpu_torch.crypto import batch as T_batch  # noqa: E402
from test_torch_fleet_spec import SEED  # noqa: E402

D1_KW = dict(bls_validators=0, episodes=1, start_delay=0.0, min_gap=1.0, max_gap=1.0,
             chaos_kinds=("device_error",))
DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = T_batch._MEMO
    T_batch._MEMO = T_batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        T_batch._MEMO = prev


def card_arm_votes(monkeypatch, config_mod, backend: str) -> None:
    """The fleet harness builds each node's config from test_config(): put
    its combined flushes on the device arm."""
    real = config_mod.test_config

    def test_config():
        cfg = real()
        cfg.scheduler.backend = backend
        return cfg

    monkeypatch.setattr(config_mod, "test_config", test_config)


def test_device_error_ends_the_port_fleet_and_the_reference_fleet_commits_on(
        tmp_path, monkeypatch):
    spec = T_fleet.FleetSpec.generate(SEED, 4, **D1_KW)
    assert spec.to_json() == R_fleet.FleetSpec.generate(SEED, 4, **D1_KW).to_json()
    (ev,) = spec.schedule.events
    assert (ev.kind, ev.at) == ("device_error", 0.0)

    card_arm_votes(monkeypatch, T_config, "cuda")
    t0 = time.monotonic()
    with pytest.raises(DeviceFaultError) as ei:
        asyncio.run(T_fleet.run_fleet_soak(spec, str(tmp_path / "port"), min_heights=4,
                                           deadline_s=DEADLINE_S, settle_height=0,
                                           device="cpu"))
    took = time.monotonic() - t0
    assert took < DEADLINE_S / 4, took
    err = ei.value
    assert T_batch.is_device_error(err)
    assert str(err).startswith("injected device fault at ")
    (note,) = err.__notes__
    assert note.startswith("fleet node ") and "(validator, " in note
    assert "consensus halted" in note and "heights={" in note

    # the reference, beside it: every device call raises, its fallbacks
    # verify on the host, and the fleet commits on
    card_arm_votes(monkeypatch, R_config, "jax")
    monkeypatch.setattr(R_batch, "RLC_MIN", 1)
    fired = []
    real_error = R_harness.LocalChaosNet.device_error

    def device_error(self, count):
        real_error(self, count)
        self.injector.set_persistent(True)
        fired.append(self.injector)

    monkeypatch.setattr(R_harness.LocalChaosNet, "device_error", device_error)
    try:
        res = asyncio.run(R_fleet.run_fleet_soak(spec, str(tmp_path / "ref"), min_heights=3,
                                                 deadline_s=DEADLINE_S, settle_height=0))
    finally:
        R_batch.BREAKER.reset()
    assert res["verdict"] == "pass" and res["heights"] >= 3
    assert res["chaos_errors"] == []
    (inj,) = fired
    assert len(inj.fired) >= 1 and all(kind == "error" for _, kind in inj.fired)
