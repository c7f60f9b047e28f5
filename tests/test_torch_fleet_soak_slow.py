"""The port's slow-lane fleet soaks: the counterparts of the reference's
acceptance soak and mixed-key live soak (tests/test_fleet_soak.py:247,
:288), on port nodes (device="cpu"). Both are slow-lane, as in the
reference: a 50-node fleet for 20 heights runs for many minutes in one
process, and a BLS validator's votes verify by the host pairing.
TMTPU_FLEET_SEED replays a seed.
"""

import asyncio
import os

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu_torch.chaos.fleet import ROLES, FleetSpec, run_fleet_soak  # noqa: E402
from tendermint_tpu_torch.crypto import batch as T_batch  # noqa: E402

SEED = int(os.environ.get("TMTPU_FLEET_SEED", "20260807"))


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = T_batch._MEMO
    T_batch._MEMO = T_batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        T_batch._MEMO = prev


@pytest.mark.slow
def test_fleet_soak_50_nodes(tmp_path):
    """>= 50 nodes, all three roles, chaos + tx flood + light traffic at
    once, >= 20 heights, zero safety violations, full waterfall coverage,
    both catch-up paths, a reproducible schedule fingerprint."""
    spec = FleetSpec.generate(SEED, 50, bls_validators=0)
    res = asyncio.run(run_fleet_soak(spec, str(tmp_path), min_heights=20, deadline_s=3600.0,
                                     device="cpu"))
    assert res["verdict"] == "pass"
    assert res["safety_violations"] == 0
    assert res["heights"] >= 20
    assert res["workload"]["tx_submitted"] > 0
    assert res["workload"]["light_ok"] > 0
    report = res["report"]
    assert report["coverage"]["partial"] is False
    assert report["waterfall"]["uncovered"] == []
    assert len(report["waterfall"]["per_node"]) == res["live_nodes"]
    assert set(report["roles"].values()) == set(ROLES)
    assert {j["sync_mode"] for j in res["joiners"].values()} == {"blocksync", "statesync"}
    for j in res["joiners"].values():
        assert j["height"] is not None and j["height"] >= 20 - 2
        if j["sync_mode"] == "statesync":
            assert j["base"] > 1
    again = FleetSpec.generate(SEED, 50, bls_validators=0)
    assert again.fingerprint() == res["fingerprint"]
    assert again.schedule.fingerprint() == res["schedule_fingerprint"]


@pytest.mark.slow
def test_fleet_mixed_keys_live(tmp_path):
    """The mixed ed25519/BLS validator set, live. Its one chaos kind is
    device_error, which meets no device work here: the votes verify on the
    host arm (TMTPU_CRYPTO_BACKEND=cpu), where the injector does not fire."""
    spec = FleetSpec.generate(
        SEED + 1, 6, validator_frac=0.67, light_frac=0.17, joiner_frac=0.0, bls_validators=1,
        statesync_joiners=0, peer_degree=3, episodes=1, min_episode=0.5, max_episode=1.0,
        chaos_kinds=("device_error",))
    assert {ns.key_type for ns in spec.validators} == {"ed25519", "bls12_381"}
    res = asyncio.run(run_fleet_soak(spec, str(tmp_path), min_heights=4, deadline_s=900.0,
                                     device="cpu"))
    assert res["verdict"] == "pass"
    assert res["safety_violations"] == 0
    assert res["heights"] >= 4
