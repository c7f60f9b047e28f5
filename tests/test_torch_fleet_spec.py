"""The port's seeded fleet spec (tendermint_tpu_torch/chaos/fleet.py
FleetSpec) against the JAX package's.

`FleetSpec.generate` is a pure function of one random.Random(seed) stream:
for the same arguments the port must give the reference's spec JSON, spec
fingerprint and schedule fingerprint, over several seeds and sizes and the
shapes the reference's tests use (its smoke spec, its 50-node default, its
mixed-key spec, a two-poisoner spec, the default chaos kinds with
device_error and device_hang). Then the counterparts of the reference's six
spec tests (tests/test_fleet_soak.py:46-132) on the port's spec. No
tolerance applies: JSON and fingerprints compare as strings.
"""

import os

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.chaos import fleet as R  # noqa: E402
from tendermint_tpu_torch.chaos import fleet as T  # noqa: E402

SEED = 20260807


def smoke_kw() -> dict:
    """The reference's tier-1 smoke spec (tests/test_fleet_soak.py:135-157):
    4 ed25519 validators (one the poisoner), one resident full node, one
    blocksync joiner, one light edge."""
    return dict(validator_frac=0.58, light_frac=0.15, joiner_frac=0.5, bls_validators=0,
                statesync_joiners=0, poisoners=1, peer_degree=3, episodes=2, min_gap=0.5,
                max_gap=1.0, min_episode=0.8, max_episode=1.5, start_delay=0.5,
                join_window=(2.0, 4.0), chaos_kinds=("partition", "peer_stall", "sig_poison"))


MIXED_KEYS_KW = dict(validator_frac=0.67, light_frac=0.17, joiner_frac=0.0, bls_validators=1,
                     statesync_joiners=0, peer_degree=3, episodes=1, min_episode=0.5,
                     max_episode=1.0, chaos_kinds=("device_error",))

SPECS = {
    "smoke_7": (SEED, 7, smoke_kw()),
    "default_50": (SEED, 50, {}),
    "soak_50_no_bls": (SEED, 50, dict(bls_validators=0)),
    "mixed_keys_6": (SEED + 1, 6, MIXED_KEYS_KW),
    "poisoners_2": (SEED + 2, 20, dict(poisoners=2, chaos_kinds=(
        "partition", "crash", "sig_poison", "device_error", "device_hang"))),
    "d1_4": (SEED, 4, dict(bls_validators=0, episodes=1, start_delay=0.0, min_gap=1.0,
                           max_gap=1.0, chaos_kinds=("device_error",))),
    "seed_0_12": (0, 12, {}),
    "seed_7_30": (7, 30, dict(episodes=12, peer_degree=5)),
    "seed_99_100": (99, 100, dict(statesync_joiners=3, bls_validators=2)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_equals_the_reference(name):
    seed, n, kw = SPECS[name]
    r, t = R.FleetSpec.generate(seed, n, **kw), T.FleetSpec.generate(seed, n, **kw)
    assert t.to_json() == r.to_json()
    assert t.fingerprint() == r.fingerprint()
    assert t.schedule.fingerprint() == r.schedule.fingerprint()
    # each package reads the other's spec back to the same fleet
    assert T.FleetSpec.from_json(r.to_json()).fingerprint() == r.fingerprint()
    assert R.FleetSpec.from_json(t.to_json()).fingerprint() == t.fingerprint()


def test_default_kinds_keep_the_device_faults():
    spec = T.FleetSpec.generate(SEED, 50, episodes=40)
    kinds = {ev.kind for ev in spec.schedule.events}
    assert {"device_error", "device_hang"} <= kinds
    assert spec.to_json() == R.FleetSpec.generate(SEED, 50, episodes=40).to_json()


def test_fleet_spec_is_deterministic():
    a = T.FleetSpec.generate(SEED, 50)
    b = T.FleetSpec.generate(SEED, 50)
    assert a.to_json() == b.to_json()
    assert a.fingerprint() == b.fingerprint()
    assert a.schedule.fingerprint() == b.schedule.fingerprint()
    c = T.FleetSpec.generate(SEED + 1, 50)
    assert c.fingerprint() != a.fingerprint()


def test_fleet_spec_round_trips_through_json():
    a = T.FleetSpec.generate(SEED, 50)
    b = T.FleetSpec.from_json(a.to_json())
    assert b.fingerprint() == a.fingerprint()
    assert b.nodes == a.nodes
    assert b.topology == a.topology


def test_fleet_spec_heterogeneity():
    spec = T.FleetSpec.generate(SEED, 50)
    assert spec.n_nodes == 50
    assert {ns.role for ns in spec.nodes} == set(T.ROLES)
    assert {ns.key_type for ns in spec.validators} == {"ed25519", "bls12_381"}
    modes = {ns.sync_mode for ns in spec.joiners}
    assert "blocksync" in modes and "statesync" in modes
    assert all(ns.join_at > 0 for ns in spec.joiners)
    assert all(ns.role == T.ROLE_FULL for ns in spec.joiners)
    n0 = spec.nodes[0]
    assert (n0.role, n0.key_type, n0.join_at) == (T.ROLE_VALIDATOR, "ed25519", 0.0)


def test_fleet_topology_is_bounded_and_connected():
    spec = T.FleetSpec.generate(SEED, 50)
    n = spec.n_nodes
    assert len(spec.topology) < n * 8
    assert all(0 <= a < b < n for a, b in spec.topology)
    initial = {ns.index for ns in spec.initial()}
    adj = {i: set() for i in initial}
    for a, b in spec.topology:
        if a in initial and b in initial:
            adj[a].add(b)
            adj[b].add(a)
    seen, frontier = {0}, [0]
    while frontier:
        for j in adj[frontier.pop()]:
            if j not in seen:
                seen.add(j)
                frontier.append(j)
    assert seen == initial
    for ns in spec.joiners:
        peers = {b for a, b in spec.topology if a == ns.index}
        peers |= {a for a, b in spec.topology if b == ns.index}
        assert peers & initial


def test_fleet_schedule_respects_the_lifecycle():
    spec = T.FleetSpec.generate(SEED, 50)
    n = spec.n_nodes
    initial = {ns.index for ns in spec.initial()}
    light = {ns.index for ns in spec.light_edges}
    assert len(spec.schedule) > 0
    for ev in spec.schedule.events:
        params = ev.param_dict()
        if ev.kind == "partition":
            assert {i for g in params["groups"] for i in g} == set(range(n))
        elif ev.kind in ("crash", "restart"):
            t = params["target"]
            assert t in initial and t not in light and t != 0
        elif ev.kind in ("peer_stall", "peer_lie", "chunk_corrupt"):
            t = params["target"]
            assert spec.role_of(t) == T.ROLE_VALIDATOR and t != 0


def test_fleet_spec_rejects_what_the_reference_rejects():
    for args, kw in (((SEED, 3), {}),
                     ((SEED, 7), dict(chaos_kinds=("sig_poison",))),
                     ((SEED, 7), dict(chaos_kinds=("meteor",)))):
        for mod in (R, T):
            with pytest.raises(ValueError) as ei:
                mod.FleetSpec.generate(*args, **kw)
            if mod is R:
                want = str(ei.value)
        assert str(ei.value) == want
