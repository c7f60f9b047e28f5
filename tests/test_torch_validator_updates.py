"""The port's proposer priorities and validator-set updates
(tendermint_tpu_torch/types/validator_set.py increment_proposer_priority,
copy_increment_proposer_priority, update_with_change_set) against the JAX
package's, on seeded sequences.

Each sequence starts from a seeded set of Ed25519 and sr25519 validators
with seeded powers, carried into the port by
convert.validator_set_from_reference, then applies the same seeded steps to both: increments of 1-7 rounds,
copies incremented, and change sets of power changes, additions and
removals, with the error cases among them (a duplicate entry, a negative
power, a power above the maximum, removing an unknown validator, a total
above the maximum, removing every validator). After every step: the
validators' addresses, powers and priorities in order, the proposer, the
total power and the set's hash, or the same exception. Tolerance: zero.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.types import validator_set as tvs

KEYS = [(jsr.gen_sr25519 if i % 7 == 3 else jkeys.gen_ed25519)(bytes([0x33, i]) + bytes(30))
        .pub_key() for i in range(48)]


def _state(vals):
    return ([(v.address, v.voting_power, v.proposer_priority) for v in vals.validators],
            vals.get_proposer().address, vals.total_voting_power(), vals.hash())


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok",)


def _changes(rng, vals, kind):
    """A change set of `kind` over the validators `vals` holds: (reference
    Validators, port Validators)."""
    held = [v.pub_key for v in vals.validators]
    free = [k for k in KEYS if k.address() not in {v.address for v in vals.validators}]
    pairs = []
    if kind == "mixed":
        for k in rng.choice(len(held), size=min(3, len(held)), replace=False):
            pairs.append((held[k], int(rng.integers(0, 2_000))))  # 0 removes
        for k in rng.choice(len(free), size=min(2, len(free)), replace=False):
            pairs.append((free[k], int(rng.integers(1, 5_000))))
    elif kind == "duplicate":
        pairs = [(held[0], 5), (held[0], 6)]
    elif kind == "negative":
        pairs = [(held[0], -1)]
    elif kind == "too_big":
        pairs = [(held[0], jvs.MAX_TOTAL_VOTING_POWER + 1)]
    elif kind == "unknown_removal":
        pairs = [(free[0], 0)]
    elif kind == "total_too_big":
        pairs = [(held[0], jvs.MAX_TOTAL_VOTING_POWER - 1), (held[1], 2)]
    elif kind == "remove_all":
        pairs = [(k, 0) for k in held]
    return ([jvs.Validator(k, p) for k, p in pairs],
            [tvs.Validator(pubkey_from_type_and_bytes(k.type_name(), k.bytes()), p)
             for k, p in pairs])


KINDS = ("mixed",) * 6 + ("duplicate", "negative", "too_big", "unknown_removal",
                          "total_too_big", "remove_all")


@pytest.mark.parametrize("seed", range(6))
def test_seeded_priority_and_update_sequences(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(2, 12))
    start = rng.choice(len(KEYS), size=n, replace=False)
    jset = jvs.ValidatorSet([jvs.Validator(KEYS[k], int(rng.integers(1, 1_000)))
                             for k in start])
    tset = convert.validator_set_from_reference(jset)
    assert _state(tset) == _state(jset)
    kinds = {"errors": 0, "ok": 0}
    for _ in range(40):
        op = rng.integers(0, 4)
        if op == 0:
            times = int(rng.integers(1, 8))
            got = _outcome(lambda: tset.increment_proposer_priority(times))
            assert got == _outcome(lambda: jset.increment_proposer_priority(times))
        elif op == 1:
            times = int(rng.integers(1, 4))
            jc, tc = jset.copy_increment_proposer_priority(times), \
                tset.copy_increment_proposer_priority(times)
            assert _state(tc) == _state(jc)
        else:
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            jch, tch = _changes(rng, jset, kind)
            got = _outcome(lambda: tset.update_with_change_set(tch))
            assert got == _outcome(lambda: jset.update_with_change_set(jch)), kind
            kinds["ok" if got == ("ok",) else "errors"] += 1
            # a change set never leaks priorities into the caller's objects
            assert all(v.proposer_priority == 0 for v in tch)
        assert _state(tset) == _state(jset)
        assert convert.validator_set_from_reference(jset).hash() == tset.hash()
    assert kinds["ok"] and kinds["errors"]


def test_increment_errors_and_rescaling():
    """Non-positive rounds and an empty set raise as in the reference; a
    spread above twice the total power is rescaled, negatives truncated
    toward zero (Go's division)."""
    jset = jvs.ValidatorSet([jvs.Validator(KEYS[i], p) for i, p in enumerate((1, 3, 1000))])
    tset = convert.validator_set_from_reference(jset)
    for times in (0, -2):
        assert _outcome(lambda: tset.increment_proposer_priority(times)) == _outcome(
            lambda: jset.increment_proposer_priority(times))
    prios = (-7_777, 5, 9_001)
    for s in (jset, tset):
        for v, q in zip(s.validators, prios):
            v.proposer_priority = q
        s.rescale_priorities(2 * s.total_voting_power())
    assert _state(tset) == _state(jset)
    # spread 16,778 over 2 x 1,004: ratio 9; -7,777 / 9 truncates to -864 (floor: -865)
    assert [v.proposer_priority for v in tset.validators] == [-864, 0, 1_000]
    empty_j, empty_t = jvs.ValidatorSet([]), tvs.ValidatorSet([])
    assert _outcome(lambda: empty_t.increment_proposer_priority(1)) == _outcome(
        lambda: empty_j.increment_proposer_priority(1)) == ("ValueError", "empty validator set")
