"""The port's light checks (tendermint_tpu_torch/types/validator_set.py
verify_commit_light / verify_commit_light_trusting, light/verifier.py)
against the JAX package on sets of at most 64 validators.

Every chain and commit is built with the reference's types and signed by its
keys (tests/test_light.py make_chain); the port gets the same objects by
their bytes (convert.light_block_from_reference_bytes, Commit.decode). The
sets are below 256 rows, so both packages verify on their host arms (the
port with device="cpu"). Tolerance: zero. The outcome of every call, pass
or the exception's type and message (and its cause's type), must be equal.
"""

from collections import namedtuple
from fractions import Fraction

import pytest

from tendermint_tpu.light import verifier as jver
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import light as jlight
from tendermint_tpu.types.basic import NANOS, BlockID, BlockIDFlag, PartSetHeader
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.light import verifier as tver
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import block as tblock
from tests.test_light import CHAIN_ID, NOW, PERIOD, make_chain, make_keys

DRIFT = 10 * NANOS
N_VALS = 24

# The JAX package's light client reads its backend from the environment.
pytestmark = pytest.mark.usefixtures("_cpu_backend")


@pytest.fixture
def _cpu_backend(monkeypatch):
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")


def outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001  (the outcome is compared, whatever it is)
        cause = type(e.__cause__).__name__ if e.__cause__ is not None else None
        return type(e).__name__, str(e), cause
    return ("ok",)


def carry(lb):
    return convert.light_block_from_reference_bytes(jlight.light_block_to_bytes(lb))


def carry_commit(c):
    return tblock.Commit.decode(c.encode())


PRIVS = make_keys(b"\x21", N_VALS)
NEW_PRIVS = make_keys(b"\x22", N_VALS)
# a third of the set replaced at height 5, all of it at height 8
CHAIN = make_chain(9, privs_by_height={5: PRIVS[: 2 * N_VALS // 3] + NEW_PRIVS[:N_VALS // 3],
                                       8: NEW_PRIVS}, default_privs=PRIVS)
PORT = {h: carry(lb) for h, lb in CHAIN.items()}


def flip(sig: bytes) -> bytes:
    return sig[:32] + (1).to_bytes(32, "little")


def commit_variant(case: str):
    """Height 4's commit (signed by PRIVS) with one defect, as the
    reference's Commit."""
    c = CHAIN[4].signed_header.commit
    sigs = list(c.signatures)
    if case == "bad_sig":
        sigs[3] = jblock.CommitSig(sigs[3].block_id_flag, sigs[3].validator_address,
                                   sigs[3].timestamp_ns, flip(sigs[3].signature))
    elif case == "bad_third":  # a third of the power fails: under 2/3 remains
        for i in range(N_VALS // 3 + 1):
            sigs[i] = jblock.CommitSig(sigs[i].block_id_flag, sigs[i].validator_address,
                                       sigs[i].timestamp_ns, flip(sigs[i].signature))
    elif case == "absent":
        sigs[0] = jblock.CommitSig.absent_sig()
        sigs[5] = jblock.CommitSig.absent_sig()
    elif case == "nil":  # a nil vote, signed over the nil block ID
        by_addr = {p.pub_key().address(): p for p in PRIVS}
        cs = sigs[2]
        nil = jblock.CommitSig(BlockIDFlag.NIL, cs.validator_address, cs.timestamp_ns, b"")
        sigs[2] = nil
        sb = jblock.Commit(c.height, c.round, c.block_id, sigs).vote_sign_bytes(CHAIN_ID, 2)
        sigs[2] = jblock.CommitSig(BlockIDFlag.NIL, cs.validator_address, cs.timestamp_ns,
                                   by_addr[cs.validator_address].sign(sb))
    elif case == "many_nil":
        for i in range(N_VALS // 3 + 1):
            sigs[i] = jblock.CommitSig(BlockIDFlag.NIL, sigs[i].validator_address,
                                       sigs[i].timestamp_ns, sigs[i].signature)
    elif case == "double_vote":
        sigs[7] = sigs[2]
    elif case == "unknown_address":
        sigs[1] = jblock.CommitSig(sigs[1].block_id_flag, b"\x42" * 20, sigs[1].timestamp_ns,
                                   sigs[1].signature)
    elif case != "honest":
        raise KeyError(case)
    return jblock.Commit(c.height, c.round, c.block_id, sigs)


LIGHT_CASES = ("honest", "bad_sig", "bad_third", "absent", "nil", "many_nil", "double_vote",
               "unknown_address")


@pytest.mark.parametrize("case", LIGHT_CASES)
def test_verify_commit_light_matches_reference(case):
    jc = commit_variant(case)
    tc = carry_commit(jc)
    jvals, tvals = CHAIN[4].validator_set, PORT[4].validator_set
    want = outcome(lambda: jvals.verify_commit_light(CHAIN_ID, jc.block_id, jc.height, jc))
    got = outcome(lambda: tvals.verify_commit_light(CHAIN_ID, tc.block_id, tc.height, tc,
                                                    device="cpu"))
    assert got == want
    assert (want == ("ok",)) is (case not in ("bad_third", "many_nil"))


@pytest.mark.parametrize("case", ["size", "height", "block_id"])
def test_verify_commit_light_structural_errors(case):
    jc = commit_variant("honest")
    jvals, tvals = CHAIN[4].validator_set, PORT[4].validator_set
    height, bid = jc.height, jc.block_id
    if case == "size":
        jc = jblock.Commit(jc.height, jc.round, jc.block_id, jc.signatures[:-1])
    elif case == "height":
        height += 1
    else:
        bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
    tc = carry_commit(jc)
    tbid = tbasic.BlockID.decode(bid.encode())
    want = outcome(lambda: jvals.verify_commit_light(CHAIN_ID, bid, height, jc))
    got = outcome(lambda: tvals.verify_commit_light(CHAIN_ID, tbid, height, tc, device="cpu"))
    assert got == want and want[0] == "CommitVerifyError"


@pytest.mark.parametrize("level", [(1, 3), (2, 3), (1, 1)], ids=["1/3", "2/3", "1/1"])
@pytest.mark.parametrize("case", LIGHT_CASES)
def test_verify_commit_light_trusting_matches_reference(case, level):
    """The trusting check of height 4's commit against height 5's set
    (two thirds of it known)."""
    jc = commit_variant(case)
    tc = carry_commit(jc)
    jvals, tvals = CHAIN[5].validator_set, PORT[5].validator_set
    want = outcome(lambda: jvals.verify_commit_light_trusting(CHAIN_ID, jc, Fraction(*level)))
    got = outcome(lambda: tvals.verify_commit_light_trusting(CHAIN_ID, tc, Fraction(*level),
                                                             device="cpu"))
    assert got == want
    if case == "double_vote":
        assert want[1].startswith("double vote from ")


def test_zero_trust_denominator():
    """fractions.Fraction refuses a zero denominator, so the check's own
    branch is reached by a duck-typed level only."""
    level = namedtuple("Level", "numerator denominator")(1, 0)
    jc = commit_variant("honest")
    tc = carry_commit(jc)
    want = outcome(lambda: CHAIN[4].validator_set.verify_commit_light_trusting(CHAIN_ID, jc, level))
    got = outcome(lambda: PORT[4].validator_set.verify_commit_light_trusting(CHAIN_ID, tc, level,
                                                                             device="cpu"))
    assert got == want == ("CommitVerifyError", "trustLevel has zero Denominator", None)


def verify_both(fn_name: str, trusted: int, untrusted: int, now=NOW, period=PERIOD,
                drift=DRIFT, level=Fraction(1, 3), untrusted_vals=None, blocks=None):
    """The same verifier call in both packages: (reference outcome, port outcome)."""
    jb, tb = blocks or (CHAIN, PORT)
    jv = jb[untrusted].validator_set if untrusted_vals is None else untrusted_vals[0]
    tv = tb[untrusted].validator_set if untrusted_vals is None else untrusted_vals[1]
    out = []
    for mod, b, vals, kw in ((jver, jb, jv, {}), (tver, tb, tv, {"device": "cpu"})):
        t, u = b[trusted], b[untrusted]
        if fn_name == "adjacent":
            args = (CHAIN_ID, t.signed_header, u.signed_header, vals, period, now, drift)
            fn = mod.verify_adjacent
        else:
            args = (CHAIN_ID, t.signed_header, t.validator_set, u.signed_header, vals, period,
                    now, drift, level)
            fn = mod.verify_non_adjacent if fn_name == "non_adjacent" else mod.verify
        out.append(outcome(lambda: fn(*args, **kw)))
    return out


@pytest.mark.parametrize("fn_name,trusted,untrusted", [
    ("adjacent", 1, 2), ("adjacent", 4, 5), ("adjacent", 7, 8),
    ("non_adjacent", 1, 3), ("non_adjacent", 1, 5), ("non_adjacent", 3, 6),
    ("non_adjacent", 1, 9), ("non_adjacent", 4, 8), ("non_adjacent", 1, 2),
    ("adjacent", 1, 3), ("verify", 2, 3), ("verify", 2, 7), ("verify", 5, 9),
])
def test_verifier_matches_reference(fn_name, trusted, untrusted):
    """Adjacent and non-adjacent steps across the partial (height 5) and the
    full (height 8) rotation: passes, ErrNewValSetCantBeTrusted where the
    trusted set vouches for too little, and the adjacency ValueErrors."""
    want, got = verify_both(fn_name, trusted, untrusted)
    assert got == want
    if (fn_name, trusted, untrusted) in (("non_adjacent", 1, 9), ("non_adjacent", 4, 8)):
        assert want[0] == "ErrNewValSetCantBeTrusted"


@pytest.mark.parametrize("case", ["expired", "clock_drift", "future_edge", "wrong_vals",
                                  "old_height", "bad_commit", "next_vals"])
def test_verifier_errors_match_reference(case):
    kw = {}
    fn_name, trusted, untrusted = "non_adjacent", 1, 4
    if case == "expired":
        kw["now"] = CHAIN[1].time_ns + PERIOD
    elif case == "clock_drift":
        kw["now"] = CHAIN[4].time_ns - DRIFT - 1
        kw["period"] = 10 * PERIOD
    elif case == "future_edge":  # new header exactly now + drift: refused
        kw["now"] = CHAIN[4].time_ns - DRIFT
    elif case == "wrong_vals":
        kw["untrusted_vals"] = (CHAIN[8].validator_set, PORT[8].validator_set)
    elif case == "old_height":
        trusted, untrusted = 4, 2
    elif case == "bad_commit":  # the trusting check passes, the light check fails
        jc = commit_variant("bad_third")
        sh = jlight.SignedHeader(CHAIN[4].signed_header.header, jc)
        jb = dict(CHAIN)
        jb[4] = jlight.LightBlock(sh, CHAIN[4].validator_set)
        kw["blocks"] = (jb, {h: carry(lb) for h, lb in jb.items()})
    elif case == "next_vals":  # adjacent, but the set is not the trusted next set
        fn_name, trusted, untrusted = "adjacent", 3, 4
        kw["untrusted_vals"] = (CHAIN[8].validator_set, PORT[8].validator_set)
    want, got = verify_both(fn_name, trusted, untrusted, **kw)
    assert got == want and want != ("ok",)


@pytest.mark.parametrize("case", ["ok", "chain", "time", "hash"])
def test_verify_backwards_matches_reference(case):
    out = []
    for mod, b in ((jver, CHAIN), (tver, PORT)):
        older, newer, chain = b[3].signed_header, b[4].signed_header, CHAIN_ID
        if case == "chain":
            chain = "other"
        elif case == "time":
            older, newer = newer, older
        elif case == "hash":
            older = b[2].signed_header
            newer = b[4].signed_header
        out.append(outcome(lambda: mod.verify_backwards(chain, older, newer)))
    assert out[0] == out[1] and (out[0] == ("ok",)) is (case == "ok")


@pytest.mark.parametrize("level", [(1, 3), (1, 4), (4, 3), (2, 3), (1, 1)])
def test_validate_trust_level_matches_reference(level):
    f = Fraction(*level)
    assert outcome(lambda: tver.validate_trust_level(f)) == outcome(
        lambda: jver.validate_trust_level(f))


def test_header_expired_matches_reference():
    for now in (CHAIN[2].time_ns + PERIOD - 1, CHAIN[2].time_ns + PERIOD):
        assert tver.header_expired(PORT[2].signed_header, PERIOD, now) == jver.header_expired(
            CHAIN[2].signed_header, PERIOD, now)
