"""Port BLS aggregate-commit verification (tendermint_tpu_torch/types:
ValidatorSet.verify_aggregate_commit, AggregateCommit; crypto/keys BLS keys
and the PoP registry) against the JAX package on 7-validator sets.

Tolerance: zero. For every case the port must pass, or raise the same
exception type with the same message, as the JAX package's
verify_aggregate_commit: good, tampered, subthreshold, rogue key (PoP
dropped), the structural rejections of tests/test_bls_commit.py:128 onward,
the infinity signature (an identity pair) and a plain Commit routed to
verify_commit. The port runs on the CPU (device="cpu"): the fold and the
Miller loop through the kernels' plain versions.
"""

import pytest
import torch

from tendermint_tpu.crypto import keys as JK
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.validator_set import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import bls_ref as B
from tendermint_tpu_torch.crypto import keys as TK
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader

torch.set_num_threads(2)

CHAIN = "bls-commit-chain"
HEIGHT = 5
TS = 123456789
JBID = JBlockID(b"\x07" * 32, JPSH(1, b"\x08" * 32))
TBID = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
N = 7


def _sets():
    privs = [TK.gen_bls12_381(bytes([0x50 + i]) * 32) for i in range(N)]
    pks = [p.pub_key() for p in privs]
    jvs = JValidatorSet([JValidator(JK.Bls12381PubKey(pk.bytes()), 10) for pk in pks])
    tvals = convert.validator_set_from_rows(
        ((v.pub_key.bytes(), v.voting_power) for v in jvs.validators), key_type="bls12_381")
    by_addr = {pk.address(): p for pk, p in zip(pks, privs)}
    return jvs, tvals, [by_addr[v.address] for v in jvs.validators]


JVS, TVS, PRIVS = _sets()


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """Both PoP registries hold every key (registration is a pairing per key:
    the real path is checked once, in test_register_pop_matches_reference)."""
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")
    for reg in (JK._POP_VERIFIED, TK._POP_VERIFIED):
        reg.clear()
        reg.update(v.pub_key.bytes() for v in JVS.validators)
    yield
    JK.clear_pop_registry()
    TK.clear_pop_registry()


def _agg(idxs, height=HEIGHT, ts=TS):
    """One aggregate commit as a JAX and a port object (same bytes)."""
    bm = tblock.AggregateCommit.bitmap_of(idxs, N)
    msg = tblock.AggregateCommit(height, 0, TBID, ts, bm, b"").sign_bytes(CHAIN)
    sig = B.aggregate_signatures([PRIVS[i].sign(msg) for i in idxs])
    return pair(height, ts, bm, sig)


def pair(height, ts, bm, sig):
    return (jblock.AggregateCommit(height, 0, JBID, ts, bm, sig),
            tblock.AggregateCommit(height, 0, TBID, ts, bm, sig))


GOOD = _agg(list(range(N)))


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok",)


def _both(jc, tc, height=HEIGHT, jbid=JBID, tbid=TBID, jvs=JVS, tv=TVS):
    want = _outcome(lambda: jvs.verify_aggregate_commit(CHAIN, jbid, height, jc))
    got = _outcome(lambda: tv.verify_aggregate_commit(CHAIN, tbid, height, tc, device="cpu"))
    assert got == want
    return got


def test_valset_sign_bytes_and_bitmap_match():
    assert [v.address for v in TVS.validators] == [v.address for v in JVS.validators]
    jc, tc = GOOD
    assert tc.sign_bytes(CHAIN) == jc.sign_bytes(CHAIN)
    assert tc.signer_indices() == jc.signer_indices() == list(range(N))
    assert tc.has_signer(6) and not tc.has_signer(7) and not tc.has_signer(99)
    assert tblock.AggregateCommit.bitmap_of([0, 2, 9], 12) == jblock.AggregateCommit.bitmap_of(
        [0, 2, 9], 12)
    with pytest.raises(ValueError, match="out of range"):
        tblock.AggregateCommit.bitmap_of([12], 12)


def _flip_last(sig):
    return sig[:-1] + bytes([sig[-1] ^ 1])


def _case(name):
    jc, tc = GOOD
    if name == "good":
        return GOOD
    if name == "tampered":
        return pair(HEIGHT, TS, tc.signers, _flip_last(tc.agg_signature))
    if name == "wrong_scalar":  # a valid G2 point that is the wrong signature
        return pair(HEIGHT, TS, tc.signers, B.aggregate_signatures([tc.agg_signature, PRIVS[0].sign(b"x")]))
    if name == "subthreshold":
        return _agg([0, 1])
    if name == "infinity_signature":
        return pair(HEIGHT, TS, tc.signers, b"\xc0" + bytes(95))
    if name == "other_timestamp":  # changes the signed message
        return pair(HEIGHT, TS + 1, tc.signers, tc.agg_signature)
    if name == "malformed_signature":
        return pair(HEIGHT, TS, tc.signers, bytes(96))
    if name == "index_out_of_range":
        return pair(HEIGHT, TS, b"\xff\xff", tc.agg_signature)
    if name == "short_signature":
        return pair(HEIGHT, TS, tc.signers, bytes(95))
    if name == "empty_bitmap":
        return pair(HEIGHT, TS, bytes(1), tc.agg_signature)
    if name == "negative_height":
        return pair(-1, TS, tc.signers, tc.agg_signature)
    raise KeyError(name)


@pytest.mark.parametrize("name, kind", [
    ("good", "ok"),
    ("tampered", "CommitVerifyError"),
    ("wrong_scalar", "CommitVerifyError"),
    ("subthreshold", "NotEnoughVotingPowerError"),
    ("infinity_signature", "CommitVerifyError"),
    ("other_timestamp", "CommitVerifyError"),
    ("malformed_signature", "CommitVerifyError"),
    ("index_out_of_range", "CommitVerifyError"),
    ("short_signature", "ValueError"),
    ("empty_bitmap", "ValueError"),
    ("negative_height", "ValueError"),
])
def test_verdicts_and_messages_match(name, kind):
    jc, tc = _case(name)
    height = jc.height
    assert _both(jc, tc, height=height)[0] == kind


def test_wrong_height_and_block_id_match():
    jc, tc = GOOD
    assert _both(jc, tc, height=HEIGHT + 1)[1].startswith("invalid commit -- wrong height")
    other_j = JBlockID(b"\x09" * 32, JPSH(1, b"\x08" * 32))
    other_t = BlockID(b"\x09" * 32, PartSetHeader(1, b"\x08" * 32))
    assert _both(jc, tc, jbid=other_j, tbid=other_t)[1].startswith("invalid commit -- wrong block ID")


def test_rogue_key_without_pop_is_rejected_like_the_reference():
    drop = JVS.validators[3].pub_key.bytes()
    JK._POP_VERIFIED.discard(drop)
    TK._POP_VERIFIED.discard(drop)
    got = _both(*GOOD)
    assert got == ("CommitVerifyError", "invalid commit -- validator #3 has no verified proof "
                                        "of possession (rogue-key defense)")


def test_good_commit_stages_and_apk():
    """The good case on the port alone: the stage record and the apk against
    bls_ref.aggregate_pubkeys by compressed encoding."""
    _, tc = GOOD
    TVS.verify_aggregate_commit(CHAIN, TBID, HEIGHT, tc, device="cpu")
    st = tvs.LAST_AGGREGATE
    assert st["signers"] == N and st["pairing_ok"] is True
    for k in ("keys_s", "fold_s", "sig_decode_s", "hash_to_g2_s", "miller_s", "final_exp_s"):
        assert st[k] >= 0
    apk = st["apk"]
    ref = B.aggregate_pubkeys([v.pub_key.bytes() for v in TVS.validators])
    assert B.g1_to_bytes((B._G1Field(apk[0]), B._G1Field(apk[1]), B._G1Field(1))) == \
        B.g1_to_bytes(ref)
    pk = TVS.validators[0].pub_key.bytes()
    x, y = B._jac_to_affine(B.g1_from_bytes(pk))
    assert tvs._bls_pubkey_coords(pk) == (x.v, y.v)


def _mixed_sets():
    ed = [JK.gen_ed25519(bytes([i + 1]) * 32) for i in range(3)]
    bls = PRIVS[:3]
    jvs = JValidatorSet([JValidator(p.pub_key(), 10) for p in ed]
                        + [JValidator(JK.Bls12381PubKey(p.pub_key().bytes()), 10) for p in bls])
    tv = tvs.ValidatorSet([tvs.Validator(
        TK.Ed25519PubKey(v.pub_key.bytes()) if v.pub_key.type_name() == "ed25519"
        else TK.Bls12381PubKey(v.pub_key.bytes()), v.voting_power) for v in jvs.validators])
    by_addr = {p.pub_key().address(): p for p in ed + list(bls)}
    return jvs, tv, [by_addr[v.address] for v in jvs.validators]


def test_non_bls_signer_is_rejected_like_the_reference():
    jvs, tv, _ = _mixed_sets()
    ed_idx = next(i for i, v in enumerate(jvs.validators) if v.pub_key.type_name() == "ed25519")
    bm = tblock.AggregateCommit.bitmap_of([ed_idx], 6)
    jc, tc = pair(HEIGHT, TS, bm, GOOD[1].agg_signature)
    got = _both(jc, tc, jvs=jvs, tv=tv)
    assert got == ("CommitVerifyError", f"invalid commit -- validator #{ed_idx} is ed25519, "
                                        "cannot join a BLS aggregate")


def _plain_commits(vals, privs, bad_idx=None):
    rows = [(v.address, 1) for v in vals.validators]
    stub = tblock.Commit(HEIGHT, 0, TBID, [tblock.CommitSig(BlockIDFlag.COMMIT, a, ts, b"")
                                           for a, ts in rows])
    sigs = []
    for i, p in enumerate(privs):
        sig = p.sign(stub.vote_sign_bytes(CHAIN, i))
        sigs.append(_flip_last(sig) if i == bad_idx else sig)
    return (jblock.Commit(HEIGHT, 0, JBID, [jblock.CommitSig(JFlag.COMMIT, a, ts, s)
                                            for (a, ts), s in zip(rows, sigs)]),
            tblock.Commit(HEIGHT, 0, TBID, [tblock.CommitSig(BlockIDFlag.COMMIT, a, ts, s)
                                            for (a, ts), s in zip(rows, sigs)]))


def test_plain_commit_routes_to_verify_commit():
    privs = [JK.gen_ed25519(bytes([i + 1]) * 32) for i in range(4)]
    jvs = JValidatorSet([JValidator(p.pub_key(), 10) for p in privs])
    tv = convert.validator_set_from_rows((v.pub_key.bytes(), v.voting_power) for v in jvs.validators)
    ordered = [{p.pub_key().address(): p for p in privs}[v.address] for v in jvs.validators]
    assert _both(*_plain_commits(jvs, ordered), jvs=jvs, tv=tv) == ("ok",)
    got = _both(*_plain_commits(jvs, ordered, bad_idx=2), jvs=jvs, tv=tv)
    assert got == ("CommitVerifyError", "wrong signature (#2)")


def test_bls_key_in_a_plain_commit_raises():
    """A plain Commit on a set holding BLS keys: the port verifies its rows
    per key type, as the reference does, and neither side raises; a bad BLS
    row raises the same CommitVerifyError on both (the name is kept from
    when the port raised NotImplementedError here)."""
    jvs, tv, privs = _mixed_sets()
    jc, tc = _plain_commits(jvs, privs)
    assert _both(jc, tc, jvs=jvs, tv=tv) == ("ok",)  # routed to verify_commit
    bad = next(i for i, v in enumerate(jvs.validators) if v.pub_key.type_name() == "bls12_381")
    got = _both(*_plain_commits(jvs, privs, bad_idx=bad), jvs=jvs, tv=tv)
    assert got == ("CommitVerifyError", f"wrong signature (#{bad})")


def test_register_pop_matches_reference():
    TK.clear_pop_registry()
    JK.clear_pop_registry()
    p = PRIVS[0]
    pk = p.pub_key().bytes()
    assert TK.register_pop(pk, PRIVS[1].pop_prove()) is False
    assert not TK.pop_verified(pk)
    proof = p.pop_prove()
    assert proof == JK.Bls12381PrivKey(p.seed).pop_prove()
    assert TK.register_pop(pk, proof) is True and TK.pop_verified(pk)
    assert JK.register_pop(pk, proof) is True


@pytest.mark.parametrize("type_name, data", [
    ("bls12_381", None),  # a real key: accepted
    ("bls12_381", bytes(48)),
    ("bls12_381", b"\xc0" + bytes(47)),  # the identity
    ("ed25519", b"\xff" * 32),  # y >= p
    ("ed25519", bytes(31)),
    ("unknown", bytes(32)),
])
def test_pubkey_ingestion_matches_reference(type_name, data):
    data = PRIVS[0].pub_key().bytes() if data is None else data
    want = _outcome(lambda: JK.pubkey_from_type_and_bytes(type_name, data))
    got = _outcome(lambda: TK.pubkey_from_type_and_bytes(type_name, data))
    assert got == want
    for sr in (bytes(32), bytes(31)):  # sr25519 ingestion as the reference's
        assert (_outcome(lambda: TK.pubkey_from_type_and_bytes("sr25519", sr))
                == _outcome(lambda: JK.pubkey_from_type_and_bytes("sr25519", sr)))


def test_bls_keys_match_reference():
    p = PRIVS[4]
    jp = JK.Bls12381PrivKey(p.seed)
    assert p.pub_key().bytes() == jp.pub_key().bytes()
    assert p.pub_key().address() == jp.pub_key().address()
    assert p.sign(b"m") == jp.sign(b"m")
    assert repr(p) == "Bls12381PrivKey(<redacted>)"
    with pytest.raises(ValueError):
        TK.Bls12381PubKey(bytes(47))
