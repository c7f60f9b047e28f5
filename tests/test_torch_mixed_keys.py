"""Port per-key-type routing (tendermint_tpu_torch/crypto/batch.verify_batch
with key_types, and ValidatorSet.verify_commit on sets mixing Ed25519 with
BLS12-381 or sr25519 keys) against the JAX package.

Tolerance: zero. The port's masks must be byte-identical to the reference's
verify_batch(..., backend="cpu", key_types=...); verify_commit must pass, or
raise the same exception type with the same message, as the reference's.
A host BLS verify costs about a second here, so each case holds 1 or 2 BLS
rows and the reference's results are computed once per module. sr25519
rows (every fifth row from row 1 in the sr25519 cases) are signed once per
module with the port's signer; both packages verify them natively on the
host.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import keys as JK
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.validator_set import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as TK
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader

torch.set_num_threads(2)

CHAIN = "mixed-key-chain"
HEIGHT = 11
JBID = JBlockID(b"\x0a" * 32, JPSH(2, b"\x0b" * 32))
TBID = BlockID(b"\x0a" * 32, PartSetHeader(2, b"\x0b" * 32))

ED = [JK.gen_ed25519(bytes([0x31 + i]) * 32) for i in range(3)]
BLS = [TK.gen_bls12_381(bytes([0x61 + i]) * 32) for i in range(2)]


@pytest.fixture(autouse=True)
def _cpu_backend(monkeypatch):
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")


def _flip(sig: bytes) -> bytes:
    return sig[:-1] + bytes([sig[-1] ^ 1])


def _rows():
    """3 Ed25519 rows then 2 BLS rows, honest: (pubkeys, msgs, sigs, types)."""
    pks, msgs, sigs, types = [], [], [], []
    for i, p in enumerate(ED + BLS):
        msg = b"mixed row %d" % i
        pks.append(p.pub_key().bytes())
        msgs.append(msg)
        sigs.append(p.sign(msg))
        types.append(p.pub_key().type_name())
    return pks, msgs, sigs, types


HONEST = _rows()


def _case(name):
    pks, msgs, sigs, types = (list(x) for x in HONEST)
    if name == "ed_only":
        return pks[:3], msgs[:3], sigs[:3], types[:3]
    if name == "ed_bls":
        pass
    elif name == "bad_rows":  # a bad Ed25519 row and a bad BLS row
        sigs[1] = _flip(sigs[1])
        sigs[4] = _flip(sigs[4])
    elif name == "short_bls_sig":  # 95 bytes: False before any pairing
        sigs[3] = sigs[3][:95]
    elif name == "unknown_type":  # an Ed25519-valid triple under another type
        types[0] = "secp256k1"
        types[4] = "secp256k1"
    else:
        raise KeyError(name)
    return pks, msgs, sigs, types


CASES = ("ed_only", "ed_bls", "bad_rows", "short_bls_sig", "unknown_type")


@pytest.fixture(scope="module")
def reference_masks():
    """The reference's mask per case, computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            pks, msgs, sigs, types = _case(name)
            cache[name] = np.asarray(jbatch.verify_batch(pks, msgs, sigs, backend="cpu",
                                                         key_types=types))
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_verify_batch_key_types_matches_reference(name, reference_masks):
    pks, msgs, sigs, types = _case(name)
    want = reference_masks(name)
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=types)
    assert got.dtype == np.bool_ and got.tobytes() == want.tobytes()
    expect = {"ed_only": [1, 1, 1], "ed_bls": [1] * 5, "bad_rows": [1, 0, 1, 1, 0],
              "short_bls_sig": [1, 1, 1, 0, 1], "unknown_type": [0, 1, 1, 1, 0]}[name]
    assert got.tolist() == [bool(x) for x in expect]


def test_all_ed25519_key_types_take_the_plain_path(reference_masks):
    pks, msgs, sigs, types = _case("ed_only")
    want = reference_masks("ed_only")
    for kt in (types, None):
        tbatch.LAST_FLUSH.clear()
        got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=kt)
        assert got.tobytes() == want.tobytes()
        # the plain (not the per-type) routing: 3 rows take the host serial loop
        assert set(tbatch.LAST_FLUSH) == {"mode", "total_s", "path"}
        assert tbatch.LAST_FLUSH["mode"] == "host_serial" and tbatch.LAST_FLUSH["path"] == "cpu"


# ---------------------------------------------------------------------------
# sr25519 rows: the native schnorrkel verifier on the host.

SR_SIZES = (3, 64, 300)
SR_CASES = ("ed_sr", "ed_sr_bls", "bad_sr_rows", "short_sr_sig", "sr_unknown_type")
_SR_ROWS = {}


def _sr_rows(n):
    """n honest rows, sr25519 at i % 5 == 1 and Ed25519 elsewhere, each from
    its own seeded key: (pubkeys, msgs, sigs, types)."""
    if n not in _SR_ROWS:
        rng = np.random.default_rng(n)
        pks, msgs, sigs, types = [], [], [], []
        for i in range(n):
            priv = (tsr.gen_sr25519 if i % 5 == 1 else JK.gen_ed25519)(rng.bytes(32))
            msg = b"sr row %d " % i + rng.bytes(int(rng.integers(0, 110)))
            pks.append(priv.pub_key().bytes())
            msgs.append(msg)
            sigs.append(priv.sign(msg))
            types.append(priv.type_name())
        _SR_ROWS[n] = pks, msgs, sigs, types
    return tuple(list(x) for x in _SR_ROWS[n])


def _sr_case(name, n):
    """The case's rows and the rows that must be False."""
    pks, msgs, sigs, types = _sr_rows(n)
    sr = [i for i, t in enumerate(types) if t == "sr25519"]
    bad = []
    if name == "ed_sr_bls":  # the last row a BLS row, honest
        pks[-1], msgs[-1], sigs[-1], types[-1] = (x[3] for x in HONEST)
    elif name == "bad_sr_rows":  # a flipped sr25519 signature, the last one's marker unset
        sigs[sr[0]] = _flip(sigs[sr[0]])
        s = bytearray(sigs[sr[-1]])
        s[63] &= 0x7F
        sigs[sr[-1]] = bytes(s)
        bad = sorted({sr[0], sr[-1]})
    elif name == "short_sr_sig":  # 63 bytes: False before packing
        sigs[sr[0]] = sigs[sr[0]][:63]
        bad = [sr[0]]
    elif name == "sr_unknown_type":  # an sr25519 triple under another type, and an
        types[sr[0]] = "secp256k1"      # Ed25519 triple read as sr25519
        types[0] = "sr25519"
        bad = [0, sr[0]]
    elif name != "ed_sr":
        raise KeyError(name)
    return (pks, msgs, sigs, types), bad


@pytest.fixture(scope="module")
def reference_sr_masks():
    cache = {}

    def get(name, n):
        if (name, n) not in cache:
            (pks, msgs, sigs, types), _ = _sr_case(name, n)
            cache[name, n] = np.asarray(jbatch.verify_batch(pks, msgs, sigs, backend="cpu",
                                                            key_types=types))
        return cache[name, n]

    return get


@pytest.mark.parametrize("n", SR_SIZES)
@pytest.mark.parametrize("name", SR_CASES)
def test_sr25519_rows_match_reference(name, n, reference_sr_masks):
    (pks, msgs, sigs, types), bad = _sr_case(name, n)
    want = reference_sr_masks(name, n)
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=types)
    assert got.dtype == np.bool_ and got.tobytes() == want.tobytes()
    assert np.flatnonzero(~got).tolist() == bad
    assert tbatch.LAST_FLUSH["sr25519_rows"] == types.count("sr25519")
    assert tbatch.LAST_FLUSH["sr25519_s"] > 0


# ---------------------------------------------------------------------------
# verify_commit on a mixed set.


SR = [tsr.gen_sr25519(bytes([0x91 + i]) * 32) for i in range(2)]


def _port_key(pk):
    kind = pk.type_name()
    return {"ed25519": TK.Ed25519PubKey, "bls12_381": TK.Bls12381PubKey,
            "sr25519": tsr.Sr25519PubKey}[kind](pk.bytes())


def _sets(others, ref_key):
    """The 3 Ed25519 keys and `others` as a reference set and a port set
    (power 10 each), and the private keys in set order."""
    jvs = JValidatorSet([JValidator(p.pub_key(), 10) for p in ED]
                        + [JValidator(ref_key(p.pub_key().bytes()), 10) for p in others])
    tv = tvs.ValidatorSet([tvs.Validator(_port_key(v.pub_key), v.voting_power)
                           for v in jvs.validators])
    by_addr = {p.pub_key().address(): p for p in ED + others}
    return jvs, tv, [by_addr[v.address] for v in jvs.validators]


SETS = {"bls12_381": _sets(BLS, JK.Bls12381PubKey), "sr25519": _sets(SR, jsr.Sr25519PubKey)}


def _commits(bad_idx=None, nil_idx=(), kind="bls12_381"):
    jvs, _, privs = SETS[kind]
    rows = [(JFlag.NIL if i in nil_idx else JFlag.COMMIT, v.address, 5_000 + i)
            for i, v in enumerate(jvs.validators)]
    stub = tblock.Commit(HEIGHT, 0, TBID, [tblock.CommitSig(BlockIDFlag(int(f)), a, ts, b"")
                                           for f, a, ts in rows])
    sigs = []
    for i, p in enumerate(privs):
        sig = p.sign(stub.vote_sign_bytes(CHAIN, i))
        sigs.append(_flip(sig) if i == bad_idx else sig)
    return (jblock.Commit(HEIGHT, 0, JBID, [jblock.CommitSig(f, a, ts, s)
                                            for (f, a, ts), s in zip(rows, sigs)]),
            tblock.Commit(HEIGHT, 0, TBID, [tblock.CommitSig(BlockIDFlag(int(f)), a, ts, s)
                                            for (f, a, ts), s in zip(rows, sigs)]))


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok",)


def _first(kind, other="bls12_381"):
    return next(i for i, v in enumerate(SETS[other][0].validators)
                if v.pub_key.type_name() == kind)


def _check_commit(case, other):
    kw = {"honest": {}, "bad_other": {"bad_idx": _first(other, other)},
          "bad_ed": {"bad_idx": _first("ed25519", other)},
          "subthreshold": {"nil_idx": (_first("ed25519", other), _first(other, other))}}[case]
    jvs, tv, _ = SETS[other]
    jc, tc = _commits(kind=other, **kw)
    want = _outcome(lambda: jvs.verify_commit(CHAIN, JBID, HEIGHT, jc))
    got = _outcome(lambda: tv.verify_commit(CHAIN, TBID, HEIGHT, tc, device="cpu"))
    assert got == want
    if case == "honest":
        assert got == ("ok",)
    elif case == "subthreshold":  # 30 of 50 power for the block
        assert got == ("NotEnoughVotingPowerError",
                       "invalid commit -- insufficient voting power: got 30, needed more than 33")
    else:
        assert got == ("CommitVerifyError", f"wrong signature (#{kw['bad_idx']})")


@pytest.mark.parametrize("case", ["honest", "bad_bls", "bad_ed", "subthreshold"])
def test_verify_commit_on_a_mixed_set_matches_reference(case):
    _check_commit({"bad_bls": "bad_other"}.get(case, case), "bls12_381")


@pytest.mark.parametrize("case", ["honest", "bad_sr", "bad_ed", "subthreshold"])
def test_verify_commit_on_an_ed_sr_set_matches_reference(case):
    _check_commit({"bad_sr": "bad_other"}.get(case, case), "sr25519")
