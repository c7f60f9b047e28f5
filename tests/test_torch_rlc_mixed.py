"""The port's one-MSM mixed Ed25519 + sr25519 flush (tendermint_tpu_torch/
crypto/batch.py: _verify_batch_mixed_routed, _rlc_submit_mixed, the typed A
cache, the mixed submit / finish; ops/msm_torch.py _rlc_core_cached_mixed)
and the device-sort arm (msm_torch.sort_windows_device, TMTPU_DEVICE_SORT)
against the JAX package on seeded rows.

RLC_MIN is lowered to 256 in both packages, so a set of 264 rows (192
Ed25519, 72 sr25519, interleaved) takes the mixed route: 512 A lanes + 256
Ed25519 R + 256 sr25519 R = 1,024 lanes, the fused MSM at a 1,024-lane
chunk. The port runs on device="cpu" (the kernels' plain versions); the
reference's masks come from its host path (verify_batch(backend="cpu")),
its route labels from its own routing under its host twins
(tests/torch_routing_util.py knobs and install_mixed_twins), its memo off.
Each plain mixed check costs ~3-4 s here, so each case runs few. The split
after a failed check runs its Ed25519 rows on the host arm (192 rows,
below the 256-row card floor of a call that names no backend), in both
packages. Tolerance: zero. Masks byte-identical, route labels equal.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvset
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.crypto import scheduler as tsched
from tendermint_tpu_torch.ops import msm_torch
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import vote_set as tvset
from tests.torch_routing_util import install_mixed_twins, knobs, signed_rows  # noqa: F401

torch.set_num_threads(2)

N = 264
SR_RESIDUES = (1, 4, 7)  # row i is sr25519 when i % 11 is one of these: 72 rows


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


@pytest.fixture
def mixed(knobs, monkeypatch):  # noqa: F811
    """knobs, RLC_MIN = 256 in both packages, the reference's mixed twins."""
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", 256)
    install_mixed_twins(monkeypatch)
    return knobs


def _privs():
    return [(jsr.gen_sr25519 if i % 11 in SR_RESIDUES else jkeys.gen_ed25519)(
        bytes([0x6D, i % 256, i // 256]) + bytes(29)) for i in range(N)]


PRIVS = _privs()
_ROWS: dict = {}


def rows():
    """N honest rows, each key signing its own message of 20-22 bytes
    (three message lengths, so the sr25519 challenges run in three
    lockstep groups): lists (pubkeys, msgs, sigs, types)."""
    if not _ROWS:
        for i, p in enumerate(PRIVS):
            msg = b"rlc-mixed-%05d" % i + bytes(i % 3) + b"|" * 5
            _ROWS.setdefault("pks", []).append(p.pub_key().bytes())
            _ROWS.setdefault("msgs", []).append(msg)
            _ROWS.setdefault("sigs", []).append(p.sign(msg))
            _ROWS.setdefault("types", []).append(p.pub_key().type_name())
    return tuple(list(_ROWS[k]) for k in ("pks", "msgs", "sigs", "types"))


ED = [i for i in range(N) if i % 11 not in SR_RESIDUES]
SR = [i for i in range(N) if i % 11 in SR_RESIDUES]


def flip(sig: bytes) -> bytes:
    """Both encodings kept, one bit of s changed below the marker byte."""
    return sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]


def reference(pks, msgs, sigs, types, backend=None):
    """The JAX package: (host-path mask, route label, rlc_fallback)."""
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu", key_types=types)
    jbatch.LAST_FLUSH_DETAIL.clear()
    jb = {None: None, "cuda": "jax"}[backend]
    twin_mask, _, path = jbatch._verify_batch_routed(pks, msgs, sigs, jb, types)
    assert np.asarray(twin_mask).tobytes() == np.asarray(want).tobytes()
    return np.asarray(want), path, jbatch.LAST_FLUSH_DETAIL.get("rlc_fallback")


def check(pks, msgs, sigs, types, backend=None) -> dict:
    """The port against the reference: masks byte-identical, labels and
    rlc_fallback equal. Returns the port's LAST_FLUSH with the mask."""
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=types, backend=backend)
    flush = dict(tbatch.LAST_FLUSH)
    want, path, fallback = reference(pks, msgs, sigs, types, backend)
    assert got.dtype == np.bool_ and got.tobytes() == want.tobytes()
    assert flush["path"] == path
    assert bool(flush.get("rlc_fallback")) == bool(fallback)
    flush["mask"] = got
    return flush


def _one_flush(flush: dict) -> None:
    """The one-MSM route's detail: mode "mixed", 1,024 fused lanes, no
    sr25519 row on the host."""
    assert flush["mode"] == "mixed" and flush["lanes"] == 1024 and flush["fused"]
    assert flush["ed_rows"] == len(ED) and flush["sr_rows"] == len(SR)
    assert "sr25519_rows" not in flush and flush["challenge_s"] > 0


MODES = [("cofactored", None, "rlc-mixed"), ("cofactored", "cuda", "rlc-mixed"),
         ("cofactorless", None, "mixed"), ("cofactorless", "cuda", "rlc-mixed")]


@pytest.mark.parametrize("mode,backend,path", MODES,
                         ids=[f"{m}-{b or 'default'}" for m, b, _ in MODES])
def test_all_valid_in_both_modes(mixed, mode, backend, path):
    """All rows valid: the default arm (the card in cofactored mode, the
    host in cofactorless mode, whose split then runs) and an explicit card
    backend (the one-MSM route in both modes, as the reference honours
    backend="jax" there)."""
    mixed.mode(mode)
    flush = check(*rows(), backend=backend)
    assert flush["path"] == path and flush["mask"].all()
    if path == "rlc-mixed":
        _one_flush(flush)
        pks, _, _, types = rows()
        for i in (ED[0], SR[0]):  # the typed A cache: bare key, b"s" + key
            key = tbatch._cache_key(pks[i], types[i])
            assert len(key) == (33 if types[i] == "sr25519" else 32)
            assert tbatch._A_CACHE[key] is not None
    else:
        assert flush["sr25519_rows"] == len(SR)


def _case(name):
    """(rows, the rows that must be False) of each failing or refused case."""
    pks, msgs, sigs, types = rows()
    if name == "bad_ed_and_sr":
        sigs[ED[3]], sigs[SR[5]] = flip(sigs[ED[3]]), flip(sigs[SR[5]])
        bad = [ED[3], SR[5]]
    elif name == "invalid_ristretto_r":  # an odd s: not a ristretto encoding
        r = bytearray(sigs[SR[2]])
        r[0] |= 1
        sigs[SR[2]] = bytes(r)
        bad = [SR[2]]
    elif name == "no_marker":
        s = bytearray(sigs[SR[7]])
        s[63] &= 0x7F
        sigs[SR[7]] = bytes(s)
        bad = [SR[7]]
    elif name == "s_ge_L":
        big = (ref.L + 3).to_bytes(32, "little")
        sigs[SR[9]] = sigs[SR[9]][:32] + big[:31] + bytes([big[31] | 0x80])
        bad = [SR[9]]
    elif name == "short_key":
        pks[SR[11]] = pks[SR[11]][:31]
        bad = [SR[11]]
    else:
        raise KeyError(name)
    return (pks, msgs, sigs, types), bad


# a failing combined check recovers by the split; a precheck refusal leaves
# the check passing with the row False
CASES = [("bad_ed_and_sr", "mixed"), ("invalid_ristretto_r", "mixed"),
         ("no_marker", "rlc-mixed"), ("s_ge_L", "rlc-mixed"), ("short_key", "rlc-mixed")]


@pytest.mark.parametrize("name,path", CASES, ids=[c for c, _ in CASES])
def test_failing_and_refused_rows(mixed, name, path):
    args, bad = _case(name)
    flush = check(*args)
    assert flush["path"] == path and np.flatnonzero(~flush["mask"]).tolist() == bad
    if path == "mixed":
        assert flush["rlc_fallback"] and flush["combined_s"] > 0
        assert flush["sr25519_rows"] == len(SR)
    else:
        _one_flush(flush)


def test_bls_row_takes_the_split(mixed):
    """A BLS12-381 row in the set: the mixed flush knows two types only, so
    the set takes the exact per-type split."""
    pks, msgs, sigs, types = rows()
    bls = tkeys.gen_bls12_381(b"\x5b" * 32)
    pks[0], msgs[0], types[0] = bls.pub_key().bytes(), b"bls row", "bls12_381"
    sigs[0] = bls.sign(msgs[0])
    flush = check(pks, msgs, sigs, types)
    assert flush["path"] == "mixed" and flush["mask"].all() and not flush.get("rlc_fallback")


def test_planner_engaged_set_takes_the_split(mixed):
    """A set above the planner's chunk rows (a 512-lane budget: 255 rows)
    takes the split, whose Ed25519 rows stream where they exceed it."""
    mixed.planner(512)
    assert tbatch.planner_engaged(N)
    flush = check(*rows())
    assert flush["path"] == "mixed" and flush["mask"].all()


def test_rlc_off_takes_the_split(mixed, monkeypatch):
    monkeypatch.setenv("TMTPU_RLC", "0")
    flush = check(*rows())
    assert flush["path"] == "mixed" and flush["mask"].all()


def test_one_string_as_both_key_types_is_cached_apart(mixed):
    """An sr25519 key's 32 bytes also given as an Ed25519 row's key (that
    row cannot verify): both decodings are cached under their own keys, and
    the honest set then verifies on the one-MSM route with the sr25519
    entry, which an untyped cache would have overwritten."""
    pks, msgs, sigs, types = rows()
    s_key = pks[SR[0]]
    pks[ED[1]] = s_key
    flush = check(pks, msgs, sigs, types)
    assert np.flatnonzero(~flush["mask"]).tolist() == [ED[1]]
    ed_entry, sr_entry = tbatch._A_CACHE[s_key], tbatch._A_CACHE[b"s" + s_key]
    assert sr_entry is not None and ed_entry != sr_entry
    flush = check(*rows())
    assert flush["path"] == "rlc-mixed" and flush["mask"].all() and flush["a_fill_s"] < 0.5


def reference_submit(pks, msgs, sigs, types):
    jtrace.reset_stats()
    mask = jbatch.verify_batch_finish(jbatch.verify_batch_submit(pks, msgs, sigs, None, types))
    return np.asarray(mask), jtrace.verify_stats()["last_flush"].get("path")


@pytest.mark.parametrize("bad", [False, True], ids=["passing", "failing"])
def test_submit_finish(mixed, bad):
    """The mixed set is eligible for the asynchronous flush, as in the
    reference: the submit returns unsynced, a passing finish is
    "rlc-async" mode "mixed", a failing one recovers by the split (path
    "mixed", rlc_fallback) with the reference's mask."""
    args, want_bad = _case("bad_ed_and_sr") if bad else (rows(), [])
    h = tbatch.verify_batch_submit(*args[:3], device="cpu", key_types=args[3])
    assert h._mask is None and h._call.mode == "mixed"
    got = tbatch.verify_batch_finish(h)
    flush = dict(tbatch.LAST_FLUSH)
    want, ref_path = reference_submit(*args)
    assert got.tobytes() == want.tobytes() and np.flatnonzero(~got).tolist() == want_bad
    if bad:
        assert flush["path"] == "mixed" and flush["rlc_fallback"]
        assert flush["sr25519_rows"] == len(SR)
    else:
        assert flush["path"] == ref_path == "rlc-async" and flush["mode"] == "mixed"


def test_memo_answers_a_repeated_call(mixed):
    """With the memo on, a repeated mixed set is answered from it (path
    "memo", no flush), in verify_batch and in verify_batch_submit."""
    tbatch._MEMO = tbatch.VerifiedRowMemo(1 << 12)
    pks, msgs, sigs, types = rows()
    first = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=types)
    assert tbatch.LAST_FLUSH["path"] == "rlc-mixed" and first.all()
    again = tbatch.verify_batch(pks, msgs, sigs, device="cpu", key_types=types)
    assert tbatch.LAST_FLUSH["path"] == "memo" and again.all()
    h = tbatch.verify_batch_submit(pks, msgs, sigs, device="cpu", key_types=types)
    assert h._mask is not None and h._mask.all() and tbatch.LAST_FLUSH["path"] == "memo"
    ed_only = tbatch.verify_batch(pks, msgs, sigs, device="cpu",
                                  key_types=["ed25519"] * N)  # the type is in the digest
    assert tbatch.LAST_FLUSH["path"] != "memo" and not ed_only[SR].any()


# ---------------------------------------------------------------------------
# The callers on a mixed validator set: each takes the one-MSM route.

CHAIN = "rlc-mixed-chain"
HEIGHT, ROUND = 12, 0
JBID = jbasic.BlockID(b"\x2a" * 32, jbasic.PartSetHeader(2, b"\x2b" * 32))
TBID = tbasic.BlockID(b"\x2a" * 32, tbasic.PartSetHeader(2, b"\x2b" * 32))
_SET: dict = {}


def vote_set():
    """The N keys as a validator set in both packages and each validator's
    precommit for JBID in both: (jset, tset, [(jvote, tvote)])."""
    if not _SET:
        jset = jvs.ValidatorSet([jvs.Validator(p.pub_key(), 10 + i % 7)
                                 for i, p in enumerate(PRIVS)])
        priv_of = {p.pub_key().address(): p for p in PRIVS}
        votes = []
        for idx, v in enumerate(jset.validators):
            j = jvote.Vote(type=jbasic.SignedMsgType.PRECOMMIT, block_id=JBID, height=HEIGHT,
                           round=ROUND, timestamp_ns=1_700_000_000_000_000_000 + 1_000 * idx,
                           validator_address=v.address, validator_index=idx)
            sig = priv_of[v.address].sign(j.sign_bytes(CHAIN))
            votes.append((j.with_signature(sig),
                          convert.vote_from_reference(j).with_signature(sig)))
        _SET.update(jset=jset, tset=convert.validator_set_from_reference(jset), votes=votes)
    return _SET["jset"], _SET["tset"], _SET["votes"]


def _last_path():
    return jtrace.verify_stats()["last_flush"].get("path")


def test_callers_take_the_one_msm_route(mixed):
    """VoteSet.flush, verify_commit, begin_verify_commit_light with its
    finish and a scheduler lane, each on the mixed set: the port's labels
    "rlc-mixed" / "rlc-async" (mode "mixed"), the reference's the same."""
    jset, tset, votes = vote_set()
    jv = jvset.VoteSet(CHAIN, HEIGHT, ROUND, jbasic.SignedMsgType.PRECOMMIT, jset,
                       defer_verification=True)
    tv = tvset.VoteSet(CHAIN, HEIGHT, ROUND, tbasic.SignedMsgType.PRECOMMIT, tset,
                       defer_verification=True, device="cpu")
    for j, t in votes:
        assert tv.add_vote(t) == jv.add_vote(j) == "pending"
    jtrace.reset_stats()
    committed, failed = tv.flush()
    assert tbatch.LAST_FLUSH["path"] == "rlc-mixed" and tbatch.LAST_FLUSH["mode"] == "mixed"
    j_committed, j_failed = jv.flush()
    assert _last_path() == "rlc-mixed"
    assert failed == j_failed == [] and len(committed) == len(j_committed) == N
    tcommit, jcommit = tv.make_commit(), jv.make_commit()
    assert tcommit.encode() == jcommit.encode()

    tset.verify_commit(CHAIN, TBID, HEIGHT, tcommit, device="cpu")
    assert tbatch.LAST_FLUSH["path"] == "rlc-mixed"
    jtrace.reset_stats()
    jset.verify_commit(CHAIN, JBID, HEIGHT, jcommit)
    assert _last_path() == "rlc-mixed"

    fin = tset.begin_verify_commit_light(CHAIN, TBID, HEIGHT, tcommit, device="cpu")
    fin()
    assert tbatch.LAST_FLUSH["path"] == "rlc-async" and tbatch.LAST_FLUSH["mode"] == "mixed"
    jtrace.reset_stats()
    jset.begin_verify_commit_light(CHAIN, JBID, HEIGHT, jcommit)()
    assert _last_path() == "rlc-async"

    pks = [v.pub_key.bytes() for v in tset.validators]
    types = [v.pub_key.type_name() for v in tset.validators]
    msgs = tcommit.vote_sign_bytes_many(CHAIN, range(N))
    sigs = [cs.signature for cs in tcommit.signatures]
    sched = tsched.VerifyScheduler(device="cpu")
    try:
        mask = sched.verify_rows("catchup", pks, msgs, sigs, types)
    finally:
        sched.close()
    assert mask.all() and tbatch.LAST_FLUSH["path"] == "rlc-mixed"
    assert [f["rows"] for f in sched.flush_log] == [{"catchup": N}]


# ---------------------------------------------------------------------------
# The device-sort arm.


def test_sort_windows_device_equals_the_host_sort():
    """Random digits with the R block's top windows zero: the same bucket
    ends, and in every window the same set of lanes in each bucket."""
    rng = np.random.default_rng(3)
    n = 1536
    digits = rng.integers(0, 256, size=(n, 32)).astype(np.uint8)
    digits[n // 2:, 16:] = 0
    perm, ends = msm_torch.sort_windows(digits, zero16_from=n // 2)
    dperm, dends = msm_torch.sort_windows_device(torch.from_numpy(digits))
    assert dperm.dtype == dends.dtype == torch.int32
    assert np.array_equal(dends.numpy(), ends)
    dperm = dperm.numpy()
    for w in range(32):
        lo = 0
        for v in np.flatnonzero(np.diff(np.concatenate([[0], ends[w]]))):
            hi = ends[w][v]
            assert sorted(perm[w, lo:hi].tolist()) == sorted(dperm[w, lo:hi].tolist())
            lo = hi


def test_device_sort_arm_masks_equal_the_host_sort(mixed, monkeypatch):
    """A cached-A single flush of 300 Ed25519 rows (one refused by s >= L)
    with TMTPU_DEVICE_SORT=1 and with 0: the same mask and label as each
    other and the reference; the dsort flush says so in LAST_FLUSH."""
    pks, msgs, sigs = signed_rows(300, seed=23)
    s = int.from_bytes(sigs[4][32:], "little")
    sigs[4] = sigs[4][:32] + (s + ref.L).to_bytes(32, "little")
    enc = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pks])
    pts, ok = msm_torch.decompress_rows(enc, "cpu")
    tbatch.fill_a_cache(enc, pts, ok)
    want, path, _ = reference(pks, msgs, sigs, None, "cuda")
    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("TMTPU_DEVICE_SORT", flag)
        got[flag] = (tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cuda"),
                     dict(tbatch.LAST_FLUSH))
    for flag, (mask, flush) in got.items():
        assert mask.tobytes() == want.tobytes() and np.flatnonzero(~mask).tolist() == [4]
        assert flush["path"] == path == "rlc" and flush["mode"] == "cached"
        assert flush.get("device_sort", False) == (flag == "1")
