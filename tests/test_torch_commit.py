"""Port commit verification (tendermint_tpu_torch/types, convert.py) against
the JAX package on a 600-validator commit.

Tolerance: zero. Sign bytes must be byte-identical; verify_commit must pass
or raise the same exception type with the same message; coordinates carried
over by convert.py must equal the port's own decompression limb for limb.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import gen_ed25519
from tendermint_tpu.ops import ed25519_jax
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.validator_set import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.ops import msm_torch
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader

torch.set_num_threads(2)

CHAIN = "port-chain"
HEIGHT = 9
N = 600
JBID = JBlockID(b"\x11" * 32, JPSH(3, b"\x22" * 32))
TBID = BlockID(b"\x11" * 32, PartSetHeader(3, b"\x22" * 32))


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


@pytest.fixture(autouse=True)
def _cpu_backend(monkeypatch):
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")
    tbatch.reset_a_cache()
    yield
    tbatch.reset_a_cache()


def _sets():
    privs = [gen_ed25519(bytes([7, i % 256, i // 256]) + bytes(29)) for i in range(N)]
    jvs = JValidatorSet([JValidator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    tvs = convert.validator_set_from_rows(
        (v.pub_key.bytes(), v.voting_power) for v in jvs.validators)
    return jvs, tvs, [by_addr[v.address] for v in jvs.validators]


JVS, TVS, PRIVS = _sets()


def _commits(nil_idx=(), absent_idx=(), bad_idx=()):
    """The same signed commit as JAX and port objects."""
    rows = []
    for i, v in enumerate(JVS.validators):
        if i in absent_idx:
            rows.append((JFlag.ABSENT, b"", 0))
        else:
            rows.append((JFlag.NIL if i in nil_idx else JFlag.COMMIT, v.address, 10_000 + 7 * i))
    stub = jblock.Commit(HEIGHT, 1, JBID, [jblock.CommitSig(f, a, ts, b"") for f, a, ts in rows])
    idxs = [i for i, r in enumerate(rows) if r[0] != JFlag.ABSENT]
    msgs = dict(zip(idxs, stub.vote_sign_bytes_many(CHAIN, idxs)))
    jsigs, tsigs = [], []
    for i, (f, a, ts) in enumerate(rows):
        sig = b""
        if f != JFlag.ABSENT:
            sig = PRIVS[i].sign(msgs[i])
            if i in bad_idx:
                sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        jsigs.append(jblock.CommitSig(f, a, ts, sig))
        tsigs.append(tblock.CommitSig(BlockIDFlag(int(f)), a, ts, sig))
    return jblock.Commit(HEIGHT, 1, JBID, jsigs), tblock.Commit(HEIGHT, 1, TBID, tsigs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok",)


def _both(jc, tc, height=HEIGHT, jbid=JBID, tbid=TBID):
    want = _outcome(lambda: JVS.verify_commit(CHAIN, jbid, height, jc))
    with pytest.MonkeyPatch.context() as mp:  # the port on its default arm
        mp.delenv("TMTPU_CRYPTO_BACKEND")
        got = _outcome(lambda: TVS.verify_commit(CHAIN, tbid, height, tc, device="cpu"))
    assert got == want
    return got


def test_valset_and_sign_bytes_match():
    assert [v.address for v in TVS.validators] == [v.address for v in JVS.validators]
    assert TVS.total_voting_power() == JVS.total_voting_power() == 10 * N
    jc, tc = _commits(nil_idx=(3, 400), absent_idx=(10,))
    idxs = [i for i in range(N) if i != 10]
    got = tc.vote_sign_bytes_many(CHAIN, idxs)
    assert got == jc.vote_sign_bytes_many(CHAIN, idxs)
    assert got[5] == tc.vote_sign_bytes(CHAIN, 5) == jc.vote_sign_bytes(CHAIN, 5)


def test_verify_commit_outcomes_match():
    jc, tc = _commits(nil_idx=(3,), absent_idx=(10, 11))
    assert _both(jc, tc) == ("ok",)
    assert tbatch.LAST_FLUSH["mode"] == "plain"
    assert _both(jc, tc, height=HEIGHT + 1)[1].startswith("invalid commit -- wrong height")
    other_j = JBlockID(b"\x33" * 32, JPSH(3, b"\x22" * 32))
    other_t = BlockID(b"\x33" * 32, PartSetHeader(3, b"\x22" * 32))
    assert _both(jc, tc, jbid=other_j, tbid=other_t)[1].startswith(
        "invalid commit -- wrong block ID")
    jc, tc = _commits(bad_idx=(123, 456))
    assert _both(jc, tc) == ("CommitVerifyError", "wrong signature (#123)")
    jc, tc = _commits(nil_idx=tuple(range(250)))
    assert _both(jc, tc)[0] == "NotEnoughVotingPowerError"
    assert tbatch.LAST_FLUSH["mode"] == "cached"  # same keys: the cached-A kernel


def test_convert_carries_jax_a_coords_into_the_cache():
    rows = np.stack([np.frombuffer(v.pub_key.bytes(), dtype=np.uint8) for v in JVS.validators])
    pts, ok = ed25519_jax.decompress(ed25519_jax.make_ctx((N,)), np.ascontiguousarray(rows.T))
    coords = tuple(np.asarray(c) for c in pts)
    carried = convert.a_coords_to_tensor(coords, device="cpu")
    own, own_ok = msm_torch.decompress_rows(rows, device="cpu")
    assert torch.equal(carried, own) and own_ok.all() and np.asarray(ok).all()
    convert.fill_a_cache_from_coords(rows, coords, np.asarray(ok), device="cpu")
    jc, tc = _commits(nil_idx=(1,))
    assert _both(jc, tc) == ("ok",)
    assert tbatch.LAST_FLUSH["mode"] == "cached"  # first port flush already cached
