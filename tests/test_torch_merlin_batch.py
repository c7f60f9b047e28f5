"""The port's batched merlin transcripts (tendermint_tpu_torch/crypto/merlin.py
keccak_f1600_batch, BatchStrobe128, BatchTranscript) against the JAX
package's (tendermint_tpu/crypto/merlin.py) and against the port's own
scalar Transcript, and the sr25519 challenges the mixed flush derives with
them (crypto/batch.py _precheck_and_challenge_sr) against the ones
crypto/sr25519.py's verifier uses.

Inputs come from numpy seeds. Tolerance: zero. Permutations, challenge bytes
and challenge scalars must be byte-identical.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import merlin as jmerlin
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import merlin as tmerlin
from tendermint_tpu_torch.crypto import sr25519 as tsr


def test_keccak_batch_matches_reference_and_scalar():
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 1 << 63, size=(5, 25), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    got = tmerlin.keccak_f1600_batch(lanes)
    assert got.tobytes() == jmerlin.keccak_f1600_batch(lanes).tobytes()
    for i in range(lanes.shape[0]):
        st = bytearray(lanes[i].tobytes())
        tmerlin.keccak_f1600(st)
        assert bytes(st) == got[i].tobytes()


# (row message length, second message length, first challenge, second challenge):
# lengths below, at and across the 166-byte STROBE rate, challenges of both sizes
SHAPES = ((0, 32, 64, 32), (40, 166, 64, 64), (165, 7, 200, 64), (333, 400, 1, 199))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}-{b}-{c}-{d}" for a, b, c, d in SHAPES])
def test_batch_transcript_matches_reference_and_scalar(shape):
    """Per-row messages of one length, a shared message, then two
    challenges in a row: the port's batch against the reference's batch and
    against one scalar Transcript a row."""
    len1, len2, c1, c2 = shape
    n = 6
    rng = np.random.default_rng(sum(shape))
    m1 = rng.integers(0, 256, size=(n, len1), dtype=np.uint8)
    shared = rng.bytes(len2)
    out = {}
    for name, mod in (("port", tmerlin), ("ref", jmerlin)):
        bt = mod.BatchTranscript(b"batch-test", n)
        bt.append_message(b"rows", m1)
        bt.append_message(b"shared", shared)
        out[name] = (bt.challenge_bytes(b"first", c1), bt.challenge_bytes(b"second", c2))
    for a, b in zip(out["port"], out["ref"]):
        assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()
    for i in range(n):
        t = tmerlin.Transcript(b"batch-test")
        t.append_message(b"rows", m1[i].tobytes())
        t.append_message(b"shared", shared)
        assert t.challenge_bytes(b"first", c1) == out["port"][0][i].tobytes()
        assert t.challenge_bytes(b"second", c2) == out["port"][1][i].tobytes()


def _sr_rows(n: int, seed: int):
    """n sr25519 rows of seeded keys; message lengths 0-300 bytes, some
    repeated so that a length group holds several rows."""
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.choice([0, 3, 110, 166, 167, 300], size=n)]
    pks, msgs, sigs = [], [], []
    for i, ln in enumerate(lengths):
        priv = tsr.gen_sr25519(rng.bytes(32))
        msg = rng.bytes(ln)
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(priv.sign(msg))
    return pks, msgs, sigs


def _challenge(pk: bytes, msg: bytes, r: bytes) -> int:
    """k as crypto/sr25519.py's verifier derives it (scalar transcripts)."""
    t = tsr._sign_transcript(tsr._context_transcript(msg), pk)
    t.append_message(b"sign:R", r)
    return tsr._scalar_from_wide(t.challenge_bytes(b"sign:c", 64))


def test_mixed_flush_challenges_equal_the_verifiers():
    """_precheck_and_challenge_sr over 12 rows in 6 length groups: k equals
    the port's scalar derivation and the reference's (jsr, on the same
    transcript), row for row; s is the marker-cleared scalar."""
    pks, msgs, sigs = _sr_rows(12, seed=4)
    pc, a_rows, r_rows, s_rows, k_rows = tbatch._precheck_and_challenge_sr(pks, msgs, sigs)
    assert pc.all()
    for i in range(len(pks)):
        k = int.from_bytes(k_rows[i].tobytes(), "little")
        assert k == _challenge(pks[i], msgs[i], sigs[i][:32])
        jt = jsr._sign_transcript(jsr._context_transcript(msgs[i]), pks[i])
        jt.append_message(b"sign:R", sigs[i][:32])
        assert k == jsr._scalar_from_wide(jt.challenge_bytes(b"sign:c", 64))
        assert a_rows[i].tobytes() == pks[i] and r_rows[i].tobytes() == sigs[i][:32]
        s = bytearray(sigs[i][32:])
        s[31] &= 0x7F
        assert s_rows[i].tobytes() == bytes(s)


def test_mixed_flush_sr_precheck():
    """The precheck refuses a missing marker bit, s >= L, a 31-byte key and
    a 63-byte signature, and leaves their k zero; the other rows keep
    theirs."""
    pks, msgs, sigs = _sr_rows(6, seed=5)
    s = bytearray(sigs[0])
    s[63] &= 0x7F
    sigs[0] = bytes(s)
    big = (tsr.L + 5).to_bytes(32, "little")
    sigs[1] = sigs[1][:32] + big[:31] + bytes([big[31] | 0x80])
    pks[2] = pks[2][:31]
    sigs[3] = sigs[3][:63]
    pc, _, _, _, k_rows = tbatch._precheck_and_challenge_sr(pks, msgs, sigs)
    assert pc.tolist() == [False, False, False, False, True, True]
    assert not k_rows[:4].any() and k_rows[4:].any(axis=1).all()
    for i in (4, 5):
        assert int.from_bytes(k_rows[i].tobytes(), "little") == _challenge(pks[i], msgs[i],
                                                                           sigs[i][:32])
