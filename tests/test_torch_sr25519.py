"""The port's sr25519 host path (tendermint_tpu_torch/crypto/merlin.py,
crypto/sr25519.py and the native schnorrkel verifier native/sr25519.c)
against the JAX package's (tendermint_tpu/crypto/merlin.py, sr25519.py).

Inputs come from numpy seeds. Tolerance: zero. Transcript challenges,
ristretto encodings and signatures must be byte-identical, verdicts equal,
and the port's generated ed25519_constants.h must equal the reference
generator's text below its first line (which names the file that wrote it).
"""

import os

import numpy as np
import pytest

from tendermint_tpu.crypto import merlin as jmerlin
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.crypto.ed25519_ref import BASE, IDENTITY, L, P, point_add, point_mul
from tendermint_tpu.native import gen_constants
from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as TK
from tendermint_tpu_torch.crypto import merlin as tmerlin
from tendermint_tpu_torch.crypto import sr25519 as tsr

# ristretto255 spec: encodings of B*0 .. B*4 (as tests/test_sr25519.py)
SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
]


def _transcript_ops(rng):
    """A seeded sequence of transcript operations: messages of 0-400 bytes
    (longer than the 166-byte STROBE rate) and challenges of 1-199 bytes."""
    ops = []
    for _ in range(12):
        label = rng.bytes(int(rng.integers(0, 20)))
        if rng.integers(0, 2):
            ops.append(("msg", label, rng.bytes(int(rng.integers(0, 400)))))
        else:
            ops.append(("chal", label, int(rng.integers(1, 200))))
    return ops


def _run(mod, label, ops):
    t = mod.Transcript(label)
    out = []
    for kind, lab, arg in ops:
        if kind == "msg":
            t.append_message(lab, arg)
        else:
            out.append(t.challenge_bytes(lab, arg))
    c = t.clone()  # a clone runs on from the same state
    out.append(c.challenge_bytes(b"clone", 64))
    out.append(t.challenge_bytes(b"clone", 64))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merlin_challenges_equal_reference(seed):
    rng = np.random.default_rng(seed)
    label, ops = rng.bytes(int(rng.integers(1, 30))), _transcript_ops(rng)
    got = _run(tmerlin, label, ops)
    assert got == _run(jmerlin, label, ops)
    assert got[-1] == got[-2]


def test_merlin_transcript_vector():
    """merlin crate test_transcript_it_works."""
    t = tmerlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    cb = t.challenge_bytes(b"challenge", 32)
    assert cb.hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def test_ristretto_small_multiples_equal_reference():
    pt = IDENTITY
    for i, want in enumerate(SMALL_MULTIPLES):
        enc = tsr.ristretto_encode(pt)
        assert enc.hex() == want == jsr.ristretto_encode(pt).hex(), f"B*{i}"
        dec = tsr.ristretto_decode(enc)
        assert dec == jsr.ristretto_decode(enc)
        assert tsr.ristretto_encode(dec) == enc
        pt = point_add(pt, BASE)


def test_ristretto_decode_equals_reference_on_invalid_and_random():
    rng = np.random.default_rng(7)
    encs = [int.to_bytes(P + 1, 32, "little"), int.to_bytes(1, 32, "little"), b"\x00" * 31,
            b"\xff" * 32]
    encs += [rng.bytes(32) for _ in range(48)]
    encs += [tsr.ristretto_encode(point_mul(int(rng.integers(1, 1 << 62)), BASE))
             for _ in range(8)]
    decoded = [tsr.ristretto_decode(e) for e in encs]
    assert decoded == [jsr.ristretto_decode(e) for e in encs]
    assert decoded[:4] == [None] * 4
    assert all(d is not None for d in decoded[-8:])


def _flip_bit(b: bytes, i: int) -> bytes:
    out = bytearray(b)
    out[i // 8] ^= 1 << (i % 8)
    return bytes(out)


def _row(case: str):
    """(pubkey, msg, sig) of one case: a key and a message from numpy seeds 5
    and 6, signed, then altered as the case says."""
    priv = tsr.gen_sr25519(np.random.default_rng(5).bytes(32))
    pk, msg = priv.pub_key().bytes(), b"sr25519 row: " + np.random.default_rng(6).bytes(40)
    sig = priv.sign(msg)
    r, s = sig[:32], int.from_bytes(sig[32:], "little") & ((1 << 255) - 1)
    if case == "honest":
        return pk, msg, sig
    if case == "wrong_message":
        return pk, msg + b"!", sig
    if case == "flipped_bit":
        return pk, msg, _flip_bit(sig, 77)
    if case == "marker_unset":
        return pk, msg, r + s.to_bytes(32, "little")
    if case == "s_ge_l":
        return pk, msg, r + ((s + L) | (1 << 255)).to_bytes(32, "little")
    if case == "noncanonical_r":  # the same field element plus p: s >= p
        return pk, msg, (int.from_bytes(r, "little") + P).to_bytes(32, "little") + sig[32:]
    if case == "short_sig":
        return pk, msg, sig[:63]
    if case == "short_key":
        return pk[:31], msg, sig
    raise KeyError(case)


CASES = ("honest", "wrong_message", "flipped_bit", "marker_unset", "s_ge_l", "noncanonical_r",
         "short_sig", "short_key")


@pytest.mark.parametrize("case", CASES)
def test_verify_equals_reference(case):
    pk, msg, sig = _row(case)
    want = jsr.sr25519_verify(pk, msg, sig)
    assert want == (case == "honest")
    assert tsr._sr25519_verify_py(pk, msg, sig) == want
    assert tsr.sr25519_verify(pk, msg, sig) == want
    assert native.sr25519_verify(pk, msg, sig) == want


def test_native_batch_equals_reference_per_row():
    rows = [_row(c) for c in CASES]
    want = np.array([jsr.sr25519_verify(*r) for r in rows])
    assert want.tolist() == [c == "honest" for c in CASES]
    # the native batch takes fixed-stride rows only: the length-valid ones
    ok = [i for i, (pk, _, sig) in enumerate(rows) if len(pk) == 32 and len(sig) == 64]
    msgs = [rows[i][1] for i in ok]
    moffs = np.concatenate([[0], np.cumsum([len(m) for m in msgs])]).astype(np.int64)
    got = native.sr25519_verify_batch(b"".join(rows[i][0] for i in ok), b"".join(msgs), moffs,
                                      b"".join(rows[i][2] for i in ok))
    assert got.tolist() == want[ok].tolist()
    # batch.py's packing drops the other rows first
    pks, ms, sigs = zip(*rows)
    mask = tbatch._verify_sr25519_rows(pks, ms, sigs, list(range(len(rows))))
    assert mask.tobytes() == want.tobytes()


def test_native_batch_rejects_misaligned_blobs():
    pk, msg, sig = _row("honest")
    with pytest.raises(ValueError, match="signature bytes for 1 rows"):
        native.sr25519_verify_batch(pk, msg, np.array([0, len(msg)], dtype=np.int64), sig[:63])


def test_native_batch_many_keys_equals_python():
    """40 seeded keys and messages, a third of them tampered, on the native
    batch's threads, against the port's pure-Python verifier."""
    rng = np.random.default_rng(11)
    pks, msgs, sigs = [], [], []
    for i in range(40):
        priv = tsr.gen_sr25519(rng.bytes(32))
        msg = rng.bytes(int(rng.integers(0, 120)))
        sig = priv.sign(msg)
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(_flip_bit(sig, int(rng.integers(0, 512))) if i % 3 == 0 else sig)
    moffs = np.concatenate([[0], np.cumsum([len(m) for m in msgs])]).astype(np.int64)
    got = native.sr25519_verify_batch(b"".join(pks), b"".join(msgs), moffs, b"".join(sigs))
    want = [tsr._sr25519_verify_py(*r) for r in zip(pks, msgs, sigs)]
    assert got.tolist() == want
    assert sum(want) == 26


def test_signatures_byte_identical_to_reference(monkeypatch):
    """The same seed and the same signing randomness (os.urandom, which both
    packages draw the witness from) give the same 64 bytes."""
    rng = np.random.default_rng(13)
    for _ in range(3):
        seed, msg, noise = rng.bytes(32), rng.bytes(int(rng.integers(0, 200))), rng.bytes(32)
        monkeypatch.setattr(os, "urandom", lambda n: noise[:n])
        tpriv, jpriv = tsr.gen_sr25519(seed), jsr.gen_sr25519(seed)
        assert tpriv.pub_key().bytes() == jpriv.pub_key().bytes()
        assert tpriv.sign(msg) == jpriv.sign(msg)


def test_pubkey_from_type_and_bytes_sr25519():
    pk = tsr.gen_sr25519(b"\x21" * 32).pub_key()
    got = TK.pubkey_from_type_and_bytes("sr25519", pk.bytes())
    assert got == pk and got.type_name() == "sr25519"
    assert got.address() == jsr.Sr25519PubKey(pk.bytes()).address()
    with pytest.raises(ValueError, match="32 bytes"):
        TK.pubkey_from_type_and_bytes("sr25519", pk.bytes()[:31])


def test_generated_ed25519_header_equals_reference_generator():
    got = native.ed25519_constants_header().splitlines()
    want = gen_constants.generate_ed().splitlines()
    assert got[0].startswith("/* generated") and got[1:] == want[1:]
