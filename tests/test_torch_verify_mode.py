"""The Ed25519 verify mode (TMTPU_ED25519_MODE) in the port against the JAX
package: keys.set_verify_mode / cofactorless_mode, Ed25519PubKey.verify,
verify_batch's `backend` routing and ValidatorSet.verify_commit.

Each package keeps its own switch, so every test sets the mode in both and
restores both afterwards. The rows are the edge vectors of
tests/test_ed25519_edge_vectors.py (honest, s + L, small-order A with the
challenge even and odd, non-canonical A, non-canonical and canonical
identity R) and tests/sigutil.torsion_defect_sig(), among honest rows. The
reference runs its default verify_batch with TMTPU_CRYPTO_BACKEND=cpu; the
port runs its default route with the variable unset and device="cpu" (the
kernels' plain versions).

Tolerance: zero. Masks must be byte-identical, verify_commit must pass or
raise the same exception type with the same message, and
Ed25519PubKey.verify must give the reference's verdict, with `cryptography`
present and with it hidden in both packages.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.validator_set import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader
from tests.sigutil import torsion_defect_sig

torch.set_num_threads(2)

MODES = ("cofactored", "cofactorless")
T2_ENC = ref.point_compress((0, ref.P - 1, 1, 0))
IDENTITY_NONCANONICAL = (ref.P + 1).to_bytes(32, "little")


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


@pytest.fixture
def set_mode(monkeypatch):
    """set_mode(m) sets verify mode m in both packages; both are restored."""
    for k in (jkeys, tkeys):
        monkeypatch.setattr(k, "_VERIFY_MODE", k._VERIFY_MODE)

    def apply(mode):
        jkeys.set_verify_mode(mode)
        tkeys.set_verify_mode(mode)

    return apply


def _honest(i: int, msg: bytes):
    priv = jkeys.gen_ed25519(bytes([0x42, i % 256, i // 256]) + bytes(29))
    return priv.pub_key().bytes(), msg, priv.sign(msg)


def _small_order_a(even: bool):
    """A = T2 and s = r: [s]B - [h]A - R = -[h]T2, exact iff h is even."""
    msg = b"mode-small-order-%d" % even
    for r in range(1, 1000):
        r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
        if (ref.sha512_mod_l(r_enc + T2_ENC + msg) % 2 == 0) == even:
            return T2_ENC, msg, r_enc + r.to_bytes(32, "little")
    raise AssertionError("no challenge of the wanted parity in 1000 tries")


def _identity_r(canonical: bool):
    seed = b"\x16" * 32
    pk = ref.public_key(seed)
    a, _ = ref.secret_expand(seed)
    msg = b"mode-identity-R-%d" % canonical
    r_enc = ref.point_compress(ref.IDENTITY) if canonical else IDENTITY_NONCANONICAL
    s = ref.sha512_mod_l(r_enc + pk + msg) * a % ref.L
    return pk, msg, r_enc + s.to_bytes(32, "little")


def edge_rows():
    """(name, (pk, msg, sig)) for every edge vector."""
    pk, msg, sig = _honest(0, b"mode-honest")
    s = int.from_bytes(sig[32:], "little")
    r7 = ref.point_compress(ref.point_mul(7, ref.BASE))
    return [
        ("honest", (pk, msg, sig)),
        ("s_plus_L", (pk, msg, sig[:32] + (s + ref.L).to_bytes(32, "little"))),
        ("small_order_a_even", _small_order_a(True)),
        ("small_order_a_odd", _small_order_a(False)),
        ("non_canonical_a", (IDENTITY_NONCANONICAL, b"mode-nc-A", r7 + (7).to_bytes(32, "little"))),
        ("non_canonical_r", _identity_r(False)),
        ("canonical_identity_r", _identity_r(True)),
        ("torsion_defect", torsion_defect_sig()),
    ]


EDGE = edge_rows()


def rows_of(n: int):
    """n rows: the C1 inputs (the torsion-defect signature 3 times) at n = 3,
    else honest rows with every edge vector spread among them."""
    if n == 3:
        return [torsion_defect_sig()] * 3
    out = [_honest(i + 1, b"mode-row-%d" % i) for i in range(n)]
    for k, (_, row) in enumerate(EDGE):
        out[(k * 37 + 5) % n] = row
    return out


@pytest.mark.parametrize("n", [3, 100, 300, 600])
@pytest.mark.parametrize("mode", MODES)
def test_default_verify_batch_masks_equal_reference(set_mode, mode, n):
    set_mode(mode)
    pks, msgs, sigs = (list(c) for c in zip(*rows_of(n)))
    want = jbatch.verify_batch(pks, msgs, sigs)
    with pytest.MonkeyPatch.context() as mp:  # the port on its default arm
        mp.delenv("TMTPU_CRYPTO_BACKEND")
        got = tbatch.verify_batch(pks, msgs, sigs, device="cpu")
    assert got.dtype == want.dtype == np.bool_
    assert got.tobytes() == want.tobytes()
    torsion = [i for i, row in enumerate(zip(pks, msgs, sigs)) if row == torsion_defect_sig()]
    assert torsion and bool(got[torsion].any()) is (mode == "cofactored")
    # the reference's routing: the host below 256 rows and in cofactorless mode
    assert (tbatch.LAST_FLUSH["path"] == "cpu") is (mode == "cofactorless" or n < 256)
    if mode == "cofactorless":
        assert tbatch.LAST_FLUSH["mode"] == "host_serial"


@pytest.mark.parametrize("mode", MODES)
def test_explicit_cuda_backend_stays_cofactored(set_mode, mode):
    """backend="cuda" is the card path (here on device="cpu") in both modes,
    as the reference honours backend="jax": the cofactored verdicts."""
    set_mode(mode)
    pks, msgs, sigs = (list(c) for c in zip(*rows_of(100)))
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cuda")
    assert tbatch.LAST_FLUSH["mode"] == "persig"
    set_mode("cofactored")
    assert got.tobytes() == jbatch.verify_batch(pks, msgs, sigs).tobytes()


def test_backend_names(set_mode, monkeypatch):
    """An unknown arm raises; "jax", the reference's name for its device arm,
    is the card arm (here on device="cpu"), as TMTPU_CRYPTO_BACKEND=jax is."""
    pk, msg, sig = torsion_defect_sig()
    with pytest.raises(ValueError, match="unknown crypto backend"):
        tbatch.verify_batch([pk], [msg], [sig], device="cpu", backend="bogus")
    set_mode("cofactored")
    assert tbatch.verify_batch([pk], [msg], [sig], device="cpu", backend="jax").all()
    assert tbatch.LAST_FLUSH["mode"] == "persig"
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "jax")
    assert tbatch.backend_default() == "cuda"
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND")
    assert tbatch.backend_default() == "cuda"
    # the host loop in cofactored mode gives the card path's verdicts
    got = tbatch.verify_batch([pk] * 2, [msg] * 2, [sig] * 2, device="cpu", backend="cpu")
    assert tbatch.LAST_FLUSH["mode"] == "host_serial" and got.all()
    set_mode("cofactorless")
    assert tbatch.backend_default() == jbatch.backend_default() == "cpu"


def test_mode_switch_rejects_unknown_modes(set_mode):
    with pytest.raises(ValueError, match="unknown ed25519 verify mode"):
        tkeys.set_verify_mode("zip215")
    set_mode("cofactorless")
    assert tkeys.cofactorless_mode() and jkeys.cofactorless_mode()
    set_mode("cofactored")
    assert not tkeys.cofactorless_mode()


def test_mode_env_var_is_read_at_import():
    """TMTPU_ED25519_MODE picks the port's mode when its keys module is
    imported, and a value that is neither mode raises there."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "from tendermint_tpu_torch.crypto import keys; print(keys.cofactorless_mode())"
    outs = []
    for value in ("cofactorless", "cofactored", "zip215"):
        env = dict(os.environ, TMTPU_ED25519_MODE=value, PYTHONPATH=root)
        outs.append(subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                                   capture_output=True, text=True))
    assert [o.stdout.strip() for o in outs[:2]] == ["True", "False"]
    assert outs[2].returncode != 0 and "TMTPU_ED25519_MODE='zip215'" in outs[2].stderr


@pytest.mark.parametrize("openssl", [True, False], ids=["openssl", "pure_python"])
@pytest.mark.parametrize("mode", MODES)
def test_pubkey_verify_equals_reference(set_mode, monkeypatch, mode, openssl):
    if openssl:
        pytest.importorskip("cryptography")
    else:
        monkeypatch.setattr(jkeys, "_HAVE_OPENSSL", False)
        monkeypatch.setattr(tkeys, "_HAVE_OPENSSL", False)
    set_mode(mode)
    got = {name: tkeys.Ed25519PubKey(pk).verify(msg, sig) for name, (pk, msg, sig) in EDGE}
    want = {name: jkeys.Ed25519PubKey(pk).verify(msg, sig) for name, (pk, msg, sig) in EDGE}
    assert got == want
    assert got["torsion_defect"] is (mode == "cofactored")
    assert got["honest"] and not got["s_plus_L"] and not got["non_canonical_r"]


# ---------------------------------------------------------------------------
# ValidatorSet.verify_commit with a torsion-defect row.

CHAIN = "mode-chain"
HEIGHT = 4
N_VALS = 5
JBID = JBlockID(b"\x21" * 32, JPSH(1, b"\x31" * 32))
TBID = BlockID(b"\x21" * 32, PartSetHeader(1, b"\x31" * 32))


def _commit_pair():
    """A 5-validator set in both packages and one commit whose row from the
    torsion-defect key carries a torsion-defect signature over its own
    precommit sign bytes (the key depends only on the seed, not the
    message); every other row is honestly signed."""
    privs = [jkeys.gen_ed25519(bytes([0x55, i]) + bytes(30)) for i in range(N_VALS - 1)]
    torsion_pk = torsion_defect_sig()[0]
    keys = [p.pub_key().bytes() for p in privs] + [torsion_pk]
    jvs = JValidatorSet([JValidator(jkeys.Ed25519PubKey(k), 10) for k in keys])
    tvs = convert.validator_set_from_rows((v.pub_key.bytes(), 10) for v in jvs.validators)
    by_key = {p.pub_key().bytes(): p for p in privs}
    rows = [(JFlag.COMMIT, v.address, 20_000 + 3 * i) for i, v in enumerate(jvs.validators)]
    stub = jblock.Commit(HEIGHT, 0, JBID, [jblock.CommitSig(f, a, ts, b"") for f, a, ts in rows])
    msgs = stub.vote_sign_bytes_many(CHAIN, range(N_VALS))
    sigs = []
    for v, m in zip(jvs.validators, msgs):
        k = v.pub_key.bytes()
        sigs.append(torsion_defect_sig(msg=m)[2] if k == torsion_pk else by_key[k].sign(m))
    jc = jblock.Commit(HEIGHT, 0, JBID, [jblock.CommitSig(f, a, ts, s)
                                         for (f, a, ts), s in zip(rows, sigs)])
    tc = tblock.Commit(HEIGHT, 0, TBID, [tblock.CommitSig(BlockIDFlag(int(f)), a, ts, s)
                                         for (f, a, ts), s in zip(rows, sigs)])
    torsion_idx = [v.pub_key.bytes() for v in jvs.validators].index(torsion_pk)
    return jvs, tvs, jc, tc, torsion_idx


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok",)


@pytest.mark.parametrize("mode", MODES)
def test_verify_commit_with_torsion_row_follows_mode(set_mode, mode):
    jvs, tvs, jc, tc, k = _commit_pair()
    set_mode(mode)
    want = _outcome(lambda: jvs.verify_commit(CHAIN, JBID, HEIGHT, jc))
    got = _outcome(lambda: tvs.verify_commit(CHAIN, TBID, HEIGHT, tc, device="cpu"))
    assert got == want
    # 5 rows: the host serial loop in both modes, as in the reference
    assert tbatch.LAST_FLUSH["path"] == "cpu" and tbatch.LAST_FLUSH["mode"] == "host_serial"
    if mode == "cofactored":
        assert got == ("ok",)
    else:
        assert got == ("CommitVerifyError", f"wrong signature (#{k})")
