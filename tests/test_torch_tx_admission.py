"""Device-batched CheckTx admission in the port against the JAX package's
(tests/test_tx_admission.py:33-268), tolerance 0: the signed-tx envelope and
its domain separation, the sig_precheck request field, verdicts consumed by
SignedKVStoreApplication (`serial_verifies`, `precheck_consumed`,
`prechecked_total` equal), plain and oversized txs skipping the lane, a
duplicate resident costing no second verify, one lane submit for a
check_tx_batch, the post-commit recheck on the lane, and WAL replay of
signed txs. Every tx is signed once with the reference's keys (OpenSSL) and
the same bytes go to both packages; the reference's scheduler runs its host
arm (`VerifyScheduler(backend="cpu")`), and so does the port's in the
side-by-side cases.

Port only: a 300-tx check_tx_batch with `device="cpu"` and no backend set
takes the card arm's plain kernels (300 rows are below RLC_MIN = 512, so
the route is the per-signature ladder, `persig`), and with 3 bad
signatures gives the reference's codes; a scheduler that raises makes the
port's check_tx_batch raise (the reference degrades to the app's serial
verify, `test_precheck_survives_broken_scheduler`; the port does not,
ROADMAP D1).
"""

import dataclasses
import os

import numpy as np
import pytest

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as tbatch
from tests.test_torch_consensus_util import Pkg

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261021
PRIV = REF.keys.gen_ed25519(b"\x2a" * 32)


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _signed(payloads, priv=PRIV):
    return [REF.signed_tx.encode_signed_tx(priv, p) for p in payloads]


def _flip(tx: bytes) -> bytes:
    b = bytearray(tx)
    b[40] ^= 0xFF  # inside the signature
    return bytes(b)


def _pool(P, **kw):
    app = P.kvstore.SignedKVStoreApplication()
    port = {"device": "cpu"} if P is PORT else {}
    sched = P.scheduler.VerifyScheduler(backend="cpu", **port)
    mp = P.mempool.Mempool(P.client.LocalClient(app), scheduler=sched, sig_precheck=True, **kw)
    return mp, app, sched


def _counts(mp, app, sched):
    lane = sched.stats()["lanes"]["admission"]
    adm = [f["rows"]["admission"] for f in list(sched.flush_log) if "admission" in f["rows"]]
    return (app.serial_verifies, app.precheck_consumed, mp.prechecked_total,
            lane["rows_total"], adm, [m.tx for m in mp._txs.values()])


def _code(fn, *a, **kw):
    try:
        r = fn(*a, **kw)
    except Exception as e:  # the reference and the port raise the same types
        return (type(e).__name__, getattr(e, "reason", None))
    if isinstance(r, list):
        return [None if x is None else x.code for x in r]
    return None if r is None else r.code


def _both(scenario, **kw):
    out = []
    for P in (REF, PORT):
        mp, app, sched = _pool(P, **kw)
        try:
            out.append((scenario(P, mp), _counts(mp, app, sched)))
        finally:
            sched.close()
    assert out[1] == out[0]
    return out[0]


def test_envelope_bytes_and_domain_separation():
    rng = np.random.default_rng(SEED)
    payloads = [rng.bytes(int(rng.integers(0, 40))) for _ in range(6)]
    port_priv = PORT.keys.gen_ed25519(b"\x2a" * 32)
    for p in payloads:
        tx = REF.signed_tx.encode_signed_tx(PRIV, p)
        assert PORT.signed_tx.encode_signed_tx(port_priv, p) == tx
        env_r, env_p = REF.signed_tx.decode_signed_tx(tx), PORT.signed_tx.decode_signed_tx(tx)
        assert convert.signed_tx_from_reference(env_r) == env_p
        assert env_p.sign_bytes == env_r.sign_bytes
        assert PORT.signed_tx.verify_signed_tx(env_p) and REF.signed_tx.verify_signed_tx(env_r)
        for bad in (tx[:-1] + b"!", _flip(tx)):
            assert (PORT.signed_tx.verify_signed_tx(PORT.signed_tx.decode_signed_tx(bad))
                    == REF.signed_tx.verify_signed_tx(REF.signed_tx.decode_signed_tx(bad))
                    is False)
        # the signature never verifies over the bare payload
        assert not PORT.keys.Ed25519PubKey(env_p.pubkey).verify(p, env_p.signature)
    assert PORT.signed_tx.SIGN_PREFIX == REF.signed_tx.SIGN_PREFIX
    for raw in (b"plain=1", b"", REF.signed_tx.MAGIC + b"short"):
        assert PORT.signed_tx.decode_signed_tx(raw) is REF.signed_tx.decode_signed_tx(raw) is None


def test_sig_precheck_request_field():
    """The request the lane's verdict rides: the same fields, defaults and
    constants (the wire codec, abci/wire.py, comes with the socket
    transport, ROADMAP A3)."""
    for v in ("SIG_PRECHECK_NONE", "SIG_PRECHECK_OK", "SIG_PRECHECK_BAD"):
        assert getattr(PORT.abci, v) == getattr(REF.abci, v)
    req = dict(tx=b"abc", sig_precheck=REF.abci.SIG_PRECHECK_BAD)
    assert (dataclasses.asdict(PORT.abci.RequestCheckTx(**req))
            == dataclasses.asdict(REF.abci.RequestCheckTx(**req)))
    assert (dataclasses.asdict(PORT.abci.RequestCheckTx())
            == dataclasses.asdict(REF.abci.RequestCheckTx()))


def _consumed(P, mp):
    good, bad = _signed([b"k=v", b"k2=v2"])
    return [_code(mp.check_tx, good), _code(mp.check_tx, _flip(bad))]


def _skip_lane(P, mp):
    return [_code(mp.check_tx, b"plain=1"),
            _code(mp.check_tx, _signed([b"x" * 500])[0])]


def _duplicate(P, mp):
    tx = _signed([b"dup=1"])[0]
    return [_code(mp.check_tx, tx), _code(mp.check_tx, tx, sender="peerA"),
            _code(mp.check_tx, tx)]


def _batch(P, mp):
    txs = _signed([b"b=%d" % i for i in range(8)])
    txs[3] = _flip(txs[3])
    return [_code(mp.check_tx_batch, txs, sender="peerB")]


def _recheck(P, mp):
    txs = _signed([b"r=%d" % i for i in range(5)])
    out = [_code(mp.check_tx, tx) for tx in txs]
    with mp._lock:
        mp.update(1, [txs[0]], [P.abci.ResponseDeliverTx(code=0)])
    return out + [mp.size()]


CASES = {"verdicts_consumed": (_consumed, {}), "plain_and_oversized_skip": (_skip_lane,
         {"max_tx_bytes": 256}), "duplicate_no_second_verify": (_duplicate, {}),
         "check_tx_batch_one_submit": (_batch, {}), "recheck_on_the_lane": (_recheck, {})}


@pytest.mark.parametrize("name", sorted(CASES))
def test_admission_case(name):
    fn, kw = CASES[name]
    _both(fn, **kw)


def test_admission_expectations():
    """Spot values of the side-by-side runs, the reference's own asserts."""
    codes, counts = _both(_batch)
    bad = REF.kvstore.SignedKVStoreApplication.CODE_BAD_SIGNATURE
    assert codes[0] == [0, 0, 0, bad, 0, 0, 0, 0]
    assert counts[:5] == (0, 8, 8, 8, [8])
    codes, counts = _both(_recheck)
    assert codes[-1] == 4 and counts[0] == 0 and counts[3] == 9


def test_no_scheduler_means_app_verifies():
    out = []
    for P in (REF, PORT):
        app = P.kvstore.SignedKVStoreApplication()
        mp = P.mempool.Mempool(P.client.LocalClient(app))
        out.append((mp.sig_precheck, _code(mp.check_tx, _signed([b"k=v"])[0]),
                    app.serial_verifies, app.precheck_consumed))
    assert out[0] == out[1] == (False, 0, 1, 0)


def test_wal_replay_readmits_signed_txs(tmp_path):
    txs = _signed([b"w=%d" % i for i in range(3)])
    out = []
    for P in (REF, PORT):
        mp, app, sched = _pool(P, wal_path=str(tmp_path / P.which / "wal"))
        try:
            codes = [_code(mp.check_tx, tx) for tx in txs]
            mp.flush()
            out.append((codes, mp.replay_wal(), _counts(mp, app, sched)))
        finally:
            sched.close()
    assert out[1] == out[0]
    assert out[0][1] == 3


def _flood(n_keys: int, n: int, bad=()):
    privs = [REF.keys.gen_ed25519(bytes([k + 1]) * 32) for k in range(n_keys)]
    txs = [REF.signed_tx.encode_signed_tx(privs[i % n_keys], b"f%d=%d" % (i, i))
           for i in range(n)]
    for i in bad:
        txs[i] = _flip(txs[i])
    return txs


@pytest.mark.parametrize("bad", [(), (17, 150, 299)], ids=["clean", "3_bad"])
def test_300_tx_batch_on_the_card_arm_plain_kernels(bad):
    """300 signed txs from 16 keys in one check_tx_batch, clean and with 3
    flipped signatures: the port's lane flush runs the card arm's plain
    versions (device="cpu", no backend set: route persig, 300 rows being
    below RLC_MIN), and its codes and counters equal the reference's on its
    host arm."""
    txs = _flood(16, 300, bad)
    ref_mp, ref_app, ref_sched = _pool(REF)
    try:
        ref_codes = _code(ref_mp.check_tx_batch, txs, sender="flood")
        ref_counts = _counts(ref_mp, ref_app, ref_sched)
    finally:
        ref_sched.close()
    app = PORT.kvstore.SignedKVStoreApplication()
    with pytest.MonkeyPatch.context() as mp_env:
        mp_env.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
        sched = PORT.scheduler.VerifyScheduler(device="cpu")
        try:
            mp = PORT.mempool.Mempool(PORT.client.LocalClient(app), scheduler=sched,
                                      sig_precheck=True)
            codes = _code(mp.check_tx_batch, txs, sender="flood")
            route = tbatch.LAST_FLUSH["path"]
            counts = _counts(mp, app, sched)
        finally:
            sched.close()
    assert route == "persig"
    assert codes == ref_codes
    assert counts == ref_counts
    want = REF.kvstore.SignedKVStoreApplication.CODE_BAD_SIGNATURE
    assert [i for i, c in enumerate(codes) if c == want] == list(bad)
    assert counts[:5] == (0, 300, 300, 300, [300])


def test_raising_scheduler_raises_in_the_port():
    """The reference catches a failed lane flush and lets the app verify
    (tests/test_tx_admission.py:161); the port does not catch it: the
    failure reaches check_tx and check_tx_batch, local or gossiped, and no
    tx is admitted (ROADMAP D1)."""

    class Broken:
        def verify_rows(self, *a, **kw):
            raise RuntimeError("device on fire")

    txs = _signed([b"k=v", b"k2=v"])
    app = REF.kvstore.SignedKVStoreApplication()
    ref = REF.mempool.Mempool(REF.client.LocalClient(app), scheduler=Broken(), sig_precheck=True)
    assert [r.code for r in ref.check_tx_batch(txs, sender="p")] == [0, 0]
    assert app.serial_verifies == 2  # the reference degraded

    app = PORT.kvstore.SignedKVStoreApplication()
    mp = PORT.mempool.Mempool(PORT.client.LocalClient(app), scheduler=Broken(), sig_precheck=True)
    with pytest.raises(RuntimeError, match="device on fire"):
        mp.check_tx_batch(txs, sender="p")
    with pytest.raises(RuntimeError, match="device on fire"):
        mp.check_tx(txs[0])
    assert mp.size() == 0 and app.serial_verifies == 0 and app.precheck_consumed == 0
