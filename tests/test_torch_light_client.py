"""The port's light Client (tendermint_tpu_torch/light/client.py with
light/store.py, light/provider.py, libs/kvdb.py) against the JAX package's,
on chains of small sets built and signed by the reference
(tests/test_light.py make_chain) and carried into the port by their bytes
(convert.light_block_from_reference_bytes).

Each scenario of tests/test_light.py:134-240 runs on both packages with
mirrored providers; the sets are below 256 rows, so both verify on their
host arms (the port's Client with device="cpu"). Tolerance: zero. The same
outcome (pass, or the exception's type and message), the same trusted
heights, byte-identical store contents, the same primary and witnesses
afterwards and the same provider call counts.
"""

import asyncio

import pytest

from tendermint_tpu import light as jl
from tendermint_tpu.libs.kvdb import MemDB as JMemDB
from tendermint_tpu.libs.kvdb import SQLiteDB as JSQLiteDB
from tendermint_tpu.types import light as jlight
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import light as tl
from tendermint_tpu_torch.libs.kvdb import MemDB as TMemDB
from tendermint_tpu_torch.libs.kvdb import SQLiteDB as TSQLiteDB
from tendermint_tpu_torch.types import light as tlight
from tests.test_light import CHAIN_ID, NOW, PERIOD, T0, make_chain, make_keys

NANOS = 1_000_000_000

pytestmark = pytest.mark.usefixtures("_cpu_backend")


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


@pytest.fixture
def _cpu_backend(monkeypatch):
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "cpu")


def carry(blocks):
    return {h: convert.light_block_from_reference_bytes(jlight.light_block_to_bytes(lb))
            for h, lb in blocks.items()}


SIDES = {
    "ref": dict(pkg=jl, db=JMemDB, kw={}, carry=lambda b: b),
    "port": dict(pkg=tl, db=TMemDB, kw={"device": "cpu"}, carry=carry),
}


async def _outcome(coro):
    try:
        await coro
    except Exception as e:  # noqa: BLE001  (the outcome is compared, whatever it is)
        return type(e).__name__, str(e)
    return ("ok",)


def run_scenario(side: str, blocks, steps, mode="skipping", witnesses=(), primary=None,
                 trust_height=1, db=None):
    """Build a Client of `side` over mirrored providers, then run `steps`:
    ("init", now) or ("height", h, now) or ("update", now). Returns what
    must match across the packages."""
    s = SIDES[side]
    pkg = s["pkg"]
    own = s["carry"](blocks)
    wit = [pkg.MockProvider(CHAIN_ID, s["carry"](w)) for w in witnesses]
    prim = pkg.MockProvider(CHAIN_ID, s["carry"](primary) if primary is not None else own)
    providers = [prim] + wit
    client = pkg.Client(CHAIN_ID, pkg.TrustOptions(PERIOD, trust_height, own[trust_height].hash()),
                        prim, wit, pkg.LightStore(db() if db else s["db"]()),
                        verification_mode=mode, **s["kw"])

    async def go():
        out = []
        for step in steps:
            if step[0] == "init":
                out.append(await _outcome(client.initialize(step[1])))
            elif step[0] == "height":
                out.append(await _outcome(client.verify_light_block_at_height(step[1], step[2])))
            else:
                out.append(await _outcome(client.update(step[1])))
        return out

    outcomes = asyncio.run(go())
    store = client.store
    return dict(
        outcomes=outcomes,
        heights=store.heights(),
        stored=[bytes(v) for _, v in store.db.iterate_prefix(b"lb/")],
        primary=providers.index(client.primary),
        witnesses=[providers.index(w) for w in client.witnesses],
        calls=[p.calls for p in providers],
        conflicting=[lb.hash() for lb in client.conflicting_blocks],
        first=client.first_trusted_height(), last=client.last_trusted_height(),
    )


def both(*args, **kw):
    want = run_scenario("ref", *args, **kw)
    got = run_scenario("port", *args, **kw)
    assert got == want
    return want


OLD = make_keys(b"\x31", 8)
NEW = make_keys(b"\x32", 8)


def test_sequential_verification():
    r = both(make_chain(10, default_privs=OLD), [("init", NOW), ("height", 10, NOW)],
             mode="sequential")
    assert r["outcomes"] == [("ok",)] * 2 and r["heights"] == list(range(1, 11))


def test_skipping_single_jump_constant_valset():
    r = both(make_chain(20, default_privs=OLD), [("init", NOW), ("height", 20, NOW)])
    assert r["heights"] == [1, 20] and r["calls"] == [2]


@pytest.mark.parametrize("rotation,overlap", [(10, 0), (6, 3), (12, 6)])
def test_skipping_bisects_across_rotation(rotation, overlap):
    """A rotation at `rotation` keeping `overlap` of 8 validators: the
    bisection's trusted heights and store are the reference's."""
    blocks = make_chain(16, privs_by_height={rotation: OLD[:overlap] + NEW[overlap:]},
                        default_privs=OLD)
    r = both(blocks, [("init", NOW), ("height", 16, NOW), ("height", 11, NOW)])
    assert r["outcomes"][0] == r["outcomes"][1] == ("ok",)
    if overlap < 3:
        assert len(r["heights"]) > 2


def test_update_and_cached_height():
    both(make_chain(7, default_privs=OLD), [("init", NOW), ("update", NOW), ("update", NOW),
                                            ("height", 7, NOW), ("height", 0, NOW)])


def test_expired_trust_root_rejected():
    r = both(make_chain(5, default_privs=OLD), [("init", T0 + PERIOD + 10 * NANOS)])
    assert r["outcomes"][0][0] == "ErrOldHeaderExpired"


def test_uninitialized_and_wrong_root():
    blocks = make_chain(5, default_privs=OLD)
    r = both(blocks, [("height", 3, NOW)])
    assert r["outcomes"][0][0] == "LightError"
    other = make_chain(5, default_privs=NEW)
    r = both(blocks, [("init", NOW)], primary=other)
    assert r["outcomes"][0][0] == "LightError"


def test_witness_divergence_detected():
    blocks = make_chain(10, default_privs=OLD)
    forged = make_chain(10, default_privs=make_keys(b"\x37", 8))
    r = both(blocks, [("init", NOW), ("height", 8, NOW)], witnesses=[{**blocks, 8: forged[8]}])
    assert r["outcomes"][1][0] == "ErrConflictingHeaders" and r["witnesses"] == []
    assert r["conflicting"] == [forged[8].hash()]


def test_backwards_verification():
    r = both(make_chain(10, default_privs=OLD), [("init", NOW), ("height", 3, NOW)],
             trust_height=8)
    assert r["outcomes"][1] == ("ok",) and r["heights"] == [3, 4, 5, 6, 7, 8]


def test_backwards_rejects_a_broken_hash_chain():
    blocks = make_chain(10, default_privs=OLD)
    forged = make_chain(10, default_privs=NEW)
    r = both({**blocks, 5: forged[5]}, [("init", NOW), ("height", 3, NOW)], trust_height=8)
    assert r["outcomes"][1][0] == "ErrInvalidHeader"


def test_primary_failover_to_witness():
    blocks = make_chain(6, default_privs=OLD)
    r = both(blocks, [("init", NOW), ("height", 6, NOW)], primary={1: blocks[1]},
             witnesses=[blocks])
    assert r["outcomes"][1] == ("ok",) and r["primary"] == 1 and r["witnesses"] == [0]


def test_primary_failure_without_witnesses():
    blocks = make_chain(6, default_privs=OLD)
    r = both(blocks, [("init", NOW), ("height", 6, NOW)], primary={1: blocks[1]})
    assert r["outcomes"][1][0] == "ErrNoWitnesses"


def test_sqlite_store_round_trip(tmp_path):
    """The SQLite-backed store holds the same bytes as the reference's and
    reopens with the same heights."""
    blocks = make_chain(8, default_privs=OLD)
    paths = {side: str(tmp_path / f"{side}.db") for side in ("ref", "port")}
    want = run_scenario("ref", blocks, [("init", NOW), ("height", 8, NOW)], mode="sequential",
                        db=lambda: JSQLiteDB(paths["ref"]))
    got = run_scenario("port", blocks, [("init", NOW), ("height", 8, NOW)], mode="sequential",
                       db=lambda: TSQLiteDB(paths["port"]))
    assert got == want
    store = tl.LightStore(TSQLiteDB(paths["port"]))
    assert store.heights() == want["heights"]
    store.prune(3)
    assert store.heights() == [6, 7, 8] and store.light_block_before(7).height == 6
    lb = store.first_light_block()
    assert tlight.light_block_to_bytes(lb) == jlight.light_block_to_bytes(blocks[6])
