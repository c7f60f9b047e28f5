"""The light service: the port's light/service.py and light/coalescer.py
held against the JAX package's over two small chains carried into the port
by their bytes (convert.light_block_from_reference_bytes):

- bench.py's make_light_chain at 8 heights x 8 validators (its CPU child's
  size), one set throughout;
- 20 heights of 4 validators whose set changes to a disjoint one at height
  10 (tests/test_light_service.py's rotation), so bisection runs.

Both services take the same multi-client Zipf(1.1) requests (seed 7, as
bench.py's light_serve draws them), in waves: each wave is one request a
client, all started together, and the next wave starts when it is
answered, so which request leads, waits on a leader (single-flight) or
hits the cache does not depend on thread timing. Every request must get
the same verified header (the chain's own) and the same source; the
counters (requests, cache hits, single-flight waits, bisections, sheds,
conflicts, outcomes, rows coalesced) must be equal. Also: a conflicting
expected hash, a missing height, max_pending shedding (the provider held
on an event, not a sleep), a coalesced batch whose job fails alone, and
close() stopping the service's own scheduler. Each package runs on its
host arm (8 and 4 validators). Tolerance: zero.
"""

import asyncio
import os
import random

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

import bench  # noqa: E402
from tendermint_tpu.config.config import LightServiceConfig  # noqa: E402
from tendermint_tpu.light import provider as jprovider  # noqa: E402
from tendermint_tpu.light import service as jservice  # noqa: E402
from tendermint_tpu.types import light as jlight  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto import batch as tbatch  # noqa: E402
from tendermint_tpu_torch.light import coalescer as tcoalescer  # noqa: E402
from tendermint_tpu_torch.light import provider as tprovider  # noqa: E402
from tendermint_tpu_torch.light import service as tservice  # noqa: E402
from tests import test_light as lt  # noqa: E402

COUNTERS = ("requests", "cache_hits", "singleflight_waits", "bisections", "sheds",
            "conflicting_headers", "outcomes", "lanes_total")


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo off, as tests/conftest.py turns the
    reference's off."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def carry(blocks):
    return {h: convert.light_block_from_reference_bytes(jlight.light_block_to_bytes(lb))
            for h, lb in blocks.items()}


BENCH_BLOCKS, BENCH_NOW, BENCH_PERIOD = bench.make_light_chain(8, 8)
ROT_BLOCKS = lt.make_chain(20, privs_by_height={10: lt.make_keys(b"\x02", 4)},
                           default_privs=lt.make_keys(b"\x01", 4))
CHAINS = {
    "bench": ("bench-light", BENCH_BLOCKS, carry(BENCH_BLOCKS), BENCH_NOW, BENCH_PERIOD),
    "rotation": (lt.CHAIN_ID, ROT_BLOCKS, carry(ROT_BLOCKS), lt.NOW, lt.PERIOD),
}


def services(chain, provider_cls=None, **cfg):
    """(reference service, port service) over the chain, from one config."""
    chain_id, jblocks, tblocks, now, period = CHAINS[chain]
    jcfg = LightServiceConfig(trust_period=period / 1e9, **cfg)
    jprov = (provider_cls or {})
    jsvc = jservice.LightService(
        chain_id, jprov.get("ref", jprovider.MockProvider)(chain_id, jblocks), jcfg,
        now_ns=lambda: now)
    tsvc = tservice.LightService(
        chain_id, jprov.get("port", tprovider.MockProvider)(chain_id, tblocks),
        convert.light_service_config_from_reference(jcfg), now_ns=lambda: now, device="cpu")
    return jsvc, tsvc


def zipf_waves(heights, clients, requests, seed=7):
    """bench.py light_serve's draw (Zipf 1.1 over 2..heights), cut into
    waves of one request a client."""
    rng = random.Random(seed)
    ranks = list(range(2, heights + 1))
    weights = [1.0 / (i + 1) ** 1.1 for i in range(len(ranks))]
    reqs = rng.choices(ranks, weights, k=requests)
    return [reqs[i:i + clients] for i in range(0, requests, clients)]


async def _answer(svc, height, expected=None):
    try:
        lb, source = await svc.verify_height(height, expected)
    except Exception as e:  # noqa: BLE001  (the outcome is compared, whatever it is)
        return height, type(e).__name__, getattr(e, "code", None)
    return height, source, lb.hash()


def drive(svc, waves, expected=None):
    async def go():
        out = []
        for wave in waves:
            out.append(await asyncio.gather(*[_answer(svc, h, (expected or {}).get(h))
                                              for h in wave]))
        return out

    try:
        return asyncio.run(go()), {k: svc.stats()[k] for k in COUNTERS}, svc.stats()
    finally:
        svc.close()


def both(chain, waves, expected=None, **cfg):
    jsvc, tsvc = services(chain, **cfg)
    (jans, jcount, _), (tans, tcount, tstats) = drive(jsvc, waves, expected), drive(
        tsvc, waves, expected)
    assert tans == jans
    assert tcount == jcount
    assert tsvc.scheduler.closed
    return tans, tstats


@pytest.mark.parametrize("clients,requests", [(8, 64), (16, 96), (1, 12)])
def test_zipf_traffic_on_the_bench_chain(clients, requests):
    waves = zipf_waves(8, clients, requests)
    answers, stats = both("bench", waves, coalesce_window=0.02, max_heights_per_flush=9,
                          max_pending=0)
    chain = CHAINS["bench"][2]
    for wave in answers:
        for h, source, digest in wave:
            assert source in ("flush", "cache") and digest == chain[h].hash()
    assert stats["requests"] == requests
    assert stats["flushes"] >= 1 and stats["coalescer"]["jobs_total"] == len(
        {h for w in waves for h in w})
    if clients > 1:
        assert stats["singleflight_waits"] > 0


def test_rotation_bisects_then_serves_both_sets():
    """Height 20 first (bisection across the rotation), then 10, then Zipf
    waves over 2..20: heights above 10 verify against the new set, below
    against the old, every answer the chain's header."""
    waves = [[20], [10], [20, 20, 15]] + zipf_waves(20, 6, 48)
    answers, stats = both("rotation", waves, coalesce_window=0.01, max_pending=0)
    chain = CHAINS["rotation"][2]
    assert answers[0] == [(20, "bisection", chain[20].hash())]
    assert stats["bisections"] >= 1
    for wave in answers:
        for h, _source, digest in wave:
            assert digest == chain[h].hash()


def test_conflicting_hash_and_missing_heights():
    chain = CHAINS["bench"][2]
    waves = [[3], [3, 5], [99], [-1], [0], [6]]
    expected = {3: b"\x00" * 32, 6: chain[6].hash()}
    answers, stats = both("bench", waves, expected=expected)
    assert answers[0] == [(3, "ErrConflictingHeader", -32010)]
    assert answers[2] == [(99, "ErrHeightNotAvailable", -32011)]
    assert answers[5] == [(6, "flush", chain[6].hash())]
    assert stats["conflicting_headers"] == 2


class _Held:
    """A provider mixin that holds every fetch above height 1 until
    `release` is set; `entered` is set when one is held."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.entered = asyncio.Event()
        self.release = asyncio.Event()

    async def light_block(self, height):
        if height is not None and height > 1:
            self.entered.set()
            await self.release.wait()
        return await super().light_block(height)


def test_max_pending_sheds_misses_never_hits():
    providers = {"ref": type("JHeld", (_Held, jprovider.MockProvider), {}),
                 "port": type("THeld", (_Held, tprovider.MockProvider), {})}
    out = {}
    for pkg, svc in zip(("ref", "port"), services("bench", providers, max_pending=1)):
        async def go(svc=svc):
            await svc._ensure_anchor()
            prov = svc.provider
            first = asyncio.create_task(_answer(svc, 5))
            await prov.entered.wait()  # the miss holds max_pending
            shed = await _answer(svc, 6)
            prov.release.set()
            answers = [shed, await first]
            prov.entered.clear()
            prov.release.clear()
            second = asyncio.create_task(_answer(svc, 7))
            await prov.entered.wait()
            answers.append(await _answer(svc, 5))  # a hit while a miss is held
            prov.release.set()
            answers.append(await second)
            return answers

        try:
            out[pkg] = (asyncio.run(go()), {k: svc.stats()[k] for k in COUNTERS})
        finally:
            svc.close()
    assert out["port"] == out["ref"]
    answers, counts = out["port"]
    assert answers[0] == (6, "ErrLightOverloaded", -32005) and answers[2][1] == "cache"
    assert counts["sheds"] == 1 and counts["outcomes"]["shed"] == 1


def test_a_failing_job_fails_alone():
    """Two heights in one batch, one with a tampered commit: that request
    fails verification, the other is served, in both packages."""
    chain_id, jblocks, _, now, period = CHAINS["bench"]
    jbad = dict(jblocks)
    lb = jblocks[4]
    commit = lb.signed_header.commit
    sigs = list(commit.signatures)
    for i in range(4):
        cs = sigs[i]
        sigs[i] = type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                           bytes(64))
    jbad[4] = type(lb)(type(lb.signed_header)(lb.signed_header.header, type(commit)(
        commit.height, commit.round, commit.block_id, sigs)), lb.validator_set)
    CHAINS["bad"] = (chain_id, jbad, carry(jbad), now, period)
    try:
        answers, stats = both("bad", [[4, 6]], coalesce_window=0.05)
    finally:
        del CHAINS["bad"]
    assert answers[0][0] == (4, "ErrVerificationFailed", -32012)
    assert answers[0][1][1] == "flush"


def test_coalescer_batches_and_isolates():
    """Same-tick submits share one run_batch call; a job's failure and a
    short result list fail only their own submitters; a closed coalescer
    refuses."""
    calls = []

    def run_batch(jobs):
        calls.append(list(jobs))
        return [(j != "bad", j if j != "bad" else ValueError("bad job")) for j in jobs][:2], {}

    async def go():
        c = tcoalescer.Coalescer(run_batch, max_jobs=8)
        got = await asyncio.gather(*[c.submit(j) for j in ("a", "bad", "c")],
                                   return_exceptions=True)
        stats = c.stats()
        c.close()
        with pytest.raises(RuntimeError, match="closed"):
            await c.submit("d")
        return got, stats

    got, stats = asyncio.run(go())
    assert calls == [["a", "bad", "c"]]
    assert got[0] == "a" and isinstance(got[1], ValueError) and isinstance(got[2], RuntimeError)
    assert stats["windows_fired"] == 1 and stats["jobs_total"] == 3
    with pytest.raises(ValueError):
        tcoalescer.Coalescer(run_batch, max_jobs=0)
