"""The consensus hooks against the JAX package's, tolerance 0: PR 15's
scenario fixture (tests/test_torch_consensus_util.py) with the metrics, the
timeline ring and the tx tracker wired in both packages, as node/node.py
wires them, and every module that stamps them (cs_state, timeline,
txtrace, mempool) reading one fake clock whose perf_counter moves only when
the scenario moves it.

Scenarios: the full round (tests/test_consensus_state.py:209; the node
proposes height 1 with three mempool txs) and deferred verification with
one bad signature. Compared: the outcome PR 15 compares, the timeline
records (heights, rounds, steps in order, their durations under the fake
clock, proposals, votes, commits), the ConsensusMetrics / StateMetrics /
TxLifecycleMetrics exposition via parse_exposition, each tx's journey
through `committed` and `delivered`, and hotstats' `encode` and `verify`
stage counts. `tendermint_state_block_processing_time` reads the real
clock in both packages (state/execution.py imports `time` inside
apply_block), so of it the sample count is compared, not its sum or
buckets.
"""

import os

import pytest

from tendermint_tpu_torch.crypto import batch as tbatch
from tests.test_torch_consensus_state import SCENARIOS, SEED, TXS
from tests.test_torch_consensus_util import Pkg, run_scenario, seeds

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
REAL_CLOCK_FAMILY = "tendermint_state_block_processing_time"


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _exposition(P, node):
    fams = P.metrics.parse_exposition(node.registry.expose())
    fam = fams[REAL_CLOCK_FAMILY]
    fam["samples"] = [s for s in fam["samples"] if s[0].endswith("_count")]
    return fams


def _hooked(P, name, tmp_path, script=None):
    sc = dict(SCENARIOS[name])
    fn = sc.pop("fn")
    hs = P.hotstats.stats
    hs.reset()
    hs.enabled = True
    try:
        out, script, node = run_scenario(P, fn, seeds(4, SEED), tmp_path, script=script,
                                         hooks=True, **sc)
    finally:
        hs.enabled = False
    out["timeline"] = node.timeline.dump()
    out["exposition"] = _exposition(P, node)
    out["journeys"] = [node.tx_tracker.waterfall(P.tmhash.sum256(tx)) for tx in TXS]
    out["tracker"] = node.tx_tracker.stats()
    out["hotstats"] = {k: hs.counts[k] for k in ("encode", "verify")}
    hs.reset()
    return out, script


@pytest.mark.parametrize("name", ["full_round", "deferred_bad_signature"])
def test_hooks_match_reference(name, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF.trace.tracer, "enabled", True)
        mp.setattr(PORT.trace.tracer, "enabled", True)
        want, script = _hooked(REF, name, tmp_path)
        got, _ = _hooked(PORT, name, tmp_path, script=script)
    assert got == want
    assert not got["halted"]
    fams = got["exposition"]
    assert fams["tendermint_consensus_height"]["samples"][0][2] == len(got["blocks"])
    assert [s["step"] for s in got["timeline"][0]["steps"]][:3] == [
        "NEW_HEIGHT", "NEW_ROUND", "PROPOSE"]
    assert got["hotstats"]["encode"] > 0 and got["hotstats"]["verify"] > 0
    if name == "full_round":
        for wf in got["journeys"]:
            stages = [s["stage"] for s in wf["stages"]]
            assert stages == ["received", "checked", "admitted", "proposed", "committed",
                              "delivered"]
        assert fams["tendermint_consensus_total_txs"]["samples"][0][2] == len(TXS)
