"""The port's chain observatory (tendermint_tpu_torch/tools/chain_observatory.py)
against the JAX package's: the counterparts of tests/test_chain_observatory.py
:230-446, the fleet merge from dump fixtures and the end-to-end 4-node net.

Fixture dumps are built through each package's own producers (its
ConsensusTimeline and SLOEngine) on the same call sequence, and must be
equal; both packages' merge, markdown and CLI then agree on them. The
end-to-end net is four port nodes (device="cpu", the host arm) over the
plaintext transport: each node's dump is captured by the port's
write_node_dump and, of the same live node, by the reference's; both
packages' tools agree on both sets of dumps, the reference's assertions
hold on the port's, and an injected over-budget run trips the guard that
`--check` turns into exit 2 in both CLIs. The keys that name a time
(TIME_KEYS) are left out of the equality; no other tolerance applies.
"""

import asyncio
import json
import os
import shutil

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.config.config import SLOConfig as R_SLOConfig  # noqa: E402
from tendermint_tpu.consensus.timeline import ConsensusTimeline as R_Timeline  # noqa: E402
from tendermint_tpu.libs.slo import SLOEngine as R_SLOEngine  # noqa: E402
from tendermint_tpu.tools import chain_observatory as R_obs  # noqa: E402
from tendermint_tpu_torch.config.config import SLOConfig as T_SLOConfig  # noqa: E402
from tendermint_tpu_torch.consensus.timeline import ConsensusTimeline as T_Timeline  # noqa: E402
from tendermint_tpu_torch.crypto import batch as T_batch  # noqa: E402
from tendermint_tpu_torch.libs.slo import SLOEngine as T_SLOEngine  # noqa: E402
from tendermint_tpu_torch.tools import chain_observatory as obs  # noqa: E402
from torch_p2p_util import make_net, start_and_connect, stop_all  # noqa: E402

NODE_A = "aa" * 20
NODE_B = "bb" * 20
NODE_C = "cc" * 20
TIME_KEYS = ("generated_ts",)
PRODUCERS = {"ref": (R_Timeline, R_SLOEngine, R_SLOConfig, R_obs),
             "port": (T_Timeline, T_SLOEngine, T_SLOConfig, obs)}


def timeless(doc):
    if isinstance(doc, dict):
        return {k: timeless(v) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [timeless(v) for v in doc]
    return doc


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = T_batch._MEMO
    T_batch._MEMO = T_batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        T_batch._MEMO = prev


def same_merge(dumps, **kw) -> dict:
    got, want = obs.merge(dumps, **kw), R_obs.merge(dumps, **kw)
    assert timeless(got) == timeless(want)
    assert obs.render_markdown(got) == R_obs.render_markdown(want)
    return got


# ---------------------------------------------------------------------------
# fleet merge from dump fixtures (offline mode: no net, no RPC)


def _slo_snapshot(which: str, tripped: bool) -> dict:
    _, engine, config, _ = PRODUCERS[which]
    eng = engine(config(window_fast=10.0, window_slow=100.0, min_samples=3, target=0.9))
    seconds = 5.0 if tripped else 0.01
    for i in range(6):
        eng.observe("proposal_propagation", seconds, ts=100.0 + i)
    return eng.snapshot(now=107.0)


def _fixture_dump(which, node_id, *, t0, recv_lat, commit_off, proposer=None,
                  tripped=False) -> dict:
    """tests/test_chain_observatory.py _fixture_dump, through package
    `which`'s own producers."""
    timeline, _, _, mod = PRODUCERS[which]
    tl = timeline()
    for h in (10, 11):
        base = t0 + (h - 10) * 1.0
        tl.record_step(h, 0, "PROPOSE", ts=base)
        tl.record_proposal(h, 0, ts=base + recv_lat)
        if proposer is not None:
            tl.record_proposal_propagation(h, 0, proposer, recv_lat, hops=0, ts=base + recv_lat)
            tl.record_hop(proposer, "proposal", recv_lat, skew_corrected=True)
        tl.record_step(h, 0, "PREVOTE", ts=base + recv_lat + 0.01)
        tl.record_step(h, 0, "PRECOMMIT", ts=base + commit_off * 0.6)
        tl.record_step(h, 0, "COMMIT", ts=base + commit_off * 0.9)
        tl.record_commit(h, 0, txs=0, ts=base + commit_off)
    return {
        "observatory_dump": mod.DUMP_VERSION,
        "node_id": node_id,
        "moniker": f"n-{node_id[:4]}",
        "timeline": {"heights": tl.dump(), "propagation_peers": tl.peer_stats()},
        "slo": _slo_snapshot(which, tripped),
    }


def _fixture_fleet(tripped=False):
    """A proposes; B is a fast receiver, C a slow one. The port's producers'
    dumps equal the reference's."""
    fleets = {
        which: [
            _fixture_dump(which, NODE_A, t0=200.0, recv_lat=0.0, commit_off=0.50,
                          tripped=tripped),
            _fixture_dump(which, NODE_B, t0=200.0, recv_lat=0.020, commit_off=0.52,
                          proposer=NODE_A),
            _fixture_dump(which, NODE_C, t0=200.0, recv_lat=0.200, commit_off=0.70,
                          proposer=NODE_A),
        ]
        for which in PRODUCERS
    }
    assert fleets["port"] == fleets["ref"]
    return fleets["port"]


def test_merge_waterfall_proposer_and_slowest_link():
    report = same_merge(_fixture_fleet())
    assert [n["node"] for n in report["nodes"]] == [NODE_A[:10], NODE_B[:10], NODE_C[:10]]
    assert len(report["heights"]) == 2
    h10 = report["heights"][0]
    assert h10["height"] == 10
    assert h10["proposer"] == NODE_A[:10]
    rows = h10["nodes"]
    assert set(rows) == {NODE_A[:10], NODE_B[:10], NODE_C[:10]}
    assert rows[NODE_A[:10]]["proposal_recv_ms"] == 0.0
    assert rows[NODE_B[:10]]["proposal_recv_ms"] == pytest.approx(20.0)
    assert rows[NODE_C[:10]]["proposal_recv_ms"] == pytest.approx(200.0)
    assert rows[NODE_C[:10]]["commit_ms"] == pytest.approx(700.0)
    for row in rows.values():
        for key in ("prevote_quorum_ms", "precommit_quorum_ms", "commit_ms"):
            assert row[key] is not None
    assert h10["first_peer_receipt_ms"] == pytest.approx(20.0)
    assert h10["last_peer_receipt_ms"] == pytest.approx(200.0)
    assert h10["slowest_link"] is not None
    lag = report["peer_lag"][0]
    assert lag["origin"] == NODE_A[:10]
    assert lag["observers"] == 2
    assert lag["msgs"] == 4
    assert lag["mean_ms"] == pytest.approx(110.0)
    assert lag["max_ms"] == pytest.approx(200.0)
    assert report["slo_any_tripped"] is False
    verdicts = {(e["node"], e["objective"]): e for e in report["slo"]}
    assert verdicts[(NODE_A[:10], "proposal_propagation")]["verdict"] == "ok"


def test_merge_flags_tripped_slo_and_render():
    report = same_merge(_fixture_fleet(tripped=True))
    assert report["slo_any_tripped"] is True
    tripped = [e for e in report["slo"] if e["tripped"]]
    assert tripped and tripped[0]["node"] == NODE_A[:10]
    assert tripped[0]["objective"] == "proposal_propagation"
    md = obs.render_markdown(report)
    assert "height 10" in md and "height 11" in md
    assert "ANY GUARD TRIPPED" in md
    assert "slowest link" in md
    assert NODE_A[:10] in md


@pytest.mark.parametrize("window", [1, 2, None])
def test_merge_window_equals_the_reference(window):
    same_merge(_fixture_fleet(), max_heights=window)


def same_cli(argv_of, out_dir, capsys) -> int:
    """Both CLIs on the same dumps, each into its own output directory:
    equal exit codes, equal chain_report.json (less TIME_KEYS) and .md."""
    rc = obs.main(argv_of(out_dir))
    rout = out_dir + "_ref"
    assert R_obs.main(argv_of(rout)) == rc
    if os.path.exists(os.path.join(out_dir, "chain_report.json")):
        for name in ("chain_report.json", "chain_report.md"):
            with open(os.path.join(out_dir, name)) as f, open(os.path.join(rout, name)) as g:
                a, b = f.read(), g.read()
            if name.endswith(".json"):
                a, b = timeless(json.loads(a)), timeless(json.loads(b))
            assert a == b
    capsys.readouterr()
    return rc


def test_cli_offline_merge_and_check_exit_codes(tmp_path, capsys):
    dump_dir = tmp_path / "dumps"
    dump_dir.mkdir()
    for i, doc in enumerate(_fixture_fleet()):
        (dump_dir / f"{obs.DUMP_PREFIX}{i}.json").write_text(json.dumps(doc))
    out = str(tmp_path / "report")

    def argv(extra=()):
        return lambda o: ["--dumps", str(dump_dir), "--out", o, *extra]

    assert same_cli(argv(["--check"]), out, capsys) == 0
    report = json.loads((tmp_path / "report" / "chain_report.json").read_text())
    assert len(report["heights"]) == 2
    assert (tmp_path / "report" / "chain_report.md").read_text().startswith("# Chain observatory")

    for i, doc in enumerate(_fixture_fleet(tripped=True)):
        (dump_dir / f"{obs.DUMP_PREFIX}{i}.json").write_text(json.dumps(doc))
    assert same_cli(argv(["--check"]), out, capsys) == 2
    assert same_cli(argv(), out, capsys) == 0

    (dump_dir / f"{obs.DUMP_PREFIX}zz.json").write_text("{not json")
    assert same_cli(argv(), out, capsys) == 0
    report = json.loads((tmp_path / "report" / "chain_report.json").read_text())
    assert any(n.get("load_error") for n in report["nodes"])

    empty = tmp_path / "empty"
    empty.mkdir()
    assert same_cli(lambda o: ["--dumps", str(empty), "--out", o], out, capsys) == 1


# ---------------------------------------------------------------------------
# end to end: a live 4-node port net -> dumps -> one merged report


def test_observatory_e2e_4node_net(tmp_path, capsys):
    """tests/test_chain_observatory.py:360 on port nodes, with each node's
    dump also written by the reference's capture of the same node."""
    port_dir, ref_dir = str(tmp_path / "observatory"), str(tmp_path / "observatory_ref")

    async def run():
        nodes = make_net(["port"] * 4, tmp_path, chain="observatory-e2e", plaintext=True)
        await start_and_connect(nodes)
        try:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            while not all(n.block_store.height >= 3 for n in nodes):
                for n in nodes:
                    n.raise_failures()
                assert loop.time() - t0 < 60, [n.block_store.height for n in nodes]
                await asyncio.sleep(0.05)
            for n in nodes:
                obs.write_node_dump(n, port_dir)
                R_obs.write_node_dump(n, ref_dir)
        finally:
            await stop_all(nodes)
        return nodes

    nodes = asyncio.run(run())
    labels = {n.node_key.id[:10] for n in nodes}

    dumps = obs.load_dumps(port_dir)
    assert len(dumps) == 4
    assert dumps == R_obs.load_dumps(port_dir)
    report = same_merge(dumps)
    assert not report["slo_any_tripped"], report["slo"]
    covered = [rec for rec in report["heights"]
               if set(rec["nodes"]) == labels
               and all(r["commit_ms"] is not None for r in rec["nodes"].values())]
    assert covered, f"no height covered all nodes: {report['heights']}"
    rec = covered[-1]
    assert rec["proposer"] in labels
    traced = [r for r in rec["nodes"].values() if r["proposal_first_seen_ms"] is not None]
    assert traced, rec
    assert all(r["proposal_hops"] is not None for r in traced)
    assert report["peer_lag"], "no propagation aggregates reached the report"
    assert {e["origin"] for e in report["peer_lag"]} <= labels | {"?"}
    assert all(not e["tripped"] for e in report["slo"])

    # the port's sections: verify_stats and /debug/mesh's snapshot
    from tendermint_tpu_torch.parallel import telemetry

    for d in dumps:
        assert d["mesh"] == json.loads(json.dumps(telemetry.mesh_stats()))
        assert d["verify_stats"]["mesh"] == d["mesh"]
        assert set(d["chain"]["hashes"]) >= {"1", "2", "3"}
    # the reference's capture of the same nodes: both packages' tools agree
    # on it, and its chain sections are the port's
    rdumps = R_obs.load_dumps(ref_dir)
    assert obs.load_dumps(ref_dir) == rdumps
    same_merge(rdumps)
    key = lambda d: d["node_id"]  # noqa: E731
    assert [d["chain"] for d in sorted(rdumps, key=key)] == \
        [d["chain"] for d in sorted(dumps, key=key)]

    # over-budget propagation latency into one node's engine trips its
    # guard; re-dump, re-merge: both CLIs exit 2 under --check
    victim = nodes[0]
    for _ in range(max(victim.slo.min_samples, 8)):
        victim.slo.observe("proposal_propagation", 99.0)
    assert victim.slo.evaluate()["proposal_propagation"]["tripped"]
    obs.write_node_dump(victim, port_dir)
    out = str(tmp_path / "report")
    assert same_cli(lambda o: ["--dumps", port_dir, "--out", o, "--check"], out, capsys) == 2
    merged = json.loads((tmp_path / "report" / "chain_report.json").read_text())
    assert merged["slo_any_tripped"] is True
    shutil.rmtree(ref_dir)
