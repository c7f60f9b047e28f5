"""The port's fleet referee and release gate (tendermint_tpu_torch/tools/
fleet_referee.py, release_gate.py, perf_ledger.py's fleet-gate column,
chain_observatory.py's fleet hardening) against the JAX package's: the
counterpart of tests/test_fleet_referee.py, whole.

Every test drives the port's verdict engine on hand-built observatory dumps,
manifests and BENCH round files (all under tmp_path), asserts what the
reference's test asserts, and holds the port's report, exit code, written
files and markdown equal to the reference's on the same inputs. The keys
that name a time (TIME_KEYS) are left out of the equality; no other
tolerance applies.
"""

import asyncio
import json
import os
import shutil

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.tools import chain_observatory as R_obs  # noqa: E402
from tendermint_tpu.tools import fleet_referee as R_ref  # noqa: E402
from tendermint_tpu.tools import perf_ledger as R_pl  # noqa: E402
from tendermint_tpu.tools import release_gate as R_gate  # noqa: E402
from tendermint_tpu_torch.tools import chain_observatory as obs  # noqa: E402
from tendermint_tpu_torch.tools import fleet_referee as ref  # noqa: E402
from tendermint_tpu_torch.tools import perf_ledger  # noqa: E402
from tendermint_tpu_torch.tools import release_gate as gate  # noqa: E402

T0 = 1_700_000_000.0
TIME_KEYS = ("generated_ts",)


def timeless(doc):
    if isinstance(doc, dict):
        return {k: timeless(v) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [timeless(v) for v in doc]
    return doc


def same_report(dumps, manifest=None, **kw) -> dict:
    """The port's build_report, held equal to the reference's (JSON less
    TIME_KEYS, and markdown)."""
    got = ref.build_report(dumps, manifest=manifest, **kw)
    want = R_ref.build_report(dumps, manifest=manifest, **kw)
    assert timeless(got) == timeless(want)
    assert ref.render_markdown(got) == R_ref.render_markdown(want)
    return got


def same_gate(**kw) -> dict:
    """The port's release_gate.evaluate, held equal to the reference's. The
    fleet gate writes its report beside the dumps: the reference runs on a
    copy of the directory, and both written reports compare too."""
    copy = None
    fd = kw.get("fleet_dumps")
    if fd and os.path.isdir(fd):
        copy = fd.rstrip("/") + "_ref"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(fd, copy)
    got = gate.evaluate(**kw)
    want = R_gate.evaluate(**dict(kw, fleet_dumps=copy or fd))
    if copy:  # a detail that names the directory names the copy
        want = json.loads(json.dumps(want).replace(copy, fd))
    assert timeless(got) == timeless(want)
    if copy:
        mine, theirs = (os.path.join(d, "fleet_report.json") for d in (fd, copy))
        assert os.path.exists(mine) == os.path.exists(theirs)
        if os.path.exists(mine):
            with open(mine) as f, open(theirs) as g:
                assert timeless(json.load(f)) == timeless(json.load(g))
    return got


def same_main(mod_pair, argv, dumps_dir=None) -> int:
    """A CLI's exit code and written report, the port's against the
    reference's (which runs on a copy of the dumps directory)."""
    port_mod, ref_mod = mod_pair
    rc = port_mod.main(argv)
    if dumps_dir is not None:
        copy = dumps_dir.rstrip("/") + "_ref"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(dumps_dir, copy)
        os.remove(os.path.join(copy, "fleet_report.json"))
        os.remove(os.path.join(copy, "fleet_report.md"))
        rargv = [copy if a == dumps_dir else a for a in argv]
        assert ref_mod.main(rargv) == rc
        for name in ("fleet_report.json", "fleet_report.md"):
            with open(os.path.join(dumps_dir, name)) as f, open(os.path.join(copy, name)) as g:
                a, b = f.read(), g.read()
            if name.endswith(".json"):
                a, b = timeless(json.loads(a)), timeless(json.loads(b))
            assert a == b
    else:
        assert ref_mod.main(argv) == rc
    return rc


# -- synthetic evidence builders ----------------------------------------------


def make_dump(label, heights, *, tripped=False, fork_at=None, terminals=None):
    """tests/test_fleet_referee.py make_dump: one synthetic observatory dump
    shaped like capture_node_dump's output."""
    recs = []
    hashes = {}
    for h in range(1, heights + 1):
        t = T0 + h
        recs.append({
            "height": h,
            "proposals": [{"ts": t}],
            "steps": [{"step": "PRECOMMIT", "ts": t + 0.05}, {"step": "COMMIT", "ts": t + 0.08}],
            "commit": {"ts": t + 0.1, "round": 0},
            "propagation": {},
        })
        hx = f"{h:064x}"
        if fork_at is not None and h == fork_at:
            hx = "f" * 64
        hashes[str(h)] = hx
    return {
        "observatory_dump": 1,
        "node_id": label,
        "moniker": label,
        "timeline": {"heights": recs, "propagation_peers": {}},
        "slo": {
            "enabled": True,
            "any_tripped": tripped,
            "objectives": {
                "consensus_commit_latency": {
                    "verdict": "TRIPPED" if tripped else "ok",
                    "tripped": tripped,
                    "trips_total": 1 if tripped else 0,
                    "breaches": 3 if tripped else 0,
                    "observations": heights,
                    "worst_s": 0.5,
                    "burn_rate": {},
                }
            },
        },
        "txtrace": {"enabled": True, "terminals": terminals or {}},
        "chain": {"base": 1, "height": heights, "hashes": hashes},
    }


def write_dumps(directory, dumps):
    os.makedirs(directory, exist_ok=True)
    for d in dumps:
        with open(os.path.join(directory, f"{obs.DUMP_PREFIX}{d['node_id']}.json"), "w") as f:
            json.dump(d, f)


def write_manifest(directory, labels_roles, *, seed=7, live=None):
    doc = {
        "fleet_manifest": 1,
        "seed": seed,
        "fingerprint": "feedfacefeedface",
        "schedule_fingerprint": "deadbeefdeadbeef",
        "nodes": [
            {"index": i, "label": lbl, "role": role,
             "live": (lbl in live) if live is not None else True}
            for i, (lbl, role) in enumerate(labels_roles)
        ],
    }
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, ref.MANIFEST_NAME), "w") as f:
        json.dump(doc, f)
    return doc


# -- the safety auditor --------------------------------------------------------


def same_audit(dumps) -> dict:
    got = ref.safety_audit(dumps)
    assert got == R_ref.safety_audit(dumps)
    return got


def test_safety_audit_clean():
    audit = same_audit([make_dump(f"n{i}", 8) for i in range(4)])
    assert audit["nodes_audited"] == 4
    assert audit["heights_checked"] == 8
    assert audit["violations"] == []


def test_safety_audit_names_the_forked_height():
    audit = same_audit([make_dump("good0", 8), make_dump("good1", 8),
                        make_dump("evil", 8, fork_at=7)])
    assert len(audit["violations"]) == 1
    viol = audit["violations"][0]
    assert viol["height"] == 7
    assert viol["hashes"]["evil"] == "f" * 64
    assert viol["hashes"]["good0"] == f"{7:064x}"


def test_safety_audit_ignores_unshared_heights():
    audit = same_audit([make_dump("a", 4), make_dump("b", 9, fork_at=9)])
    assert audit["heights_checked"] == 4
    assert audit["violations"] == []


def test_safety_audit_counts_its_checks():
    from tendermint_tpu_torch.libs import metrics as T_metrics

    c = T_metrics.fleet_metrics().safety_checks
    before = c._values.get((), 0.0)
    ref.safety_audit([make_dump(f"n{i}", 5) for i in range(3)])
    assert c._values.get((), 0.0) - before == 5
    v = T_metrics.fleet_metrics().referee_verdicts
    before = v._values.get(("pass",), 0.0)
    ref.build_report([make_dump("n0", 2), make_dump("n1", 2)])
    assert v._values.get(("pass",), 0.0) - before == 1


# -- verdicts + exit codes -----------------------------------------------------


def test_exit_code_matrix_is_pinned():
    assert ref.EXIT_CODES == R_ref.EXIT_CODES == {
        "pass": 0, "no_data": 1, "safety_violation": 2, "slo_tripped": 3, "partial": 4,
    }
    for mod in (gate, R_gate):
        assert (mod.EXIT_PASS, mod.EXIT_SAFETY, mod.EXIT_SLO, mod.EXIT_PARTIAL, mod.EXIT_PERF,
                mod.EXIT_FLEET_MISSING, mod.EXIT_TIER1) == (0, 2, 3, 4, 5, 6, 7)
    assert gate.SEVERITY == R_gate.SEVERITY == (2, 3, 4, 5, 6, 7)


def test_verdict_pass():
    report = same_report([make_dump(f"n{i}", 6) for i in range(3)])
    assert report["verdict"] == "pass"
    assert report["exit_code"] == 0
    assert report["safety"]["violations"] == []
    assert not report["coverage"]["partial"]


def test_verdict_no_data():
    report = same_report([])
    assert report["verdict"] == "no_data"
    assert report["exit_code"] == 1


def test_verdict_slo_tripped():
    report = same_report([make_dump("ok0", 6), make_dump("burny", 6, tripped=True)])
    assert report["verdict"] == "slo_tripped"
    assert report["exit_code"] == 3


def test_safety_outranks_slo_and_partial():
    report = same_report([make_dump("good", 8, tripped=True), make_dump("evil", 8, fork_at=3),
                          {"node_id": "corrupt", "load_error": "ValueError('bad json')"}])
    assert report["verdict"] == "safety_violation"
    assert report["exit_code"] == 2
    assert report["safety"]["violations"][0]["height"] == 3
    assert report["slo_any_tripped"] is True
    assert report["coverage"]["partial"] is True


def test_waterfall_covers_every_node():
    report = same_report([make_dump(f"n{i}", 5) for i in range(4)])
    wf = report["waterfall"]
    assert wf["heights_merged"] == 5
    assert set(wf["per_node"]) == {"n0", "n1", "n2", "n3"}
    assert all(c == 5 for c in wf["per_node"].values())
    assert wf["uncovered"] == []


def test_terminals_fold_fleet_wide():
    report = same_report([make_dump("a", 4, terminals={"delivered": 5, "rejected": 1}),
                          make_dump("b", 4, terminals={"delivered": 7})])
    assert report["terminals"] == {"delivered": 12, "rejected": 1}


def test_mesh_and_quarantine_columns():
    """The elastic-mesh and quarantine folds (the reference's build_report
    reads each dump's `mesh` and `suspicion` sections) on dumps that carry
    them, the port's telemetry snapshot shape included."""
    from tendermint_tpu_torch.parallel import health, telemetry

    hm = health.MeshHealthManager(probe=lambda key: None)
    hm._spawn_probe_thread = False
    hm.mark_device_lost("cuda:1")
    a, b, c = make_dump("a", 4), make_dump("b", 4), make_dump("c", 4)
    a["mesh"] = dict(telemetry.mesh_stats(), ladder="survivor", rebuilds=2, health=hm.snapshot())
    b["mesh"] = telemetry.mesh_stats()
    c["mesh"] = {"error": "RuntimeError('x')"}
    for d, q in ((a, ["peer:aa"]), (b, ["peer:bb", "peer:aa"])):
        d["suspicion"] = {"quarantined": q, "punished": len(q), "paroles": 0}
        d["verify_stats"] = {"counters": {"recovery_flushes": 3 * len(q), "quarantined_rows": 7}}
    report = same_report([a, b, c])
    assert report["mesh_degrade"] == {"worst_ladder": "survivor", "rebuilds_total": 2,
                                      "nodes": {"a": {"ladder": "survivor", "rebuilds": 2,
                                                      "dead_devices": ["cuda:1"]}}}
    assert report["quarantine"]["quarantined_sources"] == ["peer:aa", "peer:bb"]
    assert report["quarantine"]["recovery_flushes"] == 6


# -- coverage: corrupt dumps and manifest ghosts -------------------------------


def test_corrupt_dump_is_partial_not_a_crash(tmp_path):
    d = str(tmp_path / "d")
    write_dumps(d, [make_dump("n0", 6), make_dump("n1", 6)])
    with open(os.path.join(d, f"{obs.DUMP_PREFIX}corrupt.json"), "w") as f:
        f.write("{not json at all")
    assert same_main((ref, R_ref), ["--dumps", d, "--check"], dumps_dir=d) == 4
    with open(os.path.join(d, "fleet_report.json")) as f:
        report = json.load(f)
    assert report["verdict"] == "partial"
    assert any("corrupt" in m for m in report["coverage"]["missing"])
    assert any("corrupt" in m for m in report["coverage"]["failed_dumps"])
    assert report["coverage"]["merged"] == 2


def test_manifest_names_nodes_that_never_dumped():
    manifest = {
        "fleet_manifest": 1,
        "seed": 1,
        "nodes": [
            {"label": "n0", "role": "validator", "live": True},
            {"label": "ghost", "role": "full", "live": True},
            {"label": "dead", "role": "full", "live": False},
        ],
    }
    report = same_report([make_dump("n0", 5)], manifest=manifest)
    assert report["verdict"] == "partial"
    assert report["coverage"]["never_dumped"] == ["ghost"]
    assert "dead" not in report["coverage"]["missing"]
    assert report["coverage"]["expected_live"] == 2


def test_role_slo_fold(tmp_path):
    d = str(tmp_path)
    write_dumps(d, [make_dump("val0", 6), make_dump("val1", 6, tripped=True),
                    make_dump("edge0", 6)])
    write_manifest(d, [("val0", "validator"), ("val1", "validator"), ("edge0", "light_edge")])
    assert ref.load_manifest(d) == R_ref.load_manifest(d)
    assert obs.load_dumps(d) == R_obs.load_dumps(d)
    report = same_report(obs.load_dumps(d), manifest=ref.load_manifest(d))
    rs = report["role_slo"]
    assert rs["validator"]["nodes"] == 2
    assert rs["validator"]["tripped"] == 1
    assert rs["validator"]["verdict"] == "TRIPPED"
    assert rs["light_edge"]["verdict"] == "ok"
    assert report["roles"]["edge0"] == "light_edge"
    assert report["manifest"]["schedule_fingerprint"] == "deadbeefdeadbeef"


# -- CLI + markdown ------------------------------------------------------------


def test_cli_fork_exits_2_and_markdown_names_the_height(tmp_path, capsys):
    d = str(tmp_path / "d")
    write_dumps(d, [make_dump("good0", 8), make_dump("good1", 8), make_dump("evil", 8, fork_at=7)])
    assert ref.main(["--dumps", d, "--check"]) == 2
    out = capsys.readouterr().out
    assert "SAFETY VIOLATION at height 7" in out
    md = open(os.path.join(d, "fleet_report.md")).read()
    assert "SAFETY VIOLATION at height 7" in md
    assert "evil" in md
    assert same_main((ref, R_ref), ["--dumps", d, "--check"], dumps_dir=d) == 2
    capsys.readouterr()


def test_cli_pass_exits_0_and_without_check_always_0(tmp_path):
    d = str(tmp_path / "d")
    write_dumps(d, [make_dump("n0", 5), make_dump("n1", 5)])
    assert same_main((ref, R_ref), ["--dumps", d, "--check"], dumps_dir=d) == 0
    write_dumps(d, [make_dump("evil", 5, fork_at=2)])
    assert same_main((ref, R_ref), ["--dumps", d], dumps_dir=d) == 0


def test_cli_empty_dir_is_no_data(tmp_path):
    d = str(tmp_path / "d")
    os.makedirs(d)
    assert same_main((ref, R_ref), ["--dumps", d, "--check"], dumps_dir=d) == 1


# -- release gate composition --------------------------------------------------


def _bench_round(path, value, *, fleet=None, extra=None):
    blob = {"metric": "verify_commit_10k_latency", "value": value, "unit": "ms",
            "extra": dict(extra or {})}
    blob["extra"]["verify_commit_10k"] = {"speedup_e2e": 1.0}
    if fleet is not None:
        blob["extra"]["fleet_soak"] = fleet
    with open(path, "w") as f:
        json.dump({"n": 1, "cmd": "bench", "rc": 0, "parsed": blob}, f)


def test_release_gate_all_pass(tmp_path):
    d = os.path.join(str(tmp_path), "obs")
    write_dumps(d, [make_dump("n0", 5), make_dump("n1", 5)])
    result = same_gate(fleet_dumps=d, perf_root=str(tmp_path))
    assert result["exit_code"] == 0
    assert result["verdict"] == "pass"
    assert result["gates"]["fleet"]["status"] == "pass"
    assert result["gates"]["perf"]["status"] == "no_rounds"
    assert result["gates"]["tier1"]["status"] == "skipped"
    assert os.path.exists(os.path.join(d, "fleet_report.json"))


def test_release_gate_safety_violation(tmp_path):
    d = os.path.join(str(tmp_path), "obs")
    write_dumps(d, [make_dump("good", 6), make_dump("evil", 6, fork_at=4)])
    result = same_gate(fleet_dumps=d, perf_root=str(tmp_path))
    assert result["exit_code"] == 2
    assert result["gates"]["fleet"]["detail"]["safety_violations"] == [4]


def test_release_gate_fleet_missing(tmp_path):
    result = same_gate(fleet_dumps=os.path.join(str(tmp_path), "nope"), perf_root=str(tmp_path))
    assert result["exit_code"] == 6
    empty = os.path.join(str(tmp_path), "empty")
    os.makedirs(empty)
    result = same_gate(fleet_dumps=empty, perf_root=str(tmp_path))
    assert result["exit_code"] == 6
    result = same_gate(skip_fleet=True, perf_root=str(tmp_path))
    assert result["exit_code"] == 0
    assert result["gates"]["fleet"]["status"] == "skipped"


def test_release_gate_skip_perf_reads_no_rounds(tmp_path):
    """skip_perf records the gate as skipped and reads no round file, even
    where the directory holds a failing round."""
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0)
    _bench_round(os.path.join(root, "BENCH_r02.json"), 900.0)
    result = same_gate(skip_fleet=True, perf_root=root, skip_perf=True)
    assert result["exit_code"] == 0
    assert result["gates"]["perf"] == {"status": "skipped", "exit_code": 0, "detail": None}


def test_release_gate_perf_regression(tmp_path):
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0)
    _bench_round(os.path.join(root, "BENCH_r02.json"), 200.0)
    result = same_gate(skip_fleet=True, perf_root=root, tolerance=0.25)
    assert result["exit_code"] == 5
    assert result["gates"]["perf"]["status"] == "regression"
    assert any("headline regression" in f for f in result["gates"]["perf"]["detail"])


def test_release_gate_fleet_gate_column_regression(tmp_path):
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0,
                 fleet={"verdict": "pass", "heights": 20, "safety_violations": 0})
    _bench_round(os.path.join(root, "BENCH_r02.json"), 101.0,
                 fleet={"verdict": "safety_violation", "heights": 21, "safety_violations": 1})
    result = same_gate(skip_fleet=True, perf_root=root)
    assert result["exit_code"] == 5
    assert any("fleet gate failed" in f for f in result["gates"]["perf"]["detail"])


def test_release_gate_tier1_failed(tmp_path):
    result = same_gate(skip_fleet=True, perf_root=str(tmp_path), tier1_cmd="exit 3")
    assert result["exit_code"] == 7
    assert result["gates"]["tier1"]["detail"]["rc"] == 3
    result = same_gate(skip_fleet=True, perf_root=str(tmp_path), tier1_cmd="true")
    assert result["exit_code"] == 0


def test_release_gate_severity_order(tmp_path):
    d = os.path.join(str(tmp_path), "obs")
    write_dumps(d, [make_dump("good", 6), make_dump("evil", 6, fork_at=2)])
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0)
    _bench_round(os.path.join(root, "BENCH_r02.json"), 500.0)
    result = same_gate(fleet_dumps=d, perf_root=root)
    assert result["gates"]["fleet"]["exit_code"] == 2
    assert result["gates"]["perf"]["exit_code"] == 5
    assert result["exit_code"] == 2


def test_release_gate_cli(tmp_path, capsys):
    d = os.path.join(str(tmp_path), "obs")
    write_dumps(d, [make_dump("n0", 5), make_dump("n1", 5)])
    out = os.path.join(str(tmp_path), "gate.json")
    assert gate.main(["--fleet-dumps", d, "--root", str(tmp_path), "--out", out,
                      "--check"]) == 0
    with open(out) as f:
        summary = json.load(f)
    assert summary["release_gate"] == 1
    assert summary["verdict"] == "pass"
    rout = os.path.join(str(tmp_path), "gate_ref.json")
    assert R_gate.main(["--fleet-dumps", d, "--root", str(tmp_path), "--out", rout,
                        "--check"]) == 0
    with open(rout) as f:
        assert timeless(json.load(f)) == timeless(summary)
    write_dumps(d, [make_dump("evil", 5, fork_at=3)])
    assert gate.main(["--fleet-dumps", d, "--root", str(tmp_path), "--check"]) == 2
    assert R_gate.main(["--fleet-dumps", d, "--root", str(tmp_path), "--check"]) == 2
    # --out naming a directory writes release_gate.json into it
    assert gate.main(["--fleet-dumps", d, "--skip-perf", "--out", str(tmp_path)]) == 0
    assert os.path.exists(os.path.join(str(tmp_path), "release_gate.json"))
    capsys.readouterr()


# -- perf ledger fleet-gate column ---------------------------------------------


def test_perf_ledger_fleet_gate_column(tmp_path):
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0)
    _bench_round(os.path.join(root, "BENCH_r02.json"), 99.0,
                 fleet={"verdict": "pass", "heights": 21, "safety_violations": 0})
    ledger = perf_ledger.load_ledger(root)
    assert ledger == R_pl.load_ledger(root)
    r1, r2 = ledger["bench"]
    assert r1["fleet_gate"] is None and r1["fleet_gate_missing"]
    assert r2["fleet_gate"] == {"verdict": "pass", "heights": 21, "violations": 0}
    assert not r2["fleet_gate_missing"]
    assert ledger["fleet_gate_missing_rounds"] == ["BENCH_r01.json"]
    assert perf_ledger.check_regressions(ledger) == []
    md = perf_ledger.render_markdown(ledger)
    assert md == R_pl.render_markdown(ledger)
    assert "fleet gate" in md
    assert "pass·21h·0v" in md
    assert "missing" in md


def test_perf_ledger_fleet_gate_failure_blocks_check(tmp_path, capsys):
    root = str(tmp_path)
    _bench_round(os.path.join(root, "BENCH_r01.json"), 100.0,
                 fleet={"verdict": "slo_tripped", "heights": 20, "safety_violations": 0})
    ledger = perf_ledger.load_ledger(root)
    failures = perf_ledger.check_regressions(ledger)
    assert failures == R_pl.check_regressions(R_pl.load_ledger(root))
    assert len(failures) == 1
    assert "fleet gate failed" in failures[0]
    assert "slo_tripped" in failures[0]
    assert perf_ledger.main(["--root", root, "--check"]) == 2
    capsys.readouterr()


# -- observatory fleet hardening -----------------------------------------------


def same_merge(dumps, **kw) -> dict:
    got, want = obs.merge(dumps, **kw), R_obs.merge(dumps, **kw)
    assert timeless(got) == timeless(want)
    assert obs.render_markdown(got) == R_obs.render_markdown(want)
    return got


def test_merge_marks_partial_coverage_explicitly():
    merged = same_merge([make_dump("n0", 5), {"node_id": "broke", "load_error": "OSError('gone')"}])
    assert merged["coverage"] == {"expected": 2, "merged": 1, "missing": ["broke"],
                                  "partial": True}
    rows = {n["node"]: n for n in merged["nodes"]}
    assert rows["broke"]["load_error"] == "OSError('gone')"
    md = obs.render_markdown(merged)
    assert "PARTIAL COVERAGE" in md
    assert "broke" in md


def test_merge_full_coverage_is_not_partial():
    merged = same_merge([make_dump("n0", 5), make_dump("n1", 5)])
    assert merged["coverage"]["partial"] is False
    assert merged["coverage"]["missing"] == []


def test_merge_window_bounds_retained_heights():
    merged = same_merge([make_dump(f"n{i}", 100) for i in range(3)], max_heights=5)
    assert len(merged["heights"]) == 5
    assert merged["heights"][0]["height"] == 96
    for n in merged["nodes"]:
        assert n["heights"] == 100


def test_scrape_fleet_names_unreachable_nodes():
    urls = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    dumps = asyncio.run(obs.scrape_fleet(urls, timeout=2.0, concurrency=2))
    assert len(dumps) == 2
    for d in dumps:
        assert d.get("scrape_error")
    merged = same_merge(dumps)
    assert merged["coverage"]["partial"] is True
    assert len(merged["coverage"]["missing"]) == 2
    # the reference's scrape of the same URLs names the same nodes
    rdumps = asyncio.run(R_obs.scrape_fleet(urls, timeout=2.0, concurrency=2))
    assert [d["node_id"] for d in dumps] == [d["node_id"] for d in rdumps]


@pytest.mark.parametrize("window", [None, 1, 3])
def test_merge_of_forked_and_partial_fleets(window):
    dumps = [make_dump("a", 7, terminals={"delivered": 2}), make_dump("b", 5, fork_at=4),
             make_dump("c", 6, tripped=True), {"node_id": "x", "scrape_error": "Timeout()"}]
    same_merge(dumps, max_heights=window)
    same_report(dumps, max_heights=window)
