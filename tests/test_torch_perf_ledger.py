"""The port's perf-trajectory ledger (tendermint_tpu_torch/tools/
perf_ledger.py) against the JAX package's: the counterpart of
tests/test_perf_ledger.py.

Every round file here is a fixture these tests write under tmp_path: a
history shaped like the repository's own rounds (a wrapper with no parsed
JSON, a `value: -1` device-init stall, a skipped multichip round, an rc-124
multichip round, a loader-mismatch tail), scenario columns (backend,
prep overlap, mesh degrade, poison defense, fleet gate), a corrupt file and
a file with no round suffix. No port test reads the repository's rounds,
which are the JAX package's TPU rounds. On each input the port's ledger,
regressions, markdown, JSON output and exit codes equal the reference's
(the ledger's `root` is the directory's absolute path in both). No
tolerance applies.
"""

import json

import pytest

from tendermint_tpu.tools import perf_ledger as R_PL
from tendermint_tpu_torch.tools import perf_ledger as PL

HEAD = "verify_commit_10k_latency"


def _write_round(d, n, value, metric=HEAD, rc=0, degraded=None, extra=None, host=True):
    parsed = {"metric": metric, "value": value, "unit": "ms", "vs_baseline": 2.0,
              "extra": dict(extra or {})}
    if host:
        parsed["extra"]["host"] = {"machine_fingerprint": "test-host", "jax": "0.9",
                                   "git_sha": "0123456789abcdef"}
    if degraded:
        parsed["degraded"] = degraded
    (d / f"BENCH_r{n:02d}.json").write_text(
        json.dumps({"n": n, "rc": rc, "tail": "", "parsed": parsed}))


def history(d):
    """A lost r01 (no parsed JSON), healthy r02-r04 with scenario columns,
    r05's `value: -1` stall; multichip r01 skipped, r04 rc 124, r05 a
    loader mismatch, r06 ok."""
    (d / "BENCH_r01.json").write_text(json.dumps(
        {"n": 1, "cmd": "bench", "rc": 0, "tail": "", "parsed": None}))
    _write_round(d, 2, 120.0, extra={HEAD.rsplit("_", 1)[0]: {"speedup_e2e": 1.5}})
    _write_round(d, 3, 110.0, extra={
        "verify_commit_10k": {"speedup": 1.7, "tpu_e2e_ms": 9.5, "prep_wall_hidden": 0.42},
        "bls_commit": {"speedup": 3.0, "backend": "bls12_381"},
        "mesh_failover": {"degrade_ratio": 0.48, "mesh_ladder": "survivor", "rebuild_s": 1.25,
                          "during": {"lost_verdicts": 0}},
        "poisoned_flush": {"p99_ratio_1pct": 1.4, "speedup": 5.0, "quarantine_isolated": True,
                           "rates": {"0.01": {"recovery_flushes": 3, "quarantined_rows": 12}}},
        "fleet_soak": {"verdict": "pass", "heights": 20, "safety_violations": 0},
        "catchup": {"sigs_per_sec": 12345.0, "skipped": True},
    })
    _write_round(d, 4, 105.0, extra={"verify_commit_10k": {"speedup_e2e": 1.8}})
    (d / "BENCH_r05.json").write_text(json.dumps({
        "n": 5, "rc": 0, "tail": "[init] device initialization stalled",
        "parsed": {"metric": "verify_commit_latency", "value": -1, "unit": "ms",
                   "vs_baseline": 0, "extra": {"error": "device initialization stalled"}}}))
    for n, doc in ((1, {"n_devices": 8, "rc": 0, "ok": False, "skipped": True,
                        "tail": "__GRAFT_DRYRUN_SKIP__\n"}),
                   (4, {"n_devices": 8, "rc": 124, "ok": False, "skipped": False, "tail": ""}),
                   (5, {"n_devices": 8, "rc": 1, "ok": False, "skipped": False,
                        "tail": "cpu_aot_loader: machine feature mismatch\n"}),
                   (6, {"n_devices": 8, "rc": 0, "ok": True, "skipped": False,
                        "tail": "dryrun ok\n"})):
        (d / f"MULTICHIP_r{n:02d}.json").write_text(json.dumps(doc))


def same_ledger(root) -> dict:
    got = PL.load_ledger(str(root))
    want = R_PL.load_ledger(str(root))
    assert got == want
    assert PL.render_markdown(got) == R_PL.render_markdown(want)
    for tol in (0.25, 0.01, 2.0):
        assert PL.check_regressions(got, tol) == R_PL.check_regressions(want, tol)
    return got


def same_main(argv, capsys) -> int:
    rc = PL.main(argv)
    out = capsys.readouterr()
    assert R_PL.main(argv) == rc
    rout = capsys.readouterr()
    assert (out.out, out.err) == (rout.out, rout.err)
    return rc


def test_parses_every_round_artifact(tmp_path):
    history(tmp_path)
    ledger = same_ledger(tmp_path)
    on_disk = {p.name for p in tmp_path.iterdir()}
    assert {r["file"] for r in ledger["bench"] + ledger["multichip"]} == on_disk
    for r in ledger["bench"] + ledger["multichip"]:
        assert isinstance(r["round"], int), r["file"]


def test_known_lost_datapoints_are_flagged(tmp_path):
    history(tmp_path)
    ledger = same_ledger(tmp_path)
    lost = set(ledger["lost_datapoints"])
    assert "BENCH_r01.json" in lost
    assert "BENCH_r05.json" in lost
    by_file = {r["file"]: r for r in ledger["bench"]}
    assert "no parseable" in by_file["BENCH_r01.json"]["lost_reason"]
    assert "-1" in by_file["BENCH_r05.json"]["lost_reason"]
    assert "BENCH_r04.json" not in lost


def test_multichip_diagnoses(tmp_path):
    history(tmp_path)
    by_file = {r["file"]: r for r in same_ledger(tmp_path)["multichip"]}
    assert by_file["MULTICHIP_r01.json"]["diagnosis"] == "skipped"
    assert "timeout" in by_file["MULTICHIP_r04.json"]["diagnosis"]
    assert by_file["MULTICHIP_r04.json"]["lost"]
    assert "machine-feature" in by_file["MULTICHIP_r05.json"]["diagnosis"]
    assert by_file["MULTICHIP_r06.json"]["diagnosis"] == "ok"


def test_scenario_columns(tmp_path):
    history(tmp_path)
    ledger = same_ledger(tmp_path)
    r3 = {r["file"]: r for r in ledger["bench"]}["BENCH_r03.json"]
    assert r3["prep_hidden"] == 0.42
    assert r3["mesh_degrade"]["ladder"] == "survivor"
    assert r3["poison_defense"]["quarantine_isolated"] is True
    assert r3["fleet_gate"] == {"verdict": "pass", "heights": 20, "violations": 0}
    assert r3["scenarios"]["bls_commit"]["backend"] == "bls12_381"
    assert r3["versions"] == {"jax": "0.9", "git_sha": "0123456789abcdef"}


def test_renders_full_trajectory(tmp_path, capsys):
    root = tmp_path / "rounds"
    root.mkdir()
    history(root)
    out = tmp_path / "out"
    out.mkdir()
    argv = ["--root", str(root), "--json", str(out / "ledger.json"),
            "--markdown", str(out / "ledger.md")]
    assert same_main(argv, capsys) == 0
    md = (out / "ledger.md").read_text()
    assert "| r01 |" in md and "LOST" in md
    assert "## Multichip rounds" in md
    doc = json.loads((out / "ledger.json").read_text())
    assert doc["lost_datapoints"] and doc["bench"] and doc["multichip"]
    assert doc == json.loads(json.dumps(PL.load_ledger(str(root)) | {"regressions": []}))


def test_check_exits_nonzero_on_simulated_headline_regression(tmp_path, capsys):
    _write_round(tmp_path, 1, 100.0)
    _write_round(tmp_path, 2, 200.0)
    assert same_main(["--root", str(tmp_path), "--check"], capsys) == 2
    PL.main(["--root", str(tmp_path), "--check"])
    out = capsys.readouterr()
    assert "REGRESSION" in out.err and "REGRESSIONS" in out.out
    assert same_main(["--root", str(tmp_path), "--check", "--tolerance", "1.5"], capsys) == 0


def test_check_ignores_lost_and_degraded_rounds(tmp_path, capsys):
    _write_round(tmp_path, 1, 100.0)
    _write_round(tmp_path, 2, 110.0)
    _write_round(tmp_path, 3, -1)
    _write_round(tmp_path, 4, 900.0, degraded="cpu-fallback")
    assert same_main(["--root", str(tmp_path), "--check"], capsys) == 0
    assert "BENCH_r03.json" in same_ledger(tmp_path)["lost_datapoints"]


def test_host_stamp_lands_in_rows(tmp_path):
    _write_round(tmp_path, 7, 50.0)
    row = same_ledger(tmp_path)["bench"][0]
    assert row["fingerprint"] == "test-host"
    assert row["versions"]["jax"] == "0.9"


def test_empty_root_errors(tmp_path, capsys):
    assert same_main(["--root", str(tmp_path)], capsys) == 1
    PL.main(["--root", str(tmp_path)])
    assert "no BENCH_r*" in capsys.readouterr().err


def test_salvaged_value_from_nonzero_rc(tmp_path):
    _write_round(tmp_path, 1, 75.0, rc=1)
    row = same_ledger(tmp_path)["bench"][0]
    assert not row["lost"] and row["value"] == 75.0
    assert "rc=1" in row["lost_reason"]


def test_artifact_without_round_suffix_renders_not_crashes(tmp_path, capsys):
    _write_round(tmp_path, 1, 100.0)
    (tmp_path / "BENCH_rerun.json").write_text((tmp_path / "BENCH_r01.json").read_text())
    (tmp_path / "MULTICHIP_rX.json").write_text(json.dumps({"n": 8, "rc": 0, "tail": ""}))
    ledger = same_ledger(tmp_path)
    assert [r["round"] for r in ledger["bench"]] == [1, None]
    md = PL.render_markdown(ledger)
    assert "BENCH_rerun" in md and "MULTICHIP_rX" in md
    assert same_main(["--root", str(tmp_path), "--check"], capsys) == 0


@pytest.mark.parametrize("text", ["{not json", "null", ""])
def test_corrupt_round_is_a_flagged_row(tmp_path, text):
    _write_round(tmp_path, 1, 100.0)
    (tmp_path / "BENCH_r02.json").write_text(text)
    (tmp_path / "MULTICHIP_r02.json").write_text(text)
    ledger = same_ledger(tmp_path)
    assert len(ledger["bench"]) == 2 and len(ledger["multichip"]) == 1
    assert {"BENCH_r02.json", "MULTICHIP_r02.json"} <= set(ledger["lost_datapoints"])


@pytest.mark.parametrize("text", ["[1, 2]", "7", '"round"'])
def test_round_that_is_no_json_object(tmp_path, text):
    """JSON that is not an object: the reference's parse_bench raises
    (AttributeError or TypeError on its `doc.get` / `in doc`); the port flags
    a lost row, as it does for any unreadable file (ROADMAP C)."""
    _write_round(tmp_path, 1, 100.0)
    (tmp_path / "BENCH_r02.json").write_text(text)
    with pytest.raises((AttributeError, TypeError)):
        R_PL.load_ledger(str(tmp_path))
    ledger = PL.load_ledger(str(tmp_path))
    row = {r["file"]: r for r in ledger["bench"]}["BENCH_r02.json"]
    assert row["lost"] and "not a JSON object" in row["lost_reason"]
    assert PL.check_regressions(ledger) == []
    PL.render_markdown(ledger)
