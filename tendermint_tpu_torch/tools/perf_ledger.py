"""Perf-trajectory ledger: every round's datapoint in one table. The port's
copy of tendermint_tpu/tools/perf_ledger.py: the same parsing, the same
checks and the same markdown.

Aggregates per-round artifacts, `BENCH_r*.json` (wrapper:
`{"n", "cmd", "rc", "tail", "parsed": <bench JSON line or null>}`) and
`MULTICHIP_r*.json` (`{"n_devices", "rc", "ok", "skipped", "tail"}`), into
one trajectory table rendered as markdown + JSON:

- headline metric/value/speedup per round, with **lost** datapoints flagged
  and diagnosed (no parseable JSON; `value: -1`; a nonzero exit whose value
  was salvaged) instead of silently skipped;
- per-scenario speedups so a regression names its scenario;
- the machine fingerprint + the software versions each round stamped
  (older rounds show `—`);
- multichip round diagnoses (rc-124 timeout, loader machine-feature
  mismatch, skip, ok).

`--check` turns the ledger into a budget guard: exit nonzero when the
newest non-lost, non-degraded headline regressed by more than
`--tolerance` (default 25%) against the best earlier round of the same
metric, or when the newest round that ran a fleet soak or a poisoned flood
failed its gate.

    python -m tendermint_tpu_torch.tools.perf_ledger [--root DIR] [--json OUT]
        [--markdown OUT] [--check] [--tolerance 0.25]

Which rounds: in this repository the `BENCH_r*.json` / `MULTICHIP_r*.json`
files at the root are the JAX package's TPU rounds. Run at the repo root,
this tool reads TPU rounds, never a figure of the port; nothing in the port
runs it there, and the port's own tests give it fixture directories.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional

_ROUND_RE = re.compile(r"_r(\d+)\.json$")

# The trajectory's north-star datapoint: the ledger flags any round that
# lacks it (a scenario-scoped round can lose the headline silently: the
# matrix shows the scenario, the headline row does not).
HEADLINE_SCENARIO = "verify_commit_10k"
HEADLINE_METRIC = f"{HEADLINE_SCENARIO}_latency"


def _round_of(path: str) -> Optional[int]:
    m = _ROUND_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _round_label(row: dict) -> str:
    """`r04` — or the filename stem for artifacts with no numeric round
    suffix (BENCH_rerun.json matches the glob but not _ROUND_RE); the
    ledger flags odd artifacts, it never dies on them."""
    if row.get("round") is not None:
        return f"r{row['round']:02d}"
    return os.path.splitext(row.get("file") or "?")[0]


def _load(path: str) -> Optional[dict]:
    """The file's JSON object, None for `null`, or {"_load_error": ...}.
    JSON that is neither (a list, a number) is a load error too: the
    reference's parse_bench raises AttributeError on it."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return {"_load_error": f"{type(e).__name__}: {e}"}
    if doc is not None and not isinstance(doc, dict):
        return {"_load_error": f"ValueError: not a JSON object ({type(doc).__name__})"}
    return doc


def _scenario_speedups(extra: dict) -> Dict[str, Any]:
    """Per-scenario comparable numbers out of a bench `extra` blob."""
    out: Dict[str, Any] = {}
    for name, res in (extra or {}).items():
        if not isinstance(res, dict):
            continue
        entry: Dict[str, Any] = {}
        for key in ("speedup_e2e", "speedup"):
            if isinstance(res.get(key), (int, float)):
                entry["speedup"] = res[key]
                break
        # signature-scheme backend column: scenarios stamp
        # `backend` so e.g. BLS aggregate numbers render in their own
        # column and never fold into the ed25519 RLC headline trajectory
        if isinstance(res.get("backend"), str):
            entry["backend"] = res["backend"]
        if isinstance(res.get("tpu_e2e_ms"), (int, float)):
            entry["tpu_e2e_ms"] = res["tpu_e2e_ms"]
        # prep-overlap column: fraction of host-prep wall hidden
        # behind device/MSM work for the flush the scenario timed
        if isinstance(res.get("prep_wall_hidden"), (int, float)):
            entry["prep_hidden"] = res["prep_wall_hidden"]
        # elastic-mesh column: survivor-mesh throughput as a
        # fraction of the full mesh's, plus the final ladder rung
        if isinstance(res.get("degrade_ratio"), (int, float)):
            entry["degrade_ratio"] = res["degrade_ratio"]
        if isinstance(res.get("mesh_ladder"), str):
            entry["mesh_ladder"] = res["mesh_ladder"]
        # adversarial-flush column: vote-path p99 under a 1%
        # signature-poisoning flood as a multiple of the clean baseline
        if isinstance(res.get("p99_ratio_1pct"), (int, float)):
            entry["p99_ratio_1pct"] = res["p99_ratio_1pct"]
        if "quarantine_isolated" in res:
            entry["quarantine_isolated"] = bool(res["quarantine_isolated"])
        if isinstance(res.get("sigs_per_sec"), (int, float)):
            entry["sigs_per_sec"] = res["sigs_per_sec"]
        if res.get("degraded"):
            entry["degraded"] = res["degraded"]
        if res.get("skipped"):
            entry["skipped"] = True
        if entry:
            out[name] = entry
    return out


def parse_bench(path: str) -> dict:
    """One BENCH_r*.json → a ledger row. Accepts both the round wrapper
    shape and a bare bench JSON line saved to a file."""
    doc = _load(path)
    row: Dict[str, Any] = {
        "round": _round_of(path),
        "file": os.path.basename(path),
        "kind": "bench",
        "lost": False,
        "lost_reason": None,
        "degraded": None,
        "metric": None,
        "value": None,
        "unit": None,
        "vs_baseline": None,
        "fingerprint": None,
        "versions": None,
        "scenarios": {},
        "fleet_gate": None,
        "fleet_gate_missing": True,
        "mesh_degrade": None,
        "poison_defense": None,
    }
    if doc is None or "_load_error" in (doc or {}):
        row["lost"] = True
        row["lost_reason"] = (doc or {}).get("_load_error", "unreadable file")
        return row
    parsed = doc.get("parsed", doc if "metric" in doc else None)
    row["rc"] = doc.get("rc")
    if parsed is None:
        row["lost"] = True
        row["lost_reason"] = (
            f"no parseable bench JSON (rc={doc.get('rc')})"
            if "rc" in doc
            else "no parseable bench JSON"
        )
        return row
    row["metric"] = parsed.get("metric")
    row["value"] = parsed.get("value")
    row["unit"] = parsed.get("unit")
    row["vs_baseline"] = parsed.get("vs_baseline")
    row["degraded"] = parsed.get("degraded")
    extra = parsed.get("extra") or {}
    host = extra.get("host") or parsed.get("host") or {}
    if host:
        row["fingerprint"] = host.get("machine_fingerprint")
        row["versions"] = {
            k: host.get(k) for k in ("jax", "jaxlib", "python", "git_sha")
            if host.get(k)
        }
    row["scenarios"] = _scenario_speedups(extra)
    # headline prep-overlap trajectory: rounds before the staged
    # prep pipeline simply show "—"
    head = row["scenarios"].get(HEADLINE_SCENARIO) or {}
    row["prep_hidden"] = head.get("prep_hidden")
    # fleet-gate column: rounds that ran the `fleet_soak`
    # scenario carry the referee verdict + heights + safety-violation count;
    # rounds that didn't are flagged like headline_missing — a silently
    # skipped fleet gate must read as a gap, not a pass
    fs = extra.get("fleet_soak")
    if isinstance(fs, dict) and fs.get("verdict"):
        row["fleet_gate"] = {
            "verdict": fs.get("verdict"),
            "heights": fs.get("heights"),
            "violations": fs.get("safety_violations"),
        }
        row["fleet_gate_missing"] = False
    # mesh-degrade column: rounds that ran the `mesh_failover`
    # scenario carry the survivor/full throughput ratio, the final ladder
    # rung, the rebuild wall and the lost-verdict count; rounds that
    # didn't show "—" (a gap, not a pass)
    mf = extra.get("mesh_failover")
    if isinstance(mf, dict) and (
        mf.get("degrade_ratio") is not None or mf.get("mesh_ladder")
    ):
        row["mesh_degrade"] = {
            "ratio": mf.get("degrade_ratio"),
            "ladder": mf.get("mesh_ladder"),
            "rebuild_s": mf.get("rebuild_s"),
            "lost_verdicts": (mf.get("during") or {}).get("lost_verdicts"),
        }
    # quarantine/recovery column: rounds that ran the
    # `poisoned_flush` scenario carry the vote-path p99 ratio under a 1%
    # signature-poisoning flood, the bisection-vs-naive recovery speedup,
    # the recovery-flush count at 1%, and whether the quarantine lane
    # isolated exactly the poisoner; rounds that didn't show "—"
    pf = extra.get("poisoned_flush")
    if isinstance(pf, dict) and (
        pf.get("p99_ratio_1pct") is not None
        or pf.get("quarantine_isolated") is not None
    ):
        one_pct = (pf.get("rates") or {}).get("0.01") or {}
        row["poison_defense"] = {
            "p99_ratio_1pct": pf.get("p99_ratio_1pct"),
            "speedup": pf.get("speedup"),
            "recovery_flushes_1pct": one_pct.get("recovery_flushes"),
            "quarantined_rows_1pct": one_pct.get("quarantined_rows"),
            "quarantine_isolated": pf.get("quarantine_isolated"),
        }
    # a parsed round that carries NEITHER the headline metric nor a
    # headline scenario datapoint lost the trajectory point — flag it
    # explicitly instead of leaving a silent gap in the matrix
    row["headline_missing"] = (
        row["metric"] != HEADLINE_METRIC
        and HEADLINE_SCENARIO not in row["scenarios"]
        and HEADLINE_SCENARIO not in (extra or {})
    )
    if not isinstance(row["value"], (int, float)) or row["value"] < 0:
        row["lost"] = True
        err = extra.get("error") or parsed.get("degrade_reason")
        row["lost_reason"] = (
            f"value {row['value']!r}" + (f" ({err})" if err else "")
        )
    elif doc.get("rc") not in (0, None):
        # the datapoint parsed but the run exited nonzero — keep the value,
        # flag the round
        row["lost_reason"] = f"bench exited rc={doc['rc']} (value salvaged)"
    return row


def diagnose_multichip(doc: dict) -> str:
    if doc.get("skipped"):
        return "skipped"
    tail = doc.get("tail") or ""
    if doc.get("rc") == 124:
        return "timeout (rc 124): hard deadline with no diagnosis — "\
               "the forensics watchdog (libs/forensics.py) now captures these"
    if "cpu_aot_loader" in tail or "machine feature" in tail.lower():
        return "AOT machine-feature mismatch (foreign-host artifact loaded; "\
               "fixed by machine-fingerprint cache scoping)"
    if doc.get("ok"):
        return "ok"
    if doc.get("rc", 0) != 0:
        return f"failed rc={doc.get('rc')}"
    return "failed (no diagnosis in tail)"


def parse_multichip(path: str) -> dict:
    doc = _load(path)
    row: Dict[str, Any] = {
        "round": _round_of(path),
        "file": os.path.basename(path),
        "kind": "multichip",
    }
    if doc is None or "_load_error" in (doc or {}):
        row.update(ok=False, lost=True,
                   diagnosis=(doc or {}).get("_load_error", "unreadable file"))
        return row
    row.update(
        n_devices=doc.get("n_devices"),
        rc=doc.get("rc"),
        ok=bool(doc.get("ok")),
        skipped=bool(doc.get("skipped")),
        lost=not doc.get("ok") and not doc.get("skipped"),
        diagnosis=diagnose_multichip(doc),
    )
    return row


def load_ledger(root: str) -> dict:
    bench = sorted(
        (parse_bench(p) for p in glob.glob(os.path.join(root, "BENCH_r*.json"))),
        key=lambda r: (r["round"] is None, r["round"] or 0, r.get("file") or ""),
    )
    multichip = sorted(
        (parse_multichip(p) for p in glob.glob(os.path.join(root, "MULTICHIP_r*.json"))),
        key=lambda r: (r["round"] is None, r["round"] or 0, r.get("file") or ""),
    )
    return {
        "root": os.path.abspath(root),
        "bench": bench,
        "multichip": multichip,
        "lost_datapoints": [
            r["file"] for r in bench + multichip if r.get("lost")
        ],
        "headline_missing_rounds": [
            r["file"] for r in bench if r.get("headline_missing")
        ],
        "fleet_gate_missing_rounds": [
            r["file"] for r in bench if r.get("fleet_gate_missing")
        ],
    }


def check_regressions(ledger: dict, tolerance: float = 0.25) -> List[str]:
    """Headline budget guard: the newest healthy bench round must not be
    slower than the best earlier healthy round of the SAME metric by more
    than `tolerance`. Returns human-readable failures (empty = pass)."""
    healthy = [
        r for r in ledger["bench"]
        if not r["lost"] and not r.get("degraded")
        and isinstance(r.get("value"), (int, float))
    ]
    failures: List[str] = []
    latest = healthy[-1] if healthy else None
    prior = (
        [r for r in healthy[:-1] if r["metric"] == latest["metric"]]
        if len(healthy) >= 2 else []
    )
    if prior:
        best = min(prior, key=lambda r: r["value"])
        budget = best["value"] * (1.0 + tolerance)
        if latest["value"] > budget:
            failures.append(
                f"headline regression: {latest['metric']} = "
                f"{latest['value']:.3f}{latest['unit'] or ''} in "
                f"{latest['file']} vs best {best['value']:.3f} in "
                f"{best['file']} (budget {budget:.3f}, tolerance "
                f"{tolerance:.0%})"
            )
    # fleet gate: the newest round that ran the fleet soak must
    # have a passing referee verdict with zero safety violations
    ran_fleet = [r for r in ledger["bench"] if r.get("fleet_gate")]
    if ran_fleet:
        latest_fg = ran_fleet[-1]
        fg = latest_fg["fleet_gate"]
        if fg.get("verdict") != "pass" or (fg.get("violations") or 0) > 0:
            failures.append(
                f"fleet gate failed in {latest_fg['file']}: "
                f"verdict={fg.get('verdict')} heights={fg.get('heights')} "
                f"violations={fg.get('violations')}"
            )
    # poison defense: the newest round that ran the poisoned
    # flood must keep vote-path p99 within 2x of the clean baseline AND
    # the quarantine lane must have isolated exactly the poisoner
    ran_poison = [r for r in ledger["bench"] if r.get("poison_defense")]
    if ran_poison:
        latest_pd = ran_poison[-1]
        pd = latest_pd["poison_defense"]
        ratio = pd.get("p99_ratio_1pct")
        if isinstance(ratio, (int, float)) and ratio > 2.0:
            failures.append(
                f"poison defense failed in {latest_pd['file']}: vote-path "
                f"p99 under 1% poison flood is {ratio:.2f}x the clean "
                f"baseline (budget 2.00x)"
            )
        if pd.get("quarantine_isolated") is False:
            failures.append(
                f"poison defense failed in {latest_pd['file']}: quarantine "
                f"lane did not isolate the poisoner "
                f"(quarantine_isolated=false)"
            )
    return failures


def _fmt_versions(v: Optional[dict]) -> str:
    if not v:
        return "—"
    bits = []
    if v.get("jax"):
        bits.append(f"jax {v['jax']}")
    if v.get("git_sha"):
        bits.append(v["git_sha"][:9])
    return ", ".join(bits) or "—"


def render_markdown(ledger: dict) -> str:
    lines = [
        "# Perf trajectory ledger",
        "",
        f"Source: `{ledger['root']}` — {len(ledger['bench'])} bench rounds, "
        f"{len(ledger['multichip'])} multichip rounds, "
        f"{len(ledger['lost_datapoints'])} lost/failed datapoints.",
        "",
        "## Bench rounds",
        "",
        "| round | metric | value | speedup | prep hidden | fleet gate | mesh degrade | poison defense | host | status |",
        "|---:|---|---:|---:|---:|---|---|---|---|---|",
    ]
    for r in ledger["bench"]:
        if r["lost"]:
            status = f"**LOST** — {r['lost_reason']}"
            if r.get("headline_missing"):
                status += "; headline MISSING"
            value = "—"
            speed = "—"
        else:
            status = "degraded (cpu-fallback)" if r.get("degraded") else "ok"
            if r.get("lost_reason"):
                status += f"; {r['lost_reason']}"
            if r.get("headline_missing"):
                status += "; **headline MISSING**"
            value = (
                f"{r['value']:.1f} {r['unit'] or ''}".strip()
                if isinstance(r["value"], (int, float))
                else "—"
            )
            speed = (
                f"{r['vs_baseline']:.2f}×"
                if isinstance(r["vs_baseline"], (int, float)) and r["vs_baseline"]
                else "—"
            )
        fg = r.get("fleet_gate")
        if fg:
            mark = "" if fg.get("verdict") == "pass" else "**"
            fleet = (
                f"{mark}{fg.get('verdict')}{mark}·{fg.get('heights') or '?'}h·"
                f"{fg.get('violations') if fg.get('violations') is not None else '?'}v"
            )
        else:
            fleet = "missing"
        md = r.get("mesh_degrade")
        if md:
            ratio = md.get("ratio")
            mesh = (
                f"{ratio:.2f}×" if isinstance(ratio, (int, float)) else "?"
            ) + f"·{md.get('ladder') or '?'}"
            lost = md.get("lost_verdicts")
            if lost:  # nonzero lost verdicts is a failover BUG — shout
                mesh += f"·**{lost} lost**"
        else:
            mesh = "—"
        pd = r.get("poison_defense")
        if pd:
            ratio = pd.get("p99_ratio_1pct")
            poison = (
                f"{ratio:.2f}×" if isinstance(ratio, (int, float)) else "?"
            )
            rec = pd.get("recovery_flushes_1pct")
            if rec is not None:
                poison += f"·{rec}rf"
            if pd.get("quarantine_isolated") is False:
                poison += "·**LEAK**"  # quarantine missed the poisoner — BUG
        else:
            poison = "—"
        host = r["fingerprint"] or "—"
        if r.get("versions"):
            host += f" ({_fmt_versions(r['versions'])})"
        hidden = (
            f"{r['prep_hidden']:.0%}"
            if isinstance(r.get("prep_hidden"), (int, float))
            else "—"
        )
        lines.append(
            f"| {_round_label(r)} | {r['metric'] or '—'} | {value} "
            f"| {speed} | {hidden} | {fleet} | {mesh} | {poison} "
            f"| {host} | {status} |"
        )
    lines += ["", "### Per-scenario speedups", ""]
    scen_names: List[str] = []
    for r in ledger["bench"]:
        for name in r["scenarios"]:
            if name not in scen_names:
                scen_names.append(name)
    if scen_names:
        lines.append("| scenario | backend | " + " | ".join(
            _round_label(r) for r in ledger["bench"]) + " |")
        lines.append("|---|---|" + "---:|" * len(ledger["bench"]))
        for name in scen_names:
            cells = []
            backend = "ed25519"  # scenarios without a backend stamp are ed25519/RLC
            for r in ledger["bench"]:
                s = r["scenarios"].get(name)
                if s and s.get("backend"):
                    backend = s["backend"]
                hid = (
                    f"·h{s['prep_hidden']:.0%}"
                    if s and isinstance(s.get("prep_hidden"), (int, float))
                    else ""
                )
                if not s:
                    cells.append("—")
                elif s.get("degraded"):
                    cells.append("cpu!" + hid)
                elif "speedup" in s:
                    cells.append(f"{s['speedup']:.2f}×{hid}")
                elif "sigs_per_sec" in s:
                    cells.append(f"{s['sigs_per_sec']:,}/s")
                else:
                    cells.append("·")
            lines.append(f"| {name} | {backend} | " + " | ".join(cells) + " |")
    else:
        lines.append("(no per-scenario data)")
    lines += [
        "",
        "## Multichip rounds",
        "",
        "| round | devices | rc | status |",
        "|---:|---:|---:|---|",
    ]
    for r in ledger["multichip"]:
        lines.append(
            f"| {_round_label(r)} | {r.get('n_devices', '—')} "
            f"| {r.get('rc', '—')} | {r.get('diagnosis', '—')} |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--root", default=".",
        help="directory holding BENCH_r*.json / MULTICHIP_r*.json (repo root)",
    )
    ap.add_argument("--json", help="write the ledger as JSON here")
    ap.add_argument("--markdown", help="write the markdown table here")
    ap.add_argument(
        "--check", action="store_true",
        help="exit 2 on a headline budget regression (see --tolerance)",
    )
    ap.add_argument(
        "--tolerance", type=float, default=0.25,
        help="allowed headline slowdown vs the best prior round (default 0.25)",
    )
    args = ap.parse_args(argv)
    ledger = load_ledger(args.root)
    if not ledger["bench"] and not ledger["multichip"]:
        print(f"error: no BENCH_r*/MULTICHIP_r* files under {args.root!r}",
              file=sys.stderr)
        return 1
    failures = check_regressions(ledger, args.tolerance)
    ledger["regressions"] = failures
    md = render_markdown(ledger)
    if failures:
        md += "\n## REGRESSIONS\n\n" + "\n".join(f"- {f}" for f in failures) + "\n"
    sys.stdout.write(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(ledger, f, indent=1)
    if args.check and failures:
        for f in failures:
            print(f"REGRESSION: {f}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
