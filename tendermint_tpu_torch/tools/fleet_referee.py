"""Fleet referee: one machine-readable verdict over a whole fleet soak. The
port's copy of tendermint_tpu/tools/fleet_referee.py.

The chain observatory (tools/chain_observatory.py) merges per-node dumps
into a descriptive report; the referee turns that evidence — plus a
cross-node **safety audit** it runs itself — into a single release-gate
verdict with a pinned exit code:

    verdict            exit   meaning
    pass                0     safety held, no SLO guard tripped, full coverage
    safety_violation    2     two nodes committed different hashes at a height
                              (the non-negotiable core — named per height)
    slo_tripped         3     some node's SLO burn-rate guard tripped
    partial             4     coverage gaps: dumps missing/corrupt, or nodes
                              the manifest expected that never dumped
    no_data             1     nothing to audit (no usable dumps at all)

Severity strictly orders the verdicts: a fork outranks a tripped SLO
outranks a coverage gap. The safety audit reads the bounded `chain`
sections `capture_node_dump` embeds in every dump (last N committed block
hashes per node) and compares every height two or more nodes share — a
disagreement is never averaged away, it IS the verdict.

The optional `fleet_manifest.json` (chaos/fleet.py writes one next to the
dumps) is the referee's ground truth for coverage and roles: nodes the
harness says survived MUST appear in the dumps (missing ones are named),
and SLO verdicts fold per role (validator / full / light_edge) so "the
light edges blew their budget" reads directly off the report.

Usage:

    python -m tendermint_tpu_torch.tools.fleet_referee --dumps ./observatory --check
    python -m tendermint_tpu_torch.tools.fleet_referee --dumps ./observatory \
        --manifest ./observatory/fleet_manifest.json --out ./observatory
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

from tendermint_tpu_torch.tools import chain_observatory as obs

MANIFEST_NAME = "fleet_manifest.json"

VERDICT_PASS = "pass"
VERDICT_SAFETY = "safety_violation"
VERDICT_SLO = "slo_tripped"
VERDICT_PARTIAL = "partial"
VERDICT_NO_DATA = "no_data"

EXIT_CODES = {
    VERDICT_PASS: 0,
    VERDICT_NO_DATA: 1,
    VERDICT_SAFETY: 2,
    VERDICT_SLO: 3,
    VERDICT_PARTIAL: 4,
}


# -- inputs -------------------------------------------------------------------


def load_manifest(path_or_dir: str) -> Optional[dict]:
    """The fleet manifest at `path` (or `<dir>/fleet_manifest.json`), or
    None — the referee works manifest-less, it just can't see nodes that
    never produced a dump."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and doc.get("fleet_manifest") else None


def _roles_by_label(manifest: Optional[dict]) -> Dict[str, str]:
    if not manifest:
        return {}
    out = {}
    for n in manifest.get("nodes") or []:
        if n.get("label"):
            out[n["label"]] = n.get("role") or "?"
    return out


# -- the safety auditor -------------------------------------------------------


def safety_audit(dumps: List[dict]) -> dict:
    """Compare committed block hashes per height across every dump's `chain`
    section. Any height where two nodes disagree is a violation naming the
    height and each node's hash — THE BFT safety invariant, audited offline
    from the evidence files alone."""
    by_height: Dict[int, Dict[str, str]] = {}
    audited_nodes = 0
    for dump in dumps:
        chain = dump.get("chain") or {}
        hashes = chain.get("hashes")
        if not isinstance(hashes, dict) or not hashes:
            continue
        audited_nodes += 1
        label = obs._node_label(dump)
        for h_str, hx in hashes.items():
            try:
                h = int(h_str)
            except (TypeError, ValueError):
                continue
            by_height.setdefault(h, {})[label] = str(hx)

    violations = []
    checked = 0
    for h in sorted(by_height):
        entries = by_height[h]
        if len(entries) < 2:
            continue
        checked += 1
        if len(set(entries.values())) > 1:
            violations.append({"height": h, "hashes": dict(sorted(entries.items()))})
    try:
        from tendermint_tpu_torch.libs.metrics import fleet_metrics

        if checked:
            fleet_metrics().safety_checks.inc(checked)
    except Exception:
        pass
    return {
        "nodes_audited": audited_nodes,
        "heights_checked": checked,
        "violations": violations,
    }


# -- the report ---------------------------------------------------------------


def build_report(
    dumps: List[dict],
    manifest: Optional[dict] = None,
    max_heights: Optional[int] = None,
) -> dict:
    """Fold the observatory merge, the safety audit, manifest-aware
    coverage, per-role SLO verdicts, waterfall coverage, and terminal
    accounting into one report with a single `verdict`."""
    merged = obs.merge(dumps, max_heights=max_heights)
    safety = safety_audit(dumps)
    roles = _roles_by_label(manifest)

    # coverage: dumps that failed to load/scrape, plus manifest-expected
    # survivors that produced NO dump at all
    present = {obs._node_label(d) for d in dumps}
    failed = list(merged["coverage"]["missing"])
    expected = [
        n["label"]
        for n in (manifest.get("nodes") if manifest else []) or []
        if n.get("live") and n.get("label")
    ]
    never_dumped = sorted(set(expected) - present)
    usable = merged["coverage"]["merged"]
    coverage = {
        "dumps": len(dumps),
        "merged": usable,
        "expected_live": len(expected) if manifest else None,
        "missing": sorted(set(failed) | set(never_dumped)),
        "failed_dumps": sorted(failed),
        "never_dumped": never_dumped,
        "partial": bool(failed or never_dumped),
    }

    # per-node waterfall coverage: on how many merged heights does each
    # node's milestone row appear? ("fleet_report covers every surviving
    # node's waterfall" is checked right off this map)
    n_heights = len(merged["heights"])
    waterfall_cov: Dict[str, int] = {}
    for rec in merged["heights"]:
        for label in rec["nodes"]:
            waterfall_cov[label] = waterfall_cov.get(label, 0) + 1
    waterfall = {
        "heights_merged": n_heights,
        "per_node": dict(sorted(waterfall_cov.items())),
        "uncovered": sorted(
            lbl for lbl in (expected or sorted(present - set(failed)))
            if not waterfall_cov.get(lbl)
        ),
    }

    # per-role SLO fold: worst verdict + trip/breach totals per role
    by_role: Dict[str, dict] = {}
    for row in merged["slo"]:
        role = roles.get(row["node"], "?")
        ent = by_role.setdefault(
            role, {"nodes": set(), "objectives": 0, "tripped": 0, "breaches": 0}
        )
        ent["nodes"].add(row["node"])
        ent["objectives"] += 1
        ent["breaches"] += row.get("breaches") or 0
        if row.get("tripped"):
            ent["tripped"] += 1
    role_slo = {
        role: {
            "nodes": len(ent["nodes"]),
            "objectives": ent["objectives"],
            "tripped": ent["tripped"],
            "breaches": ent["breaches"],
            "verdict": "TRIPPED" if ent["tripped"] else "ok",
        }
        for role, ent in sorted(by_role.items())
    }

    # elastic-mesh degrade column: each dump's `mesh` section
    # (/debug/mesh) carries the degrade-ladder rung, rebuild count and
    # per-device health — fold the worst rung fleet-wide so a soak that
    # silently limped on a survivor mesh (or fell to host-RLC) reads
    # straight off the report instead of hiding in per-node dumps
    ladder_rank = {"full": 0, "survivor": 1, "single": 2, "host": 3}
    mesh_nodes: Dict[str, dict] = {}
    for dump in dumps:
        mesh = dump.get("mesh")
        if not isinstance(mesh, dict) or mesh.get("error"):
            continue
        health = mesh.get("health") or {}
        devices = health.get("devices") or {}
        dead = sorted(
            k for k, st in devices.items()
            if isinstance(st, dict) and st.get("state") == "dead"
        )
        ladder = mesh.get("ladder")
        rebuilds = mesh.get("rebuilds") or 0
        if ladder is None and not rebuilds and not dead:
            continue  # node never exercised the elastic mesh: no column
        mesh_nodes[obs._node_label(dump)] = {
            "ladder": ladder,
            "rebuilds": int(rebuilds),
            "dead_devices": dead,
        }
    mesh_degrade = None
    if mesh_nodes:
        worst = max(
            (e["ladder"] for e in mesh_nodes.values() if e["ladder"]),
            key=lambda l: ladder_rank.get(l, 0),
            default=None,
        )
        mesh_degrade = {
            "worst_ladder": worst,
            "rebuilds_total": sum(e["rebuilds"] for e in mesh_nodes.values()),
            "nodes": dict(sorted(mesh_nodes.items())),
        }

    # quarantine/recovery column: each dump's `suspicion` section
    # snapshots the process-global SuspicionScorer and its verify_stats
    # counters carry the recovery-flush total — fold with a UNION (and max
    # over the shared counters), never a sum: in-process fleets share one
    # scorer, so every dump repeats the same snapshot. A soak where a
    # poisoner got quarantined (or punished) reads straight off the report.
    quarantined_union: set = set()
    punished_max = 0
    paroles_max = 0
    recovery_max = 0
    quarantined_rows_max = 0
    saw_suspicion = False
    for dump in dumps:
        sus = dump.get("suspicion")
        if isinstance(sus, dict) and not sus.get("error"):
            saw_suspicion = True
            quarantined_union.update(sus.get("quarantined") or [])
            punished_max = max(punished_max, int(sus.get("punished") or 0))
            paroles_max = max(paroles_max, int(sus.get("paroles") or 0))
        vs = dump.get("verify_stats")
        counters = (vs or {}).get("counters") if isinstance(vs, dict) else None
        if isinstance(counters, dict):
            recovery_max = max(
                recovery_max, int(counters.get("recovery_flushes") or 0)
            )
            quarantined_rows_max = max(
                quarantined_rows_max, int(counters.get("quarantined_rows") or 0)
            )
    quarantine = None
    if saw_suspicion:
        quarantine = {
            "quarantined_sources": sorted(quarantined_union),
            "punished": punished_max,
            "paroles": paroles_max,
            "recovery_flushes": recovery_max,
            "quarantined_rows": quarantined_rows_max,
        }

    # fleet-wide terminal accounting (delivered/rejected/evicted/expired)
    terminals: Dict[str, int] = {}
    for terms in (merged.get("tx_terminals") or {}).values():
        for outcome, count in terms.items():
            try:
                terminals[outcome] = terminals.get(outcome, 0) + int(count)
            except (TypeError, ValueError):
                continue

    if usable == 0:
        verdict = VERDICT_NO_DATA
    elif safety["violations"]:
        verdict = VERDICT_SAFETY
    elif merged["slo_any_tripped"]:
        verdict = VERDICT_SLO
    elif coverage["partial"]:
        verdict = VERDICT_PARTIAL
    else:
        verdict = VERDICT_PASS
    try:
        from tendermint_tpu_torch.libs.metrics import fleet_metrics

        fleet_metrics().referee_verdicts.labels(verdict).inc()
    except Exception:
        pass

    report: Dict[str, Any] = {
        "fleet_report": 1,
        "generated_ts": round(time.time(), 3),
        "verdict": verdict,
        "exit_code": EXIT_CODES[verdict],
        "coverage": coverage,
        "safety": safety,
        "roles": {
            lbl: roles.get(lbl, "?") for lbl in sorted(present)
        } if roles else {},
        "role_slo": role_slo,
        "slo_any_tripped": merged["slo_any_tripped"],
        "waterfall": waterfall,
        "mesh_degrade": mesh_degrade,
        "quarantine": quarantine,
        "terminals": terminals,
        "slowest_link_counts": merged["slowest_link_counts"],
        "worst_offender": merged["worst_offender"],
        "peer_lag_worst": merged["peer_lag"][:5],
        "manifest": {
            "seed": manifest.get("seed"),
            "fingerprint": manifest.get("fingerprint"),
            "schedule_fingerprint": manifest.get("schedule_fingerprint"),
            "chaos": manifest.get("chaos"),
            "workload_counters": manifest.get("workload_counters"),
        } if manifest else None,
        "observatory": merged,
    }
    return report


# -- rendering ----------------------------------------------------------------


def render_markdown(report: dict) -> str:
    lines: List[str] = []
    lines.append("# Fleet referee report")
    lines.append("")
    v = report["verdict"]
    lines.append(f"## VERDICT: **{v.upper()}** (exit {report['exit_code']})")
    lines.append("")
    man = report.get("manifest")
    if man:
        lines.append(
            f"fleet seed `{man['seed']}` · spec fingerprint "
            f"`{man['fingerprint']}` · schedule `{man['schedule_fingerprint']}`"
        )
        lines.append("")

    cov = report["coverage"]
    lines.append("## Coverage")
    lines.append("")
    exp = cov["expected_live"]
    lines.append(
        f"{cov['merged']}/{cov['dumps']} dumps merged"
        + (f", {exp} live nodes expected by the manifest" if exp is not None else "")
        + "."
    )
    if cov["partial"]:
        lines.append("")
        lines.append(
            f"**PARTIAL**: missing nodes: {', '.join(cov['missing'])}"
            + (
                f" (failed dumps: {', '.join(cov['failed_dumps'])})"
                if cov["failed_dumps"]
                else ""
            )
        )
    lines.append("")

    safety = report["safety"]
    lines.append("## Safety audit (cross-node block hashes)")
    lines.append("")
    lines.append(
        f"{safety['heights_checked']} shared heights compared across "
        f"{safety['nodes_audited']} nodes."
    )
    if safety["violations"]:
        for viol in safety["violations"]:
            lines.append("")
            lines.append(f"**SAFETY VIOLATION at height {viol['height']}**:")
            for label, hx in viol["hashes"].items():
                lines.append(f"- {label}: `{hx[:16]}…`")
    else:
        lines.append("")
        lines.append("No conflicting commits — safety held.")
    lines.append("")

    lines.append("## Per-role SLO verdicts")
    lines.append("")
    if report["role_slo"]:
        lines.append("| role | nodes | objectives | tripped | breaches | verdict |")
        lines.append("|---|---|---|---|---|---|")
        for role, ent in report["role_slo"].items():
            lines.append(
                f"| {role} | {ent['nodes']} | {ent['objectives']} | "
                f"{ent['tripped']} | {ent['breaches']} | {ent['verdict']} |"
            )
    else:
        lines.append("no SLO engines enabled")
    lines.append("")

    wf = report["waterfall"]
    lines.append("## Waterfall coverage")
    lines.append("")
    lines.append(
        f"{wf['heights_merged']} heights merged; per-node appearance counts:"
    )
    lines.append("")
    lines.append("| node | role | heights covered | mesh degrade |")
    lines.append("|---|---|---|---|")
    roles = report.get("roles") or {}
    mesh_nodes = (report.get("mesh_degrade") or {}).get("nodes") or {}
    for label, count in wf["per_node"].items():
        me = mesh_nodes.get(label)
        if me:
            mesh_cell = f"{me.get('ladder') or '?'}·{me.get('rebuilds', 0)}rb"
            if me.get("dead_devices"):
                mesh_cell += f"·{len(me['dead_devices'])}dead"
        else:
            mesh_cell = "—"
        lines.append(
            f"| {label} | {roles.get(label, '?')} | {count} | {mesh_cell} |"
        )
    if wf["uncovered"]:
        lines.append("")
        lines.append(
            f"**uncovered nodes** (no waterfall row on any merged height): "
            f"{', '.join(wf['uncovered'])}"
        )
    lines.append("")

    md = report.get("mesh_degrade")
    if md:
        lines.append("## Elastic mesh degrade")
        lines.append("")
        worst = md.get("worst_ladder")
        mark = "**" if worst and worst != "full" else ""
        lines.append(
            f"worst ladder rung: {mark}{worst or '?'}{mark} · "
            f"{md.get('rebuilds_total', 0)} mesh rebuild(s) fleet-wide"
        )
        lines.append("")

    q = report.get("quarantine")
    if q:
        lines.append("## Adversarial flush defense")
        lines.append("")
        srcs = q.get("quarantined_sources") or []
        mark = "**" if srcs else ""
        lines.append(
            f"quarantined sources: {mark}{', '.join(srcs) or 'none'}{mark} · "
            f"{q.get('punished', 0)} punished · {q.get('paroles', 0)} paroled · "
            f"{q.get('recovery_flushes', 0)} recovery flush(es) · "
            f"{q.get('quarantined_rows', 0)} quarantined row(s)"
        )
        lines.append("")

    lines.append("## Terminal outcomes (fleet-wide)")
    lines.append("")
    if report["terminals"]:
        lines.append(
            ", ".join(f"{k}={v}" for k, v in sorted(report["terminals"].items()))
        )
    else:
        lines.append("no tx lifecycle terminals recorded")
    lines.append("")

    if report.get("worst_offender"):
        lines.append(
            f"Habitual slowest link: **{report['worst_offender']}** "
            f"({report['slowest_link_counts'][report['worst_offender']]} heights)"
        )
        lines.append("")
    return "\n".join(lines)


def write_report(report: dict, out_dir: str) -> tuple:
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, "fleet_report.json")
    md_path = os.path.join(out_dir, "fleet_report.md")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=1, default=repr)
    with open(md_path, "w") as f:
        f.write(render_markdown(report))
    return json_path, md_path


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--dumps", required=True,
        help=f"directory of {obs.DUMP_PREFIX}*.json dumps (+ optional manifest)",
    )
    ap.add_argument(
        "--manifest",
        help=f"fleet manifest path (default <dumps>/{MANIFEST_NAME} if present)",
    )
    ap.add_argument(
        "--out", help="output directory for fleet_report.{json,md} (default --dumps)"
    )
    ap.add_argument(
        "--heights", type=int, default=0,
        help="most recent heights to merge (0 = all; default all)",
    )
    ap.add_argument(
        "--check", action="store_true",
        help="exit with the verdict's code (see EXIT_CODES) instead of 0",
    )
    args = ap.parse_args(argv)

    dumps = obs.load_dumps(args.dumps)
    manifest = load_manifest(args.manifest or args.dumps)
    report = build_report(dumps, manifest=manifest, max_heights=args.heights or None)
    json_path, md_path = write_report(report, args.out or args.dumps)
    print(render_markdown(report))
    print(f"wrote {json_path} and {md_path}")
    if args.check:
        return report["exit_code"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
