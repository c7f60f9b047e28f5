"""Release gate: ONE entrypoint, ONE exit code, over every referee. The port's
copy of tendermint_tpu/tools/release_gate.py.

Composes three verdicts into a single machine-checkable decision:

  1. **fleet referee** (tools/fleet_referee.py) over a fleet soak's
     observatory dumps: safety audit, SLO verdicts, coverage;
  2. **perf ledger** (tools/perf_ledger.py) over the round artifacts:
     headline budget + fleet-gate column;
  3. optionally **tier-1 tests**, run as a subprocess via `--tier1-cmd`.

Exit codes are PINNED and severity-ordered: when several gates fail, the
worst one names the exit:

    0  pass               every requested gate held
    2  safety_violation   the fleet referee found conflicting commits
    3  slo_tripped        a fleet SLO burn-rate guard tripped
    4  partial            fleet coverage gaps (missing/corrupt dumps)
    5  perf_regression    perf ledger headline/fleet-gate regression
    6  fleet_missing      fleet evidence absent/unusable (and not skipped)
    7  tier1_failed       the tier-1 test command exited nonzero

Usage:

    python -m tendermint_tpu_torch.tools.release_gate --fleet-dumps ./observatory \
        --skip-perf --check
    python -m tendermint_tpu_torch.tools.release_gate --skip-fleet --root DIR --check

The perf gate reads `BENCH_r*.json` / `MULTICHIP_r*.json` under `--root`
(`evaluate(perf_root=None)` reads "."). In this repository the files at the
root are the JAX package's TPU rounds, never a figure of the port: the port
calls `evaluate` with `skip_perf=True` or an empty directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

from tendermint_tpu_torch.tools import fleet_referee, perf_ledger

EXIT_PASS = 0
EXIT_SAFETY = 2
EXIT_SLO = 3
EXIT_PARTIAL = 4
EXIT_PERF = 5
EXIT_FLEET_MISSING = 6
EXIT_TIER1 = 7

# worst-first: a fork outranks a tripped SLO outranks a coverage gap
# outranks a perf regression outranks missing evidence outranks red tests
SEVERITY = (
    EXIT_SAFETY,
    EXIT_SLO,
    EXIT_PARTIAL,
    EXIT_PERF,
    EXIT_FLEET_MISSING,
    EXIT_TIER1,
)

_GATE_NAMES = {
    EXIT_PASS: "pass",
    EXIT_SAFETY: "safety_violation",
    EXIT_SLO: "slo_tripped",
    EXIT_PARTIAL: "partial",
    EXIT_PERF: "perf_regression",
    EXIT_FLEET_MISSING: "fleet_missing",
    EXIT_TIER1: "tier1_failed",
}


def _fleet_gate(
    dumps_dir: Optional[str],
    manifest_path: Optional[str],
    max_heights: Optional[int],
) -> dict:
    """Run the fleet referee in-process. Missing/unusable evidence is its
    own failure (EXIT_FLEET_MISSING): a release gate that quietly passes
    because nobody ran the fleet is not a gate."""
    if not dumps_dir or not os.path.isdir(dumps_dir):
        return {
            "status": "missing",
            "exit_code": EXIT_FLEET_MISSING,
            "detail": f"no dumps directory at {dumps_dir!r}",
        }
    dumps = fleet_referee.obs.load_dumps(dumps_dir)
    if not dumps:
        return {
            "status": "missing",
            "exit_code": EXIT_FLEET_MISSING,
            "detail": f"no observatory dumps under {dumps_dir!r}",
        }
    manifest = fleet_referee.load_manifest(manifest_path or dumps_dir)
    report = fleet_referee.build_report(
        dumps, manifest=manifest, max_heights=max_heights
    )
    fleet_referee.write_report(report, dumps_dir)
    code = report["exit_code"]
    if report["verdict"] == fleet_referee.VERDICT_NO_DATA:
        code = EXIT_FLEET_MISSING
    return {
        "status": report["verdict"],
        "exit_code": code,
        "detail": {
            "safety_violations": [
                v["height"] for v in report["safety"]["violations"]
            ],
            "slo_any_tripped": report["slo_any_tripped"],
            "coverage_missing": report["coverage"]["missing"],
            "heights_merged": report["waterfall"]["heights_merged"],
        },
    }


def _perf_gate(root: str, tolerance: float) -> dict:
    """perf_ledger --check in-process: headline budget + the fleet-gate
    column. An empty ledger is a pass here (young repos have no rounds),
    not a failure — the fleet gate owns evidence-missing semantics."""
    ledger = perf_ledger.load_ledger(root)
    if not ledger["bench"] and not ledger["multichip"]:
        return {"status": "no_rounds", "exit_code": EXIT_PASS, "detail": None}
    failures = perf_ledger.check_regressions(ledger, tolerance)
    if failures:
        return {
            "status": "regression",
            "exit_code": EXIT_PERF,
            "detail": failures,
        }
    return {
        "status": "pass",
        "exit_code": EXIT_PASS,
        "detail": {
            "bench_rounds": len(ledger["bench"]),
            "fleet_gate_missing_rounds": len(
                ledger["fleet_gate_missing_rounds"]
            ),
        },
    }


def _tier1_gate(cmd: Optional[str], timeout: float) -> dict:
    if not cmd:
        return {"status": "skipped", "exit_code": EXIT_PASS, "detail": None}
    try:
        proc = subprocess.run(
            cmd, shell=True, capture_output=True, text=True, timeout=timeout
        )
    except subprocess.TimeoutExpired:
        return {
            "status": "timeout",
            "exit_code": EXIT_TIER1,
            "detail": f"tier-1 command timed out after {timeout:.0f}s",
        }
    if proc.returncode != 0:
        return {
            "status": "failed",
            "exit_code": EXIT_TIER1,
            "detail": {
                "rc": proc.returncode,
                "tail": (proc.stdout or "")[-2000:] + (proc.stderr or "")[-500:],
            },
        }
    return {"status": "pass", "exit_code": EXIT_PASS, "detail": None}


def evaluate(
    *,
    fleet_dumps: Optional[str] = None,
    fleet_manifest: Optional[str] = None,
    max_heights: Optional[int] = None,
    skip_fleet: bool = False,
    perf_root: Optional[str] = ".",
    tolerance: float = 0.25,
    skip_perf: bool = False,
    tier1_cmd: Optional[str] = None,
    tier1_timeout: float = 1800.0,
) -> dict:
    """Run every requested gate and fold the failures severity-first into
    one exit code. Pure composition — each gate is independently testable
    and a skipped gate is RECORDED as skipped, never silently passed."""
    gates: Dict[str, Any] = {}
    if skip_fleet:
        gates["fleet"] = {"status": "skipped", "exit_code": EXIT_PASS, "detail": None}
    else:
        gates["fleet"] = _fleet_gate(fleet_dumps, fleet_manifest, max_heights)
    if skip_perf:
        gates["perf"] = {"status": "skipped", "exit_code": EXIT_PASS, "detail": None}
    else:
        gates["perf"] = _perf_gate(perf_root or ".", tolerance)
    gates["tier1"] = _tier1_gate(tier1_cmd, tier1_timeout)

    codes = {g["exit_code"] for g in gates.values()}
    exit_code = next((c for c in SEVERITY if c in codes), EXIT_PASS)
    return {
        "release_gate": 1,
        "generated_ts": round(time.time(), 3),
        "verdict": _GATE_NAMES[exit_code],
        "exit_code": exit_code,
        "gates": gates,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--fleet-dumps", default="./observatory",
        help="fleet soak dumps directory (default ./observatory)",
    )
    ap.add_argument(
        "--fleet-manifest",
        help="fleet manifest path (default <fleet-dumps>/fleet_manifest.json)",
    )
    ap.add_argument(
        "--heights", type=int, default=0,
        help="most recent heights to merge in the referee (0 = all)",
    )
    ap.add_argument(
        "--skip-fleet", action="store_true",
        help="skip the fleet gate (recorded as skipped, not passed silently)",
    )
    ap.add_argument(
        "--root", default=".",
        help="perf ledger root holding BENCH_r*.json (default .)",
    )
    ap.add_argument(
        "--tolerance", type=float, default=0.25,
        help="perf ledger headline tolerance (default 0.25)",
    )
    ap.add_argument("--skip-perf", action="store_true", help="skip the perf gate")
    ap.add_argument(
        "--tier1-cmd",
        help="shell command running the tier-1 suite (nonzero rc => exit 7)",
    )
    ap.add_argument(
        "--tier1-timeout", type=float, default=1800.0,
        help="tier-1 command timeout in seconds (default 1800)",
    )
    ap.add_argument("--out", help="write the gate summary JSON here")
    ap.add_argument(
        "--check", action="store_true",
        help="exit with the severity-ordered gate code instead of 0",
    )
    args = ap.parse_args(argv)

    result = evaluate(
        fleet_dumps=args.fleet_dumps,
        fleet_manifest=args.fleet_manifest,
        max_heights=args.heights or None,
        skip_fleet=args.skip_fleet,
        perf_root=args.root,
        tolerance=args.tolerance,
        skip_perf=args.skip_perf,
        tier1_cmd=args.tier1_cmd,
        tier1_timeout=args.tier1_timeout,
    )
    print(json.dumps(result, indent=1, default=repr))
    if args.out:
        # the referee's --out is a directory; accept the same here rather
        # than masking the gate's exit code with an IsADirectoryError
        out = args.out
        if os.path.isdir(out):
            out = os.path.join(out, "release_gate.json")
        with open(out, "w") as f:
            json.dump(result, f, indent=1, default=repr)
    print(
        f"\nRELEASE GATE: {result['verdict'].upper()} "
        f"(exit {result['exit_code']})"
    )
    if args.check:
        return result["exit_code"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
