"""Offline profile analyzer: a capture directory -> a per-stage time table.
The port's copy of tendermint_tpu/tools/profile_report.py, on torch's
chrome trace (libs/profiler.py writes `torch.trace.json.gz`; any
`*.trace.json[.gz]` or `*.json` that torch.profiler exported reads too):

    python3 -m tendermint_tpu_torch.tools.profile_report <capture dir or file> \\
        [--top N] [--json OUT]

Device events (cat "kernel", "gpu_memcpy", "gpu_memset") are attributed to
stages, first match wins:

1. by name (`classify`): the MSM kernels `uptree_kernel`, `fenwick_kernel`
   and `bucket_fold_kernel` (stages uptree, fenwick_reduce, bucket_fold),
   the BLS kernels fp381_mul / fp12_sparse_mul (bls), memcpy (transfer),
   and torch's own kernels (at::, c10::, cub::, memset), the plain-op glue
   between the hand-written kernels (glue);
2. by range: `padd`, `pdbl` and `fsquare_chain` run in decompression, in
   the MSM's top tree and window fold and in the ladder, and their names
   cannot tell those apart, so the port launches them inside
   torch.profiler.record_function ranges named for the reference's stages
   ("decompress", "msm", "persig"). A kernel takes the innermost range
   around the runtime call that launched it (the trace's correlation id
   joins a kernel to its cuda_runtime / cuda_driver launch, and the
   launching thread's user_annotation events give the ranges), or failing
   that the innermost gpu_user_annotation span on its stream that holds
   it;
3. else "other": the share that fell to no stage.

Host events (cpu_op, cuda_runtime / cuda_driver, user_annotation,
python_function) are classified by name into host stages with self time
(total minus same-thread nested children). The profiler's own wrapper
events are dropped. There is no xplane reader: torch writes none.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs.profiler import DECOMPRESS, MSM, PERSIG, PROFILE_RANGES

# Stage classification by name, first match wins (case-insensitive).
STAGE_PATTERNS: List[Tuple[str, str]] = [
    ("uptree", r"uptree"),
    ("fenwick_reduce", r"fenwick"),
    ("bucket_fold", r"bucket_fold"),
    ("bls", r"fp381_mul|fp12_sparse_mul"),
    (PERSIG, rf"^{PERSIG}$|verify_prepared|ladder"),
    (DECOMPRESS, rf"^{DECOMPRESS}$|ristretto"),
    (MSM, rf"^{MSM}$|pippenger"),
    ("compile", r"^compile|nvcc"),
    ("transfer", r"memcpy|htod|dtoh|dtod"),
    ("glue", r"at::|c10::|cub::|memset"),
    ("dispatch", r"^cu[A-Z]\w*|^cuda[A-Z]\w*"),
    ("host_ops", r"^aten::"),
    ("host_python", r"^\$|\.py\(\d+\)|^<built-in"),
]
_COMPILED = [(stage, re.compile(pat, re.IGNORECASE)) for stage, pat in STAGE_PATTERNS]
# the stages a device kernel's name decides; the point kernels take their range's
NAME_STAGES = ("uptree", "fenwick_reduce", "bucket_fold", "bls", "transfer", "glue")
RANGE_STAGES = PROFILE_RANGES + ("compile",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def classify(name: str) -> str:
    for stage, rx in _COMPILED:
        if rx.search(name):
            return stage
    return "other"


# ---------------------------------------------------------------------------
# Input discovery


def find_capture_files(path: str) -> List[str]:
    """A run dir, a capture dir or a single file -> its trace file, the
    newest by name when there are several."""
    if os.path.isfile(path):
        return [path]
    found = sorted(glob.glob(os.path.join(path, "**", "*.trace.json*"), recursive=True)
                   or glob.glob(os.path.join(path, "**", "*.json"), recursive=True))
    return found[-1:]


# ---------------------------------------------------------------------------
# chrome trace parsing


def _load_chrome_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    evs = data.get("traceEvents", []) if isinstance(data, dict) else data
    pnames: Dict[object, str] = {}
    tnames: Dict[Tuple[object, object], str] = {}
    out = []
    for e in evs:
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") == "process_name":
                pnames[e.get("pid")] = e.get("args", {}).get("name", "")
            elif e.get("name") == "thread_name":
                tnames[(e.get("pid"), e.get("tid"))] = e.get("args", {}).get("name", "")
        elif ph == "X":
            args = e.get("args") or {}
            out.append({
                "name": e.get("name", ""),
                "cat": e.get("cat", ""),
                "ts_us": float(e.get("ts", 0.0)),
                "dur_us": float(e.get("dur", 0.0)),
                "pid": e.get("pid"),
                "tid": e.get("tid"),
                "correlation": args.get("correlation"),
            })
    for e in out:
        e["plane"] = pnames.get(e["pid"], str(e["pid"]))
        e["thread"] = tnames.get((e["pid"], e["tid"]), str(e["tid"]))
    return out


def load_events(path: str) -> List[dict]:
    return _load_chrome_trace(path)


# ---------------------------------------------------------------------------
# Aggregation


def _with_self_times(events: List[dict]) -> None:
    """Annotate each event with `self_us` = dur minus same-thread nested
    children (a stack sweep per thread; chrome events nest properly)."""
    by_thread: Dict[Tuple, List[dict]] = {}
    for e in events:
        e["self_us"] = e["dur_us"]
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts_us"], -e["dur_us"]))
        stack: List[dict] = []
        for e in evs:
            while stack and stack[-1]["ts_us"] + stack[-1]["dur_us"] <= e["ts_us"] + 1e-9:
                stack.pop()
            if stack:
                stack[-1]["self_us"] -= e["dur_us"]
            stack.append(e)


def _innermost(spans: List[dict], t0: float, t1: float) -> Optional[str]:
    """The shortest span holding [t0, t1] (spans sorted by start)."""
    best = None
    for s in spans:
        if s["ts_us"] > t0:
            break
        if s["ts_us"] + s["dur_us"] >= t1 and (best is None or s["dur_us"] < best["dur_us"]):
            best = s
    return None if best is None else best["name"]


def _ranges(events: List[dict]) -> Tuple[dict, dict, dict]:
    """(correlation -> launching host event, (pid, tid) -> host ranges,
    (pid, tid) -> device range spans), ranges sorted by start."""
    launches, host, dev = {}, {}, {}
    for e in events:
        if e["cat"] in ("cuda_runtime", "cuda_driver") and e["correlation"] is not None:
            launches[e["correlation"]] = e
        elif e["cat"] == "user_annotation":
            host.setdefault((e["pid"], e["tid"]), []).append(e)
        elif e["cat"] == "gpu_user_annotation":
            dev.setdefault((e["pid"], e["tid"]), []).append(e)
    for d in (host, dev):
        for spans in d.values():
            spans.sort(key=lambda s: s["ts_us"])
    return launches, host, dev


def device_stage(e: dict, launches: dict, host: dict, dev: dict) -> Tuple[str, Optional[str]]:
    """A device event's (stage, range): by name, else by the range around
    its launch (or the device span holding it), else "other"."""
    rng = None
    launch = launches.get(e["correlation"])
    if launch is not None:
        rng = _innermost(host.get((launch["pid"], launch["tid"]), []),
                         launch["ts_us"], launch["ts_us"] + launch["dur_us"])
    if rng is None:
        rng = _innermost(dev.get((e["pid"], e["tid"]), []), e["ts_us"], e["ts_us"] + e["dur_us"])
    stage = classify(e["name"])
    if stage in NAME_STAGES:
        return stage, rng
    if rng is not None and classify(rng) in RANGE_STAGES:
        return classify(rng), rng
    return "other", rng


_PROFILER_SELF = re.compile(r"^ProfilerStep|^PyTorch Profiler|^Iteration Start", re.IGNORECASE)


def _rows(d: Dict[str, dict], total: float, key: str) -> List[dict]:
    return sorted(({"name": k, **{kk: round(v, 3) if isinstance(v, float) else v
                                  for kk, v in r.items()},
                    "share": round(r[key] / (total or 1.0), 4)} for k, r in d.items()),
                  key=lambda r: -r[key])


def analyze(events: List[dict]) -> dict:
    """Events -> {"events", "wall_ms", "device_busy_ms", "stages" (device
    time by stage), "unattributed_share" (the device share of "other"),
    "ranges" (device time by range, split into kernels and glue),
    "host_stages" (host self time by stage), "ops" (by name and stage, by
    self time), "planes"}."""
    events = [e for e in events if not _PROFILER_SELF.search(e["name"])]
    launches, host_r, dev_r = _ranges(events)
    device = [e for e in events if e["cat"] in DEVICE_CATS]
    hosts = [e for e in events if e["cat"] in HOST_CATS]
    _with_self_times(hosts)
    for e in device:
        e["self_us"] = e["dur_us"]
    stages: Dict[str, dict] = {}
    ranges: Dict[str, dict] = {}
    ops: Dict[str, dict] = {}
    planes: Dict[str, dict] = {}
    for e in device:
        stage, rng = device_stage(e, launches, host_r, dev_r)
        e["stage"] = stage
        s = stages.setdefault(stage, {"count": 0, "device_us": 0.0})
        s["count"] += 1
        s["device_us"] += e["dur_us"]
        if rng is not None:
            r = ranges.setdefault(rng, {"count": 0, "device_us": 0.0, "glue_us": 0.0})
            r["count"] += 1
            r["device_us"] += e["dur_us"]
            if stage == "glue":
                r["glue_us"] += e["dur_us"]
    host_stages: Dict[str, dict] = {}
    for e in hosts:
        e["stage"] = classify(e["name"])
        s = host_stages.setdefault(e["stage"], {"count": 0, "self_us": 0.0})
        s["count"] += 1
        s["self_us"] += max(0.0, e["self_us"])
    for e in device + hosts:  # an op by name and stage: padd runs in several
        o = ops.setdefault((e["name"], e["stage"]), {"count": 0, "total_us": 0.0,
                                                     "self_us": 0.0})
        o["count"] += 1
        o["total_us"] += e["dur_us"]
        o["self_us"] += max(0.0, e["self_us"])
        p = planes.setdefault(e["plane"], {"events": 0, "self_us": 0.0})
        p["events"] += 1
        p["self_us"] += max(0.0, e["self_us"])
    busy = sum(s["device_us"] for s in stages.values())
    t0 = min((e["ts_us"] for e in events), default=0.0)
    t1 = max((e["ts_us"] + e["dur_us"] for e in events), default=0.0)
    return {
        "events": len(events),
        "wall_ms": round((t1 - t0) / 1e3, 3),
        "device_busy_ms": round(busy / 1e3, 3),
        "stages": _rows(stages, busy, "device_us"),
        "unattributed_share": round(stages.get("other", {}).get("device_us", 0.0) / (busy or 1.0),
                                    4),
        "ranges": _rows(ranges, busy, "device_us"),
        "host_stages": _rows(host_stages, sum(s["self_us"] for s in host_stages.values()),
                             "self_us"),
        "ops": [dict(r, name=r["name"][0], stage=r["name"][1]) for r in
                _rows(ops, sum(o["self_us"] for o in ops.values()), "self_us")],
        "planes": [{"plane": k, **{kk: round(vv, 3) for kk, vv in v.items()}}
                   for k, v in sorted(planes.items())],
    }


def report(path: str, top: int = 25) -> dict:
    """The full report for a capture dir or trace file."""
    files = find_capture_files(path)
    if not files:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {path!r}")
    events: List[dict] = []
    for f in files:
        events.extend(load_events(f))
    out = analyze(events)
    out["capture"] = files
    out["ops"] = out["ops"][: max(0, top)]
    return out


def render_markdown(rep: dict) -> str:
    lines = [
        f"# Profile report — {len(rep.get('capture', []))} artifact(s), {rep['events']} events, "
        f"{rep['wall_ms']:.1f} ms wall, {rep['device_busy_ms']:.3f} ms device busy",
        "",
        f"## Device time by stage ({rep['unattributed_share'] * 100:.1f}% fell to no stage)",
        "",
        "| stage | events | device ms | share |",
        "|---|---:|---:|---:|",
    ]
    for s in rep["stages"]:
        lines.append(f"| {s['name']} | {s['count']} | {s['device_us'] / 1e3:.3f} "
                     f"| {s['share'] * 100:.1f}% |")
    if rep["ranges"]:
        lines += ["", "## Device time by range", "", "| range | events | device ms | glue ms |",
                  "|---|---:|---:|---:|"]
        for r in rep["ranges"]:
            lines.append(f"| {r['name']} | {r['count']} | {r['device_us'] / 1e3:.3f} "
                         f"| {r['glue_us'] / 1e3:.3f} |")
    lines += ["", "## Host self time by stage", "", "| stage | events | self ms | share |",
              "|---|---:|---:|---:|"]
    for s in rep["host_stages"]:
        lines.append(f"| {s['name']} | {s['count']} | {s['self_us'] / 1e3:.3f} "
                     f"| {s['share'] * 100:.1f}% |")
    lines += ["", "## Top ops", "", "| op | stage | count | self ms | total ms |",
              "|---|---|---:|---:|---:|"]
    for o in rep["ops"]:
        name = o["name"] if len(o["name"]) <= 72 else o["name"][:69] + "..."
        lines.append(f"| `{name}` | {o['stage']} | {o['count']} | {o['self_us'] / 1e3:.3f} "
                     f"| {o['total_us'] / 1e3:.3f} |")
    if rep.get("planes"):
        lines += ["", "## Planes", ""]
        for p in rep["planes"]:
            lines.append(f"- `{p['plane']}`: {p['events']} events, {p['self_us'] / 1e3:.1f} ms self")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="capture directory (or a single trace file)")
    ap.add_argument("--top", type=int, default=25, help="top-N ops to list")
    ap.add_argument("--json", help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    try:
        rep = report(args.path, top=args.top)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    sys.stdout.write(render_markdown(rep))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"\nJSON report: {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
