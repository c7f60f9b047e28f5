"""Chain observatory: merge every node's debug surfaces into ONE report. The
port's copy of tendermint_tpu/tools/chain_observatory.py.

Every observability surface before this is node-local: a single process can
explain its own flushes, steps, and stalls, but nobody could answer "where
did height H spend its 800 ms across the 4-node net". This tool scrapes each
node's `/debug/consensus_timeline`, `/debug/verify_stats`,
`/debug/overload`, `/debug/mesh`, and `/debug/slo` — live over RPC, or
offline from dump files captured by soaks/bench — and merges them on
(height, round) into one markdown + JSON chain report:

- a per-height **waterfall**: proposal created → first/last peer receipt →
  +2/3 prevote (the PRECOMMIT step entry) → +2/3 precommit (the COMMIT step
  entry) → commit, as millisecond offsets per node;
- **slowest-link attribution**: the node × stage with the largest gap per
  height, and the worst habitual offender across the report;
- a **per-peer lag ranking** merged from every node's per-origin
  propagation aggregates (trace stamps carried in the p2p envelope,
  clock-skew corrected — consensus/timeline.py peer_stats);
- **SLO verdicts** per node from the burn-rate engine (libs/slo.py).

Usage:

    # live, against a running net
    python -m tendermint_tpu_torch.tools.chain_observatory \
        --nodes http://127.0.0.1:26657,http://127.0.0.1:26660

    # offline, from dump files a soak captured (write_node_dump below)
    python -m tendermint_tpu_torch.tools.chain_observatory --dumps ./observatory

    # guard mode: exit 2 when any node's SLO guard tripped
    python -m tendermint_tpu_torch.tools.chain_observatory --dumps ./observatory --check

A dump's `verify_stats` and `mesh` sections are libs/trace.verify_stats()
and parallel/telemetry.mesh_stats(), the snapshots /debug/verify_stats and
/debug/mesh serve; its `suspicion` section is the process-global
provenance scorer's stats. The dump format, the merge and the report are
the reference's, so either package's tools read either package's dumps.

Timestamps in a merged report come from each node's LOCAL wall clock. For
the in-process soaks that is one clock; for a real fleet the per-connection
skew estimates ride each dump (net_info/connection_status) and the
propagation latencies inside the timelines are already skew-corrected — the
absolute cross-node offsets in the waterfall carry the residual skew, which
the report states rather than hides (honesty over precision).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

DUMP_VERSION = 1
DUMP_PREFIX = "observatory_"

# step names marking quorum milestones: entering PRECOMMIT requires +2/3
# prevotes, entering COMMIT requires +2/3 precommits (consensus/cs_state.py)
_STEP_MILESTONES = (
    ("propose_ts", "PROPOSE"),
    ("prevote_ts", "PREVOTE"),
    ("precommit_quorum_ts", "PRECOMMIT"),
    ("commit_step_ts", "COMMIT"),
)

_WATERFALL_STAGES = (
    ("proposal_recv_ms", "proposal receipt"),
    ("prevote_quorum_ms", "+2/3 prevote"),
    ("precommit_quorum_ms", "+2/3 precommit"),
    ("commit_ms", "commit"),
)


# -- capture ------------------------------------------------------------------


def capture_node_dump(node, hash_window: int = 64) -> dict:
    """In-process capture of one node's observability surfaces (the offline
    producer soaks/bench use — no RPC listener needed). Every section
    degrades independently to an error string."""
    doc: Dict[str, Any] = {
        "observatory_dump": DUMP_VERSION,
        "captured_ts": round(time.time(), 3),
        "node_id": getattr(getattr(node, "node_key", None), "id", None),
        "moniker": getattr(
            getattr(getattr(node, "config", None), "base", None), "moniker", None
        ),
    }
    tl = getattr(node, "timeline", None)
    try:
        doc["timeline"] = {
            "heights": tl.dump() if tl is not None else [],
            "propagation_peers": tl.peer_stats() if tl is not None else {},
        }
    except Exception as e:
        doc["timeline"] = {"error": repr(e), "heights": [], "propagation_peers": {}}
    eng = getattr(node, "slo", None)
    try:
        doc["slo"] = eng.snapshot() if eng is not None else {"enabled": False}
    except Exception as e:
        doc["slo"] = {"error": repr(e)}
    tt = getattr(node, "tx_tracker", None)
    try:
        doc["txtrace"] = tt.stats() if tt is not None else {"enabled": False}
    except Exception as e:
        doc["txtrace"] = {"error": repr(e)}
    try:
        from tendermint_tpu_torch.libs import trace as _trace

        doc["verify_stats"] = _trace.verify_stats()
    except Exception as e:
        doc["verify_stats"] = {"error": repr(e)}
    try:
        ctl = getattr(node, "overload", None)
        doc["overload"] = {
            "controller": ctl.snapshot() if ctl is not None else None
        }
    except Exception as e:
        doc["overload"] = {"error": repr(e)}
    try:
        from tendermint_tpu_torch.parallel import telemetry as _mesh

        doc["mesh"] = _mesh.mesh_stats()
    except Exception as e:
        doc["mesh"] = {"error": repr(e)}
    try:
        from tendermint_tpu_torch.crypto import provenance as _prov

        # the suspicion scorer is process-global (like the mesh): every
        # in-process node's dump carries the same snapshot, and the fleet
        # referee folds them with a union, not a sum
        doc["suspicion"] = _prov.default_scorer().stats()
    except Exception as e:
        doc["suspicion"] = {"error": repr(e)}
    try:
        sw = getattr(node, "switch", None)
        peers = {}
        if sw is not None:
            for p in sw.peers.list():
                st = p.status()
                peers[p.id] = {
                    "clock_skew_s": st.get("clock_skew_s"),
                    "clock_skew_rtt_s": st.get("clock_skew_rtt_s"),
                }
        doc["peers"] = peers
    except Exception as e:
        doc["peers"] = {"error": repr(e)}
    try:
        doc["chain"] = _chain_section(node, hash_window)
    except Exception as e:
        doc["chain"] = {"error": repr(e)}
    return doc


def _chain_section(node, hash_window: int) -> dict:
    """Committed block hashes over the last `hash_window` heights — the raw
    material for the fleet referee's cross-node safety audit
    (tools/fleet_referee.py). Bounded: a 100k-height chain contributes the
    same few KB as a 100-height one."""
    bs = node.block_store
    top = bs.height
    lo = max(bs.base or 1, 1, top - hash_window + 1)
    hashes = {}
    for h in range(lo, top + 1):
        b = bs.load_block(h)
        if b is not None:
            hashes[str(h)] = b.hash().hex()
    return {"base": bs.base, "height": top, "hashes": hashes}


def write_node_dump(node, directory: str) -> str:
    """capture_node_dump -> observatory_<id8>.json under `directory`."""
    doc = capture_node_dump(node)
    nid = (doc.get("node_id") or doc.get("moniker") or "node")[:8]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{DUMP_PREFIX}{nid}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=repr)
    return path


async def scrape_node(base_url: str, timeout: float = 5.0) -> dict:
    """Live capture of one node over its RPC listener. Each endpoint
    degrades independently (a node mid-overload still yields a partial
    dump), and every call is bounded by `timeout` seconds — one hung node
    in a 50-node fleet must cost at most a timeout, never the scrape."""
    import asyncio

    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(base_url)
    doc: Dict[str, Any] = {
        "observatory_dump": DUMP_VERSION,
        "captured_ts": round(time.time(), 3),
        "scraped_from": base_url,
    }

    async def call(section, method, **params):
        try:
            doc[section] = await asyncio.wait_for(
                client.call(method, **params), timeout
            )
        except Exception as e:
            doc[section] = {"error": repr(e)}

    try:
        try:
            st = await asyncio.wait_for(client.call("status"), timeout)
            doc["node_id"] = st.get("node_info", {}).get("id")
            doc["moniker"] = st.get("node_info", {}).get("moniker")
        except Exception as e:
            # the identity call failing marks the WHOLE dump: the merge's
            # coverage section must list this node as missing, not quietly
            # fold an empty record in
            doc["node_id"] = None
            doc["error_status"] = repr(e)
            doc["scrape_error"] = repr(e)
        await call("timeline", "consensus_timeline")
        await call("slo", "debug_slo")
        await call("verify_stats", "debug_verify_stats")
        await call("overload", "debug_overload")
        await call("mesh", "debug_mesh")
        await call("txtrace", "debug_tx_trace")
        tl = doc.get("timeline") or {}
        if doc.get("node_id") is None:
            doc["node_id"] = tl.get("node_id") if isinstance(tl, dict) else None
    finally:
        await client.close()
    return doc


async def scrape_fleet(
    urls: List[str], timeout: float = 5.0, concurrency: int = 16
) -> List[dict]:
    """Scrape many nodes concurrently (bounded by `concurrency`): a 50-node
    fleet scrape costs ~ceil(50/16) round-trips, and a node that fails
    entirely still yields a dump row carrying `scrape_error` so the report
    can NAME it instead of dropping it."""
    import asyncio

    sem = asyncio.Semaphore(max(1, concurrency))

    async def one(u: str) -> dict:
        async with sem:
            try:
                return await scrape_node(u, timeout=timeout)
            except Exception as e:
                return {
                    "observatory_dump": DUMP_VERSION,
                    "node_id": u,
                    "scraped_from": u,
                    "scrape_error": repr(e),
                }

    return list(await asyncio.gather(*(one(u) for u in urls)))


def load_dumps(directory: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, f"{DUMP_PREFIX}*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            # label the broken dump by its node stem (observatory_<id>.json
            # -> <id>) so coverage lists name the NODE, not a truncated
            # filename prefix shared by every dump in the directory
            stem = os.path.splitext(os.path.basename(path))[0]
            if stem.startswith(DUMP_PREFIX):
                stem = stem[len(DUMP_PREFIX):] or stem
            out.append({
                "node_id": stem,
                "load_error": f"{e!r}",
                "source_file": path,
            })
            continue
        doc.setdefault("source_file", path)
        out.append(doc)
    return out


# -- merge --------------------------------------------------------------------


def _node_label(dump: dict) -> str:
    nid = dump.get("node_id") or dump.get("moniker") or "?"
    return str(nid)[:10]


def _height_records(dump: dict) -> Dict[int, dict]:
    tl = dump.get("timeline") or {}
    heights = tl.get("heights") or []
    return {rec["height"]: rec for rec in heights if "height" in rec}


def _milestones(rec: dict) -> dict:
    """Per-node millisecond-resolution milestones for one height record."""
    out: Dict[str, Optional[float]] = {
        "proposal_ts": None,
        "prevote_quorum_ts": None,
        "precommit_quorum_ts": None,
        "commit_ts": None,
        "round": None,
        "proposal_first_seen_ms": None,
        "proposal_origin": None,
        "proposal_hops": None,
        "parts_fanout_s": None,
    }
    props = rec.get("proposals") or []
    if props and props[0].get("ts") is not None:
        out["proposal_ts"] = props[0]["ts"]
    steps = rec.get("steps") or []
    seen = {}
    for st in steps:
        name = st.get("step")
        if name not in seen and st.get("ts") is not None:
            seen[name] = st["ts"]
    # entering PRECOMMIT == +2/3 prevote seen; entering COMMIT == +2/3 precommit
    out["prevote_quorum_ts"] = seen.get("PRECOMMIT")
    out["precommit_quorum_ts"] = seen.get("COMMIT")
    commit = rec.get("commit")
    if commit is not None:
        out["commit_ts"] = commit.get("ts")
        out["round"] = commit.get("round")
    prop = rec.get("propagation") or {}
    # the commit round's propagation record, else the lowest recorded round
    rounds = sorted(prop, key=lambda r: int(r))
    key = None
    if out["round"] is not None and str(out["round"]) in {str(r) for r in rounds}:
        key = out["round"] if out["round"] in prop else str(out["round"])
    elif rounds:
        key = rounds[0]
    if key is not None:
        p = prop[key]
        out["proposal_first_seen_ms"] = p.get("proposal_first_seen_ms")
        out["proposal_origin"] = p.get("proposal_origin")
        out["proposal_hops"] = p.get("proposal_hops")
        out["parts_fanout_s"] = p.get("parts_fanout_s")
    return out


def _ms(ts: Optional[float], t0: Optional[float]) -> Optional[float]:
    if ts is None or t0 is None:
        return None
    return round((ts - t0) * 1e3, 1)


def merge(dumps: List[dict], max_heights: Optional[int] = None) -> dict:
    """Merge per-node dumps into the chain report structure.

    Fleet-scale contract: a dump that failed to load or scrape is
    NEVER silently dropped — it keeps its node row and is named in the
    report's `coverage.missing` list; and only the merge window's height
    records are retained per node, so merging 100 deep dumps holds
    O(nodes × window) milestone state, not O(nodes × chain length)."""
    nodes = []
    per_node_heights: Dict[str, Dict[int, dict]] = {}
    missing: List[str] = []
    for dump in dumps:
        label = _node_label(dump)
        failure = dump.get("load_error") or dump.get("scrape_error")
        recs = {} if failure else _height_records(dump)
        per_node_heights[label] = recs
        slo = dump.get("slo") or {}
        if failure:
            missing.append(label)
        nodes.append(
            {
                "node": label,
                "node_id": dump.get("node_id"),
                "moniker": dump.get("moniker"),
                "heights": len(recs),
                "height_range": (
                    [min(recs), max(recs)] if recs else None
                ),
                "slo_enabled": bool(slo.get("enabled")),
                "slo_any_tripped": bool(slo.get("any_tripped")),
                "load_error": dump.get("load_error"),
                "scrape_error": dump.get("scrape_error"),
            }
        )

    all_heights = sorted({h for recs in per_node_heights.values() for h in recs})
    if max_heights is not None and max_heights > 0:
        all_heights = all_heights[-max_heights:]
    # bound the retained state to the merge window before milestone
    # extraction — out-of-window records are released here
    window = set(all_heights)
    for label in per_node_heights:
        per_node_heights[label] = {
            h: rec for h, rec in per_node_heights[label].items() if h in window
        }

    heights_out = []
    slow_counts: Dict[str, int] = {}
    for h in all_heights:
        per_node = {
            label: _milestones(recs[h])
            for label, recs in per_node_heights.items()
            if h in recs
        }
        # the proposer: named by any receiver's propagation origin, else the
        # node that recorded a proposal but no propagation (its own)
        proposer = None
        for ms in per_node.values():
            if ms["proposal_origin"]:
                proposer = str(ms["proposal_origin"])[:10]
                break
        if proposer is None:
            for label, ms in per_node.items():
                if ms["proposal_ts"] is not None and ms["proposal_first_seen_ms"] is None:
                    proposer = label
                    break
        # creation time: the proposer's own proposal record, else the
        # earliest receipt minus its measured propagation latency, else the
        # earliest receipt
        t0 = None
        if proposer in per_node and per_node[proposer]["proposal_ts"] is not None:
            t0 = per_node[proposer]["proposal_ts"]
        if t0 is None:
            candidates = [
                (
                    ms["proposal_ts"] - (ms["proposal_first_seen_ms"] or 0.0) / 1e3,
                    ms["proposal_ts"],
                )
                for ms in per_node.values()
                if ms["proposal_ts"] is not None
            ]
            if candidates:
                t0 = min(c[0] for c in candidates)
        rows = {}
        receipt_ts = []
        commit_round = None
        for label, ms in per_node.items():
            if ms["round"] is not None:
                commit_round = ms["round"]
            row = {
                "proposal_recv_ms": _ms(ms["proposal_ts"], t0),
                "prevote_quorum_ms": _ms(ms["prevote_quorum_ts"], t0),
                "precommit_quorum_ms": _ms(ms["precommit_quorum_ts"], t0),
                "commit_ms": _ms(ms["commit_ts"], t0),
                "proposal_first_seen_ms": ms["proposal_first_seen_ms"],
                "proposal_hops": ms["proposal_hops"],
                "parts_fanout_s": ms["parts_fanout_s"],
            }
            rows[label] = row
            if label != proposer and ms["proposal_ts"] is not None:
                receipt_ts.append(ms["proposal_ts"])
        # slowest link: the largest consecutive-stage gap over all nodes
        slowest = None
        for label, row in rows.items():
            prev_ms, prev_name = 0.0, "proposal created"
            for key, name in _WATERFALL_STAGES:
                val = row.get(key)
                if val is None:
                    continue
                gap = val - prev_ms
                if slowest is None or gap > slowest["gap_ms"]:
                    slowest = {
                        "node": label,
                        "stage": f"{prev_name} -> {name}",
                        "gap_ms": round(gap, 1),
                    }
                prev_ms, prev_name = val, name
        if slowest is not None:
            slow_counts[slowest["node"]] = slow_counts.get(slowest["node"], 0) + 1
        heights_out.append(
            {
                "height": h,
                "round": commit_round,
                "proposer": proposer,
                "nodes": rows,
                "first_peer_receipt_ms": _ms(min(receipt_ts), t0) if receipt_ts else None,
                "last_peer_receipt_ms": _ms(max(receipt_ts), t0) if receipt_ts else None,
                "slowest_link": slowest,
            }
        )

    # per-peer lag ranking: merge every observer's per-origin aggregates
    lag: Dict[str, dict] = {}
    for dump in dumps:
        tl = dump.get("timeline") or {}
        for origin, st in (tl.get("propagation_peers") or {}).items():
            key = str(origin)[:10]
            ent = lag.setdefault(
                key, {"count": 0, "sum_ms": 0.0, "max_ms": 0.0, "observers": 0}
            )
            # peer_stats entries nest everything under per-kind aggregates
            # (consensus/timeline.py peer_stats): fold them all together
            for k in (st.get("kinds") or {}).values():
                cnt = k.get("count", 0)
                ent["count"] += cnt
                ent["sum_ms"] += k.get("mean_ms", 0.0) * cnt
                ent["max_ms"] = max(ent["max_ms"], k.get("max_ms", 0.0))
            ent["observers"] += 1
    peer_lag = [
        {
            "origin": origin,
            "msgs": ent["count"],
            "mean_ms": round(ent["sum_ms"] / ent["count"], 3) if ent["count"] else 0.0,
            "max_ms": round(ent["max_ms"], 3),
            "observers": ent["observers"],
        }
        for origin, ent in lag.items()
    ]
    peer_lag.sort(key=lambda e: -e["mean_ms"])

    # SLO verdicts
    slo_out = []
    any_tripped = False
    for dump in dumps:
        slo = dump.get("slo") or {}
        if not slo.get("enabled"):
            continue
        label = _node_label(dump)
        if slo.get("any_tripped"):
            any_tripped = True
        for name, obj in (slo.get("objectives") or {}).items():
            slo_out.append(
                {
                    "node": label,
                    "objective": name,
                    "verdict": obj.get("verdict"),
                    "tripped": obj.get("tripped"),
                    "trips_total": obj.get("trips_total"),
                    "breaches": obj.get("breaches"),
                    "observations": obj.get("observations"),
                    "worst_s": obj.get("worst_s"),
                    "burn_fast": (obj.get("burn_rate") or {}).get("fast", {}).get("burn"),
                    "burn_slow": (obj.get("burn_rate") or {}).get("slow", {}).get("burn"),
                }
            )

    # per-node tx lifecycle latency attribution: every node's
    # per-stage percentiles + terminal-outcome counts, so a fleet report
    # names WHICH node's txs stall at WHICH stage
    tx_latency = []
    tx_terminals: Dict[str, dict] = {}
    for dump in dumps:
        tx = dump.get("txtrace") or {}
        label = _node_label(dump)
        for stage, p in sorted((tx.get("stage_percentiles") or {}).items()):
            tx_latency.append(
                {
                    "node": label,
                    "stage": stage,
                    "count": p.get("count"),
                    "p50_ms": p.get("p50_ms"),
                    "p99_ms": p.get("p99_ms"),
                    "max_ms": p.get("max_ms"),
                }
            )
        if tx.get("terminals"):
            tx_terminals[label] = tx["terminals"]

    worst_offender = max(slow_counts.items(), key=lambda kv: kv[1])[0] if slow_counts else None
    return {
        "generated_ts": round(time.time(), 3),
        "coverage": {
            "expected": len(dumps),
            "merged": len(dumps) - len(missing),
            "missing": sorted(missing),
            "partial": bool(missing),
        },
        "nodes": nodes,
        "heights": heights_out,
        "peer_lag": peer_lag,
        "slo": slo_out,
        "slo_any_tripped": any_tripped,
        "slowest_link_counts": slow_counts,
        "worst_offender": worst_offender,
        "tx_latency": tx_latency,
        "tx_terminals": tx_terminals,
    }


# -- rendering ----------------------------------------------------------------


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.1f}"
    return str(v)


def render_markdown(report: dict) -> str:
    lines: List[str] = []
    lines.append("# Chain observatory report")
    lines.append("")
    lines.append(
        f"{len(report['nodes'])} nodes, {len(report['heights'])} heights merged. "
        "Waterfall offsets are milliseconds from proposal creation (each "
        "node's LOCAL clock; propagation latencies inside are skew-corrected)."
    )
    cov = report.get("coverage")
    if cov and cov.get("partial"):
        lines.append("")
        lines.append(
            f"**PARTIAL COVERAGE**: {cov['merged']}/{cov['expected']} dumps "
            f"merged; missing: {', '.join(cov['missing'])}"
        )
    lines.append("")
    lines.append("## Nodes")
    lines.append("")
    lines.append("| node | moniker | heights | range | SLO |")
    lines.append("|---|---|---|---|---|")
    for n in report["nodes"]:
        rng = n["height_range"]
        slo = (
            "TRIPPED" if n["slo_any_tripped"]
            else ("ok" if n["slo_enabled"] else "off")
        )
        lines.append(
            f"| {n['node']} | {_fmt(n['moniker'])} | {n['heights']} | "
            f"{f'{rng[0]}..{rng[1]}' if rng else '—'} | {slo} |"
        )
    lines.append("")
    lines.append("## Per-height waterfall (proposal → commit)")
    for rec in report["heights"]:
        lines.append("")
        lines.append(
            f"### height {rec['height']}"
            + (f" · round {rec['round']}" if rec["round"] is not None else "")
            + (f" · proposer {rec['proposer']}" if rec["proposer"] else "")
        )
        lines.append("")
        lines.append(
            "| node | proposal recv | +2/3 prevote | +2/3 precommit | commit "
            "| first-seen lat (ms) | hops | parts fan-out (s) |"
        )
        lines.append("|---|---|---|---|---|---|---|---|")
        for label in sorted(rec["nodes"]):
            row = rec["nodes"][label]
            lines.append(
                f"| {label} | {_fmt(row['proposal_recv_ms'])} | "
                f"{_fmt(row['prevote_quorum_ms'])} | "
                f"{_fmt(row['precommit_quorum_ms'])} | {_fmt(row['commit_ms'])} | "
                f"{_fmt(row['proposal_first_seen_ms'])} | "
                f"{_fmt(row['proposal_hops'])} | {_fmt(row['parts_fanout_s'])} |"
            )
        extras = []
        if rec["first_peer_receipt_ms"] is not None:
            extras.append(
                f"peer receipt {rec['first_peer_receipt_ms']:.1f}–"
                f"{rec['last_peer_receipt_ms']:.1f} ms"
            )
        sl = rec["slowest_link"]
        if sl is not None:
            extras.append(
                f"slowest link: **{sl['node']}** at {sl['stage']} "
                f"({sl['gap_ms']:.1f} ms)"
            )
        if extras:
            lines.append("")
            lines.append("; ".join(extras))
    lines.append("")
    lines.append("## Per-peer lag ranking (worst origin first)")
    lines.append("")
    if report["peer_lag"]:
        lines.append("| origin | msgs | mean ms | max ms | observers |")
        lines.append("|---|---|---|---|---|")
        for e in report["peer_lag"]:
            lines.append(
                f"| {e['origin']} | {e['msgs']} | {e['mean_ms']:.3f} | "
                f"{e['max_ms']:.3f} | {e['observers']} |"
            )
    else:
        lines.append("no propagation aggregates recorded (tracing off?)")
    if report.get("worst_offender"):
        lines.append("")
        lines.append(
            f"Habitual slowest link: **{report['worst_offender']}** "
            f"({report['slowest_link_counts'][report['worst_offender']]} heights)"
        )
    lines.append("")
    lines.append("## Tx lifecycle latency (per node, per stage)")
    lines.append("")
    if report.get("tx_latency"):
        lines.append("| node | stage | count | p50 ms | p99 ms | max ms |")
        lines.append("|---|---|---|---|---|---|")
        for e in report["tx_latency"]:
            lines.append(
                f"| {e['node']} | {e['stage']} | {_fmt(e['count'])} | "
                f"{_fmt(e['p50_ms'])} | {_fmt(e['p99_ms'])} | "
                f"{_fmt(e['max_ms'])} |"
            )
        for label, terms in sorted((report.get("tx_terminals") or {}).items()):
            pretty = ", ".join(f"{k}={v}" for k, v in sorted(terms.items()))
            lines.append("")
            lines.append(f"{label} terminal outcomes: {pretty}")
    else:
        lines.append("no tx lifecycle data recorded (tracker off or idle)")
    lines.append("")
    lines.append("## SLO verdicts")
    lines.append("")
    if report["slo"]:
        lines.append(
            "| node | objective | verdict | breaches | obs | worst s | "
            "burn fast | burn slow |"
        )
        lines.append("|---|---|---|---|---|---|---|---|")
        for e in report["slo"]:
            lines.append(
                f"| {e['node']} | {e['objective']} | {e['verdict']} | "
                f"{e['breaches']} | {e['observations']} | {_fmt(e['worst_s'])} | "
                f"{_fmt(e['burn_fast'])} | {_fmt(e['burn_slow'])} |"
            )
        lines.append("")
        lines.append(
            "**ANY GUARD TRIPPED**" if report["slo_any_tripped"]
            else "All declared budgets held."
        )
    else:
        lines.append("no SLO engine enabled on any node")
    lines.append("")
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--nodes", help="comma-separated RPC base URLs to scrape live"
    )
    src.add_argument(
        "--dumps", help=f"directory of {DUMP_PREFIX}*.json offline dumps"
    )
    ap.add_argument(
        "--out", default="./observatory",
        help="output directory for chain_report.{json,md} (default ./observatory)",
    )
    ap.add_argument(
        "--heights", type=int, default=20,
        help="most recent heights to merge (0 = all; default 20)",
    )
    ap.add_argument(
        "--check", action="store_true",
        help="exit 2 when any node's SLO guard tripped",
    )
    ap.add_argument(
        "--timeout", type=float, default=5.0,
        help="per-endpoint scrape timeout in seconds (default 5)",
    )
    ap.add_argument(
        "--concurrency", type=int, default=16,
        help="concurrent node scrapes (default 16)",
    )
    args = ap.parse_args(argv)

    if args.nodes:
        import asyncio

        urls = [u.strip() for u in args.nodes.split(",") if u.strip()]
        dumps = asyncio.run(
            scrape_fleet(urls, timeout=args.timeout, concurrency=args.concurrency)
        )
    else:
        dumps = load_dumps(args.dumps)
        if not dumps:
            print(f"no {DUMP_PREFIX}*.json dumps under {args.dumps}")
            return 1

    report = merge(dumps, max_heights=args.heights or None)
    md = render_markdown(report)
    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "chain_report.json")
    md_path = os.path.join(args.out, "chain_report.md")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=1, default=repr)
    with open(md_path, "w") as f:
        f.write(md)
    print(md)
    print(f"\nwrote {json_path} and {md_path}")
    if args.check and report["slo_any_tripped"]:
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
