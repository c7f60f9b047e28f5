"""Offline WAL post-mortem inspector: the port's copy of
tendermint_tpu/tools/wal_inspect.py, on the port's consensus WAL.

Replays a consensus WAL (consensus/wal.py framing) into the SAME
per-height/round timeline the live node serves at
`GET /debug/consensus_timeline` (consensus/timeline.py), entirely offline
and strictly read-only — the ONLY WAL consumer that must never append an
EndHeight(0) anchor to the artifact it is examining (hence
wal.iter_wal_messages, not the WAL class).

WAL frames carry no wall-clock timestamps; time is reconstructed from the
SIGNED timestamps embedded in votes and proposals (Vote.timestamp_ns /
Proposal.timestamp_ns — the only clocks that survive a crash). Every
timeline entry is stamped with the most recent such timestamp, so step
durations are vote-arrival-granular approximations: exact enough to answer
"which step did height H sit in for 30 s" and "how many rounds did it
burn", which is what a post-mortem of a crashed or slow node needs.

Report contents (`inspect_wal`):
- per-height timeline records (heights/rounds/steps, identical shape to
  /debug/consensus_timeline) — the cross-check the integration test runs;
- per-step duration summary (count/total/max seconds);
- round escalations: heights that needed round > 0;
- aggregate vote-arrival histogram (offset from round start, ms buckets);
- EndHeight gaps: heights whose completion marker never made it to disk —
  the crash frontier;
- message counts by type, timeout counts by step.

CLI: `python -m tendermint_tpu_torch.cli wal-inspect [--wal PATH]` or the
standalone `tools/wal_inspect.py PATH`.
"""

from __future__ import annotations

from typing import List, Optional

from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
)
from tendermint_tpu_torch.consensus.round_state import RoundStepType
from tendermint_tpu_torch.consensus.timeline import (
    VOTE_ARRIVAL_BUCKETS_MS,
    ConsensusTimeline,
)
from tendermint_tpu_torch.consensus.wal import (
    EndHeightMessage,
    EventRoundState,
    MsgInfo,
    TimeoutInfo,
    iter_wal_messages,
)


def _step_name(step: int) -> str:
    try:
        return RoundStepType(step).name
    except ValueError:
        return f"STEP_{step}"


def _scan(path: str, max_heights: int = 0):
    """ONE decode pass over a WAL group (crashed-node groups can be many
    rotated files — don't read/CRC/decode them twice): feeds the timeline
    AND accumulates the count aggregates. Returns
    (timeline, msg_counts, timeout_steps, end_heights)."""
    tl = ConsensusTimeline(max_heights or 1_000_000)
    cur_ts: Optional[float] = None  # last signed timestamp seen, seconds
    msg_counts: dict = {}
    timeout_steps: dict = {}
    end_heights = set()
    for msg in iter_wal_messages(path):
        if isinstance(msg, EventRoundState):
            name = "EventRoundState"
            tl.record_step(msg.height, msg.round, _step_name(msg.step), ts=cur_ts)
        elif isinstance(msg, EndHeightMessage):
            name = "EndHeightMessage"
            end_heights.add(msg.height)
            if msg.height > 0:  # height 0 is the fresh-WAL anchor, not a height
                tl.record_end_height(msg.height, ts=cur_ts)
        elif isinstance(msg, TimeoutInfo):
            name = "TimeoutInfo"
            step = _step_name(msg.step)
            timeout_steps[step] = timeout_steps.get(step, 0) + 1
        elif isinstance(msg, MsgInfo):
            m = msg.msg
            name = type(m).__name__
            if isinstance(m, VoteMessage):
                cur_ts = m.vote.timestamp_ns / 1e9
                tl.record_vote(m.vote.height, m.vote.round, m.vote.type.name, ts=cur_ts)
            elif isinstance(m, ProposalMessage):
                cur_ts = m.proposal.timestamp_ns / 1e9
                tl.record_proposal(m.proposal.height, m.proposal.round, ts=cur_ts)
        else:
            name = type(msg).__name__
        msg_counts[name] = msg_counts.get(name, 0) + 1
    return tl, msg_counts, timeout_steps, end_heights


def build_timeline(path: str, max_heights: int = 0) -> ConsensusTimeline:
    """Replay one WAL group into a ConsensusTimeline. max_heights=0 keeps
    every height found (post-mortems want the full history)."""
    return _scan(path, max_heights)[0]


def inspect_wal(path: str, limit: Optional[int] = None) -> dict:
    """Full post-mortem report for one WAL group (see module docstring)."""
    tl, msg_counts, timeout_steps, end_heights = _scan(path)
    heights = tl.dump(limit)

    step_durations: dict = {}
    escalated: List[dict] = []
    arrival = [0] * (len(VOTE_ARRIVAL_BUCKETS_MS) + 1)
    for rec in heights:
        for st in rec["steps"]:
            dur = st.get("dur_s")
            if dur is None:
                continue
            agg = step_durations.setdefault(
                st["step"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] = round(agg["total_s"] + dur, 6)
            agg["max_s"] = max(agg["max_s"], dur)
        if rec["round_count"] > 1:
            escalated.append(
                {"height": rec["height"], "rounds": rec["round_count"]}
            )
        for votes in rec["votes"].values():
            for i, n in enumerate(votes["arrival_ms"]):
                arrival[i] += n

    # EndHeight gaps: completed heights per the timeline that never got
    # their durable marker — everything at/after the first gap replays on
    # restart; the LAST height is expected to be open (the crash frontier)
    seen = [r["height"] for r in heights]
    frontier = max(seen) if seen else None
    gaps = [h for h in seen if h not in end_heights and h != frontier]
    return {
        "wal": path,
        "messages": msg_counts,
        "timeouts_by_step": timeout_steps,
        "height_range": [min(seen), max(seen)] if seen else None,
        "heights_seen": len(seen),
        "end_height_markers": len(end_heights),
        "end_height_gaps": gaps,
        "round_escalations": escalated,
        "step_durations": step_durations,
        "vote_arrival_ms_buckets": list(VOTE_ARRIVAL_BUCKETS_MS) + ["+Inf"],
        "vote_arrival_counts": arrival,
        "heights": heights,
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("wal", help="path to the WAL head file (rotated .NNN siblings are included)")
    p.add_argument("--limit", type=int, default=None, help="only the most recent N heights")
    args = p.parse_args(argv)
    print(json.dumps(inspect_wal(args.wal, limit=args.limit), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
