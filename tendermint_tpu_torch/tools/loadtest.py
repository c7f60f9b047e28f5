"""Transaction load generator driving live consensus over RPC: the port's
copy of tendermint_tpu/tools/loadtest.py.

The reference ships no in-tree load tool — its README points at the
external tm-load-test harness (reference: README.md:153-155), which spawns
websocket/HTTP clients that spam transactions at a running network and
report send/commit throughput. This is the in-tree equivalent: N asyncio
workers per endpoint push unique transactions at a target aggregate rate
through `broadcast_tx_async`/`broadcast_tx_sync`, while the chain's block
stream is sampled before and after to count what actually COMMITTED —
send-side acceptance alone (what a naive load tool reports) says nothing
about consensus keeping up.

Output: one dict/JSON with send-side stats (sent, errors, achieved rate,
RPC latency percentiles) and chain-side stats (blocks, committed txs,
committed tx/s, blocks/s) over the run window. When the target node serves
/metrics (instrumentation.prometheus = true), `chain_metrics` adds the
consensus-side view of the SAME window scraped as exposition deltas:
`block_interval_avg_s` and per-step `step_duration_avg_s` — RPC latency
percentiles say how fast the node answers, these say where consensus spent
the time; `chain_metrics` is null when /metrics is unavailable.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.rpc.client import HTTPClient


@dataclass
class LoadStats:
    sent: int = 0
    errors: int = 0
    rejected: int = 0  # CheckTx code != 0 (sync method only)
    latencies_ms: List[float] = field(default_factory=list)


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(q * (len(xs) - 1)))
    return xs[i]


def _hist_sums(families: dict, name: str) -> dict:
    """{label_key: (count, sum)} for one histogram family in a
    parse_exposition result."""
    fam = families.get(name)
    out: dict = {}
    if fam is None:
        return out
    for sample_name, labels, value in fam["samples"]:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        cnt, tot = out.get(key, (0.0, 0.0))
        if sample_name.endswith("_count"):
            cnt = value
        elif sample_name.endswith("_sum"):
            tot = value
        else:
            continue
        out[key] = (cnt, tot)
    return out


def _chain_metrics_delta(text0: Optional[str], text1: Optional[str]) -> Optional[dict]:
    """Consensus-side summary of the load window from two /metrics scrapes:
    average block interval and per-step durations over the DELTA (counts and
    sums are monotonic, so before/after subtraction isolates the window)."""
    if not text0 or not text1:
        return None
    try:
        return _chain_metrics_delta_strict(text0, text1)
    except Exception:
        # the degrade contract: a foreign/unparseable exposition (another
        # node implementation, a proxy error page) must not cost the report
        return None


def _chain_metrics_delta_strict(text0: str, text1: str) -> dict:
    from tendermint_tpu_torch.libs.metrics import parse_exposition

    fams0, fams1 = parse_exposition(text0), parse_exposition(text1)

    def avg_delta(name: str) -> dict:
        h0, h1 = _hist_sums(fams0, name), _hist_sums(fams1, name)
        out = {}
        for key, (c1, s1) in h1.items():
            c0, s0 = h0.get(key, (0.0, 0.0))
            dc, ds = c1 - c0, s1 - s0
            label = ",".join(f"{k}={v}" for k, v in key) or "_"
            out[label] = {
                "observations": int(dc),
                "avg_s": round(ds / dc, 6) if dc > 0 else None,
            }
        return out

    interval = avg_delta("tendermint_consensus_block_interval_seconds").get("_")
    return {
        "block_interval_avg_s": interval["avg_s"] if interval else None,
        "block_intervals_observed": interval["observations"] if interval else 0,
        "step_duration_avg_s": {
            label.partition("=")[2]: v["avg_s"]
            for label, v in avg_delta(
                "tendermint_consensus_step_duration_seconds"
            ).items()
            if label.startswith("step=")
        },
    }


async def _worker(
    client: HTTPClient,
    stats: LoadStats,
    stop_at: float,
    interval: float,
    tx_size: int,
    method: str,
    tag: bytes,
    priv=None,
) -> None:
    """One connection: sends at 1/interval tx/s until stop_at. Each tx is
    unique (tag + counter + random pad) so the mempool cache never dedups
    the load away. With `priv` set (--signed), every tx is a signed-tx
    envelope (types/signed_tx.py) under this worker's key — the workload
    that exercises the node's device-batched CheckTx admission lane against
    an app like signed_kvstore."""
    if priv is not None:
        from tendermint_tpu_torch.types.signed_tx import encode_signed_tx
    i = 0
    next_send = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now >= stop_at:
            return
        if now < next_send:
            await asyncio.sleep(min(next_send - now, stop_at - now))
            continue
        next_send += interval
        # unique regardless of tx_size: an 8-byte nonce rides every tx (the
        # counter alone would repeat across runs and the mempool cache would
        # dedup run 2 to zero committed); pad with random to the target size
        body = tag + b"=%d;" % i + os.urandom(8)
        tx = body + os.urandom(max(0, tx_size - len(body)))
        if priv is not None:
            tx = encode_signed_tx(priv, tx)
        i += 1
        t0 = time.perf_counter()
        try:
            if method == "sync":
                res = await client.broadcast_tx_sync(tx)
                if int(res.get("code", 0)) != 0:
                    stats.rejected += 1
                    continue
            else:
                await client.broadcast_tx_async(tx)
            stats.sent += 1
            stats.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception:
            stats.errors += 1


async def run_load(
    endpoints: List[str],
    rate: float = 200.0,
    duration: float = 10.0,
    connections: int = 2,
    tx_size: int = 64,
    method: str = "async",
    settle: float = 2.0,
    signed: bool = False,
) -> dict:
    """Drive `rate` tx/s aggregate across endpoints for `duration` seconds,
    then wait `settle` seconds and count committed txs by scanning the
    blocks produced in the window."""
    if method not in ("async", "sync"):
        raise ValueError(f"method must be 'async' or 'sync', not {method!r}")
    if not endpoints:
        raise ValueError("no RPC endpoints given")
    # Per-RUN nonce in every worker tag: the committed-tx scan matches this
    # exact prefix, so txs from a concurrent or stale load run (which also
    # start with b"load-") are never attributed to this one.
    run_id = os.urandom(4).hex().encode()
    clients = [HTTPClient(ep) for ep in endpoints]
    try:
        status0 = await clients[0].status()
        h0 = int(status0["sync_info"]["latest_block_height"])
        metrics0 = await clients[0].metrics_text()  # None when not served

        n_workers = max(1, connections) * len(clients)
        interval = n_workers / max(rate, 0.001)
        stop_at = time.perf_counter() + duration
        stats = [LoadStats() for _ in range(n_workers)]
        tasks = []
        w = 0
        privs = []
        if signed:
            from tendermint_tpu_torch.crypto.keys import gen_ed25519

            privs = [gen_ed25519() for _ in range(n_workers)]
        for c in clients:
            for _ in range(max(1, connections)):
                tasks.append(
                    asyncio.ensure_future(
                        _worker(
                            c, stats[w], stop_at, interval, tx_size, method,
                            b"load-%s-%d" % (run_id, w),
                            priv=privs[w] if signed else None,
                        )
                    )
                )
                w += 1
        t0 = time.perf_counter()
        await asyncio.gather(*tasks)
        send_wall = time.perf_counter() - t0
        if settle > 0:
            await asyncio.sleep(settle)

        status1 = await clients[0].status()
        h1 = int(status1["sync_info"]["latest_block_height"])
        metrics1 = await clients[0].metrics_text()
        # count only OUR txs (unique "load-<runid>-<n>=" prefix): background
        # traffic AND other load runs' txs must not inflate the committed
        # numbers. Blocks fetched concurrently in chunks (serial per-height
        # awaits add one RTT per block to the report time).
        import base64

        run_prefix = b"load-%s-" % run_id
        committed = 0
        heights = list(range(h0 + 1, h1 + 1))
        if signed:
            from tendermint_tpu_torch.types.signed_tx import decode_signed_tx
        for c0 in range(0, len(heights), 32):
            blocks = await asyncio.gather(
                *(clients[0].block(height=h) for h in heights[c0 : c0 + 32])
            )
            for blk in blocks:
                for tx_b64 in blk["block"]["data"]["txs"]:
                    raw = base64.b64decode(tx_b64)
                    if signed:
                        env = decode_signed_tx(raw)
                        raw = env.payload if env is not None else raw
                    if raw.startswith(run_prefix):
                        committed += 1

        sent = sum(s.sent for s in stats)
        lats = [x for s in stats for x in s.latencies_ms]
        return {
            "run_id": run_id.decode(),
            "endpoints": len(endpoints),
            "connections_per_endpoint": max(1, connections),
            "method": method,
            "tx_size": tx_size,
            "signed": signed,
            "target_rate": rate,
            "duration_s": round(send_wall, 2),
            "sent": sent,
            "errors": sum(s.errors for s in stats),
            "rejected": sum(s.rejected for s in stats),
            "send_rate_tx_s": round(sent / send_wall, 1) if send_wall else 0.0,
            "rpc_latency_ms_p50": round(_percentile(lats, 0.50), 2),
            "rpc_latency_ms_p95": round(_percentile(lats, 0.95), 2),
            "blocks": h1 - h0,
            "blocks_per_sec": round((h1 - h0) / (send_wall + settle), 2),
            "committed_txs": committed,
            "committed_tx_s": round(committed / (send_wall + settle), 1),
            "chain_metrics": _chain_metrics_delta(metrics0, metrics1),
        }
    finally:
        for c in clients:
            try:
                await c.close()
            except Exception:
                pass
