"""What the 7-node fleet smoke costs with every node's `device` the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.fleet_probe [--runs SPEC,...] [--json FILE]

Each run is `lock` or `free` (whether every device round trip of
crypto/batch.py holds one process-wide lock, `one_launcher`), the round
clock's scale (chaos/fleet.FleetHarness `timeout_scale`, which stretches the
SLO budgets with it), the height gate and the stall deadline (s), written
`free:1:4:90` (the default runs: `free:1:4:90,lock:10:4:240`). Each run is
chaos/fleet.run_fleet_soak on the reference's tier-1 smoke spec
(tests/test_fleet_soak.py `_smoke_spec`, seed 20260807: 4 Ed25519
validators, one of them the poisoner; a resident full node; a blocksync
joiner; a light edge; partition, peer_stall, sig_poison) with every node's
`device` the card. The fleet's nodes share one process: their event loop's
vote flushes, their scheduler lanes' dispatch threads and their prewarm
threads all launch, and each launch of the ctypes-bound kernels releases
and retakes the GIL, so the threads convoy. Every 10 s a run prints the
nodes' committed heights and (height, round, step), its card flushes and
their ms so far; at the end its outcome (verdict and heights, or the stall),
its card flushes by rows, its device round trips and lock waits, and the
launches of the six Ed25519 kernels. Prints the card's name and power limit,
and last one JSON object (also written to --json). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time

FLEET_SEED, FLEET_NODES = 20260807, 7
SMOKE_KW = dict(validator_frac=0.58, light_frac=0.15, joiner_frac=0.5, bls_validators=0,
                statesync_joiners=0, poisoners=1, peer_degree=3, episodes=2, min_gap=0.5,
                max_gap=1.0, min_episode=0.8, max_episode=1.5, start_delay=0.5,
                join_window=(2.0, 4.0), chaos_kinds=("partition", "peer_stall", "sig_poison"))
DEFAULT_RUNS = "free:1:4:90,lock:10:4:240"


@contextlib.contextmanager
def one_launcher():
    """Inside the block every device round trip of crypto/batch.py (its
    `_on_device` sites: rlc_submit, rlc_finish, persig) holds one
    process-wide lock, so no two threads launch at once. Yields the lock
    waits (s)."""
    from tendermint_tpu_torch.crypto import batch

    lock, real, waits = threading.RLock(), batch._on_device, []

    @contextlib.contextmanager
    def on_device(site, sync=False):
        t0 = time.perf_counter()
        with lock:
            waits.append(time.perf_counter() - t0)
            with real(site, sync):
                yield

    batch._on_device = on_device
    try:
        yield waits
    finally:
        batch._on_device = real


@contextlib.contextmanager
def recorded_flushes():
    """Every verify_batch inside the block, as crypto/batch.py and its
    importers call it: (rows, route, ms)."""
    from tendermint_tpu_torch.blocksync import verify as bs_verify
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types import validator_set, vote_set

    users = (batch, vote_set, validator_set, bs_verify)
    real = [m.verify_batch for m in users]
    seen = []

    def wrap(fn):
        def vb(*a, **kw):
            t0 = time.perf_counter()
            mask = fn(*a, **kw)
            seen.append((len(a[0]), batch.LAST_FLUSH.get("path"),
                         (time.perf_counter() - t0) * 1e3))
            return mask
        return vb

    for m, fn in zip(users, real):
        m.verify_batch = wrap(fn)
    try:
        yield seen
    finally:
        for m, fn in zip(users, real):
            m.verify_batch = fn


def run(dev, lock: bool, scale: float, min_heights: int, deadline: float) -> dict:
    from tendermint_tpu_torch.chaos import fleet
    from tendermint_tpu_torch.crypto import provenance
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    spec = fleet.FleetSpec.generate(FLEET_SEED, FLEET_NODES, **SMOKE_KW)
    nets, root = [], tempfile.mkdtemp(prefix="fleet_probe-")
    real_init, real_harness = fleet.FleetNet.__init__, fleet.FleetHarness.__init__

    def net_init(self, *a, **kw):
        real_init(self, *a, **kw)
        nets.append(self)

    def harness_init(self, spec_, root_dir, **kw):
        kw.setdefault("timeout_scale", scale)
        real_harness(self, spec_, root_dir, **kw)

    provenance.default_scorer().reset()
    cuda_fe.reset_launches()
    cuda_msm.reset_launches()
    fleet.FleetNet.__init__, fleet.FleetHarness.__init__ = net_init, harness_init
    stop, t0 = threading.Event(), time.perf_counter()
    out = {"lock": lock, "timeout_scale": scale, "min_heights": min_heights,
           "deadline_s": deadline}
    try:
        with recorded_flushes() as flushes, \
                (one_launcher() if lock else contextlib.nullcontext([])) as waits:

            def monitor():
                while not stop.wait(10.0):
                    nodes = [None if n is None else
                             (n.block_store.height, n.consensus.rs.height,
                              n.consensus.rs.round, str(n.consensus.rs.step).rsplit(".", 1)[-1])
                             for net in nets for n in net.nodes]
                    card = [f for f in flushes if f[1] not in ("cpu", "memo")]
                    print(f"[{time.perf_counter() - t0:.0f} s] nodes {nodes}; card flushes "
                          f"{len(card)}, {sum(f[2] for f in card):.0f} ms", flush=True)

            threading.Thread(target=monitor, daemon=True).start()
            try:
                res = asyncio.run(fleet.run_fleet_soak(spec, root, min_heights=min_heights,
                                                       deadline_s=deadline, device=dev))
                out.update(outcome=res["verdict"], heights=res["heights"],
                           joiner=list(res["joiners"].values())[0]["height"])
            except RuntimeError as e:
                out.update(outcome="stalled", error=str(e)[:300])
    finally:
        stop.set()
        fleet.FleetNet.__init__, fleet.FleetHarness.__init__ = real_init, real_harness
        shutil.rmtree(root, ignore_errors=True)
    card = [f for f in flushes if f[1] not in ("cpu", "memo")]
    by_rows = {}
    for rows, _, ms in card:
        by_rows.setdefault(rows, []).append(ms)
    out.update(
        seconds=round(time.perf_counter() - t0, 1), card_flushes=len(card),
        card_ms=round(sum(f[2] for f in card), 1),
        card_flush_ms_by_rows={r: [len(v), round(sorted(v)[len(v) // 2], 1)]
                               for r, v in sorted(by_rows.items())},
        memo_or_host=len(flushes) - len(card), round_trips=len(waits),
        lock_wait_s=round(sum(waits), 1),
        launches={**cuda_fe.LAUNCHES, **cuda_msm.LAUNCHES})
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default=DEFAULT_RUNS,
                    help=f"lock|free:timeout_scale:min_heights:deadline_s,... ({DEFAULT_RUNS})")
    ap.add_argument("--json", help="write the results here too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fleet_probe: no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(fn) for fn in (cuda_fe.build, cuda_msm.build, cuda_bls.build,
                                           native._lib)]:
            f.result()
    batch.configure_verified_memo(0)  # the fleet's nodes set their own memo
    results = []
    for spec in args.runs.split(","):
        mode, scale, heights, deadline = spec.split(":")
        print(f"=== {spec}", flush=True)
        results.append(run(dev, mode == "lock", float(scale), int(heights), float(deadline)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    doc = {"card": card, "runs": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
    print(card, flush=True)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
