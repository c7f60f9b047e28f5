"""chip_smoke.py's scheduler_mixed phase under a short scheduler
`wait_timeout`, on two or more trees of this repository, in one session.

Run from the repository root on a machine with a CUDA card and nvcc, as a
file (each tree runs in a subprocess of its own, from its root):

    python3 tendermint_tpu_torch/tools/mixed_ab.py --trees OLD,NEW \
        [--timeout 12] [--rounds 2] [--json FILE]

OLD and NEW are roots of checkouts: e.g. the parent commit unpacked by
`git archive` into a gitignored directory, and `.`. Each subprocess imports
its tree's chip_smoke.py, builds the 10k commit, light and catch-up corpora
and the kernels, runs catchup, scheduler_lanes and light_serve (they fill
the numbers scheduler_mixed prints beside its own), then ROUNDS scheduler_mixed
phases with each phase's scheduler given `wait_timeout` TIMEOUT seconds (the
default 30 s leaves a fast host a wide margin; a short one makes the catch-up
tickets meet it). Per round: whether the phase passed (its message if not),
the tickets that met the timeout inside a running flush and the inline
fallbacks (the scheduler's own warnings), and the seconds. Prints each
tree's scheduler_mixed lines, a line per round, the card's name and power
limit, and last one JSON object (also written to --json). Exits 2 without
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.abspath(__file__)


def worker(timeout: float, rounds: int) -> None:
    """One tree, from its root (the working directory)."""
    import contextlib
    import logging
    import time
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as C

    warnings = []

    class Tap(logging.Handler):
        def emit(self, rec):
            warnings.append(rec.getMessage())

    logging.getLogger("tendermint_tpu_torch.crypto.scheduler").addHandler(Tap())
    installed = C.installed_scheduler

    @contextlib.contextmanager
    def short(dev):
        with installed(dev) as sched:
            sched.wait_timeout = timeout
            yield sched

    corpus = C.build_commit(np.random.default_rng(C.SEED + 1))
    light = C.build_light(np.random.default_rng(C.SEED + 10))
    catchup = C.build_catchup(np.random.default_rng(C.SEED + 11))
    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(fn) for fn in (cuda_fe.build, cuda_msm.build, cuda_bls.build,
                                           native._lib)]:
            f.result()
    batch.configure_verified_memo(0)  # as chip_smoke.py times every phase
    launches: dict = {}
    C.catchup_phase(dev, catchup, launches)  # scheduler_lanes holds its launches to these
    C.scheduler_lanes_phase(dev, corpus, catchup, light, launches)
    C.light_serve_phase(dev, light, launches)
    C.installed_scheduler = short
    out = []
    for i in range(rounds):
        warnings.clear()
        t0 = time.perf_counter()
        try:
            C.scheduler_mixed_phase(dev, corpus, catchup, light, launches)
            result = "passed"
        except SystemExit as e:
            result = f"failed: {e}"
        out.append({"round": i, "result": result,
                    "in_flight_waits": sum("running flush" in w for w in warnings),
                    "inline_fallbacks": sum("missed the" in w for w in warnings),
                    "seconds": round(time.perf_counter() - t0, 1)})
    print("ROUNDS " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", required=True)
    ap.add_argument("--timeout", type=float, default=12.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.timeout, args.rounds)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("mixed_ab: no CUDA device", file=sys.stderr)
        return 2
    result = {"timeout_s": args.timeout, "trees": {}}
    for tree in args.trees.split(","):
        root = os.path.abspath(tree)
        p = subprocess.run([sys.executable, HERE, "--worker", "--trees", tree, "--timeout",
                            str(args.timeout), "--rounds", str(args.rounds)], cwd=root,
                           capture_output=True, text=True)
        rounds = [json.loads(line[len("ROUNDS "):]) for line in p.stdout.splitlines()
                  if line.startswith("ROUNDS ")]
        if p.returncode or not rounds:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"mixed_ab: the subprocess of {tree} exited {p.returncode}")
        result["trees"][tree] = rounds[0]
        for line in p.stdout.splitlines():
            if line.startswith("scheduler_mixed"):
                print(f"{tree}: {line[:1500]}", flush=True)
        for r in rounds[0]:
            print(f"{tree} round {r['round']}: {r['result']}; in-flight waits "
                  f"{r['in_flight_waits']}, inline fallbacks {r['inline_fallbacks']}; "
                  f"{r['seconds']} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    result["card"] = card.strip().splitlines()[0] if card.strip() else "not measured"
    print(result["card"], flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
