"""Device busy time of the tampered 10k verify_batch call, profiled on two or
more trees of this repository in alternation, in one session.

Run from the repository root on a machine with a CUDA card and nvcc, as a
file (each tree's package is imported in a subprocess of its own):

    python3 tendermint_tpu_torch/tools/busy_ab.py --trees OLD,NEW [--json FILE]

OLD and NEW are roots of checkouts: e.g. the parent commit unpacked by
`git archive` into a gitignored directory, and `.`. The first subprocess
signs 10,000 Ed25519 rows (32-byte seeds and 110-byte messages from numpy
seed 7) with its tree's ed25519_ref and saves them beside this file's
package build; every subprocess loads them, verifies them once on the card
(this builds the kernels and fills the A cache) and twice more, flips the
signatures of rows 17, 4,242 and 9,999 (chip_smoke.py's tampered rows),
checks the exact mask, then profiles PROFILED tampered calls under
torch.profiler: device busy = the sum of the kernels' device time (one
stream, so kernels do not overlap). ROUNDS rounds run the trees in order,
then in reverse (OLD, NEW, NEW, OLD). Prints a line per reading, each
tree's median busy, the card's name and power limit, and last one JSON
object (also written to --json). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

N_ROWS = 10_000
MSG_BYTES = 110
TAMPERED = (17, 4242, 9_999)
ROUNDS, PROFILED = 2, 3
HERE = os.path.abspath(__file__)
WORK = os.path.join(os.path.dirname(os.path.dirname(HERE)), "_build")


def _sign_rows(rows):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    out = []
    for seed, msg in rows:
        a, prefix = ref.secret_expand(seed)
        pk = ref.point_compress(ref.point_mul(a, ref.BASE))
        r = ref.sha512_mod_l(prefix + msg)
        r_enc = ref.point_compress(ref.point_mul(r, ref.BASE))
        h = ref.sha512_mod_l(r_enc + pk + msg)
        out.append((pk, r_enc + ((r + h * a) % ref.L).to_bytes(32, "little")))
    return out


def corpus(path: str):
    """(pubkeys, msgs, sigs), signed once and saved to `path`."""
    import numpy as np

    if not os.path.exists(path):
        import multiprocessing as mp

        rng = np.random.default_rng(7)
        seeds = [rng.bytes(32) for _ in range(N_ROWS)]
        msgs = [rng.bytes(MSG_BYTES) for _ in range(N_ROWS)]
        workers = os.cpu_count() or 1
        jobs = list(zip(seeds, msgs))
        with mp.get_context("fork").Pool(workers) as pool:
            parts = pool.map(_sign_rows, [jobs[i::workers] for i in range(workers)])
        signed = [None] * N_ROWS
        for i, part in enumerate(parts):
            signed[i::workers] = part
        np.savez(path, pk=np.frombuffer(b"".join(p for p, _ in signed), np.uint8),
                 msg=np.frombuffer(b"".join(msgs), np.uint8),
                 sig=np.frombuffer(b"".join(s for _, s in signed), np.uint8))
    z = np.load(path)
    rows = lambda a, w: [a[i * w:(i + 1) * w].tobytes() for i in range(N_ROWS)]  # noqa: E731
    return rows(z["pk"], 32), rows(z["msg"], MSG_BYTES), rows(z["sig"], 64)


def child(tree: str, corpus_path: str) -> dict:
    """One tree: load its package, check the tampered mask, profile."""
    import importlib.util

    # the device-record filter is this checkout's, so every tree is read alike
    spec = importlib.util.spec_from_file_location(
        "_busy_ab_profiler", os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                          "libs", "profiler.py"))
    profiler = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiler)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tendermint_tpu_torch
    from tendermint_tpu_torch.crypto import batch

    if not os.path.abspath(tendermint_tpu_torch.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"busy_ab: imported {tendermint_tpu_torch.__file__}, not {tree}'s package")
    pubkeys, msgs, sigs = corpus(corpus_path)
    dev = torch.device("cuda")
    for _ in range(3):
        if not batch.verify_batch(pubkeys, msgs, sigs, device=dev).all():
            raise SystemExit("busy_ab: an honest row was rejected")
    bad_sigs = list(sigs)
    for i in TAMPERED:
        s = bytearray(bad_sigs[i])
        s[40] ^= 1
        bad_sigs[i] = bytes(s)
    mask = batch.verify_batch(pubkeys, msgs, bad_sigs, device=dev)
    if tuple(int(i) for i in np.flatnonzero(~mask)) != TAMPERED:
        raise SystemExit(f"busy_ab: tampered mask wrong: False at {np.flatnonzero(~mask)}")
    busy, kernels, top = [], [], {}
    for _ in range(PROFILED):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            batch.verify_batch(pubkeys, msgs, bad_sigs, device=dev)
            torch.cuda.synchronize()
        rows = profiler.device_rows(prof)
        busy.append(sum(e.self_device_time_total for e in rows) / 1e3)
        kernels.append(sum(e.count for e in rows))
        top = {e.key: [round(e.self_device_time_total / 1e3, 4), e.count]
               for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]}
    if min(busy) <= 0:
        raise SystemExit("busy_ab: the profiler recorded no device time")
    return {"tree": tree, "busy_ms": busy, "kernels": kernels, "top": top}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", help="comma-separated checkout roots, e.g. OLD,.")
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--corpus", default=os.path.join(WORK, "busy_ab_corpus.npz"))
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.corpus)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("busy_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(args.corpus), exist_ok=True)
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    order = [t for r in range(ROUNDS) for t in (trees if r % 2 == 0 else trees[::-1])]
    readings = []
    for tree in order:
        res = subprocess.run([sys.executable, HERE, "--child", tree, "--corpus", args.corpus],
                             cwd=tree, capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            raise SystemExit(f"busy_ab: {tree} failed:\n{res.stdout[-4000:]}{res.stderr[-4000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        readings.append(got)
        print(f"busy {tree}: device_busy_ms={[round(b, 3) for b in got['busy_ms']]} "
              f"kernels={got['kernels']}", flush=True)
        for name, (ms, n) in got["top"].items():
            print(f"busy {tree}:   {ms:8.3f} ms x{n:<5d} {name[:90]}", flush=True)
    medians = {t: statistics.median(b for r in readings if r["tree"] == t for b in r["busy_ms"])
               for t in trees}
    for t, m in medians.items():
        print(f"busy median {t}: {m:.3f} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "median_busy_ms": medians, "readings": readings}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
