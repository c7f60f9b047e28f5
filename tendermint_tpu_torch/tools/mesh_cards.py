"""The sharded mesh over several cards: chip_smoke.py's several-card arm
(`mesh_auto_arm`) and the wrappers' device-guard test, on a machine with two
cards or more.

Run from the repository root, as a file (it imports chip_smoke.py from the
root):

    python3 tendermint_tpu_torch/tools/mesh_cards.py [--json FILE]

It signs chip_smoke.py's 10,000-validator commit corpus on a fork pool
before the card is touched, takes the host arm's masks of the clean rows and
of the rows with row MESH_TAMPERED flipped on the same pool, builds the
kernels, verifies the clean rows on one card (TMTPU_SHARDED=0), then runs
`mesh_auto_arm` twice with TMTPU_SHARDED=auto (the "auto" mesh over the
distinct healthy cards: the clean rows, the tampered rows, the rows tiled
MESH_STREAM_TILES times, each mask held to the host arm's; the second pass's
times are the warm ones), and last tests/test_torch_device_guard.py in a
process of its own. Prints each call's ms, path and launch counts, the
cards' names and power limits, and last one JSON object (also written to
--json). Exits 2 with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_cards: needs two CUDA cards or more", file=sys.stderr)
        return 2
    t00 = time.perf_counter()
    corpus = C.build_commit(np.random.default_rng(C.SEED + 1))
    workers = os.cpu_count() or 1
    pool = mp.get_context("fork").Pool(workers)
    try:
        vals, _, commit, msgs = corpus
        pks = [v.pub_key.bytes() for v in vals.validators]
        sigs = [cs.signature for cs in commit.signatures]
        bad = list(sigs)
        bad[C.MESH_TAMPERED] = C.flip(bad[C.MESH_TAMPERED])

        def host_mask(s):
            part = C.pool_map(pool, C._host_masks, [
                (pks[lo:lo + C.DRAIN], msgs[lo:lo + C.DRAIN], s[lo:lo + C.DRAIN],
                 ["ed25519"] * len(pks[lo:lo + C.DRAIN])) for lo in range(0, len(pks), C.DRAIN)],
                workers)
            return np.array([ok for f in part for ok in f], dtype=bool)

        host, host_bad = host_mask(sigs), host_mask(bad)
    finally:
        pool.terminate()
        pool.join()

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_fe, cuda_msm

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    cards = C.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(cards.strip(), flush=True)
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(fn) for fn in (cuda_fe.build, cuda_msm.build, native._lib)]:
            f.result()
    batch.configure_verified_memo(0)
    launches, calls = {}, []

    def run(path, fn, kernels=C.ED25519_KERNELS):
        C.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        ms = (time.perf_counter() - t0) * 1e3
        launches[path] = C.read_launches(path, kernels)
        flush = dict(batch.LAST_FLUSH)
        calls.append(dict(path=path, ms=ms, route=flush.get("path"), shards=flush.get("shards"),
                          launches=launches[path]))
        return out, ms, flush

    os.environ["TMTPU_SHARDED"] = "0"
    single, ms, f = run("single card", lambda: batch.verify_batch(pks, msgs, sigs, device=dev))
    if single.tobytes() != host.tobytes():
        raise SystemExit("mesh_cards: the single-card mask differs from the host arm's")
    print(f"single card: {ms:.1f} ms, path {f['path']}, mask == host arm", flush=True)
    os.environ["TMTPU_SHARDED"] = "auto"
    for _ in range(2):  # the second pass is warm
        C.mesh_auto_arm(dev, corpus, host, host_bad, run)
    guard = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                            "-q", "tests/test_torch_device_guard.py"],
                           capture_output=True, text=True)
    print(guard.stdout[-600:], flush=True)
    out = dict(cards=cards.strip().splitlines(), calls=calls, device_guard_rc=guard.returncode,
               seconds=time.perf_counter() - t00)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if guard.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
