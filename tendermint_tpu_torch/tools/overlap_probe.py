"""What two host threads launching kernels at once cost on one card, with
the kernel libraries bound so that each launch releases the GIL
(ctypes.CDLL) and so that it holds it (ctypes.PyDLL, ops/cuda_fe.py's
build_library).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.overlap_probe [--json FILE]

Signs 512 Ed25519 rows (32-byte seeds and 110-byte messages from numpy seed
20) with ed25519_ref, builds the kernels, turns the verified-row memo off,
then in the binding order CDLL, PyDLL, PyDLL, CDLL times REPS of each:

- `ladder_507`: verify_batch of rows 0-506 on the card (below RLC_MIN, the
  per-signature ladder), alone; `ladder_5`: rows 507-511, alone;
- `ladders_serial`: the two one after the other on one thread;
  `ladders_overlapped`: the two at once on two threads (a poisoned vote
  call after the quarantine: the clean rows on the caller's thread, the
  quarantined rows on the scheduler's dispatch thread);
- `rlc_512`: all 512 rows, a cached single flush, alone, and
  `rlc_512_under_ladder`: the same while a 507-row ladder runs on another
  thread (a vote flush while a bulk flush launches).

Every mask must be all True. Prints each reading, the medians by binding,
the card's name and power limit, and last one JSON object (also written to
--json). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing as mp
import statistics
import subprocess
import sys
import threading
import time

N_ROWS, SPLIT, MSG_BYTES, SEED, REPS = 512, 507, 110, 20, 3


def _sign(rows):
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


def _rows():
    import numpy as np

    rng = np.random.default_rng(SEED)
    jobs = [(rng.bytes(32), rng.bytes(MSG_BYTES)) for _ in range(N_ROWS)]
    with mp.get_context("fork").Pool(8) as pool:
        parts = pool.map(_sign, [jobs[i::8] for i in range(8)])
    signed = [None] * N_ROWS
    for i, part in enumerate(parts):
        signed[i::8] = part
    return [pk for pk, _ in signed], [m for _, m in jobs], [s for _, s in signed]


def _rebind(loader) -> None:
    """Load the built kernel libraries again with `loader` (ctypes.CDLL or
    ctypes.PyDLL); the wrappers fetch them from cuda_fe._LIBS at each
    launch."""
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    for stem, bind in (("point_kernels", cuda_fe._bind), ("msm_kernels", cuda_msm._bind),
                       ("bls_kernels", cuda_bls._bind)):
        lib = loader(cuda_fe._LIBS[stem]._name)
        bind(lib)
        cuda_fe._LIBS[stem] = lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("overlap_probe: no CUDA device", file=sys.stderr)
        return 2
    pks, msgs, sigs = _rows()
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.ops import cuda_bls, cuda_fe, cuda_msm

    for build in (cuda_fe.build, cuda_msm.build, cuda_bls.build):
        build()
    batch.configure_verified_memo(0)
    dev = torch.device("cuda")

    def verify(lo, hi):
        def call():
            mask = batch.verify_batch(pks[lo:hi], msgs[lo:hi], sigs[lo:hi], device=dev)
            if not mask.all():
                raise SystemExit(f"rows {lo}-{hi} refused")
        return call

    def overlapped(*fns):
        def call():
            threads = [threading.Thread(target=fn) for fn in fns[1:]]
            for t in threads:
                t.start()
            fns[0]()
            for t in threads:
                t.join()
        return call

    def serial(*fns):
        def call():
            for fn in fns:
                fn()
        return call

    ladder_507, ladder_5, rlc_512 = verify(0, SPLIT), verify(SPLIT, N_ROWS), verify(0, N_ROWS)
    cases = {
        "ladder_507": ladder_507, "ladder_5": ladder_5,
        "ladders_serial": serial(ladder_507, ladder_5),
        "ladders_overlapped": overlapped(ladder_507, ladder_5),
        "rlc_512": rlc_512,
        # the flush timed is the main thread's; the ladder runs beside it
        "rlc_512_under_ladder": overlapped(rlc_512, ladder_507),
    }
    for fn in cases.values():  # warm: every shape built and the A cache filled
        fn()
    torch.cuda.synchronize()
    readings = {}
    for loader in (ctypes.CDLL, ctypes.PyDLL, ctypes.PyDLL, ctypes.CDLL):
        _rebind(loader)
        for name, fn in cases.items():
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                readings.setdefault(loader.__name__, {}).setdefault(name, []).append(ms)
                print(f"{loader.__name__} {name}: {ms:.1f} ms", flush=True)
    medians = {b: {k: statistics.median(v) for k, v in r.items()} for b, r in readings.items()}
    for b, m in medians.items():
        print(f"median {b}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in m.items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out = {"card": card, "reps": REPS, "readings_ms": readings, "medians_ms": medians}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
