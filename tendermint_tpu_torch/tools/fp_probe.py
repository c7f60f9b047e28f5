"""The few-product fp381_mul kernel beside the thread-per-product kernel.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.fp_probe [--sass-dir DIR] [--json FILE]

1. Builds csrc/bls_kernels.cu as the wrapper does (cuda_bls.build) and
   reads ptxas's registers and spills of fp381_mul_few_kernel and
   fp381_mul_kernel.
2. SASS (`cuobjdump -sass`) of both kernels by pipe (tools/fe_probe.py's
   counts).
3. Times: tm_fp381_mul_few and tm_fp381_mul at the BLS paths' shapes (the
   Miller loop's launches of 8-216 products on 2 lanes, the key fold's 14
   levels of 6 products x 8,192 ... 1 lanes), on the same seeded
   carried-limb inputs, after checking each against
   cuda_bls.fp381_mul_plain (max |err| 0): CUDA events around 20 launches
   queued behind a device sleep, entries in order then in reverse, the
   median of the two rounds (`ms`); and the profiler's kernel records, the
   median over 20 launches (`prof_ms`, chip_smoke.py's measure).

Prints one line per reading, the card's name and power limit, and last one
JSON object (also written to --json). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from tendermint_tpu_torch.ops import cuda_bls, cuda_fe
from tendermint_tpu_torch.tools import fe_probe

# (groups, lanes) of each launch shape: the Miller loop's stacked products on
# 2 lanes, then the fold's levels 1..14 over the 16,384-lane padded set
MILLER = ((4, 2), (6, 2), (9, 2), (12, 2), (18, 2), (108, 2))
FOLD = tuple((6, 8192 >> k) for k in range(14))
ENTRIES = {"tm_fp381_mul_few": "fp381_mul_few_kernel", "tm_fp381_mul": "fp381_mul_kernel"}


def profiled_ms(fn, reps: int = 20):
    """Median device ms of the fp381_mul kernels' records over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and "fp381_mul" in e.name]
    return statistics.median(durs) if len(durs) >= reps // 2 else None


def carried(shape, rng) -> torch.Tensor:
    lead, n = shape[:-1], shape[-1]
    x = rng.integers(0, 4097, size=(*lead, 33, n), dtype=np.int32)
    x[..., 32, :] = rng.integers(0, 16, size=(*lead, n), dtype=np.int32)
    return torch.from_numpy(x)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-dir", default=None, help="write the SASS listing here")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lib = cuda_bls.build()
    symbols = tuple(ENTRIES.values())
    dump = os.path.join(args.sass_dir, "fp_probe.sass") if args.sass_dir else None
    result = {"ptxas": fe_probe.ptxas(cuda_fe.BUILD_LOG["bls_kernels"]["ptxas"], symbols),
              "sass": fe_probe.sass(lib._name, symbols, dump), "times": []}
    print(f"ptxas (registers, spill bytes) {result['ptxas']}", flush=True)
    for name, mix in result["sass"].items():
        print(f"sass {name}: kernel {mix['kernel']}", flush=True)
    rng = np.random.default_rng(381)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for where, shapes in (("miller", MILLER), ("fold", FOLD)):
        for groups, n in shapes:
            a, b = carried((groups, n), rng).to(dev), carried((groups, n), rng).to(dev)
            want = cuda_bls.fp381_mul_plain(a, b)
            runs = {}
            for entry, symbol in ENTRIES.items():
                out, fn = torch.empty_like(a), getattr(lib, entry)

                def run(fn=fn, out=out, symbol=symbol):
                    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, groups, stream)
                    if err:
                        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")

                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"{symbol} at {groups} x {n} differs from the plain version")
                runs[symbol] = run
            times = {key: [] for key in runs}
            for order in (list(runs), list(runs)[::-1]):
                for key in order:
                    times[key].append(fe_probe.queued_ms(runs[key]))
            med = {key: statistics.median(v) for key, v in times.items()}
            prof = {key: profiled_ms(run) for key, run in runs.items()}
            result["times"].append({"where": where, "groups": groups, "lanes": n,
                                    "products": groups * n, "ms": med, "prof_ms": prof})
            print(f"time {where} {groups} x {n} = {groups * n} products: "
                  + " ".join(f"{k}={v:.4f}" for k, v in med.items())
                  + " ms (events); profiler: "
                  + " ".join(f"{k}={v if v is None else round(v, 4)}" for k, v in prof.items())
                  + " (max |err| 0 against the plain version)", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    result["card"] = card
    print(card, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
