"""Pipe mix and lane sweeps of the padd, pdbl and fsquare_chain kernels,
beside an older tree's.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.fe_probe [--before DIR]
        [--sass-dir DIR] [--json FILE]

1. Builds: the point_kernels library (cuda_fe.build()) and, with --before,
   an older tree's csrc/point_kernels.cu (e.g. the parent commit unpacked by
   `git archive`), each with `-Xptxas -v` (registers, spills).
2. SASS (`cuobjdump -sass`) of every kernel by pipe: FMA (every IMAD form),
   ALU (IADD3, LOP3, SHF, LEA, SEL, ...), memory, other; for the whole
   kernel and for its largest loop, with the loop's product IMADs (IMADs
   of four register operands: the multiply-adds of the field products).
3. Times: each entry at each lane count of the three sweeps (fsquare_chain
   k = 50, pdbl times = 4, padd) on the same seeded carried-limb inputs, after
   checking it against the plain torch version (max |err| 0): CUDA events
   around 20 launches queued behind a device sleep, entries in order then
   in reverse, the median of the two rounds.

Prints one line per reading, the card's name and power limit, and last one
JSON object (also written to --json). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tendermint_tpu_torch.ops import cuda_fe

FSQ_LANES = (1_024, 4_096, 10_240, 16_384, 20_480, 24_576, 33_792, 50_688, 67_584)
PDBL_LANES = (32, 33, 64, 512, 1_024, 4_096, 10_240, 16_384, 20_480, 24_576)
PADD_LANES = (32, 192, 1_024, 4_096, 4_097, 8_192, 10_240, 16_384, 20_480, 24_576)
K, TIMES, REPS = 50, 4, 20
# entry -> kernel symbol, per build
SHIPPED = {"tm_fsquare_chain": "fsquare_chain_kernel",
           "tm_fsquare_chain_quad": "fsquare_chain_quad_kernel",
           "tm_pdbl": "pdbl_quad_kernel", "tm_pdbl_lanes": "pdbl_lanes_kernel",
           "tm_padd": "padd_quad_kernel", "tm_padd_lanes": "padd_lanes_kernel"}
# the kernels each entry launched in the tree before padd_quad_kernel (--before)
BEFORE = {"tm_fsquare_chain": "fsquare_chain_kernel", "tm_pdbl": "pdbl_quad_kernel",
          "tm_padd": "padd_kernel"}

PIPES = (
    ("fma", re.compile(r"^IMAD(\.|$)")),
    ("alu", re.compile(r"^(IADD3|IADD|VIADD|LEA|LOP3|SHF|SHL|SHR|PRMT|SGXT|BMSK|SEL|ISETP|"
                       r"IABS|IMNMX|VIMNMX|PLOP3|P2R|R2P|MOV|FSEL)(\.|$)")),
    ("memory", re.compile(r"^(LDG|STG|LD|ST|LDC|ULDC|LDS|STS)(\.|$)")),
)


def bind(lib, entries) -> None:
    vp = ctypes.c_void_p
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = ([vp, vp, vp, ctypes.c_int64, vp] if entry.startswith("tm_padd")
                       else [vp, vp, ctypes.c_int64, ctypes.c_int, vp])
        fn.restype = ctypes.c_int


def build(tag: str, source: str) -> tuple:
    """`source` (a .cu beside its headers) -> (library, ptxas log)."""
    so = os.path.join(cuda_fe.BUILD_DIR, f"fe_probe-{tag}.so")
    os.makedirs(cuda_fe.BUILD_DIR, exist_ok=True)
    cmd = [cuda_fe._nvcc(), *cuda_fe.NVCC_FLAGS, "-o", so, source]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc build {tag} failed:\n{res.stderr}")
    return ctypes.CDLL(so), res.stderr


def ptxas(log: str, symbols) -> dict:
    """{kernel: (registers, spill store bytes)} from -Xptxas -v."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur, spill = next((k for k in symbols if f"_Z{len(k)}{k}" in m.group(1)), None), 0
        elif cur and (m := re.search(r"(\d+) bytes spill stores", line)):
            spill = int(m.group(1))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur], cur = (int(m.group(1)), spill), None
    return out


def pipe_mix(ops) -> dict:
    by_pipe, products = Counter(), 0
    for op, rest in ops:
        if op == "NOP":
            continue
        by_pipe[next((p for p, pat in PIPES if pat.match(op)), "other")] += 1
        if op == "IMAD" and "c[" not in rest and rest.count("R") >= 4:
            products += 1
    return {"total": sum(by_pipe.values()), **dict(by_pipe), "product_imads": products}


def sass(so_path: str, symbols, dump: str | None = None) -> dict:
    """Per kernel: the pipe mix of the whole kernel and of its largest loop.
    `dump`: a file that gets the whole listing."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_fe._nvcc()),
                                                     "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = next((k for k in symbols if f"_Z{len(k)}{k}" in line), None)
            if cur:
                funcs[cur] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, ops in funcs.items():
        loops = []
        for addr, op, rest in ops:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
        entry = {"kernel": pipe_mix([(op, r) for _, op, r in ops])}
        if loops:
            lo, hi = max(loops, key=lambda span: span[1] - span[0])
            entry["largest_loop"] = pipe_mix([(op, r) for a, op, r in ops if lo <= a <= hi])
        out[name] = entry
    return out


def queued_ms(fn) -> float:
    """Device ms per call: events around REPS calls queued behind a sleep."""
    cycles = 1 << 22
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / REPS
        cycles *= 4
    raise SystemExit("fe_probe: the launches were not all queued behind the device sleep")


def launcher(lib, entry: str, x: torch.Tensor, out: torch.Tensor, y: torch.Tensor | None = None):
    n, fn = x.shape[-1], getattr(lib, entry)
    arg = K if "fsquare" in entry else TIMES
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), n) if y is not None else (
        x.data_ptr(), out.data_ptr(), n, arg)

    def run():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", default=None, help="an older tree's csrc directory")
    ap.add_argument("--sass-dir", default=None, help="write each build's SASS listing here")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fe_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with ThreadPoolExecutor(2) as ex:  # one nvcc each, at once
        shipped = ex.submit(cuda_fe.build)
        before = (ex.submit(build, "before", os.path.join(args.before, "point_kernels.cu"))
                  if args.before else None)
        builds = {"shipped": (shipped.result(), cuda_fe.BUILD_LOG["point_kernels"]["ptxas"])}
        if before:
            builds["before"] = before.result()
    entries = {"shipped": SHIPPED, "before": BEFORE}
    result = {"builds": {}, "times": []}
    for tag, (lib, log) in builds.items():
        bind(lib, entries[tag])
        symbols = tuple(entries[tag].values())
        dump = os.path.join(args.sass_dir, f"fe_probe-{tag}.sass") if args.sass_dir else None
        result["builds"][tag] = {"ptxas": ptxas(log, symbols),
                                 "sass": sass(lib._name, symbols, dump)}
        print(f"build {tag}: ptxas (registers, spill bytes) {result['builds'][tag]['ptxas']}",
              flush=True)
        for name, mix in result["builds"][tag]["sass"].items():
            print(f"sass {tag} {name}: kernel {mix['kernel']} largest loop "
                  f"{mix.get('largest_loop')}", flush=True)
    rng = np.random.default_rng(7)
    def carried(lead, n):
        host = rng.integers(0, 8193, size=(*lead, n), dtype=np.int32)
        host[..., 0, :] = rng.integers(0, 8192 + 608, size=host[..., 0, :].shape)
        return torch.from_numpy(host).to(dev)

    for kind, shapes in (("fsquare_chain", FSQ_LANES), ("pdbl", PDBL_LANES), ("padd", PADD_LANES)):
        for n in shapes:
            x = carried((20,) if kind == "fsquare_chain" else (4, 20), n)
            y = carried((4, 20), n) if kind == "padd" else None
            want = (cuda_fe.fsquare_chain_plain(x, K) if kind == "fsquare_chain"
                    else cuda_fe.pdbl_plain(x, TIMES) if kind == "pdbl"
                    else cuda_fe.padd_plain(x, y))
            runs = {}
            for tag, (lib, _) in builds.items():
                for entry in entries[tag]:
                    if not entry.startswith(f"tm_{kind}"):
                        continue
                    out = torch.empty_like(x)
                    key = f"{tag}:{entry[3:]}"
                    runs[key] = launcher(lib, entry, x, out, y)
                    runs[key]()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise SystemExit(f"{key} at {n} lanes differs from the plain version")
            times = {key: [] for key in runs}
            for order in (list(runs), list(runs)[::-1]):
                for key in order:
                    times[key].append(queued_ms(runs[key]))
            med = {key: statistics.median(v) for key, v in times.items()}
            result["times"].append({"kernel": kind, "lanes": n, "ms": med})
            print(f"time {kind} lanes={n}: " + " ".join(f"{t}={v:.4f}" for t, v in med.items())
                  + " ms (max |err| 0 against the plain version)", flush=True)
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
