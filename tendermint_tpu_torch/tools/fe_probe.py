"""Pipe mix and lane sweeps of the padd, pdbl and fsquare_chain kernels,
beside an older tree's fsquare_chain kernels (with --before).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.fe_probe [--before DIR]
        [--sass-dir DIR] [--json FILE]

1. Builds: the point_kernels library (cuda_fe.build()) and, with --before,
   an older tree's csrc/point_kernels.cu (e.g. the parent commit unpacked by
   `git archive`: DIR is its tendermint_tpu_torch/csrc), each with
   `-Xptxas -v` (registers, spills).
2. SASS (`cuobjdump -sass`) of every kernel by pipe: FMA (every IMAD form),
   ALU (IADD3, LOP3, SHF, LEA, SEL, ...), memory, other, and by op family
   (IMAD, IADD3 and the other adds with carry, LOP3, SHF, LEA, SEL); for the
   whole kernel and for its largest loop, with the loop's product IMADs
   (IMADs of four register operands). For the fsquare_chain kernels also
   the loop's mix a squaring (LOOP_SQUARINGS: squarings in a loop body).
3. Times: each entry at each lane count of the three sweeps (fsquare_chain
   k = 50, the shipped kernel beside the older tree's two; pdbl times = 4;
   padd) on the same seeded
   carried-limb inputs, the first lanes at the carried maxima, after checking
   each against the plain torch version: limb for limb, or through
   fe25519.freeze with canonical limbs (each < 2^13, value < p) for a kernel
   that writes those (the shipped fsquare_chain_kernel); CUDA events
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
from tendermint_tpu_torch.ops import fe25519 as fe

FSQ_LANES = (1_024, 4_096, 10_240, 16_384, 20_480, 24_576, 33_792, 50_688, 67_584)
PDBL_LANES = (32, 33, 64, 512, 1_024, 4_096, 10_240, 16_384, 20_480, 24_576)
PADD_LANES = (32, 192, 1_024, 4_096, 4_097, 8_192, 10_240, 16_384, 20_480, 24_576)
K, TIMES, REPS = 50, 4, 20
# entry -> kernel symbol, per build
SHIPPED = {"tm_fsquare_chain": "fsquare_chain_kernel",
           "tm_pdbl": "pdbl_quad_kernel", "tm_pdbl_lanes": "pdbl_lanes_kernel",
           "tm_padd": "padd_quad_kernel", "tm_padd_lanes": "padd_lanes_kernel"}
# the fsquare_chain kernels of a tree before the 8 x 32-bit kernel (--before;
# radix 2^13, the reference's limbs: one thread a lane, and 4 threads a lane
# for few lanes)
BEFORE = {"tm_fsquare_chain": "fsquare_chain_kernel",
          "tm_fsquare_chain_quad": "fsquare_chain_quad_kernel"}
# squarings in the body of each fsquare_chain kernel's largest loop, per build:
# the 8 x 32-bit kernel's loop is unrolled twice (`#pragma unroll 2`)
LOOP_SQUARINGS = {("shipped", "fsquare_chain_kernel"): 2,
                  ("before", "fsquare_chain_kernel"): 1, ("before", "fsquare_chain_quad_kernel"): 1}

PIPES = (
    ("fma", re.compile(r"^IMAD(\.|$)")),
    ("alu", re.compile(r"^(IADD3|IADD|VIADD|LEA|LOP3|SHF|SHL|SHR|PRMT|SGXT|BMSK|SEL|ISETP|"
                       r"IABS|IMNMX|VIMNMX|PLOP3|P2R|R2P|MOV|FSEL)(\.|$)")),
    ("memory", re.compile(r"^(LDG|STG|LD|ST|LDC|ULDC|LDS|STS)(\.|$)")),
)
FAMILIES = (
    ("IMAD", re.compile(r"^IMAD(\.|$)")),
    ("IADD3/carry", re.compile(r"^(IADD3|IADD|VIADD)(\.|$)")),
    ("LOP3", re.compile(r"^LOP3(\.|$)")),
    ("SHF", re.compile(r"^SHF(\.|$)")),
    ("LEA", re.compile(r"^LEA(\.|$)")),
    ("SEL", re.compile(r"^SEL(\.|$)")),
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
    by_pipe, by_op, products = Counter(), Counter(), 0
    for op, rest in ops:
        if op == "NOP":
            continue
        by_pipe[next((p for p, pat in PIPES if pat.match(op)), "other")] += 1
        by_op[next((f for f, pat in FAMILIES if pat.match(op)), "other")] += 1
        if op == "IMAD" and "c[" not in rest and rest.count("R") >= 4:
            products += 1
    return {"total": sum(by_pipe.values()), **dict(by_pipe), "product_imads": products,
            "by_op": dict(by_op)}


def per_squaring(mix: dict, squarings: int) -> dict:
    """A loop's pipe and op-family counts over the squarings in its body."""
    flat = {k: v for k, v in mix.items() if k != "by_op"}
    return {**{k: round(v / squarings, 1) for k, v in flat.items()},
            "by_op": {k: round(v / squarings, 1) for k, v in mix["by_op"].items()}}


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
            if (tag, name) in LOOP_SQUARINGS and "largest_loop" in mix:
                mix["loop_per_squaring"] = per_squaring(mix["largest_loop"],
                                                        LOOP_SQUARINGS[tag, name])
                print(f"sass {tag} {name}: a squaring {mix['loop_per_squaring']}", flush=True)
    rng = np.random.default_rng(7)
    def carried(lead, n):
        host = rng.integers(0, 8193, size=(*lead, n), dtype=np.int32)
        host[..., 0, :] = rng.integers(0, 8192 + 608, size=host[..., 0, :].shape)
        host[..., :, :2] = 8192  # the carried maxima
        host[..., 0, :2] = 8192 + 607
        return torch.from_numpy(host).to(dev)

    def compared(out, want, kind) -> str:
        """"limbs" where out equals the plain version limb for limb,
        "freeze" where fsquare_chain's out is its canonical form."""
        if torch.equal(out, want):
            return "limbs"
        if (kind == "fsquare_chain" and torch.equal(out, fe.freeze(want))
                and bool(((out >= 0) & (out < 1 << 13)).all())):
            return "freeze"
        return ""

    for kind, shapes in (("fsquare_chain", FSQ_LANES), ("pdbl", PDBL_LANES), ("padd", PADD_LANES)):
        for n in shapes:
            x = carried((20,) if kind == "fsquare_chain" else (4, 20), n)
            y = carried((4, 20), n) if kind == "padd" else None
            want = (cuda_fe.fsquare_chain_plain(x, K) if kind == "fsquare_chain"
                    else cuda_fe.pdbl_plain(x, TIMES) if kind == "pdbl"
                    else cuda_fe.padd_plain(x, y))
            runs, how = {}, {}
            for tag, (lib, _) in builds.items():
                for entry in entries[tag]:
                    if not entry.startswith(f"tm_{kind}"):
                        continue
                    out = torch.empty_like(x)
                    key = f"{tag}:{entry[3:]}"
                    runs[key] = launcher(lib, entry, x, out, y)
                    runs[key]()
                    torch.cuda.synchronize()
                    how[key] = compared(out, want, kind)
                    if not how[key]:
                        raise SystemExit(f"{key} at {n} lanes differs from the plain version")
            times = {key: [] for key in runs}
            for order in (list(runs), list(runs)[::-1]):
                for key in order:
                    times[key].append(queued_ms(runs[key]))
            med = {key: statistics.median(v) for key, v in times.items()}
            result["times"].append({"kernel": kind, "lanes": n, "ms": med, "compared": how})
            print(f"time {kind} lanes={n}: " + " ".join(f"{t}={v:.4f}" for t, v in med.items())
                  + " ms (max |err| 0 against the plain version: "
                  + ", ".join(f"{t} {h}" for t, h in how.items()) + ")", flush=True)
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
