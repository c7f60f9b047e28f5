"""What holds the uptree kernel back: its instruction mix and its barriers.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m tendermint_tpu_torch.tools.uptree_probe

1. Instruction mix: `cuobjdump -sass` of the built msm_kernels library,
   uptree_kernel's SASS counted by opcode class, for the whole kernel and
   for block_add's step loop (the smallest loop holding a field product's
   multiply-adds: the kernel's one copy of fe_mul). A block_add runs that
   body 12 times (4 warps x 3 steps), 9 of them with the product, so 9
   bodies of integer instructions per 32 adds, each warp instruction two
   clocks of a sub-partition (16 int32 lanes), give an integer-issue
   estimate to set beside the multiply-add bound.
2. Barriers: the same source built with UT_PROBE_NO_BARRIER (block_add
   without its three __syncthreads; its nodes are wrong) and timed beside
   the real kernel at the warm (20,480 x 32 lanes) and streamed
   (24,576 x 32) shapes, chunks of 2,048: the median of the profiler's
   uptree_kernel records over 10 launches, in two interleaved rounds.

Prints one line per reading and, last, one JSON object. Exits 2 without a
card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

from tendermint_tpu_torch.ops import cuda_fe, cuda_msm
from tendermint_tpu_torch.ops.msm_geometry import chunk_geometry, tree_written_positions

SHAPES = (("warm", 20_480), ("streamed", 24_576))
T_WINDOWS, CH, REPS = 32, 2048, 10

# opcode classes of the SASS count; IMAD also serves as a move, add or shift
CLASSES = (
    ("multiply-add", re.compile(r"^IMAD(\.WIDE(\.U32)?|\.HI(\.U32)?|\.U32)?$")),
    ("imad as move/add/shift", re.compile(r"^IMAD\.")),
    ("add", re.compile(r"^(IADD3|IADD|VIADD|LEA)(\.|$)")),
    ("shift/logic", re.compile(r"^(SHF|LOP3|SHL|SHR|PRMT|SGXT|BMSK)(\.|$)")),
    ("compare/select", re.compile(r"^(ISETP|SEL|FSEL|PLOP3|P2R|R2P|IABS|IMNMX|VIMNMX)(\.|$)")),
    ("global memory", re.compile(r"^(LDG|STG|LD|ST|ATOMG|ATOM|RED)(\.|$)")),
    ("shared memory", re.compile(r"^(LDS|STS)(\.|$)")),
    ("barrier/fence", re.compile(r"^(BAR|MEMBAR|WARPSYNC|BSSY|BSYNC|ERRBAR|CCTL)(\.|$)")),
)


def build_probe() -> ctypes.CDLL:
    """msm_kernels.cu with UT_PROBE_NO_BARRIER, beside the real library."""
    src = os.path.join(cuda_fe.CSRC, "msm_kernels.cu")
    so = os.path.join(cuda_fe.BUILD_DIR, f"msm_kernels-nobarrier-"
                      f"{cuda_fe._source_tag(cuda_msm.SOURCES)}.so")
    if not os.path.exists(so):
        os.makedirs(cuda_fe.BUILD_DIR, exist_ok=True)
        cmd = [cuda_fe._nvcc(), *cuda_fe.NVCC_FLAGS, "-DUT_PROBE_NO_BARRIER", "-o", so, src]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc build of the probe failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    cuda_msm._bind(lib)
    return lib


ALU = ("multiply-add", "imad as move/add/shift", "add", "shift/logic", "compare/select")


def mix(ops) -> dict:
    """Instructions [(address, opcode, operands)] by class and opcode."""
    by_op = Counter(op for _, op, _ in ops if op != "NOP")
    classes = Counter()
    for op, n in by_op.items():
        classes[next((c for c, pat in CLASSES if pat.match(op)), "other")] += n
    return {"total": sum(by_op.values()), "alu": sum(classes[c] for c in ALU),
            "classes": dict(classes.most_common()), "opcodes": dict(by_op.most_common(12))}


def sass_mix(so_path: str) -> dict:
    """uptree_kernel's SASS by class, from cuobjdump -sass: the whole kernel
    and block_add's step loop (None where no loop holds 300 plain IMADs)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_fe._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    ops, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "uptree_kernel" in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if inside and m:
            ops.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []  # (start, end) of each backward branch
    for addr, op, rest in ops:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
            loops.append((int(t.group(1), 16), addr))
    body = None
    for lo, hi in sorted(loops, key=lambda span: span[1] - span[0]):
        inner = [o for o in ops if lo <= o[0] <= hi]
        if sum(op == "IMAD" for _, op, _ in inner) >= 300:
            body = mix(inner)
            break
    return {"kernel": mix(ops), "step_loop": body, "loops": len(loops)}


def launcher(lib, n: int, dev):
    """Seeded table and permutation at one shape, and a launch of `lib`'s
    uptree on them (the arguments cuda_msm.uptree passes)."""
    rng = np.random.default_rng(n)
    g = chunk_geometry(CH)
    pts = torch.from_numpy(rng.integers(0, 1 << 13, size=(4, 20, n), dtype=np.int32)).to(dev)
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(T_WINDOWS)])
                            .astype(np.int32)).to(dev)
    nchunks = T_WINDOWS * n // CH
    rows = pts.permute(2, 0, 1).reshape(n, 80).contiguous()
    lvl0 = torch.empty((4, 20, T_WINDOWS * n), dtype=torch.int32, device=dev)
    out = torch.empty((4, 20, nchunks * g.rows_out * 128), dtype=torch.int32, device=dev)
    counters = torch.zeros(nchunks * (CH // 128) + 1, dtype=torch.int32, device=dev)

    def run():
        counters.zero_()
        err = lib.tm_uptree(rows.data_ptr(), perm.data_ptr(), n, T_WINDOWS, CH, g.rows_out,
                            lvl0.data_ptr(), out.data_ptr(), counters.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"uptree launch failed: cudaError {err}")
        return lvl0, out

    return run, pts, perm, nchunks


def kernel_ms(run) -> list:
    """The profiler's uptree_kernel records (ms) over REPS launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and "uptree_kernel" in e.name]


def main() -> int:
    if not torch.cuda.is_available():
        print("uptree_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    real, probe = cuda_msm.build(), build_probe()
    result = {"sass": sass_mix(real._name), "sass_nobarrier": sass_mix(probe._name)}
    for key in ("sass", "sass_nobarrier"):
        print(f"uptree_kernel SASS ({key}): {json.dumps(result[key])}", flush=True)
    props = torch.cuda.get_device_properties(0)
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    body = result["sass"]["step_loop"]
    for path, n in SHAPES:
        run_real, pts, perm, nchunks = launcher(real, n, dev)
        run_probe, _, _, _ = launcher(probe, n, dev)
        # the real kernel through this launch equals the wrapper's, limb for limb
        pos = torch.from_numpy(tree_written_positions(CH)).to(dev)
        got, want = run_real(), cuda_msm.uptree(pts, perm, CH)
        shape = (4, 20, nchunks, chunk_geometry(CH).rows_out * 128)
        if not (torch.equal(got[0], want[0]) and torch.equal(
                got[1].reshape(shape)[..., pos], want[1].reshape(shape)[..., pos])):
            raise SystemExit("the probe's launch of the real kernel differs from cuda_msm.uptree")
        recs = {"real": [], "nobarrier": []}
        for name in ("real", "nobarrier", "nobarrier", "real"):
            recs[name] += kernel_ms(run_real if name == "real" else run_probe)
        med = {k: statistics.median(v) for k, v in recs.items()}
        # 9 step-loop bodies per 32 adds, 2 clocks per warp instruction, 4 sub-partitions an SM
        issue_ms = None if body is None else (
            nchunks * (CH - 1) / 32 * 9 * body["alu"] * 2
            / (props.multi_processor_count * 4 * clock_hz) * 1e3)
        result[path] = {"lanes": T_WINDOWS * n, "real_ms": med["real"],
                        "nobarrier_ms": med["nobarrier"],
                        "barrier_share": 1 - med["nobarrier"] / med["real"],
                        "integer_issue_ms": issue_ms,
                        "records": {k: len(v) for k, v in recs.items()}}
        print(f"uptree {path} ({T_WINDOWS * n} lanes, ch={CH}): real {med['real']:.4f} ms, "
              f"without block_add's barriers {med['nobarrier']:.4f} ms "
              f"(barriers {100 * result[path]['barrier_share']:.1f}% of the kernel); "
              f"integer-issue estimate {issue_ms} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
