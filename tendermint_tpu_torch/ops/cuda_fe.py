"""CUDA point kernels and their plain torch versions.

The counterpart of tendermint_tpu/ops/pallas_fe.py. Hand-written Hopper
kernels behind three wrappers (csrc/point_kernels.cu; field arithmetic in
csrc/fe25519.cuh, split over a warp in csrc/fe25519_warp.cuh, and in 8 x
32-bit words in csrc/fe25519_w32.cuh):

- `padd(p, q)`            unified a=-1 extended add (add-2008-hwcd-3): a
                          warp per lane on PADD_FEW_LANES lanes or fewer (the
                          MSM's top tree, tail, window fold and partial sums),
                          4 threads a lane above, one product of each round
                          each (the per-signature ladder)
- `pdbl(p, times)`        `times` chained dbl-2008-hwcd doublings: a warp per
                          lane on PDBL_FEW_LANES lanes or fewer (the window
                          fold's latency-bound chains, the ladder of a
                          small commit), 4 threads a lane above, one
                          independent field op each (the 10k ladder)
- `fsquare_chain(x, k)`   x^(2^k), k squarings (every decompression): a
                          thread a lane in 8 x 32-bit words, writing
                          canonical limbs

A point batch is one contiguous int32 tensor `(4, 20, ...batch)` (x, y, z, t
in radix-2^13 limbs, lanes innermost); a field batch is `(20, ...batch)`.

Each wrapper, for a tensor on the CPU, returns its plain version (`*_plain`,
built on ops/fe25519.py). For a CUDA tensor it checks dtype, shape and
contiguity, allocates the output, launches the kernel on the tensor's
device's current stream with that device current (`_on_card`), raises if
the launch failed, and adds one to `LAUNCHES[name]`. There is no
fallback from a CUDA tensor to the plain version.

The kernels are built with nvcc for sm_90a at first use into `_build/` (keyed
by a hash of the sources, the flags and `machine_fingerprint()`: the nvcc
binary and the card's compute capability) and bound with ctypes (`build_library`,
which ops/cuda_msm.py uses for its own library too). A failed build raises
with nvcc's stderr.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

from tendermint_tpu_torch.libs import trace as _trace
from tendermint_tpu_torch.ops import fe25519 as fe

NL = fe.NLIMBS

LAUNCHES = {"padd": 0, "pdbl": 0, "fsquare_chain": 0}


class _ThreadLaunches(threading.local):
    def __init__(self):
        self.count = 0


# the launches of all eight wrappers made by the current thread
# (msm_torch.flush_counters: a flush's dispatches are its own thread's)
THREAD_LAUNCHES = _ThreadLaunches()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fe25519.cuh", "fe25519_w32.cuh", "fe25519_warp.cuh", "point_kernels.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the formulas of pallas_fe._padd_rows / _pdbl_rows /
# _fsq_n_kernel on ops/fe25519.py).


def padd_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = fe.mul(fe.sub(py, px), fe.sub(qy, qx))
    b = fe.mul(fe.add(py, px), fe.add(qy, qx))
    c = fe.mul(fe.mul(pt, qt), fe.const("d2", p.device, pt.dim()))
    d = fe.mul_small(fe.mul(pz, qz), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)])


def _pdbl_once(p: torch.Tensor) -> torch.Tensor:
    px, py, pz, _ = p
    xx = fe.square(px)
    yy = fe.square(py)
    zz2 = fe.mul_small(fe.square(pz), 2)
    xy2 = fe.square(fe.add(px, py))
    s = fe.add(xx, yy)
    e = fe.sub(xy2, s)
    g = fe.sub(yy, xx)
    f = fe.sub(g, zz2)
    h = fe.neg(s)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)])


def pdbl_plain(p: torch.Tensor, times: int = 1) -> torch.Tensor:
    for _ in range(times):
        p = _pdbl_once(p)
    return p


def fsquare_chain_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        x = fe.square(x)
    return x


# ---------------------------------------------------------------------------
# Build and bind. One nvcc per kernel source, each into its own library in
# _build/, named by a hash of its sources, the flags and the machine
# fingerprint; builds of different libraries may run at the same time
# (chip_smoke.py starts them together).

_FINGERPRINT: Optional[str] = None


def machine_fingerprint() -> str:
    """Short stable hash of what a built library depends on besides its
    sources: the CPU architecture, the nvcc binary (its bytes, so its
    version), NVCC_FLAGS and the card's compute capability (the port's
    counterpart of the reference's ops/cache_hardening.machine_fingerprint,
    which scopes the XLA cache). Keying each library's file name by it
    makes a `_build/` directory copied between machines or toolchains a
    miss (rebuilt) instead of a stale library loaded. Without nvcc or a
    card those parts read "none"."""
    global _FINGERPRINT
    if _FINGERPRINT is not None:
        return _FINGERPRINT
    import platform

    h = hashlib.sha256()
    h.update(platform.machine().encode())
    try:
        nvcc = _nvcc()
        with open(shutil.which(nvcc) or nvcc, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    except (RuntimeError, OSError):
        h.update(b"nvcc=none")
    h.update(" ".join(NVCC_FLAGS).encode())
    cap = torch.cuda.get_device_capability(0) if torch.cuda.is_available() else "none"
    h.update(f"sm={cap}".encode())
    _FINGERPRINT = h.hexdigest()[:12]
    return _FINGERPRINT


def _source_tag(sources) -> str:
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(machine_fingerprint().encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on PATH)")


_LIBS: dict = {}
_LOCKS = {stem: threading.Lock() for stem in ("point_kernels", "msm_kernels", "bls_kernels")}
BUILD_LOG: dict = {}  # stem -> {"seconds": build + load time, "ptxas": nvcc's -Xptxas -v}


def build_library(stem: str, sources, bind) -> ctypes.CDLL:
    """Build (once per source hash) and load `csrc/<stem>.cu` (its headers in
    `sources` count toward the hash); `bind(lib)` sets the ctypes signatures.
    A failed build raises with nvcc's stderr. The nvcc build and the load
    are each a libs/trace.record_compile ("build", "load"); the build runs
    in a record_function range "compile:<stem>" (tools/profile_report.py's
    compile stage)."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    with _LOCKS[stem]:
        if stem in _LIBS:
            return _LIBS[stem]
        import time

        so_path = os.path.join(BUILD_DIR, f"{stem}-{_source_tag(sources)}.so")
        log_path = so_path + ".log"
        t0 = time.perf_counter()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".so-", suffix=".so")
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
            with torch.profiler.record_function(f"compile:{stem}"):
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc build of {stem} failed: {' '.join(cmd)}\n{res.stderr}")
            with open(log_path, "w") as f:
                f.write(res.stderr)
            os.replace(tmp, so_path)
            _trace.record_compile(stem, time.perf_counter() - t0, "build")
        t_load = time.perf_counter()
        lib = ctypes.CDLL(so_path)
        bind(lib)
        _trace.record_compile(stem, time.perf_counter() - t_load, "load")
        ptxas = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                ptxas = f.read()
        BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
        _LIBS[stem] = lib
        return lib


def _bind(lib) -> None:
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_padd.argtypes = [vp, vp, vp, i64, vp]
    lib.tm_padd_lanes.argtypes = [vp, vp, vp, i64, vp]
    lib.tm_pdbl.argtypes = [vp, vp, i64, ci, vp]
    lib.tm_pdbl_lanes.argtypes = [vp, vp, i64, ci, vp]
    lib.tm_fsquare_chain.argtypes = [vp, vp, i64, ci, vp]
    for fn in (lib.tm_padd, lib.tm_padd_lanes, lib.tm_pdbl, lib.tm_pdbl_lanes,
               lib.tm_fsquare_chain):
        fn.restype = ci


def build() -> ctypes.CDLL:
    """The point-kernel library (csrc/point_kernels.cu)."""
    return build_library("point_kernels", SOURCES, _bind)


def _check(x: torch.Tensor, lead: tuple, what: str) -> int:
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {x.dtype}")
    if tuple(x.shape[: len(lead)]) != lead:
        raise ValueError(f"{what}: expected shape {lead + ('...',)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    n = 1
    for d in x.shape[len(lead):]:
        n *= d
    return n


def _launched(name: str, err: int, launches: dict = LAUNCHES) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
    launches[name] += 1
    THREAD_LAUNCHES.count += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_SAME_CARD = contextlib.nullcontext()


def _on_card(x: torch.Tensor):
    """A launch's device guard: the C launchers size their grids and keep
    per-device state by the current CUDA device (cudaGetDevice), so every
    wrapper launches with its tensor's card current, restored after. A
    tensor on the current card (every launch on one card) switches
    nothing; on a mesh of cards a shard on cuda:1 launches in cuda:1's
    context (parallel/sharded.py)."""
    if x.device.index == torch.cuda.current_device():
        return _SAME_CARD
    return torch.cuda.device(x.device)


PADD_FEW_LANES = 4096


def padd_entry(n: int) -> str:
    """The padd kernel that n lanes launch: the warp-per-lane kernel on
    PADD_FEW_LANES lanes or fewer, the 4-threads-a-lane kernel above."""
    return "tm_padd_lanes" if n <= PADD_FEW_LANES else "tm_padd"


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for point batches (4, 20, ...batch)."""
    if p.device.type == "cpu":
        return padd_plain(p, q)
    n = _check(p, (4, NL), "padd p")
    if q.shape != p.shape or q.device != p.device:
        raise ValueError(f"padd: q {tuple(q.shape)} on {q.device} vs p {tuple(p.shape)} on {p.device}")
    _check(q, (4, NL), "padd q")
    out = torch.empty_like(p)
    if n:
        fn = getattr(build(), padd_entry(n))
        with _on_card(p):
            _launched("padd", fn(p.data_ptr(), q.data_ptr(), out.data_ptr(), n, _stream(p)))
    return out


# The largest lane count of the card sweep (tools/fe_probe.py: 32, 33, 64,
# 512, 1,024, 4,096, ... lanes, times = 4) at which the warp-per-lane kernel
# beat the 4-threads-a-lane kernel (1,024: 0.0102 vs 0.0111 ms; 4,096: 0.0273
# vs 0.0116; NVIDIA H100 80GB HBM3, 700 W).
PDBL_FEW_LANES = 1024


def pdbl_entry(n: int) -> str:
    """The pdbl kernel that n lanes launch: the warp-per-lane kernel on
    PDBL_FEW_LANES lanes or fewer, the 4-threads-a-lane kernel above."""
    return "tm_pdbl_lanes" if n <= PDBL_FEW_LANES else "tm_pdbl"


def pdbl(p: torch.Tensor, times: int = 1) -> torch.Tensor:
    """[2^times] p for a point batch (4, 20, ...batch); `times` is a run-time
    count of the kernel's loop."""
    if p.device.type == "cpu":
        return pdbl_plain(p, times)
    n = _check(p, (4, NL), "pdbl p")
    if times < 1:
        raise ValueError("pdbl: times must be >= 1")
    out = torch.empty_like(p)
    if n:
        fn = getattr(build(), pdbl_entry(n))
        with _on_card(p):
            _launched("pdbl", fn(p.data_ptr(), out.data_ptr(), n, int(times), _stream(p)))
    return out


def fsquare_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k) for a field batch (20, ...batch) of carried limbs. The
    plain version (a CPU tensor) returns the reference's carried limbs, the
    kernel (one thread a lane, at every width) the same field element in
    canonical limbs (each < 2^13, value < p): both carried forms, equal after
    `fe25519.freeze`. The kernel beat the 4-threads-a-lane radix-2^13 kernel
    it replaced on few lanes at every width of the card sweep
    (tools/fe_probe.py, k = 50; NVIDIA H100 80GB HBM3, 700.00 W): 1,024
    lanes 0.0117 vs 0.0182 ms, 4,096 0.0118 vs 0.0182, 24,576 0.0168 vs
    0.0766, 67,584 0.0303 vs 0.1968."""
    if x.device.type == "cpu":
        return fsquare_chain_plain(x, k)
    n = _check(x, (NL,), "fsquare_chain x")
    if k < 1:
        raise ValueError("fsquare_chain: k must be >= 1")
    out = torch.empty_like(x)
    if n:
        fn = build().tm_fsquare_chain
        with _on_card(x):
            _launched("fsquare_chain", fn(x.data_ptr(), out.data_ptr(), n, int(k), _stream(x)))
    return out
