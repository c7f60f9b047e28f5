"""Native (C) host prep for the RLC flush, built with gcc at first use.

The port's own copy of the reference package's native/ module, reduced to
what the ed25519 path needs: challenge hashing (`ed25519_h_batch`), the RLC
scalar math (`rlc_scalars`) and the per-window counting sort
(`sort_windows`). batchhost.c is compiled once into `_build/` (keyed by a
hash of the sources) and bound with ctypes. A failed build raises with the
compiler's stderr: the port has no pure-Python host prep.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_BASE = os.path.dirname(os.path.abspath(__file__))
_NTHREADS = min(8, os.cpu_count() or 1)


def _primes(k: int) -> list:
    out, cand = [], 2
    while len(out) < k:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return out


def _icbrt(x: int) -> int:
    r = 1 << ((x.bit_length() + 2) // 3)
    while True:
        nr = (2 * r + x // (r * r)) // 3
        if nr >= r:
            break
        r = nr
    while r * r * r > x:
        r -= 1
    while (r + 1) ** 3 <= x:
        r += 1
    return r


def sha512_constants_header() -> str:
    """SHA-512 round constants and IV from their FIPS 180-4 definitions
    (fractional bits of cube / square roots of the first primes), computed
    with integer arithmetic."""
    import math

    primes = _primes(80)
    k = [_icbrt(p << 192) & ((1 << 64) - 1) for p in primes]
    iv = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in primes[:8]]
    lines = ["/* generated by native/__init__.py — do not edit */", "#include <stdint.h>", ""]
    lines.append("static const uint64_t SHA512_IV[8] = {")
    lines.append("  " + ", ".join(f"0x{v:016X}ULL" for v in iv))
    lines.append("};")
    lines.append("static const uint64_t SHA512_K[80] = {")
    for i in range(0, 80, 4):
        lines.append("  " + ", ".join(f"0x{v:016X}ULL" for v in k[i : i + 4]) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def _build() -> ctypes.CDLL:
    src = os.path.join(_BASE, "batchhost.c")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    with open(__file__, "rb") as f:  # the header generator lives here
        h.update(f.read())
    build_dir = os.path.join(_BASE, "_build")
    so_path = os.path.join(build_dir, f"batchhost-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        hdr = os.path.join(build_dir, "sha512_constants.h")
        fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=".hdr-")
        with os.fdopen(fd, "w") as f:
            f.write(sha512_constants_header())
        os.replace(tmp, hdr)
        fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=".so-", suffix=".so")
        os.close(fd)
        cmd = [os.environ.get("CC", "gcc"), "-O3", "-shared", "-fPIC", "-pthread",
               "-I", build_dir, src, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"native host-prep build failed: {' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tm_ed25519_h_batch.argtypes = [u8p, u8p, u8p, i64p, ctypes.c_int64, u8p, ctypes.c_int]
    lib.tm_rlc_scalars.argtypes = [u8p, u8p, u8p, ctypes.c_int64, u8p, u8p, ctypes.c_int]
    lib.tm_sort_windows.argtypes = [u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int, ctypes.c_int64]
    lib.tm_prep_pool_configure.argtypes = [ctypes.c_int]
    lib.tm_prep_pool_configure.restype = ctypes.c_int
    if _NTHREADS > 1:
        lib.tm_prep_pool_configure(_NTHREADS)
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _build()
    return _LIB


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def ed25519_h_batch(sigs_blob: bytes, pks_blob: bytes, msgs_blob: bytes,
                    moffs: np.ndarray) -> np.ndarray:
    """h_i = SHA-512(R_i || A_i || M_i) mod L for n rows -> (n, 32) uint8 LE.
    sigs_blob n*64 bytes, pks_blob n*32, msgs_blob concatenated with moffs
    (n+1,) int64 offsets."""
    lib = _lib()
    n = len(moffs) - 1
    out = np.empty((n, 32), dtype=np.uint8)
    sigs = np.frombuffer(sigs_blob, dtype=np.uint8)
    pks = np.frombuffer(pks_blob, dtype=np.uint8)
    msgs = np.frombuffer(msgs_blob, dtype=np.uint8) if msgs_blob else np.zeros(1, np.uint8)
    moffs = np.ascontiguousarray(moffs, dtype=np.int64)
    lib.tm_ed25519_h_batch(
        _u8p(sigs), _u8p(pks), _u8p(msgs),
        moffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, _u8p(out), _NTHREADS,
    )
    return out


def rlc_scalars(z16: np.ndarray, h32: np.ndarray, s32: np.ndarray):
    """w_i = z_i*h_i mod 8L; u = sum z_i*s_i mod L (rows with z == 0 are
    excluded). z16 (n,16), h32 (n,32), s32 (n,32) uint8 LE ->
    (w (n,32) uint8, u int)."""
    lib = _lib()
    n = z16.shape[0]
    w = np.empty((n, 32), dtype=np.uint8)
    u = np.empty(32, dtype=np.uint8)
    z16 = np.ascontiguousarray(z16, dtype=np.uint8)
    h32 = np.ascontiguousarray(h32, dtype=np.uint8)
    s32 = np.ascontiguousarray(s32, dtype=np.uint8)
    lib.tm_rlc_scalars(_u8p(z16), _u8p(h32), _u8p(s32), n, _u8p(w), _u8p(u), _NTHREADS)
    return w, int.from_bytes(u.tobytes(), "little")


def sort_windows(digits: np.ndarray, zero16_from: int = 0):
    """Per-window stable counting sort: digits (n, 32) uint8 ->
    (perm (32, n) int32, ends (32, 256) int32). zero16_from > 0 promises rows
    >= it are zero in windows 16-31 (the RLC z-lane is 128-bit)."""
    lib = _lib()
    n = digits.shape[0]
    digits = np.ascontiguousarray(digits, dtype=np.uint8)
    perm = np.empty((32, n), dtype=np.int32)
    ends = np.empty((32, 256), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tm_sort_windows(
        _u8p(digits), n, perm.ctypes.data_as(i32p), ends.ctypes.data_as(i32p),
        _NTHREADS, int(zero16_from),
    )
    return perm, ends
