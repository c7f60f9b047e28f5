"""Native (C) host code, built with gcc at first use.

The port's own copy of the reference package's native/ module: the RLC
flush's host prep in batchhost.c (challenge hashing `ed25519_h_batch`, the
RLC scalar math `rlc_scalars`, the per-window counting sort
`sort_windows`) and the schnorrkel verifier in sr25519.c (`sr25519_verify`,
`sr25519_verify_batch`). Both sources are compiled once into one shared
object in `_build/`, keyed by a hash of the two sources and of this file
(which generates their constant headers), and bound with ctypes. A failed
build raises with the compiler's stderr: the port has no pure-Python host
prep and no silent Python path for sr25519 rows. Every driver runs on
prep_threads() threads (min(cores, 8), or TMTPU_PREP_THREADS), through the
library's parked worker pool, which configure_prep_threads resizes and
prep_pool_size reads, as in the reference package.
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


def _default_threads() -> int:
    """The prep thread count by default: min(cores, 8), or TMTPU_PREP_THREADS
    (1 to 64) where it is set."""
    env = os.environ.get("TMTPU_PREP_THREADS", "")
    if env:
        try:
            return max(1, min(64, int(env)))
        except ValueError:
            pass
    return min(8, os.cpu_count() or 1)


_NTHREADS = _default_threads()


def prep_threads() -> int:
    """The thread count every native driver runs with."""
    return _NTHREADS


def configure_prep_threads(n) -> int:
    """Set the prep thread count (None or 0 = the default) and resize the
    library's parked worker pool to match (building the library if it is not
    built yet). Returns the new count."""
    global _NTHREADS
    _NTHREADS = _default_threads() if not n else max(1, min(64, int(n)))
    _lib().tm_prep_pool_configure(_NTHREADS)
    return _NTHREADS


def prep_pool_size() -> int:
    """The live size of the library's worker pool (1 = per-call threads)."""
    return int(_lib().tm_prep_pool_size())


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


def _fe_words(x: int, n: int = 4) -> str:
    return ", ".join(f"0x{(x >> (64 * i)) & (2**64 - 1):016X}ULL" for i in range(n))


def _le_bytes(x: int) -> str:
    return ", ".join(str((x >> (8 * i)) & 0xFF) for i in range(32))


def ed25519_constants_header() -> str:
    """The edwards25519 / ristretto255 field and curve constants sr25519.c
    uses, computed from their definitions (RFC 8032, the ristretto255 spec)
    with integer arithmetic."""
    p = 2**255 - 19
    d = (-121665 * pow(121666, p - 2, p)) % p
    sqrt_m1 = pow(2, (p - 1) // 4, p)

    def sqrt_ratio(u: int, v: int) -> int:
        r = u * pow(v, 3, p) % p * pow(u * pow(v, 7, p) % p, (p - 5) // 8, p) % p
        if v * r % p * r % p in ((-u) % p * sqrt_m1 % p, (-u) % p):
            r = r * sqrt_m1 % p
        return (-r) % p if r & 1 else r

    # base point: y = 4/5, x recovered even (RFC 8032 section 5.1)
    by = 4 * pow(5, p - 2, p) % p
    x2 = (by * by - 1) * pow(d * by * by + 1, p - 2, p) % p
    bx = pow(x2, (p + 3) // 8, p)
    if bx * bx % p != x2:
        bx = bx * sqrt_m1 % p
    if bx & 1:
        bx = p - bx
    lines = ["/* generated by native/__init__.py — do not edit */", "#include <stdint.h>", ""]
    for name, val in [
        ("FE_D", d), ("FE_D2", 2 * d % p), ("FE_SQRT_M1", sqrt_m1),
        ("FE_INVSQRT_A_MINUS_D", sqrt_ratio(1, (-1 - d) % p)),
        ("FE_BASE_X", bx), ("FE_BASE_Y", by), ("FE_BASE_T", bx * by % p), ("FE_P", p),
    ]:
        lines.append(f"static const uint64_t {name}[4] = {{{_fe_words(val)}}};")
    lines.append(f"static const uint64_t FE_4P[5] = {{{_fe_words(4 * p, 5)}}};")
    # exponent (p-5)/8 of SQRT_RATIO_M1, and the group order L, little-endian bytes
    lines.append(f"static const uint8_t FE_EXP_P58[32] = {{{_le_bytes((p - 5) // 8)}}};")
    order = 2**252 + 27742317777372353535851937790883648493
    lines.append(f"static const uint8_t SC_L_BYTES[32] = {{{_le_bytes(order)}}};")
    return "\n".join(lines) + "\n"


HEADERS = (("sha512_constants.h", sha512_constants_header),
           ("ed25519_constants.h", ed25519_constants_header))


def _build() -> ctypes.CDLL:
    srcs = [os.path.join(_BASE, name) for name in ("batchhost.c", "sr25519.c")]
    h = hashlib.sha256()
    for path in (*srcs, __file__):  # the header generators live here
        with open(path, "rb") as f:
            h.update(f.read())
    build_dir = os.path.join(_BASE, "_build")
    so_path = os.path.join(build_dir, f"batchhost-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        # written anew with every build: a header cached on its own could
        # outlive a change of its generator
        for name, gen in HEADERS:
            fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=".hdr-")
            with os.fdopen(fd, "w") as f:
                f.write(gen())
            os.replace(tmp, os.path.join(build_dir, name))
        fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=".so-", suffix=".so")
        os.close(fd)
        cmd = [os.environ.get("CC", "gcc"), "-O3", "-shared", "-fPIC", "-pthread",
               "-I", build_dir, *srcs, "-o", tmp]
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
    lib.tm_sr25519_verify_one.argtypes = [u8p, u8p, ctypes.c_int64, u8p]
    lib.tm_sr25519_verify_one.restype = ctypes.c_int
    lib.tm_sr25519_verify_batch.argtypes = [u8p, u8p, i64p, u8p, ctypes.c_int64, u8p, ctypes.c_int]
    lib.tm_prep_pool_configure.argtypes = [ctypes.c_int]
    lib.tm_prep_pool_configure.restype = ctypes.c_int
    lib.tm_prep_pool_size.argtypes = []
    lib.tm_prep_pool_size.restype = ctypes.c_int
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


def sr25519_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """One schnorrkel verification (sr25519.c; crypto/sr25519._sr25519_verify_py
    bit for bit). A key that is not 32 bytes or a signature that is not 64
    is False."""
    lib = _lib()
    if len(pub) != 32 or len(sig) != 64:
        return False
    p = np.frombuffer(pub, dtype=np.uint8)
    m = np.frombuffer(msg, dtype=np.uint8) if msg else np.zeros(1, np.uint8)
    s = np.frombuffer(sig, dtype=np.uint8)
    return bool(lib.tm_sr25519_verify_one(_u8p(p), _u8p(m), len(msg), _u8p(s)))


def sr25519_verify_batch(pks_blob: bytes, msgs_blob: bytes, moffs: np.ndarray,
                         sigs_blob: bytes) -> np.ndarray:
    """n schnorrkel verifications on up to 16 threads -> bool (n,). pks_blob
    n*32 bytes, sigs_blob n*64 (the caller drops rows of other lengths
    first), msgs_blob concatenated with moffs (n+1,) int64 offsets."""
    lib = _lib()
    n = len(moffs) - 1
    if len(pks_blob) != 32 * n or len(sigs_blob) != 64 * n:
        raise ValueError(f"sr25519_verify_batch: {len(pks_blob)} key and {len(sigs_blob)} "
                         f"signature bytes for {n} rows")
    out = np.empty(n, dtype=np.uint8)
    pks = np.frombuffer(pks_blob, dtype=np.uint8) if n else np.zeros(1, np.uint8)
    sigs = np.frombuffer(sigs_blob, dtype=np.uint8) if n else np.zeros(1, np.uint8)
    msgs = np.frombuffer(msgs_blob, dtype=np.uint8) if msgs_blob else np.zeros(1, np.uint8)
    moffs = np.ascontiguousarray(moffs, dtype=np.int64)
    lib.tm_sr25519_verify_batch(
        _u8p(pks), _u8p(msgs), moffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8p(sigs), n, _u8p(out), _NTHREADS,
    )
    return out.astype(bool)
