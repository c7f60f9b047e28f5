"""Pure-Python Ed25519 (RFC 8032) reference implementation.

The port's own copy of the reference package's crypto/ed25519_ref.py: the
arbitrary-precision ground truth the CUDA kernels and the torch field and
point ops are tested against, the source of host constants (the basepoint
and its niels table), and the signer the port's keys and chip_smoke.py use.

Two verification predicates:

- `verify` — *cofactorless*: accept iff [s]B == R + [h]A exactly (compared
  via compressed encodings) and s < L — the same check golang.org/x/crypto's
  ed25519 performs (reference: crypto/ed25519/ed25519.go:148).
- `verify_cofactored` — the FRAMEWORK's canonical semantic (ZIP-215-style):
  accept iff [8]([s]B - [h]A - R) == identity, with canonical encodings and
  s < L required. Cofactored acceptance is a strict superset of cofactorless
  (multiply the cofactorless equation by 8), differing only on crafted
  small-torsion inputs; honest keys/sigs are torsion-free, where both agree.
  Every verification path in the framework (host OpenSSL wrapper
  crypto/keys.py, the per-signature ladder ops/ed25519_torch.py, the RLC
  batch path ops/msm_torch.py) implements exactly this predicate, so verification outcome
  never depends on which path/backend a node runs — a consensus-fork
  requirement at the 2/3 boundary.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# Curve constants
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point
_BY = (4 * pow(5, P - 2, P)) % P
_BX_SQ = ((_BY * _BY - 1) * pow(D * _BY * _BY + 1, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = ((y * y - 1) * pow(D * y * y + 1, P - 2, P)) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


BX = _recover_x(_BY, 0)
assert BX is not None
# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
BASE = (BX, _BY, 1, BX * _BY % P)
IDENTITY = (0, 1, 1, 0)

Point = Tuple[int, int, int, int]


def point_add(p: Point, q: Point) -> Point:
    # Unified addition for a=-1 twisted Edwards ("add-2008-hwcd-3").
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p: Point) -> Point:
    # "dble-2008-hwcd" for a=-1.
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = (a + b) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_mul(s: int, p: Point) -> Point:
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_double(p)
        s >>= 1
    return q


def point_equal(p: Point, q: Point) -> bool:
    # x1/z1 == x2/z2 and y1/z1 == y2/z2
    return (
        (p[0] * q[2] - q[0] * p[2]) % P == 0
        and (p[1] * q[2] - q[1] * p[2]) % P == 0
    )


def point_compress(p: Point) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x = p[0] * zinv % P
    y = p[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def sha512_mod_l(data: bytes) -> int:
    return int.from_bytes(sha512(data), "little") % L


def secret_expand(secret: bytes) -> Tuple[int, bytes]:
    if len(secret) != 32:
        raise ValueError("bad secret length")
    h = sha512(secret)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(point_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(secret)
    A = point_compress(point_mul(a, BASE))
    r = sha512_mod_l(prefix + msg)
    R = point_compress(point_mul(r, BASE))
    h = sha512_mod_l(R + A + msg)
    s = (r + h * a) % L
    return R + int.to_bytes(s, 32, "little")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    A = point_decompress(pubkey)
    if A is None:
        return False
    Rs = sig[:32]
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = sha512_mod_l(Rs + pubkey + msg)
    # Cofactorless: compare compressed encodings of [s]B - [h]A against R.
    neg_a = (P - A[0], A[1], A[2], P - A[3])
    sB_hA = point_add(point_mul(s, BASE), point_mul(h, neg_a))
    return point_compress(sB_hA) == Rs


def verify_cofactored(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """The framework's canonical verification predicate (see module doc):
    [8]([s]B - [h]A - R) == identity, canonical encodings, s < L.

    Used as the slow-path referee when OpenSSL (cofactorless) rejects a
    signature (crypto/keys.py) — cofactored accepts a strict superset, so
    the recheck only runs on already-rejected (rare) inputs."""
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    A = point_decompress(pubkey)  # enforces canonical y (< p)
    if A is None:
        return False
    R = point_decompress(sig[:32])
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = sha512_mod_l(sig[:32] + pubkey + msg)
    neg_a = (P - A[0], A[1], A[2], P - A[3])
    neg_r = (P - R[0], R[1], R[2], P - R[3])
    q = point_add(point_add(point_mul(s, BASE), point_mul(h, neg_a)), neg_r)
    for _ in range(3):  # multiply by the cofactor 8
        q = point_double(q)
    # Z != 0 guard, mirroring the device kernels: an exceptional unified
    # addition on crafted torsion inputs can yield (0,0,0,0), whose cross
    # products against the identity are all zero — that must read as
    # REJECT, exactly as ops/ed25519_torch.py and ops/msm_torch.py read it.
    if q[2] % P == 0:
        return False
    return point_equal(q, IDENTITY)
