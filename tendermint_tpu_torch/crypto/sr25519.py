"""sr25519 (schnorrkel): Schnorr signatures over ristretto255 bound by merlin
transcripts (reference: crypto/sr25519/pubkey.go:34 verifies via
go-schnorrkel, privkey.go:25 the signing context).

The port's own copy of tendermint_tpu/crypto/sr25519.py: ristretto255
encode and decode over the edwards25519 field (the public ristretto255
spec), the transcripts of crypto/merlin.py, schnorrkel's "substrate"
signing context, signing, and verification in pure Python
(_sr25519_verify_py) and in native C (sr25519_verify, native/sr25519.c).
A mixed Ed25519 + sr25519 set of RLC_MIN rows or more verifies on the card
in one combined check (crypto/batch.py, ops/ristretto_torch.py); the exact
per-type split, and smaller sets, verify sr25519 rows here on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.crypto.ed25519_ref import BASE, D, L, P, point_add, point_mul
from tendermint_tpu_torch.crypto.merlin import Transcript

SIGNING_CTX = b"substrate"

SQRT_M1 = pow(2, (P - 1) // 4, P)


def _is_negative(x: int) -> bool:
    return bool(x & 1)


def _ct_abs(x: int) -> int:
    return (-x) % P if _is_negative(x % P) else x % P


def _sqrt_ratio_m1(u: int, v: int):
    """(was_square, sqrt(u/v) or sqrt(i*u/v)), result non-negative
    (ristretto255 spec SQRT_RATIO_M1)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (-u) % P
    correct_sign = check == u % P
    flipped_sign = check == u_neg
    flipped_sign_i = check == u_neg * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    return (correct_sign or flipped_sign), _ct_abs(r)


INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)[1]


def ristretto_decode(data: bytes):
    """32 bytes -> extended edwards point, or None if invalid."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P  # 1 + a*s^2, a = -1
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((-(D * u1 % P * u1)) % P - u2_sqr) % P  # a*d*u1^2 - u2^2
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _ct_abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_encode(pt) -> bytes:
    """extended edwards point -> canonical 32-byte ristretto encoding."""
    X, Y, Z, T = pt
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    if _is_negative(T * z_inv % P):
        ix = X * SQRT_M1 % P
        iy = Y * SQRT_M1 % P
        X, Y = iy, ix
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        den_inv = den2
    if _is_negative(X * z_inv % P):
        Y = (-Y) % P
    s = _ct_abs(den_inv * ((Z - Y) % P) % P)
    return int.to_bytes(s, 32, "little")


def _scalar_from_wide(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


def _sign_transcript(t: Transcript, pub_bytes: bytes):
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub_bytes)
    return t


def _context_transcript(msg: bytes) -> Transcript:
    t = Transcript(b"SigningContext")
    t.append_message(b"", SIGNING_CTX)
    t.append_message(b"sign-bytes", msg)
    return t


def sr25519_verify(pub_bytes: bytes, msg: bytes, sig: bytes) -> bool:
    """One schnorrkel verification (crypto/sr25519/pubkey.go:34
    VerifySignature) by the native C verifier (native/sr25519.c). A failed
    native build raises: _sr25519_verify_py is the test reference, not a
    fallback."""
    if len(sig) != 64 or len(pub_bytes) != 32:
        return False
    from tendermint_tpu_torch import native

    return native.sr25519_verify(bytes(pub_bytes), bytes(msg), bytes(sig))


def _sr25519_verify_py(pub_bytes: bytes, msg: bytes, sig: bytes) -> bool:
    """Pure-Python schnorrkel verification (reference semantics)."""
    if len(sig) != 64 or len(pub_bytes) != 32:
        return False
    if not (sig[63] & 0x80):
        return False  # schnorrkel marker bit must be set
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return False
    r_bytes = sig[:32]
    A = ristretto_decode(pub_bytes)
    R = ristretto_decode(r_bytes)
    if A is None or R is None:
        return False
    t = _sign_transcript(_context_transcript(msg), pub_bytes)
    t.append_message(b"sign:R", r_bytes)
    k = _scalar_from_wide(t.challenge_bytes(b"sign:c", 64))
    # R == s*B - k*A
    neg_a = ((-A[0]) % P, A[1], A[2], (-A[3]) % P)
    rhs = point_add(point_mul(s, BASE), point_mul(k, neg_a))
    return ristretto_encode(rhs) == r_bytes


def sr25519_sign(key: int, nonce: bytes, pub_bytes: bytes, msg: bytes) -> bytes:
    t = _sign_transcript(_context_transcript(msg), pub_bytes)
    # witness scalar: transcript-bound nonce + fresh randomness
    wt = t.clone()
    wt.append_message(b"signing-nonce", nonce + os.urandom(32))
    r = _scalar_from_wide(wt.challenge_bytes(b"witness", 64))
    R = point_mul(r, BASE)
    r_bytes = ristretto_encode(R)
    t.append_message(b"sign:R", r_bytes)
    k = _scalar_from_wide(t.challenge_bytes(b"sign:c", 64))
    s = (k * key + r) % L
    s_bytes = bytearray(int.to_bytes(s, 32, "little"))
    s_bytes[31] |= 0x80  # schnorrkel marker
    return r_bytes + bytes(s_bytes)


@dataclass(frozen=True)
class Sr25519PubKey:
    key_bytes: bytes

    def __post_init__(self):
        if len(self.key_bytes) != 32:
            raise ValueError("sr25519 pubkey must be 32 bytes")

    def address(self) -> bytes:
        return tmhash.sum_truncated(self.key_bytes)

    def bytes(self) -> bytes:
        return self.key_bytes

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return sr25519_verify(self.key_bytes, msg, sig)

    def type_name(self) -> str:
        return "sr25519"

    def __hash__(self) -> int:
        return hash(("sr25519", self.key_bytes))


@dataclass(frozen=True, repr=False)
class Sr25519PrivKey:
    seed: bytes  # 32-byte scalar seed + derived nonce

    def __repr__(self) -> str:
        return "Sr25519PrivKey(<redacted>)"

    def __post_init__(self):
        if len(self.seed) != 32:
            raise ValueError("sr25519 privkey seed must be 32 bytes")

    @property
    def _scalar(self) -> int:
        import hashlib

        return int.from_bytes(hashlib.sha512(b"sr-key" + self.seed).digest(), "little") % L

    @property
    def _nonce(self) -> bytes:
        import hashlib

        return hashlib.sha256(b"sr-nonce" + self.seed).digest()

    def bytes(self) -> bytes:
        return self.seed

    def pub_key(self) -> Sr25519PubKey:
        return Sr25519PubKey(ristretto_encode(point_mul(self._scalar, BASE)))

    def sign(self, msg: bytes) -> bytes:
        return sr25519_sign(self._scalar, self._nonce, self.pub_key().bytes(), msg)

    def type_name(self) -> str:
        return "sr25519"


def gen_sr25519(seed: bytes | None = None) -> Sr25519PrivKey:
    return Sr25519PrivKey(seed if seed is not None else os.urandom(32))
