"""Pure-Python BLS12-381: the port's own copy of the aggregate-signature referee.

A copy of tendermint_tpu/crypto/bls_ref.py with its code unchanged (the
port imports nothing of the JAX package). In the port it is

- the host half of aggregate-commit verification: key and signature
  decoding with subgroup checks, hash_to_g2 and the final exponentiation
  (types/validator_set.py; the Miller loop runs on the card through
  ops/pairing_torch.py), and
- the integer reference that tests/test_torch_bls_*.py and chip_smoke.py
  hold the card's aggregate pubkey and pairing verdicts against.

Scheme: the draft-irtf-cfrg-bls-signature "minimal-pubkey-size"
proof-of-possession ciphersuite, eth2-compatible:

    BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_

Public keys live in G1 (48-byte compressed), signatures in G2 (96-byte
compressed); an n-validator commit carries ONE 96-byte signature + a signer
bitmap instead of n*64 signature bytes (docs/BLS.md). Rogue-key defense is
proof-of-possession (pop_prove / pop_verify); aggregate verification MUST
only accept keys whose PoP has been checked (crypto/keys.py register_pop).

Design notes:

- Fp is raw Python ints mod P (fastest); Fp2/Fp6/Fp12 are slotted classes
  over the standard tower  Fp2 = Fp[u]/(u^2+1),  Fp6 = Fp2[v]/(v^3 - XI),
  Fp12 = Fp6[w]/(w^2 - v)  with XI = 1 + u.
- Every derivable constant IS derived at import (Frobenius coefficients,
  the psi untwist-Frobenius-twist endomorphism, the hard-part base-p
  digits) instead of hardcoded, so the only trusted-from-the-spec tables
  are the curve constants, the SSWU (A', B', Z) parameters and the
  RFC 9380 3-isogeny coefficients — each of which is pinned structurally
  (on-curve checks) and against RFC vectors in tests/test_bls_ref.py.
- hash_to_G2 follows RFC 9380 (hash_to_field via expand_message_xmd,
  simplified SSWU on the isogenous curve E', the 3-isogeny to E2, and the
  Budroni-Pintore psi-based clear_cofactor of appendix G.4, which equals
  multiplication by the suite's h_eff).
- The pairing is the optimal ate pairing: Miller loop over |x| (the BLS
  parameter, negative -> one conjugation), line evaluations in affine
  E(Fp12) coordinates (py_ecc-style: slow but transparently correct; the
  device path is ops/pairing_torch.py on kernels B7-B8), easy
  final exponentiation via conjugate/inverse + Frobenius, hard part as
  four base-p digit exponentiations recombined through Frobenius.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Iterable, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Curve constants (BLS12-381; the spec-trusted table)

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000  # the BLS parameter x (negative)
H1 = 0x396C8C005555E1568C00AAAB0000AAAB  # G1 cofactor

B_G1 = 4  # E1: y^2 = x^3 + 4

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

DST_SIG = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
DST_POP = b"BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

PUBKEY_SIZE = 48  # compressed G1
SIGNATURE_SIZE = 96  # compressed G2


# --------------------------------------------------------------------------
# Fp: raw ints mod P


def _fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def _fp_sqrt(a: int) -> Optional[int]:
    """sqrt in Fp (P ≡ 3 mod 4): a^((P+1)/4); None if a is not a QR."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a % P else None


class Fp2:
    """c0 + c1*u, u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp2":
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o: "Fp2") -> "Fp2":
        # Karatsuba: (a0+a1 u)(b0+b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    def mul_int(self, k: int) -> "Fp2":
        return Fp2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fp2":
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        return Fp2((self.c0 + self.c1) * (self.c0 - self.c1), 2 * self.c0 * self.c1)

    def conj(self) -> "Fp2":
        return Fp2(self.c0, -self.c1)

    def inv(self) -> "Fp2":
        n = _fp_inv((self.c0 * self.c0 + self.c1 * self.c1) % P)
        return Fp2(self.c0 * n, -self.c1 * n)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    def __repr__(self) -> str:
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"

    def pow(self, e: int) -> "Fp2":
        out, base = FP2_ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for m=2 (sign of the 'lexically first' nonzero limb)."""
        sign_0 = self.c0 & 1
        zero_0 = self.c0 == 0
        return sign_0 | (zero_0 & (self.c1 & 1))

    def is_square(self) -> bool:
        # Euler over Fp via the norm: a is a square in Fp2 iff
        # N(a) = a^(p+1) = c0^2 + c1^2 is a square in Fp.
        n = (self.c0 * self.c0 + self.c1 * self.c1) % P
        return n == 0 or pow(n, (P - 1) // 2, P) == 1

    def sqrt(self) -> Optional["Fp2"]:
        """Complex-method square root for u^2 = -1; None if not a square."""
        if self.is_zero():
            return FP2_ZERO
        if self.c1 == 0:
            s = _fp_sqrt(self.c0)
            if s is not None:
                return Fp2(s, 0)
            # c0 is a nonresidue: sqrt(c0) = sqrt(-c0) * u since u^2 = -1
            s = _fp_sqrt(-self.c0 % P)
            return Fp2(0, s) if s is not None else None
        alpha = _fp_sqrt((self.c0 * self.c0 + self.c1 * self.c1) % P)
        if alpha is None:
            return None
        delta = (self.c0 + alpha) * _fp_inv(2) % P
        x0 = _fp_sqrt(delta)
        if x0 is None:
            delta = (self.c0 - alpha) * _fp_inv(2) % P
            x0 = _fp_sqrt(delta)
            if x0 is None:
                return None
        if x0 == 0:
            return None  # would divide by zero; c1 != 0 makes this unreachable
        y0 = self.c1 * _fp_inv(2 * x0 % P) % P
        cand = Fp2(x0, y0)
        return cand if cand.square() == self else None


FP2_ZERO = Fp2(0, 0)
FP2_ONE = Fp2(1, 0)
XI = Fp2(1, 1)  # the Fp6 nonresidue v^3 = 1 + u


class Fp6:
    """c0 + c1*v + c2*v^2, v^3 = XI."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fp6":
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fp6") -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2) * XI + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self) -> "Fp6":
        return self * self

    def mul_by_v(self) -> "Fp6":
        """v * (c0 + c1 v + c2 v^2) = c2*XI + c0 v + c1 v^2."""
        return Fp6(self.c2 * XI, self.c0, self.c1)

    def inv(self) -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2) * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + (a2 * t1 + a1 * t2) * XI
        dinv = denom.inv()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fp6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self) -> int:
        return hash((self.c0, self.c1, self.c2))


FP6_ZERO = Fp6(FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = Fp6(FP2_ONE, FP2_ZERO, FP2_ZERO)


class Fp12:
    """c0 + c1*w, w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp12":
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o: "Fp12") -> "Fp12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp12(t0 + t1.mul_by_v(), t2 - t0 - t1)

    def square(self) -> "Fp12":
        return self * self

    def conj(self) -> "Fp12":
        """The p^6-Frobenius: w -> -w (conjugation over Fp6)."""
        return Fp12(self.c0, -self.c1)

    def inv(self) -> "Fp12":
        denom = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fp12(self.c0 * denom, -(self.c1 * denom))

    def pow(self, e: int) -> "Fp12":
        if e < 0:
            return self.inv().pow(-e)
        out, base = FP12_ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def is_one(self) -> bool:
        return self == FP12_ONE

    def __eq__(self, o) -> bool:
        return isinstance(o, Fp12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    # -- w-power basis view (for Frobenius) --------------------------------

    def wcoeffs(self) -> List[Fp2]:
        """Coefficients over the basis {1, w, w^2=v, w^3=vw, w^4=v^2, w^5=v^2 w}."""
        a, b = self.c0, self.c1
        return [a.c0, b.c0, a.c1, b.c1, a.c2, b.c2]

    @staticmethod
    def from_wcoeffs(c: Sequence[Fp2]) -> "Fp12":
        return Fp12(Fp6(c[0], c[2], c[4]), Fp6(c[1], c[3], c[5]))

    def frobenius(self) -> "Fp12":
        """x -> x^p via conj on Fp2 coefficients + the derived gamma table."""
        return Fp12.from_wcoeffs(
            [c.conj() * _FROB_GAMMA[m] for m, c in enumerate(self.wcoeffs())]
        )


FP12_ZERO = Fp12(FP6_ZERO, FP6_ZERO)
FP12_ONE = Fp12(FP6_ONE, FP6_ZERO)

# Frobenius coefficients, DERIVED at import: pi(w^m) = XI^(m*(p-1)/6) * w^m
# (w^6 = v^3 = XI, and (p-1)/6 is an integer for this p).
_FROB_GAMMA: List[Fp2] = [XI.pow(m * (P - 1) // 6) for m in range(6)]


def fp2_embed(x: Fp2) -> Fp12:
    return Fp12(Fp6(x, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def fp_embed(x: int) -> Fp12:
    return fp2_embed(Fp2(x, 0))


# w as an Fp12 element, and the untwist scale factors 1/w^2, 1/w^3.
_W = Fp12(FP6_ZERO, FP6_ONE)
_W_INV2 = (_W * _W).inv()
_W_INV3 = (_W * _W * _W).inv()


# --------------------------------------------------------------------------
# Jacobian point arithmetic (a = 0 short Weierstrass), generic over the
# coordinate field: ints for G1, Fp2 for G2 — every op used (+, -, *,
# square) exists on both. Points are (X, Y, Z) with Z == zero => identity.


class _G1Field:
    """Shim giving raw ints the operator surface the generic Jacobian
    formulas use; kept trivial so G1 stays close to raw-int speed."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    def __add__(self, o):
        return _G1Field(self.v + o.v)

    def __sub__(self, o):
        return _G1Field(self.v - o.v)

    def __neg__(self):
        return _G1Field(-self.v)

    def __mul__(self, o):
        return _G1Field(self.v * o.v)

    def mul_int(self, k: int):
        return _G1Field(self.v * k)

    def square(self):
        return _G1Field(self.v * self.v)

    def inv(self):
        return _G1Field(_fp_inv(self.v))

    def is_zero(self) -> bool:
        return self.v == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, _G1Field) and self.v == o.v

    def __hash__(self) -> int:
        return hash(self.v)


def _jac_is_identity(pt) -> bool:
    return pt[2].is_zero()


def _jac_double(pt):
    X, Y, Z = pt
    if Z.is_zero():
        return pt
    # Y == 0 (a point of order 2; not in either r-subgroup but reachable on
    # generic curve inputs) needs no branch: Z3 = 2YZ = 0 = identity.
    A = X.square()
    B = Y.square()
    C = B.square()
    D = ((X + B).square() - A - C).mul_int(2)
    E = A.mul_int(3)
    F = E.square()
    X3 = F - D.mul_int(2)
    Y3 = E * (D - X3) - C.mul_int(8)
    Z3 = (Y * Z).mul_int(2)
    return (X3, Y3, Z3)


def _jac_add(p1, p2):
    if _jac_is_identity(p1):
        return p2
    if _jac_is_identity(p2):
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1.square()
    Z2Z2 = Z2.square()
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        if S1 == S2:
            return _jac_double(p1)
        zero = Z1 - Z1
        return (X1, Y1, zero)  # same x, opposite y: the identity (Z = 0)
    H = U2 - U1
    I = H.mul_int(2).square()
    J = H * I
    r = (S2 - S1).mul_int(2)
    V = U1 * I
    X3 = r.square() - J - V.mul_int(2)
    Y3 = r * (V - X3) - (S1 * J).mul_int(2)
    Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
    return (X3, Y3, Z3)


def _jac_neg(pt):
    return (pt[0], -pt[1], pt[2])


def _jac_mul(pt, k: int):
    if k < 0:
        return _jac_mul(_jac_neg(pt), -k)
    zero = pt[2] - pt[2]
    one = FP2_ONE if isinstance(zero, Fp2) else _G1Field(1)
    acc = (one, one, zero)  # identity: any X/Y with Z = 0
    if k == 0:
        return acc
    for bit in bin(k)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add(acc, pt)
    return acc


def _jac_to_affine(pt):
    """-> (x, y) coordinate pair, or None for the identity."""
    X, Y, Z = pt
    if Z.is_zero():
        return None
    zinv = Z.inv()
    zinv2 = zinv.square()
    return (X * zinv2, Y * zinv2 * zinv)


def _jac_eq(p1, p2) -> bool:
    i1, i2 = _jac_is_identity(p1), _jac_is_identity(p2)
    if i1 or i2:
        return i1 and i2
    Z1Z1, Z2Z2 = p1[2].square(), p2[2].square()
    return (
        p1[0] * Z2Z2 == p2[0] * Z1Z1
        and p1[1] * Z2Z2 * p2[2] == p2[1] * Z1Z1 * p1[2]
    )


# G1 points: Jacobian triples of _G1Field. G2: Jacobian triples of Fp2.

G1_GEN = (_G1Field(G1_X), _G1Field(G1_Y), _G1Field(1))
G1_IDENTITY = (_G1Field(1), _G1Field(1), _G1Field(0))
G2_GEN = (Fp2(G2_X_C0, G2_X_C1), Fp2(G2_Y_C0, G2_Y_C1), FP2_ONE)
G2_IDENTITY = (FP2_ONE, FP2_ONE, FP2_ZERO)

B2 = XI.mul_int(4)  # E2: y^2 = x^3 + 4(1+u)


def g1_on_curve(pt) -> bool:
    aff = _jac_to_affine(pt)
    if aff is None:
        return True
    x, y = aff
    return (y.v * y.v - x.v * x.v * x.v - B_G1) % P == 0


def g2_on_curve(pt) -> bool:
    aff = _jac_to_affine(pt)
    if aff is None:
        return True
    x, y = aff
    return y.square() == x.square() * x + B2


def g1_in_subgroup(pt) -> bool:
    return g1_on_curve(pt) and _jac_is_identity(_jac_mul(pt, R))


def g2_in_subgroup(pt) -> bool:
    return g2_on_curve(pt) and _jac_is_identity(_jac_mul(pt, R))


# --------------------------------------------------------------------------
# Serialization (ZCash/eth2 compressed encodings)

_HALF_P = (P - 1) // 2


def g1_to_bytes(pt) -> bytes:
    if _jac_is_identity(pt):
        return bytes([0xC0]) + b"\x00" * 47
    x, y = _jac_to_affine(pt)
    flags = 0x80 | (0x20 if y.v > _HALF_P else 0)
    enc = bytearray(x.v.to_bytes(48, "big"))
    enc[0] |= flags
    return bytes(enc)


def g1_from_bytes(data: bytes, subgroup_check: bool = True):
    """48 compressed bytes -> G1 Jacobian point; None if invalid."""
    if len(data) != PUBKEY_SIZE:
        return None
    flags = data[0]
    if not flags & 0x80:
        return None  # only compressed encodings are admitted
    if flags & 0x40:
        if flags != 0xC0 or any(data[1:]) or data[0] & 0x3F:
            return None
        return G1_IDENTITY
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        return None
    y = _fp_sqrt((x * x * x + B_G1) % P)
    if y is None:
        return None
    if (y > _HALF_P) != bool(flags & 0x20):
        y = P - y
    pt = (_G1Field(x), _G1Field(y), _G1Field(1))
    if subgroup_check and not g1_in_subgroup(pt):
        return None
    return pt


def _fp2_lex_gt_half(y: Fp2) -> bool:
    """'y > -y' under the (c1, c0) lexicographic order the ZCash format uses."""
    if y.c1 != 0:
        return y.c1 > _HALF_P
    return y.c0 > _HALF_P


def g2_to_bytes(pt) -> bytes:
    if _jac_is_identity(pt):
        return bytes([0xC0]) + b"\x00" * 95
    x, y = _jac_to_affine(pt)
    flags = 0x80 | (0x20 if _fp2_lex_gt_half(y) else 0)
    enc = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    enc[0] |= flags
    return bytes(enc)


def g2_from_bytes(data: bytes, subgroup_check: bool = True):
    """96 compressed bytes -> G2 Jacobian point; None if invalid."""
    if len(data) != SIGNATURE_SIZE:
        return None
    flags = data[0]
    if not flags & 0x80:
        return None
    if flags & 0x40:
        if flags != 0xC0 or any(data[1:]) or data[0] & 0x3F:
            return None
        return G2_IDENTITY
    x_c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:], "big")
    if x_c0 >= P or x_c1 >= P:
        return None
    x = Fp2(x_c0, x_c1)
    y = (x.square() * x + B2).sqrt()
    if y is None:
        return None
    if _fp2_lex_gt_half(y) != bool(flags & 0x20):
        y = -y
    pt = (x, y, FP2_ONE)
    if subgroup_check and not g2_in_subgroup(pt):
        return None
    return pt


# --------------------------------------------------------------------------
# RFC 9380 hash-to-G2


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1, hash = SHA-256."""
    if len(dst) > 255:
        dst = b"H2C-OVERSIZE-DST-" + hashlib.sha256(dst).digest()
    h = hashlib.sha256
    b_in_bytes, s_in_bytes = 32, 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd: requested output too long")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * s_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = h(b0 + b"\x01" + dst_prime).digest()
    uniform = b1
    bi = b1
    for i in range(2, ell + 1):
        bi = h(bytes(a ^ b for a, b in zip(b0, bi)) + i.to_bytes(1, "big") + dst_prime).digest()
        uniform += bi
    return uniform[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int) -> List[Fp2]:
    """RFC 9380 section 5.2 with m=2, L=64."""
    L = 64
    uniform = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        off = i * 2 * L
        e0 = int.from_bytes(uniform[off : off + L], "big") % P
        e1 = int.from_bytes(uniform[off + L : off + 2 * L], "big") % P
        out.append(Fp2(e0, e1))
    return out


# Simplified SSWU on the isogenous curve E': y^2 = x^3 + A'x + B'
# (RFC 9380 section 8.8.2).
SSWU_A = Fp2(0, 240)
SSWU_B = Fp2(1012, 1012)
SSWU_Z = Fp2(-2 % P, -1 % P)  # -(2 + u)


def _sswu(u: Fp2) -> Tuple[Fp2, Fp2]:
    """map_to_curve_simple_swu (RFC 9380 F.2, straight-line version)."""
    Z, A, B = SSWU_Z, SSWU_A, SSWU_B
    u2 = u.square()
    tv1 = Z * u2
    tv2 = tv1.square() + tv1
    if tv2.is_zero():
        x1 = B * (Z * A).inv()  # exceptional case: x = B / (Z * A)
    else:
        x1 = (-B) * A.inv() * (tv2.inv() + FP2_ONE)
    gx1 = x1.square() * x1 + A * x1 + B
    if gx1.is_square():
        x, y = x1, gx1.sqrt()
    else:
        x2 = tv1 * x1
        gx2 = x2.square() * x2 + A * x2 + B
        x, y = x2, gx2.sqrt()
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


# The 3-isogeny E' -> E2 (RFC 9380 appendix E.3). Coefficient table is
# spec-trusted; tests pin (a) SSWU output on E', (b) iso output on E2, and
# (c) the full suite against RFC 9380 known-answer vectors.
_ISO3_X_NUM = [
    Fp2(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    Fp2(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    Fp2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fp2(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]
_ISO3_X_DEN = [
    Fp2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    Fp2(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    FP2_ONE,
]
_ISO3_Y_NUM = [
    Fp2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fp2(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    Fp2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fp2(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]
_ISO3_Y_DEN = [
    Fp2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fp2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    Fp2(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    FP2_ONE,
]


def _horner(coeffs: Sequence[Fp2], x: Fp2) -> Fp2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def _iso3_map(x: Fp2, y: Fp2) -> Tuple[Fp2, Fp2]:
    xn, xd = _horner(_ISO3_X_NUM, x), _horner(_ISO3_X_DEN, x)
    yn, yd = _horner(_ISO3_Y_NUM, x), _horner(_ISO3_Y_DEN, x)
    return xn * xd.inv(), y * yn * yd.inv()


# psi: the untwist-Frobenius-twist endomorphism on E2, with DERIVED
# constants: psi(x, y) = (c_x * conj(x), c_y * conj(y)),
# c_x = 1/XI^((p-1)/3), c_y = 1/XI^((p-1)/2).
_PSI_CX = XI.pow((P - 1) // 3).inv()
_PSI_CY = XI.pow((P - 1) // 2).inv()


def _psi(pt):
    """psi on an affine-normalized Jacobian point."""
    aff = _jac_to_affine(pt)
    if aff is None:
        return G2_IDENTITY
    x, y = aff
    return (_PSI_CX * x.conj(), _PSI_CY * y.conj(), FP2_ONE)


def _clear_cofactor_g2(pt):
    """Budroni-Pintore fast clearing (RFC 9380 appendix G.4) — equivalent
    to multiplying by the suite's h_eff, so KATs match the RFC vectors."""
    x = X_PARAM
    t1 = _jac_mul(pt, x)  # x * P  (x negative: mul handles the negate)
    t2 = _psi(pt)
    t3 = _psi(_psi(_jac_double(pt)))  # psi^2(2P)
    t3 = _jac_add(t3, _jac_neg(t2))
    t2 = _jac_mul(_jac_add(t1, t2), x)
    t3 = _jac_add(t3, t2)
    t3 = _jac_add(t3, _jac_neg(t1))
    return _jac_add(t3, _jac_neg(pt))


def hash_to_g2(msg: bytes, dst: bytes = DST_SIG):
    """RFC 9380 hash_to_curve for BLS12381G2_XMD:SHA-256_SSWU_RO_."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    x0, y0 = _iso3_map(*_sswu(u0))
    x1, y1 = _iso3_map(*_sswu(u1))
    q = _jac_add((x0, y0, FP2_ONE), (x1, y1, FP2_ONE))
    return _clear_cofactor_g2(q)


# --------------------------------------------------------------------------
# Optimal ate pairing


def _untwist(pt):
    """E2(Fp2) Jacobian -> E(Fp12) affine pair, or None for identity."""
    aff = _jac_to_affine(pt)
    if aff is None:
        return None
    x, y = aff
    return (fp2_embed(x) * _W_INV2, fp2_embed(y) * _W_INV3)


def _linefunc(p1, p2, t):
    """Line through p1, p2 (affine Fp12 pairs) evaluated at t; p1 == p2
    gives the tangent, a vertical line gives x_t - x_1."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        lam = (y2 - y1) * (x2 - x1).inv()
        return lam * (xt - x1) - (yt - y1)
    if y1 == y2:
        lam = (x1 * x1) * fp_embed(3) * (y1 * fp_embed(2)).inv()
        return lam * (xt - x1) - (yt - y1)
    return xt - x1


def _affine12_add(p1, p2):
    """Affine addition on E(Fp12) (None = identity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            lam = (x1 * x1) * fp_embed(3) * (y1 * fp_embed(2)).inv()
        else:
            return None
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(q, p) -> Fp12:
    """f_{|x|, q}(p) conjugated for the negative BLS parameter.

    q: G2 Jacobian point; p: G1 Jacobian point. Returns the unreduced
    pairing value (caller applies final_exponentiation)."""
    if _jac_is_identity(q) or _jac_is_identity(p):
        return FP12_ONE
    q12 = _untwist(q)
    aff = _jac_to_affine(p)
    p12 = (fp_embed(aff[0].v), fp_embed(aff[1].v))
    f = FP12_ONE
    t = q12
    n = -X_PARAM  # positive loop count
    for bit in bin(n)[3:]:  # MSB already consumed by t = q12
        f = f * f * _linefunc(t, t, p12)
        t = _affine12_add(t, t)
        if bit == "1":
            f = f * _linefunc(t, q12, p12)
            t = _affine12_add(t, q12)
    return f.conj()  # x < 0: f_{-n} ~ conj(f_n) up to final exponentiation


# Hard-part digits of (p^4 - p^2 + 1) / r in base p, derived at import.
assert (P**4 - P**2 + 1) % R == 0
_HARD_EXP = (P**4 - P**2 + 1) // R
_HARD_DIGITS: List[int] = []
_tmp = _HARD_EXP
while _tmp:
    _HARD_DIGITS.append(_tmp % P)
    _tmp //= P
del _tmp


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12 - 1) / r)."""
    # easy part: f^((p^6 - 1)(p^2 + 1))
    g = f.conj() * f.inv()
    g = g.frobenius().frobenius() * g
    # hard part: digits d_i of (p^4 - p^2 + 1)/r in base p; the p^i factors
    # become Frobenius applications (pi(m^d) = frob(m)^d = frob(m^d)).
    out = FP12_ONE
    for i, d in enumerate(_HARD_DIGITS):
        md = g.pow(d)
        for _ in range(i):
            md = md.frobenius()
        out = out * md
    return out


def pairing(p, q) -> Fp12:
    """e(p, q) for p in G1, q in G2 (full reduced pairing)."""
    return final_exponentiation(miller_loop(q, p))


def pairings_are_one(pairs: Iterable[Tuple[object, object]]) -> bool:
    """prod e(p_i, q_i) == 1, with ONE shared final exponentiation."""
    f = FP12_ONE
    for p, q in pairs:
        f = f * miller_loop(q, p)
    return final_exponentiation(f).is_one()


# --------------------------------------------------------------------------
# The signature scheme (minimal-pubkey-size, proof-of-possession)


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """draft-irtf-cfrg-bls-signature KeyGen (HKDF-SHA256)."""
    if len(ikm) < 32:
        raise ValueError("IKM must be at least 32 bytes")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    L = 48
    while True:
        salt = hashlib.sha256(salt).digest()
        prk = hmac.new(salt, ikm + b"\x00", hashlib.sha256).digest()
        okm = b""
        t = b""
        i = 1
        info = key_info + L.to_bytes(2, "big")
        while len(okm) < L:
            t = hmac.new(prk, t + info + i.to_bytes(1, "big"), hashlib.sha256).digest()
            okm += t
            i += 1
        sk = int.from_bytes(okm[:L], "big") % R
        if sk != 0:
            return sk


def sk_to_pk(sk: int) -> bytes:
    return g1_to_bytes(_jac_mul(G1_GEN, sk % R))


def sign(sk: int, msg: bytes, dst: bytes = DST_SIG) -> bytes:
    return g2_to_bytes(_jac_mul(hash_to_g2(msg, dst), sk % R))


def verify(pk_bytes: bytes, msg: bytes, sig_bytes: bytes, dst: bytes = DST_SIG) -> bool:
    pk = g1_from_bytes(pk_bytes)
    sig = g2_from_bytes(sig_bytes)
    if pk is None or sig is None or _jac_is_identity(pk):
        return False
    return pairings_are_one(
        [(_jac_neg(G1_GEN), sig), (pk, hash_to_g2(msg, dst))]
    )


def aggregate_signatures(sigs: Sequence[bytes]):
    """Aggregate 1..N signatures -> 96 compressed bytes; None on invalid
    input or an empty list (the spec rejects aggregating nothing)."""
    if not sigs:
        return None
    acc = G2_IDENTITY
    for s in sigs:
        pt = g2_from_bytes(s)
        if pt is None:
            return None
        acc = _jac_add(acc, pt)
    return g2_to_bytes(acc)


def aggregate_pubkeys(pks: Sequence[bytes]):
    """Aggregate public keys -> G1 Jacobian point; None on invalid input."""
    acc = G1_IDENTITY
    for k in pks:
        pt = g1_from_bytes(k)
        if pt is None or _jac_is_identity(pt):
            return None
        acc = _jac_add(acc, pt)
    return acc


def fast_aggregate_verify(
    pks: Sequence[bytes], msg: bytes, sig_bytes: bytes, dst: bytes = DST_SIG
) -> bool:
    """All signers signed the SAME msg: one pairing check against the
    aggregate pubkey. Callers MUST have verified each key's PoP (rogue-key
    defense); crypto/keys.register_pop enforces that at the framework layer."""
    if not pks:
        return False
    apk = aggregate_pubkeys(pks)
    sig = g2_from_bytes(sig_bytes)
    if apk is None or sig is None:
        return False
    return pairings_are_one([(_jac_neg(G1_GEN), sig), (apk, hash_to_g2(msg, dst))])


def aggregate_verify(
    pks: Sequence[bytes], msgs: Sequence[bytes], sig_bytes: bytes, dst: bytes = DST_SIG
) -> bool:
    """Distinct messages: n+1 pairings, one shared final exponentiation.
    Messages must be DISTINCT per the core spec when PoP is not used; the
    framework only calls this on the PoP-registered path, so duplicate
    messages are allowed (AggregateVerify in the PoP ciphersuite)."""
    if not pks or len(pks) != len(msgs):
        return False
    sig = g2_from_bytes(sig_bytes)
    if sig is None:
        return False
    pairs = [(_jac_neg(G1_GEN), sig)]
    for pk_b, m in zip(pks, msgs):
        pk = g1_from_bytes(pk_b)
        if pk is None or _jac_is_identity(pk):
            return False
        pairs.append((pk, hash_to_g2(m, dst)))
    return pairings_are_one(pairs)


def pop_prove(sk: int) -> bytes:
    """Proof of possession: sign your own pubkey bytes under the POP DST."""
    return sign(sk, sk_to_pk(sk), DST_POP)


def pop_verify(pk_bytes: bytes, proof: bytes) -> bool:
    return verify(pk_bytes, pk_bytes, proof, DST_POP)


def gen_sk(seed: Optional[bytes] = None) -> int:
    return keygen(seed if seed is not None else os.urandom(32))
