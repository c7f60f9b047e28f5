"""Ed25519 and BLS12-381 keys, and the BLS proof-of-possession registry.

The port's copy of tendermint_tpu/crypto/keys.py for the two key types it
verifies. Addresses are the first 20 bytes of SHA-256 of the raw public key
(reference: crypto/crypto.go). Ed25519 signing runs the pure-Python RFC 8032
code in crypto/ed25519_ref.py and verification is crypto/batch.verify_batch;
BLS keys (48-byte compressed G1, the minimal-pubkey-size PoP ciphersuite)
run crypto/bls_ref.py and are verified in aggregate by
ValidatorSet.verify_aggregate_commit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519_ref, tmhash

ED25519_KEY_TYPE = "ed25519"
SR25519_KEY_TYPE = "sr25519"
BLS12_381_KEY_TYPE = "bls12_381"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # seed
SIGNATURE_SIZE = 64
BLS_PUBKEY_SIZE = 48  # compressed G1
BLS_SIGNATURE_SIZE = 96  # compressed G2

_P25519 = 2**255 - 19


def address_from_pubkey_bytes(pubkey_bytes: bytes) -> bytes:
    return tmhash.sum_truncated(pubkey_bytes)


def _canonical_y(enc: bytes) -> bool:
    """True iff the 32-byte point encoding's y (sign bit stripped) is < p."""
    return (int.from_bytes(enc, "little") & ((1 << 255) - 1)) < _P25519


@dataclass(frozen=True)
class Ed25519PubKey:
    key_bytes: bytes

    def __post_init__(self):
        if len(self.key_bytes) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")

    def address(self) -> bytes:
        return address_from_pubkey_bytes(self.key_bytes)

    def bytes(self) -> bytes:
        return self.key_bytes

    def type_name(self) -> str:
        return ED25519_KEY_TYPE


@dataclass(frozen=True, repr=False)
class Ed25519PrivKey:
    seed: bytes

    def __repr__(self) -> str:  # never print private key material
        return "Ed25519PrivKey(<redacted>)"

    def __post_init__(self):
        if len(self.seed) != PRIVKEY_SIZE:
            raise ValueError(f"ed25519 privkey seed must be {PRIVKEY_SIZE} bytes")

    def bytes(self) -> bytes:
        return self.seed

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self.seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(ed25519_ref.public_key(self.seed))

    def type_name(self) -> str:
        return ED25519_KEY_TYPE



# ---------------------------------------------------------------------------
# BLS12-381 (aggregate commits; crypto/bls_ref.py)


@dataclass(frozen=True)
class Bls12381PubKey:
    """48-byte compressed G1 public key. Subgroup membership is enforced at
    validator ingestion (pubkey_from_type_and_bytes)."""

    key_bytes: bytes

    def __post_init__(self):
        if len(self.key_bytes) != BLS_PUBKEY_SIZE:
            raise ValueError(f"bls12_381 pubkey must be {BLS_PUBKEY_SIZE} bytes")

    def address(self) -> bytes:
        return address_from_pubkey_bytes(self.key_bytes)

    def bytes(self) -> bytes:
        return self.key_bytes

    def verify(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != BLS_SIGNATURE_SIZE:
            return False
        from tendermint_tpu_torch.crypto import bls_ref

        return bls_ref.verify(self.key_bytes, msg, sig)

    def type_name(self) -> str:
        return BLS12_381_KEY_TYPE


@dataclass(frozen=True, repr=False)
class Bls12381PrivKey:
    seed: bytes  # >= 32-byte IKM for the spec KeyGen

    def __repr__(self) -> str:  # never print private key material
        return "Bls12381PrivKey(<redacted>)"

    def __post_init__(self):
        if len(self.seed) < 32:
            raise ValueError("bls12_381 privkey seed must be >= 32 bytes")

    @property
    def _sk(self) -> int:
        from tendermint_tpu_torch.crypto import bls_ref

        return bls_ref.keygen(self.seed)

    def bytes(self) -> bytes:
        return self.seed

    def sign(self, msg: bytes) -> bytes:
        from tendermint_tpu_torch.crypto import bls_ref

        return bls_ref.sign(self._sk, msg)

    def pub_key(self) -> Bls12381PubKey:
        from tendermint_tpu_torch.crypto import bls_ref

        return Bls12381PubKey(bls_ref.sk_to_pk(self._sk))

    def pop_prove(self) -> bytes:
        """Proof of possession for rogue-key-safe aggregation."""
        from tendermint_tpu_torch.crypto import bls_ref

        return bls_ref.pop_prove(self._sk)

    def type_name(self) -> str:
        return BLS12_381_KEY_TYPE


def gen_bls12_381(seed: bytes | None = None) -> Bls12381PrivKey:
    return Bls12381PrivKey(seed if seed is not None else os.urandom(32))


# Proof-of-possession registry, the rogue-key defense: an aggregate commit
# folds a BLS key only after its PoP was verified here (at validator
# ingestion). Process-global.
_POP_VERIFIED: set = set()


def register_pop(pubkey_bytes: bytes, proof: bytes) -> bool:
    """Verify and record a proof of possession; False (not raised) on a bad
    proof."""
    from tendermint_tpu_torch.crypto import bls_ref

    if bytes(pubkey_bytes) in _POP_VERIFIED:
        return True
    if not bls_ref.pop_verify(bytes(pubkey_bytes), bytes(proof)):
        return False
    _POP_VERIFIED.add(bytes(pubkey_bytes))
    return True


def pop_verified(pubkey_bytes: bytes) -> bool:
    return bytes(pubkey_bytes) in _POP_VERIFIED


def clear_pop_registry() -> None:
    _POP_VERIFIED.clear()


def pubkey_from_type_and_bytes(type_name: str, data: bytes):
    """Validator-ingestion entry point: non-canonical ed25519 encodings
    (y >= p) and BLS keys that are not a valid, in-subgroup, non-identity
    compressed G1 point are rejected."""
    if type_name == ED25519_KEY_TYPE:
        if len(data) == PUBKEY_SIZE and not _canonical_y(data):
            raise ValueError("non-canonical ed25519 pubkey encoding (y >= p)")
        return Ed25519PubKey(data)
    if type_name == SR25519_KEY_TYPE:
        raise ValueError("sr25519 keys are not ported yet (a later slice of the port)")
    if type_name == BLS12_381_KEY_TYPE:
        from tendermint_tpu_torch.crypto import bls_ref

        pt = bls_ref.g1_from_bytes(data)
        if pt is None or bls_ref._jac_is_identity(pt):
            raise ValueError("invalid bls12_381 pubkey (encoding/subgroup)")
        return Bls12381PubKey(data)
    raise ValueError(f"unknown pubkey type {type_name!r}")
