"""Ed25519 keys (the only key type of this slice).

Addresses are the first 20 bytes of SHA-256 of the raw public key
(reference: crypto/crypto.go). Signing runs the pure-Python RFC 8032 code in
crypto/ed25519_ref.py; verification is crypto/batch.verify_batch.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519_ref, tmhash

ED25519_KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # seed
SIGNATURE_SIZE = 64


@dataclass(frozen=True)
class Ed25519PubKey:
    key_bytes: bytes

    def __post_init__(self):
        if len(self.key_bytes) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")

    def address(self) -> bytes:
        return tmhash.sum_truncated(self.key_bytes)

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

