"""Signed-transaction envelope: the wire format behind device-batched
CheckTx admission (crypto/scheduler.py admission lane).

The reference leaves tx authentication entirely to the application —
which is exactly why every CheckTx pays a serial, app-side signature
verify. The envelope makes the signature NODE-VISIBLE: the mempool can
decode it, batch-verify thousands of admissions in one device flush, and
hand the app the verdict (`RequestCheckTx.sig_precheck`) instead of the
work. Applications stay sovereign: an app may ignore the verdict and
re-verify, and txs that don't parse as envelopes flow through untouched
(`sig_precheck` stays NONE).

Layout (single ed25519 signer, versioned magic):

    b"stx1" | pubkey(32) | signature(64) | payload...

The signature covers a domain-separated message — `SIGN_PREFIX + payload`
— so a tx signature can never be replayed as a vote/proposal signature or
vice versa (those sign canonical protos with their own prefixes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

MAGIC = b"stx1"
PUBKEY_LEN = 32
SIG_LEN = 64
HEADER_LEN = len(MAGIC) + PUBKEY_LEN + SIG_LEN

# domain separation: a signed-tx signature verifies ONLY as a signed-tx
SIGN_PREFIX = b"tendermint_tpu/signed-tx/v1\x00"


class SignedTx(NamedTuple):
    pubkey: bytes     # ed25519, 32 bytes
    signature: bytes  # 64 bytes
    payload: bytes    # the application-level tx body

    @property
    def sign_bytes(self) -> bytes:
        return SIGN_PREFIX + self.payload


def encode_signed_tx(priv, payload: bytes) -> bytes:
    """Wrap `payload` in a signed envelope under `priv` (crypto/keys
    PrivKey: needs .pub_key().bytes() and .sign())."""
    payload = bytes(payload)
    sig = priv.sign(SIGN_PREFIX + payload)
    return MAGIC + priv.pub_key().bytes() + bytes(sig) + payload


def decode_signed_tx(tx: bytes) -> Optional[SignedTx]:
    """Parse an envelope; None when `tx` is not one (wrong magic / too
    short) — the caller treats those as plain opaque txs."""
    if len(tx) < HEADER_LEN or tx[: len(MAGIC)] != MAGIC:
        return None
    off = len(MAGIC)
    pubkey = bytes(tx[off : off + PUBKEY_LEN])
    off += PUBKEY_LEN
    sig = bytes(tx[off : off + SIG_LEN])
    off += SIG_LEN
    return SignedTx(pubkey, sig, bytes(tx[off:]))


def verify_signed_tx(stx: SignedTx) -> bool:
    """Serial host verification of one envelope — the baseline the
    admission lane replaces (used by apps when no precheck verdict rode
    the request, and so by the serial arm of chip_smoke.py's tx_admission)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey

    try:
        return Ed25519PubKey(stx.pubkey).verify(stx.sign_bytes, stx.signature)
    except ValueError:
        return False
