"""ASCII armor + passphrase-encrypted private keys: the port's copy of
tendermint_tpu/crypto/armor.py, the same armor and ciphertext format.

reference: crypto/armor (armor.go — RFC-4880-style armored blocks) and
crypto/xsalsa20symmetric + the keys armoring in the SDK: encrypt with a key
derived from a passphrase, armor the ciphertext. Cipher here is IETF
ChaCha20-Poly1305 with a random 96-bit nonce — safe because every encryption
derives a FRESH key from a fresh salt (the reference tree ships
crypto/xchacha20poly1305; extended nonces buy nothing under per-use keys);
KDF is scrypt with ALL cost parameters (n, r, p) carried in the armor
headers so they can evolve without breaking old files.
"""

from __future__ import annotations

import base64
import os
from typing import Dict, Tuple

from cryptography.exceptions import InvalidTag
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.scrypt import Scrypt

ARMOR_START = "-----BEGIN TENDERMINT {}-----"
ARMOR_END = "-----END TENDERMINT {}-----"

# scrypt cost parameters (interactive-login grade)
_SCRYPT_N = 1 << 15
_SCRYPT_R = 8
_SCRYPT_P = 1


class ArmorError(Exception):
    pass


def encode_armor(block_type: str, headers: Dict[str, str], data: bytes) -> str:
    """reference: crypto/armor/armor.go EncodeArmor."""
    lines = [ARMOR_START.format(block_type)]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    b64 = base64.b64encode(data).decode()
    lines.extend(b64[i : i + 64] for i in range(0, len(b64), 64))
    lines.append(ARMOR_END.format(block_type))
    return "\n".join(lines) + "\n"


def decode_armor(text: str) -> Tuple[str, Dict[str, str], bytes]:
    """reference: crypto/armor/armor.go DecodeArmor."""
    lines = [l.strip() for l in text.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN TENDERMINT "):
        raise ArmorError("missing armor start line")
    block_type = lines[0][len("-----BEGIN TENDERMINT ") : -len("-----")]
    if lines[-1] != ARMOR_END.format(block_type):
        raise ArmorError("missing or mismatched armor end line")
    headers: Dict[str, str] = {}
    body_start = 1
    for i, line in enumerate(lines[1:-1], start=1):
        if not line:
            body_start = i + 1
            break
        if ":" not in line:
            body_start = i
            break
        k, _, v = line.partition(":")
        headers[k.strip()] = v.strip()
    else:
        body_start = len(lines) - 1
    try:
        data = base64.b64decode("".join(lines[body_start:-1]))
    except Exception as e:
        raise ArmorError(f"bad armor body: {e}") from e
    return block_type, headers, data


_SCRYPT_N_MAX = 1 << 21  # ~256MB with r=8: DoS ceiling for untrusted armor


def _derive(passphrase: str, salt: bytes, n: int, r: int, p: int) -> bytes:
    return Scrypt(salt=salt, length=32, n=n, r=r, p=p).derive(passphrase.encode())


def encrypt_armor_priv_key(priv_key_bytes: bytes, passphrase: str,
                           key_type: str = "ed25519") -> str:
    """Armored, passphrase-encrypted private key
    (reference: the SDK's EncryptArmorPrivKey over crypto/armor)."""
    salt = os.urandom(16)
    nonce = os.urandom(12)
    key = _derive(passphrase, salt, _SCRYPT_N, _SCRYPT_R, _SCRYPT_P)
    ct = ChaCha20Poly1305(key).encrypt(nonce, priv_key_bytes, None)
    headers = {
        "kdf": "scrypt",
        "n": str(_SCRYPT_N),
        "r": str(_SCRYPT_R),
        "p": str(_SCRYPT_P),
        "salt": salt.hex().upper(),
        "nonce": nonce.hex().upper(),
        "type": key_type,
    }
    return encode_armor("PRIVATE KEY", headers, ct)


def unarmor_decrypt_priv_key(armor_text: str, passphrase: str) -> Tuple[bytes, str]:
    """Returns (priv_key_bytes, key_type). Raises ArmorError on a wrong
    passphrase or tampered armor."""
    block_type, headers, ct = decode_armor(armor_text)
    if block_type != "PRIVATE KEY":
        raise ArmorError(f"unexpected armor type {block_type!r}")
    if headers.get("kdf") != "scrypt":
        raise ArmorError(f"unsupported KDF {headers.get('kdf')!r}")
    try:
        salt = bytes.fromhex(headers["salt"])
        nonce = bytes.fromhex(headers["nonce"])
        n = int(headers.get("n", _SCRYPT_N))
        r = int(headers.get("r", _SCRYPT_R))
        p = int(headers.get("p", _SCRYPT_P))
    except (KeyError, ValueError) as e:
        raise ArmorError(f"bad armor headers: {e}") from e
    # validate untrusted parameters BEFORE deriving: a hostile armor file
    # must not be able to demand gigabytes of scrypt memory or smuggle a
    # ValueError past the ArmorError contract
    if not (1 < n <= _SCRYPT_N_MAX) or n & (n - 1):
        raise ArmorError(f"scrypt n {n} out of range or not a power of two")
    if not (0 < r <= 32 and 0 < p <= 16):
        raise ArmorError(f"scrypt r/p out of range: r={r} p={p}")
    if len(nonce) != 12 or len(salt) != 16:
        raise ArmorError("bad salt/nonce length")
    key = _derive(passphrase, salt, n, r, p)
    try:
        pt = ChaCha20Poly1305(key).decrypt(nonce, ct, None)
    except InvalidTag:
        raise ArmorError("wrong passphrase or corrupted armor") from None
    return pt, headers.get("type", "ed25519")
