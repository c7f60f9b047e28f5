"""Generalized merkle proof operators: the port's copy of
tendermint_tpu/crypto/proof_ops.py, whole, on the port's crypto/merkle.py.

The reference's crypto/merkle/proof_op.go + proof_value.go + proof_key_path.go:
a chain of proof operators each mapping a value (or sub-root) to the next
root, keyed by a /-separated key path, verified top-down against a trusted
root hash (the header's app_hash in the light client's abci_query path,
light/rpc/client.go:116).

Wire format follows the reference's protobuf shapes so proofs interop:
  ProofOp  { string type = 1; bytes key = 2; bytes data = 3; }
  ProofOps { repeated ProofOp ops = 1; }
  ValueOp.data = ValueOp { bytes key = 1; Proof proof = 2; }
  Proof    { int64 total = 1; int64 index = 2; bytes leaf_hash = 3;
             repeated bytes aunts = 4; }
"""

from __future__ import annotations

import hashlib
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from tendermint_tpu_torch.crypto.merkle import Proof, leaf_hash, proofs_from_byte_slices
from tendermint_tpu_torch.libs.protowire import Reader, Writer, encode_varint

PROOF_OP_VALUE = "simple:v"


# ---------------------------------------------------------------- key paths


KEY_ENCODING_URL = 0
KEY_ENCODING_HEX = 1


class KeyPath:
    """/-separated key path; hex-encoded segments use an "x:" prefix
    (reference: crypto/merkle/proof_key_path.go)."""

    def __init__(self) -> None:
        self._keys: List[tuple] = []

    def append_key(self, key: bytes, enc: int = KEY_ENCODING_URL) -> "KeyPath":
        self._keys.append((bytes(key), enc))
        return self

    def __str__(self) -> str:
        out = []
        for key, enc in self._keys:
            if enc == KEY_ENCODING_URL:
                # quote() on raw bytes percent-encodes each byte directly
                # (%FF for 0xFF), matching Go's url.PathEscape byte-wise
                # escaping; decoding via a str round-trip would re-encode
                # high bytes as UTF-8 (%C3%BF) and break interop.
                out.append("/" + urllib.parse.quote(key, safe=""))
            elif enc == KEY_ENCODING_HEX:
                out.append("/x:" + key.hex())
            else:
                raise ValueError(f"unknown key encoding {enc}")
        return "".join(out)


def key_path_to_keys(path: str) -> List[bytes]:
    """Decode a key path into raw key bytes, leftmost first."""
    if not path or path[0] != "/":
        raise ValueError("key path string must start with a forward slash '/'")
    parts = path[1:].split("/")
    keys = []
    for part in parts:
        if part.startswith("x:"):
            keys.append(bytes.fromhex(part[2:]))
        else:
            keys.append(urllib.parse.unquote_to_bytes(part))
    return keys


# ---------------------------------------------------------------- wire types


@dataclass
class ProofOp:
    type: str
    key: bytes
    data: bytes

    def encode(self) -> bytes:
        w = Writer()
        w.string_field(1, self.type)
        w.bytes_field(2, self.key)
        w.bytes_field(3, self.data)
        return w.bytes()

    @classmethod
    def decode(cls, raw: bytes) -> "ProofOp":
        type_, key, data = "", b"", b""
        for fnum, wt, val in Reader(raw):
            if fnum == 1:
                type_ = val.decode()
            elif fnum == 2:
                key = val
            elif fnum == 3:
                data = val
        return cls(type_, key, data)


def encode_proof(p: Proof) -> bytes:
    w = Writer()
    w.varint_field(1, p.total)
    w.varint_field(2, p.index, emit_zero=False)
    w.bytes_field(3, p.leaf_hash)
    for a in p.aunts:
        w.bytes_field(4, a, emit_empty=True)
    return w.bytes()


def decode_proof(raw: bytes) -> Proof:
    total = index = 0
    lh = b""
    aunts: List[bytes] = []
    for fnum, wt, val in Reader(raw):
        if fnum == 1:
            total = int(val)
        elif fnum == 2:
            index = int(val)
        elif fnum == 3:
            lh = val
        elif fnum == 4:
            aunts.append(val)
    return Proof(total=total, index=index, leaf_hash=lh, aunts=aunts)


def encode_proof_ops(ops: Sequence[ProofOp]) -> bytes:
    w = Writer()
    for op in ops:
        w.message_field(1, op.encode())
    return w.bytes()


def decode_proof_ops(raw: bytes) -> List[ProofOp]:
    return [ProofOp.decode(val) for fnum, _, val in Reader(raw) if fnum == 1]


# ---------------------------------------------------------------- operators


def _encode_byte_slice(b: bytes) -> bytes:
    return encode_varint(len(b)) + b


class ValueOp:
    """Proves value-under-key inside a simple-merkle KV tree; leaf =
    leafHash(encode(key) || encode(sha256(value)))
    (reference: crypto/merkle/proof_value.go Run)."""

    def __init__(self, key: bytes, proof: Proof):
        self.key = bytes(key)
        self.proof = proof

    def get_key(self) -> bytes:
        return self.key

    def run(self, args: List[bytes]) -> List[bytes]:
        if len(args) != 1:
            raise ValueError(f"expected 1 arg, got {len(args)}")
        vhash = hashlib.sha256(args[0]).digest()
        kvbytes = _encode_byte_slice(self.key) + _encode_byte_slice(vhash)
        kvhash = leaf_hash(kvbytes)
        if kvhash != self.proof.leaf_hash:
            raise ValueError(
                f"leaf hash mismatch: want {self.proof.leaf_hash.hex()} "
                f"got {kvhash.hex()}"
            )
        root = self.proof.compute_root_hash()
        if root is None:
            raise ValueError("invalid proof shape")
        return [root]

    def proof_op(self) -> ProofOp:
        w = Writer()
        w.bytes_field(1, self.key)
        w.message_field(2, encode_proof(self.proof))
        return ProofOp(PROOF_OP_VALUE, self.key, w.bytes())

    @classmethod
    def from_proof_op(cls, pop: ProofOp) -> "ValueOp":
        if pop.type != PROOF_OP_VALUE:
            raise ValueError(f"unexpected ProofOp.type: {pop.type!r}")
        key, proof = b"", None
        for fnum, wt, val in Reader(pop.data):
            if fnum == 1:
                key = val
            elif fnum == 2:
                proof = decode_proof(val)
        if proof is None:
            raise ValueError("ValueOp.data missing proof")
        return cls(pop.key or key, proof)


# ---------------------------------------------------------------- runtime


class ProofRuntime:
    """Decoder registry + top-level verify (crypto/merkle/proof_op.go:80)."""

    def __init__(self) -> None:
        self._decoders: Dict[str, Callable[[ProofOp], object]] = {}

    def register_op_decoder(self, type_: str, dec: Callable[[ProofOp], object]) -> None:
        if type_ in self._decoders:
            raise ValueError(f"already registered for type {type_}")
        self._decoders[type_] = dec

    def decode(self, pop: ProofOp):
        dec = self._decoders.get(pop.type)
        if dec is None:
            raise ValueError(f"unrecognized proof type {pop.type!r}")
        return dec(pop)

    def verify_value(self, ops: Sequence[ProofOp], root: bytes, keypath: str,
                     value: bytes) -> None:
        self.verify(ops, root, keypath, [value])

    def verify_absence(self, ops: Sequence[ProofOp], root: bytes, keypath: str) -> None:
        self.verify(ops, root, keypath, [])

    def verify(self, ops: Sequence[ProofOp], root: bytes, keypath: str,
               args: List[bytes]) -> None:
        """Run operators bottom-up, consuming keypath right-to-left; the last
        output must equal the trusted root (proof_op.go:39 Verify)."""
        keys = key_path_to_keys(keypath)
        operators = [self.decode(pop) for pop in ops]
        for i, op in enumerate(operators):
            key = op.get_key()
            if key:
                if not keys:
                    raise ValueError(
                        f"key path has insufficient parts: expected no more "
                        f"keys but got {key!r}"
                    )
                if keys[-1] != key:
                    raise ValueError(
                        f"key mismatch on operation #{i}: expected "
                        f"{keys[-1]!r} but got {key!r}"
                    )
                keys = keys[:-1]
            args = op.run(args)
        if not args or args[0] != root:
            raise ValueError(
                f"calculated root hash is invalid: expected {root.hex()} "
                f"but got {args[0].hex() if args else None}"
            )
        if keys:
            raise ValueError("keypath not fully consumed")


def default_proof_runtime() -> ProofRuntime:
    prt = ProofRuntime()
    prt.register_op_decoder(PROOF_OP_VALUE, ValueOp.from_proof_op)
    return prt


# ------------------------------------------------------------- simple map


def simple_map_proofs(kv: Dict[bytes, bytes]):
    """Root hash + per-key ValueOp over a sorted KV map — the SimpleMap tree
    ValueOp verifies against (crypto/merkle/proof_value.go:14). Returns
    (root_hash, {key: ValueOp})."""
    keys = sorted(kv)
    leaves = [
        _encode_byte_slice(k) + _encode_byte_slice(hashlib.sha256(kv[k]).digest())
        for k in keys
    ]
    root, proofs = proofs_from_byte_slices(leaves)
    return root, {k: ValueOp(k, proofs[i]) for i, k in enumerate(keys)}
