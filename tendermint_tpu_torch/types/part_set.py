"""Block parts: 65,536-byte chunks of an encoded block, each with a Merkle
proof against the part set's header hash.

The port's copy of tendermint_tpu/types/part_set.py (reference
types/part_set.go): `Part` with its codec, and `PartSet`, complete
(`from_data`) or filled part by part (`add_part` checks each proof) and
then `assemble`d. A block's ID is BlockID(block.hash(), parts.header).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import BLOCK_PART_SIZE_BYTES, PartSetHeader


@dataclass(frozen=True)
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part bytes too big")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.index)
        w.bytes_field(2, self.bytes_)
        p = pw.Writer()
        p.varint_field(1, self.proof.total)
        p.varint_field(2, self.proof.index)
        p.bytes_field(3, self.proof.leaf_hash)
        for aunt in self.proof.aunts:
            p.bytes_field(4, aunt)
        w.message_field(3, p.bytes(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        index, body = 0, b""
        total = pidx = 0
        leaf = b""
        aunts: List[bytes] = []
        for f, _, v in pw.Reader(data):
            if f == 1:
                index = v
            elif f == 2:
                body = v
            elif f == 3:
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        total = vv
                    elif ff == 2:
                        pidx = vv
                    elif ff == 3:
                        leaf = vv
                    elif ff == 4:
                        aunts.append(vv)
        return cls(index, body, merkle.Proof(total, pidx, leaf, aunts))


class PartSet:
    """Complete (from data) or incomplete (from a header, filled by add_part)."""

    def __init__(self, header: PartSetHeader):
        header.validate_basic()  # bounds the total before the allocation below
        self._header = header
        self._parts: List[Optional[Part]] = [None] * header.total
        self._count = 0
        self._byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """(reference types/part_set.go:150 NewPartSetFromData)"""
        chunks = [data[i:i + part_size] for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps._parts[i] = Part(i, chunk, proof)
        ps._count = len(chunks)
        ps._byte_size = len(data)
        return ps

    @property
    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, header: PartSetHeader) -> bool:
        return self._header == header

    @property
    def total(self) -> int:
        return self._header.total

    @property
    def count(self) -> int:
        return self._count

    @property
    def byte_size(self) -> int:
        return self._byte_size

    def is_complete(self) -> bool:
        return self._count == self._header.total

    def get_part(self, index: int) -> Optional[Part]:
        return self._parts[index] if 0 <= index < len(self._parts) else None

    def bit_array(self) -> List[bool]:
        return [p is not None for p in self._parts]

    def add_part(self, part: Part) -> bool:
        """Check the part's proof against the header hash and add it; True
        if it was new (reference types/part_set.go:276 AddPart)."""
        if part.index >= self._header.total:
            raise ValueError("error part set unexpected index")
        if self._parts[part.index] is not None:
            return False
        if part.proof.index != part.index or part.proof.total != self._header.total:
            raise ValueError("error part set invalid proof structure")
        if not part.proof.verify(self._header.hash, part.bytes_):
            raise ValueError("error part set invalid proof")
        self._parts[part.index] = part
        self._count += 1
        self._byte_size += len(part.bytes_)
        return True

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise ValueError("part set incomplete")
        return b"".join(p.bytes_ for p in self._parts)
