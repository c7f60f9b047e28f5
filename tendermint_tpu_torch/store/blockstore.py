"""BlockStore: blocks as meta + parts + commits in a kv-db
(reference: store/store.go:33).

Keys: H:<height> header/meta, P:<height>:<index> parts, C:<height> commit,
SC:<height> seen commit, plus base/height bookkeeping. Pruning mirrors
PruneBlocks (reference: store/store.go:228).

The port's copy of tendermint_tpu/store/blockstore.py, the same encodings byte for byte.
"""

from __future__ import annotations

import struct
from typing import Optional

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.part_set import Part, PartSet


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + struct.pack(">q", height)


class BlockStore:
    def __init__(self, db: KVDB):
        self.db = db

    # -- bookkeeping --------------------------------------------------------

    @property
    def base(self) -> int:
        raw = self.db.get(b"BS:base")
        return struct.unpack(">q", raw)[0] if raw else 0

    @property
    def height(self) -> int:
        raw = self.db.get(b"BS:height")
        return struct.unpack(">q", raw)[0] if raw else 0

    def size(self) -> int:
        h = self.height
        return 0 if h == 0 else h - self.base + 1

    # -- saving -------------------------------------------------------------

    def save_block(self, block: Block, parts: PartSet, seen_commit: Commit) -> None:
        """(reference: store/store.go:311 SaveBlock)"""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        height = block.header.height
        expected = self.height + 1
        if self.height > 0 and height != expected:
            raise ValueError(f"BlockStore can only save contiguous blocks. Wanted {expected}, got {height}")
        if not parts.is_complete():
            raise ValueError("BlockStore can only save complete block part sets")

        sets = []
        block_id = BlockID(block.hash(), parts.header)
        meta = pw.Writer()
        meta.message_field(1, block_id.encode(), always=True)
        meta.varint_field(2, parts.total)
        sets.append((_hkey(b"BS:meta:", height), meta.bytes()))
        for i in range(parts.total):
            sets.append((_hkey(b"BS:part:", height) + struct.pack(">I", i), parts.get_part(i).encode()))
        sets.append((_hkey(b"BS:block:", height), block.encode()))
        sets.append((_hkey(b"BS:commit:", height - 1), block.last_commit.encode()))
        sets.append((_hkey(b"BS:seen_commit:", height), seen_commit.encode()))
        sets.append((b"BS:height", struct.pack(">q", height)))
        if self.base == 0:
            sets.append((b"BS:base", struct.pack(">q", height)))
        self.db.write_batch(sets)

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self.db.set(_hkey(b"BS:seen_commit:", height), commit.encode())

    # -- loading ------------------------------------------------------------

    def load_block(self, height: int) -> Optional[Block]:
        raw = self.db.get(_hkey(b"BS:block:", height))
        return Block.decode(raw) if raw else None

    def load_block_meta(self, height: int) -> Optional[tuple]:
        """Returns (BlockID, total_parts) or None."""
        raw = self.db.get(_hkey(b"BS:meta:", height))
        if not raw:
            return None
        block_id = BlockID()
        total = 0
        for f, _, v in pw.Reader(raw):
            if f == 1:
                block_id = BlockID.decode(v)
            elif f == 2:
                total = v
        return block_id, total

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self.db.get(_hkey(b"BS:part:", height) + struct.pack(">I", index))
        return Part.decode(raw) if raw else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The commit FOR block at `height` (stored with block height+1)."""
        raw = self.db.get(_hkey(b"BS:commit:", height))
        return Commit.decode(raw) if raw else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self.db.get(_hkey(b"BS:seen_commit:", height))
        return Commit.decode(raw) if raw else None

    def load_block_by_hash(self, block_hash: bytes) -> Optional[Block]:
        # Linear scan over metas would be slow; maintain a hash index lazily.
        raw = self.db.get(b"BS:hash:" + block_hash)
        if raw:
            return self.load_block(struct.unpack(">q", raw)[0])
        for h in range(self.base, self.height + 1):
            meta = self.load_block_meta(h)
            if meta and meta[0].hash == block_hash:
                self.db.set(b"BS:hash:" + block_hash, struct.pack(">q", h))
                return self.load_block(h)
        return None

    # -- pruning ------------------------------------------------------------

    def prune_blocks(self, retain_height: int) -> int:
        """Removes blocks below retain_height; returns number pruned
        (reference: store/store.go:228)."""
        if retain_height <= 0:
            raise ValueError("height must be greater than 0")
        if retain_height > self.height:
            raise ValueError("cannot prune beyond the latest height")
        base = self.base
        if retain_height < base:
            return 0
        pruned = 0
        deletes = []
        for h in range(base, retain_height):
            meta = self.load_block_meta(h)
            if meta is None:
                continue
            deletes.append(_hkey(b"BS:meta:", h))
            deletes.append(_hkey(b"BS:block:", h))
            deletes.append(_hkey(b"BS:commit:", h - 1))
            deletes.append(_hkey(b"BS:seen_commit:", h))
            for i in range(meta[1]):
                deletes.append(_hkey(b"BS:part:", h) + struct.pack(">I", i))
            pruned += 1
        self.db.write_batch([(b"BS:base", struct.pack(">q", retain_height))], deletes)
        return pruned
