"""Trusted light-block store: the port's copy of tendermint_tpu/light/store.py
(reference light/store/store.go, light/store/db/db.go: ordered heights,
size-bounded pruning).

Blocks persist as light_block_to_bytes JSON under big-endian height keys.
`_heights` is guarded by an RLock, so a reader never sees a half-applied
insert or removal (the reference wraps its db in a mutex,
light/store/db/db.go:25)."""

from __future__ import annotations

import bisect
import struct
import threading
from typing import List, Optional

from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.types.light import (
    LightBlock,
    light_block_from_bytes,
    light_block_to_bytes,
)

_LB_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _LB_PREFIX + struct.pack(">Q", height)


class LightStore:
    """Stores verified light blocks keyed by big-endian height so prefix
    iteration yields ascending order (reference: light/store/db/db.go:33)."""

    def __init__(self, db: KVDB):
        self.db = db
        self._lock = threading.RLock()
        self._heights: List[int] = [
            struct.unpack(">Q", k[len(_LB_PREFIX):])[0]
            for k, _ in db.iterate_prefix(_LB_PREFIX)
        ]
        self._heights.sort()

    def save_light_block(self, lb: LightBlock) -> None:
        """reference: light/store/db/db.go:52 SaveLightBlock."""
        if lb.height <= 0:
            raise ValueError("height <= 0")
        with self._lock:
            i = bisect.bisect_left(self._heights, lb.height)
            if i == len(self._heights) or self._heights[i] != lb.height:
                self._heights.insert(i, lb.height)
            self.db.set(_key(lb.height), light_block_to_bytes(lb))

    def light_block(self, height: int) -> Optional[LightBlock]:
        """reference: light/store/db/db.go:96 LightBlock."""
        raw = self.db.get(_key(height))
        return light_block_from_bytes(raw) if raw is not None else None

    def latest_light_block(self) -> Optional[LightBlock]:
        """reference: light/store/db/db.go:126 LightBlockBefore/latest."""
        with self._lock:
            h = self._heights[-1] if self._heights else None
        return self.light_block(h) if h is not None else None

    def first_light_block(self) -> Optional[LightBlock]:
        with self._lock:
            h = self._heights[0] if self._heights else None
        return self.light_block(h) if h is not None else None

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        """Latest stored block strictly below height
        (reference: light/store/db/db.go:126)."""
        with self._lock:
            i = bisect.bisect_left(self._heights, height)
            if i == 0:
                return None
            h = self._heights[i - 1]
        return self.light_block(h)

    def delete_light_block(self, height: int) -> None:
        with self._lock:
            self.db.delete(_key(height))
            try:
                self._heights.remove(height)
            except ValueError:
                pass

    def prune(self, size: int) -> None:
        """Keep only the newest `size` blocks (reference: light/store/db/db.go:152)."""
        with self._lock:
            while len(self._heights) > size:
                self.delete_light_block(self._heights[0])

    def size(self) -> int:
        with self._lock:
            return len(self._heights)

    def heights(self) -> List[int]:
        with self._lock:
            return list(self._heights)
