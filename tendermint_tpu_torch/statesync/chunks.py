"""Chunk queue for the snapshot being restored.

reference: statesync/chunks.go — chunk (:20), chunkQueue (:27), Add (:85),
Allocate (:117), Next (:193), Retry (:221), DiscardSender (:160).

The reference spools chunks to temp files; chunks here are small enough for
the in-memory dict (the ABCI chunk-size cap is 16MB either way).

The port's copy of tendermint_tpu/statesync/chunks.py.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Set

from tendermint_tpu_torch.statesync.snapshots import Snapshot


class ChunkQueueClosed(Exception):
    pass


class Chunk:
    __slots__ = ("height", "format", "index", "chunk", "sender")

    def __init__(self, height: int, format: int, index: int, chunk: bytes, sender: str):
        self.height = height
        self.format = format
        self.index = index
        self.chunk = chunk
        self.sender = sender


class ChunkQueue:
    """reference: statesync/chunks.go:27."""

    def __init__(self, snapshot: Snapshot):
        self.snapshot = snapshot
        self._chunks: Dict[int, Chunk] = {}
        self._allocated: Set[int] = set()
        self._returned: Set[int] = set()
        self._next_return = 0
        self._event = asyncio.Event()
        self.closed = False
        self._failure: Optional[BaseException] = None

    def allocate(self) -> Optional[int]:
        """Hand out an unallocated chunk index for fetching, or None when all
        are allocated (reference: :117 Allocate)."""
        if self.closed:
            raise ChunkQueueClosed
        for i in range(self.snapshot.chunks):
            if (
                i not in self._allocated
                and i not in self._chunks
                and i not in self._returned  # crash-resume: already applied
            ):
                self._allocated.add(i)
                return i
        return None

    def add(self, chunk: Chunk) -> bool:
        """Store a fetched chunk; True if new (reference: :85 Add)."""
        if self.closed:
            return False
        if not (0 <= chunk.index < self.snapshot.chunks):
            raise ValueError(f"chunk index {chunk.index} out of range")
        if chunk.index in self._chunks:
            return False
        self._chunks[chunk.index] = chunk
        self._allocated.discard(chunk.index)
        self._event.set()
        return True

    def has(self, index: int) -> bool:
        return index in self._chunks

    async def next(self) -> Chunk:
        """Blocking, in-order retrieval for the applier
        (reference: :193 Next). Indices already returned (and not since
        retried) are skipped, so a retry() of an early chunk re-delivers just
        that chunk and then resumes where the applier left off."""
        while True:
            if self._failure is not None:
                raise self._failure
            if self.closed:
                raise ChunkQueueClosed
            while self._next_return in self._returned:
                self._next_return += 1
            c = self._chunks.get(self._next_return)
            if c is not None:
                self._returned.add(self._next_return)
                self._next_return += 1
                return c
            self._event.clear()
            await self._event.wait()

    def fail(self, exc: BaseException) -> None:
        """A fetcher exhausted its retry budget: wake the applier with the
        error instead of letting it wait forever on a chunk that will never
        arrive (the structured terminus of the retry ladder — the syncer
        rejects the snapshot and sync_any moves on / falls back)."""
        if self._failure is None:
            self._failure = exc
        self._event.set()

    def mark_applied(self, index: int) -> None:
        """Resume support: mark a chunk as already returned AND
        applied in a previous life, so neither the fetchers nor the applier
        touch it after a crash-resume re-offer."""
        if 0 <= index < self.snapshot.chunks:
            self._returned.add(index)
            self._allocated.discard(index)
            self._event.set()

    def retry(self, index: int) -> None:
        """Make a chunk (re)fetchable and (re)returnable
        (reference: :221 Retry)."""
        self._chunks.pop(index, None)
        self._allocated.discard(index)
        self._returned.discard(index)
        self._next_return = min(self._next_return, index)
        self._event.set()

    def retry_all(self) -> None:
        for i in range(self.snapshot.chunks):
            self.retry(i)

    def discard_sender(self, peer_id: str) -> None:
        """Drop unreturned chunks from a bad sender (reference: :160)."""
        for i, c in list(self._chunks.items()):
            if c.sender == peer_id and i not in self._returned:
                self.retry(i)

    def get_sender(self, index: int) -> str:
        c = self._chunks.get(index)
        return c.sender if c else ""

    def done(self) -> bool:
        return len(self._returned) == self.snapshot.chunks

    def close(self) -> None:
        self.closed = True
        self._event.set()
