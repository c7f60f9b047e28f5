"""Snapshot pool: dedup + peer tracking + ranking of advertised snapshots.

reference: statesync/snapshots.go — snapshotKey (:23), Snapshot (:29),
snapshotPool (:55), Add (:78), Best/Ranked (:161,169), Reject* (:183-219).

The port's copy of tendermint_tpu/statesync/snapshots.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from tendermint_tpu_torch.crypto import tmhash


@dataclass(frozen=True)
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""
    trusted_app_hash: bytes = b""  # filled in by the syncer, not advertised

    def key(self) -> bytes:
        """Unique id over (height, format, chunks, hash, metadata)
        (reference: statesync/snapshots.go:44 Key)."""
        w = bytearray()
        w += self.height.to_bytes(8, "big")
        w += self.format.to_bytes(4, "big")
        w += self.chunks.to_bytes(4, "big")
        w += self.hash
        w += self.metadata
        return tmhash.sum_truncated(bytes(w))


class SnapshotPool:
    """reference: statesync/snapshots.go:55."""

    def __init__(self):
        self._snapshots: Dict[bytes, Snapshot] = {}
        self._peers: Dict[bytes, Set[str]] = {}  # key -> peer ids
        self._rejected_snapshots: Set[bytes] = set()
        self._rejected_formats: Set[int] = set()
        self._rejected_peers: Set[str] = set()

    def add(self, peer_id: str, snapshot: Snapshot) -> bool:
        """Returns True if this snapshot is new (reference: :78 Add)."""
        key = snapshot.key()
        if key in self._rejected_snapshots or snapshot.format in self._rejected_formats:
            return False
        if peer_id in self._rejected_peers:
            return False
        self._peers.setdefault(key, set()).add(peer_id)
        if key in self._snapshots:
            return False
        self._snapshots[key] = snapshot
        return True

    def best(self) -> Optional[Snapshot]:
        ranked = self.ranked()
        return ranked[0] if ranked else None

    def ranked(self) -> List[Snapshot]:
        """Order: height desc, format desc, more peers first
        (reference: :169 Ranked)."""
        return sorted(
            self._snapshots.values(),
            key=lambda s: (-s.height, -s.format, -len(self._peers.get(s.key(), ()))),
        )

    def get_peers(self, snapshot: Snapshot) -> List[str]:
        return sorted(self._peers.get(snapshot.key(), ()))

    def reject(self, snapshot: Snapshot) -> None:
        key = snapshot.key()
        self._rejected_snapshots.add(key)
        self._snapshots.pop(key, None)
        self._peers.pop(key, None)

    def reject_format(self, fmt: int) -> None:
        self._rejected_formats.add(fmt)
        for key, s in list(self._snapshots.items()):
            if s.format == fmt:
                self._snapshots.pop(key, None)
                self._peers.pop(key, None)

    def reject_peer(self, peer_id: str) -> None:
        self._rejected_peers.add(peer_id)
        self.remove_peer(peer_id)

    def remove_peer(self, peer_id: str) -> None:
        for key in list(self._peers):
            self._peers[key].discard(peer_id)
            if not self._peers[key]:
                # no peer can serve it any more
                self._peers.pop(key, None)
                self._snapshots.pop(key, None)

    def __len__(self) -> int:
        return len(self._snapshots)
