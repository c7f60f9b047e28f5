"""Crash-resumable snapshot-restore checkpoint.

The syncer records which chunk indices the app ACCEPTED while restoring a
snapshot. After a crash mid-restore, the restarted syncer re-offers the SAME
snapshot and marks the recorded chunks as already applied, so the restore
resumes where it died instead of re-fetching and re-applying the whole set.

The checkpoint only describes what the NODE observed; resuming assumes the
app's side of those applies also survived the crash (a socket app that kept
running, or an app whose chunk application is durable). When that assumption
is wrong the restore fails the final verify_app hash check, the snapshot is
rejected, the checkpoint cleared — and the next attempt starts fresh.

Format (JSON, atomic tmp+rename):

    {"v": 1,
     "snapshot": {"height": H, "format": F, "chunks": N, "hash": "<hex>"},
     "applied": [0, 1, 4, ...]}

The port's copy of tendermint_tpu/statesync/checkpoint.py.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Optional, Set

logger = logging.getLogger("tendermint_tpu_torch.statesync")


class RestoreCheckpoint:
    def __init__(self, path: Optional[str]):
        """path=None disables persistence: save/load/clear are no-ops."""
        self.path = path

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def save(self, snapshot, applied: Set[int]) -> None:
        if not self.path:
            return
        payload = {
            "v": 1,
            "snapshot": {
                "height": int(snapshot.height),
                "format": int(snapshot.format),
                "chunks": int(snapshot.chunks),
                "hash": snapshot.hash.hex(),
            },
            "applied": sorted(int(i) for i in applied),
        }
        d = os.path.dirname(self.path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".restore-")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            logger.exception("restore checkpoint write failed (continuing)")

    def load(self, snapshot) -> Set[int]:
        """Applied chunk indices recorded for exactly this snapshot, or the
        empty set (absent, unreadable, or a different snapshot)."""
        if not self.path:
            return set()
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return set()
        try:
            if payload.get("v") != 1:
                return set()
            s = payload["snapshot"]
            if (
                int(s["height"]) != int(snapshot.height)
                or int(s["format"]) != int(snapshot.format)
                or int(s["chunks"]) != int(snapshot.chunks)
                or bytes.fromhex(s["hash"]) != snapshot.hash
            ):
                return set()
            applied = {
                int(i) for i in payload["applied"]
                if 0 <= int(i) < int(snapshot.chunks)
            }
        except Exception:
            logger.warning("restore checkpoint unreadable; discarding", exc_info=True)
            return set()
        return applied

    def clear(self) -> None:
        if not self.path:
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass
