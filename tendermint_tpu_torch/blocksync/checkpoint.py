"""Crash-resumable catch-up checkpoint. The port's copy of
tendermint_tpu/blocksync/checkpoint.py.

The pipelined blocksync reactor verifies a window of fetched blocks as one
cross-height super-batch BEFORE applying them. A node killed between verify
and apply used to re-fetch and re-verify that whole window on restart; the
checkpoint persists the verified-but-unapplied blocks so the restarted
pipeline re-enters at its last applied height and applies the survivors
without re-verifying (the signatures were already checked — the file's
hash-chain linkage proof below makes a tampered checkpoint fail closed).

Format (JSON, atomic tmp+rename writes so a crash never leaves a torn file):

    {"v": 1,
     "applied_height": H,            # state.last_block_height at write time
     "blocks": ["<hex>", ...]}       # encoded blocks H+1..H+k, verified,
                                     # plus the trailing (k+1)-th block whose
                                     # last_commit covers block H+k

On load the blocks are decoded and the chain linkage re-proved: block i+1's
header.last_block_id.hash must equal block i's hash, and the first block
must sit at exactly applied_height+1. Any mismatch (stale file, disk
corruption, an attacker editing the file) discards the checkpoint — the
node then just re-fetches, which is always safe.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import List, Optional

logger = logging.getLogger("tendermint_tpu_torch.blocksync")

# cap the persisted window: checkpoints are rewritten per applied run, and an
# unbounded window would turn every write into a multi-MB fsync
MAX_CHECKPOINT_BLOCKS = 64


class CatchupCheckpoint:
    def __init__(self, path: Optional[str]):
        """path=None disables persistence (memdb test nodes): save/load are
        no-ops and the pipeline behaves exactly as without a checkpoint."""
        self.path = path

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def save(self, applied_height: int, blocks: List[object]) -> None:
        """blocks: verified-but-unapplied blocks, contiguous from
        applied_height+1 (the last entry is the trailing commit carrier).
        Entries may be Block objects or their already-encoded bytes."""
        if not self.path:
            return
        payload = {
            "v": 1,
            "applied_height": int(applied_height),
            "blocks": [
                (b if isinstance(b, (bytes, bytearray)) else b.encode()).hex()
                for b in blocks[:MAX_CHECKPOINT_BLOCKS]
            ],
        }
        d = os.path.dirname(self.path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".catchup-")
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
            logger.exception("catch-up checkpoint write failed (continuing)")

    def load(self, expect_applied_height: int) -> List[object]:
        """Verified blocks for expect_applied_height+1.., or [] when the
        checkpoint is absent, stale, or fails the linkage proof.

        A file written at applied height H0 stays usable after a crash that
        landed anywhere inside its window (state at H >= H0): the
        already-applied prefix is skipped and the remainder re-proved."""
        if not self.path:
            return []
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return []
        try:
            if payload.get("v") != 1:
                return []
            base = int(payload["applied_height"])
            skip = int(expect_applied_height) - base
            if skip < 0 or skip >= len(payload["blocks"]):
                logger.info(
                    "catch-up checkpoint (applied %s, %d blocks) does not "
                    "cover state height %d; discarding", payload.get(
                        "applied_height"), len(payload["blocks"]),
                    expect_applied_height,
                )
                return []
            from tendermint_tpu_torch.types.block import Block

            blocks = [
                Block.decode(bytes.fromhex(h)) for h in payload["blocks"][skip:]
            ]
        except Exception:
            logger.warning("catch-up checkpoint unreadable; discarding", exc_info=True)
            return []
        # linkage proof: contiguous heights anchored at applied_height+1,
        # each block committing to its predecessor's hash
        for i, b in enumerate(blocks):
            if b.header.height != expect_applied_height + 1 + i:
                logger.warning("catch-up checkpoint heights not contiguous; discarding")
                return []
            if i > 0 and b.header.last_block_id.hash != blocks[i - 1].hash():
                logger.warning("catch-up checkpoint linkage broken; discarding")
                return []
        return blocks

    def clear(self) -> None:
        if not self.path:
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass
