"""Catch-up-level fault injection: misbehaving SERVING peers. The port's copy
of tendermint_tpu/chaos/catchup.py, for the `serve_faults` hooks of the
port's blocksync and statesync reactors.

The device/network/process injectors fault the node under test; these fault
the peers it syncs FROM. A `ServeFaults` instance installed on a node's
blocksync/statesync reactor (`reactor.serve_faults = ServeFaults()`) makes
that node's serving side misbehave on demand:

  arm_block_stall(seconds)  block requests are silently swallowed for the
                            window (a live-but-unresponsive peer: the
                            syncer's pool must time out, back off, and
                            route around it);
  arm_block_lies(count)     the next `count` served blocks have one commit
                            signature flipped (a lying peer: the syncer's
                            super-batch verify must fail the height, redo
                            it, and punish the sender);
  arm_chunk_corrupt(count)  the next `count` served snapshot chunks have a
                            byte flipped (the restoring app refuses them;
                            the syncer must punish + re-queue from another
                            peer).

Thread-safety matters only as far as the event loop: reactors consult these
from their receive coroutines, the chaos engine arms them from its own task
on the same loop — plain attributes suffice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


class ServeFaults:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._stall_until = 0.0
        self._block_lies = 0
        self._chunk_corrupt = 0
        # forensics: what actually fired, for soak assertions
        self.fired = []  # ("stall_drop"|"block_lie"|"chunk_corrupt", detail)

    # -- arming --------------------------------------------------------------

    def arm_block_stall(self, seconds: float) -> None:
        self._stall_until = max(self._stall_until, self._clock() + float(seconds))

    def arm_block_lies(self, count: int) -> None:
        self._block_lies += max(0, int(count))

    def arm_chunk_corrupt(self, count: int) -> None:
        self._chunk_corrupt += max(0, int(count))

    def heal(self) -> None:
        self._stall_until = 0.0
        self._block_lies = 0
        self._chunk_corrupt = 0

    # -- reactor-side hooks --------------------------------------------------

    def block_stalled(self) -> bool:
        if self._clock() < self._stall_until:
            self.fired.append(("stall_drop", ""))
            return True
        return False

    def take_block_lie(self) -> bool:
        if self._block_lies > 0:
            self._block_lies -= 1
            return True
        return False

    def take_chunk_corrupt(self) -> bool:
        if self._chunk_corrupt > 0:
            self._chunk_corrupt -= 1
            return True
        return False

    def corrupt_block(self, block):
        """A commit-tampered copy of `block`: one for_block signature in
        last_commit gets a flipped byte, so the RECEIVER's cross-height
        super-batch verification fails the previous height's 2/3 tally and
        walks the redo/punish path (the block still decodes and its header
        still hashes — this is a lie, not line noise)."""
        sigs = list(block.last_commit.signatures)
        for i, cs in enumerate(sigs):
            if cs.for_block() and cs.signature:
                flipped = bytes([cs.signature[0] ^ 0xFF]) + cs.signature[1:]
                sigs[i] = dataclasses.replace(cs, signature=flipped)
                break
        else:
            return block  # nothing to tamper (height-1 empty commit)
        commit = dataclasses.replace(block.last_commit, signatures=tuple(sigs))
        self.fired.append(("block_lie", f"height={block.header.height}"))
        return dataclasses.replace(block, last_commit=commit)

    def corrupt_chunk(self, chunk: bytes) -> bytes:
        """A bit-rotted copy of a snapshot chunk."""
        self.fired.append(("chunk_corrupt", f"len={len(chunk)}"))
        if not chunk:
            return chunk
        return bytes([chunk[0] ^ 0xFF]) + chunk[1:]


def install(node, faults: Optional[ServeFaults] = None) -> ServeFaults:
    """Attach one ServeFaults to every catch-up-serving reactor of `node`."""
    sf = faults or ServeFaults()
    if getattr(node, "blocksync_reactor", None) is not None:
        node.blocksync_reactor.serve_faults = sf
    if getattr(node, "statesync_reactor", None) is not None:
        node.statesync_reactor.serve_faults = sf
    return sf
