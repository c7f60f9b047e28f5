"""Process-level faults for in-process nodes: hard kills and WAL damage. The
port's copy of tendermint_tpu/chaos/process.py.

A REAL crash (`os._exit`, the libs/fail.py env mode) kills the whole test
process; the in-process analog must instead make one Node object disappear
the way a killed process would look to its own disk and to its peers:

- the WAL's in-memory group-commit buffer is DROPPED, not flushed (a kill
  loses exactly that window — the documented group-commit trade-off);
- the file descriptor is closed at the OS level so no Python-side finalizer
  flushes buffered bytes later;
- tasks are cancelled and sockets closed without the graceful stop() path.

WAL tail damage models torn writes (truncate mid-frame) and bit rot
(corrupt the tail); replay must recover the clean prefix (consensus/wal.py's
non-strict reader) — the soak's restarted node proves it end to end.
"""

from __future__ import annotations

import os
import random
from typing import Optional


def crash_wal(wal) -> None:
    """Make an open WAL look process-killed: drop the in-memory group-commit
    buffer and point the file descriptor at /dev/null (dup2), so anything the
    object later flushes — Python's userspace buffer included — goes nowhere
    instead of reaching the log. dup2 (not close) keeps the fd number valid:
    late close()/fsync() on the dead object stays harmless rather than
    hitting EBADF or, worse, a reused descriptor."""
    try:
        wal._buf.clear()
    except Exception:
        pass
    try:
        devnull = os.open(os.devnull, os.O_WRONLY)
        try:
            os.dup2(devnull, wal._fh.fileno())
        finally:
            os.close(devnull)
    except OSError:
        pass
    # instance-level overrides: the corpse accepts (and discards) any late
    # write/close instead of raising — fsync(/dev/null) is EINVAL on Linux
    wal._dirty_since = None
    wal.flush_and_sync = lambda: None
    wal._maybe_rotate = lambda: None


def truncate_wal_tail(path: str, drop_bytes: int = 13) -> None:
    """Tear the WAL head file mid-frame (a crash during a buffered write)."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - max(1, int(drop_bytes))))


def corrupt_wal_tail(path: str, rng: Optional[random.Random] = None, span: int = 16) -> None:
    """Flip bytes near the end of the WAL head file (bit rot / torn sector).
    The CRC framing must make replay stop at the damaged frame."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    rng = rng or random.Random(0)
    start = max(0, size - span)
    with open(path, "r+b") as f:
        f.seek(start)
        chunk = bytearray(f.read(span))
        for i in range(len(chunk)):
            chunk[i] ^= rng.randrange(1, 256)
        f.seek(start)
        f.write(bytes(chunk))


async def hard_kill(node) -> None:
    """Kill an in-process Node abruptly: no graceful consensus stop, no WAL
    close/fsync. Peers see the TCP connections die; the node's own disk is
    left exactly as a killed process would leave it."""
    node._running = False
    cs = node.consensus
    cs._running = False
    for t in (cs._timer_task, cs._loop_task):
        if t is not None:
            t.cancel()
    cs._stopped.set()
    crash_wal(node.wal)
    if node._statesync_task is not None:
        node._statesync_task.cancel()
    if node.rpc_server is not None:
        try:
            await node.rpc_server.stop()
        except Exception:
            pass
    if node.switch is not None:
        try:
            await node.switch.stop()
        except Exception:
            pass
    try:
        await node.indexer_service.stop()
    except Exception:
        pass
    try:
        node.mempool.close_wal()
    except Exception:
        pass
    try:
        node.proxy_app.stop()
    except Exception:
        pass
    # release sqlite handles so the restarted Node can reopen the same files
    for db in (node.block_db, node.state_db, node.evidence_db):
        try:
            db.close()
        except Exception:
            pass
