"""Embedded key-value stores: the port's copy of tendermint_tpu/libs/kvdb.py
(the reference's tm-db role).

MemDB (ephemeral) and SQLiteDB (durable, one file, stdlib sqlite3), with
tm-db's interface: get/set/delete/has and prefix iteration in key order.
Write batches wait for a caller in the port that stores blocks (ROADMAP A8).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, Iterator, Optional, Tuple


class KVDB:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(KVDB):
    def __init__(self) -> None:
        self._data: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            keys = sorted(k for k in self._data if k.startswith(prefix))
            items = [(k, self._data[k]) for k in keys]
        yield from items


class SQLiteDB(KVDB):
    """Durable kv store. WAL journal mode for concurrent readers; synchronous
    writes so the consensus crash-recovery ordering holds."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=FULL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, value),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        hi = prefix + b"\xff" * 8
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k <= ? ORDER BY k", (prefix, hi)
            ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), bytes(v)

    def close(self) -> None:
        with self._lock:
            self._conn.close()
