"""Key-value store interface + in-memory and SQLite-backed engines (the
port's copy of the JAX package's `db/kv.py`).

Mirrors the `ethdb.Database` contract (`ethdb/interface.go`: Put/Get/Has/
Delete/Close) and `sharding/database/inmemory.go` (ShardKV map). SQLite
(stdlib) stands in for LevelDB as the durable engine, with the reference's
schema, so a datadir written by either package opens in the other.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterator, Optional, Tuple


class KVStore:
    """Abstract Get/Put/Has/Delete byte-keyed store."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def keys(self, prefix: bytes = b"") -> Iterator[bytes]:
        """Keys under `prefix`, WITHOUT materializing values — the
        cheap scan for small namespaces (e.g. the vote journal) living
        inside a store whose values can be large (chunk blobs).
        Engines override with an index-only query where they can."""
        prefix = bytes(prefix)
        return iter([key for key, _ in self.items()
                     if key.startswith(prefix)])


class MemoryKV(KVStore):
    """Thread-safe in-memory map (parity: ShardKV, ethdb.MemDatabase)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(bytes(key))

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(bytes(key), None)

    def items(self):
        with self._lock:
            return iter(list(self._data.items()))

    def keys(self, prefix: bytes = b""):
        prefix = bytes(prefix)
        with self._lock:
            return iter([key for key in self._data
                         if key.startswith(prefix)])

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


class SqliteKV(KVStore):
    """Durable KV store over stdlib SQLite (LevelDB stand-in)."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            # WAL + NORMAL matches the durability class of the LevelDB
            # this stands in for (ethdb writes are not fsync-per-put
            # either); without it every put pays a full journal fsync —
            # an order of magnitude on spinning/virtual disks
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (bytes(key),)
            ).fetchone()
        return None if row is None else bytes(row[0])

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (bytes(key), bytes(value)),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (bytes(key),))
            self._conn.commit()

    def items(self):
        with self._lock:
            rows = self._conn.execute("SELECT k, v FROM kv ORDER BY k").fetchall()
        return iter([(bytes(k), bytes(v)) for k, v in rows])

    def keys(self, prefix: bytes = b""):
        # index-only range scan on the primary key: no value pages are
        # touched, so scanning a small namespace stays cheap even when
        # the store also holds large blobs
        prefix = bytes(prefix)
        with self._lock:
            if not prefix:
                rows = self._conn.execute(
                    "SELECT k FROM kv ORDER BY k").fetchall()
            else:
                # upper bound = prefix with its last byte incremented
                # (carrying over 0xff bytes); a prefix of all 0xff has
                # no upper bound
                upper = bytearray(prefix)
                while upper and upper[-1] == 0xFF:
                    upper.pop()
                if upper:
                    upper[-1] += 1
                    rows = self._conn.execute(
                        "SELECT k FROM kv WHERE k >= ? AND k < ? "
                        "ORDER BY k", (prefix, bytes(upper))).fetchall()
                else:
                    rows = self._conn.execute(
                        "SELECT k FROM kv WHERE k >= ? ORDER BY k",
                        (prefix,)).fetchall()
        return iter([bytes(k) for (k,) in rows])

    def close(self) -> None:
        with self._lock:
            self._conn.close()
