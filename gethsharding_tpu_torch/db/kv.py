"""Key-value store interface and its in-memory engine (the port's copy of
the JAX package's `db/kv.py`; the durable SQLite engine comes with the
port's `ShardNode`, ROADMAP.md queue A item 8).

Mirrors the `ethdb.Database` contract (`ethdb/interface.go`: Put/Get/Has/
Delete/Close) and `sharding/database/inmemory.go` (ShardKV map).
"""

from __future__ import annotations

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
