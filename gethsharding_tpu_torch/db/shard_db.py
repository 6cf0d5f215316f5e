"""ShardDB service: the node-attached storage engine (the port's copy of
the JAX package's `db/shard_db.py`).

Parity: `sharding/database/database.go` (NewShardDB :24, Start :47, Stop,
DB()). In-memory engine for tests/simulation; SQLite-backed engine (LevelDB
stand-in) for persistence under `<datadir>/<name>`.
"""

from __future__ import annotations

import os
from typing import Optional

from gethsharding_tpu_torch.db.kv import KVStore, MemoryKV, SqliteKV


class ShardDB:
    """Storage service with the framework's Service lifecycle (start/stop)."""

    def __init__(self, data_dir: str = "", name: str = "shardchaindata",
                 in_memory: bool = True):
        self.data_dir = data_dir
        self.name = name
        self.in_memory = in_memory
        self._db: Optional[KVStore] = MemoryKV() if in_memory else None

    # -- Service lifecycle -------------------------------------------------

    def start(self) -> None:
        if not self.in_memory and self._db is None:
            os.makedirs(self.data_dir, exist_ok=True)
            self._db = SqliteKV(os.path.join(self.data_dir, self.name))

    def stop(self) -> None:
        if self._db is not None:
            self._db.close()
            if not self.in_memory:
                self._db = None  # restart reopens the file

    # -- accessors ---------------------------------------------------------

    @property
    def db(self) -> KVStore:
        if self._db is None:
            # open-on-first-access: construction-time wiring (ShardNode
            # hands the store to Shard before services start) must not
            # depend on lifecycle order
            self.start()
        return self._db
