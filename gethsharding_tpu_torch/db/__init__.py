"""Shard storage engines (the port's copy of the JAX package's `db/`): the
in-memory and SQLite key-value stores and the `ShardDB` service."""

from gethsharding_tpu_torch.db.kv import KVStore, MemoryKV, SqliteKV  # noqa: F401
from gethsharding_tpu_torch.db.shard_db import ShardDB  # noqa: F401
