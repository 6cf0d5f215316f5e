"""Key-value stores of the shard DB (the port's copy of the JAX package's
`db/kv.py`)."""

from gethsharding_tpu_torch.db.kv import KVStore, MemoryKV  # noqa: F401
