"""Core consensus types on the host: transactions, collation headers and
bodies, the per-shard store, the state trie's root and the scalar state
processor (the twin of the batched replay, `ops/replay.py`)."""
