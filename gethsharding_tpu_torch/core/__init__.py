"""Shard state replay on the host: transactions, the state trie and the
scalar state processor, the twin of the batched replay (`ops/replay.py`)."""
