"""Core consensus types on the host: transactions, collation headers and
bodies, the per-shard store, the Merkle-Patricia trie with its proofs, its
node database (`trie_db.py`) and its bulk root (`mpt.py`), the state
trie's root and the scalar state processor (the twin of the batched
replay, `ops/replay.py`)."""

from gethsharding_tpu_torch.core.trie_db import TrieDatabase, TrieSync  # noqa: F401
