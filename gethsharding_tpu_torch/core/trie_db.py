"""Trie node database: persistence + ref-counted GC + by-hash sync (the
port's copy of the JAX package's `core/trie_db.py`).

The analog of the reference's `trie/database.go` (node store with
reference counting so dropped roots garbage-collect their unshared
nodes) and `trie/sync.go` (pull a trie by node hash from a remote
source), behind the framework's KV seam (`db/kv.py` — memory or
SQLite):

- `commit(trie)` persists every hash-referenced node of a `Trie` and
  takes a reference on its root. Structure sharing is free: an
  unchanged subtree hashes to the same node key, so committing
  successive versions of a state trie stores only the delta (exactly
  geth's content-addressed node model).
- `dereference(root)` drops a root; nodes whose reference count reaches
  zero are deleted, cascading into their children (trie/database.go
  Dereference).
- `load(root)` reconstructs a `Trie` object from stored nodes.
- `TrieSync` pulls a trie into the database from any `fetch(hash) ->
  blob` source (a peer protocol, another database), verifying every
  blob against its hash — the future shard-state-sync building block.

Key scheme: ``trie-node:<hash32>`` -> node RLP, ``trie-ref:<hash32>``
-> big-endian reference count. Only hash-referenced (>= 32 byte) nodes
are stored; embedded children travel inside their parent's blob, as in
the reference.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from gethsharding_tpu_torch.core.trie import (
    EMPTY_ROOT, Trie, _Branch, _encoded, _Extension, _hp_decode, _Leaf)
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.db.kv import KVStore, MemoryKV
from gethsharding_tpu_torch.utils.rlp import rlp_decode

_NODE = b"trie-node:"
_REF = b"trie-ref:"


def _child_hashes(structure) -> List[bytes]:
    """Hash references inside one decoded node structure (recursing
    through embedded children, which live inside this blob)."""
    refs: List[bytes] = []
    if not isinstance(structure, list):
        return refs
    if len(structure) == 2:
        _, is_leaf = _hp_decode(structure[0])
        if not is_leaf:
            child = structure[1]
            if isinstance(child, list):
                refs.extend(_child_hashes(child))
            elif len(child) == 32:
                refs.append(bytes(child))
    elif len(structure) == 17:
        for child in structure[:16]:
            if isinstance(child, list):
                refs.extend(_child_hashes(child))
            elif child != b"" and len(child) == 32:
                refs.append(bytes(child))
    return refs


class TrieDatabase:
    """Ref-counted trie node store over a KV engine."""

    def __init__(self, kv: Optional[KVStore] = None):
        self.kv = kv if kv is not None else MemoryKV()

    # -- node plane --------------------------------------------------------

    def node(self, node_hash: bytes) -> Optional[bytes]:
        return self.kv.get(_NODE + bytes(node_hash))

    def _refs(self, node_hash: bytes) -> int:
        raw = self.kv.get(_REF + bytes(node_hash))
        return 0 if not raw else int.from_bytes(raw, "big")

    def _set_refs(self, node_hash: bytes, count: int) -> None:
        if count <= 0:
            self.kv.delete(_REF + bytes(node_hash))
        else:
            self.kv.put(_REF + bytes(node_hash),
                        count.to_bytes(4, "big"))

    # -- commit ------------------------------------------------------------

    def commit(self, trie: Trie) -> bytes:
        """Persist the trie's hash-referenced nodes and take an external
        reference on the root. Returns the root hash (EMPTY_ROOT commits
        nothing).

        Reference model = the reference's edge counts
        (trie/database.go): a node's count is (number of stored parent
        nodes holding its hash) + (external root references). A node
        already present is a shared subtree — its edges are already
        counted, so the walk prunes there; nothing double-counts."""
        root = trie.root_hash()
        if root == EMPTY_ROOT:
            return root
        self._store(trie._root, is_root=True)
        self._incref(root)
        return root

    def _store(self, node, is_root: bool = False) -> None:
        raw = _encoded(node)[1]
        if not is_root and len(raw) < 32:
            # embedded in the parent's blob; embedded nodes cannot hold
            # hash references (a 32-byte ref alone makes a node >= 32)
            return
        key = keccak256(raw)
        if self.kv.get(_NODE + key) is not None:
            return  # shared subtree: present, edges already counted
        self.kv.put(_NODE + key, raw)
        for child in _child_hashes(rlp_decode(raw)):
            self._incref(child)
        if isinstance(node, _Extension):
            self._store(node.child)
        elif isinstance(node, _Branch):
            for child in node.children:
                if child is not None:
                    self._store(child)

    def _incref(self, node_hash: bytes) -> None:
        self._set_refs(node_hash, self._refs(node_hash) + 1)

    def reference(self, root: bytes) -> None:
        """Take an additional external reference on a stored root."""
        if root != EMPTY_ROOT:
            self._incref(root)

    # -- GC ----------------------------------------------------------------

    def dereference(self, root: bytes) -> int:
        """Drop one external reference on `root`; nodes whose count
        reaches zero are deleted, cascading into children — nodes shared
        with still-referenced roots survive (their edge counts hold).
        Returns the number of nodes deleted."""
        if root == EMPTY_ROOT:
            return 0
        node_hash = bytes(root)
        count = self._refs(node_hash)
        if count == 0:
            return 0  # unknown or already collected
        self._set_refs(node_hash, count - 1)
        if count > 1:
            return 0
        return self._collect(node_hash)

    def _collect(self, node_hash: bytes) -> int:
        blob = self.node(node_hash)
        if blob is None:
            return 0
        self.kv.delete(_NODE + node_hash)
        self.kv.delete(_REF + node_hash)
        deleted = 1
        for child in _child_hashes(rlp_decode(blob)):
            remaining = self._refs(child) - 1
            self._set_refs(child, remaining)
            if remaining <= 0:
                deleted += self._collect(child)
        return deleted

    # -- load --------------------------------------------------------------

    def load(self, root: bytes) -> Trie:
        """Reconstruct a Trie from stored nodes (raises KeyError on a
        missing node — an incomplete sync)."""
        trie = Trie()
        if root == EMPTY_ROOT:
            return trie
        trie._root = self._load_node(bytes(root))
        return trie

    def _load_node(self, node_hash: bytes):
        blob = self.node(node_hash)
        if blob is None:
            raise KeyError(f"missing trie node {node_hash.hex()}")
        return self._from_structure(rlp_decode(blob))

    def _from_structure(self, structure):
        if not isinstance(structure, list):
            raise ValueError("malformed stored node")
        if len(structure) == 2:
            path, is_leaf = _hp_decode(structure[0])
            if is_leaf:
                return _Leaf(path, structure[1])
            return _Extension(path, self._resolve(structure[1]))
        if len(structure) == 17:
            branch = _Branch()
            for i, child in enumerate(structure[:16]):
                if isinstance(child, list):
                    branch.children[i] = self._from_structure(child)
                elif child != b"":
                    branch.children[i] = self._load_node(bytes(child))
            if structure[16] != b"":
                branch.value = structure[16]
            return branch
        raise ValueError("malformed stored node")

    def _resolve(self, child):
        if isinstance(child, list):
            return self._from_structure(child)
        return self._load_node(bytes(child))


class TrieSync:
    """Pull a trie by node hash from a remote source into a database
    (trie/sync.go analog): breadth-first over missing nodes, every blob
    verified against the hash that requested it before it is stored."""

    def __init__(self, db: TrieDatabase):
        self.db = db

    def missing(self, root: bytes, limit: int = 256) -> List[bytes]:
        """Frontier of node hashes reachable from `root` that the
        database does not hold yet."""
        if root == EMPTY_ROOT:
            return []
        out: List[bytes] = []
        seen = {bytes(root)}  # dedup: a node can have several parents,
        # and double-fetching it would double-incref its children
        queue = [bytes(root)]
        while queue and len(out) < limit:
            node_hash = queue.pop(0)
            blob = self.db.node(node_hash)
            if blob is None:
                out.append(node_hash)
                continue
            for child in _child_hashes(rlp_decode(blob)):
                if child not in seen:
                    seen.add(child)
                    queue.append(child)
        return out

    def run(self, root: bytes, fetch: Callable[[bytes], Optional[bytes]],
            max_nodes: int = 1_000_000) -> int:
        """Sync until the trie under `root` is complete; returns nodes
        fetched. Raises ValueError on a blob that fails hash
        verification, KeyError when the source cannot provide a node."""
        fetched = 0
        while fetched < max_nodes:
            frontier = self.missing(root)
            if not frontier:
                break
            for node_hash in frontier:
                blob = fetch(node_hash)
                if blob is None:
                    raise KeyError(f"source missing node {node_hash.hex()}")
                if keccak256(blob) != node_hash:
                    raise ValueError(
                        f"node {node_hash.hex()} failed verification")
                self.db.kv.put(_NODE + node_hash, blob)
                # keep the edge counts consistent with commit(): each
                # stored parent references its hash children once
                for child in _child_hashes(rlp_decode(blob)):
                    self.db._incref(child)
                fetched += 1
        if root != EMPTY_ROOT and self.db._refs(bytes(root)) == 0:
            self.db._incref(bytes(root))  # the external root reference
        return fetched
