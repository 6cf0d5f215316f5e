"""The hexary Merkle-Patricia trie (the port's copy of the JAX package's
`core/trie.py`): insert, update, get and delete, the root hash, merkle
proofs (`prove` / `verify_proof`, parity `trie/proof.go`) and the
keccak-keyed `SecureTrie` (`trie/secure_trie.go`).

Node encoding follows the Ethereum yellow paper / go-ethereum 1.8:
leaf and extension nodes are 2-item RLP lists [hex-prefix path, value],
branch nodes 17-item lists (16 children + value), and a node whose RLP
is >= 32 bytes is referenced by its keccak256, a shorter one embedded in
its parent. The empty trie's root is keccak256(rlp(b"")). This is host
code: the chunk roots, the light client's proofs, the state root's twin
and `trie_db.py` build on it; the bulk roots of long lists take the
compiled builder of `core/mpt.py`, and the replay's device commitment is
the flat one (`ops/replay.py`).
"""

from __future__ import annotations

from typing import Optional

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.rlp import rlp_decode, rlp_encode

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


def _to_nibbles(key: bytes) -> tuple:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return tuple(out)


def hex_prefix_encode(nibbles: tuple, is_leaf: bool) -> bytes:
    """Compact (hex-prefix) encoding of a nibble path + leaf flag."""
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2 == 1:
        prefixed = (flag + 1,) + nibbles
    else:
        prefixed = (flag, 0) + nibbles
    out = bytearray()
    for i in range(0, len(prefixed), 2):
        out.append((prefixed[i] << 4) | prefixed[i + 1])
    return bytes(out)


# Every node keeps its encoding (`enc`, see `_encoded`) until an update or
# a delete changes it in place, which clears it: geth's cached node hashes.
# The JAX package's trie encodes the whole subtree again on every call, so
# each of its proofs costs O(size of the trie).

class _Leaf:
    __slots__ = ("path", "value", "enc")

    def __init__(self, path: tuple, value: bytes):
        self.path = path
        self.value = value
        self.enc = None


class _Extension:
    __slots__ = ("path", "child", "enc")

    def __init__(self, path: tuple, child):
        self.path = path
        self.child = child
        self.enc = None


class _Branch:
    __slots__ = ("children", "value", "enc")

    def __init__(self):
        self.children: list = [None] * 16
        self.value: Optional[bytes] = None
        self.enc = None


def _encoded(node) -> tuple:
    """(structure, RLP, reference in its parent) of a node: the reference
    is the RLP's keccak256 for an RLP of 32 bytes or more, else the
    structure itself, embedded. Kept on the node until it changes."""
    enc = node.enc
    if enc is None:
        if isinstance(node, _Leaf):
            structure = [hex_prefix_encode(node.path, True), node.value]
        elif isinstance(node, _Extension):
            structure = [hex_prefix_encode(node.path, False),
                         _encoded(node.child)[2]]
        else:
            structure = [b"" if child is None else _encoded(child)[2]
                         for child in node.children]
            structure.append(node.value if node.value is not None else b"")
        raw = rlp_encode(structure)
        enc = node.enc = (structure, raw,
                          keccak256(raw) if len(raw) >= 32 else structure)
    return enc


def _common_prefix_len(a: tuple, b: tuple) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class Trie:
    """Insert/update/get/delete Merkle-Patricia trie over byte keys and
    values, with the reference's root hash and proofs."""

    def __init__(self):
        self._root = None

    def update(self, key: bytes, value: bytes) -> None:
        if value == b"":
            # geth semantics: updating to an empty value deletes the key
            self.delete(key)
            return
        self._root = self._insert(self._root, _to_nibbles(key), value)

    def delete(self, key: bytes) -> None:
        """Remove a key (no-op if absent), restructuring single-child
        branches back into extensions or leaves (trie/trie.go delete)."""
        self._root = self._delete(self._root, _to_nibbles(key))

    def get(self, key: bytes) -> Optional[bytes]:
        node = self._root
        path = _to_nibbles(key)
        while True:
            if node is None:
                return None
            if isinstance(node, _Leaf):
                return node.value if node.path == path else None
            if isinstance(node, _Extension):
                n = len(node.path)
                if path[:n] != node.path:
                    return None
                path = path[n:]
                node = node.child
                continue
            if not path:
                return node.value
            node, path = node.children[path[0]], path[1:]

    def _insert(self, node, path: tuple, value: bytes):
        if node is None:
            return _Leaf(path, value)
        if isinstance(node, _Leaf):
            if node.path == path:
                return _Leaf(path, value)
            common = _common_prefix_len(node.path, path)
            branch = _Branch()
            old_rest, new_rest = node.path[common:], path[common:]
            if not old_rest:
                branch.value = node.value
            else:
                branch.children[old_rest[0]] = _Leaf(old_rest[1:], node.value)
            if not new_rest:
                branch.value = value
            else:
                branch.children[new_rest[0]] = _Leaf(new_rest[1:], value)
            if common:
                return _Extension(path[:common], branch)
            return branch
        if isinstance(node, _Extension):
            common = _common_prefix_len(node.path, path)
            if common == len(node.path):
                node.child = self._insert(node.child, path[common:], value)
                node.enc = None
                return node
            branch = _Branch()
            ext_rest = node.path[common:]
            child = (node.child if len(ext_rest) == 1
                     else _Extension(ext_rest[1:], node.child))
            branch.children[ext_rest[0]] = child
            new_rest = path[common:]
            if not new_rest:
                branch.value = value
            else:
                branch.children[new_rest[0]] = _Leaf(new_rest[1:], value)
            if common:
                return _Extension(path[:common], branch)
            return branch
        node.enc = None
        if not path:
            node.value = value
            return node
        node.children[path[0]] = self._insert(node.children[path[0]],
                                              path[1:], value)
        return node

    def _delete(self, node, path: tuple):
        if node is None:
            return None
        if isinstance(node, _Leaf):
            return None if node.path == path else node
        if isinstance(node, _Extension):
            n = len(node.path)
            if path[:n] != node.path:
                return node
            child = self._delete(node.child, path[n:])
            if child is None:
                return None
            return self._merge_extension(node.path, child)
        if not path:
            if node.value is None:
                return node
            node.value = None
        else:
            idx = path[0]
            node.children[idx] = self._delete(node.children[idx], path[1:])
        node.enc = None
        return self._collapse_branch(node)

    def _merge_extension(self, prefix: tuple, child):
        """Extension over `prefix` pointing at `child`, merging nested
        extensions and leaves into one path segment."""
        if isinstance(child, _Leaf):
            return _Leaf(prefix + child.path, child.value)
        if isinstance(child, _Extension):
            return _Extension(prefix + child.path, child.child)
        return _Extension(prefix, child)

    def _collapse_branch(self, node):
        live = [(i, c) for i, c in enumerate(node.children) if c is not None]
        if node.value is not None:
            if live:
                return node
            return _Leaf((), node.value)
        if len(live) > 1:
            return node
        if not live:
            return None
        idx, child = live[0]
        return self._merge_extension((idx,), child)

    # -- merkle proofs (trie/proof.go Prove/VerifyProof) -------------------

    def prove(self, key: bytes) -> list:
        """Ordered list of node RLP blobs from the root along `key`'s
        path: every hash-referenced node on the path (embedded nodes
        travel inside their parent's blob, as in geth)."""
        proof = []
        node = self._root
        path = _to_nibbles(key)
        while node is not None:
            proof.append(_encoded(node)[1])
            node, path = self._next_hashed(node, path)
        return proof

    def _next_hashed(self, node, path: tuple):
        """Walk within one blob (through embedded children) until the path
        needs a node that is referenced by hash; returns (node, rest)."""
        while True:
            if isinstance(node, _Leaf):
                return None, path
            if isinstance(node, _Extension):
                n = len(node.path)
                if path[:n] != node.path:
                    return None, path
                path = path[n:]
                child = node.child
            else:
                if not path:
                    return None, path
                child = node.children[path[0]]
                path = path[1:]
                if child is None:
                    return None, path
            if len(_encoded(child)[1]) >= 32:
                return child, path
            node = child  # embedded: keep walking inside this blob

    # -- hashing ----------------------------------------------------------

    def root_hash(self) -> bytes:
        if self._root is None:
            return EMPTY_ROOT
        # the root node is always hashed, whatever its encoded size
        return keccak256(_encoded(self._root)[1])


def verify_proof(root_hash: bytes, key: bytes, proof: list) -> Optional[bytes]:
    """Check a merkle proof against a root hash; returns the proven value,
    None for a proven absence, and raises ValueError on an invalid proof
    (`trie/proof.go VerifyProof`)."""
    if not proof:
        if root_hash == EMPTY_ROOT:
            return None
        raise ValueError("empty proof for non-empty root")
    expected = bytes(root_hash)
    path = _to_nibbles(key)
    i = 0
    structure = None
    while True:
        if structure is None:
            if i >= len(proof):
                raise ValueError("proof exhausted before path ended")
            blob = bytes(proof[i])
            if keccak256(blob) != expected:
                raise ValueError("proof node hash mismatch")
            structure = rlp_decode(blob)
            i += 1
        if not isinstance(structure, list):
            raise ValueError("malformed proof node")
        if len(structure) == 2:
            path_seg, is_leaf = _hp_decode(structure[0])
            if is_leaf:
                if path_seg == path:
                    if i != len(proof):
                        raise ValueError("trailing proof nodes")
                    return structure[1]
                return None  # proven absence
            if path[:len(path_seg)] != path_seg:
                return None
            path = path[len(path_seg):]
            nxt = structure[1]
        elif len(structure) == 17:
            if not path:
                value = structure[16]
                return value if value != b"" else None
            nxt = structure[path[0]]
            path = path[1:]
            if nxt == b"":
                return None
        else:
            raise ValueError("malformed proof node")
        if isinstance(nxt, list):
            structure = nxt  # embedded child inside the same blob
        else:
            if len(nxt) != 32:
                raise ValueError("malformed child reference")
            expected = bytes(nxt)
            structure = None


def _hp_decode(encoded: bytes):
    """Inverse of hex_prefix_encode -> (nibbles, is_leaf)."""
    if not encoded:
        raise ValueError("empty hex-prefix encoding")
    flag = encoded[0] >> 4
    nibbles = []
    if flag & 1:
        nibbles.append(encoded[0] & 0x0F)
    for b in encoded[1:]:
        nibbles.append(b >> 4)
        nibbles.append(b & 0x0F)
    return tuple(nibbles), bool(flag & 2)


class SecureTrie:
    """Trie over keccak256(key): the state trie's keying
    (`trie/secure_trie.go`)."""

    def __init__(self):
        self._trie = Trie()

    def update(self, key: bytes, value: bytes) -> None:
        self._trie.update(keccak256(key), value)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._trie.get(keccak256(key))

    def delete(self, key: bytes) -> None:
        self._trie.delete(keccak256(key))

    def prove(self, key: bytes) -> list:
        return self._trie.prove(keccak256(key))

    def root_hash(self) -> bytes:
        return self._trie.root_hash()
