"""The hexary Merkle-Patricia trie's root (the port's copy of the insert
and hashing half of the JAX package's `core/trie.py`), for the canonical
state root `state_processor.state_trie_root`.

Node encoding follows the Ethereum yellow paper / go-ethereum 1.8:
leaf and extension nodes are 2-item RLP lists [hex-prefix path, value],
branch nodes 17-item lists (16 children + value), and a node whose RLP
is >= 32 bytes is referenced by its keccak256, a shorter one embedded in
its parent. The empty trie's root is keccak256(rlp(b"")). This is host
code; the replay's device commitment is the flat one (`ops/replay.py`).
"""

from __future__ import annotations

from typing import Optional

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.rlp import rlp_encode

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


class _Leaf:
    __slots__ = ("path", "value")

    def __init__(self, path: tuple, value: bytes):
        self.path = path
        self.value = value


class _Extension:
    __slots__ = ("path", "child")

    def __init__(self, path: tuple, child):
        self.path = path
        self.child = child


class _Branch:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: list = [None] * 16
        self.value: Optional[bytes] = None


def _common_prefix_len(a: tuple, b: tuple) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class Trie:
    """Insert-only Merkle-Patricia trie over byte keys and non-empty
    values, with the reference's root hash."""

    def __init__(self):
        self._root = None

    def update(self, key: bytes, value: bytes) -> None:
        if value == b"":
            raise ValueError("an empty value deletes a key; this trie only "
                             "inserts")
        self._root = self._insert(self._root, _to_nibbles(key), value)

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
        if not path:
            node.value = value
            return node
        node.children[path[0]] = self._insert(node.children[path[0]],
                                              path[1:], value)
        return node

    def root_hash(self) -> bytes:
        if self._root is None:
            return EMPTY_ROOT
        # the root node is always hashed, whatever its encoded size
        return keccak256(rlp_encode(self._node_structure(self._root)))

    def _node_structure(self, node):
        if isinstance(node, _Leaf):
            return [hex_prefix_encode(node.path, True), node.value]
        if isinstance(node, _Extension):
            return [hex_prefix_encode(node.path, False),
                    self._encode_child(node.child)]
        items = [b"" if child is None else self._encode_child(child)
                 for child in node.children]
        items.append(node.value if node.value is not None else b"")
        return items

    def _encode_child(self, node):
        structure = self._node_structure(node)
        raw = rlp_encode(structure)
        if len(raw) >= 32:
            return keccak256(raw)
        return structure  # embedded node: nested list inside parent RLP
