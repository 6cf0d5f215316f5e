"""Tree chunker: content-addressed storage of arbitrary-size data (the
port's copy of the JAX package's `storage/chunker.py`; parity
`swarm/storage/chunker.go`).

Content is split into 4096-byte chunks, every stored chunk prefixed with
its 8-byte little-endian subtree size (`chunker.go:197,220`) and hashed
to its key, and a 128-branching tree of keys is built bottom-up until one
root key addresses the whole blob; retrieval walks keys back down and
joins leaves. The chunk hash is the BMT root of the payload bound to the
span (`key = keccak256(span_le8 || bmt_root)`): the DAS commitment tree's
leaves are these keys, so an erasure-extended chunk is an ordinary stored
chunk.

Integrity is verified on retrieval: every chunk fetched by key is
re-hashed, so a corrupted store surfaces as an error, not silent data.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.db.kv import KVStore, MemoryKV
from gethsharding_tpu_torch.storage.bmt import MAX_CHUNK, bmt_hash

CHUNK_SIZE = MAX_CHUNK  # 4096
BRANCHES = 128
KEY_SIZE = 32


class ChunkStoreError(Exception):
    pass


def chunk_key(span: int, payload: bytes) -> bytes:
    """Address of one stored chunk: the BMT root bound to the subtree
    size it spans (the span prefix of chunker.go:220)."""
    return keccak256(struct.pack("<Q", span) + bmt_hash(payload))


class ChunkStore:
    """Split / join over a KV seam (`db/kv.py`: memory or SQLite)."""

    def __init__(self, kv: Optional[KVStore] = None):
        self.kv = kv if kv is not None else MemoryKV()

    # -- split (store) -----------------------------------------------------

    def _put(self, span: int, payload: bytes) -> bytes:
        key = chunk_key(span, payload)
        self.kv.put(b"chunk:" + key, struct.pack("<Q", span) + payload)
        return key

    def store(self, data: bytes) -> bytes:
        """Chunk `data` into the store; returns the root key."""
        if len(data) <= CHUNK_SIZE:
            return self._put(len(data), data)
        # leaf level: 4096-byte data chunks
        keys: List[bytes] = []
        spans: List[int] = []
        for start in range(0, len(data), CHUNK_SIZE):
            piece = data[start:start + CHUNK_SIZE]
            keys.append(self._put(len(piece), piece))
            spans.append(len(piece))
        # interior levels: chunks of up to 128 child keys, spanning the
        # sum of their subtrees
        while len(keys) > 1:
            next_keys: List[bytes] = []
            next_spans: List[int] = []
            for start in range(0, len(keys), BRANCHES):
                group = keys[start:start + BRANCHES]
                if len(group) == 1:
                    # never wrap a single child: a 1-ary interior node's
                    # span can collide with the leaf range, making
                    # retrieve() misread the key list as user data (the
                    # reference TreeChunker likewise promotes lone
                    # subtrees)
                    next_keys.append(group[0])
                    next_spans.append(spans[start])
                    continue
                span = sum(spans[start:start + BRANCHES])
                payload = b"".join(group)
                next_keys.append(self._put(span, payload))
                next_spans.append(span)
            keys, spans = next_keys, next_spans
        return keys[0]

    # -- join (retrieve) ---------------------------------------------------

    def _get(self, key: bytes) -> tuple:
        raw = self.kv.get(b"chunk:" + key)
        if raw is None:
            raise ChunkStoreError(f"missing chunk {key.hex()}")
        if len(raw) < 8:
            raise ChunkStoreError(f"corrupted chunk {key.hex()} "
                                  "(truncated span)")
        span = struct.unpack("<Q", raw[:8])[0]
        payload = raw[8:]
        if chunk_key(span, payload) != key:
            raise ChunkStoreError(f"corrupted chunk {key.hex()}")
        return span, payload

    def size(self, root: bytes) -> int:
        """Total content size under a root key (span of its chunk)."""
        span, _ = self._get(root)
        return span

    def chunk(self, key: bytes) -> tuple:
        """(span, payload) of one stored chunk, integrity-verified —
        the raw-chunk read surface the network tier (netstore) serves."""
        return self._get(key)

    def put_chunk(self, span: int, payload: bytes) -> bytes:
        """Store one raw chunk (netstore's delivery sink); returns its
        key. The caller verifies the key matches what it requested."""
        return self._put(span, payload)

    def retrieve(self, root: bytes, fetch=None) -> bytes:
        """Reassemble + verify the full content under `root`.

        `fetch(key) -> (span, payload)` overrides how chunks are read —
        the ONE tree walk shared with the network tier (netstore passes
        its network-faulting reader), so the 1-ary-promotion and span
        invariants live in exactly one place."""
        fetch = fetch or self._get
        span, payload = fetch(root)
        if span <= CHUNK_SIZE:
            if len(payload) != span:
                raise ChunkStoreError("leaf span does not match payload")
            return payload
        if len(payload) % KEY_SIZE:
            raise ChunkStoreError("interior chunk is not a key list")
        parts = []
        for start in range(0, len(payload), KEY_SIZE):
            parts.append(self.retrieve(payload[start:start + KEY_SIZE],
                                       fetch=fetch))
        data = b"".join(parts)
        if len(data) != span:
            raise ChunkStoreError("subtree span mismatch")
        return data

    def has(self, root: bytes) -> bool:
        return self.kv.has(b"chunk:" + root)
