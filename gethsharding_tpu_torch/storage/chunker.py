"""The netstore chunk address: the port's copy of the JAX package's
`storage/chunker.py::chunk_key` (the chunk store is not copied)."""

from __future__ import annotations

import struct

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.storage.bmt import MAX_CHUNK, bmt_hash

CHUNK_SIZE = MAX_CHUNK  # 4096


def chunk_key(span: int, payload: bytes) -> bytes:
    """Address of one stored chunk: the BMT root bound to the subtree
    size it spans (the 8-byte little-endian span prefix)."""
    return keccak256(struct.pack("<Q", span) + bmt_hash(payload))
