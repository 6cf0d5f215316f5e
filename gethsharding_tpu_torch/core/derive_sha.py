"""DeriveSha: merklize an indexed list into a trie root (the port's copy
of `derive_sha` and `chunk_root` from the JAX package's
`core/derive_sha.py`; the chunk proofs wait, as the port's trie has no
proofs).

Parity with `core/types/derive_sha.go:32`: a trie mapping rlp(uint index)
-> item-RLP, returning the root hash. The collation chunk root
(`sharding/collation.go:115 CalculateChunkRoot`) applies it to the body's
bytes, one list entry a byte (`collation.go:210-220`).
"""

from __future__ import annotations

from typing import Sequence

from gethsharding_tpu_torch.core.trie import EMPTY_ROOT, Trie
from gethsharding_tpu_torch.utils.rlp import int_to_big_endian, rlp_encode


def derive_sha(items: Sequence[bytes]) -> bytes:
    """Root hash over rlp(index) -> item (items are already RLP-encoded)."""
    if not items:
        return EMPTY_ROOT
    trie = Trie()
    for index, item in enumerate(items):
        trie.update(rlp_encode(int_to_big_endian(index)), item)
    return trie.root_hash()


def chunk_root(body: bytes) -> bytes:
    """Chunk root of a serialized collation body (per-byte DeriveSha).

    `Chunks.GetRlp(i)` RLP-encodes the single byte body[i] as a uint (Go's
    `rlp.EncodeToBytes(byte)` takes writeUint), so 0x00 encodes as 0x80,
    not as a 1-byte string.
    """
    return derive_sha([rlp_encode(int(b)) for b in body])
