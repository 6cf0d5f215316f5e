"""Wire message types for the shard data-availability protocol (the port's
copy of the JAX package's `p2p/messages.py`: the collation body and chunk
proof messages; the DAS messages wait for the port's `das/service.py`).

Parity: `sharding/p2p/messages/messages.go` (CollationBodyRequest :11,
CollationBodyResponse :20).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32


@dataclass(frozen=True)
class CollationBodyRequest:
    chunk_root: Optional[Hash32]
    shard_id: int
    period: int
    proposer: Optional[Address20]
    # signature of the reconstructed header by the requester
    signature: bytes = b""


@dataclass(frozen=True)
class CollationBodyResponse:
    header_hash: Hash32
    body: bytes


@dataclass(frozen=True)
class ChunkProofRequest:
    """On-demand-retrieval request (the les/light ODR analog): prove
    body byte `index` against a collation's chunk root."""

    chunk_root: Hash32
    shard_id: int
    period: int
    index: int


@dataclass(frozen=True)
class ChunkProofResponse:
    """Merkle proof for one body byte in the per-byte DeriveSha trie;
    `proof` is the root-to-leaf node-blob list (`trie/proof.go` shape).
    Out-of-range indices get a proof of ABSENCE. `body_len` is the
    serving peer's length claim — a light client PROVES it by checking
    a presence proof at body_len-1 and an absence proof at body_len."""

    chunk_root: Hash32
    index: int
    proof: tuple  # tuple[bytes, ...]
    body_len: int = 0
