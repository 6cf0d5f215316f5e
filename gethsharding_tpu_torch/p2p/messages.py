"""Wire message types for the shard data-availability protocol (the port's
copy of the JAX package's `p2p/messages.py`: the collation body and chunk
proof messages, and the DAS plane's commitment, sample and multiproof
messages).

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


# -- data-availability sampling (das/) ------------------------------------


@dataclass(frozen=True)
class DASCommitmentRequest:
    """Who holds the DAS commitment for this (shard, period)?"""

    shard_id: int
    period: int


@dataclass(frozen=True)
class DASCommitmentResponse:
    """The proposer's erasure-extension commitment: the DAS merkle
    root over the extended blob's netstore chunk keys, the code shape
    (k data of n total chunks), the exact body length, and the
    proposer's signature binding all of it to the on-chain chunk_root
    (das/service.commitment_digest)."""

    shard_id: int
    period: int
    chunk_root: Hash32
    das_root: bytes
    k: int
    n: int
    body_len: int
    # 64-byte G1 polynomial commitment to the extended blob's chunk
    # values (das/pcs.py) — empty in merkle-only mode; when present it
    # is signed into the same commitment digest as the merkle root
    poly_commitment: bytes = b""
    signature: bytes = b""


@dataclass(frozen=True)
class DASampleRequest:
    """Sampled-chunk pull: the requester wants chunks `indices` of the
    blob committed at `das_root`, each with its inclusion proof."""

    das_root: bytes
    indices: tuple  # tuple[int, ...]


@dataclass(frozen=True)
class DASampleResponse:
    """One sampled chunk + its sibling path to `das_root` — the unit a
    notary feeds the batched `das_verify_samples` dispatch."""

    das_root: bytes
    index: int
    chunk: bytes
    proof: tuple  # tuple[bytes, ...]


@dataclass(frozen=True)
class DASMultiproofRequest:
    """Multiproof-mode sampled-chunk pull: the requester wants chunks
    `indices` of the blob committed at `das_root` plus ONE constant-
    size polynomial multiproof opening the poly commitment at exactly
    those indices (das/pcs.open_multi)."""

    das_root: bytes
    indices: tuple  # tuple[int, ...]


@dataclass(frozen=True)
class DASMultiproofResponse:
    """All requested chunks + the single 64-byte G1 multiproof — the
    unit a notary or light client turns into one row of the batched
    `das_verify_multiproofs` dispatch (evaluations are derived from
    the chunk bytes host-side, never trusted from the wire)."""

    das_root: bytes
    indices: tuple  # tuple[int, ...]
    chunks: tuple  # tuple[bytes, ...], aligned with indices
    proof: bytes = b""
