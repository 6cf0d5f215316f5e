"""Per-shard persistence façade (the port's copy of the JAX package's
`core/shard.py`).

Parity: `sharding/shard.go` — header/body CRUD keyed by hash/chunk-root,
availability bits, and the canonical (shardID, period) -> header index, with
byte-identical lookup-key derivation (`shard.go:237-249`:
`BytesToHash("availability-lookup:<0xroot>")` and
`BytesToHash("canonical-collation-lookup:shardID=<d>,period=<d>")`, keeping
the LAST 32 bytes of the formatted string).
"""

from __future__ import annotations

from typing import Optional

from gethsharding_tpu_torch.core.derive_sha import chunk_root as compute_chunk_root
from gethsharding_tpu_torch.core.types import (
    Collation,
    CollationHeader,
    deserialize_blob_to_txs,
)
from gethsharding_tpu_torch.db.kv import KVStore
from gethsharding_tpu_torch.utils.hexbytes import Hash32


class ShardError(Exception):
    pass


def data_availability_lookup_key(chunk_root: Hash32) -> Hash32:
    return Hash32(f"availability-lookup:0x{bytes(chunk_root).hex()}".encode())


def canonical_collation_lookup_key(shard_id: int, period: int) -> Hash32:
    return Hash32(
        f"canonical-collation-lookup:shardID={shard_id},period={period}".encode()
    )


class Shard:
    """Fetch/store collations for one shard over any KVStore engine."""

    def __init__(self, shard_id: int, shard_db: KVStore):
        self.shard_id = shard_id
        self._db = shard_db

    def validate_shard_id(self, header: CollationHeader) -> None:
        if header.shard_id != self.shard_id:
            raise ShardError(
                f"collation does not belong to shard {self.shard_id} but "
                f"instead has shardID {header.shard_id}"
            )

    # -- reads -------------------------------------------------------------

    def header_by_hash(self, header_hash: Hash32) -> CollationHeader:
        encoded = self._db.get(bytes(header_hash))
        if not encoded:
            raise ShardError(f"no value set for header hash: {header_hash.hex_str}")
        return CollationHeader.decode_rlp(encoded)

    def collation_by_header_hash(self, header_hash: Hash32) -> Collation:
        header = self.header_by_hash(header_hash)
        body = self.body_by_chunk_root(header.chunk_root)
        txs = deserialize_blob_to_txs(body)
        return Collation(header=header, body=body, transactions=txs)

    def chunk_root_from_header_hash(self, header_hash: Hash32) -> Optional[Hash32]:
        return self.collation_by_header_hash(header_hash).header.chunk_root

    def canonical_header_hash(self, shard_id: int, period: int) -> Hash32:
        key = canonical_collation_lookup_key(shard_id, period)
        encoded = self._db.get(bytes(key))
        if not encoded:
            raise ShardError(
                f"no canonical collation header set for period={period}, "
                f"shardID={shard_id} pair"
            )
        return CollationHeader.decode_rlp(encoded).hash()

    def canonical_collation(self, shard_id: int, period: int) -> Collation:
        return self.collation_by_header_hash(
            self.canonical_header_hash(shard_id, period)
        )

    def body_by_chunk_root(self, chunk_root: Optional[Hash32]) -> bytes:
        if chunk_root is None:
            raise ShardError("header has no chunk root")
        body = self._db.get(bytes(chunk_root))
        if not body:
            raise ShardError(
                f"no corresponding body with chunk root found: {chunk_root.hex_str}"
            )
        return body

    def check_availability(self, header: CollationHeader) -> bool:
        if header.chunk_root is None:
            raise ShardError("header has no chunk root")
        key = data_availability_lookup_key(header.chunk_root)
        availability = self._db.get(bytes(key))
        if not availability:
            raise ShardError("availability not set for header")
        return availability[0] != 0

    # -- writes ------------------------------------------------------------

    def set_availability(self, chunk_root: Hash32, availability: bool) -> None:
        key = data_availability_lookup_key(chunk_root)
        self._db.put(bytes(key), b"\x01" if availability else b"\x00")

    def save_header(self, header: CollationHeader) -> None:
        if header.chunk_root is None:
            raise ShardError("header needs to have a chunk root set before saving")
        self._db.put(bytes(header.hash()), header.encode_rlp())

    def save_body(self, body: bytes) -> None:
        if not body:
            raise ShardError("body is empty")
        root = Hash32(compute_chunk_root(body))
        self.set_availability(root, True)
        self._db.put(bytes(root), body)

    def save_collation(self, collation: Collation) -> None:
        self.validate_shard_id(collation.header)
        self.save_header(collation.header)
        self.save_body(collation.body)

    def set_canonical(self, header: CollationHeader) -> None:
        self.validate_shard_id(header)
        # header and body must already be in the DB
        db_header = self.header_by_hash(header.hash())
        self.body_by_chunk_root(db_header.chunk_root)
        key = canonical_collation_lookup_key(db_header.shard_id, db_header.period)
        self._db.put(bytes(key), db_header.encode_rlp())
