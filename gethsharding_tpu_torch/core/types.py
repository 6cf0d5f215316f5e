"""Consensus types: Transaction, CollationHeader, Collation (the port's
copy of the JAX package's `core/types.py`).

Byte-format parity:
- Transaction mirrors `core/types/transaction.go` (geth 1.8.9 txdata): RLP
  list [AccountNonce, Price, GasLimit, Recipient, Amount, Payload, V, R,
  S]; hash = keccak256(rlp(tx)); the homestead signing hash covers the
  first six fields.
- CollationHeader mirrors `sharding/collation.go:30-64`: RLP list
  [ShardID, ChunkRoot, Period, ProposerAddress, ProposerSignature] with
  geth's nil-pointer rule (nil -> empty string); hash = keccak256(rlp)
  (`collation.go:66 Hash`).
- `serialize_txs_to_blob` / `deserialize_blob_to_txs` mirror
  `collation.go:158,193`: per-tx RLP, 31-byte chunking, the 1 MiB cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.blob import (RawBlob, deserialize_blobs,
                                               serialize_blobs)
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32
from gethsharding_tpu_torch.utils.rlp import (DecodingError, decode_int,
                                              int_to_big_endian, rlp_decode,
                                              rlp_encode)

COLLATION_SIZE_LIMIT = 1 << 20  # 1 MiB (`sharding/collation.go:45`)


def _expect_bytes(item, name: str) -> bytes:
    """Reject list-kind where a string-kind RLP field is required."""
    if not isinstance(item, (bytes, bytearray)):
        raise DecodingError(f"{name}: expected RLP string, got list")
    return bytes(item)


def _expect_sized(item, name: str, size: int) -> bytes:
    data = _expect_bytes(item, name)
    if len(data) != size:
        raise DecodingError(f"{name}: expected {size} bytes, got {len(data)}")
    return data


@dataclass
class Transaction:
    """A shard transaction (phase 1: opaque payload, no shard-state
    execution)."""

    nonce: int = 0
    gas_price: int = 0
    gas_limit: int = 0
    to: Optional[Address20] = None  # None = contract creation (nil Recipient)
    value: int = 0
    payload: bytes = b""
    v: int = 0
    r: int = 0
    s: int = 0

    def fields(self) -> list:
        return [
            int_to_big_endian(self.nonce),
            int_to_big_endian(self.gas_price),
            int_to_big_endian(self.gas_limit),
            bytes(self.to) if self.to is not None else b"",
            int_to_big_endian(self.value),
            self.payload,
            int_to_big_endian(self.v),
            int_to_big_endian(self.r),
            int_to_big_endian(self.s),
        ]

    def encode_rlp(self) -> bytes:
        return rlp_encode(self.fields())

    @classmethod
    def decode_rlp(cls, data: bytes) -> "Transaction":
        items = rlp_decode(data)
        if not isinstance(items, list) or len(items) != 9:
            raise DecodingError("transaction must be a 9-item RLP list")
        names = ("nonce", "gas_price", "gas_limit", "to", "value",
                 "payload", "v", "r", "s")
        fields = [_expect_bytes(item, name)
                  for item, name in zip(items, names)]
        if fields[3] and len(fields[3]) != 20:
            raise DecodingError(f"to: expected 20 bytes, got {len(fields[3])}")
        return cls(
            nonce=decode_int(fields[0]),
            gas_price=decode_int(fields[1]),
            gas_limit=decode_int(fields[2]),
            to=Address20(fields[3]) if fields[3] else None,
            value=decode_int(fields[4]),
            payload=fields[5],
            v=decode_int(fields[6]),
            r=decode_int(fields[7]),
            s=decode_int(fields[8]),
        )

    def hash(self) -> Hash32:
        return Hash32(keccak256(self.encode_rlp()))

    def sig_hash(self, chain_id: Optional[int] = None) -> Hash32:
        """Signing hash: homestead (6 fields) or EIP-155 (9 fields)."""
        items = self.fields()[:6]
        if chain_id is not None:
            items += [int_to_big_endian(chain_id), b"", b""]
        return Hash32(keccak256(rlp_encode(items)))


@dataclass
class CollationHeader:
    """Header of a collation; its hash is what proposers sign and notaries
    vote on."""

    shard_id: Optional[int] = None
    chunk_root: Optional[Hash32] = None
    period: Optional[int] = None
    proposer_address: Optional[Address20] = None
    proposer_signature: bytes = b""

    def _data_fields(self) -> list:
        return [
            int_to_big_endian(self.shard_id) if self.shard_id is not None else b"",
            bytes(self.chunk_root) if self.chunk_root is not None else b"",
            int_to_big_endian(self.period) if self.period is not None else b"",
            bytes(self.proposer_address)
            if self.proposer_address is not None
            else b"",
            self.proposer_signature,
        ]

    def encode_rlp(self) -> bytes:
        return rlp_encode(self._data_fields())

    @classmethod
    def decode_rlp(cls, data: bytes) -> "CollationHeader":
        items = rlp_decode(data)
        if not isinstance(items, list) or len(items) != 5:
            raise DecodingError("collation header must be a 5-item RLP list")
        names = ("shard_id", "chunk_root", "period", "proposer_address",
                 "proposer_signature")
        fields = [_expect_bytes(item, name) for item, name in zip(items, names)]
        return cls(
            # integer fields decode empty as zero (big.Int RLP parity), so a
            # shard-0 header keeps its identity across a DB round trip
            shard_id=decode_int(fields[0]),
            chunk_root=Hash32(_expect_sized(fields[1], "chunk_root", 32))
            if fields[1] != b"" else None,
            period=decode_int(fields[2]),
            proposer_address=Address20(
                _expect_sized(fields[3], "proposer_address", 20)
            )
            if fields[3] != b"" else None,
            proposer_signature=fields[4],
        )

    def hash(self) -> Hash32:
        return Hash32(keccak256(self.encode_rlp()))

    def add_sig(self, sig: bytes) -> None:
        self.proposer_signature = sig


@dataclass
class Collation:
    """Collation = header + serialized body blob + its transactions."""

    header: CollationHeader
    body: bytes = b""
    transactions: List[Transaction] = field(default_factory=list)

    def calculate_chunk_root(self) -> Hash32:
        from gethsharding_tpu_torch.core.derive_sha import chunk_root

        root = Hash32(chunk_root(self.body))
        self.header.chunk_root = root
        return root

    def calculate_poc(self, salt: bytes) -> Hash32:
        from gethsharding_tpu_torch.core.derive_sha import poc_root

        return Hash32(poc_root(self.body, salt))

    def proposer_address(self) -> Optional[Address20]:
        return self.header.proposer_address


def serialize_txs_to_blob(txs: Sequence[Transaction]) -> bytes:
    """RLP-encode each tx, then blob-chunk; enforces the 1 MiB cap."""
    blobs = [RawBlob(data=tx.encode_rlp(), skip_evm=False) for tx in txs]
    serialized = serialize_blobs(blobs)
    if len(serialized) > COLLATION_SIZE_LIMIT:
        raise ValueError(
            f"serialized body size {len(serialized)} exceeds the collation "
            f"size limit {COLLATION_SIZE_LIMIT}"
        )
    return serialized


def deserialize_blob_to_txs(body: bytes) -> List[Transaction]:
    return [Transaction.decode_rlp(blob.data) for blob in deserialize_blobs(body)]
