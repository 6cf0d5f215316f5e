"""The shard transaction (the port's copy of `Transaction` from the JAX
package's `core/types.py`).

Byte-format parity with `core/types/transaction.go` (geth 1.8.9 txdata):
RLP list [AccountNonce, Price, GasLimit, Recipient, Amount, Payload, V, R,
S]; hash = keccak256(rlp(tx)); the homestead signing hash covers the first
six fields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32
from gethsharding_tpu_torch.utils.rlp import (DecodingError, decode_int,
                                              int_to_big_endian, rlp_decode,
                                              rlp_encode)


def _expect_bytes(item, name: str) -> bytes:
    """Reject list-kind where a string-kind RLP field is required."""
    if not isinstance(item, (bytes, bytearray)):
        raise DecodingError(f"{name}: expected RLP string, got list")
    return bytes(item)


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
