"""Collation-body blob chunk codec (the port's copy of the JAX package's
`utils/blob.py`, without its numpy form).

Wire-format parity with `sharding/utils/marshal.go` (Serialize :71,
Deserialize :144): RLP payloads are packed into 32-byte chunks of
[1 indicator byte | 31 data bytes]. Non-terminal chunks carry indicator 0;
the terminal chunk's indicator holds the terminal data length in its low 5
bits and the skip-EVM flag in bit 7, and is zero-padded to 31 data bytes.
These bytes are merklized into the chunk root, so they must round-trip
byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

CHUNK_SIZE = 32
INDICATOR_SIZE = 1
CHUNK_DATA_SIZE = CHUNK_SIZE - INDICATOR_SIZE  # 31
SKIP_EVM_BIT = 0x80
DATA_LENGTH_MASK = 0x1F


@dataclass
class RawBlob:
    """One RLP-encoded payload plus its skip-EVM execution flag."""

    data: bytes
    skip_evm: bool = False


def _num_chunks(data_size: int) -> int:
    return -(-data_size // CHUNK_DATA_SIZE)  # ceil division


def serialize_blobs(blobs: Sequence[RawBlob]) -> bytes:
    """Pack blobs into the 32-byte chunk stream."""
    out = bytearray()
    for blob in blobs:
        data = blob.data
        n = _num_chunks(len(data))
        for j in range(n):
            if j != n - 1:
                out.append(0)
                out += data[j * CHUNK_DATA_SIZE : (j + 1) * CHUNK_DATA_SIZE]
            else:
                terminal_len = len(data) - (n - 1) * CHUNK_DATA_SIZE
                indicator = terminal_len
                if blob.skip_evm:
                    indicator |= SKIP_EVM_BIT
                out.append(indicator)
                out += data[j * CHUNK_DATA_SIZE : j * CHUNK_DATA_SIZE + terminal_len]
                out += b"\x00" * (CHUNK_DATA_SIZE - terminal_len)
    return bytes(out)


def deserialize_blobs(data: bytes) -> List[RawBlob]:
    """Inverse of serialize_blobs; ignores a trailing partial chunk like the reference."""
    n_chunks = len(data) // CHUNK_SIZE
    blobs: List[RawBlob] = []
    acc = bytearray()
    for i in range(n_chunks):
        chunk = data[i * CHUNK_SIZE : (i + 1) * CHUNK_SIZE]
        indicator = chunk[0]
        terminal_len = indicator & DATA_LENGTH_MASK
        if terminal_len == 0:
            # non-terminal chunk: all 31 data bytes belong to the current blob
            acc += chunk[1:]
        else:
            acc += chunk[1 : 1 + terminal_len]
            blobs.append(
                RawBlob(data=bytes(acc), skip_evm=bool(indicator & SKIP_EVM_BIT))
            )
            acc = bytearray()
    return blobs
