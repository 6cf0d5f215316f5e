"""Binary Merkle Tree chunk hash: the port's copy of the JAX package's
`storage/bmt.py::bmt_hash` and its segment constants (the proofs are not
copied).

The root of a binary merkle tree over 32-byte segments of a chunk of at
most 128 segments (4096 bytes), keccak256 at the nodes. The recursion
splits at the largest power-of-two span below the length, so a short
tail stays raw until it exceeds one segment; a full 4096-byte chunk (the
only size a DAS chunk comes in) is a balanced tree of 128 leaves, which
is the shape the batched verifier (`das/proofs.py`, `csrc/das.cu`) walks.
"""

from __future__ import annotations

from gethsharding_tpu_torch.crypto.keccak import keccak256

SEGMENT_SIZE = 32
SEGMENT_COUNT = 128
MAX_CHUNK = SEGMENT_SIZE * SEGMENT_COUNT  # 4096


class BMTError(Exception):
    pass


def _split_span(length: int) -> int:
    """Largest power-of-two strictly below `length` (in bytes), aligned
    to the segment grid: where the recursion cuts."""
    span = SEGMENT_SIZE
    while span * 2 < length:
        span *= 2
    return span


def bmt_hash(data: bytes) -> bytes:
    """Root of the binary merkle tree over 32-byte segments."""
    if len(data) > MAX_CHUNK:
        raise BMTError(f"chunk exceeds {MAX_CHUNK} bytes")
    return _hash(data)


def _hash(data: bytes) -> bytes:
    if len(data) <= SEGMENT_SIZE:
        return keccak256(data)
    span = _split_span(len(data))
    return keccak256(_hash(data[:span]) + _hash(data[span:]))
