"""The dev mainchain's consensus engine (the port's copy of `FakeEngine`
and `InvalidHeader` from the JAX package's `smc/engine.py`; its PoW and
clique engines wait).

An engine decides a produced block's seal payload and hash rule
(`consensus/consensus.go:47-80`), verifies imported blocks, and carries
its own state across the chain's rollbacks (`snapshot`/`restore`).
"""

from __future__ import annotations

from typing import Tuple

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Hash32
from gethsharding_tpu_torch.utils.rlp import int_to_big_endian, rlp_encode


class InvalidHeader(Exception):
    """A block failed engine verification (consensus.ErrInvalidHeader)."""


def _header_rlp(number: int, parent_hash: Hash32, extra: bytes) -> bytes:
    return rlp_encode([int_to_big_endian(number), bytes(parent_hash), extra])


class FakeEngine:
    """ModeFake: no seal work, hash over [number, parent] only.

    Byte-compatible with the pre-engine dev chain (`smc/chain.py`
    `_block_hash`): the empty-extra hash omits the extra field entirely,
    so every existing frozen block-hash vector still holds.
    """

    name = "fake"

    def seal(self, number: int, parent_hash: Hash32) -> Tuple[Hash32, bytes]:
        return self.hash_header(number, parent_hash, b""), b""

    def hash_header(self, number: int, parent_hash: Hash32,
                    extra: bytes) -> Hash32:
        if extra:
            return Hash32(keccak256(_header_rlp(number, parent_hash, extra)))
        return Hash32(keccak256(rlp_encode([int_to_big_endian(number),
                                            bytes(parent_hash)])))

    def verify_header(self, number: int, parent_hash: Hash32, extra: bytes,
                      block_hash: Hash32) -> None:
        if bytes(self.hash_header(number, parent_hash, extra)) != bytes(block_hash):
            raise InvalidHeader(f"block {number}: hash mismatch")

    def finalize(self, number: int, parent_hash: Hash32, extra: bytes) -> None:
        pass

    def snapshot(self):
        return None

    def restore(self, state) -> None:
        pass
