"""The vote digest of the SMC state machine (the port's copy of
`vote_digest` from the JAX package's `smc/state_machine.py`), for the
stress builder's BLS votes."""

from __future__ import annotations

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Hash32


def vote_digest(shard_id: int, period: int, chunk_root: Hash32) -> bytes:
    """The message a notary BLS-signs when voting: the domain-separated
    (shard, period, chunkRoot) tuple. Every committee member of a shard
    signs the same digest, so a period is verified with one aggregate
    pair per shard."""
    return keccak256(
        b"gethsharding-vote-v1/"
        + shard_id.to_bytes(32, "big")
        + period.to_bytes(32, "big")
        + bytes(chunk_root)
    )
