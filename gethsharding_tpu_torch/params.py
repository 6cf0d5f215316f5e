"""Protocol configuration (the port's copy of the JAX package's
`params.py`): one frozen Config, values per sharding_manager.sol:56-73."""

from __future__ import annotations

from dataclasses import dataclass

ETHER = 10**18


@dataclass(frozen=True)
class Config:
    """Sharding protocol constants (values per sharding_manager.sol:56-73)."""

    shard_count: int = 100
    period_length: int = 5  # mainchain blocks per period
    notary_deposit: int = 1000 * ETHER
    notary_lockup_length: int = 16128  # periods
    proposer_lockup_length: int = 48  # periods (sharding/params/config.go)
    committee_size: int = 135
    quorum_size: int = 90
    lookahead_length: int = 4  # periods of committee lookahead
    challenge_period: int = 25  # proof-of-custody challenge window
    collation_size_limit: int = 1 << 20  # bytes
    # enforced windback: prior periods' bodies a notary must hold before
    # it may vote (0 disables)
    windback_depth: int = 0
    # dev-chain network identity: peers of another network are rejected
    network_id: int = 1337


DEFAULT_CONFIG = Config()
