"""Narrow role interfaces between actors and the mainchain (the port's copy
of the JAX package's `mainchain/interfaces.py`): both `SimulatedMainchain`
and the RPC client's `RemoteMainchain` serve them.

Parity: `sharding/mainchain/interfaces.go:16-68` (Signer, ContractCaller,
ContractTransactor, EthClient/Reader). Actors depend on these protocols —
never on a concrete backend — which is exactly what makes fault-injection
test doubles possible (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32


@runtime_checkable
class Signer(Protocol):
    """Sign a 32-byte hash with the node account (smc_client.go:245)."""

    def sign(self, digest: bytes) -> bytes: ...

    def account(self) -> Address20: ...


@runtime_checkable
class ChainReader(Protocol):
    """Head subscriptions + block access (ethclient Reader surface)."""

    def subscribe_new_head(self, callback): ...

    def block_by_number(self, number: Optional[int] = None): ...

    @property
    def block_number(self) -> int: ...


@runtime_checkable
class ContractCaller(Protocol):
    """SMC view calls (SMCCaller surface)."""

    def get_notary_in_committee(self, sender: Address20, shard_id: int) -> Address20: ...

    def notary_registry(self, address: Address20): ...

    def collation_record(self, shard_id: int, period: int): ...

    def last_submitted_collation(self, shard_id: int) -> int: ...

    def last_approved_collation(self, shard_id: int) -> int: ...


@runtime_checkable
class ContractTransactor(Protocol):
    """SMC transactions (SMCTransactor surface)."""

    def register_notary(self, sender: Address20, value: Optional[int] = None): ...

    def deregister_notary(self, sender: Address20): ...

    def release_notary(self, sender: Address20): ...

    def add_header(self, sender: Address20, shard_id: int, period: int,
                   chunk_root: Hash32, signature: bytes = b""): ...

    def submit_vote(self, sender: Address20, shard_id: int, period: int,
                    index: int, chunk_root: Hash32): ...
