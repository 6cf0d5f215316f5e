"""SMCClient: the actor-side handle on the mainchain and its SMC (the port's
copy of the JAX package's `mainchain/client.py`, on the in-process
`SimulatedMainchain`).

Parity: `sharding/mainchain/smc_client.go` (NewSMCClient :49, Start :72,
Sign :245, WaitForTransaction :165). Transactions apply synchronously, so
`wait_for_transaction` resolves at once.

`stop()` marks the client stopped: in-flight `wait_for_transaction` polls
exit promptly and every later call raises `ClientStopped`. Reads of the
in-process chain cannot fail transiently, so none is retried; the read
retries of a remote chain come with the port's `rpc/codec.py`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from gethsharding_tpu_torch.mainchain.accounts import Account, AccountManager
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.smc.chain import Receipt, SimulatedMainchain
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32


class ClientStopped(RuntimeError):
    """The SMCClient was stopped; this call can never complete."""


class SMCClient:
    """Wraps a chain backend and a signing account into the actor-facing
    API: signer (sign/account), chain reader (heads/blocks), and the SMC's
    calls and transactions."""

    def __init__(self, backend: Optional[SimulatedMainchain] = None,
                 accounts: Optional[AccountManager] = None,
                 account: Optional[Account] = None,
                 deposit_flag: bool = False,
                 config: Config = DEFAULT_CONFIG):
        self.backend = backend if backend is not None else SimulatedMainchain(config)
        self.accounts = accounts or AccountManager()
        # a FRESH identity per client unless one is supplied (keystore or
        # caller): a fixed default seed would make every node in a
        # multi-node deployment the same notary
        self._account = account or self.accounts.new_account()
        self.deposit_flag = deposit_flag
        self.config = config
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # parity with SMCClient.Start: dial backend, unlock account, bind SMC
        self._stop.clear()
        self.accounts.unlock(self._account.address)

    def stop(self) -> None:
        """Mark the client stopped: in-flight `wait_for_transaction`
        polls exit promptly and later calls raise `ClientStopped`."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def _ensure_running(self) -> None:
        if self._stop.is_set():
            raise ClientStopped("SMCClient is stopped")

    def _read(self, fn, *args, **kwargs):
        """One backend read behind the stop gate."""
        self._ensure_running()
        return fn(*args, **kwargs)

    # -- Signer ------------------------------------------------------------

    def account(self) -> Address20:
        return self._account.address

    def sign(self, digest: bytes) -> bytes:
        self._ensure_running()
        return self.accounts.sign_hash(self._account.address, digest)

    def bls_sign(self, message: bytes):
        """Sign a vote message with the account's BLS vote key."""
        self._ensure_running()
        return self.accounts.bls_sign(self._account.address, message)

    # -- ChainReader -------------------------------------------------------

    def subscribe_new_head(self, callback):
        self._ensure_running()
        return self.backend.subscribe_new_head(callback)

    def block_by_number(self, number: Optional[int] = None):
        return self._read(self.backend.block_by_number, number)

    @property
    def block_number(self) -> int:
        return self._read(lambda: self.backend.block_number)

    def current_period(self) -> int:
        return self._read(self.backend.current_period)

    # -- ContractCaller ----------------------------------------------------

    def get_notary_in_committee(self, shard_id: int,
                                sender: Optional[Address20] = None) -> Address20:
        return self._read(
            self.backend.get_notary_in_committee,
            sender if sender is not None else self._account.address, shard_id)

    def committee_context(self) -> Optional[dict]:
        """One-call sampling context for local all-shard eligibility
        (None when the backend doesn't serve it)."""
        fn = getattr(self.backend, "committee_context", None)
        return self._read(fn) if fn is not None else None

    def notary_registry(self, address: Optional[Address20] = None):
        return self._read(
            self.backend.notary_registry,
            address if address is not None else self._account.address)

    def collation_record(self, shard_id: int, period: int):
        return self._read(self.backend.collation_record, shard_id, period)

    def last_submitted_collation(self, shard_id: int) -> int:
        return self._read(self.backend.last_submitted_collation, shard_id)

    def last_approved_collation(self, shard_id: int) -> int:
        return self._read(self.backend.last_approved_collation, shard_id)

    def has_voted(self, shard_id: int, index: int) -> bool:
        return self._read(self.backend.has_voted, shard_id, index)

    def get_vote_count(self, shard_id: int) -> int:
        return self._read(self.backend.get_vote_count, shard_id)

    def shard_count(self) -> int:
        return self._read(self.backend.shard_count)

    # -- ContractTransactor ------------------------------------------------

    def register_notary(self) -> Receipt:
        self._ensure_running()
        # the vote pubkey + proof of possession register with the deposit;
        # validators batch-verify PoPs (rogue-key defense) in the audit
        return self.backend.register_notary(
            self._account.address,
            bls_pubkey=self._account.bls_pubkey,
            bls_pop=self.accounts.bls_proof_of_possession(
                self._account.address),
        )

    def deregister_notary(self) -> Receipt:
        self._ensure_running()
        return self.backend.deregister_notary(self._account.address)

    def release_notary(self) -> Receipt:
        self._ensure_running()
        return self.backend.release_notary(self._account.address)

    def add_header(self, shard_id: int, period: int, chunk_root: Hash32,
                   signature: bytes = b"") -> Receipt:
        self._ensure_running()
        return self.backend.add_header(self._account.address, shard_id,
                                       period, chunk_root, signature)

    def submit_vote(self, shard_id: int, period: int, index: int,
                    chunk_root: Hash32, bls_sig=None) -> Receipt:
        self._ensure_running()
        return self.backend.submit_vote(self._account.address, shard_id,
                                        period, index, chunk_root,
                                        bls_sig=bls_sig)

    def notary_by_pool_index(self, index: int) -> Optional[Address20]:
        return self._read(self.backend.notary_by_pool_index, index)

    def notary_registry_of(self, address: Address20):
        return self._read(self.backend.notary_registry, address)

    def verify_period_batch(self, period: int,
                            device=None) -> Optional[bool]:
        """Chain-side batched vote-replay audit on `device` (None: the
        card); None if the backend does not serve it."""
        fn = getattr(self.backend, "verify_period_batch", None)
        return (self._read(fn, period, device=device) if fn is not None
                else None)

    def audit_data(self, period: int) -> dict:
        """Bulk period-audit data (records + vote sigs + voter pubkeys) —
        one round trip against backends that serve it in bulk; the
        in-process walk skips the hex wire codec (raw point tuples)."""
        fn = getattr(self.backend, "audit_data", None)
        if fn is not None:
            return self._read(fn, period)
        from gethsharding_tpu_torch.mainchain.mirror import assemble_audit_data

        return assemble_audit_data(self, period)

    # -- tx resilience (WaitForTransaction parity) ------------------------

    def wait_for_transaction(self, tx_hash: Hash32,
                             timeout_s: float = 10.0) -> Receipt:
        self._ensure_running()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            receipt = self._read(self.backend.transaction_receipt, tx_hash)
            if receipt is not None:
                return receipt
            # the stop event doubles as the poll sleep: a concurrent
            # stop() wakes the wait immediately instead of letting the
            # loop spin out its remaining timeout against a dead backend
            if self._stop.wait(0.01):
                raise ClientStopped(
                    f"client stopped while waiting for transaction "
                    f"{tx_hash.hex_str}")
        raise TimeoutError(f"transaction {tx_hash.hex_str} not mined in time")
