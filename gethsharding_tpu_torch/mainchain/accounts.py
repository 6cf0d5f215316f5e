"""Account management: the keystore seam (the port's copy of the JAX
package's `mainchain/accounts.py`).

Parity target: `accounts/keystore` as used by SMCClient
(`sharding/mainchain/smc_client.go:218` unlockAccount, :245 Sign): an
in-memory manager of secp256k1 keys with unlock semantics. Each account
also derives its BLS vote keypair from its secp256k1 key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from gethsharding_tpu_torch.crypto import bn256, secp256k1
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Address20


@dataclass
class Account:
    address: Address20
    priv: int
    unlocked: bool = False
    # BLS vote keypair, derived deterministically from the secp256k1 key
    # (one identity, two signature schemes: ECDSA for transactions, BLS for
    # aggregatable committee votes)
    _bls: Optional[Tuple[int, bn256.G2Point]] = field(
        default=None, repr=False, compare=False)

    def bls_keypair(self) -> Tuple[int, bn256.G2Point]:
        if self._bls is None:
            self._bls = bn256.bls_keygen(self.priv.to_bytes(32, "big"))
        return self._bls

    @property
    def bls_pubkey(self) -> bn256.G2Point:
        return self.bls_keypair()[1]


class AccountManager:
    """Holds accounts; signing requires an unlocked account."""

    def __init__(self):
        self._accounts: Dict[Address20, Account] = {}

    def new_account(self, seed: bytes = b"", unlock: bool = True) -> Account:
        if seed:
            priv = int.from_bytes(keccak256(b"key" + seed), "big") % secp256k1.N
            priv = priv or 1
        else:
            import secrets

            priv = secrets.randbelow(secp256k1.N - 1) + 1
        account = Account(
            address=Address20(secp256k1.priv_to_address(priv)), priv=priv, unlocked=unlock
        )
        self._accounts[account.address] = account
        return account

    def import_key(self, priv: int, unlock: bool = True) -> Account:
        account = Account(
            address=Address20(secp256k1.priv_to_address(priv)), priv=priv, unlocked=unlock
        )
        self._accounts[account.address] = account
        return account

    def unlock(self, address: Address20) -> None:
        self._accounts[address].unlocked = True

    def lock(self, address: Address20) -> None:
        self._accounts[address].unlocked = False

    def get(self, address: Address20) -> Optional[Account]:
        return self._accounts.get(address)

    def sign_hash(self, address: Address20, digest: bytes) -> bytes:
        account = self._require_unlocked(address)
        return secp256k1.sign(digest, account.priv).to_bytes65()

    def bls_sign(self, address: Address20, message: bytes) -> bn256.G1Point:
        """BLS-sign a vote message with the account's derived vote key."""
        account = self._require_unlocked(address)
        sk, _ = account.bls_keypair()
        return bn256.bls_sign(message, sk)

    def bls_proof_of_possession(self, address: Address20) -> bn256.G1Point:
        """PoP binding the vote pubkey to its secret key (rogue-key defense;
        verified in batch by the notary audit pipeline, not per-tx)."""
        account = self._require_unlocked(address)
        sk, pk = account.bls_keypair()
        return bn256.bls_prove_possession(sk, pk)

    def _require_unlocked(self, address: Address20) -> Account:
        account = self._accounts.get(address)
        if account is None:
            raise KeyError(f"unknown account {address.hex_str}")
        if not account.unlocked:
            raise PermissionError(f"account {address.hex_str} is locked")
        return account
