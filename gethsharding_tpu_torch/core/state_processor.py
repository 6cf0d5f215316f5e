"""Phase-1 shard state replay on the host: the scalar twin of the batched
replay (the port's copy of the JAX package's `core/state_processor.py`).

Parity: `core/state_processor.go:56-88` (Process / ApplyTransaction) and
`core/state_transition.go:131,183`, scoped to phase 1: nonce, balance and
intrinsic-gas accounting with sender recovery, no EVM execution, contract
creation (to=None) rejected. The checks run in geth's TransitionDb order:
(1) sender recovery, (2) nonce equality, (3) buy gas (balance >=
gas_limit·gas_price), (4) intrinsic gas <= gas_limit, (5) value transfer
(post-buy balance >= value). Any failure rejects the whole transaction
with no state change.

Two state commitments:

- `ShardState.root`: keccak256 over the accounts in ascending address
  order, each row addr(20) || nonce_be(8) || balance_be(32), which the
  batched replay (`ops/replay.py`) reproduces on the device;
- `ShardState.trie_root`: the canonical secure-MPT state root
  (`core/state/statedb.go:562`): RLP([nonce, balance, storageRoot,
  codeHash]) keyed by keccak256(address), empty accounts absent, built
  by the compiled builder (`core/mpt.py`) where it loaded, else by the
  Python trie (`core/trie.py`), which gives the same root.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.core import mpt
from gethsharding_tpu_torch.core.trie import EMPTY_ROOT, Trie
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto import secp256k1
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32
from gethsharding_tpu_torch.utils.rlp import rlp_encode

# gas cost model (params/protocol_params.go, geth 1.8 / homestead)
GAS_TX = 21000
GAS_TXDATA_ZERO = 4
GAS_TXDATA_NONZERO = 68

MAX_U256 = (1 << 256) - 1


def intrinsic_gas(payload: bytes) -> int:
    """TxGas + per-byte data gas (state_transition.go IntrinsicGas)."""
    nonzero = sum(1 for b in payload if b)
    return (GAS_TX + GAS_TXDATA_NONZERO * nonzero
            + GAS_TXDATA_ZERO * (len(payload) - nonzero))


def recover_sender(tx: Transaction) -> Optional[Address20]:
    """Homestead sender recovery: v = 27 + parity over sig_hash."""
    if tx.v not in (27, 28):
        return None
    try:
        sig = secp256k1.Signature(r=tx.r, s=tx.s, v=tx.v - 27)
        return Address20(secp256k1.ecrecover_address(bytes(tx.sig_hash()),
                                                     sig))
    except (ValueError, AssertionError):
        return None


def sign_transaction(tx: Transaction, priv: int) -> Transaction:
    """Sign in place of the keystore path (homestead v = 27 + parity)."""
    sig = secp256k1.sign(bytes(tx.sig_hash()), priv)
    return Transaction(
        nonce=tx.nonce, gas_price=tx.gas_price, gas_limit=tx.gas_limit,
        to=tx.to, value=tx.value, payload=tx.payload,
        v=27 + sig.v, r=sig.r, s=sig.s,
    )


@dataclass
class AccountState:
    nonce: int = 0
    balance: int = 0


@dataclass
class Receipt:
    status: int              # 1 = applied, 0 = rejected (no state change)
    gas_used: int
    sender: Optional[Address20]


class ShardState:
    """Flat account states with a canonical keccak commitment."""

    def __init__(self,
                 accounts: Optional[Dict[Address20, AccountState]] = None):
        self.accounts: Dict[Address20, AccountState] = dict(accounts or {})

    def get(self, address: Address20) -> AccountState:
        account = self.accounts.get(address)
        if account is None:
            account = AccountState()
            self.accounts[address] = account
        return account

    def root(self) -> Hash32:
        blob = b"".join(
            bytes(addr) + acct.nonce.to_bytes(8, "big")
            + acct.balance.to_bytes(32, "big")
            for addr, acct in sorted(self.accounts.items(),
                                     key=lambda kv: bytes(kv[0]))
        )
        return Hash32(keccak256(blob))

    def trie_root(self) -> Hash32:
        """Canonical secure-MPT state root (see module docstring)."""
        return state_trie_root(self.accounts)


# the state roots built by each route (`chip_smoke.py` reads them)
m_native_state_roots = metrics.counter("trie/state/native_roots")
m_python_state_roots = metrics.counter("trie/state/python_roots")

EMPTY_CODE_HASH = keccak256(b"")  # no shard account carries code in phase 1


def account_rlp(nonce: int, balance: int) -> bytes:
    """The state-trie account value: RLP([nonce, balance, storageRoot,
    codeHash]) with the empty storage root and empty code hash."""
    return rlp_encode([nonce, balance, EMPTY_ROOT, EMPTY_CODE_HASH])


def state_trie_root(accounts: Dict[Address20, AccountState]) -> Hash32:
    """Secure-MPT root over the non-empty accounts: the commitment a geth
    node computes at `statedb.go:562`. Built by the compiled builder
    (`core/mpt.py`, 32-byte keccak keys) where it loaded; the Python trie
    is its fallback and its twin in the tests (`python_state_trie_root`)."""
    items = state_trie_items(accounts)
    if not items:
        return Hash32(EMPTY_ROOT)
    root = mpt.mpt_root([k for k, _ in items], [v for _, v in items])
    if root is not None:
        m_native_state_roots.inc()
        return Hash32(root)
    m_python_state_roots.inc()
    return python_state_trie_root(accounts)


def state_trie_items(accounts: Dict[Address20, AccountState]) -> list:
    """(keccak(address), account RLP) of the non-empty accounts."""
    return [(keccak256(bytes(addr)), account_rlp(acct.nonce, acct.balance))
            for addr, acct in accounts.items() if acct.nonce or acct.balance]


def python_state_trie_root(accounts: Dict[Address20, AccountState]
                           ) -> Hash32:
    """`state_trie_root` built in the Python trie."""
    trie = Trie()  # keys are pre-hashed: a plain trie is the SecureTrie
    for key, value in state_trie_items(accounts):
        trie.update(key, value)
    return Hash32(trie.root_hash())


def apply_transaction(state: ShardState, tx: Transaction,
                      coinbase: Address20) -> Receipt:
    """One phase-1 state transition (ApplyTransaction parity, see module
    docstring for the check order)."""
    sender_addr = recover_sender(tx)
    if sender_addr is None or tx.to is None:
        return Receipt(status=0, gas_used=0, sender=sender_addr)
    sender = state.get(sender_addr)
    if tx.nonce != sender.nonce:
        return Receipt(status=0, gas_used=0, sender=sender_addr)
    gas_cost = tx.gas_limit * tx.gas_price
    if sender.balance < gas_cost:
        return Receipt(status=0, gas_used=0, sender=sender_addr)
    gas = intrinsic_gas(tx.payload)
    if gas > tx.gas_limit:
        return Receipt(status=0, gas_used=0, sender=sender_addr)
    if sender.balance - gas_cost < tx.value:
        return Receipt(status=0, gas_used=0, sender=sender_addr)

    # apply: nonce bump, fee to the coinbase (unused gas refunds net out:
    # phase 1 uses exactly the intrinsic gas), value transfer
    sender.nonce += 1
    fee = gas * tx.gas_price
    sender.balance -= fee + tx.value
    to, cb = state.get(tx.to), state.get(coinbase)
    to.balance = (to.balance + tx.value) & MAX_U256
    cb.balance = (cb.balance + fee) & MAX_U256
    return Receipt(status=1, gas_used=gas, sender=sender_addr)


def process(state: ShardState, txs: Sequence[Transaction],
            coinbase: Address20) -> List[Receipt]:
    """Replay a collation's transactions in order (Process parity)."""
    return [apply_transaction(state, tx, coinbase) for tx in txs]


def replay_account_table(txs: Sequence[Transaction],
                         genesis_addrs,
                         coinbase: Address20) -> List[Address20]:
    """The fixed account table a replay operates over: genesis accounts ∪
    every touched address, ascending by bytes. One definition shared by
    the device marshal (`ops/replay.py::build_replay_inputs`) and the
    host fold-back: the row order is the account identity."""
    addrs = {bytes(a): a for a in genesis_addrs}
    for addr in touched_addresses(txs, coinbase):
        addrs.setdefault(bytes(addr), addr)
    return [addrs[k] for k in sorted(addrs)]


def touched_addresses(txs: Sequence[Transaction],
                      coinbase: Address20) -> List[Address20]:
    """Every address a replay can touch, deduplicated and sorted: the
    coinbase, each recoverable sender and each recipient."""
    seen = {bytes(coinbase): coinbase}
    for tx in txs:
        sender = recover_sender(tx)
        if sender is not None:
            seen.setdefault(bytes(sender), sender)
        if tx.to is not None:
            seen.setdefault(bytes(tx.to), tx.to)
    return [seen[k] for k in sorted(seen)]
