"""Shard transaction pool service (the port's copy of the JAX package's
`actors/txpool.py`).

Parity targets, two tiers:
- `sharding/txpool/service.go` — the reference's shard pool emits a fake
  1024-random-byte tx every 5 s into an event feed (`sendTestTransaction
  :47`). That simulation mode is kept (configurable interval).
- `core/tx_pool.go:184` — the REAL pool underneath geth, which the
  sharding stub never grew into: a validated, deduplicated, price-aware
  pending set with per-sender nonce ordering, gapped-nonce queueing,
  capacity eviction of the cheapest transactions, and a crash-safe
  journal replayed on restart (`core/tx_journal.go:51`).

`submit()` feeds both worlds: accepted transactions enter the pending
structures AND are published on the feed the proposer subscribes to.
Signed transactions are keyed by recovered sender; phase-1 opaque
payloads (no signature) are admitted under a zero sender with feed-order
nonce semantics.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from gethsharding_tpu_torch import metrics, tracing
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core.state_processor import recover_sender
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.p2p.feed import Feed
from gethsharding_tpu_torch.utils.hexbytes import Address20


class TxPoolError(Exception):
    pass


class TXPool(Service):
    name = "txpool"

    def __init__(self, simulate_interval: Optional[float] = 5.0,
                 payload_size: int = 1024, capacity: int = 4096,
                 max_payload: int = 1 << 20,
                 journal_path: Optional[str] = None,
                 sig_backend=None):
        super().__init__()
        self.transactions_feed = Feed()
        self.simulate_interval = simulate_interval
        self.payload_size = payload_size
        self.capacity = capacity
        self.max_payload = max_payload
        self.journal_path = journal_path
        # sender recovery through a SigBackend (one batch row a
        # transaction) when one is given; None, the plain node's choice,
        # is the host's scalar recovery
        self.sig_backend = sig_backend
        self._nonce = 0
        # sender -> {nonce: tx}; contiguous-from-lowest prefix is pending,
        # the gapped remainder queued (tx_pool.go pending/queue split)
        self._by_sender: Dict[Address20, Dict[int, Transaction]] = {}
        self._hashes: set = set()
        # tx hash -> sender recovered at admission (core/tx_pool.go's
        # sender cache): removal paths — take_pending() for every
        # collation — must never pay recovery again
        self._senders: Dict[bytes, Address20] = {}
        self.m_known = metrics.gauge("txpool/known")
        self.m_dropped = metrics.counter("txpool/evicted")

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.journal_path:
            self._replay_journal()
        if self.simulate_interval is not None:
            self.spawn(self._send_test_transactions)

    # -- intake (core/tx_pool.go add/validateTx) ---------------------------

    def submit(self, tx: Transaction) -> int:
        """Validate + admit a transaction, journal it, and publish it on
        the proposer feed. Returns the feed subscriber count.
        Raises TxPoolError for invalid or duplicate transactions."""
        self._admit(tx)
        if self.journal_path:
            self._journal(tx)
        return self.transactions_feed.send(tx)

    def _admit(self, tx: Transaction) -> None:
        if len(tx.payload) > self.max_payload:
            raise TxPoolError("payload exceeds size cap")
        tx_hash = bytes(tx.hash())
        if tx_hash in self._hashes:
            raise TxPoolError("already known")
        sender = self._sender_of(tx)
        slot = self._by_sender.setdefault(sender, {})
        existing = slot.get(tx.nonce)
        if existing is not None:
            # replacement requires a strictly higher price (the reference's
            # price-bump rule, simplified to >)
            if tx.gas_price <= existing.gas_price:
                raise TxPoolError("replacement transaction underpriced")
            old_hash = bytes(existing.hash())
            self._hashes.discard(old_hash)
            self._senders.pop(old_hash, None)
        slot[tx.nonce] = tx
        self._hashes.add(tx_hash)
        self._senders[tx_hash] = sender
        self._enforce_capacity()
        self.m_known.set(len(self._hashes))

    def _sender_of(self, tx: Transaction) -> Address20:
        if tx.v or tx.r or tx.s:
            # the admission hot spot: recovery latency per submitted
            # transaction
            with tracing.span("txpool/recover_sender"):
                if self.sig_backend is not None:
                    try:
                        sender = self._recover_via_backend(tx)
                    except Exception as exc:  # noqa: BLE001 - the pool's
                        # contract is TxPoolError only: a backend failure
                        # must read as a pool rejection the caller can
                        # retry, not crash the submitter/proposer loop
                        raise TxPoolError(
                            f"signature verification unavailable: {exc}"
                        ) from exc
                else:
                    sender = recover_sender(tx)
            if sender is None:
                raise TxPoolError("invalid signature")
            return sender
        return Address20()  # phase-1 opaque txs pool under the zero sender

    def _recover_via_backend(self, tx: Transaction) -> Optional[Address20]:
        """`recover_sender` through the SigBackend seam: same homestead
        rule (v = 27 + parity over sig_hash), but the recovery itself is
        a backend batch row (one `ecrecover` launch on the card)."""
        if tx.v not in (27, 28):
            return None
        try:
            sig65 = (tx.r.to_bytes(32, "big") + tx.s.to_bytes(32, "big")
                     + bytes([tx.v - 27]))
        except (OverflowError, ValueError):
            return None  # out-of-range r/s: invalid, like the scalar path
        return self.sig_backend.ecrecover_addresses(
            [bytes(tx.sig_hash())], [sig65])[0]

    def _enforce_capacity(self) -> None:
        """Evict the globally cheapest transactions over capacity
        (highest nonce first within a sender, so prefixes stay intact)."""
        while len(self._hashes) > self.capacity:
            cheapest: Optional[Tuple[Address20, int]] = None
            cheapest_price = None
            for sender, slot in self._by_sender.items():
                nonce = max(slot)
                price = slot[nonce].gas_price
                if cheapest_price is None or price < cheapest_price:
                    cheapest, cheapest_price = (sender, nonce), price
            sender, nonce = cheapest
            victim = self._by_sender[sender].pop(nonce)
            if not self._by_sender[sender]:
                del self._by_sender[sender]
            victim_hash = bytes(victim.hash())
            self._hashes.discard(victim_hash)
            self._senders.pop(victim_hash, None)
            self.m_dropped.inc()

    # -- views (tx_pool.go Pending) ----------------------------------------

    def pending(self, limit: Optional[int] = None) -> List[Transaction]:
        """Executable transactions: per sender the contiguous nonce run
        from its lowest pooled nonce, merged across senders by price
        (descending), nonce order preserved within a sender."""
        runs = []
        for sender, slot in self._by_sender.items():
            nonces = sorted(slot)
            run = [slot[nonces[0]]]
            for prev, cur in zip(nonces, nonces[1:]):
                if cur != prev + 1:
                    break
                run.append(slot[cur])
            runs.append(run)
        # price-greedy merge: repeatedly take the head with the best price
        out: List[Transaction] = []
        heads = [(run, 0) for run in runs]
        while heads and (limit is None or len(out) < limit):
            best = max(range(len(heads)),
                       key=lambda i: heads[i][0][heads[i][1]].gas_price)
            run, idx = heads[best]
            out.append(run[idx])
            if idx + 1 < len(run):
                heads[best] = (run, idx + 1)
            else:
                heads.pop(best)
        return out

    def queued_count(self) -> int:
        """Transactions parked behind nonce gaps."""
        total = 0
        for slot in self._by_sender.values():
            nonces = sorted(slot)
            run = 1
            for prev, cur in zip(nonces, nonces[1:]):
                if cur != prev + 1:
                    break
                run += 1
            total += len(nonces) - run
        return total

    def known_count(self) -> int:
        return len(self._hashes)

    def take_pending(self, limit: Optional[int] = None) -> List[Transaction]:
        """Pop the current pending selection for inclusion in a collation
        (the reference drops mined txs from the pool on block events)."""
        out = self.pending(limit)
        self.remove(out)
        return out

    def remove(self, txs: List[Transaction]) -> None:
        for tx in txs:
            tx_hash = bytes(tx.hash())
            if tx_hash not in self._hashes:
                continue
            self._hashes.discard(tx_hash)
            # admission-time sender cache: the removal hot path
            # (take_pending per collation) must not re-run recovery —
            # per tx that would be a fresh backend dispatch each
            sender = self._senders.pop(tx_hash, None)
            if sender is None:
                sender = self._sender_of(tx)
            slot = self._by_sender.get(sender)
            if slot is not None:
                slot.pop(tx.nonce, None)
                if not slot:
                    del self._by_sender[sender]
        self.m_known.set(len(self._hashes))

    # -- journal (core/tx_journal.go) --------------------------------------

    def _journal(self, tx: Transaction) -> None:
        try:
            with open(self.journal_path, "ab") as fh:
                blob = tx.encode_rlp()
                fh.write(len(blob).to_bytes(4, "big") + blob)
        except OSError as exc:
            self.record_error(f"journal write failed: {exc}")

    def _replay_journal(self) -> None:
        """Reload journaled transactions on restart (rotate semantics:
        invalid/duplicate entries are dropped silently, like the
        reference's journal.load device)."""
        try:
            with open(self.journal_path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return
        except OSError as exc:
            self.record_error(f"journal read failed: {exc}")
            return
        offset, replayed = 0, 0
        while offset + 4 <= len(raw):
            size = int.from_bytes(raw[offset:offset + 4], "big")
            blob = raw[offset + 4:offset + 4 + size]
            if len(blob) < size:
                break  # torn tail from a crash mid-write
            offset += 4 + size
            try:
                self._admit(Transaction.decode_rlp(blob))
                replayed += 1
            except (TxPoolError, Exception):
                continue
        if replayed:
            self.log.info("replayed %d journaled transactions", replayed)

    # -- simulation mode (sharding/txpool/service.go parity) ---------------

    def _make_test_tx(self) -> Transaction:
        self._nonce += 1
        return Transaction(
            nonce=self._nonce,
            gas_limit=0,
            payload=os.urandom(self.payload_size),
        )

    def _send_test_transactions(self) -> None:
        while not self.wait(self.simulate_interval):
            try:
                self.submit(self._make_test_tx())
            except TxPoolError as exc:
                self.record_error(f"test tx rejected: {exc}")
