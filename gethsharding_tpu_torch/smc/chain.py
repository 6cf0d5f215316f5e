"""SimulatedMainchain: in-process mainchain with manual block production
(the port's copy of the JAX package's `smc/chain.py`).

The equivalent of `accounts/abi/bind/backends/simulated.go:53`
(SimulatedBackend) fused with the narrow mainchain surface the sharding
actors use (`sharding/mainchain/interfaces.go`): pending and sealed
blocks, deterministic block hashes, account balances, head subscriptions,
and the SMC state machine in-process.

Transactions execute against the pending block number (sealed height + 1)
and view calls against the latest sealed block, as in geth. `commit()`
seals the pending block; `fast_forward(p)` mines p full periods
(`sharding/internal/client_helper.go:93`).

The chain logs every accepted vote of a period with its sampling context;
`verify_period_batch` replays that log through the batched vote kernel
(`ops/smc.py`, on the card unless the caller asks for the CPU) and checks
that it reaches the scalar machine's state.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import smc as smc_ops
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG, ETHER
from gethsharding_tpu_torch.smc.state_machine import SMC, SMCRevert
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32
from gethsharding_tpu_torch.utils.rlp import rlp_encode, int_to_big_endian


@dataclass
class Block:
    number: int
    hash: Hash32
    parent_hash: Hash32
    # engine seal payload (consensus/consensus.go role): empty for the
    # fake engine, 8-byte nonce for dev PoW, vanity+65-byte signature
    # for clique — see smc/engine.py
    extra: bytes = b""


@dataclass
class Receipt:
    """Minimal tx receipt: status + events emitted during the call."""

    tx_hash: Hash32
    status: int
    block_number: int
    events: List = field(default_factory=list)


class SimulatedMainchain:
    """Deterministic dev chain hosting the SMC state machine."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 genesis_balances: Optional[Dict[Address20, int]] = None,
                 engine=None):
        from gethsharding_tpu_torch.smc.engine import FakeEngine

        self.config = config
        # consensus engine seam (consensus/consensus.go): decides the
        # seal payload + hash rule for produced blocks and the
        # verification rule for imported ones. The default FakeEngine
        # is byte-compatible with the pre-engine chain.
        self.engine = engine if engine is not None else FakeEngine()
        genesis = Block(number=0, hash=self._block_hash(0, Hash32()),
                        parent_hash=Hash32())
        self.blocks: List[Block] = [genesis]
        self.balances: Dict[Address20, int] = dict(genesis_balances or {})
        self.smc = SMC(config=config, blockhash_fn=self.blockhash)
        self._head_subscribers: List[Callable[[Block], None]] = []
        self._receipts: Dict[Hash32, Receipt] = {}
        self._tx_counter = 0
        self._lock = threading.RLock()
        # per-period vote log for the batched replay audit
        # (ops/smc.py submit_votes_batch vs the scalar machine): accepted
        # attempts + the sampling context snapshot + end-of-period state
        self._vote_audit: Dict[int, dict] = {}
        # chain rollback / reorg support (core/blockchain.go SetHead,
        # reorg): bounded ring of per-block state snapshots; heads beyond
        # the horizon cannot be rolled back to (the same limitation as a
        # non-archive geth node's pruned states). reorg_generation bumps
        # on every head rollback so downstream caches (the state mirror)
        # can tell a reorg from a racing stale refresh.
        self.SNAPSHOT_HORIZON = 32
        self._state_snaps: Dict[int, tuple] = {}
        self.reorg_generation = 0
        self._snapshot_state(0)

    # -- chain mechanics ---------------------------------------------------

    @staticmethod
    def _block_hash(number: int, parent_hash: Hash32) -> Hash32:
        return Hash32(keccak256(rlp_encode([int_to_big_endian(number),
                                            bytes(parent_hash)])))

    @property
    def block_number(self) -> int:
        """Latest sealed block number."""
        return self.blocks[-1].number

    @property
    def pending_block_number(self) -> int:
        return self.block_number + 1

    def current_period(self) -> int:
        return self.block_number // self.config.period_length

    def blockhash(self, number: int) -> Hash32:
        """Hash of a sealed block; zero for unknown/future (EVM blockhash)."""
        if 0 <= number < len(self.blocks):
            return self.blocks[number].hash
        return Hash32()

    def block_by_number(self, number: Optional[int] = None) -> Block:
        if number is None:
            return self.blocks[-1]
        return self.blocks[number]

    def commit(self) -> Block:
        """Seal the pending block and notify head subscribers."""
        with self._lock:
            parent = self.blocks[-1]
            block_hash, extra = self.engine.seal(parent.number + 1,
                                                 parent.hash)
            block = Block(
                number=parent.number + 1,
                hash=block_hash,
                parent_hash=parent.hash,
                extra=extra,
            )
            self.blocks.append(block)
            self.engine.finalize(block.number, block.parent_hash, extra)
            # a period ends when the pending block number crosses into the
            # next period: snapshot its end-of-period vote state for the
            # batched replay audit before any next-period tx can clear it
            old_pending = block.number
            plen = self.config.period_length
            if (old_pending + 1) // plen > old_pending // plen:
                self._finalize_vote_audit(old_pending // plen)
            self._snapshot_state(block.number)
            subscribers = list(self._head_subscribers)
        for callback in subscribers:
            callback(block)
        return block

    # -- rollback / reorg (core/blockchain.go SetHead + reorg) -------------

    def _snapshot_state(self, number: int) -> None:
        import copy

        fn = self.smc.blockhash_fn
        self.smc.blockhash_fn = None  # bound method: not copyable state
        # the audit log grows with chain age: snapshot only the rollback
        # window's worth (older periods' logs survive a rollback anyway —
        # a head inside the horizon can't reach them)
        period_floor = (number // self.config.period_length
                        - self.SNAPSHOT_HORIZON // self.config.period_length
                        - 1)
        audit = {p: v for p, v in self._vote_audit.items()
                 if p >= period_floor}
        try:
            snap = copy.deepcopy((self.smc, self.balances, audit,
                                  self.engine.snapshot()))
        finally:
            self.smc.blockhash_fn = fn
        self._state_snaps[number] = snap
        stale = number - self.SNAPSHOT_HORIZON
        if stale in self._state_snaps:
            del self._state_snaps[stale]

    def _rollback_locked(self, number: int) -> None:
        """Restore block `number`'s state + truncate (lock held)."""
        import copy

        if not 0 <= number <= self.block_number:
            raise ValueError(f"set_head({number}): head is "
                             f"{self.block_number}")
        snap = self._state_snaps.get(number)
        if snap is None:
            raise ValueError(
                f"state for block {number} pruned (horizon "
                f"{self.SNAPSHOT_HORIZON})")
        smc, balances, vote_audit, engine_state = copy.deepcopy(snap)
        smc.blockhash_fn = self.blockhash
        self.smc = smc
        self.balances = balances
        if engine_state is not None:
            self.engine.restore(engine_state)
        # audit logs for periods finalized BEFORE the target head are
        # identical on both branches — keep them (the snapshot only
        # carries the rollback window's worth); anything later comes
        # from the snapshot or is gone with the rolled-back blocks
        plen = self.config.period_length
        keep = {p: v for p, v in self._vote_audit.items()
                if (p + 1) * plen <= number}
        keep.update(vote_audit)
        self._vote_audit = keep
        del self.blocks[number + 1:]
        for n in list(self._state_snaps):
            if n > number:
                del self._state_snaps[n]
        self.reorg_generation += 1

    def set_head(self, number: int) -> Block:
        """Roll the chain back to `number` (SetHead parity): truncate the
        header chain, restore that block's state snapshot, notify head
        subscribers with the new head. Raises for future heads and for
        heads whose state has been pruned past the snapshot horizon."""
        with self._lock:
            self._rollback_locked(number)
            head = self.blocks[-1]
            subscribers = list(self._head_subscribers)
        for callback in subscribers:
            callback(head)
        return head

    def import_chain(self, blocks: Sequence[Block]) -> int:
        """Import a competing branch (core/blockchain.go:1002 InsertChain
        + reorg, scoped to the dev chain's empty blocks): the branch must
        link to a known block; it wins only if strictly longer than the
        current chain (the dev analog of higher total difficulty — ties
        keep the incumbent). Validation, rollback and adoption happen
        under ONE lock hold, so a concurrent commit() can neither
        interleave a block into the adopted branch nor invalidate the
        longest-wins decision. Returns the number of blocks adopted."""
        if not blocks:
            return 0
        import copy

        with self._lock:
            first = blocks[0]
            attach = first.number - 1
            if (not 0 <= attach <= self.block_number
                    or bytes(first.parent_hash)
                    != bytes(self.blocks[attach].hash)):
                raise ValueError("branch does not link to a known block")
            parent = self.blocks[attach]
            for block in blocks:  # internal linkage + numbering
                if (block.number != parent.number + 1
                        or bytes(block.parent_hash) != bytes(parent.hash)):
                    raise ValueError("broken branch linkage")
                parent = block
            if blocks[-1].number <= self.block_number:
                return 0  # not longer: incumbent stays canonical, and a
                # branch that cannot win needs no engine verification
                # (stale forks may attach beyond the snapshot horizon)
            # seal verification runs against the ATTACH POINT's engine
            # state, with finalize interleaved, so mid-branch
            # authorization changes rotate the expected signer exactly
            # as geth's per-block clique snapshots do
            # (clique.go snapshot()). The walked state is throwaway:
            # failure restores the incumbent's, adoption re-derives it
            # block by block below.
            attach_snap = self._state_snaps.get(attach)
            if attach_snap is None:
                raise ValueError(
                    f"state for block {attach} pruned (horizon "
                    f"{self.SNAPSHOT_HORIZON})")
            incumbent_engine = self.engine.snapshot()
            attach_engine = copy.deepcopy(attach_snap[3])
            if attach_engine is not None:
                self.engine.restore(attach_engine)
            try:
                for block in blocks:
                    self.engine.verify_header(block.number,
                                              block.parent_hash,
                                              block.extra, block.hash)
                    self.engine.finalize(block.number, block.parent_hash,
                                         block.extra)
            except BaseException:
                if incumbent_engine is not None:
                    self.engine.restore(incumbent_engine)
                raise
            self._rollback_locked(attach)  # also re-restores attach state
            self.blocks.extend(blocks)
            for block in blocks:
                self.engine.finalize(block.number, block.parent_hash,
                                     block.extra)
                self._snapshot_state(block.number)
            head = self.blocks[-1]
            subscribers = list(self._head_subscribers)
        for callback in subscribers:
            callback(head)
        return len(blocks)

    def state_seq(self) -> list:
        """Cheap monotonic state identity [reorg_gen, block, tx_count]:
        a follower skips the heavy checkpoint pull while it is
        unchanged (every SMC transaction bumps the tx counter)."""
        with self._lock:
            return [self.reorg_generation, self.block_number,
                    self._tx_counter]

    def state_checkpoint(self) -> dict:
        """Serialized full state at the CURRENT head — what a follower
        chain process installs after importing our headers (the
        fast-sync pivot-state pull, `eth/downloader/downloader.go:479`
        role at dev-chain scale). The blob is a pickle: followers must
        only install checkpoints from their configured leader, never
        from untrusted peers. The vote-audit log ships only the rollback
        window's worth (same pruning as _snapshot_state) so the blob
        does not grow with chain age."""
        import pickle

        with self._lock:
            fn = self.smc.blockhash_fn
            self.smc.blockhash_fn = None  # bound method: not picklable
            number = self.block_number
            period_floor = (number // self.config.period_length
                            - self.SNAPSHOT_HORIZON
                            // self.config.period_length - 1)
            audit = {p: v for p, v in self._vote_audit.items()
                     if p >= period_floor}
            try:
                blob = pickle.dumps((self.smc, self.balances, audit,
                                     self.engine.snapshot()))
            finally:
                self.smc.blockhash_fn = fn
            head = self.blocks[-1]
            return {"number": head.number,
                    "hash": bytes(head.hash).hex(),
                    "reorg_gen": self.reorg_generation,
                    "seq": [self.reorg_generation, number,
                            self._tx_counter],
                    "state": blob.hex()}

    def install_checkpoint(self, checkpoint: dict) -> bool:
        """Adopt a leader's state checkpoint. The checkpoint must match
        OUR current head (number + hash) — headers are imported and
        engine-verified first via `import_chain`; this only swaps in the
        state they commit to. Returns False when the head moved since
        the checkpoint was taken (caller retries next round)."""
        import pickle

        with self._lock:
            head = self.blocks[-1]
            if (checkpoint["number"] != head.number
                    or checkpoint["hash"] != bytes(head.hash).hex()):
                return False
            smc, balances, vote_audit, engine_state = pickle.loads(
                bytes.fromhex(checkpoint["state"]))
            smc.blockhash_fn = self.blockhash
            self.smc = smc
            self.balances = balances
            self._vote_audit = vote_audit
            if engine_state is not None:
                self.engine.restore(engine_state)
            # the head snapshot must reflect the synced state, or a later
            # rollback would resurrect the pre-sync one
            self._snapshot_state(head.number)
        return True

    def fast_forward(self, periods: int) -> None:
        """Mine `periods` full periods of blocks (client_helper.go:93)."""
        for _ in range(periods * self.config.period_length):
            self.commit()

    def subscribe_new_head(self, callback: Callable[[Block], None]) -> Callable[[], None]:
        """Register a head callback; returns an unsubscribe function."""
        self._head_subscribers.append(callback)

        def unsubscribe():
            if callback in self._head_subscribers:
                self._head_subscribers.remove(callback)

        return unsubscribe

    # -- accounts ----------------------------------------------------------

    def fund(self, account: Address20, amount: int = 10_000 * ETHER) -> None:
        # counted as a state mutation so followers' seq-gated checkpoint
        # pulls see dev-faucet changes too
        self._tx_counter += 1
        self.balances[account] = self.balances.get(account, 0) + amount

    def balance_of(self, account: Address20) -> int:
        return self.balances.get(account, 0)

    # -- SMC transaction surface ------------------------------------------
    # Each transact_* executes in the pending block, records a receipt, and
    # moves value. Reverts raise SMCRevert and leave no state change.

    def _new_tx_hash(self) -> Hash32:
        self._tx_counter += 1
        return Hash32(keccak256(b"tx" + self._tx_counter.to_bytes(8, "big")))

    def _record(self, events_before: int) -> Receipt:
        receipt = Receipt(
            tx_hash=self._new_tx_hash(),
            status=1,
            block_number=self.pending_block_number,
            events=self.smc.events[events_before:],
        )
        self._receipts[receipt.tx_hash] = receipt
        return receipt

    def transaction_receipt(self, tx_hash: Hash32) -> Optional[Receipt]:
        return self._receipts.get(tx_hash)

    def register_notary(self, sender: Address20, value: Optional[int] = None,
                        bls_pubkey=None, bls_pop=None) -> Receipt:
        with self._lock:
            deposit = self.config.notary_deposit if value is None else value
            if self.balances.get(sender, 0) < deposit:
                raise SMCRevert("insufficient balance for deposit")
            events_before = len(self.smc.events)
            self.smc.register_notary(sender, deposit, self.pending_block_number,
                                     bls_pubkey=bls_pubkey, bls_pop=bls_pop)
            self.balances[sender] -= deposit
            self._mark_pool_churn()
            return self._record(events_before)

    def deregister_notary(self, sender: Address20) -> Receipt:
        with self._lock:
            events_before = len(self.smc.events)
            self.smc.deregister_notary(sender, self.pending_block_number)
            self._mark_pool_churn()
            return self._record(events_before)

    def release_notary(self, sender: Address20) -> Receipt:
        with self._lock:
            events_before = len(self.smc.events)
            released = self.smc.release_notary(sender, self.pending_block_number)
            self.balances[sender] = self.balances.get(sender, 0) + released
            return self._record(events_before)

    def add_header(self, sender: Address20, shard_id: int, period: int,
                   chunk_root: Hash32, signature: bytes = b"") -> Receipt:
        with self._lock:
            events_before = len(self.smc.events)
            self.smc.add_header(sender, shard_id, period, chunk_root,
                                signature, self.pending_block_number)
            return self._record(events_before)

    def submit_vote(self, sender: Address20, shard_id: int, period: int,
                    index: int, chunk_root: Hash32, bls_sig=None) -> Receipt:
        with self._lock:
            events_before = len(self.smc.events)
            pre_last_approved = (
                dict(self.smc.last_approved_collation)
                if period not in self._vote_audit else None)
            self.smc.submit_vote(sender, shard_id, period, index, chunk_root,
                                 self.pending_block_number, bls_sig=bls_sig)
            self._log_vote(period, sender, shard_id, index, chunk_root,
                           pre_last_approved)
            return self._record(events_before)

    # -- SMC view surface (latest sealed block, like eth_call) ------------

    def get_notary_in_committee(self, sender: Address20, shard_id: int) -> Address20:
        return self.smc.get_notary_in_committee_view(
            sender, shard_id, self.block_number
        )

    def notary_registry(self, address: Address20):
        return self.smc.notary_registry.get(address)

    def collation_record(self, shard_id: int, period: int):
        return self.smc.collation_records.get((shard_id, period))

    def last_submitted_collation(self, shard_id: int) -> int:
        return self.smc.last_submitted_collation.get(shard_id, 0)

    def last_approved_collation(self, shard_id: int) -> int:
        return self.smc.last_approved_collation.get(shard_id, 0)

    def notary_by_pool_index(self, index: int) -> Optional[Address20]:
        """Pool slot -> notary address (None for empty/out-of-range slots)."""
        pool = self.smc.notary_pool
        return pool[index] if 0 <= index < len(pool) else None

    def committee_context(self) -> dict:
        """The sampling inputs for the CURRENT period in one view call:
        clients compute all-shard committee eligibility locally (one
        keccak batch) instead of one eth_call per shard — the reference's
        per-head x per-shard scan (`sharding/notary/notary.go:62`,
        SURVEY.md §3.1 hot loop) collapsed into a single round-trip.

        Mirrors `get_notary_in_committee_view`'s sample-size simulation
        exactly; `pool` is the raw slot array (None = emptied slot)."""
        with self._lock:
            smc = self.smc
            period = self.current_period()
            sample_size_last_updated = smc.sample_size_last_updated_period
            current_size = smc.current_period_notary_sample_size
            next_size = smc.next_period_notary_sample_size
            if period >= sample_size_last_updated:
                current_size = next_size
                sample_size_last_updated = period
            sample_size = (next_size if period > sample_size_last_updated
                           else current_size)
            latest_block = period * self.config.period_length - 1
            return {
                "period": period,
                "sample_size": sample_size,
                "blockhash": bytes(self.blockhash(latest_block)),
                "pool": [None if a is None else bytes(a)
                         for a in smc.notary_pool],
            }

    def has_voted(self, shard_id: int, index: int) -> bool:
        return self.smc.has_voted(shard_id, index)

    def get_vote_count(self, shard_id: int) -> int:
        return self.smc.get_vote_count(shard_id)

    def shard_count(self) -> int:
        return self.smc.shard_count

    # -- batched vote-replay audit ----------------------------------------
    # The chain logs every ACCEPTED submitVote together with a snapshot of
    # the sampling context (pool, sample size, period blockhash) taken at
    # the period's first vote, and the end-of-period vote state at the
    # period boundary. `verify_period_batch` replays the log through the
    # batched vote kernel `ops/smc.py::submit_votes_batch` and checks the
    # result is byte-identical with what the scalar machine computed —
    # in-node failure detection for the batch path (SURVEY.md §5.3).

    def _mark_pool_churn(self) -> None:
        pending_period = self.pending_block_number // self.config.period_length
        entry = self._vote_audit.get(pending_period)
        if entry is not None:
            # pool mutated after the snapshot: sampling context no longer
            # reproducible for this period; skip its replay check
            entry["churned"] = True

    def _log_vote(self, period: int, sender: Address20, shard_id: int,
                  index: int, chunk_root: Hash32, pre_last_approved) -> None:
        entry = self._vote_audit.get(period)
        if entry is None:
            entry = {
                "attempts": [],
                "churned": False,
                # post-update value: SMC.submit_vote just ran
                # _update_notary_sample_size for this period
                "sample_size": self.smc.current_period_notary_sample_size,
                "pool": [bytes(a) if a is not None else None
                         for a in self.smc.notary_pool],
                "blockhash": bytes(self.blockhash(
                    period * self.config.period_length - 1)),
                "pre_last_approved": pre_last_approved or {},
                "final": None,
            }
            self._vote_audit[period] = entry
        reg = self.smc.notary_registry[sender]
        entry["attempts"].append({
            "shard": shard_id,
            "index": index,
            "pool_index": reg.pool_index,
            "sender": bytes(sender),
            "chunk_root": bytes(chunk_root),
        })

    def _finalize_vote_audit(self, period: int) -> None:
        entry = self._vote_audit.get(period)
        if entry is not None and entry["final"] is None:
            shards = {a["shard"] for a in entry["attempts"]}
            entry["final"] = {
                "words": {s: self.smc.current_vote.get(s, 0) for s in shards},
                "elected": {
                    s: bool(self.smc.collation_records[(s, period)].is_elected)
                    for s in shards
                    if (s, period) in self.smc.collation_records},
                "last_approved": {
                    s: self.smc.last_approved_collation.get(s, 0)
                    for s in shards},
            }
        # bound memory: keep a few recent periods only
        for p in [p for p in self._vote_audit if p < period - 8]:
            del self._vote_audit[p]

    def verify_period_batch(self, period: int,
                            device=None) -> Optional[bool]:
        """Replay `period`'s accepted votes through the batched vote
        kernel (`ops/smc.py` on `device`: None is the card, which raises
        where there is none) and compare with the scalar outcome. True =
        byte-identical, False = divergence, None = not auditable (no
        votes, pool churn mid-period, or period not yet finalized)."""
        with self._lock:
            entry = self._vote_audit.get(period)
            if (entry is None or entry["churned"] or not entry["attempts"]
                    or entry["final"] is None):
                return None
            attempts = list(entry["attempts"])
            records = {
                s: self.smc.collation_records.get((s, period))
                for s in range(self.smc.shard_count)
            }
            snapshot = dict(entry)

        s_count = self.smc.shard_count
        committee = self.config.committee_size
        last_sub = np.zeros(s_count, np.int32)
        roots = np.zeros((s_count, 32), np.uint8)
        last_appr = np.zeros(s_count, np.int32)
        for s in range(s_count):
            last_appr[s] = snapshot["pre_last_approved"].get(s, 0)
            rec = records[s]
            if rec is not None:
                last_sub[s] = period
                roots[s] = np.frombuffer(bytes(rec.chunk_root), np.uint8)
        dev = resolve_device(device)
        put = lambda a: torch.as_tensor(a, device=dev)
        state = smc_ops.init_vote_state(s_count, committee, dev)._replace(
            last_submitted=put(last_sub), chunk_root=put(roots),
            last_approved=put(last_appr))
        pool = snapshot["pool"]
        pool_addr = np.zeros((max(len(pool), 1), 20), np.uint8)
        for i, addr in enumerate(pool):
            if addr is not None:
                pool_addr[i] = np.frombuffer(addr, np.uint8)
        n_att = len(attempts)
        column = lambda key: put(np.asarray([a[key] for a in attempts],
                                            np.int32))
        rows = lambda key: put(np.stack(
            [np.frombuffer(a[key], np.uint8) for a in attempts]))
        att = smc_ops.VoteAttempts(
            shard=column("shard"), index=column("index"),
            pool_index=column("pool_index"), sender=rows("sender"),
            chunk_root=rows("chunk_root"),
            deposited=torch.ones(n_att, dtype=torch.bool, device=dev),
            valid=torch.ones(n_att, dtype=torch.bool, device=dev))
        blockhash = np.frombuffer(snapshot["blockhash"], np.uint8).copy()
        new_state, accepted = smc_ops.submit_votes_batch(
            state, put(pool_addr), att, period=period,
            blockhash=put(blockhash),
            sample_size=snapshot["sample_size"], committee_size=committee,
            quorum_size=self.config.quorum_size)
        if not bool(accepted.all()):
            return False  # a scalar-accepted vote was rejected by the batch
        words = smc_ops.export_vote_word(new_state.has_voted,
                                         new_state.vote_count)
        final = snapshot["final"]
        elected = new_state.is_elected.cpu().tolist()
        approved = new_state.last_approved.cpu().tolist()
        for s in sorted({a["shard"] for a in attempts}):
            if words[s] != final["words"].get(s, 0):
                return False
            if elected[s] != final["elected"].get(s, False):
                return False
            if approved[s] != final["last_approved"].get(s, 0):
                return False
        return True
