"""SMC: the Sharding Manager Contract as a deterministic state machine (the
port's copy of the JAX package's `smc/state_machine.py`).

Semantics-parity reimplementation of `sharding/contracts/sharding_manager.sol`
(every rule cited below by .sol line), outcomes byte-identical with what
the Solidity contract computes, including its quirks:

- the vote word packs a 255-bit bitfield (bit `255 - index`) plus a count in
  the low byte (.sol:32-34, castVote :276);
- `stackPop` requires the stack top to be > 1, so the last freed pool slot
  is never reused (.sol:262 `require(emptySlotsStackTop > 1)`);
- committee sampling is `keccak256(bytes32(blockhash) ++ bytes32(poolIndex)
  ++ bytes32(shardId)) % sampleSize` over the last block of the previous
  period (.sol:90-99), with the sample size tracked one period ahead
  (updateNotarySampleSize :250).

Every method takes the acting `block_number` explicitly, so the machine is
replayable, and the batched form (`ops/smc.py`) is held against it by the
chain's vote-log replay check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from gethsharding_tpu_torch.crypto import bn256
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

UINT256_MASK = (1 << 256) - 1


class SMCRevert(Exception):
    """Equivalent of a failed Solidity `require` — the tx has no effect."""


def vote_digest(shard_id: int, period: int, chunk_root: Hash32) -> bytes:
    """The message a notary BLS-signs when voting: domain-separated
    (shard, period, chunkRoot) tuple. Same-message aggregation per shard —
    every committee member of a shard signs the identical digest, so the
    period pipeline verifies ONE aggregate pair per shard.

    (An extension over `sharding_manager.sol:198-221`, where vote
    authenticity rides only on the tx sender: votes also carry an
    aggregatable signature, so a validator verifies a whole period in one
    batched device call.)
    """
    return keccak256(
        b"gethsharding-vote-v1/"
        + shard_id.to_bytes(32, "big")
        + period.to_bytes(32, "big")
        + bytes(chunk_root)
    )


@dataclass
class Notary:
    """Per-notary registry entry (.sol:11-16), extended with the BLS vote
    pubkey registered alongside the deposit (PoP retained for batch
    verification by validators — rogue-key defense)."""

    deregistered_period: int = 0
    pool_index: int = 0
    balance: int = 0
    deposited: bool = False
    bls_pubkey: Optional[bn256.G2Point] = None
    bls_pop: Optional[bn256.G1Point] = None


@dataclass
class VoteSig:
    """An accepted vote's BLS signature with signer attribution, recorded
    at vote time so the period audit resolves the voter's registered
    pubkey WITHOUT consulting the live pool (pool slots can be freed and
    reused between the vote and the audit)."""

    sig: bn256.G1Point
    signer: Address20


@dataclass
class CollationRecord:
    """Per-(shard, period) collation header record (.sol:18-23), extended
    with the accepted votes' BLS signatures keyed by committee bitfield
    index — the persistent artifact the batched period audit verifies —
    and a persistent accepted-vote counter (the packed word's low byte is
    transient: addHeader clears it next period, .sol:187)."""

    chunk_root: Hash32 = field(default_factory=Hash32)
    proposer: Address20 = field(default_factory=Address20)
    is_elected: bool = False
    signature: bytes = b""
    vote_sigs: Dict[int, VoteSig] = field(default_factory=dict)
    vote_count: int = 0


@dataclass
class Event:
    name: str
    args: dict


class SMC:
    """The contract state + transition rules.

    `blockhash_fn(number) -> Hash32` supplies mainchain block hashes for
    committee sampling (the `block.blockhash` dependency).
    """

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 blockhash_fn: Optional[Callable[[int], Hash32]] = None):
        self.config = config
        self.blockhash_fn = blockhash_fn or (lambda n: Hash32())

        # notary state (.sol:25-34)
        self.notary_pool: List[Optional[Address20]] = []
        self.notary_registry: Dict[Address20, Notary] = {}
        self.notary_pool_length: int = 0
        self.current_vote: Dict[int, int] = {}  # shard -> packed uint256

        # collation state (.sol:36-42)
        self.collation_records: Dict[Tuple[int, int], CollationRecord] = {}
        self.last_submitted_collation: Dict[int, int] = {}
        self.last_approved_collation: Dict[int, int] = {}

        # empty-slot stack + sample-size bookkeeping (.sol:44-52)
        self.empty_slots_stack: List[int] = []
        self.empty_slots_stack_top: int = 0
        self.current_period_notary_sample_size: int = 0
        self.next_period_notary_sample_size: int = 0
        self.sample_size_last_updated_period: int = 0

        self.shard_count: int = config.shard_count
        self.balance: int = 0  # ether held by the contract
        self.events: List[Event] = []

    # -- internal helpers --------------------------------------------------

    def _period(self, block_number: int) -> int:
        return block_number // self.config.period_length

    def _update_notary_sample_size(self, block_number: int) -> None:
        """updateNotarySampleSize (.sol:250-258)."""
        current_period = self._period(block_number)
        if current_period < self.sample_size_last_updated_period:
            return
        self.current_period_notary_sample_size = self.next_period_notary_sample_size
        self.sample_size_last_updated_period = current_period

    def _stack_empty(self) -> bool:
        return self.empty_slots_stack_top == 0

    def _stack_push(self, index: int) -> None:
        if len(self.empty_slots_stack) == self.empty_slots_stack_top:
            self.empty_slots_stack.append(index)
        else:
            self.empty_slots_stack[self.empty_slots_stack_top] = index
        self.empty_slots_stack_top += 1

    def _stack_pop(self) -> int:
        # reference quirk preserved: the last freed slot is unreachable
        # (.sol:262 `require(emptySlotsStackTop > 1)`)
        if not self.empty_slots_stack_top > 1:
            raise SMCRevert("stackPop: emptySlotsStackTop <= 1")
        self.empty_slots_stack_top -= 1
        return self.empty_slots_stack[self.empty_slots_stack_top]

    # -- views -------------------------------------------------------------

    def get_notary_in_committee(self, sender: Address20, shard_id: int,
                                block_number: int) -> Address20:
        """Committee sampling (.sol:77-100).

        NOTE: mirrors the mutating-view quirk — the Solidity function calls
        updateNotarySampleSize() even though it is marked `view` (a no-op
        on-chain via STATICCALL for eth_call, but state-changing inside a
        transaction such as submitVote). We therefore only mutate when used
        inside a transaction; pure view usage passes `mutate=False` via
        get_notary_in_committee_view.
        """
        return self._committee_member(sender, shard_id, block_number, mutate=True)

    def get_notary_in_committee_view(self, sender: Address20, shard_id: int,
                                     block_number: int) -> Address20:
        return self._committee_member(sender, shard_id, block_number, mutate=False)

    def _committee_member(self, sender: Address20, shard_id: int,
                          block_number: int, mutate: bool) -> Address20:
        period = self._period(block_number)
        if mutate:
            self._update_notary_sample_size(block_number)
            sample_size_last_updated = self.sample_size_last_updated_period
            current_size = self.current_period_notary_sample_size
            next_size = self.next_period_notary_sample_size
        else:
            # simulate the sample-size update without committing it
            sample_size_last_updated = self.sample_size_last_updated_period
            current_size = self.current_period_notary_sample_size
            next_size = self.next_period_notary_sample_size
            if period >= sample_size_last_updated:
                current_size = next_size
                sample_size_last_updated = period

        if period > sample_size_last_updated:
            sample_size = next_size
        else:
            sample_size = current_size

        registry_entry = self.notary_registry.get(sender, Notary())
        pool_index = registry_entry.pool_index

        latest_block = period * self.config.period_length - 1
        latest_block_hash = self.blockhash_fn(latest_block)
        preimage = (
            bytes(latest_block_hash)
            + pool_index.to_bytes(32, "big")
            + shard_id.to_bytes(32, "big")
        )
        index = int.from_bytes(keccak256(preimage), "big")
        if sample_size == 0:
            raise SMCRevert("committee sample size is zero (division by zero)")
        index %= sample_size
        member = self.notary_pool[index] if index < len(self.notary_pool) else None
        return member if member is not None else Address20()

    def get_vote_count(self, shard_id: int) -> int:
        """Low byte of the packed vote word (.sol:224-229)."""
        return self.current_vote.get(shard_id, 0) % 256

    def has_voted(self, shard_id: int, index: int) -> bool:
        """Bit `255 - index` of the packed vote word (.sol:233-239)."""
        votes = self.current_vote.get(shard_id, 0)
        return (votes >> (255 - index)) & 1 == 1

    # -- transactions ------------------------------------------------------

    def register_notary(self, sender: Address20, value: int,
                        block_number: int,
                        bls_pubkey: Optional[bn256.G2Point] = None,
                        bls_pop: Optional[bn256.G1Point] = None) -> None:
        """registerNotary (.sol:103-133). `bls_pubkey`/`bls_pop` register
        the notary's aggregatable vote key; when a pubkey is supplied a PoP
        must accompany it (its pairing check is deferred to the batched
        validator audit, keeping registration scalar-crypto-free)."""
        entry = self.notary_registry.get(sender)
        if entry is not None and entry.deposited:
            raise SMCRevert("notary already deposited")
        if value != self.config.notary_deposit:
            raise SMCRevert("deposit must be exactly NOTARY_DEPOSIT")
        if bls_pubkey is not None and bls_pop is None:
            raise SMCRevert("BLS pubkey requires a proof of possession")

        self._update_notary_sample_size(block_number)

        if self._stack_empty():
            index = self.notary_pool_length
            self.notary_pool.append(sender)
        else:
            index = self._stack_pop()
            self.notary_pool[index] = sender
        self.notary_pool_length += 1

        self.notary_registry[sender] = Notary(
            deregistered_period=0, pool_index=index, balance=value,
            deposited=True, bls_pubkey=bls_pubkey, bls_pop=bls_pop,
        )
        self.balance += value

        if index >= self.next_period_notary_sample_size:
            self.next_period_notary_sample_size = index + 1

        self.events.append(
            Event("NotaryRegistered", {"notary": sender, "poolIndex": index})
        )

    def deregister_notary(self, sender: Address20, block_number: int) -> None:
        """deregisterNotary (.sol:138-154)."""
        entry = self.notary_registry.get(sender)
        if entry is None or not entry.deposited:
            raise SMCRevert("notary not deposited")
        index = entry.pool_index
        if index >= len(self.notary_pool) or self.notary_pool[index] != sender:
            raise SMCRevert("pool entry does not match sender")

        self._update_notary_sample_size(block_number)

        deregistered_period = self._period(block_number)
        entry.deregistered_period = deregistered_period
        self._stack_push(index)
        self.notary_pool[index] = None  # `delete notaryPool[index]`
        self.notary_pool_length -= 1
        self.events.append(
            Event(
                "NotaryDeregistered",
                {"notary": sender, "poolIndex": index,
                 "deregisteredPeriod": deregistered_period},
            )
        )

    def release_notary(self, sender: Address20, block_number: int) -> int:
        """releaseNotary (.sol:157-168); returns the released balance."""
        entry = self.notary_registry.get(sender)
        if entry is None or entry.deposited is not True:
            raise SMCRevert("notary not deposited")
        if entry.deregistered_period == 0:
            raise SMCRevert("notary has not deregistered")
        if not (self._period(block_number)
                > entry.deregistered_period + self.config.notary_lockup_length):
            raise SMCRevert("lockup period not over")

        index = entry.pool_index
        balance = entry.balance
        del self.notary_registry[sender]
        self.balance -= balance
        self.events.append(
            Event("NotaryReleased", {"notary": sender, "poolIndex": index})
        )
        return balance

    def add_header(self, sender: Address20, shard_id: int, period: int,
                   chunk_root: Hash32, signature: bytes,
                   block_number: int) -> None:
        """addHeader (.sol:171-195)."""
        if not (0 <= shard_id < self.shard_count):
            raise SMCRevert("shard id out of range")
        if period != self._period(block_number):
            raise SMCRevert("period is not current")
        if period <= self.last_submitted_collation.get(shard_id, 0):
            raise SMCRevert("period already has a submitted collation")

        self._update_notary_sample_size(block_number)

        self.collation_records[(shard_id, period)] = CollationRecord(
            chunk_root=Hash32(chunk_root),
            proposer=sender,
            is_elected=False,
            signature=bytes(signature),
        )
        self.last_submitted_collation[shard_id] = self._period(block_number)
        self.current_vote.pop(shard_id, None)  # `delete currentVote[_shardId]`
        self.events.append(
            Event(
                "HeaderAdded",
                {"shardId": shard_id, "chunkRoot": Hash32(chunk_root),
                 "period": period, "proposerAddress": sender},
            )
        )

    def submit_vote(self, sender: Address20, shard_id: int, period: int,
                    index: int, chunk_root: Hash32, block_number: int,
                    bls_sig: Optional[bn256.G1Point] = None) -> None:
        """submitVote (.sol:198-221), extended: a notary registered with a
        BLS pubkey must attach its signature over
        `vote_digest(shard, period, chunkRoot)`. Authenticity within a tx
        still rides on the sender (reference parity); the stored signature
        is the artifact the batched period audit verifies in one device
        dispatch — an invalid one is detected there (and in a slashing
        design would forfeit the deposit)."""
        if not (0 <= shard_id < self.shard_count):
            raise SMCRevert("shard id out of range")
        if period != self._period(block_number):
            raise SMCRevert("period is not current")
        if period != self.last_submitted_collation.get(shard_id, 0):
            raise SMCRevert("no collation submitted this period")
        if not index < self.config.committee_size:
            raise SMCRevert("index out of committee range")
        record = self.collation_records.get((shard_id, period))
        if record is None or Hash32(chunk_root) != record.chunk_root:
            raise SMCRevert("chunk root does not match submitted collation")
        entry = self.notary_registry.get(sender)
        if entry is None or not entry.deposited:
            raise SMCRevert("sender is not a deposited notary")
        if entry.bls_pubkey is not None:
            if bls_sig is None:
                raise SMCRevert("vote must carry a BLS signature")
            # the reference contract leaves _index unbound to the sender
            # (.sol:198-221 checks only range + hasVoted); for SIGNED votes
            # the index is the attribution key, so it must be the sender's
            # own pool slot — otherwise a voter could burn another slot's
            # bit and poison the audit's signer resolution
            if index != entry.pool_index:
                raise SMCRevert(
                    "signed vote index must be the sender's pool index")
        if self.has_voted(shard_id, index):
            raise SMCRevert("notary already voted at this index")
        if self.get_notary_in_committee(sender, shard_id, block_number) != sender:
            raise SMCRevert("sender is not the sampled committee member")

        self._cast_vote(shard_id, index)
        record.vote_count += 1
        if bls_sig is not None:
            record.vote_sigs[index] = VoteSig(sig=bls_sig, signer=sender)
        vote_count = self.get_vote_count(shard_id)
        if vote_count >= self.config.quorum_size:
            self.last_approved_collation[shard_id] = period
            record.is_elected = True
        self.events.append(
            Event(
                "VoteSubmitted",
                {"shardId": shard_id, "chunkRoot": Hash32(chunk_root),
                 "period": period, "notaryAddress": sender},
            )
        )

    def _cast_vote(self, shard_id: int, index: int) -> None:
        """castVote (.sol:276-285): set bit 255-index, then increment count."""
        votes = self.current_vote.get(shard_id, 0)
        votes |= 1 << (255 - index)
        votes = (votes + 1) & UINT256_MASK
        self.current_vote[shard_id] = votes
