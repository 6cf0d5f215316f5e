"""The SMC vote batch as fixed-shape tensor ops: the port's counterpart of
the JAX package's `ops/smc_jax.py`.

Registration and period bookkeeping stay with the host's state machine;
the per-period hot loop (committee sampling, vote validation, the has-voted
bitfield, quorum) runs here as integer tensor ops on the given device.

The batch reaches exactly the state the scalar `SMC.submit_vote` reaches
applying the attempts in order, the packed uint256 vote word
(`export_vote_word`), the is_elected flip and each attempt's accept or
revert included. The only dependence between the attempts of one period
is the has-voted bit of a (shard, index) slot, which a first-occurrence-
wins scatter reproduces (`sharding_manager.sol:198-221`): here
`scatter_reduce` with `amin` over the attempt order, `amax` onto the
bitfield and `index_add_` for the counts.

Sampling (.sol:77-100): member = pool[keccak256(blockhash_32 ++
poolIndex_32 ++ shardId_32) % sampleSize], an emptied slot giving the
zero address. The digests are one launch of `csrc/keccak_fixed.cu` on the
card (`ops/keccak.py::keccak256`); the digest mod the sample size is one
weighted sum of its 32 bytes (the weights 256^(31-i) mod m), which equals
the reference's big-endian Horner loop for the sample sizes it allows
(m < 2^23).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops.keccak import keccak256
from gethsharding_tpu_torch.ops.limb import const

# the reference's Horner loop stays inside int32 below this sample size
MAX_SAMPLE_SIZE = 1 << 23


class VoteState(NamedTuple):
    """Per-shard vote-period state: S shards, C committee slots. The
    contract packs `has_voted` and the count into one uint256
    (`currentVote`, .sol:32-34); `export_vote_word` packs them back."""

    has_voted: torch.Tensor      # (S, C) bool: bit 255-index of the word
    vote_count: torch.Tensor     # (S,) int32: low byte of the word
    last_submitted: torch.Tensor  # (S,) int32
    last_approved: torch.Tensor  # (S,) int32
    is_elected: torch.Tensor     # (S,) bool: this period's record flag
    chunk_root: torch.Tensor     # (S, 32) uint8: this period's record root


class VoteAttempts(NamedTuple):
    """A batch of submitVote transactions, in order: A attempts."""

    shard: torch.Tensor       # (A,) int32
    index: torch.Tensor       # (A,) int32: claimed committee slot
    pool_index: torch.Tensor  # (A,) int32: sender's registry poolIndex
    sender: torch.Tensor      # (A, 20) uint8
    chunk_root: torch.Tensor  # (A, 32) uint8
    deposited: torch.Tensor   # (A,) bool: registry[sender].deposited
    valid: torch.Tensor       # (A,) bool: caller premask


_BE_SHIFTS = np.array([24, 16, 8, 0], np.int32)


def _be32(x: torch.Tensor) -> torch.Tensor:
    """int32 (...,) -> (..., 32) uint8 big-endian uint256 (the low four
    bytes of the int32, as the reference takes them)."""
    tail = ((x[..., None] >> const(_BE_SHIFTS, x.device)) & 0xFF)
    head = torch.zeros(x.shape + (28,), dtype=torch.uint8, device=x.device)
    return torch.cat([head, tail.to(torch.uint8)], dim=-1)


@functools.lru_cache(maxsize=None)
def _mod_weights(m: int) -> np.ndarray:
    """256^(31 - i) mod m for the 32 big-endian bytes of a digest."""
    return np.asarray([pow(256, 31 - i, m) for i in range(32)], np.int64)


def sample_committee(blockhash: torch.Tensor, pool_index: torch.Tensor,
                     shard_id: torch.Tensor, sample_size) -> torch.Tensor:
    """Batched getNotaryInCommittee sampling -> pool slot per attempt.

    blockhash (32,) uint8; pool_index, shard_id (A,) int32; sample_size
    an int (or 0-d tensor) in [1, MAX_SAMPLE_SIZE). Returns (A,) int32."""
    m = int(sample_size)
    if not 0 < m < MAX_SAMPLE_SIZE:
        raise ValueError(f"sample size {m}: the sampling takes 1 to "
                         f"{MAX_SAMPLE_SIZE - 1}")
    a = pool_index.shape[0]
    preimage = torch.cat([blockhash.to(torch.uint8).expand(a, 32),
                          _be32(pool_index), _be32(shard_id)], dim=-1)
    digest = keccak256(preimage)                  # (A, 32) big-endian
    # each term < 2^31, their sum < 2^36: exact in int64
    weighted = digest.to(torch.int64) * const(_mod_weights(m),
                                              digest.device)
    return (weighted.sum(dim=-1) % m).to(torch.int32)


def submit_votes_batch(state: VoteState, pool_addr: torch.Tensor,
                       attempts: VoteAttempts, *, period: int,
                       blockhash: torch.Tensor, sample_size,
                       committee_size: int, quorum_size: int,
                       sample_shard: torch.Tensor = None):
    """Apply a period's submitVote batch. Returns (new_state, accepted).

    pool_addr (P, 20) uint8, zero rows for empty slots; period an int
    (the caller guarantees the attempts were made in it, .sol:203).
    `sample_shard` (A,) int32 replaces the shard ids of the committee
    sampling: on a mesh slot the state is indexed by the slab's local
    ids while the sampling must see the global ones."""
    period = int(period)
    s_count, c_size = state.has_voted.shape
    if c_size != committee_size:
        raise ValueError(f"vote state has {c_size} committee slots, the "
                         f"batch expects {committee_size}")
    a = attempts.shard.shape[0]
    pool_cap = pool_addr.shape[0]
    dev = state.vote_count.device

    shard_ok = (attempts.shard >= 0) & (attempts.shard < s_count)
    shard_ix = attempts.shard.clamp(0, s_count - 1).long()
    index_ok = (attempts.index >= 0) & (attempts.index < committee_size)
    index_ix = attempts.index.clamp(0, committee_size - 1).long()

    # the period has a submitted collation whose root matches (.sol:204-210)
    period_ok = state.last_submitted[shard_ix] == period
    root_ok = (attempts.chunk_root == state.chunk_root[shard_ix]).all(dim=-1)

    # the sender is the sampled committee member (.sol:212-214)
    slot = sample_committee(
        blockhash, attempts.pool_index,
        attempts.shard if sample_shard is None else sample_shard,
        sample_size)
    member = pool_addr[slot.clamp(0, pool_cap - 1).long()]
    member = torch.where((slot < pool_cap)[:, None], member,
                         torch.zeros_like(member))
    sampled_ok = (member == attempts.sender).all(dim=-1)

    not_voted = ~state.has_voted[shard_ix, index_ix]

    ok = (attempts.valid & shard_ok & index_ok & period_ok & root_ok
          & attempts.deposited & not_voted & sampled_ok)

    # first occurrence wins within the batch: the only cross-attempt state
    # in one period is the has-voted bit of a (shard, index) slot
    spill = s_count * committee_size
    flat = torch.where(ok, shard_ix * committee_size + index_ix,
                       torch.full_like(shard_ix, spill))
    order = torch.arange(a, dtype=torch.int32, device=dev)
    first = torch.full((spill + 1,), a, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, flat, order, reduce="amin")
    accepted = ok & (first[flat] == order)

    has_voted = state.has_voted.to(torch.int32).reshape(-1).scatter_reduce(
        0, shard_ix * committee_size + index_ix, accepted.to(torch.int32),
        reduce="amax").reshape(s_count, committee_size).bool()
    add = torch.zeros(s_count, dtype=torch.int32, device=dev).index_add_(
        0, shard_ix, accepted.to(torch.int32))
    vote_count = (state.vote_count + add) % 256   # low-byte semantics
    # the scalar SMC touches lastApproved / isElected only inside an
    # accepted submitVote (.sol:215-218): a shard with no accepted vote
    # keeps its approval state even where a stale count clears quorum
    newly_elected = (add > 0) & (vote_count >= quorum_size)
    last_approved = torch.where(
        newly_elected, torch.full_like(state.last_approved, period),
        state.last_approved)
    new_state = VoteState(
        has_voted=has_voted, vote_count=vote_count,
        last_submitted=state.last_submitted, last_approved=last_approved,
        is_elected=state.is_elected | newly_elected,
        chunk_root=state.chunk_root)
    return new_state, accepted


def add_header_reset(state: VoteState, shard_id: torch.Tensor, period: int,
                     chunk_root: torch.Tensor) -> VoteState:
    """addHeader's vote-plane effects for accepted headers (.sol:183-189):
    record the root, mark the period submitted, clear the vote word.
    shard_id (K,) distinct shards, chunk_root (K, 32) uint8."""
    period = int(period)
    s_count = state.has_voted.shape[0]
    six = shard_id.clamp(0, s_count - 1).long()

    def put(plane, value):
        out = plane.clone()
        out[six] = value
        return out

    return VoteState(
        has_voted=put(state.has_voted, False),
        vote_count=put(state.vote_count, 0),
        last_submitted=put(state.last_submitted, period),
        last_approved=state.last_approved,
        is_elected=put(state.is_elected, False),
        chunk_root=put(state.chunk_root, chunk_root.to(torch.uint8)))


def add_header_reset_masked(state: VoteState, mask: torch.Tensor,
                            period: int,
                            chunk_root: torch.Tensor) -> VoteState:
    """`add_header_reset` over a per-shard bool `mask` (True: a header was
    accepted this period) in place of an index list. mask (S,),
    chunk_root (S, 32) uint8."""
    period = int(period)
    m1 = mask[:, None]
    return VoteState(
        has_voted=state.has_voted & ~m1,
        vote_count=torch.where(mask, torch.zeros_like(state.vote_count),
                               state.vote_count),
        last_submitted=torch.where(
            mask, torch.full_like(state.last_submitted, period),
            state.last_submitted),
        last_approved=state.last_approved,
        is_elected=state.is_elected & ~mask,
        chunk_root=torch.where(m1, chunk_root.to(torch.uint8),
                               state.chunk_root))


def export_vote_word(has_voted, vote_count) -> list:
    """Pack (S, C) bits and (S,) counts into the contract's uint256 words:
    bit `255 - index` per vote, the count in the low byte (.sol:276-285)."""
    has_voted = torch.as_tensor(has_voted).cpu().numpy()
    vote_count = torch.as_tensor(vote_count).cpu().numpy()
    words = []
    for s in range(has_voted.shape[0]):
        w = 0
        for i in np.flatnonzero(has_voted[s]):
            w |= 1 << (255 - int(i))
        words.append(w + int(vote_count[s]) % 256)
    return words


def init_vote_state(shard_count: int, committee_size: int,
                    device=None) -> VoteState:
    """All-zero per-shard vote state on `device` (the card unless 'cpu'
    is asked for)."""
    dev = resolve_device(device)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    return VoteState(
        has_voted=zeros((shard_count, committee_size), torch.bool),
        vote_count=zeros(shard_count, torch.int32),
        last_submitted=zeros(shard_count, torch.int32),
        last_approved=zeros(shard_count, torch.int32),
        is_elected=zeros(shard_count, torch.bool),
        chunk_root=zeros((shard_count, 32), torch.uint8))
