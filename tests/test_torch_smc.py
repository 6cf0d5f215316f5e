"""The port's SMC vote batch (gethsharding_tpu_torch/ops/smc.py) against
the JAX package's `ops/smc_jax.py` and the scalar state machine
(`smc/state_machine.py`), on the CPU:

1. `sample_committee` against the reference's and the scalar
   `get_notary_in_committee_view` for every (notary, shard) pair;
2. `submit_votes_batch` on tests/test_smc_jax.py's period (every eligible
   vote, a duplicate (shard, index), an index out of range, a bad root,
   an undeposited sender, a shard with no header, a deregistered notary)
   plus more duplicates (a pair and a triple), shards -1 and S, a wrong
   sender (a notary not sampled for the shard), applied in order by the
   scalar SMC: the same accepts and reverts, vote words, elected flags,
   lastApproved and lastSubmitted; and against the reference batch,
   every plane equal, with index -1, invalid rows, a stale period and a
   stale count at quorum added;
3. `add_header_reset`, `add_header_reset_masked`, `init_vote_state` and
   `export_vote_word` against the reference's;
4. one period's vote log of the reference `SimulatedMainchain`, built as
   its `verify_period_batch` builds it (`smc/chain.py:589-640`), replayed
   through the port: every vote accepted, and the words, elected flags
   and approvals equal to the chain's final scalar state.

States and attempts cross over through `convert.vote_state_from_reference`
and `convert.vote_attempts_from_reference`; every comparison is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.crypto.keccak import keccak256
from gethsharding_tpu.ops import smc_jax
from gethsharding_tpu.params import Config as RConfig
from gethsharding_tpu.smc.state_machine import SMC, Notary, SMCRevert
from gethsharding_tpu.utils.hexbytes import Address20, Hash32
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.ops import smc
from gethsharding_tpu_torch.params import Config

torch.set_num_threads(2)

CFG = RConfig(shard_count=6, committee_size=9, quorum_size=3)
POOL_CAP = 16


def _addr(i: int) -> Address20:
    return Address20(keccak256(b"notary" + bytes([i]))[:20])


def _blockhash_fn(n: int) -> Hash32:
    return Hash32(keccak256(b"block" + n.to_bytes(8, "big")))


def _pool_array(chain_smc: SMC) -> np.ndarray:
    pool = np.zeros((POOL_CAP, 20), np.uint8)
    for i, a in enumerate(chain_smc.notary_pool):
        if a is not None:
            pool[i] = np.frombuffer(bytes(a), np.uint8)
    return pool


def _setup():
    chain_smc = SMC(CFG, blockhash_fn=_blockhash_fn)
    notaries = [_addr(i) for i in range(10)]
    for a in notaries:
        chain_smc.register_notary(a, CFG.notary_deposit, block_number=0)
    # one deregistration: the slot empties, the registry stays deposited
    chain_smc.deregister_notary(notaries[3], block_number=1)
    return chain_smc, notaries


def test_configs_equal_reference():
    assert Config() == Config(**RConfig().__dict__)
    assert Config().__dict__ == RConfig().__dict__


# == 1. committee sampling ====================================================


def test_sample_committee_equals_reference_and_scalar():
    chain_smc, notaries = _setup()
    block_number = 5
    chain_smc._update_notary_sample_size(block_number)
    sample_size = chain_smc.current_period_notary_sample_size
    bh = np.frombuffer(bytes(_blockhash_fn(CFG.period_length - 1)),
                       np.uint8).copy()
    pool_idx, shards, expect = [], [], []
    for a in notaries:
        for s in range(CFG.shard_count):
            pool_idx.append(chain_smc.notary_registry[a].pool_index)
            shards.append(s)
            expect.append(bytes(chain_smc.get_notary_in_committee_view(
                a, s, block_number)))
    pool_idx += [-1, 2 ** 31 - 1, 0]     # the low four bytes, as the
    shards += [0, 3, -5]                  # reference takes them
    got = smc.sample_committee(torch.as_tensor(bh),
                               torch.tensor(pool_idx, dtype=torch.int32),
                               torch.tensor(shards, dtype=torch.int32),
                               sample_size)
    want = jax.jit(smc_jax.sample_committee)(
        jnp.asarray(bh), jnp.asarray(pool_idx, jnp.int32),
        jnp.asarray(shards, jnp.int32), jnp.int32(sample_size))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    pool = _pool_array(chain_smc)
    for k, slot in enumerate(got.tolist()[:len(expect)]):
        member = pool[slot] if slot < POOL_CAP else np.zeros(20, np.uint8)
        assert member.tobytes() == expect[k], k
    for bad in (0, smc.MAX_SAMPLE_SIZE):
        with pytest.raises(ValueError):
            smc.sample_committee(torch.as_tensor(bh),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32), bad)


# == 2. the vote batch ========================================================


def _period():
    """The reference test's period: headers on every shard but the last,
    then attempts (sender, shard, index, root, deposited) in a shuffled
    order: every eligible vote and the hostile kinds."""
    chain_smc, notaries = _setup()
    period, block_number = 1, 5
    roots = {s: Hash32(keccak256(b"root" + bytes([s])))
             for s in range(CFG.shard_count)}
    headed = list(range(CFG.shard_count - 1))
    for s in headed:
        chain_smc.add_header(notaries[0], s, period, roots[s], b"",
                             block_number)
    chain_smc._update_notary_sample_size(block_number)
    sample_size = chain_smc.current_period_notary_sample_size
    bh = np.frombuffer(
        bytes(_blockhash_fn(period * CFG.period_length - 1)), np.uint8).copy()

    eligible, attempts, counter = {}, [], 0
    for a in notaries:
        for s in range(CFG.shard_count):
            if chain_smc.get_notary_in_committee_view(a, s,
                                                      block_number) == a:
                eligible.setdefault(a, set()).add(s)
                attempts.append((a, s, counter % CFG.committee_size,
                                 roots[s], True))
                counter += 1
    a0, s0, i0 = attempts[0][:3]
    a1, s1, i1 = attempts[1][:3]
    attempts += [
        (a0, s0, i0, roots[s0], True),                  # duplicate
        (a1, s1, i1, roots[s1], True),                  # a triple
        (a1, s1, i1, roots[s1], True),
        (a0, s0, CFG.committee_size, roots[s0], True),  # index out of range
        (a0, -1, 4, roots[0], True),                    # shard -1
        (a0, CFG.shard_count, 4, roots[0], True),       # shard S
        (a0, s0, 5, Hash32(b"\xff" * 32), True),        # bad root
        (_addr(99), s0, 6, roots[s0], False),           # undeposited
        (a0, CFG.shard_count - 1, 7, roots[CFG.shard_count - 1], True),
        (notaries[3], s0, 8, roots[s0], True),          # deregistered
    ]
    # a wrong sender: a deposited notary not sampled for the shard
    stray = next((a, s) for a in notaries if a != notaries[3]
                 for s in headed if s not in eligible.get(a, ()))
    attempts.append((stray[0], stray[1], 2, roots[stray[1]], True))
    np.random.default_rng(0).shuffle(attempts)
    return (chain_smc, period, block_number, headed, roots, sample_size, bh,
            attempts)


def _ref_planes(chain_smc, period, headed, roots, attempts, valid=None):
    state = smc_jax.add_header_reset(
        smc_jax.init_vote_state(CFG.shard_count, CFG.committee_size),
        jnp.asarray(headed, jnp.int32), jnp.int32(period),
        jnp.asarray(np.stack([np.frombuffer(bytes(roots[s]), np.uint8)
                              for s in headed])))
    n = len(attempts)
    batch = smc_jax.VoteAttempts(
        shard=jnp.asarray([t[1] for t in attempts], jnp.int32),
        index=jnp.asarray([t[2] for t in attempts], jnp.int32),
        pool_index=jnp.asarray(
            [chain_smc.notary_registry.get(t[0], Notary()).pool_index
             for t in attempts], jnp.int32),
        sender=jnp.asarray(np.stack(
            [np.frombuffer(bytes(t[0]), np.uint8) for t in attempts])),
        chunk_root=jnp.asarray(np.stack(
            [np.frombuffer(bytes(t[3]), np.uint8) for t in attempts])),
        deposited=jnp.asarray([t[4] for t in attempts], jnp.bool_),
        valid=jnp.ones(n, jnp.bool_) if valid is None
        else jnp.asarray(valid))
    return state, batch


def _run_both(state, batch, pool, period, bh, sample_size):
    kw = dict(committee_size=CFG.committee_size, quorum_size=CFG.quorum_size)
    want_state, want_acc = jax.jit(
        smc_jax.submit_votes_batch,
        static_argnames=("committee_size", "quorum_size"))(
        state, jnp.asarray(pool), batch, period=jnp.int32(period),
        blockhash=jnp.asarray(bh), sample_size=jnp.int32(sample_size), **kw)
    got_state, got_acc = smc.submit_votes_batch(
        convert.vote_state_from_reference(state, "cpu"), torch.as_tensor(pool),
        convert.vote_attempts_from_reference(batch, "cpu"), period=period,
        blockhash=torch.as_tensor(bh), sample_size=sample_size, **kw)
    return (got_state, got_acc), (want_state, want_acc)


def _assert_planes_equal(got, want):
    (got_state, got_acc), (want_state, want_acc) = got, want
    assert got_acc.tolist() == np.asarray(want_acc).tolist()
    for name in smc.VoteState._fields:
        g, w = getattr(got_state, name), np.asarray(getattr(want_state, name))
        assert g.numpy().dtype == w.dtype and (g.numpy() == w).all(), name


def test_vote_batch_equals_scalar_sequential():
    (chain_smc, period, block_number, headed, roots, sample_size, bh,
     attempts) = _period()
    pool = _pool_array(chain_smc)
    state, batch = _ref_planes(chain_smc, period, headed, roots, attempts)
    got, want = _run_both(state, batch, pool, period, bh, sample_size)
    _assert_planes_equal(got, want)

    scalar_ok = []
    for (a, s, i, root, _) in attempts:
        try:
            chain_smc.submit_vote(a, s, period, i, root, block_number)
            scalar_ok.append(True)
        except SMCRevert:
            scalar_ok.append(False)
    new_state, accepted = got
    assert accepted.tolist() == scalar_ok
    assert 0 < sum(scalar_ok) < len(scalar_ok)
    words = smc.export_vote_word(new_state.has_voted, new_state.vote_count)
    for s in range(CFG.shard_count):
        assert words[s] == chain_smc.current_vote.get(s, 0), s
        rec = chain_smc.collation_records.get((s, period))
        assert bool(new_state.is_elected[s]) == (rec.is_elected if rec
                                                 else False), s
        assert int(new_state.last_approved[s]) == \
            chain_smc.last_approved_collation.get(s, 0), s
        assert int(new_state.last_submitted[s]) == \
            chain_smc.last_submitted_collation.get(s, 0), s


def test_vote_batch_equals_reference_on_hostile_planes():
    (chain_smc, period, _, headed, roots, sample_size, bh,
     attempts) = _period()
    a0, s0 = attempts[0][:2]
    attempts = attempts + [(a0, s0, -1, roots[s0], True)] * 2   # index -1
    valid = np.ones(len(attempts), bool)
    valid[::5] = False                                    # invalid rows
    state, batch = _ref_planes(chain_smc, period, headed, roots, attempts,
                               valid)
    # a stale period on shard 2; a stale count at quorum on shard 4 (no
    # accepted vote there keeps its approval state); earlier approvals
    state = state._replace(
        last_submitted=state.last_submitted.at[2].set(period - 1),
        vote_count=state.vote_count.at[4].set(CFG.quorum_size + 1),
        last_approved=jnp.arange(CFG.shard_count, dtype=jnp.int32) % 2)
    batch = batch._replace(
        index=jnp.where(batch.shard == 4, 0, batch.index),
        valid=jnp.where(batch.shard == 4, False, batch.valid))
    pool = _pool_array(chain_smc)
    got, want = _run_both(state, batch, pool, period, bh, sample_size)
    _assert_planes_equal(got, want)
    assert got[1].any() and not got[1].all()
    assert int(got[0].vote_count[4]) == CFG.quorum_size + 1
    assert not bool(got[0].is_elected[4])


# == 3. the header resets and the vote word ===================================


def test_resets_and_words_equal_reference():
    rng = np.random.default_rng(5)
    S, C = 7, 9
    ref_state = smc_jax.VoteState(
        has_voted=jnp.asarray(rng.random((S, C)) < 0.4),
        vote_count=jnp.asarray(rng.integers(0, 300, S), jnp.int32),
        last_submitted=jnp.asarray(rng.integers(0, 4, S), jnp.int32),
        last_approved=jnp.asarray(rng.integers(0, 4, S), jnp.int32),
        is_elected=jnp.asarray(rng.random(S) < 0.5),
        chunk_root=jnp.asarray(rng.integers(0, 256, (S, 32)), jnp.uint8))
    state = convert.vote_state_from_reference(ref_state, "cpu")
    ids = np.asarray([0, 3, 6], np.int32)
    roots = rng.integers(0, 256, (3, 32)).astype(np.uint8)
    mask = rng.random(S) < 0.5
    all_roots = rng.integers(0, 256, (S, 32)).astype(np.uint8)
    pairs = [
        (smc.add_header_reset(state, torch.as_tensor(ids), 5,
                              torch.as_tensor(roots)),
         smc_jax.add_header_reset(ref_state, jnp.asarray(ids), jnp.int32(5),
                                  jnp.asarray(roots))),
        (smc.add_header_reset_masked(state, torch.as_tensor(mask), 5,
                                     torch.as_tensor(all_roots)),
         smc_jax.add_header_reset_masked(ref_state, jnp.asarray(mask),
                                         jnp.int32(5),
                                         jnp.asarray(all_roots))),
        (smc.init_vote_state(S, C, device="cpu"),
         smc_jax.init_vote_state(S, C))]
    for got, want in pairs:
        for name in smc.VoteState._fields:
            w = np.asarray(getattr(want, name))
            assert (getattr(got, name).numpy() == w).all(), name
            assert getattr(got, name).shape == w.shape, name
        assert smc.export_vote_word(got.has_voted, got.vote_count) == \
            smc_jax.export_vote_word(np.asarray(want.has_voted),
                                     np.asarray(want.vote_count))
    # state untouched
    assert (state.has_voted.numpy() == np.asarray(ref_state.has_voted)).all()


# == 4. the chain's vote log ==================================================


def test_chain_vote_log_replays_on_the_port():
    """A period of votes through the reference `SimulatedMainchain`, its
    log replayed as `verify_period_batch` replays it, on the port."""
    from gethsharding_tpu.smc.chain import SimulatedMainchain

    config = RConfig(shard_count=5, committee_size=9, quorum_size=2)
    chain = SimulatedMainchain(config=config)
    notaries = [_addr(40 + i) for i in range(24)]
    for a in notaries:
        chain.fund(a)
        chain.register_notary(a)
    chain.fast_forward(1)
    period = chain.current_period()
    roots = {s: Hash32(keccak256(b"chain-root" + bytes([s])))
             for s in range(config.shard_count)}
    for s in range(config.shard_count - 1):
        chain.add_header(notaries[0], s, period, roots[s])
    votes = 0
    for s in range(config.shard_count - 1):
        index = 0
        for a in notaries:
            if chain.get_notary_in_committee(a, s) == a:
                chain.submit_vote(a, s, period, index, roots[s])
                index += 1
                votes += 1
    assert votes
    chain.fast_forward(1)
    assert chain.verify_period_batch(period) is True

    entry = chain._vote_audit[period]
    s_count, committee = config.shard_count, config.committee_size
    last_sub = np.zeros(s_count, np.int32)
    root_plane = np.zeros((s_count, 32), np.uint8)
    last_appr = np.zeros(s_count, np.int32)
    for s in range(s_count):
        last_appr[s] = entry["pre_last_approved"].get(s, 0)
        rec = chain.smc.collation_records.get((s, period))
        if rec is not None:
            last_sub[s] = period
            root_plane[s] = np.frombuffer(bytes(rec.chunk_root), np.uint8)
    state = smc.init_vote_state(s_count, committee, device="cpu")._replace(
        last_submitted=torch.as_tensor(last_sub),
        chunk_root=torch.as_tensor(root_plane),
        last_approved=torch.as_tensor(last_appr))
    pool = entry["pool"]
    pool_addr = np.zeros((max(len(pool), 1), 20), np.uint8)
    for i, addr in enumerate(pool):
        if addr is not None:
            pool_addr[i] = np.frombuffer(addr, np.uint8)
    log = entry["attempts"]
    col = lambda key: torch.tensor([a[key] for a in log], dtype=torch.int32)
    rows = lambda key: torch.as_tensor(np.stack(
        [np.frombuffer(a[key], np.uint8) for a in log]))
    attempts = smc.VoteAttempts(
        shard=col("shard"), index=col("index"), pool_index=col("pool_index"),
        sender=rows("sender"), chunk_root=rows("chunk_root"),
        deposited=torch.ones(len(log), dtype=torch.bool),
        valid=torch.ones(len(log), dtype=torch.bool))
    new_state, accepted = smc.submit_votes_batch(
        state, torch.as_tensor(pool_addr), attempts, period=period,
        blockhash=torch.tensor(list(entry["blockhash"]), dtype=torch.uint8),
        sample_size=entry["sample_size"], committee_size=committee,
        quorum_size=config.quorum_size)
    assert bool(accepted.all())
    words = smc.export_vote_word(new_state.has_voted, new_state.vote_count)
    final = entry["final"]
    for s in sorted({a["shard"] for a in log}):
        assert words[s] == final["words"].get(s, 0), s
        assert bool(new_state.is_elected[s]) == \
            final["elected"].get(s, False), s
        assert int(new_state.last_approved[s]) == \
            final["last_approved"].get(s, 0), s
    assert any(final["elected"].values())
