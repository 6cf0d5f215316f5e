"""The port's single-device stress step (gethsharding_tpu_torch/parallel/
stress.py, BASELINE config 5) against the JAX package's
`parallel/stress.py`, on the CPU, on `build_stress_inputs(3,
votes_per_shard=3, txs_per_shard=2, committee_size=7)` at quorum 2:

1. the port's builder gives the reference builder's planes, pool,
   blockhash and sample size (same seed, same draws), through
   `convert.stress_inputs_from_reference`;
2. `StressPipeline` (the plain versions) on those planes: its vote planes
   equal to the reference's `add_header_reset_masked` and
   `submit_votes_batch`, its statuses and roots equal to the reference's
   transition and commitment on the host's senders, every aggregate
   valid (the host pairing agrees), and the totals their sums; `-m slow`
   holds all six planes and three totals against the reference's whole
   `StressPipeline(mesh=None)` (~2 min of XLA compile).

Every comparison is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.ops import replay_jax, smc_jax
from gethsharding_tpu.parallel import stress as rstress
from gethsharding_tpu.params import Config as RConfig
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.parallel import stress
from gethsharding_tpu_torch.params import Config
from gethsharding_tpu_torch.smc.state_machine import vote_digest

torch.set_num_threads(2)

SHARDS, VOTES, TXS, COMMITTEE, QUORUM = 3, 3, 2, 7, 2
PLANES = ("accepted", "vote_count", "is_elected", "agg_ok", "tx_status",
          "roots")
TOTALS = ("total_votes", "total_elected", "total_txs")


@pytest.fixture(scope="module")
def ref_workload():
    return rstress.build_stress_inputs(SHARDS, votes_per_shard=VOTES,
                                       txs_per_shard=TXS,
                                       committee_size=COMMITTEE)


@pytest.fixture(scope="module")
def port_workload():
    return stress.build_stress_inputs(SHARDS, votes_per_shard=VOTES,
                                      txs_per_shard=TXS,
                                      committee_size=COMMITTEE, device="cpu")


@pytest.fixture(scope="module")
def port_out(ref_workload):
    inputs, pool, bh, sample_size, _ = ref_workload
    return stress.StressPipeline(
        Config(committee_size=COMMITTEE, quorum_size=QUORUM)).run(
        convert.stress_inputs_from_reference(inputs, "cpu"), np.asarray(pool),
        np.asarray(bh), 1, sample_size)


def test_builder_equals_reference(ref_workload, port_workload):
    ref_inputs, ref_pool, ref_bh, ref_size, ref_extra = ref_workload
    inputs, pool, bh, size, extra = port_workload
    want = convert.stress_inputs_from_reference(ref_inputs, "cpu")
    for name in stress.StressInputs._fields:
        a, b = getattr(inputs, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert (pool == np.asarray(ref_pool)).all()
    assert (bh == np.asarray(ref_bh)).all() and size == ref_size
    assert [[t.encode_rlp() for t in txs] for txs in extra["shard_txs"]] == \
        [[t.encode_rlp() for t in txs] for txs in ref_extra["shard_txs"]]


def test_stress_step_equals_reference_pieces(ref_workload, port_out):
    inputs, pool, bh, sample_size, extra = ref_workload
    period = 1
    # the vote planes: the reference's reset and batch
    state = smc_jax.add_header_reset_masked(
        smc_jax.VoteState(
            has_voted=inputs.has_voted, vote_count=inputs.vote_count,
            last_submitted=inputs.last_submitted,
            last_approved=inputs.last_approved,
            is_elected=inputs.is_elected, chunk_root=inputs.chunk_root),
        inputs.new_header, jnp.int32(period), inputs.new_chunk_root)
    flat = lambda x: x.reshape((SHARDS * VOTES,) + x.shape[2:])
    attempts = smc_jax.VoteAttempts(
        shard=jnp.repeat(jnp.arange(SHARDS, dtype=jnp.int32), VOTES),
        index=flat(inputs.att_index), pool_index=flat(inputs.att_pool_index),
        sender=flat(inputs.att_sender), chunk_root=flat(inputs.att_chunk_root),
        deposited=flat(inputs.att_deposited), valid=flat(inputs.att_valid))
    state, accepted = jax.jit(
        smc_jax.submit_votes_batch,
        static_argnames=("committee_size", "quorum_size"))(
        state, jnp.asarray(pool), attempts, period=jnp.int32(period),
        blockhash=jnp.asarray(bh), sample_size=jnp.int32(sample_size),
        committee_size=COMMITTEE, quorum_size=QUORUM)
    assert port_out.accepted.numpy().ravel().tolist() == \
        np.asarray(accepted).tolist()
    assert (port_out.vote_count.numpy() == np.asarray(state.vote_count)).all()
    assert (port_out.is_elected.numpy() == np.asarray(state.is_elected)).all()

    # the replay: the reference's transition and roots on host senders
    from gethsharding_tpu.core import state_processor as rsp

    senders = np.zeros((SHARDS, TXS, 20), np.uint8)
    for s, txs in enumerate(extra["shard_txs"]):
        for j, tx in enumerate(txs):
            senders[s, j] = np.frombuffer(bytes(rsp.recover_sender(tx)),
                                          np.uint8)
    nonces, balances, status, _ = jax.jit(jax.vmap(replay_jax._shard_replay))(
        inputs.addrs, inputs.nonces, inputs.balances, inputs.coinbase_ix,
        jnp.asarray(senders), inputs.tx_valid, inputs.tx_nonce,
        inputs.tx_gas_limit, inputs.tx_intrinsic, inputs.tx_price,
        inputs.tx_value, inputs.tx_to, inputs.tx_valid)
    roots = jax.jit(replay_jax._state_root)(inputs.addrs, nonces, balances)
    assert (port_out.tx_status.numpy() == np.asarray(status)).all()
    assert (port_out.roots.numpy() == np.asarray(roots)).all()

    # every shard's aggregate vote is valid, as the host pairing says
    assert port_out.agg_ok.tolist() == [True] * SHARDS
    keys = [bls.bls_keygen(bytes([7, i])) for i in range(2)]
    root0 = bytes(np.asarray(inputs.new_chunk_root)[0])
    digest = vote_digest(0, period, root0)
    assert bls.bls_verify_aggregate(
        digest, bls.bls_aggregate_sigs([bls.bls_sign(digest, sk)
                                        for sk, _ in keys]),
        [pk for _, pk in keys])
    assert port_out.accepted.all() and port_out.tx_status.all()
    assert port_out.is_elected.all()      # 3 votes at quorum 2

    for name, plane in zip(TOTALS, ("accepted", "is_elected", "tx_status")):
        total = getattr(port_out, name)
        assert total.dtype == torch.int32 and total.dim() == 0
        assert int(total) == int(getattr(port_out, plane).sum()), name


@pytest.mark.slow
def test_stress_step_equals_reference_whole(ref_workload, port_out):
    inputs, pool, bh, sample_size, _ = ref_workload
    want = rstress.StressPipeline(
        config=RConfig(committee_size=COMMITTEE, quorum_size=QUORUM),
        mesh=None).run(inputs, pool, bh, 1, sample_size)
    for name in PLANES:
        assert (getattr(port_out, name).numpy()
                == np.asarray(getattr(want, name))).all(), name
    for name in TOTALS:
        assert int(getattr(port_out, name)) == int(getattr(want, name)), name
