"""The fused period step of BASELINE config 5 on one device: the port's
counterpart of the JAX package's `parallel/stress.py` with no mesh.

One step over S shards combines every per-period device path the port
has, in order, on one CUDA stream with no host sync until the outputs are
read:

  addHeader vote-plane reset    (ops/smc.py add_header_reset_masked)
  -> submitVote batch            (ops/smc.py submit_votes_batch: committee
                                  sampling on csrc/keccak_fixed.cu, the
                                  bitfield and quorum as scatters)
  -> committee BLS aggregation and verification
                                 (ops/bn256.py bls_aggregate_verify_
                                  committee_batch: csrc/agg.cu G1 and G2,
                                  csrc/miller.cu, csrc/finalexp.cu)
  -> collation replay            (ops/replay.py replay_batch:
                                  csrc/secp256k1.cu, the addresses on
                                  csrc/keccak_fixed.cu,
                                  csrc/replay.cu, the roots on
                                  csrc/keccak_fixed.cu)
  -> the period totals.

With a `Mesh` (`parallel/mesh.py`) the step runs in its mesh form, the
reference's `shard_map`: each slot runs `_step` on its contiguous slab of
shards, with the committee sampling on global shard ids (`base` = slot ×
slab) and the vote state on the slab's local ids. An uneven shard count
pads with zero rows, masked as the reference masks them (no new header,
no valid vote attempt, no valid aggregate, no valid transaction). The
three totals, stacked, cross the slots in one reduction per mesh axis
(`hierarchical_psum`, the innermost axis first); the per-shard outputs are
joined on slot 0 and cut back to the shard count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import replay, smc
from gethsharding_tpu_torch.parallel import mesh as mesh_mod
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.smc.state_machine import vote_digest
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32


class StressInputs(NamedTuple):
    """Leading axis S = shards on every field."""

    # SMC vote plane
    has_voted: torch.Tensor       # (S, C) bool
    vote_count: torch.Tensor      # (S,) int32
    last_submitted: torch.Tensor  # (S,) int32
    last_approved: torch.Tensor   # (S,) int32
    is_elected: torch.Tensor      # (S,) bool
    chunk_root: torch.Tensor      # (S, 32) uint8: prior record roots
    # this period's headers
    new_header: torch.Tensor      # (S,) bool
    new_chunk_root: torch.Tensor  # (S, 32) uint8
    # vote attempts, V rows per shard (padded with valid=False)
    att_index: torch.Tensor       # (S, V) int32
    att_pool_index: torch.Tensor  # (S, V) int32
    att_sender: torch.Tensor      # (S, V, 20) uint8
    att_chunk_root: torch.Tensor  # (S, V, 32) uint8
    att_deposited: torch.Tensor   # (S, V) bool
    att_valid: torch.Tensor       # (S, V) bool
    # committee BLS votes per shard, aggregated on the device
    hx: torch.Tensor              # (S, NLIMBS)
    hy: torch.Tensor
    sigx: torch.Tensor            # (S, Cw, NLIMBS) raw vote signatures
    sigy: torch.Tensor
    sig_mask: torch.Tensor        # (S, Cw) bool
    pkx: torch.Tensor             # (S, Cw, 2, NLIMBS) voter pubkeys
    pky: torch.Tensor
    pk_mask: torch.Tensor         # (S, Cw) bool
    agg_valid: torch.Tensor       # (S,) bool
    # collation replay (see ops/replay.py ReplayInputs)
    addrs: torch.Tensor
    nonces: torch.Tensor
    balances: torch.Tensor
    coinbase_ix: torch.Tensor
    tx_e: torch.Tensor
    tx_r: torch.Tensor
    tx_s: torch.Tensor
    tx_recid: torch.Tensor
    tx_nonce: torch.Tensor
    tx_gas_limit: torch.Tensor
    tx_intrinsic: torch.Tensor
    tx_price: torch.Tensor
    tx_value: torch.Tensor
    tx_to: torch.Tensor
    tx_valid: torch.Tensor


class StressOutputs(NamedTuple):
    accepted: torch.Tensor        # (S, V) bool: accepted vote attempts
    vote_count: torch.Tensor      # (S,) int32
    is_elected: torch.Tensor      # (S,) bool
    agg_ok: torch.Tensor          # (S,) bool: aggregate signature valid
    tx_status: torch.Tensor       # (S, T) bool
    roots: torch.Tensor           # (S, 32) uint8: post-replay state roots
    total_votes: torch.Tensor     # () int32
    total_elected: torch.Tensor   # () int32
    total_txs: torch.Tensor       # () int32


def _step(inp: StressInputs, pool_addr, blockhash, period: int,
          sample_size: int, committee_size: int, quorum_size: int,
          base: int = 0) -> StressOutputs:
    """The step on one device's shards; `base` is the global id of its
    first shard (a mesh slot's slab), which the committee sampling sees."""
    s, v = inp.att_index.shape

    # 1. addHeader resets
    state = smc.VoteState(
        has_voted=inp.has_voted, vote_count=inp.vote_count,
        last_submitted=inp.last_submitted, last_approved=inp.last_approved,
        is_elected=inp.is_elected, chunk_root=inp.chunk_root)
    state = smc.add_header_reset_masked(state, inp.new_header, period,
                                        inp.new_chunk_root)

    # 2. the submitVote batch, the attempts flattened shard by shard:
    # local ids route the state, global ids feed the sampling
    flat = lambda x: x.reshape((s * v,) + x.shape[2:])
    shard_ids = torch.arange(s, dtype=torch.int32,
                             device=inp.att_index.device).repeat_interleave(v)
    attempts = smc.VoteAttempts(
        shard=shard_ids, index=flat(inp.att_index),
        pool_index=flat(inp.att_pool_index), sender=flat(inp.att_sender),
        chunk_root=flat(inp.att_chunk_root),
        deposited=flat(inp.att_deposited), valid=flat(inp.att_valid))
    state, accepted = smc.submit_votes_batch(
        state, pool_addr, attempts, period=period, blockhash=blockhash,
        sample_size=sample_size, committee_size=committee_size,
        quorum_size=quorum_size,
        sample_shard=None if base == 0 else shard_ids + base)

    # 3. committee BLS aggregation and verification
    agg_ok = bn.bls_aggregate_verify_committee_batch(
        inp.hx, inp.hy, inp.sigx, inp.sigy, inp.sig_mask, inp.pkx, inp.pky,
        inp.pk_mask, inp.agg_valid)

    # 4. collation replay: the planes share ReplayInputs' names; the
    # stress planes have no table_len, which only the host's canonical
    # roots read
    rep = replay.replay_batch(replay.ReplayInputs(table_len=None, **{
        name: getattr(inp, name) for name in replay.ReplayInputs._fields
        if name != "table_len"}))

    # 5. the period totals
    count = lambda x: x.to(torch.int32).sum(dtype=torch.int32)
    return StressOutputs(
        accepted=accepted.reshape(s, v), vote_count=state.vote_count,
        is_elected=state.is_elected, agg_ok=agg_ok, tx_status=rep.statuses,
        roots=rep.roots, total_votes=count(accepted),
        total_elected=count(state.is_elected),
        total_txs=count(rep.statuses))


class StressPipeline:
    """The config-5 step with the committee and quorum of `config`: on the
    device of its inputs (the card, or the CPU for CPU tensors), or over
    `mesh`'s slots (module docstring)."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 mesh: mesh_mod.Mesh = None):
        self.config = config
        self.mesh = mesh

    def run(self, inputs: StressInputs, pool_addr, blockhash, period: int,
            sample_size: int) -> StressOutputs:
        c, q = self.config.committee_size, self.config.quorum_size
        if self.mesh is None:
            dev = inputs.has_voted.device
            with mesh_mod.slot_context(dev):
                return _step(inputs, _bytes_on(pool_addr, dev),
                             _bytes_on(blockhash, dev), int(period),
                             int(sample_size), c, q)
        m = self.mesh
        n = int(inputs.has_voted.shape[0])
        padded = -(-n // m.size) * m.size
        rows = padded // m.size
        slabs = [mesh_mod.split_rows(mesh_mod.pad_rows(a, padded - n), m)
                 for a in inputs]
        outs = []
        for i, dev in enumerate(m.devices):
            with mesh_mod.slot_context(dev):
                slab = StressInputs(*(plane[i] for plane in slabs))
                outs.append(_step(slab, _bytes_on(pool_addr, dev),
                                  _bytes_on(blockhash, dev), int(period),
                                  int(sample_size), c, q, base=i * rows))
        totals = mesh_mod.hierarchical_psum(
            [torch.stack([o.total_votes, o.total_elected, o.total_txs])
             for o in outs], m)
        joined = [mesh_mod.gather_rows([getattr(o, name) for o in outs])[:n]
                  for name in StressOutputs._fields[:6]]
        return StressOutputs(*joined, *totals.unbind(0))


def _bytes_on(x, dev) -> torch.Tensor:
    """A uint8 plane (numpy, a sequence or a tensor) on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x, np.uint8))
    return x.to(device=dev, dtype=torch.uint8)


# == distinct-per-shard workload builder ===================================


def build_stress_inputs(n_shards: int, *, votes_per_shard: int = 3,
                        txs_per_shard: int = 2, committee_size: int = 135,
                        period: int = 1, seed: int = 7, device=None):
    """Distinct per-shard data for the stress step, made on the host with
    scalar crypto in the reference builder's order of random draws (the
    same seed gives the same planes): a notary pool, per-shard vote
    attempts the committee sampling accepts, per-shard aggregate BLS votes
    on the shard's own digest (a committee of two keys), and per-shard
    signed transfers from one funded sender.

    Returns (inputs on `device`, pool_addr (P, 20) uint8, blockhash (32,)
    uint8, sample_size, {"shard_txs": ...})."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool_size = committee_size
    pool = [Address20(bytes(rng.integers(1, 255, 20, dtype=np.uint8)))
            for _ in range(pool_size)]
    pool_addr = np.stack([np.frombuffer(bytes(a), np.uint8) for a in pool])
    blockhash = bytes(rng.integers(0, 255, 32, dtype=np.uint8))
    sample_size = pool_size

    def sampled_slot(pool_index: int, shard: int) -> int:
        pre = (blockhash + pool_index.to_bytes(32, "big")
               + shard.to_bytes(32, "big"))
        return int.from_bytes(keccak256(pre), "big") % sample_size

    s, v, t = n_shards, votes_per_shard, txs_per_shard
    roots = rng.integers(0, 255, (s, 32), dtype=np.uint8)
    att_index = np.tile(np.arange(v, dtype=np.int32), (s, 1))
    att_sender = np.zeros((s, v, 20), np.uint8)
    for shard in range(s):
        for j in range(v):
            # attempt j claims pool slot j; its sender is the member the
            # committee sampling selects for (j, shard)
            att_sender[shard, j] = pool_addr[sampled_slot(j, shard)]

    # distinct committee BLS votes per shard, aggregated on the device
    keys = [bls.bls_keygen(bytes([seed % 256, i])) for i in range(2)]
    h_pts, sig_rows, pk_rows = [], [], []
    for shard in range(s):
        digest = vote_digest(shard, period, Hash32(bytes(roots[shard])))
        h_pts.append(bls.hash_to_g1(digest))
        sig_rows.append([bls.bls_sign(digest, sk) for sk, _ in keys])
        pk_rows.append([pk for _, pk in keys])
    hx, hy, hok = bn.g1_to_limbs(h_pts)
    sigx, sigy, sig_mask = bn.g1_committee_to_limbs(sig_rows, len(keys))
    pkx, pky, pk_mask = bn.g2_committee_to_limbs(pk_rows, len(keys))

    # distinct replay data per shard: one funded sender pays a recipient
    priv = [(int(rng.integers(1, 2 ** 31)) * 2663 + shard) % ecdsa.N or 1
            for shard in range(s)]
    shard_txs, genesis = [], []
    coinbase = Address20(b"\xc0" * 20)
    for shard in range(s):
        sender_addr = Address20(ecdsa.priv_to_address(priv[shard]))
        recipient = Address20(bytes(rng.integers(1, 255, 20, dtype=np.uint8)))
        shard_txs.append([sp.sign_transaction(
            Transaction(nonce=k, gas_price=1, gas_limit=30000, to=recipient,
                        value=1000 + shard, payload=bytes([shard % 256])),
            priv[shard]) for k in range(t)])
        genesis.append({sender_addr: sp.AccountState(balance=10 ** 9)})
    rep = replay.build_replay_inputs(shard_txs, genesis, [coinbase] * s,
                                     pad_txs=t, device=dev)

    on = lambda a: torch.as_tensor(a, device=dev)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    inputs = StressInputs(
        has_voted=zeros((s, committee_size), torch.bool),
        vote_count=zeros(s, torch.int32),
        last_submitted=zeros(s, torch.int32),
        last_approved=zeros(s, torch.int32),
        is_elected=zeros(s, torch.bool),
        chunk_root=zeros((s, 32), torch.uint8),
        new_header=torch.ones(s, dtype=torch.bool, device=dev),
        new_chunk_root=on(roots),
        att_index=on(att_index), att_pool_index=on(att_index.copy()),
        att_sender=on(att_sender),
        att_chunk_root=on(np.repeat(roots[:, None, :], v, axis=1)),
        att_deposited=torch.ones((s, v), dtype=torch.bool, device=dev),
        att_valid=torch.ones((s, v), dtype=torch.bool, device=dev),
        hx=on(hx), hy=on(hy), sigx=on(sigx), sigy=on(sigy),
        sig_mask=on(sig_mask), pkx=on(pkx), pky=on(pky),
        pk_mask=on(pk_mask), agg_valid=on(hok),
        addrs=rep.addrs, nonces=rep.nonces, balances=rep.balances,
        coinbase_ix=rep.coinbase_ix, tx_e=rep.tx_e, tx_r=rep.tx_r,
        tx_s=rep.tx_s, tx_recid=rep.tx_recid, tx_nonce=rep.tx_nonce,
        tx_gas_limit=rep.tx_gas_limit, tx_intrinsic=rep.tx_intrinsic,
        tx_price=rep.tx_price, tx_value=rep.tx_value, tx_to=rep.tx_to,
        tx_valid=rep.tx_valid)
    return (inputs, pool_addr, np.frombuffer(blockhash, np.uint8).copy(),
            sample_size, {"shard_txs": shard_txs})
