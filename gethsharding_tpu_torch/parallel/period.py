"""The per-period cross-shard pipeline, verify → tally → approve: the port's
counterpart of the JAX package's `parallel/period.py`.

For every shard of a period: verify the committee vote on the shard's
collation header (the batched pairing kernels), count the accepted votes,
apply the quorum rule and sum the period totals (BASELINE configs 3 and
5). Two layouts, the same arithmetic:

- one device: one batch over all shards;
- a mesh (`parallel/mesh.py`): each slot verifies its contiguous slab of
  shards, and the two totals, stacked, cross the slots in one reduction
  per mesh axis. An uneven shard count pads with zero rows whose
  `has_header` is False, so they add nothing to the totals.

`PeriodPipeline` takes pre-aggregated committee points (one Miller and one
final-exponentiation launch a slot); `CommitteePeriodPipeline` takes the
raw votes and voter pubkeys and sums them on the device first (the G1 and
G2 committee sums, then the same two launches), the production audit's
kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.parallel import mesh as mesh_mod
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG


class PeriodInputs(NamedTuple):
    """One period across S shards (leading axis = shard)."""

    hx: torch.Tensor    # (S, NL) G1 hash of each header
    hy: torch.Tensor
    sx: torch.Tensor    # (S, NL) aggregate committee signature
    sy: torch.Tensor
    pkx: torch.Tensor   # (S, 2, NL) aggregate committee pubkey
    pky: torch.Tensor
    vote_count: torch.Tensor  # (S,) int32: votes aggregated per shard
    has_header: torch.Tensor  # (S,) bool: a submission this period


class PeriodOutputs(NamedTuple):
    verified: torch.Tensor        # (S,) bool: aggregate signature valid
    approved: torch.Tensor        # (S,) bool: verified and quorum reached
    total_votes: torch.Tensor     # () int32: counted votes, all shards
    total_approved: torch.Tensor  # () int32: approved shards


def _tally(ok, counted, quorum: int) -> PeriodOutputs:
    """Quorum and the totals of one device's shards: the one tail of both
    pipelines (the mesh sums the slots' totals after it)."""
    approved = ok & (counted >= quorum)
    return PeriodOutputs(ok, approved, counted.sum(dtype=torch.int32),
                         approved.to(torch.int32).sum(dtype=torch.int32))


def _step(inp: PeriodInputs):
    ok = bn.bls_verify_aggregate_batch(inp.hx, inp.hy, inp.sx, inp.sy,
                                       inp.pkx, inp.pky, inp.has_header)
    return ok, torch.where(ok, inp.vote_count, 0).to(torch.int32)


def _run_padded(step, quorum: int, mesh: Optional[mesh_mod.Mesh], inputs,
                tuple_cls) -> PeriodOutputs:
    """Run a period step on one device, or over the mesh: pad the shard
    axis with zero rows to a multiple of the slots, run each slot's slab
    on its device, reduce the stacked totals once per mesh axis and cut
    the per-shard outputs back to the shard count."""
    if mesh is None:
        with mesh_mod.slot_context(inputs[0].device):
            return _tally(*step(inputs), quorum)
    n = int(inputs[0].shape[0])
    padded = -(-n // mesh.size) * mesh.size
    slabs = [mesh_mod.split_rows(mesh_mod.pad_rows(a, padded - n), mesh)
             for a in inputs]
    outs = []
    for i, dev in enumerate(mesh.devices):
        with mesh_mod.slot_context(dev):
            slab = tuple_cls(*(plane[i] for plane in slabs))
            outs.append(_tally(*step(slab), quorum))
    totals = mesh_mod.hierarchical_psum(
        [torch.stack([o.total_votes, o.total_approved]) for o in outs], mesh)
    return PeriodOutputs(
        mesh_mod.gather_rows([o.verified for o in outs])[:n],
        mesh_mod.gather_rows([o.approved for o in outs])[:n],
        totals[0], totals[1])


class PeriodPipeline:
    """Per-period verifier over pre-aggregated committee points, on one
    device (`device`, None: the card) or over `mesh`; uneven shard counts
    pad with masked rows (`_run_padded`)."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 mesh: Optional[mesh_mod.Mesh] = None, device=None):
        self.config = config
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))

    def run(self, inputs: PeriodInputs) -> PeriodOutputs:
        return _run_padded(_step, self.config.quorum_size, self.mesh,
                           inputs, PeriodInputs)

    def build_inputs(self, headers: Sequence[Optional[bytes]],
                     agg_sigs: Sequence[Optional[bls.G1Point]],
                     agg_pks: Sequence[Optional[bls.G2Point]],
                     vote_counts: Sequence[int]) -> PeriodInputs:
        """Host records -> tensors on the pipeline's (first) device.
        `headers[i] is None` marks a shard with no submission (masked)."""
        hashes = [bls.hash_to_g1(h) if h is not None else None
                  for h in headers]
        hx, hy, hok = bn.g1_to_limbs(hashes)
        sx, sy, sok = bn.g1_to_limbs(list(agg_sigs))
        pkx, pky, pok = bn.g2_to_limbs(list(agg_pks))
        on = lambda a: torch.as_tensor(a, device=self.device)
        return PeriodInputs(
            hx=on(hx), hy=on(hy), sx=on(sx), sy=on(sy), pkx=on(pkx),
            pky=on(pky), vote_count=on(np.asarray(vote_counts, np.int32)),
            has_header=on(hok & sok & pok))


class CommitteePeriodInputs(NamedTuple):
    """One period at committee granularity (leading axis = shard): the raw
    vote signatures and voter pubkeys, summed on the device."""

    hx: torch.Tensor        # (S, NL) G1 hash of each header
    hy: torch.Tensor
    sigx: torch.Tensor      # (S, C, NL) per-vote signatures
    sigy: torch.Tensor
    sig_mask: torch.Tensor  # (S, C) bool: filled vote slots
    pkx: torch.Tensor       # (S, C, 2, NL) voter pubkeys
    pky: torch.Tensor
    pk_mask: torch.Tensor   # (S, C) bool
    has_header: torch.Tensor  # (S,) bool


def _committee_step(inp: CommitteePeriodInputs):
    ok = bn.bls_aggregate_verify_committee_batch(
        inp.hx, inp.hy, inp.sigx, inp.sigy, inp.sig_mask, inp.pkx, inp.pky,
        inp.pk_mask, inp.has_header)
    # the counted votes are the filled signature slots: the device holds
    # the ground truth, so a stale host-side count cannot inflate a quorum
    counted = inp.sig_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return ok, torch.where(ok, counted, 0).to(torch.int32)


class CommitteePeriodPipeline:
    """The production period step: per-shard committee sums, the batched
    pairing check and the quorum tally, over the shard axis of `mesh`
    (or on `device`, None: the card); only the two totals cross slots."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 mesh: Optional[mesh_mod.Mesh] = None, device=None):
        self.config = config
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))

    def run(self, inputs: CommitteePeriodInputs) -> PeriodOutputs:
        return _run_padded(_committee_step, self.config.quorum_size,
                           self.mesh, inputs, CommitteePeriodInputs)

    def build_inputs(self, headers: Sequence[Optional[bytes]],
                     sig_rows: Sequence[Sequence[bls.G1Point]],
                     pk_rows: Sequence[Sequence[bls.G2Point]],
                     width: Optional[int] = None) -> CommitteePeriodInputs:
        """Host vote records -> committee-granular tensors; the committee
        axis pads to `width` (default: the config's committee size)."""
        width = width if width is not None else self.config.committee_size
        hashes = [bls.hash_to_g1(h) if h is not None else None
                  for h in headers]
        hx, hy, hok = bn.g1_to_limbs(hashes)
        sigx, sigy, sig_mask = bn.g1_committee_to_limbs(sig_rows, width)
        pkx, pky, pk_mask = bn.g2_committee_to_limbs(pk_rows, width)
        on = lambda a: torch.as_tensor(a, device=self.device)
        return CommitteePeriodInputs(
            hx=on(hx), hy=on(hy), sigx=on(sigx), sigy=on(sigy),
            sig_mask=on(sig_mask), pkx=on(pkx), pky=on(pky),
            pk_mask=on(pk_mask), has_header=on(hok))
