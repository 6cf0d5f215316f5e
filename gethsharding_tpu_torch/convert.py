"""Carry the JAX package's state across to the port.

`to_port` turns the reference's numpy limb planes (any integer dtype,
22-limb exact or 25-limb wide form) into port tensors: int32, 25 limbs,
on the port's device. `line_tables_from_reference` carries the state of
the precomp path across: a resident line table and its infinity flags.
`srs_from_reference` carries the DAS multiproofs' structured reference
string across: the same powers of τ as the port's `pcs.SRS`.
`replay_inputs_from_reference`, `vote_state_from_reference`,
`vote_attempts_from_reference` and `stress_inputs_from_reference` carry
the replay, vote-batch and stress planes across (the reference's
NamedTuples of arrays, read as numpy), limb planes in the port's limb
form. `smc_fields` reads a scalar SMC's state (either package's: it
only reads attributes) into plain Python values, and `smc_from_fields`
builds the port's `SMC` from them, so both machines can start from one
mid-life state. The node's state carries across as plain values too:
`kv_items` / `kv_from_items` (the shard DB byte for byte),
`mirror_snapshot_fields` / `mirror_snapshot_from_fields` (the state
mirror's snapshot in its persisted JSON), `journal_records` /
`journal_from_records` (the vote journal), `txpool_pending` /
`txpool_from_pending` (a txpool's transactions) and
`das_commitment_fields` / `das_commitment_from_fields` (a DAS
commitment, so digests and signatures compare across packages).
`reference_tables` reads the reference's constant tables and kernel
programs from its modules, which the caller passes in
(nothing of the JAX package is imported here), so they can be held byte
for byte against the port's own re-derived tables (`port_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.das import pcs
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.ops.limb import NLIMBS

# constant tables of the megakernel module, by name in both packages
KERNEL_TABLES = ("_FOLD_J", "_LIFT_RELAXED", "_MUL_PAD", "_FP2_PAD",
                 "_NEG_PAD", "_GAMMA", "_LINE_PAD", "_ONE12")
# tables of the bn256 module, by name in both packages
BN_TABLES = ("_OPT_OPS", "_GEN_LINES", "_TWF_X", "_TWF_Y", "_TWF2_X",
             "_TWF2_Y", "_HARD_PROGRAM", "_U_NAF", "_B3_G2_LIMBS")


def to_port(plane, device=None) -> torch.Tensor:
    """A limb plane (..., 22 | 25) -> int32 (..., 25) tensor; the exact
    22-limb form widens losslessly with zero limbs."""
    arr = np.asarray(plane)
    if arr.shape[-1] not in (22, mk.KNL):
        raise ValueError(f"not a limb plane: last axis {arr.shape[-1]}")
    if arr.shape[-1] < mk.KNL:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (mk.KNL - arr.shape[-1],),
                           arr.dtype)], axis=-1)
    return torch.as_tensor(arr.astype(np.int32),
                           device=resolve_device(device))


def limbs_to_port_form(plane, device=None) -> torch.Tensor:
    """A 12-bit limb plane (..., 22 | 25) -> int32 (..., NLIMBS) at the
    port's limb form: zero limbs added, or dropped where they are zero
    (a canonical value below 2^264 fits either form)."""
    arr = np.asarray(plane)
    width = arr.shape[-1]
    if width not in (22, mk.KNL):
        raise ValueError(f"not a limb plane: last axis {width}")
    if width > NLIMBS:
        if arr[..., NLIMBS:].any():
            raise ValueError(f"limbs beyond the port's {NLIMBS} are not zero")
        arr = arr[..., :NLIMBS]
    elif width < NLIMBS:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (NLIMBS - width,), arr.dtype)],
            axis=-1)
    return torch.as_tensor(arr.astype(np.int32),
                           device=resolve_device(device))


def _planes(ref, names, limbs, dtypes, device):
    """The named fields of a reference NamedTuple as port tensors: limb
    planes in the port's form, the rest in their dtype."""
    dev = resolve_device(device)
    out = {}
    for name in names:
        arr = np.asarray(getattr(ref, name))
        if name in limbs:
            out[name] = limbs_to_port_form(arr, dev)
        else:
            out[name] = torch.as_tensor(arr.astype(dtypes[arr.dtype.kind]),
                                        device=dev)
    return out


# the dtype of a plane by its numpy kind: bool, uint8 bytes, int32
_KINDS = {"b": np.bool_, "u": np.uint8, "i": np.int32}
_REPLAY_LIMBS = ("tx_e", "tx_r", "tx_s")
_BLS_LIMBS = ("hx", "hy", "sigx", "sigy", "pkx", "pky")


def replay_inputs_from_reference(inp, device=None):
    """A reference `replay_jax.ReplayInputs` -> the port's
    `ops/replay.py::ReplayInputs` on `device`."""
    from gethsharding_tpu_torch.ops import replay

    return replay.ReplayInputs(**_planes(
        inp, replay.ReplayInputs._fields, _REPLAY_LIMBS, _KINDS, device))


def vote_state_from_reference(state, device=None):
    """A reference `smc_jax.VoteState` -> the port's
    `ops/smc.py::VoteState`."""
    from gethsharding_tpu_torch.ops import smc

    return smc.VoteState(**_planes(state, smc.VoteState._fields, (), _KINDS,
                                   device))


def vote_attempts_from_reference(att, device=None):
    """A reference `smc_jax.VoteAttempts` -> the port's
    `ops/smc.py::VoteAttempts`."""
    from gethsharding_tpu_torch.ops import smc

    return smc.VoteAttempts(**_planes(att, smc.VoteAttempts._fields, (),
                                      _KINDS, device))


def stress_inputs_from_reference(inp, device=None):
    """A reference `parallel/stress.py::StressInputs` -> the port's
    `parallel/stress.py::StressInputs`."""
    from gethsharding_tpu_torch.parallel import stress

    return stress.StressInputs(**_planes(
        inp, stress.StressInputs._fields, _REPLAY_LIMBS + _BLS_LIMBS,
        _KINDS, device))


def line_tables_from_reference(tab, inf, device=None):
    """A reference line table (..., 88, 3, 2, 22 | 25) and its infinity
    flags (...,) -> the port's (int32 (..., 88, 3, 2, 25), bool (...))
    tensors, ready for `LineTableCache.insert` or the precomp audit."""
    tab = np.asarray(tab)
    if tab.shape[-4:-1] != bn.LINE_TABLE_SHAPE[:3]:
        raise ValueError(f"not a line table: shape {tab.shape}")
    inf = np.asarray(inf, dtype=bool)
    if inf.shape != tab.shape[:-4]:
        raise ValueError(f"infinity flags {inf.shape} do not match the "
                         f"tables {tab.shape[:-4]}")
    return (to_port(tab, device),
            torch.as_tensor(inf, device=resolve_device(device)))


def srs_from_reference(srs) -> pcs.SRS:
    """A reference `das/pcs.py` SRS (G1 powers as (x, y) int pairs, G2
    powers as pairs of the reference's `Fp2`, None for infinity) -> the
    port's `pcs.SRS` with the same seed, τ and powers."""
    fp2 = lambda v: bls.Fp2(int(v.a), int(v.b))
    g1 = lambda pt: None if pt is None else (int(pt[0]), int(pt[1]))
    g2 = lambda pt: None if pt is None else (fp2(pt[0]), fp2(pt[1]))
    return pcs.SRS(seed=str(srs.seed), tau=int(srs.tau),
                   g1_powers=tuple(map(g1, srs.g1_powers)),
                   g2_powers=tuple(map(g2, srs.g2_powers)))


def reference_tables(pallas_finalexp, bn256_jax) -> dict:
    """The reference's tables and programs as numpy arrays, from its
    `ops/pallas_finalexp.py` and `ops/bn256_jax.py` modules."""
    out = {name: np.asarray(getattr(pallas_finalexp, name))
           for name in KERNEL_TABLES}
    out.update({name: np.asarray(getattr(bn256_jax, name))
                for name in BN_TABLES})
    out["program"] = np.asarray(pallas_finalexp._build_program())
    for name, arr in zip(("miller_ops", "miller_lines", "miller_twf"),
                         pallas_finalexp._miller_tables()):
        out[name] = np.asarray(arr)
    return out


def port_tables() -> dict:
    """The port's own tables, under the same names as `reference_tables`."""
    out = {name: getattr(mk, name) for name in KERNEL_TABLES}
    out.update({name: getattr(bn, name) for name in BN_TABLES})
    out["program"] = mk._PROGRAM
    out["miller_ops"] = mk._MILLER_OPS
    out["miller_lines"] = mk._MILLER_LINES
    out["miller_twf"] = mk._MILLER_TWF
    return out


def mismatched_tables(reference: dict, port: dict) -> list:
    """Names whose dtype, shape or bytes differ between the two sides."""
    return sorted(name for name in reference
                  if name not in port
                  or reference[name].dtype != port[name].dtype
                  or reference[name].shape != port[name].shape
                  or reference[name].tobytes() != port[name].tobytes())


# -- the scalar SMC's state ---------------------------------------------------

# event arguments that carry an address or a root (the rest are ints)
_EVENT_ADDRESSES = ("notary", "proposerAddress", "notaryAddress")
_EVENT_ROOTS = ("chunkRoot",)


def _g1_ints(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def _g2_ints(pt):
    return None if pt is None else (int(pt[0].a), int(pt[0].b),
                                    int(pt[1].a), int(pt[1].b))


def smc_fields(smc) -> dict:
    """A scalar SMC's state as plain values: addresses and roots as bytes,
    G1 points as (x, y) and G2 points as (x.a, x.b, y.a, y.b) int tuples
    (None at infinity), vote words as ints, events as (name, args)."""
    plain = lambda v: bytes(v) if isinstance(v, bytes) else v
    return {
        "pool": [None if a is None else bytes(a) for a in smc.notary_pool],
        "pool_length": smc.notary_pool_length,
        "registry": {
            bytes(addr): {
                "deregistered_period": e.deregistered_period,
                "pool_index": e.pool_index, "balance": e.balance,
                "deposited": e.deposited,
                "bls_pubkey": _g2_ints(e.bls_pubkey),
                "bls_pop": _g1_ints(e.bls_pop)}
            for addr, e in smc.notary_registry.items()},
        "current_vote": dict(smc.current_vote),
        "records": {
            key: {"chunk_root": bytes(r.chunk_root),
                  "proposer": bytes(r.proposer),
                  "is_elected": r.is_elected,
                  "signature": bytes(r.signature),
                  "vote_sigs": {i: {"sig": _g1_ints(v.sig),
                                    "signer": bytes(v.signer)}
                                for i, v in r.vote_sigs.items()},
                  "vote_count": r.vote_count}
            for key, r in smc.collation_records.items()},
        "last_submitted": dict(smc.last_submitted_collation),
        "last_approved": dict(smc.last_approved_collation),
        "empty_slots_stack": list(smc.empty_slots_stack),
        "empty_slots_stack_top": smc.empty_slots_stack_top,
        "current_sample_size": smc.current_period_notary_sample_size,
        "next_sample_size": smc.next_period_notary_sample_size,
        "sample_size_last_updated": smc.sample_size_last_updated_period,
        "shard_count": smc.shard_count,
        "balance": smc.balance,
        "events": [(e.name, {k: plain(v) for k, v in e.args.items()})
                   for e in smc.events],
    }


def smc_from_fields(fields: dict, config=None, blockhash_fn=None):
    """The port's `SMC` in the state `fields` describes (the form of
    `smc_fields`; the empty-slot stack may be any int sequence, a numpy
    array included)."""
    from gethsharding_tpu_torch.params import DEFAULT_CONFIG
    from gethsharding_tpu_torch.smc import state_machine as sm
    from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

    g1 = lambda t: None if t is None else (int(t[0]), int(t[1]))
    g2 = lambda t: None if t is None else (bls.Fp2(int(t[0]), int(t[1])),
                                           bls.Fp2(int(t[2]), int(t[3])))

    def event_arg(key, value):
        if key in _EVENT_ADDRESSES:
            return Address20(value)
        if key in _EVENT_ROOTS:
            return Hash32(value)
        return int(value)

    smc = sm.SMC(config or DEFAULT_CONFIG, blockhash_fn=blockhash_fn)
    smc.notary_pool = [None if a is None else Address20(a)
                       for a in fields["pool"]]
    smc.notary_pool_length = int(fields["pool_length"])
    smc.notary_registry = {
        Address20(addr): sm.Notary(
            deregistered_period=int(e["deregistered_period"]),
            pool_index=int(e["pool_index"]), balance=int(e["balance"]),
            deposited=bool(e["deposited"]), bls_pubkey=g2(e["bls_pubkey"]),
            bls_pop=g1(e["bls_pop"]))
        for addr, e in fields["registry"].items()}
    smc.current_vote = {int(s): int(w)
                        for s, w in fields["current_vote"].items()}
    smc.collation_records = {
        (int(s), int(p)): sm.CollationRecord(
            chunk_root=Hash32(r["chunk_root"]),
            proposer=Address20(r["proposer"]),
            is_elected=bool(r["is_elected"]),
            signature=bytes(r["signature"]),
            vote_sigs={int(i): sm.VoteSig(sig=g1(v["sig"]),
                                          signer=Address20(v["signer"]))
                       for i, v in r["vote_sigs"].items()},
            vote_count=int(r["vote_count"]))
        for (s, p), r in fields["records"].items()}
    smc.last_submitted_collation = {
        int(s): int(p) for s, p in fields["last_submitted"].items()}
    smc.last_approved_collation = {
        int(s): int(p) for s, p in fields["last_approved"].items()}
    smc.empty_slots_stack = [int(i) for i in fields["empty_slots_stack"]]
    smc.empty_slots_stack_top = int(fields["empty_slots_stack_top"])
    smc.current_period_notary_sample_size = int(
        fields["current_sample_size"])
    smc.next_period_notary_sample_size = int(fields["next_sample_size"])
    smc.sample_size_last_updated_period = int(
        fields["sample_size_last_updated"])
    smc.shard_count = int(fields["shard_count"])
    smc.balance = int(fields["balance"])
    smc.events = [sm.Event(name, {k: event_arg(k, v)
                                  for k, v in args.items()})
                  for name, args in fields["events"]]
    return smc


# -- the node's state ----------------------------------------------------


def kv_items(kv) -> list:
    """A key-value store's items (either package's `KVStore`: the shard
    DB, whose keys hold the headers, bodies, availability bits, canonical
    index, vote journal and mirror snapshot) as sorted (key, value) bytes
    pairs."""
    return sorted((bytes(k), bytes(v)) for k, v in kv.items())


def kv_from_items(items, kv=None):
    """`items` ((key, value) bytes pairs) written into `kv` (a new port
    `MemoryKV` where None); returns the store."""
    from gethsharding_tpu_torch.db.kv import MemoryKV

    kv = MemoryKV() if kv is None else kv
    for key, value in items:
        kv.put(bytes(key), bytes(value))
    return kv


def mirror_snapshot_fields(snapshot: dict) -> bytes:
    """A state mirror's snapshot (either package's) in its persisted
    encoding: the JSON bytes both packages keep under `smc-mirror:latest`."""
    from gethsharding_tpu_torch.mainchain import mirror

    return mirror._encode(snapshot)


def mirror_snapshot_from_fields(encoded: bytes) -> dict:
    """The snapshot `mirror_snapshot_fields` encoded, decoded as the port's
    `StateMirror` holds it (int shard and period keys)."""
    from gethsharding_tpu_torch.mainchain import mirror

    return mirror._decode(encoded)


def journal_records(journal) -> dict:
    """A vote journal's records (either package's `VoteJournal`): the
    journaled (shard, period) votes and the audit high-water mark."""
    return {"votes": sorted(journal.votes()),
            "audit_high_water": journal.audit_high_water()}


def journal_from_records(records: dict, kv=None):
    """The port's `VoteJournal` over `kv` (a new `MemoryKV` where None)
    holding `records` (the form of `journal_records`)."""
    from gethsharding_tpu_torch.db.kv import MemoryKV
    from gethsharding_tpu_torch.resilience.journal import VoteJournal

    journal = VoteJournal(MemoryKV() if kv is None else kv)
    for shard_id, period in records["votes"]:
        journal.record_vote(int(shard_id), int(period))
    if records["audit_high_water"] is not None:
        journal.set_audit_high_water(int(records["audit_high_water"]))
    return journal


def txpool_pending(txpool) -> list:
    """Every transaction a txpool holds (either package's `TXPool`,
    executable or parked behind a nonce gap), RLP-encoded, by sender and
    nonce."""
    return [bytes(slot[nonce].encode_rlp())
            for sender, slot in sorted(txpool._by_sender.items(),
                                       key=lambda kv: bytes(kv[0]))
            for nonce in sorted(slot)]


def txpool_from_pending(encoded, **kwargs):
    """The port's `TXPool(**kwargs)` holding the RLP-encoded transactions
    `encoded` (the form of `txpool_pending`), admitted in order."""
    from gethsharding_tpu_torch.actors.txpool import TXPool
    from gethsharding_tpu_torch.core.types import Transaction

    pool = TXPool(**{"simulate_interval": None, **kwargs})
    for blob in encoded:
        pool.submit(Transaction.decode_rlp(bytes(blob)))
    return pool


DAS_COMMITMENT_FIELDS = ("shard_id", "period", "chunk_root", "das_root", "k",
                         "n", "body_len", "poly_commitment", "signature")


def das_commitment_fields(commitment) -> dict:
    """A DAS commitment (either package's `DASCommitment`) as plain bytes
    and ints, by field name."""
    fields = {name: getattr(commitment, name)
              for name in DAS_COMMITMENT_FIELDS}
    return {name: bytes(value) if isinstance(value, bytes) else int(value)
            for name, value in fields.items()}


def das_commitment_from_fields(fields: dict):
    """The port's `DASCommitment` from `das_commitment_fields`' form."""
    from gethsharding_tpu_torch.das.service import DASCommitment

    return DASCommitment(**{name: fields[name]
                            for name in DAS_COMMITMENT_FIELDS})
