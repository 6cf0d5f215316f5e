"""Periodic SMC state mirror: the actor-side analog of chain sync (the
port's copy of the JAX package's `mainchain/mirror.py`; the snapshot's
JSON encoding and its key in the shard DB are the reference's, so either
package reads the other's persisted snapshot).

The reference's downloader/fetcher stack (`eth/downloader`,
`eth/fetcher`) keeps a full node's local chain state current;
SURVEY.md §2.2 maps that role here to "a periodic SMC state mirror" —
actors don't import blocks, they track the one authoritative contract.
`StateMirror` maintains a per-head snapshot of the SMC surface an actor
reads in its hot loop (period, committee-sampling context, per-shard
submission/approval watermarks and current-period records) and persists
it in the shard DB, so:

- reads between heads hit the local snapshot instead of another RPC
  round trip (a remote actor's per-head chatter drops to ONE
  `mirror_snapshot`-shaped pull), and
- a restarted actor warm-starts from the last persisted snapshot
  before its first head arrives (checkpoint/resume §5.4: the SMC is
  the authoritative state; the mirror is the local cache of it).
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Dict, NamedTuple, Optional

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

_DB_KEY = b"smc-mirror:latest"


class MirrorRecord(NamedTuple):
    """Decoded snapshot record — the read surface of an SMC collation
    record (chain.py CollationRecord duck-type) the notary hot loop
    consumes."""

    chunk_root: Hash32
    proposer: Address20
    vote_count: int
    is_elected: bool
    signature: bytes


def decode_record(rec: dict) -> MirrorRecord:
    return MirrorRecord(
        chunk_root=Hash32(bytes.fromhex(rec["chunk_root"])),
        proposer=Address20(bytes.fromhex(rec["proposer"])),
        vote_count=rec["vote_count"],
        is_elected=bool(rec["is_elected"]),
        signature=bytes.fromhex(rec.get("signature", "")),
    )


def decode_committee_context(ctx: Optional[dict]) -> Optional[dict]:
    """Inverse of `_ctx_jsonable` for the fields the sampling loop reads
    (blockhash + pool back to raw bytes)."""
    if ctx is None:
        return None
    out = dict(ctx)
    blockhash = out.get("blockhash")
    if isinstance(blockhash, str):
        out["blockhash"] = bytes.fromhex(blockhash)
    pool = out.get("pool")
    if pool is not None:
        out["pool"] = [bytes.fromhex(p) if isinstance(p, str) else p
                       for p in pool]
    return out


class StateMirror(Service):
    """Tracks SMC state per head; serves stale-bounded local reads."""

    name = "state-mirror"
    supervisable = True

    def __init__(self, client: SMCClient, shard_db=None):
        super().__init__()
        self.client = client
        self.db = shard_db
        self._lock = threading.Lock()
        self._snapshot: Optional[dict] = None
        self._gen = 0              # bumps with every stored snapshot
        self._persist_lock = threading.Lock()
        self._persisted_gen = 0
        self.refreshes = 0
        self._unsubscribe = None
        if self.db is not None:
            self._load_persisted()

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._unsubscribe = self.client.subscribe_new_head(self._on_head)
        try:
            self.refresh()  # don't wait for the first head
        except Exception as exc:
            self.record_error(f"initial mirror refresh failed: {exc}")

    def on_stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()

    def _on_head(self, block) -> None:
        try:
            self.refresh()
            self.record_success()
        except Exception as exc:
            self.record_failure(f"mirror refresh failed: {exc}")

    # -- the sync step -----------------------------------------------------

    def refresh(self) -> dict:
        """Pull one consistent snapshot of the hot-loop SMC surface —
        ONE bulk round trip when the backend serves `mirror_snapshot`
        (the RPC server does), the per-shard walk otherwise."""
        snapshot = self.client.mirror_snapshot()
        with self._lock:
            held = self._snapshot
            if held is not None:
                held_gen = held.get("reorg_gen", 0)
                new_gen = snapshot.get("reorg_gen", 0)
                # ordering is (reorg generation, block number): a stale
                # refresh from BEFORE a rollback must never overwrite the
                # post-reorg truth regardless of its higher block number,
                # and within one generation the head never regresses
                # (the head-callback vs on_start refresh race)
                if new_gen < held_gen or (
                        new_gen == held_gen
                        and (held["block_number"] or 0)
                        > (snapshot["block_number"] or 0)):
                    return held
            self._snapshot = snapshot
            self._gen += 1
            gen = self._gen
        self.refreshes += 1
        if self.db is not None:
            # persist OUTSIDE the read lock (disk I/O must not block
            # hot-loop snapshot() readers), but generation-checked so a
            # slower refresh that lost the in-memory race can never
            # overwrite a newer snapshot on disk
            payload = _encode(snapshot)
            try:
                with self._persist_lock:
                    if gen > self._persisted_gen:
                        self.db.put(_DB_KEY, payload)
                        self._persisted_gen = gen
            except Exception as exc:
                self.record_error(f"mirror persist failed: {exc}")
        return snapshot

    # -- reads -------------------------------------------------------------

    def snapshot(self) -> Optional[dict]:
        with self._lock:
            return self._snapshot

    def period(self) -> Optional[int]:
        snap = self.snapshot()
        return None if snap is None else snap["period"]

    def record(self, shard_id: int) -> Optional[dict]:
        """The current-period record mirror for a shard (None if absent)."""
        snap = self.snapshot()
        if snap is None:
            return None
        return snap["records"].get(shard_id)

    def record_view(self, shard_id: int) -> Optional[MirrorRecord]:
        """`record` decoded to the CollationRecord read surface."""
        rec = self.record(shard_id)
        return None if rec is None else decode_record(rec)

    @property
    def resumed_from_disk(self) -> bool:
        """True when the snapshot predates this process (warm start)."""
        return self._resumed

    # -- persistence -------------------------------------------------------

    _resumed = False

    def _load_persisted(self) -> None:
        try:
            raw = self.db.get(_DB_KEY)
        except Exception:
            return
        if not raw:
            return
        try:
            snapshot = _decode(raw)
        except (ValueError, KeyError):
            return  # a corrupt mirror is just a cold start
        with self._lock:
            self._snapshot = snapshot
        self._resumed = True


def assemble_snapshot(source) -> dict:
    """Build the mirror snapshot from anything with the client read
    surface (SMCClient, SimulatedMainchain, the RPC server's backend) —
    the ONE definition shared by the in-process walk and the bulk
    `shard_mirrorSnapshot` RPC method."""
    period = source.current_period()
    shard_count = source.shard_count()
    block_number = source.block_number
    if callable(block_number):  # pragma: no cover - surface variance
        block_number = block_number()
    submitted: Dict[int, int] = {}
    records: Dict[int, dict] = {}
    approved: Dict[int, int] = {}
    for shard_id in range(shard_count):
        last_sub = source.last_submitted_collation(shard_id)
        submitted[shard_id] = last_sub
        approved[shard_id] = source.last_approved_collation(shard_id)
        if last_sub == period:
            record = source.collation_record(shard_id, period)
            if record is not None:
                records[shard_id] = _rec_jsonable(record)
    # windback context: the last windback_depth CLOSED periods' records
    # (immutable once their period ends — votes only land in the current
    # period), so a remote notary's windback availability checks read
    # them from the snapshot instead of O(depth) collationRecord round
    # trips per vote (the r3 gap: actors/notary.py _check_windback).
    # Immutability also makes each closed period's walk cacheable: the
    # per-source memo avoids re-reading depth×shards records every head
    # (reorg_gen-keyed — a rollback can rewrite "closed" periods).
    depth = getattr(getattr(source, "config", None), "windback_depth", 0)
    reorg_gen = getattr(source, "reorg_generation", 0)
    prior: Dict[int, Dict[int, dict]] = {}
    # the cache is shared across the RPC server's handler threads and the
    # local mirror: all reads/writes/evictions happen under the lock (an
    # unlocked eviction racing an insert raises 'dict changed size during
    # iteration') — but the record WALK itself runs outside it, so a
    # slow source (remote client fallback) never serializes every other
    # snapshot assembly in the process behind one cold cache fill
    with _PRIOR_LOCK:
        cache = _PRIOR_CACHE.setdefault(source, {})
        have = {pp: cache.get((reorg_gen, pp))
                for pp in range(max(1, period - (depth or 0)), period)}
    for pp, cached in have.items():
        if cached is None:
            shard_recs: Dict[int, dict] = {}
            for shard_id in range(shard_count):
                record = source.collation_record(shard_id, pp)
                if record is not None:
                    shard_recs[shard_id] = _rec_jsonable(record)
            cached = shard_recs  # racing fills compute identical data
        prior[pp] = cached
    with _PRIOR_LOCK:
        for pp, recs in prior.items():
            cache[(reorg_gen, pp)] = recs
        for key in [k for k in cache
                    if k[0] != reorg_gen or k[1] < period - (depth or 0) - 2]:
            del cache[key]
    return {
        "block_number": block_number,
        "period": period,
        "shard_count": shard_count,
        # bumps on every chain rollback (smc/chain.py set_head): lets the
        # regression guard tell a reorg from a racing stale refresh
        "reorg_gen": getattr(source, "reorg_generation", 0),
        "committee_context": _ctx_jsonable(source.committee_context()),
        "last_submitted": submitted,
        "last_approved": approved,
        "records": records,
        "prior_records": prior,
    }


# per-source memo of closed-period record walks (see assemble_snapshot);
# weak keys so a dropped backend releases its cache
_PRIOR_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PRIOR_LOCK = threading.Lock()


def _rec_jsonable(record) -> dict:
    return {
        "chunk_root": bytes(record.chunk_root).hex(),
        "proposer": bytes(record.proposer).hex(),
        "vote_count": record.vote_count,
        "is_elected": bool(record.is_elected),
        "signature": bytes(record.signature or b"").hex(),
    }


def assemble_audit_data(source, period: int, jsonable: bool = True) -> dict:
    """Bulk audit pull: for every shard with a collation record in
    `period`, the record's vote signatures and the voters' registered BLS
    pubkeys (resolved by vote-time attribution; None for a released
    voter): one round trip for a remote notary's period audit instead of
    O(shards) record reads and O(votes) registry lookups. Shared by
    `SMCClient`'s local walk and the `shard_auditData` RPC method.

    `jsonable=False` (the in-process path) skips the hex wire codec: the
    points ride as raw tuples, the chunk root as raw bytes, and the result
    carries `raw: True`."""
    from gethsharding_tpu_torch.rpc import codec

    shards: Dict[int, dict] = {}
    for shard_id in range(source.shard_count()):
        record = source.collation_record(shard_id, period)
        if record is None or not record.vote_sigs:
            continue
        votes = []
        for index, vote in record.vote_sigs.items():
            entry = source.notary_registry(vote.signer)
            pubkey = None if entry is None else entry.bls_pubkey
            if jsonable:
                votes.append({
                    "index": index,
                    "signer": bytes(vote.signer).hex(),
                    "sig": codec.enc_g1(vote.sig),
                    "pubkey": codec.enc_g2(pubkey),
                })
            else:
                votes.append({"index": index, "signer": vote.signer,
                              "sig": vote.sig, "pubkey": pubkey})
        shards[shard_id] = {
            "chunk_root": (bytes(record.chunk_root).hex() if jsonable
                           else bytes(record.chunk_root)),
            "vote_count": record.vote_count,
            "is_elected": bool(record.is_elected),
            "votes": votes,
        }
    out = {"period": period, "shards": shards}
    if not jsonable:
        out["raw"] = True
    return out


def _ctx_jsonable(ctx: Optional[dict]) -> Optional[dict]:
    if ctx is None:
        return None
    out = {}
    for key, val in ctx.items():
        if isinstance(val, (bytes, Hash32)):
            out[key] = bytes(val).hex()
        elif isinstance(val, (list, tuple)):
            out[key] = [bytes(v).hex() if isinstance(v, bytes) else v
                        for v in val]
        else:
            out[key] = val
    return out


def _encode(snapshot: dict) -> bytes:
    return json.dumps(snapshot, sort_keys=True).encode()


def restore_int_keys(snapshot: dict) -> dict:
    """JSON stringifies int dict keys; restore them in place."""
    for field in ("last_submitted", "last_approved", "records"):
        snapshot[field] = {int(k): v for k, v in snapshot[field].items()}
    prior = snapshot.get("prior_records")
    if prior is not None:
        snapshot["prior_records"] = {
            int(p): {int(s): rec for s, rec in shards.items()}
            for p, shards in prior.items()}
    return snapshot


def _decode(raw: bytes) -> dict:
    return restore_int_keys(json.loads(raw))
