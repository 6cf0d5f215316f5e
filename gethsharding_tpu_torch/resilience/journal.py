"""Crash-safe notary vote journal over the `db/kv` seam (the port's copy
of the JAX package's `resilience/journal.py`; same keys and values, so
either package reads the other's journal).

A restarted notary has two ways to misbehave that the chain cannot
always catch for it:

- **double-voting**: the SMC's `has_voted` bitfield is per pool index
  and readable, but a vote submitted just before the crash may still
  be in flight (RPC backend), and re-submitting burns a revert — or
  worse on a chain that slashes double votes;
- **re-auditing**: the period audit watermark (`_last_audited_period`)
  was process memory, so a restart re-audits every period since boot —
  wasted device dispatches and duplicated mismatch reports.

`VoteJournal` persists both through the SAME `KVStore` the shard data
already lives in (`--datadir` makes it a SQLite file, tests use
`MemoryKV`), so a notary that crashes mid-period recovers
exactly-once semantics on `on_start` replay:

- ``vj/v/<shard>/<period>`` — one key per submitted vote;
- ``vj/audit_hwm``          — the audit high-water mark (monotonic).

Writes go through the KV engine's own durability (WAL for SQLite) and
are recorded AFTER the chain accepted the vote — the journal answers
"did I already submit this?", the chain stays authoritative for what
counts.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.db.kv import KVStore

_VOTE_PREFIX = b"vj/v/"
_AUDIT_KEY = b"vj/audit_hwm"


def _vote_key(shard_id: int, period: int) -> bytes:
    return (_VOTE_PREFIX + shard_id.to_bytes(8, "big")
            + period.to_bytes(8, "big"))


class VoteJournal:
    """Persisted (shard, period) vote set + audit high-water mark."""

    def __init__(self, kv: KVStore,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.kv = kv
        self._lock = threading.Lock()
        self._m_recorded = registry.counter(
            "resilience/journal/votes_recorded")
        # gate HITS, not "duplicates blocked": the notary re-checks
        # every candidate on every head, so most hits are routine
        # already-voted short-circuits — the counter is an activity
        # signal, not a crash-recovery alarm
        self._m_gate_hits = registry.counter(
            "resilience/journal/vote_gate_hits")

    # -- votes -------------------------------------------------------------

    def record_vote(self, shard_id: int, period: int) -> None:
        self.kv.put(_vote_key(shard_id, period), b"\x01")
        self._m_recorded.inc()

    def has_vote(self, shard_id: int, period: int) -> bool:
        hit = self.kv.get(_vote_key(shard_id, period)) is not None
        if hit:
            self._m_gate_hits.inc()
        return hit

    def votes(self) -> Iterator[Tuple[int, int]]:
        """All journaled (shard_id, period) votes (recovery replay /
        introspection). A key-only prefix scan: the journal shares its
        KV with the shard data, whose VALUES (chunk blobs) must not be
        materialized just to walk the vote namespace."""
        for key in self.kv.keys(_VOTE_PREFIX):
            if len(key) == len(_VOTE_PREFIX) + 16:
                body = key[len(_VOTE_PREFIX):]
                yield (int.from_bytes(body[:8], "big"),
                       int.from_bytes(body[8:], "big"))

    def prune_votes(self, before_period: int) -> int:
        """Drop vote entries for periods < `before_period` (closed
        periods can never be re-voted; keeps the journal bounded)."""
        dropped = 0
        for shard_id, period in list(self.votes()):
            if period < before_period:
                self.kv.delete(_vote_key(shard_id, period))
                dropped += 1
        return dropped

    # -- the audit high-water mark -----------------------------------------

    def audit_high_water(self) -> Optional[int]:
        """Highest period whose audit completed; None when no audit has
        ever been journaled (a missing key, NOT period 0 — the two must
        not conflate, or a restarted notary re-audits period 0
        forever)."""
        raw = self.kv.get(_AUDIT_KEY)
        return int.from_bytes(raw, "big") if raw is not None else None

    def set_audit_high_water(self, period: int) -> None:
        """Monotonic: catch-up audits judging out of order can only
        raise the mark."""
        with self._lock:
            current = self.audit_high_water()
            if current is None or period > current:
                self.kv.put(_AUDIT_KEY, period.to_bytes(8, "big"))

    # -- chain-reset detection ---------------------------------------------

    def invalidate_if_reset(self, current_period: int) -> bool:
        """Clear the journal when it is AHEAD of the chain. Periods are
        monotonic per chain lifetime — votes land in their own period
        and audits run strictly behind it — so a journaled vote past
        `current_period` (or an audit watermark at/past it) can only
        mean the datadir outlived its chain (a wiped devnet, a dev-mode
        restart against a fresh simulated chain). Replaying it would
        silently mute the notary for every period up to the stale
        watermark; starting fresh merely risks one redundant,
        chain-rejected vote. Returns True when cleared."""
        high_water = self.audit_high_water()
        stale = high_water is not None and high_water >= current_period
        if not stale:
            stale = any(period > current_period
                        for _shard, period in self.votes())
        if not stale:
            return False
        for shard_id, period in list(self.votes()):
            self.kv.delete(_vote_key(shard_id, period))
        self.kv.delete(_AUDIT_KEY)
        return True
