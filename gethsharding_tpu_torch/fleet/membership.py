"""Runtime fleet membership: the replica registry as a control plane (the
port's copy of the JAX package's `fleet/membership.py`).

A ``--replica`` list parsed once would freeze the fleet's topology at
boot. This module makes the registry a first-class, MUTABLE object an
operator (or the autoscaler, fleet/autoscaler.py) drives at runtime:

- **admission preserves the routing invariants** — a new replica enters
  the router DRAINING and earns HEALTHY through the existing half-open
  differential sweep (no healthy-by-assertion); a removal drains first
  and detaches only once nothing is in flight, so no live request ever
  sees its endpoint vanish. Rendezvous affinity makes both cheap: only
  the keys whose top-choice replica changed move.
- **every topology is an epoch** — a monotonic counter bumped on each
  local mutation. Replicated frontends gossip ``(epoch, endpoints)``
  and converge last-writer-wins: a peer adopts a strictly newer epoch
  verbatim and ignores everything else, so two frontends that diverged
  during a partition agree again the moment they can talk.
- **the acked topology survives restarts** — `MembershipJournal`
  persists ``(epoch, endpoints)`` through the same `db/kv` seam the
  vote journal uses (resilience/journal.py's shape: SQLite under a
  ``--datadir``-style path, MemoryKV in tests); a restarted frontend
  reconverges to the last journaled topology instead of its stale
  command line.

Typed errors (`DuplicateReplicaError` / `UnknownReplicaError`) keep
operator mistakes distinguishable from fleet weather on the wire — the
frontend ships their class names under its membership error code.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Dict, List, Optional

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.db.kv import KVStore
from gethsharding_tpu_torch.fleet.router import FleetRouter, Replica

log = logging.getLogger("fleet.membership")

_EPOCH_KEY = b"fm/epoch"
_TOPOLOGY_KEY = b"fm/topology"


class DuplicateReplicaError(ValueError):
    """The endpoint is already a member — admitting it twice would
    split one replica's flight accounting across two registry rows."""


class UnknownReplicaError(KeyError):
    """No member has this endpoint (or name): nothing to remove."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep it flat
        return self.args[0] if self.args else ""


class MembershipJournal:
    """Persisted ``(epoch, endpoints)`` over the `db/kv` seam.

    One record, overwritten per acknowledged topology change (unlike
    the vote journal's per-vote keys, membership IS the latest state —
    history lives in the flight recorder). Writes ride the KV engine's
    own durability (WAL for SQLite)."""

    def __init__(self, kv: KVStore,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.kv = kv
        self._m_recorded = registry.counter(
            "fleet/membership/journal_records")

    def record(self, epoch: int, endpoints: List[str]) -> None:
        self.kv.put(_EPOCH_KEY, int(epoch).to_bytes(8, "big"))
        self.kv.put(_TOPOLOGY_KEY,
                    json.dumps(sorted(endpoints)).encode())
        self._m_recorded.inc()

    def load(self) -> Optional[Dict]:
        """The last acked topology, or None for a fresh journal."""
        raw_epoch = self.kv.get(_EPOCH_KEY)
        raw_topology = self.kv.get(_TOPOLOGY_KEY)
        if raw_epoch is None or raw_topology is None:
            return None
        try:
            endpoints = json.loads(raw_topology.decode())
        except (ValueError, UnicodeDecodeError):
            log.warning("membership journal topology corrupt; ignoring")
            return None
        if not isinstance(endpoints, list):
            return None
        return {"epoch": int.from_bytes(raw_epoch, "big"),
                "endpoints": [str(e) for e in endpoints]}

    def clear(self) -> None:
        self.kv.delete(_EPOCH_KEY)
        self.kv.delete(_TOPOLOGY_KEY)


class FleetMembership:
    """The mutable replica registry over a `FleetRouter`.

    `make_replica` builds a routed `Replica` from an ``HOST:PORT``
    endpoint string (the frontend passes an `RpcReplicaBackend.dial`
    factory; tests pass in-proc fakes). `seed` names the replicas the
    router was BOOTED with (name -> endpoint), so gossip/reconfigure
    can diff against them.

    All mutations serialize under one lock; the router's own members
    lock orders strictly after it (membership -> router, never back).
    """

    def __init__(self, router: FleetRouter,
                 make_replica: Callable[[str], Replica],
                 journal: Optional[MembershipJournal] = None,
                 seed: Optional[Dict[str, str]] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.router = router
        self.make_replica = make_replica
        self.journal = journal
        self._lock = threading.Lock()
        # name -> endpoint for every CURRENT member (including the
        # boot-time seed, whose names predate endpoint-naming)
        self._endpoints: Dict[str, str] = dict(seed or {})
        self.epoch = 0
        self._g_epoch = registry.gauge("fleet/membership/epoch")
        self._g_size = registry.gauge("fleet/membership/size")
        self._m_adds = registry.counter("fleet/membership/adds")
        self._m_removes = registry.counter("fleet/membership/removes")
        self._m_adoptions = registry.counter("fleet/membership/adoptions")
        self._g_size.set(len(self._endpoints))

    # -- restore -----------------------------------------------------------

    def restore(self) -> bool:
        """Reconverge to the journal's last acked topology (boot path).
        Returns True when the journal overrode the seed — the restarted
        frontend resumes where the CONTROL PLANE left it, not where the
        command line started it."""
        if self.journal is None:
            return False
        acked = self.journal.load()
        if acked is None:
            with self._lock:
                # first boot with a journal: ack the seed as epoch 0
                self.journal.record(self.epoch, self._endpoints_locked())
            return False
        with self._lock:
            self.epoch = max(self.epoch, acked["epoch"])
            self._g_epoch.set(self.epoch)
            changed = self._reconcile_locked(acked["endpoints"])
        if changed:
            log.warning("membership restored from journal: epoch %d, "
                        "%d endpoint(s)", acked["epoch"],
                        len(acked["endpoints"]))
        return changed

    # -- reads -------------------------------------------------------------

    def _endpoints_locked(self) -> List[str]:
        return sorted(self._endpoints.values())

    def endpoints(self) -> List[str]:
        with self._lock:
            return self._endpoints_locked()

    def snapshot(self) -> dict:
        """The gossip payload: the epoch and its endpoint set (plus the
        per-replica states for operators — peers key on the first two
        only)."""
        with self._lock:
            return {"epoch": self.epoch,
                    "endpoints": self._endpoints_locked(),
                    "replicas": self.router.states()}

    # -- mutations (operator / autoscaler) ---------------------------------

    def add(self, endpoint: str) -> dict:
        """Admit `endpoint` as a new replica (DRAINING until the health
        sweep promotes it). Bumps the epoch and journals the topology."""
        endpoint = str(endpoint)
        with self._lock:
            if endpoint in self._endpoints.values():
                raise DuplicateReplicaError(
                    f"endpoint {endpoint} is already a member")
            replica = self.make_replica(endpoint)
            self.router.add_replica(replica)
            self._endpoints[replica.name] = endpoint
            self._m_adds.inc()
            self._bump_locked()
            return {"epoch": self.epoch, "name": replica.name,
                    "state": replica.state}

    def remove(self, endpoint: str) -> dict:
        """Remove the member at `endpoint` (drain first; the router's
        sweep detaches once its in-flight work finishes). Accepts a
        replica NAME too, for the boot-time seed whose names predate
        endpoint-naming."""
        endpoint = str(endpoint)
        with self._lock:
            name = self._find_locked(endpoint)
            if name is None:
                raise UnknownReplicaError(
                    f"endpoint {endpoint} is not a member")
            state = self.router.remove_replica(name)
            del self._endpoints[name]
            self._m_removes.inc()
            self._bump_locked()
            state["epoch"] = self.epoch
            return state

    def reconfigure(self, endpoints: List[str]) -> dict:
        """Set the FULL topology in one mutation (operator bulk edit):
        diffs against the current membership, admits what's missing,
        drains what's gone, bumps the epoch once."""
        with self._lock:
            self._reconcile_locked([str(e) for e in endpoints])
            self._bump_locked()
            return {"epoch": self.epoch,
                    "endpoints": self._endpoints_locked()}

    # -- gossip (peer frontends) -------------------------------------------

    def adopt(self, epoch: int, endpoints: List[str]) -> bool:
        """Last-writer-wins convergence: apply a peer's topology iff
        its epoch is STRICTLY newer than ours (ties and stale gossip
        are no-ops — the bump on local mutations keeps epochs moving,
        so two frontends cannot ping-pong). Returns True on adoption."""
        epoch = int(epoch)
        with self._lock:
            if epoch <= self.epoch:
                return False
            self._reconcile_locked([str(e) for e in endpoints])
            self.epoch = epoch
            self._g_epoch.set(self.epoch)
            self._m_adoptions.inc()
            if self.journal is not None:
                self.journal.record(self.epoch, self._endpoints_locked())
        log.info("adopted peer membership epoch %d (%d endpoint(s))",
                 epoch, len(endpoints))
        return True

    # -- internals ---------------------------------------------------------

    def _find_locked(self, endpoint_or_name: str) -> Optional[str]:
        for name, endpoint in self._endpoints.items():
            if endpoint == endpoint_or_name or name == endpoint_or_name:
                return name
        return None

    def _reconcile_locked(self, target: List[str]) -> bool:
        """Diff the live membership against `target` endpoints: admit
        the missing, drain the extra. Returns True when anything
        changed."""
        want = set(target)
        have = set(self._endpoints.values())
        changed = False
        for endpoint in sorted(want - have):
            try:
                replica = self.make_replica(endpoint)
                self.router.add_replica(replica)
            except Exception as exc:  # noqa: BLE001 - one bad endpoint
                # must not abort the whole reconcile (the rest of the
                # adopted topology is still right)
                log.warning("reconcile: admitting %s failed: %r",
                            endpoint, exc)
                continue
            self._endpoints[replica.name] = endpoint
            self._m_adds.inc()
            changed = True
        for endpoint in sorted(have - want):
            name = self._find_locked(endpoint)
            if name is None:
                continue
            try:
                self.router.remove_replica(name)
            except KeyError:
                pass  # already detached underneath us
            del self._endpoints[name]
            self._m_removes.inc()
            changed = True
        self._g_size.set(len(self._endpoints))
        return changed

    def _bump_locked(self) -> None:
        self.epoch += 1
        self._g_epoch.set(self.epoch)
        self._g_size.set(len(self._endpoints))
        if self.journal is not None:
            self.journal.record(self.epoch, self._endpoints_locked())
