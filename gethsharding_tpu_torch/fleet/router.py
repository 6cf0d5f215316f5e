"""Shard-aware router/balancer in front of N chain_server replicas (the
port's copy of the JAX package's `fleet/router.py`).

Millions of users means many frontends sharing few devices: a frontend
does not own a replica, it ROUTES to one. This module is that routing
layer, kept deliberately lightweight — policy over existing pieces, no
new protocol:

- **shard affinity** — rendezvous (highest-random-weight) hashing maps
  an affinity key (a shard id, a pk-row key, a DAS root) to a stable
  replica preference order, so a shard's committee planes keep landing
  on the replica whose device-resident pk-plane LRU already holds them.
  Affinity survives replica set changes with minimal reshuffling: when
  a replica drains, only ITS shards move; when it re-enters, exactly
  those shards rebalance back. Keyless traffic (plain ecrecover) routes
  least-in-flight.
- **retry-on-next-replica** — one `resilience.policy.RetryExecutor`
  (seam ``fleet.route``) drives the failover ladder: a transient
  replica failure (connection loss, a watchdog `DeadlineExceeded`, a
  `SoundnessViolation`, an admission shed) advances to the next replica
  in the preference order; deterministic caller errors propagate on the
  first throw. When no replica is accepting, callers get the typed
  `AllReplicasDraining` — a fast, non-retryable overload signal.
- **breaker-aware draining** — each replica exports health (its
  failover breaker's state, plus an explicit drain flag); the router
  marks a tripped or corrupt-flagged replica DRAINING: it takes no new
  work, its in-flight calls finish, and while draining the router sends
  a tiny probe call each health refresh so the replica's own half-open
  differential probe can run — the replica re-enters the rotation only
  after that probe re-promotes the primary (breaker closed). Transport-
  dead replicas (consecutive connection failures) are TRIPPED and
  re-enter after a cooldown plus a successful health read.

Observability (``fleet/`` namespace, surfaced on /status and the
Prometheus exposition): per-replica state gauge (0 healthy, 1 draining,
2 tripped) and routed/failure counters (EWMA rates ride the counter
snapshots), router-level failover / all-draining / rebalance counters,
and the ``resilience/retry/fleet.route/*`` retry counters from the
shared executor.

The router itself launches nothing: each replica's own process runs the
port's kernels on its card. Its knobs keep the JAX package's defaults
under the port's prefix (``GETHSHARDING_TORCH_FLEET_HEDGE_MS``,
``_HEDGE_STORM_PCT``, ``_HEDGE_BULK_MIN_BUDGET``). A hedged request is
not marked for the fleet trace collector, which waits for the port's
`fleettrace/`.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import math
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from gethsharding_tpu_torch import metrics, slo, tracing
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.resilience.breaker import breaker_of
from gethsharding_tpu_torch.serving.classes import (
    ADMISSION_CLASSES,
    CLASS_BULK_AUDIT,
    CLASS_INTERACTIVE,
    admission_class,
    class_for,
)
from gethsharding_tpu_torch.resilience.errors import (
    DeadlineExceeded,
    DispatcherClosed,
    SoundnessViolation,
    TransientError,
)
from gethsharding_tpu_torch.resilience.policy import (RetryExecutor,
                                                      RetryPolicy)
from gethsharding_tpu_torch.serving.queue import ServingOverloadError

log = logging.getLogger("fleet.router")


class ReplicaState:
    HEALTHY = "healthy"
    DRAINING = "draining"
    TRIPPED = "tripped"


_STATE_GAUGE = {ReplicaState.HEALTHY: 0, ReplicaState.DRAINING: 1,
                ReplicaState.TRIPPED: 2}


class AllReplicasDraining(RuntimeError):
    """No replica is accepting work (every one draining or tripped, or
    every accepting one already refused this call). Deliberately NOT a
    transient/retryable class: the fleet is saturated or down, and
    hammering it from the router would be the thundering herd itself.
    Callers queue upstream or surface the overload."""


# failures worth trying the NEXT replica for: transport loss, a hung
# dispatch the watchdog reaped, a shutdown race, detected corruption,
# and admission sheds (an overloaded replica is routing information).
# Everything else — ValueError, a revert, a logic bug — propagates.
ROUTER_RETRYABLE = (ConnectionError, TimeoutError, OSError, TransientError,
                    DeadlineExceeded, DispatcherClosed, SoundnessViolation,
                    ServingOverloadError)

# the subset that speaks to the TRANSPORT being dead (feeds the
# consecutive-failure trip, unlike sheds/soundness which are the
# replica's interior weather)
_TRANSPORT_FAILURES = (ConnectionError, TimeoutError, OSError,
                       DeadlineExceeded, DispatcherClosed)


def default_health(backend) -> Callable[[], dict]:
    """Health from the composition itself (in-process replicas): the
    breaker's state name plus any explicit drain flag the backend
    carries. Cross-process replicas replace this with the
    ``shard_health`` RPC (`RpcReplicaBackend.health`)."""
    def read() -> dict:
        breaker = breaker_of(backend)
        return {
            "breaker": None if breaker is None else breaker.state_name,
            "draining": bool(getattr(backend, "draining", False)),
        }

    return read


def _default_probe(backend) -> Callable[[], None]:
    """A minimal 1-row call: enough for the replica's half-open breaker
    to run its differential probe (any input works — the probe compares
    primary and fallback on the SAME rows, an unrecoverable signature
    included)."""
    def probe() -> None:
        backend.ecrecover_addresses([b"\x00" * 32], [b"\x00" * 65])

    return probe


class Replica:
    """One routed replica: its backend face, health source, and state.

    `backend` is anything with the `SigBackend` batch ops (typically
    ``FailoverSigBackend(ServingSigBackend(...))`` in-process, or an
    `RpcReplicaBackend` dialing a chain_server). `health` overrides the
    in-process default; `probe` overrides the draining-side probe call
    (None disables probing — re-entry then relies on the replica's own
    traffic running the half-open differential)."""

    def __init__(self, name: str, backend,
                 health: Optional[Callable[[], dict]] = None,
                 probe: Optional[Callable[[], None]] = "default",
                 metrics_read: Optional[Callable[[], dict]] = "default",
                 trip_threshold: int = 3,
                 trip_cooldown_s: float = 2.0,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.name = name
        self.backend = backend
        self.health = health or default_health(backend)
        self.probe = _default_probe(backend) if probe == "default" else probe
        # metrics federation source: a callable returning the replica's
        # registry snapshot (`RpcReplicaBackend.metrics` → the
        # `shard_metrics` RPC). The default resolves it off the backend;
        # in-process replicas (which share THIS process's registry)
        # have none and are skipped by the sweep's fold. None disables.
        if metrics_read == "default":
            metrics_read = getattr(backend, "metrics", None)
        self.metrics_read = metrics_read
        self.last_metrics: Optional[dict] = None
        self.trip_threshold = trip_threshold
        self.trip_cooldown_s = trip_cooldown_s
        self.state = ReplicaState.HEALTHY
        self.in_flight = 0
        self.drain_requested = False
        # runtime-membership removal intent: drain first, detach only
        # once nothing is in flight (fleet/membership.py sets it; the
        # health sweep completes the detach)
        self.removing = False
        self.detached = False
        self.drain_events = 0
        self.reentries = 0
        self._consecutive = 0
        self._tripped_until = 0.0
        # bounded ring of recent successful-call latencies: the
        # observed per-replica quantile the hedge delay adapts to
        # (a consistently slow replica earns a longer fuse; the
        # --fleet-hedge-ms floor keeps a cold ring from hair-trigger
        # hedging)
        self._lat_ring: List[float] = []
        self._lat_idx = 0
        self._lock = threading.Lock()
        base = f"fleet/replica/{name}"
        self._g_state = registry.gauge(f"{base}/state")
        self._m_routed = registry.counter(f"{base}/routed")
        self._m_failures = registry.counter(f"{base}/failures")

    # -- flight accounting -------------------------------------------------

    @contextmanager
    def flight(self):
        with self._lock:
            self.in_flight += 1
        self._m_routed.inc()
        try:
            yield
        finally:
            with self._lock:
                self.in_flight -= 1

    LAT_RING = 128

    def note_success(self) -> None:
        with self._lock:
            self._consecutive = 0

    def note_latency(self, seconds: float) -> None:
        with self._lock:
            if len(self._lat_ring) < self.LAT_RING:
                self._lat_ring.append(seconds)
            else:
                self._lat_ring[self._lat_idx % self.LAT_RING] = seconds
            self._lat_idx += 1

    # below this many samples a high quantile IS the max — one slow
    # call would poison the hedge fuse; stay on the configured floor
    LAT_MIN_SAMPLES = 20

    def latency_quantile(self, q: float) -> float:
        """The q-quantile of this replica's recent consumed-verdict
        latencies (0.0 while the ring is cold or too small to trust —
        hedge losers never record, so a delayed replica's tail does
        not stretch its own hedge fuse)."""
        with self._lock:
            snapshot = list(self._lat_ring)
        if len(snapshot) < self.LAT_MIN_SAMPLES:
            return 0.0
        snapshot.sort()
        return snapshot[min(int(q * len(snapshot)), len(snapshot) - 1)]

    def note_failure(self, exc: BaseException) -> None:
        self._m_failures.inc()
        if not isinstance(exc, _TRANSPORT_FAILURES):
            return  # interior weather (shed, soundness): health decides
        with self._lock:
            self._consecutive += 1
            if self._consecutive >= self.trip_threshold \
                    and self.state != ReplicaState.TRIPPED:
                self._set_state_locked(ReplicaState.TRIPPED)
                self._tripped_until = (time.monotonic()
                                       + self.trip_cooldown_s)
                log.warning("replica %s tripped: %d consecutive transport "
                            "failures (last: %r); cooling down %.1fs",
                            self.name, self._consecutive, exc,
                            self.trip_cooldown_s)

    # -- health-driven state machine ---------------------------------------

    def observe_health(self, health: Optional[dict],
                       now: Optional[float] = None) -> None:
        """Apply one health reading. None = the health read itself
        failed (transport dead)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if health is None:
                self._set_state_locked(ReplicaState.TRIPPED)
                self._tripped_until = now + self.trip_cooldown_s
                return
            if self.state == ReplicaState.TRIPPED \
                    and now < self._tripped_until:
                return  # cooling down; a good health read can't shortcut
            breaker = health.get("breaker")
            should_drain = (self.drain_requested
                            or bool(health.get("draining"))
                            or breaker not in (None, "closed"))
            if should_drain:
                if self.state != ReplicaState.DRAINING:
                    self.drain_events += 1
                    log.warning(
                        "replica %s draining (breaker=%s drain_flag=%s): "
                        "no new work; in-flight %d finishing", self.name,
                        breaker, health.get("draining"), self.in_flight)
                self._set_state_locked(ReplicaState.DRAINING)
            else:
                if self.state != ReplicaState.HEALTHY:
                    self.reentries += 1
                    self._consecutive = 0
                    log.warning("replica %s re-entering the rotation "
                                "(breaker=%s)", self.name, breaker)
                self._set_state_locked(ReplicaState.HEALTHY)

    def _set_state_locked(self, state: str) -> None:
        self.state = state
        self._g_state.set(_STATE_GAUGE[state])

    def set_state(self, state: str) -> None:
        """Direct state entry (runtime admission: a freshly added
        replica starts DRAINING and earns HEALTHY through the sweep)."""
        with self._lock:
            self._set_state_locked(state)

    @property
    def accepting(self) -> bool:
        return self.state == ReplicaState.HEALTHY

    @property
    def drained(self) -> bool:
        """True while draining with zero in-flight work left."""
        return self.state == ReplicaState.DRAINING and self.in_flight == 0

    def describe(self) -> dict:
        return {"state": self.state, "in_flight": self.in_flight,
                "routed": self._m_routed.value,
                "failures": self._m_failures.value,
                "drain_events": self.drain_events,
                "removing": self.removing,
                "reentries": self.reentries}


class FleetRouter:
    """The balancer: route, retry-on-next, drain, re-enter."""

    def __init__(self, replicas: List[Replica],
                 health_interval_s: float = 0.25,
                 retry_policy: Optional[RetryPolicy] = None,
                 hedge_ms: Optional[float] = None,
                 hedge_quantile: float = 0.9,
                 hedge_storm_pct: Optional[float] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        # the registry is MUTABLE at runtime (fleet/membership.py):
        # every mutation and every multi-element read goes through
        # _members_lock; hot-path readers iterate a members() snapshot
        # so a concurrent add/remove can never invalidate their walk
        self.replicas = list(replicas)
        self._members_lock = threading.Lock()
        self.health_interval_s = health_interval_s
        self._last_refresh = 0.0
        self._refresh_lock = threading.Lock()
        self._fixed_policy = retry_policy is not None
        policy = retry_policy or RetryPolicy(
            attempts=max(2, len(replicas)), base_s=0.0, jitter=0.0,
            retryable=ROUTER_RETRYABLE)
        self._executor = RetryExecutor("fleet.route", policy,
                                       registry=registry)
        self.registry = registry  # public: the frontend snapshots it
        self._registry = registry
        self._m_failovers = registry.counter("fleet/router/failovers")
        self._m_all_draining = registry.counter("fleet/router/all_draining")
        self._m_calls = registry.counter("fleet/router/calls")
        # -- request hedging (tail robustness) -----------------------------
        # interactive requests that outlive their hedge delay are
        # RE-ISSUED to the next affinity replica, first verdict wins;
        # the delay is the primary replica's observed latency quantile
        # floored by --fleet-hedge-ms / GETHSHARDING_TORCH_FLEET_HEDGE_MS
        # (0 = hedging off). Hedged duplicates ride UNTENANTED so a
        # tenant's quota charges the logical request exactly once.
        if hedge_ms is None:
            hedge_ms = float(os.environ.get(
                "GETHSHARDING_TORCH_FLEET_HEDGE_MS", "0") or 0)
        self.hedge_s = hedge_ms / 1e3
        self.hedge_quantile = hedge_quantile
        if hedge_storm_pct is None:
            hedge_storm_pct = float(os.environ.get(
                "GETHSHARDING_TORCH_FLEET_HEDGE_STORM_PCT", "30") or 30)
        self.hedge_storm_pct = hedge_storm_pct
        # budget-aware BULK hedging: keyed bulk_audit planes may hedge
        # too, but only while the class's SLO budget says the duplicate
        # dispatch is free — GETHSHARDING_TORCH_FLEET_HEDGE_BULK_MIN_BUDGET
        # is the budget_remaining floor (0 = bulk never hedges, the
        # pre-elastic behavior; e.g. 0.75 = hedge bulk only while at
        # least 75% of the slow-window error budget is unburned)
        self.hedge_bulk_min_budget = float(os.environ.get(
            "GETHSHARDING_TORCH_FLEET_HEDGE_BULK_MIN_BUDGET", "0") or 0)
        self._m_hedge_bulk_held = registry.counter(
            "fleet/hedge/bulk_budget_held")
        self._m_hedge_issued = registry.counter("fleet/hedge/issued")
        self._m_hedge_won = registry.counter("fleet/hedge/won")
        self._m_hedge_wasted = registry.counter("fleet/hedge/wasted")
        self._m_hedge_audit_faults = registry.counter(
            "fleet/hedge/audit_faults")
        self._m_hedge_loser_failures = registry.counter(
            "fleet/hedge/loser_failures")
        self._g_hedge_storm = registry.gauge("fleet/hedge/storm")
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._hedge_pool_closed = False
        self._hedge_pool_lock = threading.Lock()
        self._storm_lock = threading.Lock()
        self._storm_prev = (0, 0)  # (dispatches, wasted) at last sweep
        self._storm_latched = False
        # federation aggregates, refreshed each sweep from the scraped
        # replica snapshots: the one-glance fleet answers — how much
        # work is in flight anywhere, how deep each class is queued
        # across replicas, and the worst replica's device-dispatch p99
        self._g_inflight = registry.gauge("fleet/total_inflight")
        self._g_class_depth = {
            c: registry.gauge(f"fleet/class/{c}/queue_depth")
            for c in ADMISSION_CLASSES}
        # the serving queue is a sawtooth (it drains to zero on every
        # take_batch), so an instantaneous scrape aliases against the
        # sweep cadence and a depth-driven controller would see noise.
        # The exported gauge holds a short DECAYING PEAK instead: new
        # value = max(instant sum, previous * exp(-dt/tau))
        self._class_depth_peak = {c: 0.0 for c in ADMISSION_CLASSES}
        self._class_depth_peak_at = time.monotonic()
        self._g_worst_p99 = registry.gauge("fleet/worst_replica_p99_s")
        # health sweeps run on a BACKGROUND thread when an interval is
        # set: a slow or dead replica's health read (a full RPC timeout
        # against a silently-gone host) must stall the sweeper, never a
        # caller's request path. interval <= 0 keeps the sweep inline
        # per call — the deterministic mode tests drive with
        # refresh(force=True).
        self._stop_sweeper = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        if health_interval_s > 0:
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="fleet-health", daemon=True)
            self._sweeper.start()

    # -- health ------------------------------------------------------------

    def _sweep_loop(self) -> None:
        while not self._stop_sweeper.wait(self.health_interval_s):
            try:
                self.refresh(force=True)
            except Exception:  # noqa: BLE001 - the sweeper must survive
                log.exception("fleet health sweep failed")

    def refresh(self, force: bool = False) -> None:
        """Rate-limited health sweep: read every replica's health, run
        the state machine, and probe draining replicas (one tiny call
        each, so their half-open differential can re-promote them).

        The sweep iterates a SNAPSHOT of the registry (a health read is
        a full RPC that may block for its timeout; membership must stay
        mutable underneath it) but re-checks membership before every
        side effect on a replica — a replica removed mid-sweep gets no
        stale probe and no stale fold after its detach."""
        now = time.monotonic()
        with self._refresh_lock:
            if not force and now - self._last_refresh < self.health_interval_s:
                return
            self._last_refresh = now
        total_inflight = 0
        class_depth = {c: 0 for c in ADMISSION_CLASSES}
        worst_p99 = 0.0
        for replica in self.members():
            if replica.detached or not self._is_member(replica):
                continue  # removed since the snapshot: skip, don't probe
            try:
                health = replica.health()
            except Exception as exc:  # noqa: BLE001 - dead health = dead node
                log.warning("replica %s health read failed: %r",
                            replica.name, exc)
                health = None
            replica.observe_health(health, now)
            if health is not None:
                total_inflight += int(health.get("inflight") or 0)
                # metrics federation: scrape the replica's registry
                # snapshot (the shard_metrics RPC) on the same sweep
                # that read its health — one background thread pays
                # both round trips, callers pay neither
                if replica.metrics_read is not None:
                    try:
                        snapshot = replica.metrics_read()
                    except Exception as exc:  # noqa: BLE001 - scrape is
                        # best-effort: health already said it is alive
                        log.warning("replica %s metrics scrape failed: %r",
                                    replica.name, exc)
                        snapshot = None
                    if snapshot:
                        replica.last_metrics = snapshot
                        self._fold_metrics(replica.name, snapshot,
                                           class_depth)
            if replica.last_metrics:
                worst_p99 = max(worst_p99,
                                self._dispatch_p99(replica.last_metrics))
            if replica.state == ReplicaState.DRAINING \
                    and replica.probe is not None \
                    and health is not None \
                    and health.get("breaker") == "open" \
                    and self._is_member(replica):
                # the nudge that lets an idle drained replica recover:
                # once its cooldown elapses this call becomes the
                # half-open differential probe; before that it is a
                # cheap fallback-served request. Membership re-checked
                # at probe time: a replica removed while this sweep was
                # blocked in an earlier health read must not be probed
                # back to life (the mid-sweep shard_removeReplica case)
                try:
                    replica.probe()
                except Exception:  # noqa: BLE001 - probe outcome is the
                    pass  # breaker's business, not ours
            if replica.removing and replica.in_flight == 0 \
                    and not replica.accepting:
                # removal completes here: the drain ran its course
                # (nothing in flight, no longer accepting), so the
                # endpoint can finally vanish without any caller seeing
                # a live request die under it
                self._detach(replica)
        self._g_inflight.set(total_inflight)
        # decaying peak (tau ~1s): a queue that was deep within the
        # last second still reads deep, a drained trough decays to
        # zero in a few sweeps — sample-robust for the autoscaler's
        # sustain clocks in both directions
        with self._refresh_lock:
            dt = max(0.0, now - self._class_depth_peak_at)
            self._class_depth_peak_at = now
            decay = math.exp(-dt / 1.0)
            for klass, depth in class_depth.items():
                peak = max(float(depth),
                           self._class_depth_peak[klass] * decay)
                self._class_depth_peak[klass] = peak
                self._g_class_depth[klass].set(round(peak, 3))
        self._g_worst_p99.set(round(worst_p99, 6))
        self._check_hedge_storm()
        # the sweep doubles as the SLO gauge heartbeat: an idle class's
        # burn rate decays on the exposition instead of freezing
        slo.tracker().sweep(now)

    # a storm check needs this many dispatches since the last sweep
    # before the wasted rate means anything
    _STORM_MIN_DISPATCHES = 16

    def _check_hedge_storm(self) -> None:
        """Hedge-storm watch, run on the health sweep (off the request
        path): when the wasted-dispatch rate since the last sweep
        crosses ``hedge_storm_pct`` the router is duplicating work
        faster than it is cutting tails — a fleet-health event that
        lands in the flight recorder with a post-mortem bundle, like a
        breaker trip. Latched per episode (hysteresis at half the
        threshold) so a sustained storm dumps once, not per sweep."""
        if self.hedge_s <= 0:
            return
        dispatches = self._m_calls.value + self._m_hedge_issued.value
        wasted = self._m_hedge_wasted.value
        with self._storm_lock:
            prev_d, prev_w = self._storm_prev
            delta_d, delta_w = dispatches - prev_d, wasted - prev_w
            if delta_d < self._STORM_MIN_DISPATCHES:
                return  # not enough traffic to judge; keep accumulating
            self._storm_prev = (dispatches, wasted)
            rate_pct = 100.0 * delta_w / max(1, delta_d)
            if rate_pct >= self.hedge_storm_pct and not self._storm_latched:
                self._storm_latched = True
                self._g_hedge_storm.set(1)
                log.warning(
                    "hedge storm: %.1f%% of the last %d dispatches were "
                    "wasted duplicates (threshold %.0f%%)", rate_pct,
                    delta_d, self.hedge_storm_pct)
                RECORDER.trigger("hedge_storm", dump=True,
                                 wasted_pct=round(rate_pct, 1),
                                 window_dispatches=delta_d,
                                 threshold_pct=self.hedge_storm_pct,
                                 issued=self._m_hedge_issued.value,
                                 wasted=wasted)
            elif self._storm_latched and rate_pct < self.hedge_storm_pct / 2:
                self._storm_latched = False
                self._g_hedge_storm.set(0)
                RECORDER.record("hedge_storm_clear",
                                wasted_pct=round(rate_pct, 1))

    # federation fold: which remote namespaces land under
    # fleet/replica/<name>/..., and which snapshot fields per metric
    # type (the full snapshots would be thousands of gauges; these are
    # the dashboard-grade fields)
    _FOLD_NAMESPACES = ("serving/", "resilience/", "slo/", "trace/",
                        "sig/", "jax/", "das/", "fleettrace/")
    _FOLD_FIELDS = {
        "counter": ("count", "rate_1m"),
        "gauge": ("value",),
        "timer": ("count", "mean_s", "p50_s", "p95_s", "p99_s"),
        "histogram": ("count", "mean", "p50", "p95", "p99"),
    }

    def _fold_metrics(self, name: str, snapshot: dict,
                      class_depth: Dict[str, int]) -> None:
        """Fold one replica's scraped snapshot into this process's
        registry as ``fleet/replica/<name>/<metric>/<field>`` gauges
        (re-set in place every sweep), accumulating the per-class
        queue depths into the fleet aggregate on the way."""
        base = f"fleet/replica/{name}"
        for metric, snap in snapshot.items():
            if not isinstance(snap, dict) \
                    or not metric.startswith(self._FOLD_NAMESPACES):
                continue
            for field in self._FOLD_FIELDS.get(snap.get("type"), ()):
                value = snap.get(field)
                if isinstance(value, (int, float)):
                    self._registry.gauge(
                        f"{base}/{metric}/{field}").set(value)
            if metric.endswith("/queue_depth"):
                for klass in class_depth:
                    if f"/class/{klass}/" in metric:
                        class_depth[klass] += int(snap.get("value") or 0)

    @staticmethod
    def _dispatch_p99(snapshot: dict) -> float:
        """The replica's worst per-op device-dispatch p99 from its
        scraped snapshot — the 'slow chip' scalar."""
        worst = 0.0
        for metric, snap in snapshot.items():
            if metric.startswith("serving/") \
                    and metric.endswith("/dispatch_latency") \
                    and isinstance(snap, dict):
                worst = max(worst, float(snap.get("p99_s") or 0.0))
        return worst

    # -- routing -----------------------------------------------------------

    def route(self, affinity: Optional[str] = None) -> List[Replica]:
        """The preference-ordered accepting replicas for one call: a
        stable rendezvous order for keyed traffic, least-in-flight for
        keyless."""
        accepting = [r for r in self.members() if r.accepting]
        if affinity is None:
            return sorted(accepting, key=lambda r: (r.in_flight, r.name))
        key = str(affinity)

        def weight(replica: Replica) -> int:
            digest = hashlib.blake2b(
                f"{key}|{replica.name}".encode(), digest_size=8).digest()
            return int.from_bytes(digest, "big")

        return sorted(accepting, key=weight, reverse=True)

    def _pool(self) -> ThreadPoolExecutor:
        """The hedge worker pool, built on first hedged call (a router
        with hedging off never spawns it). Sized generously — every
        hedged interactive primary runs here, and a queued (not
        running) primary must be the exception, not the norm: a fuse
        that times out on pool queue wait would hedge spuriously
        (`_hedged`'s started-guard catches the residual case)."""
        with self._hedge_pool_lock:
            if self._hedge_pool_closed:
                # close() raced an in-flight hedged call: refuse
                # instead of silently rebuilding an executor nothing
                # will ever shut down
                raise AllReplicasDraining("router closed")
            if self._hedge_pool is None:
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=max(32, 8 * len(self.replicas)),
                    thread_name_prefix="fleet-hedge")
            return self._hedge_pool

    def _hedge_delay_s(self, replica: Replica, slo_class: str,
                       keyed: bool = False) -> float:
        """The class-aware hedge fuse for a call whose primary is
        `replica`: 0 (no hedge) unless hedging is on and the class is
        interactive — bulk/catchup latency budgets are periods, and
        duplicating them would double bulk device load for nothing.
        The fuse adapts to the primary's OBSERVED latency quantile
        (a slow chip earns its reputation), floored by the configured
        hedge delay so a cold ring cannot hair-trigger.

        Budget-aware exception: a KEYED bulk_audit call (a committee
        plane with shard affinity — the duplicate lands cache-warm on
        the next rendezvous replica) may hedge while the class's SLO
        budget is nearly whole (``hedge_bulk_min_budget`` > 0 arms it):
        when the error budget says duplicate dispatches are free, tail
        bulk audits get cut too; the moment the budget thins, bulk
        hedging stops FIRST (``fleet/hedge/bulk_budget_held`` counts
        the holds)."""
        if self.hedge_s <= 0:
            return 0.0
        if slo_class == CLASS_INTERACTIVE:
            return max(self.hedge_s,
                       replica.latency_quantile(self.hedge_quantile))
        if slo_class == CLASS_BULK_AUDIT and keyed \
                and self.hedge_bulk_min_budget > 0:
            if slo.tracker().budget_remaining(CLASS_BULK_AUDIT) \
                    >= self.hedge_bulk_min_budget:
                return max(self.hedge_s,
                           replica.latency_quantile(self.hedge_quantile))
            self._m_hedge_bulk_held.inc()
        return 0.0

    def call(self, op: str, *args, affinity: Optional[str] = None,
             klass: Optional[str] = None, tenant: Optional[str] = None,
             **kwargs):
        """Route one batch call with retry-on-next-replica. `affinity`
        pins the preference order (shard/pk-row/DAS-root keyed traffic
        stays cache-warm); `klass`/`tenant` tag admission downstream
        (the in-process serving tier reads the thread context, the RPC
        adapter ships them on the wire).

        With hedging on, an interactive call still pending after its
        hedge delay is re-issued to the NEXT affinity replica and the
        first verdict wins; the loser's verdict is discarded with
        accounting (``fleet/hedge/{issued,won,wasted}``), the
        duplicate rides untenanted (the tenant quota charges the
        logical request once), and a `SoundnessViolation` from any
        duplicate charges the audit-fault path at most once per
        logical request.

        Observability per call: a ``fleet/route`` span (op, class,
        shard affinity) parenting one ``fleet/attempt`` span per
        replica tried (replica name + attempt ordinal — and, through
        the RPC trace envelope, the replica's own handler/dispatch
        spans). SLO events: each FAILED attempt charges the class's
        error budget (a breaker trip burns budget even when failover
        keeps the caller whole — that is the fleet-health signal), the
        final success records one good event with end-to-end latency."""
        self._m_calls.inc()
        slo_class = class_for(op, klass)
        if self._sweeper is None:
            self.refresh()  # inline mode only; see __init__
        candidates = self.route(affinity)
        if not candidates:
            self.refresh(force=True)
            candidates = self.route(affinity)
            if not candidates:
                self._m_all_draining.inc()
                slo.record(slo_class, ok=False)
                raise AllReplicasDraining(
                    f"{op}: all {len(self.replicas)} replicas are "
                    f"draining or tripped")
        ladder = iter(candidates)
        tried: List[str] = []
        # the route span's context, filled in once it opens below:
        # pool-thread attempt spans reparent under the route with it
        route_ctx: List[Optional[tuple]] = [None]
        # per-LOGICAL-request state shared by all duplicates: the
        # soundness audit-fault accounting must fire once even when
        # both the primary and its hedge detect the same corruption,
        # and a discarded loser's failure must not burn SLO budget for
        # a logical request the winner already answered ("charged to
        # no caller")
        logical = {"audit_recorded": False, "won": False,
                   "lock": threading.Lock()}

        def run_on(replica: Replica, attempt_no: int,
                   hedged: bool = False, record_latency: bool = True,
                   started: Optional[List[bool]] = None):
            """One replica attempt: flight accounting, admission
            tagging (hedges ride untenanted), latency observation and
            failure classification. Runs on the caller thread for the
            plain path, on the hedge pool for duplicated dispatches —
            `route_ctx` reparents pool-thread spans under the route.
            `record_latency=False` for racing duplicates: only the
            WINNER's latency enters the replica's hedge-fuse ring
            (`_hedged` records it), so a delayed primary that loses
            the race cannot stretch its own future fuse. The ring is
            fed by INTERACTIVE samples only — it exists solely to set
            the interactive hedge fuse, and a replica also serving
            multi-second bulk audits must not have its interactive
            quantile (and so its fuse) inflated by them. `started`
            lets `_hedged` distinguish a slow replica from a primary
            still queued behind a saturated pool."""
            if started is not None:
                started[0] = True
            t0 = time.monotonic()
            try:
                with replica.flight(), \
                        tracing.span("fleet/attempt", ctx=route_ctx[0],
                                     replica=replica.name,
                                     attempt=attempt_no, hedged=hedged):
                    use_tenant = None if hedged else tenant
                    if klass is not None or use_tenant is not None:
                        # a tenant tag alone still charges the quota —
                        # class_for resolves this op's default class
                        with admission_class(class_for(op, klass),
                                             use_tenant):
                            out = getattr(replica.backend, op)(*args,
                                                               **kwargs)
                    else:
                        out = getattr(replica.backend, op)(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - classify + re-raise
                replica.note_failure(exc)
                if isinstance(exc, SoundnessViolation):
                    # at most ONE audit fault per logical request: the
                    # duplicate that loses the race must not burn the
                    # error budget for the same detected corruption
                    # (integrity signals burn budget even post-win —
                    # detected corruption is real wherever it raced)
                    with logical["lock"]:
                        first = not logical["audit_recorded"]
                        logical["audit_recorded"] = True
                    if first:
                        self._m_hedge_audit_faults.inc()
                        slo.record(slo_class, ok=False)
                else:
                    with logical["lock"]:
                        answered = logical["won"]
                    if not answered:
                        # a discarded loser failing AFTER the winner
                        # answered burns no budget — the logical
                        # request succeeded (loser_failures keeps the
                        # signal); a failure while the outcome is
                        # still open is a real attempt failure
                        slo.record(slo_class, ok=False)
                raise
            replica.note_success()
            if record_latency and slo_class == CLASS_INTERACTIVE:
                replica.note_latency(time.monotonic() - t0)
            return out

        def attempt():
            replica = next(ladder, None)
            if replica is None:
                self._m_all_draining.inc()
                raise AllReplicasDraining(
                    f"{op}: every accepting replica refused "
                    f"(tried {tried}; "
                    f"{len(self.replicas) - len(tried)} not accepting)")
            if tried:
                self._m_failovers.inc()
            tried.append(replica.name)
            hedge_s = self._hedge_delay_s(replica, slo_class,
                                          keyed=affinity is not None)
            if hedge_s <= 0:
                return run_on(replica, len(tried))
            return self._hedged(replica, hedge_s, ladder, tried, run_on,
                                logical,
                                feed_ring=slo_class == CLASS_INTERACTIVE)

        t_start = time.monotonic()
        route_tags = {"op": op, "klass": slo_class}
        if affinity is not None:
            route_tags["shard"] = str(affinity)
        with tracing.span("fleet/route", **route_tags):
            route_ctx[0] = tracing.current_context()
            out = self._executor.call(attempt)
        slo.record(slo_class, ok=True,
                   latency_s=time.monotonic() - t_start)
        return out

    def _hedged(self, primary: Replica, hedge_s: float, ladder,
                tried: List[str], run_on, logical: dict,
                feed_ring: bool = True):
        """One hedged attempt: dispatch to `primary` on the hedge
        pool; if no verdict lands within `hedge_s`, re-issue to the
        next replica in the affinity order and take the FIRST verdict.
        The loser's eventual outcome is discarded with accounting —
        ``fleet/hedge/wasted`` for a duplicate whose verdict nobody
        consumed, ``fleet/hedge/loser_failures`` when the discard was
        a failure (typed, but charged to no caller). Both failing
        raises the primary's error into the retry ladder.
        `feed_ring=False` for budget-hedged BULK calls: the latency
        ring sets the INTERACTIVE fuse only, and a multi-second audit
        winning its race must not inflate it."""
        pool = self._pool()
        started: List[bool] = [False]
        t_primary = time.monotonic()
        primary_f = pool.submit(run_on, primary, len(tried),
                                False, False, started)
        try:
            out = primary_f.result(timeout=hedge_s)
            if feed_ring:
                primary.note_latency(time.monotonic() - t_primary)
            return out
        except FutureTimeout:
            pass  # the hedge case: primary still pending
        if not started[0]:
            # the primary never STARTED — the fuse measured hedge-pool
            # queue wait, not replica latency. A hedge would join the
            # back of the same saturated queue and duplicate device
            # work exactly when the fleet is capacity-constrained; the
            # positive-feedback storm is the one failure hedging must
            # never cause. Wait the primary out instead.
            return primary_f.result()
        hedge_replica = next(ladder, None)
        if hedge_replica is None:
            return primary_f.result()  # nowhere to hedge: wait it out
        tried.append(hedge_replica.name)
        self._m_hedge_issued.inc()
        t_hedge = time.monotonic()
        hedge_f = pool.submit(run_on, hedge_replica, len(tried),
                              True, False)
        pending = {primary_f: ("primary", primary, t_primary),
                   hedge_f: ("hedge", hedge_replica, t_hedge)}
        failures: List[BaseException] = []
        failed_early = 0  # duplicates that failed before the verdict
        while pending:
            done, _ = futures_wait(list(pending),
                                   return_when=FIRST_COMPLETED)
            for future in done:
                role, winner_replica, t_sub = pending.pop(future)
                exc = future.exception()
                if exc is not None:
                    failures.append(exc)
                    failed_early += 1
                    continue
                # first verdict wins; the loser is discarded with
                # accounting once it completes (it may still be
                # running — its flight/audit paths stay correct, only
                # its verdict is dropped). A duplicate that already
                # FAILED is a wasted dispatch too (a partitioned hedge
                # target failing every duplicate fast must still feed
                # the storm watch's wasted rate). Only the winner's
                # latency feeds its replica's hedge-fuse ring.
                if role == "hedge":
                    self._m_hedge_won.inc()
                if feed_ring:
                    winner_replica.note_latency(time.monotonic() - t_sub)
                with logical["lock"]:
                    # the logical request is answered: a loser failing
                    # from here on burns no SLO budget (run_on checks)
                    logical["won"] = True
                # winner/loser linkage on the logical trace: the route
                # span names the winner, the loser's discard records a
                # wasted-work span under the same trace id
                tracing.tag_current(hedge_winner=winner_replica.name,
                                    hedge_winner_role=role)
                discard_ctx = tracing.current_context()
                for _ in range(failed_early):
                    self._m_hedge_wasted.inc()
                    self._m_hedge_loser_failures.inc()
                for loser, (_, loser_replica, loser_t) in pending.items():
                    loser.add_done_callback(functools.partial(
                        self._discard_loser, replica=loser_replica.name,
                        winner=winner_replica.name, t_sub=loser_t,
                        ctx=discard_ctx))
                return future.result()
        # both sides failed: no verdict was discarded (nothing wasted)
        # — the primary's failure drives the ladder (it is the one the
        # un-hedged path would have raised)
        raise primary_f.exception() or failures[0]

    def _discard_loser(self, future, replica: Optional[str] = None,
                       winner: Optional[str] = None,
                       t_sub: Optional[float] = None,
                       ctx: Optional[tuple] = None) -> None:
        self._m_hedge_wasted.inc()
        exc = future.exception()
        if exc is not None:
            # typed loss, charged to no caller: the winner already
            # answered; run_on recorded the replica-level failure
            self._m_hedge_loser_failures.inc()
            log.debug("hedge loser failed after the verdict: %r", exc)
        if ctx is not None and t_sub is not None and tracing.TRACER.enabled:
            # the loser's wall interval as an explicit wasted-work span
            # on the LOGICAL trace (same trace id as the winner, tagged
            # with both names): the critical-path analyzer reports it
            # as the hedge_wasted segment — duplicate work outside the
            # request's wall-time identity
            tags = {"replica": replica, "winner": winner, "wasted": True}
            if exc is not None:
                tags["error"] = repr(exc)
            tracing.TRACER.record("fleet/hedge_wasted", t_sub,
                                  time.monotonic(), trace_id=ctx[0],
                                  parent_id=ctx[1], tags=tags)

    def hedge_stats(self) -> Dict[str, int]:
        return {"issued": self._m_hedge_issued.value,
                "won": self._m_hedge_won.value,
                "wasted": self._m_hedge_wasted.value,
                "audit_faults": self._m_hedge_audit_faults.value,
                "loser_failures": self._m_hedge_loser_failures.value,
                "bulk_budget_held": self._m_hedge_bulk_held.value,
                "storm": int(self._storm_latched)}

    # -- runtime membership (fleet/membership.py drives these) -------------

    def members(self) -> List[Replica]:
        """A point-in-time snapshot of the registry — the only way the
        request/sweep paths walk it, so a concurrent add/remove never
        invalidates an in-progress iteration."""
        with self._members_lock:
            return list(self.replicas)

    def _is_member(self, replica: Replica) -> bool:
        with self._members_lock:
            return replica in self.replicas

    def _resize_policy_locked(self) -> None:
        # the failover ladder is as deep as the fleet: keep the retry
        # budget tracking the live registry size (a caller-injected
        # policy is the caller's contract and stays fixed)
        if not self._fixed_policy:
            self._executor.policy.attempts = max(2, len(self.replicas))

    def add_replica(self, replica: Replica,
                    initial_state: str = ReplicaState.DRAINING) -> Replica:
        """Admit a NEW replica at runtime. It enters DRAINING (not
        healthy-by-assertion): the next health sweep reads its real
        health and the existing half-open differential path promotes
        it — exactly how a drained replica re-enters. Duplicate names
        raise ValueError (the membership plane types this for the
        wire)."""
        with self._members_lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(
                    f"replica {replica.name!r} already registered")
            replica.set_state(initial_state)
            self.replicas.append(replica)
            self._resize_policy_locked()
        log.info("replica %s admitted (enters %s; the health sweep "
                 "promotes it)", replica.name, initial_state)
        return replica

    def remove_replica(self, name: str) -> dict:
        """Begin removing a replica: drain FIRST (no new work; its
        in-flight calls finish), then the health sweep detaches it once
        nothing is in flight. An idle replica detaches immediately.
        Returns the replica's state at return (``detached`` tells an
        operator whether the drain already completed)."""
        replica = self._replica(name)
        replica.drain_requested = True
        replica.removing = True
        # force the state transition now — route() must stop offering
        # this replica before the next sweep, not after it
        replica.observe_health({"breaker": None, "draining": True})
        if replica.in_flight == 0:
            self._detach(replica)
        state = replica.describe()
        state["detached"] = replica.detached
        return state

    def _detach(self, replica: Replica) -> None:
        """Final removal: unhook from the registry, then close the
        backend. Only ever called with the replica drained (nothing in
        flight), so no live request sees its endpoint vanish."""
        with self._members_lock:
            if replica not in self.replicas:
                return  # lost a benign race with another detacher
            self.replicas.remove(replica)
            self._resize_policy_locked()
            replica.detached = True
        close = getattr(replica.backend, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort shutdown
                log.exception("closing removed replica %s failed",
                              replica.name)
        log.info("replica %s detached (drain complete)", replica.name)

    # -- drain lifecycle ---------------------------------------------------

    def drain(self, name: str) -> None:
        """Operator-initiated drain: the replica stops taking new work
        on the next refresh and re-enters only after `undrain`."""
        self._replica(name).drain_requested = True
        self.refresh(force=True)

    def undrain(self, name: str) -> None:
        self._replica(name).drain_requested = False
        self.refresh(force=True)

    def _replica(self, name: str) -> Replica:
        for replica in self.members():
            if replica.name == name:
                return replica
        raise KeyError(f"unknown replica {name!r}")

    # -- observability / lifecycle -----------------------------------------

    def states(self) -> Dict[str, dict]:
        return {replica.name: replica.describe()
                for replica in self.members()}

    def close(self) -> None:
        self._stop_sweeper.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=2.0)
        with self._hedge_pool_lock:
            self._hedge_pool_closed = True
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        for replica in self.members():
            close = getattr(replica.backend, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort shutdown
                    log.exception("closing replica %s failed", replica.name)


class RouterSigBackend:
    """The drop-in `SigBackend` face over a `FleetRouter`: actors and
    the RPC server speak to the FLEET exactly as they would to one
    backend. Affinity derives from the call's own cache key — the
    committee op's first pk-row key, the DAS op's first root — so the
    routing layer is invisible except in the fleet counters."""

    def __init__(self, router: FleetRouter):
        self.router = router
        self.name = f"router[{len(router.replicas)}]"

    def ecrecover_addresses(self, digests, sigs65):
        return self.router.call("ecrecover_addresses", digests, sigs65)

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return self.router.call("bls_verify_aggregates", messages,
                                agg_sigs, agg_pks)

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        affinity = None
        if pk_row_keys:
            affinity = next((str(k) for k in pk_row_keys if k is not None),
                            None)
        return self.router.call("bls_verify_committees", messages,
                                sig_rows, pk_rows, pk_row_keys=pk_row_keys,
                                affinity=affinity)

    def das_verify_samples(self, chunks, indices, proofs, roots):
        affinity = None
        if roots:
            root = roots[0]
            affinity = root.hex() if hasattr(root, "hex") else str(root)
        return self.router.call("das_verify_samples", chunks, indices,
                                proofs, roots, affinity=affinity)

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        affinity = None
        if commitments:
            c = commitments[0]
            affinity = c.hex() if hasattr(c, "hex") else str(c)
        return self.router.call("das_verify_multiproofs", commitments,
                                index_rows, eval_rows, proofs, ns,
                                affinity=affinity)

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        from gethsharding_tpu_torch.sigbackend import VerdictFuture

        out = self.bls_verify_committees(messages, sig_rows, pk_rows,
                                         pk_row_keys=pk_row_keys)
        future = VerdictFuture(lambda: out)
        future.result()
        return future

    def submit(self, op: str, *args, pk_row_keys=None,
               klass: Optional[str] = None, tenant: Optional[str] = None):
        """The serving-compatible async face: routed synchronously on
        the calling thread (RPC handler threads are already per-
        connection), returned as a resolved future."""
        from concurrent.futures import Future

        future: Future = Future()
        kwargs = {}
        if op == "bls_verify_committees":
            kwargs["pk_row_keys"] = pk_row_keys
        try:
            future.set_result(self.router.call(op, *args, klass=klass,
                                               tenant=tenant, **kwargs))
        except BaseException as exc:  # noqa: BLE001 - future carries it
            future.set_exception(exc)
        return future

    def close(self) -> None:
        self.router.close()


class RpcReplicaBackend:
    """A chain_server replica's verification surface over JSON-RPC —
    the cross-process face a frontend router balances. Covers the FULL
    `SigBackend` plane set (``shard_ecrecover`` /
    ``shard_verifyAggregates`` / ``shard_verifyCommittees`` /
    ``shard_dasVerify``) plus the ``shard_health`` / ``shard_metrics``
    / ``shard_drain`` control plane, so a router balances everything —
    the committee audit and DAS verdict planes included.

    Transport failures surface as `ConnectionError` (the router's
    retryable/trip class), and a dialed backend REDIALS lazily after a
    connection loss: a replica process killed and restarted on the
    same endpoint re-enters the rotation through the ordinary health
    sweep without anyone rebuilding the backend. An optional ``chaos``
    schedule is consulted at the ``fleet.transport`` seam before every
    wire call (delay/partition modes, resilience/chaos.py)."""

    def __init__(self, client, name: str = "", chaos=None):
        self.client = client
        self.name = name or "rpc-replica"
        self.chaos = chaos
        self._host: Optional[str] = None
        self._port: Optional[int] = None
        self._timeout = 10.0
        self._client_lock = threading.Lock()
        self._closed = False

    @classmethod
    def dial(cls, host: str, port: int, timeout: float = 10.0,
             chaos=None) -> "RpcReplicaBackend":
        from gethsharding_tpu_torch.rpc.client import RPCClient

        backend = cls(RPCClient(host, port, timeout=timeout),
                      name=f"{host}:{port}", chaos=chaos)
        backend._host, backend._port = host, port
        backend._timeout = timeout
        return backend

    @classmethod
    def dial_lazy(cls, host: str, port: int, timeout: float = 10.0,
                  chaos=None) -> "RpcReplicaBackend":
        """Like `dial` without the eager connect: the first call (the
        health sweep's read, usually) dials through the ordinary redial
        path. Runtime admission uses this — an endpoint still coming up
        enters the registry DRAINING and connects when it arrives,
        instead of failing the control-plane RPC that admitted it."""
        backend = cls(None, name=f"{host}:{port}", chaos=chaos)
        backend._host, backend._port = host, int(port)
        backend._timeout = timeout
        return backend

    # -- the wire ----------------------------------------------------------

    def _client(self):
        """The live client, redialed if a prior call dropped it. Only
        dialed backends can redial; a caller-injected client is the
        caller's to replace."""
        with self._client_lock:
            if self.client is not None:
                return self.client
            if self._closed or self._host is None:
                raise ConnectionError(f"{self.name}: connection lost")
        from gethsharding_tpu_torch.rpc.client import RPCClient

        fresh = RPCClient(self._host, self._port, timeout=self._timeout)
        with self._client_lock:
            if self._closed:
                fresh.close()
                raise ConnectionError(f"{self.name}: closed")
            if self.client is None:
                self.client = fresh
            else:  # lost a benign race with another redialer
                fresh.close()
            return self.client

    def _drop_client(self, client) -> None:
        with self._client_lock:
            if self.client is client:
                self.client = None
        if client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - already dead
                pass

    def _call(self, method: str, *params):
        from gethsharding_tpu_torch.resilience.chaos import (
            transport_disturb)
        from gethsharding_tpu_torch.rpc.client import RPCError

        transport_disturb(self.chaos)
        client = self._client()
        try:
            # tag the enclosing span (the router's fleet/attempt, or
            # whatever the direct caller has open) with the endpoint
            # this call actually dialed — the router's `replica` tag
            # names the routing slot, this names the wire address
            tracing.tag_current(endpoint=self.name)
            return client.call(method, *params)
        except RPCError as exc:
            if "draining" in exc.message:
                # the replica refused because it is shutting down: a
                # transient routing fact, not a caller bug — surface it
                # retryable so the router advances to the next replica.
                # Drop the connection too: a drain usually precedes a
                # stop, and a gracefully-stopped server's established
                # connections outlive its listener — redialing is what
                # notices the restart (the kill path gets there via
                # "connection lost")
                self._drop_client(client)
                raise ConnectionError(
                    f"{self.name} draining: {exc.message}") from exc
            if "connection lost" in exc.message:
                # the socket died under the call (replica killed):
                # drop the client so the next call redials, and type
                # the failure as transport for the router's trip path
                self._drop_client(client)
                raise ConnectionError(
                    f"{self.name}: {exc.message}") from exc
            raise
        except TimeoutError:
            # a per-call deadline on a healthy connection (an oversized
            # batch, a slow dispatch): retryable for the router, but
            # the SHARED multiplexed socket stays up — tearing it down
            # would fail every concurrent call on this replica for one
            # slow request (builtins.TimeoutError subclasses OSError,
            # so this branch must come first)
            raise
        except (OSError, ValueError) as exc:
            # a write on a dead/closed socket: same transport story
            self._drop_client(client)
            raise ConnectionError(f"{self.name}: {exc!r}") from exc

    def ecrecover_addresses(self, digests, sigs65):
        from gethsharding_tpu_torch.rpc import codec
        from gethsharding_tpu_torch.serving.classes import current_admission
        from gethsharding_tpu_torch.utils.hexbytes import Address20

        klass, tenant = current_admission()
        out = self._call("shard_ecrecover",
                         [codec.enc_bytes(d) for d in digests],
                         [codec.enc_bytes(s) for s in sigs65],
                         klass, tenant)
        return [None if a is None else Address20(codec.dec_bytes(a))
                for a in out]

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        from gethsharding_tpu_torch.rpc import codec
        from gethsharding_tpu_torch.serving.classes import current_admission

        klass, tenant = current_admission()
        out = self._call("shard_verifyAggregates",
                         [codec.enc_bytes(m) for m in messages],
                         [codec.enc_g1(s) for s in agg_sigs],
                         [codec.enc_g2(p) for p in agg_pks],
                         klass, tenant)
        return [bool(b) for b in out]

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        from gethsharding_tpu_torch.rpc import codec
        from gethsharding_tpu_torch.serving.classes import current_admission

        klass, tenant = current_admission()
        out = self._call("shard_verifyCommittees",
                         [codec.enc_bytes(m) for m in messages],
                         codec.enc_g1_rows(sig_rows),
                         codec.enc_g2_rows(pk_rows),
                         codec.enc_pk_row_keys(pk_row_keys),
                         klass, tenant)
        return [bool(b) for b in out]

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        # the wire call blocks the calling thread either way (JSON-RPC
        # request/response); a resolved VerdictFuture keeps the async
        # contract so the notary's overlapped audit path composes
        from gethsharding_tpu_torch.sigbackend import VerdictFuture

        out = self.bls_verify_committees(messages, sig_rows, pk_rows,
                                         pk_row_keys=pk_row_keys)
        future = VerdictFuture(lambda: out)
        future.result()
        return future

    def das_verify_samples(self, chunks, indices, proofs, roots):
        from gethsharding_tpu_torch.rpc import codec
        from gethsharding_tpu_torch.serving.classes import current_admission

        klass, tenant = current_admission()
        out = self._call("shard_dasVerify",
                         *codec.enc_das_call(chunks, indices, proofs,
                                             roots),
                         klass, tenant)
        return [bool(b) for b in out]

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        from gethsharding_tpu_torch.rpc import codec
        from gethsharding_tpu_torch.serving.classes import current_admission

        klass, tenant = current_admission()
        out = self._call("shard_dasPolyVerify",
                         *codec.enc_das_poly_call(commitments, index_rows,
                                                  eval_rows, proofs, ns),
                         klass, tenant)
        return [bool(b) for b in out]

    # -- control plane -----------------------------------------------------

    def health(self) -> dict:
        return self._call("shard_health")

    def metrics(self) -> dict:
        """The replica's full registry snapshot (`shard_metrics`) —
        the federation scrape the router's health sweep folds into
        ``fleet/replica/<name>/...`` rollups."""
        return self._call("shard_metrics")

    def drain(self) -> dict:
        return self._call("shard_drain")

    def close(self) -> None:
        with self._client_lock:
            self._closed = True
            client, self.client = self.client, None
        if client is not None:
            client.close()
