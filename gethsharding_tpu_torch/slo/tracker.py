"""Rolling multi-window SLO burn-rate tracking, the SRE workbook shape (the
port's copy of the JAX package's `slo/tracker.py`, without its breach
hooks, which have no caller in the port).

An objective owns an ERROR BUDGET: ``1 - availability`` of events may
be bad (failed, or slower than the latency target) before the SLO is
broken. The burn rate is how fast that budget is being spent:

    burn = (bad / events over a window) / (1 - availability)

1.0 means the budget exactly lasts the window's period; 14.4 over the
fast window is the classic "2% of a 30-day budget in one hour" page
threshold. Two windows make the signal robust — the FAST window (5 m)
reacts to an outage in seconds, the SLOW window (1 h) stops a brief
blip from paging — and a breach fires only when both burn (the
multi-window, multi-burn-rate alert).

Mechanics: per objective, good/bad counts land in 5-second buckets on
a ring sized to the slow window; both windows read the same ring
(lazy-advanced on record/read like `metrics.Counter.rate_1m`, so an
idle class costs nothing). Latency distribution rides a
`metrics.Histogram` whose bucket-interpolated `quantile()` gives the
p50/p95/p99 of `describe()`. Everything is O(ring) only on reads that
are throttled to ~1/s; the hot-path `record()` is two dict hops, two
int adds and a histogram observe under a per-objective lock.

Each objective's targets are knobs with the port's prefix:
``GETHSHARDING_TORCH_SLO_<NAME>_AVAILABILITY`` / ``_P99_MS``. The windows
and the breach thresholds are the module constants below.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from gethsharding_tpu_torch import metrics

log = logging.getLogger("slo")

# ring resolution: 5-second buckets (the go-metrics meter tick); the
# windows must be multiples of this
BUCKET_S = 5.0
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0

# breach thresholds: fast-window burn 14.4 (2% of a 30-day budget per
# hour) AND slow-window burn 6 (5% per 6 h) — the SRE workbook's page
# pair, scaled to our 5m/1h windows
BREACH_FAST = 14.4
BREACH_SLOW = 6.0
# a breach needs at least this many events in the fast window
MIN_EVENTS = 10

# latency histogram bounds in seconds: sub-ms host calls up through
# multi-second bulk audits
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

INTEGRITY = "integrity"


@dataclass(frozen=True)
class Objective:
    """One declarative objective: availability target + optional
    latency target at a quantile. ``latency_target_s`` None means
    availability-only (the integrity objective's shape)."""

    name: str
    availability: float
    latency_target_s: Optional[float] = None
    latency_q: float = 0.99

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {self.availability}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    def bad(self, ok: bool, latency_s: Optional[float]) -> bool:
        """Is one event bad under this objective? A failure always is;
        a success is bad when it blew the latency target."""
        if not ok:
            return True
        return (self.latency_target_s is not None
                and latency_s is not None
                and latency_s > self.latency_target_s)

    def describe(self) -> dict:
        return {
            "availability": self.availability,
            "error_budget": round(self.error_budget, 6),
            "latency_target_ms": (
                None if self.latency_target_s is None
                else round(self.latency_target_s * 1e3, 3)),
            "latency_q": self.latency_q,
        }


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name, "")
    return float(raw) if raw else default


# (availability, p99 latency ms or None) per objective, the JAX
# package's table
_DEFAULTS = {
    "interactive": (0.999, 8000.0),
    "bulk_audit": (0.99, 30000.0),
    "catchup_replay": (0.95, None),
    # light-client DAS traffic gets its own objective, so a breach in
    # bulk audit load never masks a sampling-tier regression
    "das_light": (0.999, 8000.0),
    INTEGRITY: (0.9999, None),
}


def default_objectives() -> Dict[str, Objective]:
    """The default objective table: one per admission class plus the
    soundness-fed ``integrity`` objective. Env-overridable per
    objective: ``GETHSHARDING_TORCH_SLO_<NAME>_AVAILABILITY`` and
    ``GETHSHARDING_TORCH_SLO_<NAME>_P99_MS`` (0 disables the latency
    target). Fresh per call so env changes in tests take effect per
    instance."""
    out = {}
    for name, (availability, p99_ms) in _DEFAULTS.items():
        key = name.upper()
        availability = _env_float(
            f"GETHSHARDING_TORCH_SLO_{key}_AVAILABILITY", availability)
        p99_ms = _env_float(f"GETHSHARDING_TORCH_SLO_{key}_P99_MS", p99_ms)
        target_s = None if not p99_ms else p99_ms / 1e3
        out[name] = Objective(name, availability,
                              latency_target_s=target_s)
    return out


DEFAULT_OBJECTIVES = tuple(_DEFAULTS)


class _Series:
    """One objective's live state: the good/bad bucket ring (sized to
    the slow window), its metric handles, and breach hysteresis."""

    __slots__ = ("objective", "good", "bad", "head", "lock", "latency",
                 "m_good", "m_bad", "m_breaches", "g_fast", "g_slow",
                 "g_budget", "breached", "last_gauge")

    def __init__(self, objective: Objective, n_buckets: int,
                 registry: metrics.Registry):
        base = f"slo/{objective.name}"
        self.objective = objective
        self.good = [0] * n_buckets
        self.bad = [0] * n_buckets
        self.head = 0  # absolute bucket tick of the newest bucket
        self.lock = threading.Lock()
        self.latency = registry.histogram(f"{base}/latency_s",
                                          buckets=LATENCY_BUCKETS_S)
        self.m_good = registry.counter(f"{base}/good")
        self.m_bad = registry.counter(f"{base}/bad")
        self.m_breaches = registry.counter(f"{base}/breaches")
        self.g_fast = registry.gauge(f"{base}/burn_rate")
        self.g_slow = registry.gauge(f"{base}/burn_rate_slow")
        self.g_budget = registry.gauge(f"{base}/budget_remaining")
        self.g_budget.set(1.0)
        self.breached = False
        self.last_gauge = 0.0

    # callers hold self.lock for the ring operations below

    def _advance(self, tick: int) -> None:
        n = len(self.good)
        if tick <= self.head:
            return
        steps = min(tick - self.head, n)
        for i in range(1, steps + 1):
            idx = (self.head + i) % n
            self.good[idx] = 0
            self.bad[idx] = 0
        self.head = tick

    def _window(self, buckets: int) -> tuple:
        n = len(self.good)
        buckets = min(buckets, n)
        good = bad = 0
        for i in range(buckets):
            idx = (self.head - i) % n
            good += self.good[idx]
            bad += self.bad[idx]
        return good, bad


class SLOTracker:
    """Burn-rate tracker over a set of objectives (see module doc).

    `now` parameters take a monotonic-clock reading and exist for
    deterministic tests; production callers omit them."""

    def __init__(self, registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self._fast_buckets = int(FAST_WINDOW_S / BUCKET_S)
        n = int(SLOW_WINDOW_S / BUCKET_S)
        self.objectives = default_objectives()
        self._series = {name: _Series(obj, n, registry)
                        for name, obj in self.objectives.items()}

    # -- event intake (the hot path) ---------------------------------------

    def record(self, name: str, ok: bool = True,
               latency_s: Optional[float] = None,
               now: Optional[float] = None) -> None:
        """One event against objective `name` (an admission class, or
        ``integrity``). Unknown names are DROPPED, not raised — the
        serving hot path must never fail a request over SLO
        bookkeeping."""
        series = self._series.get(name)
        if series is None:
            return
        now = time.monotonic() if now is None else now
        bad = series.objective.bad(ok, latency_s)
        tick = int(now / BUCKET_S)
        with series.lock:
            series._advance(tick)
            idx = tick % len(series.good)
            if bad:
                series.bad[idx] += 1
            else:
                series.good[idx] += 1
            # gauge refresh is throttled to ~1/s per objective: O(ring)
            # work stays off the per-request path at high rates while
            # the exposition never lags a live incident by more than a
            # second. Claiming the refresh slot is a check-then-act on
            # last_gauge, so it happens under the ring lock — exactly
            # one of N concurrent recorders wins the refresh.
            refresh = now - series.last_gauge >= 1.0
            if refresh:
                series.last_gauge = now
        (series.m_bad if bad else series.m_good).inc()
        if latency_s is not None:
            series.latency.observe(latency_s)
        if refresh:
            self._refresh(series, now)

    # -- window math --------------------------------------------------------

    def _burns(self, series: _Series, now: float) -> tuple:
        """(fast_burn, slow_burn, fast_events, slow_events) at `now`."""
        tick = int(now / BUCKET_S)
        with series.lock:
            series._advance(tick)
            fg, fb = series._window(self._fast_buckets)
            sg, sb = series._window(len(series.good))
        budget = series.objective.error_budget
        fast = (fb / (fg + fb)) / budget if fg + fb else 0.0
        slow = (sb / (sg + sb)) / budget if sg + sb else 0.0
        return fast, slow, fg + fb, sg + sb

    def burn_rate(self, name: str, window: str = "fast",
                  now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        fast, slow, _, _ = self._burns(self._series[name], now)
        return fast if window == "fast" else slow

    def budget_remaining(self, name: str,
                         now: Optional[float] = None) -> float:
        """Fraction of the slow-window error budget left at the current
        slow burn: 1.0 = untouched, 0.0 = a full slow window at burn >= 1
        (the SLO is being missed outright)."""
        now = time.monotonic() if now is None else now
        _, slow, _, _ = self._burns(self._series[name], now)
        return max(0.0, 1.0 - slow)

    # -- gauges + breach ----------------------------------------------------

    def _refresh(self, series: _Series, now: float) -> None:
        fast, slow, fast_n, slow_n = self._burns(series, now)
        series.g_fast.set(round(fast, 4))
        series.g_slow.set(round(slow, 4))
        series.g_budget.set(round(max(0.0, 1.0 - slow), 4))
        name = series.objective.name
        # the breached flag is a check-then-act shared by every recorder
        # thread that wins a refresh slot: the flip happens under the ring
        # lock (taken after _burns released it), so a breach onset fires
        # the counter once
        fire = False
        with series.lock:
            if (fast >= BREACH_FAST and slow >= BREACH_SLOW
                    and fast_n >= MIN_EVENTS):
                if not series.breached:
                    series.breached = True
                    fire = True
            elif fast < BREACH_FAST / 2:
                # hysteresis: re-arm only once the fast burn halves, so
                # a burn hovering at the threshold logs one breach, not
                # one per gauge refresh
                series.breached = False
        if fire:
            series.m_breaches.inc()
            # breach onset only (hysteresis-gated above): one flight-
            # recorder event and bundle per episode
            from gethsharding_tpu_torch.perfwatch import RECORDER

            RECORDER.trigger("slo_breach", dump=True, objective=name,
                             fast_burn=round(fast, 3),
                             slow_burn=round(slow, 3))
            log.warning(
                "SLO breach on %s: fast burn %.1fx budget "
                "(threshold %.1fx), slow burn %.1fx (threshold "
                "%.1fx) over %d/%d events", name, fast,
                BREACH_FAST, slow, BREACH_SLOW,
                fast_n, slow_n)

    def sweep(self, now: Optional[float] = None) -> None:
        """Recompute every objective's gauges now (the fleet router's
        health sweep calls this, so an idle class's burn decays on the
        exposition instead of freezing at its last recorded value)."""
        now = time.monotonic() if now is None else now
        for series in self._series.values():
            with series.lock:
                series.last_gauge = now
            self._refresh(series, now)

    # -- introspection ------------------------------------------------------

    def describe(self, now: Optional[float] = None) -> dict:
        """The snapshot: per objective, the declared target, both burn
        rates, budget remaining, event and breach counts and the latency
        percentile ladder."""
        now = time.monotonic() if now is None else now
        out = {}
        for name, series in self._series.items():
            fast, slow, fast_n, slow_n = self._burns(series, now)
            entry = {
                "objective": series.objective.describe(),
                "burn_rate": round(fast, 4),
                "burn_rate_slow": round(slow, 4),
                "budget_remaining": round(max(0.0, 1.0 - slow), 4),
                "events_fast_window": fast_n,
                "events_slow_window": slow_n,
                "good": series.m_good.value,
                "bad": series.m_bad.value,
                "breaches": series.m_breaches.value,
            }
            if series.latency.count:
                entry["latency_ms"] = {
                    "p50": round(series.latency.quantile(0.50) * 1e3, 3),
                    "p95": round(series.latency.quantile(0.95) * 1e3, 3),
                    "p99": round(series.latency.quantile(0.99) * 1e3, 3),
                }
            out[name] = entry
        return out


# the process tracker: the serving tier and the soundness audit record
# here; objectives come from the env at first use, so importing the
# package pins no env reading taken before a test could set its own
TRACKER: Optional[SLOTracker] = None
_TRACKER_LOCK = threading.Lock()


def tracker() -> SLOTracker:
    global TRACKER
    if TRACKER is None:
        with _TRACKER_LOCK:
            if TRACKER is None:
                TRACKER = SLOTracker()
    return TRACKER


def record(name: str, ok: bool = True,
           latency_s: Optional[float] = None) -> None:
    """Record one event on the process tracker (see
    `SLOTracker.record`)."""
    tracker().record(name, ok=ok, latency_s=latency_s)


def active() -> Optional[SLOTracker]:
    """The process tracker if anything built it yet, else None: the
    status page's probe, which must not conjure objectives on an idle
    node."""
    return TRACKER
