"""Metrics: counters, gauges, fixed-bucket histograms and timers behind a
registry, and the registry's Prometheus text exposition (the port's copy of
the JAX package's `metrics.py`; its push reporters wait).

Parity: the go-metrics registry (`metrics.go:22-39`) scoped to what the
notary needs: aggregate signature verifications, collation validate and
period audit latencies, and per-actor operation counters. Timers keep a
ring buffer of recent observations for percentile snapshots.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional


class Counter:
    """Monotonic event count with a rate since creation and a 1-minute
    EWMA over 5-second ticks (go-metrics `meter.go`), advanced lazily on
    read."""

    _TICK_S = 5.0
    _ALPHA_1M = 1.0 - math.exp(-_TICK_S / 60.0)

    def __init__(self) -> None:
        self._value = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._uncounted = 0
        self._last_tick = self._t0
        self._ewma: Optional[float] = None

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
            self._uncounted += n

    @property
    def value(self) -> int:
        return self._value

    def rate(self) -> float:
        """Events/sec since creation."""
        elapsed = time.monotonic() - self._t0
        return self._value / elapsed if elapsed > 0 else 0.0

    def rate_1m(self, now: Optional[float] = None) -> float:
        """Events/sec, 1-minute EWMA (0.0 until the first 5 s tick)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ticks = int((now - self._last_tick) / self._TICK_S)
            if ticks > 0:
                # the events since the last read are spread evenly over the
                # elapsed ticks, so a lazy read agrees with a periodic ticker
                instant = self._uncounted / (ticks * self._TICK_S)
                remaining = ticks
                if self._ewma is None:
                    self._ewma = instant
                    remaining -= 1
                self._ewma = instant + (self._ewma - instant) * (
                    (1.0 - self._ALPHA_1M) ** remaining)
                self._uncounted = 0
                self._last_tick += ticks * self._TICK_S
            return self._ewma or 0.0

    def snapshot(self) -> dict:
        return {"type": "counter", "count": self._value,
                "rate_per_s": round(self.rate(), 3),
                "rate_1m": round(self.rate_1m(), 3)}


class Gauge:
    """Last-written value."""

    def __init__(self) -> None:
        self._value: float = 0.0

    def set(self, value: float) -> None:
        self._value = value

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket distribution of observations: the serving tier's
    batch sizes (discrete, bucket-shaped values a reservoir percentile
    would interpolate between) and the SLO tracker's latencies.

    Bucket semantics are Prometheus's: ``le_*`` counts are cumulative
    (observations at or below the bound; ``le_inf`` == ``count``), and
    ``bucket_*`` keys hold the exact per-slot counts.
    """

    DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, buckets=DEFAULT_BUCKETS) -> None:
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = tuple(sorted(buckets))
        # one slot per bound + the overflow (> last bound) slot
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        slot = len(self._bounds)
        for i, bound in enumerate(self._bounds):
            if value <= bound:
                slot = i
                break
        with self._lock:
            self._counts[slot] += 1
            self._count += 1
            self._total += value

    @property
    def count(self) -> int:
        return self._count

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def read(self) -> tuple:
        """One consistent locked read: (per-slot counts, count, total), so
        a reader racing `observe` never sees ``le_inf != count``."""
        with self._lock:
            return list(self._counts), self._count, self._total

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile from the buckets, interpolating linearly
        within the bucket the target rank falls in (Prometheus'
        `histogram_quantile`): the first bucket interpolates from 0, the
        overflow bucket clamps to the largest finite bound. 0.0 with no
        observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        counts, count, _ = self.read()
        if count == 0:
            return 0.0
        target = q * count
        running = 0
        lower = 0.0
        for i, bound in enumerate(self._bounds):
            if running + counts[i] >= target:
                if counts[i] == 0:
                    return float(bound)
                frac = (target - running) / counts[i]
                return lower + (bound - lower) * frac
            running += counts[i]
            lower = float(bound)
        return float(self._bounds[-1])

    def snapshot(self) -> dict:
        counts, count, total = self.read()
        out = {"type": "histogram", "count": count,
               "mean": round(total / count if count else 0.0, 3),
               "p50": round(self.quantile(0.50), 4),
               "p95": round(self.quantile(0.95), 4),
               "p99": round(self.quantile(0.99), 4)}
        running = 0
        for i, bound in enumerate(self._bounds):
            running += counts[i]
            out[f"le_{bound:g}"] = running
        out["le_inf"] = running + counts[-1]
        for i, bound in enumerate(self._bounds):
            out[f"bucket_{bound:g}"] = counts[i]
        out["bucket_inf"] = counts[-1]
        return out


class Timer:
    """Duration observations with percentile snapshots over a recent
    window (a ring buffer of the last `reservoir` observations)."""

    def __init__(self, reservoir: int = 1024) -> None:
        self._samples: List[float] = []
        self._reservoir = reservoir
        self._count = 0
        self._total = 0.0
        self._next = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            if len(self._samples) < self._reservoir:
                self._samples.append(seconds)
            else:
                self._samples[self._next] = seconds
                self._next = (self._next + 1) % self._reservoir

    def time(self) -> "_TimerContext":
        return _TimerContext(self)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            ordered = sorted(self._samples)
        idx = min(int(q * len(ordered)), len(ordered) - 1)
        return ordered[idx]

    def mean(self) -> float:
        return self._total / self._count if self._count else 0.0

    def snapshot(self) -> dict:
        return {
            "type": "timer", "count": self._count,
            "mean_s": round(self.mean(), 6),
            "p50_s": round(self.percentile(0.50), 6),
            "p95_s": round(self.percentile(0.95), 6),
            "p99_s": round(self.percentile(0.99), 6),
        }


class _TimerContext:
    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self) -> "_TimerContext":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._timer.observe(time.monotonic() - self._start)


class Registry:
    """Named metric registry (metrics.Registry parity): the first caller
    of a name defines its instrument."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_register(self, name: str, factory):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = factory()
                self._metrics[name] = metric
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_register(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_register(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get_or_register(name, Timer)

    def histogram(self, name: str, buckets=None) -> Histogram:
        """`buckets` applies only on first registration (the first caller
        of a name defines its instrument)."""
        factory = (Histogram if buckets is None
                   else (lambda: Histogram(buckets)))
        return self._get_or_register(name, factory)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: metric.snapshot() for name, metric in sorted(items)}


# the port's default registry (metrics.DefaultRegistry parity)
DEFAULT_REGISTRY = Registry()


def counter(name: str) -> Counter:
    return DEFAULT_REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return DEFAULT_REGISTRY.gauge(name)


def timer(name: str) -> Timer:
    return DEFAULT_REGISTRY.timer(name)


def histogram(name: str, buckets=None) -> Histogram:
    return DEFAULT_REGISTRY.histogram(name, buckets=buckets)


# -- Prometheus text exposition (scrape without Telegraf) -------------------


def _prom_name(name: str, namespace: str) -> str:
    """Metric path -> a legal Prometheus metric name."""
    import re

    flat = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return f"{namespace}_{flat}" if namespace else flat


def prometheus_text(registry: Registry = DEFAULT_REGISTRY,
                    namespace: str = "gethsharding") -> str:
    """The registry as Prometheus text exposition format (0.0.4) — the
    ``GET /metrics?format=prom`` payload, so a node is scrapeable with
    no Telegraf/Influx hop:

    - Counter   -> ``<name>_total`` counter (+ ``<name>_rate_1m`` gauge)
    - Gauge     -> gauge
    - Timer     -> summary (quantiles 0.5/0.95/0.99, ``_count``/``_sum``)
    - Histogram -> histogram (cumulative ``_bucket{le=...}``,
      ``le="+Inf"`` == ``_count``, plus ``_sum``)
    """
    with registry._lock:
        items = sorted(registry._metrics.items())
    lines: List[str] = []
    for name, metric in items:
        prom = _prom_name(name, namespace)
        if isinstance(metric, Counter):
            lines += [f"# TYPE {prom}_total counter",
                      f"{prom}_total {metric.value}",
                      f"# TYPE {prom}_rate_1m gauge",
                      f"{prom}_rate_1m {metric.rate_1m():g}"]
        elif isinstance(metric, Gauge):
            lines += [f"# TYPE {prom} gauge", f"{prom} {metric.value:g}"]
        elif isinstance(metric, Timer):
            lines.append(f"# TYPE {prom} summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'{prom}{{quantile="{q:g}"}} {metric.percentile(q):g}')
            lines += [f"{prom}_count {metric.count}",
                      f"{prom}_sum {metric.mean() * metric.count:g}"]
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {prom} histogram")
            # ONE locked read: +Inf bucket, _count and _sum must agree
            # even when a scrape races observe()
            counts, count, total = metric.read()
            running = 0
            for i, bound in enumerate(metric.bounds):
                running += counts[i]
                lines.append(f'{prom}_bucket{{le="{bound:g}"}} {running}')
            lines += [f'{prom}_bucket{{le="+Inf"}} {running + counts[-1]}',
                      f"{prom}_count {count}",
                      f"{prom}_sum {total:g}"]
    # never empty: a scraper (or the observability smoke step) reading
    # zero bytes cannot tell "no metrics yet" from a broken endpoint
    return "\n".join(lines) + "\n" if lines else "# empty registry\n"
