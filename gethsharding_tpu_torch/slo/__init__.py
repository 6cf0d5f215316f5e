"""Per-class service-level objectives: error budgets, burn rates, breaches
(the port's copy of the JAX package's `slo/`).

- ``tracker.py`` — `Objective` (target availability and an optional
  latency quantile target, env-overridable), `SLOTracker` (bucketed
  good/bad event rings, fast/slow burn rates, ``slo/<name>/...`` gauges
  and counters in the metrics registry) and the lazily built process
  tracker (`tracker()` / module-level `record()`).

Event sources: the serving tier records every request's outcome and
latency (`serving/batcher.py`) and every shed or expiry, and the
soundness audit feeds the ``integrity`` objective
(`resilience/soundness.py`).
"""

from gethsharding_tpu_torch.slo.tracker import (  # noqa: F401
    DEFAULT_OBJECTIVES,
    INTEGRITY,
    Objective,
    SLOTracker,
    active,
    default_objectives,
    record,
    tracker,
)
