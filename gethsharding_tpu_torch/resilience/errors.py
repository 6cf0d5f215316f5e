"""The resilience layer's error vocabulary (the port's copy of the JAX
package's `resilience/errors.py`).

A leaf module, so that infrastructure that fails work (the serving
dispatcher, the watchdog) and infrastructure that retries it (the policy
executors) share one vocabulary without importing each other: nothing here
imports anything.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for the resilience layer's own failure signals."""


class DeadlineExceeded(ResilienceError):
    """An in-flight operation overran its deadline and was abandoned.

    Raised into the futures of a batch whose dispatch the watchdog
    declared hung. The distinct type lets a failover backend count it as
    a device fault rather than a caller mistake.
    """


class DispatcherClosed(ResilienceError):
    """Work was still queued (or in flight) when the dispatcher shut
    down; its futures are failed with this instead of hanging."""


class SoundnessViolation(ResilienceError):
    """The primary backend returned a result the soundness audit rejects:
    a spot-checked row disagreed with the scalar reference, or the
    always-on verdict-plane invariant check failed (wrong row count, a
    verdict outside 0/1, an empty committee row verifying True).

    Silent corruption made loud: the device path raised nothing, the
    answer was simply wrong. A `ResilienceError` on purpose: the failover
    face counts it as a primary fault, so the breaker trips on a
    corrupting device as it does on a crashing one, and during a
    half-open probe it counts as a probe mismatch.
    """


class TransientError(Exception):
    """A failure the caller expects to succeed on retry.

    Seam adapters (the collation-body wait, the DAS fetches) raise
    subclasses of this and name them in their `RetryPolicy.retryable`
    tuple.
    """


class FetchAborted(Exception):
    """A poll-under-retry seam is stopping mid-fetch.

    Deliberately NOT transient (plain Exception, not TransientError):
    the retry executor must abort immediately instead of backing off
    and re-polling against a shutting-down service. Raised by
    `policy.poll_probe` when the owning service's `wait` reports stop.
    """
