"""Composable retry policies: deadline + capped exponential backoff (the
port's copy of the JAX package's `resilience/policy.py`).

The reference hardens its seams by hand (every caller open-codes its
own poll loop); here retry behavior is ONE object applied at every
seam that talks to something that can transiently fail — the
`SMCClient` RPC-backend reads, shardp2p collation-body fetches, and
`storage/netstore` chunk gets. A seam owns a `RetryExecutor`, which
pre-resolves its per-seam counters once:

- ``resilience/retry/<seam>/retries``  — transient failures absorbed
  (the seam recovered without the caller noticing);
- ``resilience/retry/<seam>/giveups``  — attempts/deadline exhausted,
  the last error re-raised to the caller.

Only *transient* error classes are retried (`RetryPolicy.retryable`);
everything else propagates on the first throw — a revert or a
programming error must never be hammered. Writes are never routed
through an executor (a connection error mid-write is ambiguous;
retrying could double-submit a vote).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.resilience.errors import (FetchAborted,
                                                      TransientError)

# the transient classes every seam agrees on: network-ish failures and
# the layer's own explicit retry signal (chaos InjectedFault subclasses
# ConnectionError on purpose — injected faults model exactly this set)
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError, TransientError)

# OSError subclasses that are deterministic configuration errors, not
# weather, carved out of every policy's retryable classes and re-raised
# on the first throw: retrying a missing socket path or a permission
# failure only delays the inevitable and masks the misconfiguration
NON_RETRYABLE: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError)


class RetryPolicy:
    """Capped exponential backoff with jitter under an overall deadline.

    - ``attempts``: total tries (1 = no retry);
    - ``base_s`` / ``cap_s``: the backoff ladder — try k sleeps
      ``min(cap_s, base_s * 2**k)``, scaled down into ``[0.5, 1]`` of
      itself by the jitter draw;
    - ``deadline_s``: optional wall-clock budget across ALL attempts;
      a retry never starts past it (the sleep is also clipped to the
      remaining budget);
    - ``retryable``: exception classes worth retrying (less
      `NON_RETRYABLE`).
    """

    __slots__ = ("attempts", "base_s", "cap_s", "deadline_s", "retryable",
                 "_rng")

    def __init__(self, attempts: int = 4, base_s: float = 0.02,
                 cap_s: float = 1.0, deadline_s: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...] =
                 DEFAULT_RETRYABLE):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.deadline_s = deadline_s
        self.retryable = tuple(retryable)
        self._rng = random.Random()

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (0-based)."""
        delay = min(self.cap_s, self.base_s * (2 ** attempt))
        return delay * (1.0 - 0.5 * self._rng.random())


class RetryExecutor:
    """One seam's retry loop: policy + pre-resolved per-seam counters.

    ``abort`` is the owner's shutdown hook: called before and after
    every backoff sleep, an exception instance returned from it ends
    the ladder immediately (raised chained to the last transient
    error). Pair it with an interruptible ``sleep`` (e.g. an Event's
    ``wait``) so stop() wakes an in-flight backoff instead of letting
    it run out the full budget against a dead backend.
    """

    def __init__(self, seam: str, policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 abort: Optional[
                     Callable[[], Optional[BaseException]]] = None):
        self.seam = seam
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self._abort = abort
        self._m_retries = metrics.counter(
            f"resilience/retry/{seam}/retries")
        self._m_giveups = metrics.counter(
            f"resilience/retry/{seam}/giveups")

    def _check_abort(self, cause: BaseException) -> None:
        if self._abort is None:
            return
        stop = self._abort()
        if stop is not None:
            raise stop from cause

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn` under the policy; re-raise the last transient error
        once attempts (or the deadline) are exhausted."""
        policy = self.policy
        deadline = (time.monotonic() + policy.deadline_s
                    if policy.deadline_s is not None else None)
        for attempt in range(policy.attempts):
            try:
                return fn(*args, **kwargs)
            except policy.retryable as exc:
                if isinstance(exc, NON_RETRYABLE):
                    raise
                if attempt == policy.attempts - 1:
                    self._m_giveups.inc()
                    raise
                self._check_abort(exc)
                delay = policy.backoff_s(attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._m_giveups.inc()
                        raise
                    delay = min(delay, remaining)
                self._m_retries.inc()
                if delay > 0:
                    self._sleep(delay)
                self._check_abort(exc)
        raise AssertionError("unreachable")  # pragma: no cover


# sentinel: poll_probe exhausted its polls without an answer — the
# caller turns it into its own seam's transient miss (messages and
# retryable tuples stay per-seam)
POLL_MISS = object()


def poll_probe(probe: Callable, wait: Callable[[float], bool], *,
               interval_s: float, polls: int,
               not_ready: Tuple[Type[BaseException], ...]):
    """The shared inner loop of a poll-under-retry attempt.

    Up to `polls` probes, `interval_s` apart, paced by the owning
    service's interruptible `wait` (returning True means the service is
    stopping — raises `FetchAborted`, which is deliberately
    non-transient so the surrounding retry executor aborts instead of
    backing off against a shutting-down service). `probe` raising one
    of `not_ready` means "ask again next poll"; any return value is the
    answer. Returns `POLL_MISS` when every poll came up empty.
    """
    for _ in range(max(1, polls)):
        if wait(interval_s):
            raise FetchAborted
        try:
            return probe()
        except not_ready:
            continue
    return POLL_MISS
