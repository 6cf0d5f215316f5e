"""Capped exponential backoff under an optional overall deadline (the
port's copy of the part of the JAX package's `resilience/policy.py` that
the notary's shardp2p body fetch, the DAS fetchers and the netstore's
chunk fetch use).

A seam owns a `RetryExecutor`, which pre-resolves its per-seam counters
once:

- ``resilience/retry/<seam>/retries``  — transient failures absorbed
  (the seam recovered without the caller noticing);
- ``resilience/retry/<seam>/giveups``  — attempts or the deadline
  exhausted, the last error re-raised to the caller.

Only the policy's *retryable* error classes are retried; everything
else propagates on the first throw.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.resilience.errors import (FetchAborted,
                                                      TransientError)

# the transient classes the DAS fetchers retry: network-ish failures and
# the layer's own explicit retry signal
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError, TransientError)


class RetryPolicy:
    """Capped exponential backoff with jitter under an overall deadline.

    - ``attempts``: total tries (1 = no retry);
    - ``base_s`` / ``cap_s``: the backoff ladder — try k sleeps
      ``min(cap_s, base_s * 2**k)``, scaled down into ``[0.5, 1]`` of
      itself by the jitter draw;
    - ``retryable``: exception classes worth retrying;
    - ``deadline_s``: optional wall-clock budget across all attempts; a
      retry never starts past it (the sleep is also clipped to the
      remaining budget).
    """

    __slots__ = ("attempts", "base_s", "cap_s", "retryable", "deadline_s",
                 "_rng")

    def __init__(self, attempts: int, base_s: float, cap_s: float,
                 retryable: Tuple[Type[BaseException], ...],
                 deadline_s: Optional[float] = None):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.retryable = tuple(retryable)
        self.deadline_s = deadline_s
        self._rng = random.Random()

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (0-based)."""
        delay = min(self.cap_s, self.base_s * (2 ** attempt))
        return delay * (1.0 - 0.5 * self._rng.random())


class RetryExecutor:
    """One seam's retry loop: policy + pre-resolved per-seam counters."""

    def __init__(self, seam: str, policy: RetryPolicy):
        self.seam = seam
        self.policy = policy
        self._m_retries = metrics.counter(f"resilience/retry/{seam}/retries")
        self._m_giveups = metrics.counter(f"resilience/retry/{seam}/giveups")

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn` under the policy; re-raise the last retryable error
        once the attempts (or the deadline) are exhausted."""
        policy = self.policy
        deadline = (time.monotonic() + policy.deadline_s
                    if policy.deadline_s is not None else None)
        for attempt in range(policy.attempts):
            try:
                return fn(*args, **kwargs)
            except policy.retryable:
                if attempt == policy.attempts - 1:
                    self._m_giveups.inc()
                    raise
                delay = policy.backoff_s(attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._m_giveups.inc()
                        raise
                    delay = min(delay, remaining)
                self._m_retries.inc()
                time.sleep(delay)
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
