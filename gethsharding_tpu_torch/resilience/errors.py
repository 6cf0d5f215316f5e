"""The resilience layer's error vocabulary (the port's copy of the part of
the JAX package's `resilience/errors.py` that the body fetch uses: the
serving tier's and the breaker's errors wait for those modules).

A leaf module: nothing here imports anything.
"""

from __future__ import annotations


class TransientError(Exception):
    """A failure the caller expects to succeed on retry.

    Seam adapters (the collation-body wait) raise subclasses of this
    and name them in their `RetryPolicy.retryable` tuple.
    """


class FetchAborted(Exception):
    """A poll-under-retry seam is stopping mid-fetch.

    Deliberately NOT transient (plain Exception, not TransientError):
    the retry executor must abort immediately instead of backing off
    and re-polling against a shutting-down service. Raised by
    `policy.poll_probe` when the owning service's `wait` reports stop.
    """
