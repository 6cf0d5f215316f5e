"""Admission classes: who may occupy the serving queue, and on what terms
(the port's copy of the JAX package's `serving/classes.py`).

Undifferentiated admission treats a catch-up replay burst and an
interactive call identically, so overload starves exactly the traffic
that can least afford it. Three classes partition the tier's workloads:

- ``interactive`` — request/response traffic a caller is waiting on
  (txpool sender recovery, the notary's vote-phase gates). Highest priority, tightest flush deadline, shed LAST.
- ``bulk_audit`` — high-volume verification whose latency budget is a
  period, not a round trip: the notary's period audits and the DAS
  sample-verdict plane. Middle priority; a weighted batch share keeps
  it flowing under interactive load without ever displacing it.
- ``catchup_replay`` — replay/backfill traffic that tolerates delay
  and retry (node catch-up, historical re-verification). Lowest
  priority, longest flush deadline, shed FIRST under overload, and the
  natural candidate for an expiry (none is set by default — expiry is an
  operator knob).

Each class carries:

- ``priority``   — drain order inside a coalesced batch (0 first);
- ``weight``     — the guaranteed share of a ``take_batch`` cycle, so
  a lower class still progresses under a higher-class flood (weighted
  fairness both ways: bulk can never starve interactive because
  interactive drains first, interactive can never fully starve bulk
  because bulk's weight share is reserved);
- ``flush_mult`` — multiplier on the queue's base flush deadline
  (bulk waits longer for a fuller bucket; interactive never does);
- ``deadline_s`` — optional max queue wait: a request older than this
  is EXPIRED (failed with a typed overload error) instead of occupying
  capacity forever. ``GETHSHARDING_TORCH_CLASS_<NAME>_DEADLINE_S`` sets
  it.

The `admission_class` context manager tags every serving submit made
by the calling thread — the tag rides the thread, not the call
signature, so it survives any backend wrapper composition (failover,
soundness, chaos, serving) without threading a kwarg through each.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

CLASS_INTERACTIVE = "interactive"
CLASS_BULK_AUDIT = "bulk_audit"
CLASS_CATCHUP = "catchup_replay"

ADMISSION_CLASSES = (CLASS_INTERACTIVE, CLASS_BULK_AUDIT, CLASS_CATCHUP)

# under overload, displace queued work in this order — catchup first,
# interactive last (and only ever for a strictly higher-priority arrival)
SHED_ORDER = (CLASS_CATCHUP, CLASS_BULK_AUDIT, CLASS_INTERACTIVE)


@dataclass(frozen=True)
class ClassPolicy:
    """One admission class's terms (see the module docstring)."""

    name: str
    priority: int
    weight: int
    flush_mult: float
    deadline_s: Optional[float] = None


def _env_deadline(name: str) -> Optional[float]:
    raw = os.environ.get(f"GETHSHARDING_TORCH_CLASS_{name.upper()}_DEADLINE_S")
    return float(raw) if raw else None


def default_policies() -> Dict[str, ClassPolicy]:
    """The default class table (fresh per queue so env changes in tests
    take effect per instance)."""
    return {
        CLASS_INTERACTIVE: ClassPolicy(
            CLASS_INTERACTIVE, priority=0, weight=8, flush_mult=1.0,
            deadline_s=_env_deadline(CLASS_INTERACTIVE)),
        CLASS_BULK_AUDIT: ClassPolicy(
            CLASS_BULK_AUDIT, priority=1, weight=3, flush_mult=4.0,
            deadline_s=_env_deadline(CLASS_BULK_AUDIT)),
        CLASS_CATCHUP: ClassPolicy(
            CLASS_CATCHUP, priority=2, weight=1, flush_mult=8.0,
            deadline_s=_env_deadline(CLASS_CATCHUP)),
    }


# ops whose traffic is bulk by nature even when the caller says nothing:
# the DAS sample-verdict plane is the notary's per-period availability
# sweep, never a caller-blocking round trip. Multiproof verdicts default
# the same way (the notary's sweep again).
DEFAULT_OP_CLASS = {
    "das_verify_samples": CLASS_BULK_AUDIT,
    "das_verify_multiproofs": CLASS_BULK_AUDIT,
}


def check_class(klass: str) -> str:
    if klass not in ADMISSION_CLASSES:
        raise ValueError(f"unknown admission class {klass!r}; "
                         f"choose from {ADMISSION_CLASSES}")
    return klass


def class_for(op: str, klass: Optional[str] = None) -> str:
    """Resolve a submit's admission class: explicit argument > the
    thread's `admission_class` context >
    ``GETHSHARDING_TORCH_CLASS_<OP>`` env override > the per-op default map > ``interactive``."""
    if klass is not None:
        return check_class(klass)
    ctx_class, _ = current_admission()
    if ctx_class is not None:
        return ctx_class
    env = os.environ.get(f"GETHSHARDING_TORCH_CLASS_{op.upper()}")
    if env:
        return check_class(env)
    return DEFAULT_OP_CLASS.get(op, CLASS_INTERACTIVE)


# -- the thread-local tagging context ---------------------------------------

_CTX = threading.local()


def current_admission() -> Tuple[Optional[str], Optional[str]]:
    """The calling thread's (class, tenant) tag, or (None, None)."""
    stack = getattr(_CTX, "stack", None)
    return stack[-1] if stack else (None, None)


@contextmanager
def admission_class(klass: str, tenant: Optional[str] = None):
    """Tag every serving submit the calling thread makes inside the
    block. Nestable; the innermost tag wins. A ``tenant`` of None
    inherits the enclosing tag's tenant."""
    check_class(klass)
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    if tenant is None and stack:
        tenant = stack[-1][1]
    stack.append((klass, tenant))
    try:
        yield
    finally:
        stack.pop()
