"""Black-box flight recorder: the last N structured events and a
post-mortem bundle on the failures that matter (the port's copy of the JAX
package's `perfwatch/recorder.py`, without its wire-ledger ring, benchmark
ledger tail and observer hooks, which have no caller in the port).

When a breaker trips, a watchdog fires or a soundness violation surfaces,
the question is what the node was doing in the seconds before. The
recorder keeps an always-on bounded ring of structured events (breaker
trips and reopens, watchdog fires, chaos decisions, SLO breach onsets,
soundness violations) and freezes it to disk when a fatal trigger fires.

A bundle directory (under ``GETHSHARDING_TORCH_PERFWATCH_DIR``, default
``./torch_perfwatch_blackbox``) holds ``manifest.json`` (reason, stamps,
pid), ``events.json`` (the ring, oldest first), ``spans.json`` (the
tracer's finished spans) and ``metrics.json`` (a registry snapshot).

Dumps are rate-limited (``DUMP_MIN_INTERVAL_S``: a flapping breaker must
not write a bundle per trip), old bundles are pruned to ``MAX_BUNDLES``,
and the dump runs on a short-lived thread, so a trigger under a caller's
lock (the breaker trips inside its own) never does file IO there.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from typing import Optional

from gethsharding_tpu_torch import metrics, tracing

log = logging.getLogger("perfwatch.recorder")

RING = 256
DUMP_MIN_INTERVAL_S = 30.0
MAX_BUNDLES = 8

_M_EVENTS = metrics.counter("perfwatch/events")
_M_BUNDLES = metrics.counter("perfwatch/bundles")
_M_SUPPRESSED = metrics.counter("perfwatch/dumps_suppressed")


def bundle_dir() -> str:
    return os.environ.get("GETHSHARDING_TORCH_PERFWATCH_DIR",
                          os.path.join(os.getcwd(),
                                       "torch_perfwatch_blackbox"))


def prune_dirs(base: str, keep: int) -> None:
    """Keep only the newest `keep` subdirectories of `base` (name order:
    the bundle names start with a sortable timestamp)."""
    try:
        entries = sorted(e for e in os.listdir(base)
                         if os.path.isdir(os.path.join(base, e)))
    except OSError:
        return
    keep = max(1, keep)
    for stale in entries[:-keep] if len(entries) > keep else []:
        shutil.rmtree(os.path.join(base, stale), ignore_errors=True)


class FlightRecorder:
    """A bounded event ring with a post-mortem dump."""

    def __init__(self, registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.registry = registry
        self._events: deque = deque(maxlen=RING)
        self._lock = threading.Lock()
        self._last_dump = 0.0
        # one dump at a time: a trigger while one is pending is counted as
        # suppressed
        self._dump_pending = False
        self._seq = 0  # bundle-name sequence, advanced under the lock

    # -- producers ---------------------------------------------------------

    def record(self, kind: str, **detail) -> None:
        """Append one structured event (one locked deque append)."""
        event = {"ts": time.time(), "mono": time.monotonic(),
                 "kind": kind, "detail": detail}
        with self._lock:
            self._events.append(event)
        _M_EVENTS.inc()

    def trigger(self, kind: str, dump: bool = False, **detail) -> None:
        """Record `kind` and, for the fatal triggers (breaker trip,
        watchdog timeout, soundness violation, SLO breach), schedule a
        post-mortem dump on a background thread."""
        self.record(kind, **detail)
        if not dump:
            return
        with self._lock:
            suppressed = self._dump_pending
            if not suppressed:
                self._dump_pending = True
                # the directory is read here, on the triggering thread:
                # the dump must land where the trigger's caller points it
                thread = threading.Thread(
                    target=self._dump_safe, args=(kind, bundle_dir()),
                    name="perfwatch-dump", daemon=True)
                thread.start()
        if suppressed:
            _M_SUPPRESSED.inc()

    def describe(self) -> dict:
        """The status page's view: events buffered and bundles dumped."""
        with self._lock:
            return {"events": len(self._events), "bundles": self._seq}

    # -- the post-mortem dump ----------------------------------------------

    def _dump_safe(self, reason: str, base: str) -> None:
        try:
            self.dump(reason, base=base)
        except Exception:  # noqa: BLE001 - a failing dump must never
            # propagate into the resilience seam that triggered it
            log.exception("flight-recorder dump failed (reason %s)", reason)
        finally:
            with self._lock:
                self._dump_pending = False

    def dump(self, reason: str, base: str) -> Optional[str]:
        """Write one bundle directory under `base`; returns its path (None
        when rate-limited). Snapshots are taken before any file IO so the
        bundle is one moment."""
        now = time.monotonic()
        with self._lock:
            if self._last_dump and \
                    now - self._last_dump < DUMP_MIN_INTERVAL_S:
                _M_SUPPRESSED.inc()
                return None
            self._last_dump = now
            self._seq += 1
            seq = self._seq
            events = list(self._events)
        spans = tracing.TRACER.recent_spans()
        snapshot = self.registry.snapshot()
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(base, f"{stamp}_{reason}_{os.getpid()}_{seq}")
        os.makedirs(path, exist_ok=True)
        payloads = {
            "manifest.json": {"reason": reason, "ts": time.time(),
                              "mono": now, "pid": os.getpid(),
                              "events": len(events), "spans": len(spans)},
            "events.json": events,
            "spans.json": spans,
            "metrics.json": snapshot,
        }
        for fname, payload in payloads.items():
            with open(os.path.join(path, fname), "w") as fh:
                json.dump(payload, fh, indent=1, default=repr)
        _M_BUNDLES.inc()
        prune_dirs(base, MAX_BUNDLES)
        log.warning("flight-recorder bundle written: %s (%s)", path, reason)
        return path


# the process recorder: the resilience seams record here
RECORDER = FlightRecorder()
