"""Low-overhead span tracer (the port's copy of the JAX package's
`tracing/tracer.py`, without its export plane and log correlation).

Spans carry monotonic-clock bounds and tags on a context-local stack, so a
span opened inside another is its child; finished spans go to a bounded
ring and feed a ``trace/<name>`` timer of the metrics registry.
Collection is gated by one attribute read (`TRACER.enabled`): while
tracing is off every producer gets the shared no-op span.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from gethsharding_tpu_torch import metrics

# the active span stack of the current thread of control
_SPAN_STACK = contextvars.ContextVar("gethsharding_torch_span_stack",
                                     default=())


def _id_base() -> int:
    """Per-process id offset (the pid in the high bits), below 2^53 so
    the ids survive a JSON round trip through JavaScript."""
    return (os.getpid() & 0xFFFFF) << 32


class Span:
    """One named, tagged interval on the context-local stack."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "tags", "tid", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: Optional[int], tags: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tags = dict(tags) if tags else {}
        self.tid = threading.get_ident()
        self.start = time.monotonic()
        self.end: Optional[float] = None
        self._tracer = tracer
        self._token = None

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.tags.setdefault("error", repr(exc))
        self._tracer.finish(self)
        return False


class _NoopSpan:
    """The shared disabled-path span: no allocation, no clock reads."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def tag(self, **tags) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span collector: context stack and a bounded ring of finished span
    records (plain dicts, newest last)."""

    def __init__(self, ring_spans: int = 4096,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        self.enabled = False
        self.registry = registry
        self._ring: deque = deque(maxlen=ring_spans)
        self._ids = itertools.count(_id_base() + 1)
        self._lock = threading.Lock()
        self._timers: Dict[str, metrics.Timer] = {}
        self.spans_recorded = 0
        self.spans_dropped = 0

    def configure(self, ring_spans: Optional[int] = None,
                  registry: Optional[metrics.Registry] = None) -> None:
        with self._lock:
            if ring_spans is not None:
                self._ring = deque(self._ring, maxlen=ring_spans)
            if registry is not None:
                self.registry = registry
                self._timers = {}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def new_trace_id(self) -> int:
        return next(self._ids)

    def start(self, name: str, tags: Optional[dict] = None,
              ctx: Optional[Tuple[int, int]] = None):
        """Open a span under the context's current span (a new trace when
        there is none); NOOP_SPAN when disabled. An explicit `ctx`, a
        ``(trace_id, span_id)`` pair from another process's tracer carried
        on the RPC trace envelope, wins over the local stack: the span
        joins the remote trace under the remote span."""
        if not self.enabled:
            return NOOP_SPAN
        stack = _SPAN_STACK.get()
        if ctx is not None and ctx[0] is not None:
            trace_id, parent_id = int(ctx[0]), ctx[1]
            parent_id = None if parent_id is None else int(parent_id)
        else:
            parent = stack[-1] if stack else None
            trace_id = parent.trace_id if parent else self.new_trace_id()
            parent_id = parent.span_id if parent else None
        span = Span(self, name, trace_id=trace_id,
                    span_id=self.new_trace_id(),
                    parent_id=parent_id, tags=tags)
        span._token = _SPAN_STACK.set(stack + (span,))
        return span

    def finish(self, span: Span) -> None:
        if span._token is not None:
            try:
                _SPAN_STACK.reset(span._token)
            except ValueError:
                pass  # finished from another context: keep the record
            span._token = None
        span.end = time.monotonic()
        self._record(span.name, span.trace_id, span.span_id, span.parent_id,
                     span.start, span.end, span.tags, span.tid)

    def record(self, name: str, start: float, end: float,
               trace_id: Optional[int] = None,
               parent_id: Optional[int] = None,
               tags: Optional[dict] = None,
               tid: Optional[int] = None) -> Optional[int]:
        """Record a finished span from explicit monotonic timestamps: the
        cross-thread form the serving tier uses (a request's lifecycle
        spans the caller, flusher and dispatch threads; no one context
        owns it). Returns the span id (None when disabled)."""
        if not self.enabled:
            return None
        span_id = self.new_trace_id()
        self._record(name, trace_id or self.new_trace_id(), span_id,
                     parent_id, start, end, dict(tags) if tags else {},
                     threading.get_ident() if tid is None else tid)
        return span_id

    def current(self) -> Optional[Tuple[int, int]]:
        """(trace_id, span_id) of the context's active span, or None."""
        stack = _SPAN_STACK.get()
        if not stack:
            return None
        return (stack[-1].trace_id, stack[-1].span_id)

    def _record(self, name, trace_id, span_id, parent_id, start, end,
                tags, tid) -> None:
        record = {
            "name": name, "trace": trace_id, "span": span_id,
            "parent": parent_id, "start": start, "end": end,
            "dur_us": round((end - start) * 1e6, 1), "tid": tid,
            "tags": tags,
        }
        timer = self._timers.get(name)
        if timer is None:
            timer = self.registry.timer(f"trace/{name}")
            with self._lock:
                self._timers[name] = timer
        timer.observe(end - start)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.spans_dropped += 1
            self._ring.append(record)
            self.spans_recorded += 1

    def recent_spans(self, limit: Optional[int] = None) -> List[dict]:
        """Finished span records, oldest first."""
        with self._lock:
            spans = list(self._ring)
        return spans if limit is None else spans[-limit:]

    def recent_traces(self, limit: int = 100) -> List[dict]:
        """Finished spans grouped into traces, newest trace first (the
        status page's ``/trace``)."""
        by_trace: Dict[int, List[dict]] = {}
        for record in self.recent_spans():
            by_trace.setdefault(record["trace"], []).append(record)
        traces = sorted(
            by_trace.items(),
            key=lambda item: max(r["end"] for r in item[1]), reverse=True)
        return [{"trace_id": trace_id,
                 "duration_us": round(
                     (max(r["end"] for r in spans)
                      - min(r["start"] for r in spans)) * 1e6, 1),
                 "spans": spans}
                for trace_id, spans in traces[:limit]]


# the process tracer: instrumented code records here; `enable()` turns
# collection on
TRACER = Tracer()


def enable(ring_spans: int = 4096,
           registry: Optional[metrics.Registry] = None) -> Tracer:
    TRACER.configure(ring_spans=ring_spans, registry=registry)
    TRACER.enabled = True
    return TRACER


def disable() -> None:
    TRACER.enabled = False


def span(name: str, ctx: Optional[Tuple[int, int]] = None, **tags):
    """Open a context-stacked span on the process tracer (no-op when
    disabled): ``with tracing.span("notary/fetch"):``. `ctx` adopts a
    remote (trace_id, span_id), as `Tracer.start` says."""
    if not TRACER.enabled:
        return NOOP_SPAN
    return TRACER.start(name, tags or None, ctx=ctx)


def tag_current(**tags) -> None:
    """Set tags on the context's innermost active span, last writer wins
    (the fleet router names a hedge's winner this way). No-op when
    tracing is off or no span is open."""
    if not TRACER.enabled:
        return
    stack = _SPAN_STACK.get()
    if stack:
        stack[-1].tags.update(tags)


def request_context() -> Optional[Tuple[int, int]]:
    """The caller's (trace_id, span_id) to stitch a cross-thread serving
    request to, or None: one attribute read when tracing is off."""
    if not TRACER.enabled:
        return None
    return TRACER.current()


# the wire-propagation name: what `RPCClient.call` ships on the JSON-RPC
# trace envelope is the serving tier's stitching context
current_context = request_context
