"""Dynamic micro-batcher: many callers' rows, one device dispatch (the
port's copy of the JAX package's `serving/batcher.py`).

One `AdmissionQueue` + flusher thread per signature operation (the five
ops have incompatible batch layouts and separate kernels, so they
coalesce separately), all feeding ONE shared
`PipelinedDispatcher`. A flusher drains whatever concurrent callers
queued, concatenates their rows into single batch columns (host-side
aggregation — stage 1 of the double buffer), and hands the assembled
batch to the dispatch thread, then immediately loops back to drain the
next window while the device executes.

Batch sizing reuses the sigbackend's quarter-power-of-two bucket
policy (`sigbackend/marshal.py::bucket_size`): `max_batch` is rounded to
a bucket at construction and partial (deadline) flushes are padded BY
THE WRAPPED BACKEND to the same buckets it uses for direct callers —
coalesced traffic fills the same shapes better.

Per-op observability (metrics registry names under ``serving/``):

- ``serving/<op>/requests``, ``/dispatches``, ``/shed`` counters —
  the coalescing ratio and the backpressure drop rate;
- ``serving/<op>/flush_full`` / ``/flush_deadline`` counters — whether
  traffic is dense enough to fill buckets or the deadline is doing the
  flushing;
- ``serving/<op>/batch_rows`` fixed-bucket histogram — the batch-size
  distribution (discrete sizes: a reservoir-percentile timer would
  interpolate between bucket shapes that never occur);
- ``serving/<op>/queue_depth`` gauge, ``/wait_time`` and
  ``/dispatch_latency`` timers.

With tracing enabled (``gethsharding_tpu_torch.tracing``), every request also
emits a span tree: ``serving/<op>/request`` decomposing into contiguous
``queue_wait`` / ``batch_assembly`` / ``device_dispatch`` children (the
per-request latency attribution the aggregate timers cannot give), plus
a ``future_wake`` phase recorded by the caller on resume; the dispatch
child carries ``device_ms``/``marshal_ms``/``wire_bytes`` tags. When
tracing is off the hot path pays one attribute read per request.

Every completed request additionally records one per-class SLO event
(``slo/``): good with its end-to-end latency on success, bad on a shed
or a failed batch — the burn-rate feed, always on.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

from gethsharding_tpu_torch import metrics, slo, tracing
from gethsharding_tpu_torch.perfwatch import ensure_host
from gethsharding_tpu_torch.serving.classes import (
    ADMISSION_CLASSES,
    class_for,
    current_admission,
)
from gethsharding_tpu_torch.serving.pipeline import PipelinedDispatcher
from gethsharding_tpu_torch.serving.queue import (
    AdmissionQueue,
    QueueClosed,
    Request,
    ServingOverloadError,
    TenantQuotaExceeded,
)

# the SigBackend batch API surface the serving tier coalesces
SERVING_OPS = ("ecrecover_addresses", "bls_verify_aggregates",
               "bls_verify_committees", "das_verify_samples",
               "das_verify_multiproofs")

# registry-friendly short labels
OP_LABELS = {
    "ecrecover_addresses": "ecrecover",
    "bls_verify_aggregates": "bls_aggregate",
    "bls_verify_committees": "bls_committee",
    "das_verify_samples": "das_verify",
    "das_verify_multiproofs": "das_poly_verify",
}

# batch-row histogram buckets: the quarter-pow2 ladder the backend pads
# to, so each histogram bucket is (roughly) one padded shape
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 384,
                  512, 768, 1024)


class _OpMetrics:
    """The per-operation metric handles, resolved once."""

    def __init__(self, registry: metrics.Registry, label: str):
        base = f"serving/{label}"
        self.requests = registry.counter(f"{base}/requests")
        self.request_rows = registry.counter(f"{base}/request_rows")
        self.dispatches = registry.counter(f"{base}/dispatches")
        self.shed = registry.counter(f"{base}/shed")
        self.flush_full = registry.counter(f"{base}/flush_full")
        self.flush_deadline = registry.counter(f"{base}/flush_deadline")
        self.batch_rows = registry.histogram(f"{base}/batch_rows",
                                             buckets=_BATCH_BUCKETS)
        self.queue_depth = registry.gauge(f"{base}/queue_depth")
        self.wait_time = registry.timer(f"{base}/wait_time")
        self.dispatch_latency = registry.timer(f"{base}/dispatch_latency")
        # the per-admission-class split (serving/classes.py): request and
        # depth attribution per class, plus per-class queue-wait timers.
        # The shed/expiry
        # counters under the same prefix are owned by the AdmissionQueue
        # — displacement happens inside it, invisible from here.
        self.class_requests = {
            c: registry.counter(f"{base}/class/{c}/requests")
            for c in ADMISSION_CLASSES}
        self.class_depth = {
            c: registry.gauge(f"{base}/class/{c}/queue_depth")
            for c in ADMISSION_CLASSES}
        self.class_wait = {
            c: registry.timer(f"{base}/class/{c}/wait_time")
            for c in ADMISSION_CLASSES}


class MicroBatcher:
    """Coalesce concurrent per-op requests into single inner-backend calls.

    `submit()` is the only producer entry: it validates shape, enqueues
    a `Request`, and returns its future. Results come back per-request
    in the caller's own row order — coalescing is invisible except in
    the dispatch counters.
    """

    def __init__(self, inner, max_batch: int = 128,
                 flush_us: float = 500.0, queue_cap: int = 4096,
                 policy: str = "block",
                 watchdog_s: float = 0.0,
                 tenant_quota_rows: Optional[int] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        from gethsharding_tpu_torch.sigbackend.marshal import bucket_size

        self.inner = inner
        # full-flush quantum = a padded bucket shape, never between two
        self.max_batch = bucket_size(max(1, max_batch))
        self.flush_us = flush_us
        self.queue_cap = queue_cap
        self.policy = policy
        # per-op dispatch counts; "only the dispatch thread writes"
        # stopped being true the day the watchdog grew fail_current —
        # a superseded dispatch thread finishing its device call can
        # overlap the fresh thread's next batch, so the += takes a lock
        self.dispatch_counts: Dict[str, int] = {op: 0 for op in SERVING_OPS}
        self._counts_lock = threading.Lock()
        self._metrics = {op: _OpMetrics(registry, OP_LABELS[op])
                         for op in SERVING_OPS}
        self._queues = {
            op: AdmissionQueue(cap_rows=queue_cap, policy=policy,
                               max_batch=self.max_batch, flush_us=flush_us,
                               tenant_quota_rows=tenant_quota_rows,
                               registry=registry, label=OP_LABELS[op])
            for op in SERVING_OPS
        }
        self._dispatcher = PipelinedDispatcher(registry=registry)
        # watchdog_s > 0 arms the dispatch watchdog: a device call that
        # wedges the dispatch thread past the deadline fails its batch's
        # futures with DeadlineExceeded and a fresh thread takes over —
        # the hung-device single point of failure the resilience layer
        # exists for (lazy import: healthy nodes without the knob never
        # load the monitor)
        self._watchdog = None
        if watchdog_s > 0:
            from gethsharding_tpu_torch.resilience.watchdog import DispatchWatchdog

            self._watchdog = DispatchWatchdog(
                self._dispatcher, deadline_s=watchdog_s, registry=registry)
        self._flushers: List[threading.Thread] = []
        self._closed = False
        for op in SERVING_OPS:
            thread = threading.Thread(
                target=self._flush_loop, args=(op,),
                name=f"serving-flush-{OP_LABELS[op]}", daemon=True)
            self._flushers.append(thread)
            thread.start()

    # -- producer ----------------------------------------------------------

    def submit(self, op: str, args: Sequence[Sequence], rows: int,
               klass: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one request; returns the future of its per-row results.
        `klass`/`tenant` override the thread's `admission_class` context
        and the per-op default (serving/classes.py)."""
        if op not in SERVING_OPS:
            raise ValueError(f"unknown serving op {op!r}; "
                             f"choose from {SERVING_OPS}")
        if self._closed:
            raise QueueClosed("serving batcher is closed")
        for column in args:
            if len(column) != rows:
                # reject HERE: a short column concatenated into a
                # coalesced batch would misalign every batch-mate's rows
                raise ValueError(
                    f"{op}: column of {len(column)} rows in a "
                    f"{rows}-row request")
        klass = class_for(op, klass)
        if tenant is None:
            tenant = current_admission()[1] or ""
        met = self._metrics[op]
        met.requests.inc()
        met.request_rows.inc(rows)
        met.class_requests[klass].inc()
        if rows == 0:
            # nothing to coalesce; resolve without touching the queue so
            # empty probes can't occupy flush windows
            future: Future = Future()
            future.set_result([])
            return future
        request = Request(op, tuple(args), rows, klass=klass, tenant=tenant)
        # trace stitching: the caller's active span (a
        # notary phase) becomes the parent of this request's lifecycle
        # spans, recorded later from the flusher/dispatch threads. ONE
        # attribute read when tracing is off.
        request.trace_ctx = tracing.request_context()
        if tracing.TRACER.enabled:
            # let the caller-side wake observer find the request again
            request.future._serving_request = request
        queue = self._queues[op]
        try:
            queue.put(request)
        except (QueueClosed, TenantQuotaExceeded):
            # counted by the queue's own quota/lifecycle accounting —
            # folding them into the shed rate would read as capacity
            # overload that never happened
            raise
        except ServingOverloadError:
            met.shed.inc()
            # a shed IS an availability event: the class's error budget
            # pays for it even though no device dispatch ever ran
            slo.record(klass, ok=False)
            raise
        met.queue_depth.set(queue.depth_rows)
        met.class_depth[klass].set(queue.class_depth_rows(klass))
        return request.future

    # -- consumer ----------------------------------------------------------

    def _flush_loop(self, op: str) -> None:
        queue = self._queues[op]
        met = self._metrics[op]
        while True:
            batch, reason = queue.take_batch()
            if batch is None:
                return
            met.queue_depth.set(queue.depth_rows)
            for klass in ADMISSION_CLASSES:
                met.class_depth[klass].set(queue.class_depth_rows(klass))
            if reason == AdmissionQueue.FLUSH_FULL:
                met.flush_full.inc()
            elif reason == AdmissionQueue.FLUSH_DEADLINE:
                met.flush_deadline.inc()
            try:
                now = time.monotonic()
                rows = 0
                traced = tracing.TRACER.enabled
                for request in batch:
                    wait_s = request.wait_s(now)
                    met.wait_time.observe(wait_s)
                    met.class_wait[request.klass].observe(wait_s)
                    rows += request.rows
                    if traced:
                        request.t_taken = now  # queue_wait ends here
                met.batch_rows.observe(rows)
                # host-side aggregation HERE, on the flusher thread: the
                # dispatch thread may still be executing the previous
                # batch (the double-buffer overlap pipeline.py documents)
                n_args = len(batch[0].args)
                cols = tuple(
                    [row for request in batch for row in request.args[i]]
                    for i in range(n_args))
                if traced:
                    # batch_assembly ends HERE, before the (possibly
                    # blocking) double-buffer handoff: a stall waiting
                    # for a free dispatch slot is the device's pace, so
                    # it belongs to the device_dispatch phase, not to
                    # host-side assembly
                    t_assembled = time.monotonic()
                    for request in batch:
                        request.t_dispatch = t_assembled
                self._dispatcher.submit(
                    lambda batch=batch, cols=cols, rows=rows, reason=reason:
                    self._run_batch(op, batch, cols, rows, reason),
                    fail=lambda exc, batch=batch:
                    self._fail_batch(batch, exc))
            except Exception as exc:  # noqa: BLE001 - a malformed batch
                # must fail ITS futures, not kill the op's only consumer
                # (a dead flusher would hang every later caller forever)
                self._fail_batch(batch, exc)

    def _run_batch(self, op: str, batch: List[Request], cols: tuple,
                   rows: int, reason: str = "") -> None:
        """Stage 2 (dispatch thread): one inner-backend call, results
        sliced back out per request."""
        met = self._metrics[op]
        traced = tracing.TRACER.enabled
        try:
            with met.dispatch_latency.time():
                # ensure_host: the dispatch-latency clock must close
                # over a HOST value — a backend handing back a CUDA
                # tensor is pulled here, so the serving timing site
                # cannot stop at the kernel's enqueue
                out = list(ensure_host(self._dispatch(op, cols), op=op))
            if len(out) != rows:
                raise RuntimeError(
                    f"{op} returned {len(out)} results for {rows} rows")
        except Exception as exc:  # noqa: BLE001 - fail the batch, keep serving
            if traced:
                # errored requests are the ones most worth attributing:
                # emit their spans (error-tagged) before failing them
                t_done = time.monotonic()
                wire = self._wire_bytes(op, cols)
                for request in batch:
                    if request.t_taken and request.t_dispatch:
                        request.t_done = t_done
                        self._emit_request_trace(op, request, reason, rows,
                                                 wire_bytes=wire,
                                                 error=repr(exc))
            self._fail_batch(batch, exc)
            return
        with self._counts_lock:
            self.dispatch_counts[op] += 1
        met.dispatches.inc()
        t_done = time.monotonic()
        if traced:
            # emit BEFORE resolving the futures so a waking caller reads
            # complete trace_ids for its future_wake span
            wire = self._wire_bytes(op, cols)
            for request in batch:
                if request.t_taken and request.t_dispatch:
                    request.t_done = t_done
                    self._emit_request_trace(op, request, reason, rows,
                                             wire_bytes=wire)
        offset = 0
        for request in batch:
            # done() guard: the watchdog (or shutdown) may have failed
            # this batch's futures already — a late device completion
            # must not raise InvalidStateError over them
            if not request.future.done():
                request.future.set_result(out[offset:offset + request.rows])
                # the per-class SLO event: one good/bad mark per request
                # with its end-to-end serving latency (enqueue -> result
                # set) — watchdog-failed requests were already marked
                # bad by their _fail_batch
                slo.record(request.klass, ok=True,
                           latency_s=t_done - request.enqueued_at)
            offset += request.rows

    def _fail_batch(self, batch: List[Request],
                    exc: BaseException) -> None:
        """Fail every still-pending future in `batch` — the shared
        failure channel of the dispatch error path, the watchdog abort
        and the drain-and-fail shutdown. Each newly-failed request
        charges its class's SLO error budget exactly once."""
        for request in batch:
            if not request.future.done():
                request.future.set_exception(exc)
                slo.record(request.klass, ok=False)

    # the ops whose dispatch refreshes `TorchSigBackend.last_wire` — for
    # any other op the ledger is a STALE leftover from a previous
    # dispatch and must not be trusted
    _LEDGER_OPS = ("das_verify_samples", "das_verify_multiproofs")

    def _wire_bytes(self, op: str, cols: tuple) -> int:
        """This dispatch's host->device wire bytes for span tags: the
        backend's own per-dispatch ledger when THIS op writes one (the
        DAS paths — we read it right after the dispatch on the single
        dispatch thread, so it is this dispatch's entry),
        else the payload bytes of the batch columns (bytes-like rows
        one level deep) — computed only when tracing is on."""
        if op in self._LEDGER_OPS:
            wire = getattr(self.inner, "last_wire", None)
            if wire:
                return int(wire.get("wire_bytes", 0))
        total = 0
        for col in cols:
            for item in col:
                if isinstance(item, (bytes, bytearray, memoryview)):
                    total += len(item)
                elif isinstance(item, (list, tuple)):
                    total += sum(len(leaf) for leaf in item
                                 if isinstance(leaf, (bytes, bytearray,
                                                      memoryview)))
        return total

    def _emit_request_trace(self, op: str, request: Request, reason: str,
                            batch_rows: int, wire_bytes: int = 0,
                            error: str = None) -> None:
        """One request's lifecycle as spans: the parent request span
        decomposes EXACTLY into contiguous queue_wait / batch_assembly /
        device_dispatch children (shared boundary timestamps, so the
        children sum to the parent by construction). device_dispatch
        runs from the end of host-side assembly, so a flusher stall on
        the double-buffer slot — the device's pace — is attributed to
        the device phase, not to assembly. Recorded under the request's
        own trace id as the display track (tid) so every coalesced
        request renders as its own Perfetto row; stitched to the
        submitting caller's span when one was active."""
        tracer = tracing.TRACER
        label = OP_LABELS[op]
        ctx = request.trace_ctx
        trace_id = ctx[0] if ctx else tracer.new_trace_id()
        parent = ctx[1] if ctx else None
        # device-time attribution rides the spans: device_ms is the
        # dispatch phase of THIS request, wire_bytes/batch_rows the
        # whole coalesced dispatch it shared
        device_ms = round((request.t_done - request.t_dispatch) * 1e3, 3)
        tags = {"rows": request.rows, "batch_rows": batch_rows,
                "flush": reason, "klass": request.klass,
                "device_ms": device_ms, "wire_bytes": wire_bytes}
        if error is not None:
            tags["error"] = error
        root = tracer.record(
            f"serving/{label}/request", request.enqueued_at, request.t_done,
            trace_id=trace_id, parent_id=parent, tags=tags, tid=trace_id)
        for name, start, end in (
                ("queue_wait", request.enqueued_at, request.t_taken),
                ("batch_assembly", request.t_taken, request.t_dispatch),
                ("device_dispatch", request.t_dispatch, request.t_done)):
            phase_tags = None
            if name == "device_dispatch":
                phase_tags = {"device_ms": device_ms,
                              "wire_bytes": wire_bytes,
                              "marshal_ms": round(
                                  (request.t_dispatch - request.t_taken)
                                  * 1e3, 3)}
            tracer.record(f"serving/{label}/{name}", start, end,
                          trace_id=trace_id, parent_id=root, tid=trace_id,
                          tags=phase_tags)
        request.trace_ids = (trace_id, root, label)

    def _dispatch(self, op: str, cols: tuple):
        if op == "bls_verify_committees":
            messages, sig_rows, pk_rows, keys = cols
            if any(key is not None for key in keys):
                return self.inner.bls_verify_committees(
                    messages, sig_rows, pk_rows, pk_row_keys=keys)
            return self.inner.bls_verify_committees(
                messages, sig_rows, pk_rows)
        return getattr(self.inner, op)(*cols)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Drain queued requests, stop the flushers and the dispatcher."""
        if self._closed:
            return
        self._closed = True
        for queue in self._queues.values():
            queue.close()
        for thread in self._flushers:
            thread.join(timeout=10.0)
        if self._watchdog is not None:
            # the watchdog first: a restart racing the dispatcher's own
            # drain-and-fail close would fail batches twice
            self._watchdog.close()
        self._dispatcher.close(wait=True)

    # -- observability -----------------------------------------------------

    def shed_counts(self) -> Dict[str, int]:
        return {op: queue.shed_requests
                for op, queue in self._queues.items()}


def observe_future_wake(future) -> None:
    """Record the ``future_wake`` phase for a resolved serving future:
    result-set on the dispatch thread -> the waiting caller actually
    resumed. Called by the sync `SigBackend` faces and the notary right
    after ``future.result()`` returns; a no-op when tracing is
    off or the future did not come from a traced request."""
    tracer = tracing.TRACER
    if not tracer.enabled:
        return
    request = getattr(future, "_serving_request", None)
    if request is None or request.trace_ids is None:
        return
    trace_id, root, label = request.trace_ids
    tracer.record(f"serving/{label}/future_wake", request.t_done,
                  time.monotonic(), trace_id=trace_id, parent_id=root,
                  tid=trace_id, tags={"klass": request.klass})
