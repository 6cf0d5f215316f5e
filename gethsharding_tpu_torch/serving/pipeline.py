"""Double-buffered dispatch: overlap host work for batch N+1 with N (the
port's copy of the JAX package's `serving/pipeline.py`).

The serving tier splits each flush into two stages on two threads:

- the per-op FLUSHER thread drains the admission queue and does the
  host-side aggregation — concatenating the coalesced requests' rows
  into one set of batch columns (and, inside the wrapped backend, the
  limb marshalling + bucket padding);
- ONE shared DISPATCH thread drives the device.

`PipelinedDispatcher` is the handoff between them: a depth-1 queue of
ready batches. While the dispatch thread executes batch N, the flusher
drains and assembles batch N+1 and parks it in the slot — the double
buffer. A third batch blocks the flusher, which in turn lets the
admission queue fill, which is exactly the backpressure chain we want:
the device's pace propagates to callers instead of batches piling up
in unbounded memory.

One dispatcher is shared by ALL operation flushers on purpose — there
is one device, and serializing dispatches through a single thread keeps
the dispatch timeline observable (a per-op thread pool would just move
the serialization to the backend's lock with worse fairness). Kernels
launch on the dispatch thread's current stream, which is the default
stream: no serving thread sets another, and only host rows (bytes,
points) cross threads, never a device tensor.

Resilience contract (`resilience/`): the single dispatch
thread is also a single point of failure, so

- `submit(fn, fail=...)` can attach a failure channel — a callable
  that fails the batch's futures with a given exception — so work the
  thread never gets to run can still be resolved deterministically;
- `fail_current(exc)` (driven by `resilience.watchdog`) abandons a
  HUNG in-flight batch: its futures fail with the watchdog's
  `DeadlineExceeded`, and a FRESH dispatch thread takes over the
  ready queue. Threads carry a generation token (a restarted thread is
  named ``<name>-<generation>``); the stuck thread notices it was
  superseded when its device call finally returns, and exits. At most
  `MAX_ABANDONED` abandoned threads may still be inside their calls: past
  that, a fail starts no fresh thread, and the first abandoned thread
  whose call returns serves on as the live one. A hang that every
  thread meets (inside the backend's lock) so holds a bounded number of
  threads, not one more per deadline.
- `close(wait=True)` stops accepting, gives in-flight work a bounded
  grace to drain, then drain-AND-FAILS whatever is still queued (a
  `DispatcherClosed` into each batch's futures) — queued work never
  hangs across shutdown, even when the pipeline is wedged.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional, Tuple

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.resilience.errors import DispatcherClosed

log = logging.getLogger("serving.pipeline")

FailFn = Callable[[BaseException], None]

# abandoned dispatch threads that may still be inside their calls before
# a watchdog fail stops starting fresh ones
MAX_ABANDONED = 4


class PipelinedDispatcher:
    """A single dispatch thread behind a bounded ready-batch slot.

    `submit(fn)` parks a zero-arg callable (a fully assembled batch
    bound to its requests' futures) and returns as soon as the slot has
    room; the dispatch thread runs callables in submission order. The
    callable owns its own error handling (it must route failures to its
    batch's futures) — a raise here would mean requests hang, so the
    run loop also backstops unexpected escapes. The optional `fail`
    companion is the out-of-band failure channel the watchdog and the
    shutdown path use when the callable can never (or must not) run.
    """

    _SENTINEL = None

    def __init__(self, name: str = "serving-dispatch", depth: int = 1,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        # depth 1 = classic double buffering: one batch executing, one
        # assembled and waiting
        self._name = name
        self._ready: "queue.Queue[Optional[Tuple]]" = (
            queue.Queue(maxsize=max(1, depth)))
        # how long the FLUSHER stalls waiting for a free buffer slot —
        # nonzero means the device is the bottleneck (the backpressure
        # edge is engaged), zero means traffic is arrival-bound
        self._m_slot_wait = registry.timer("serving/pipeline/slot_wait")
        self._m_aborted = registry.counter("serving/pipeline/aborted_batches")
        # generation token: incremented each time the live thread is
        # declared dead (watchdog) so a superseded thread can tell
        self._gen = 0
        self._cur_lock = threading.Lock()
        self._current: Optional[Tuple] = None  # (entry, started_at, gen)
        # threads abandoned by fail_current, and whether no live thread
        # serves the queue (the cap above held a fresh one back)
        self._abandoned: list = []
        self._orphaned = False
        # _closed BEFORE the thread starts: the run loop reads it at the
        # top of every iteration
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, args=(0,), name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], None],
               fail: Optional[FailFn] = None) -> None:
        """Hand one assembled batch to the dispatch thread (blocks while
        both buffers are busy — the backpressure edge). `fail(exc)` must
        fail the batch's futures; it is invoked INSTEAD of `fn` if the
        batch is abandoned (watchdog restart, shutdown)."""
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        t0 = time.monotonic()
        self._ready.put((fn, fail))
        self._m_slot_wait.observe(time.monotonic() - t0)
        if self._closed:
            # close() raced our blocking put: its drain-and-fail pass
            # may already have emptied the queue, so nothing would ever
            # consume the entry we just parked — drain it (and anything
            # else left) ourselves rather than let its futures hang
            self._drain_and_fail(
                DispatcherClosed("dispatcher closed while this batch "
                                 "was being submitted"))

    # -- watchdog surface --------------------------------------------------

    def current_batch_age(self) -> Optional[float]:
        """Seconds the in-flight batch has been executing (None: idle)."""
        with self._cur_lock:
            if self._current is None:
                return None
            return time.monotonic() - self._current[1]

    def fail_current(self, exc: BaseException,
                     min_age_s: float = 0.0) -> bool:
        """Abandon the in-flight batch: fail its futures with `exc` and
        hand the ready queue to a FRESH dispatch thread. Returns True
        when a batch was actually abandoned. The stuck thread is left
        to die on its own (it is daemon and blocked inside the device
        call); when that call finally returns it sees its generation
        superseded and exits without touching the queue's work.

        `min_age_s` makes the caller's observe-then-abandon atomic: a
        watchdog that saw a hung batch outside the lock may be racing
        its completion — if a DIFFERENT, fresh batch is in flight by
        the time the lock is held, abandoning it would fail healthy
        work and feed a spurious fault to the breaker."""
        with self._cur_lock:
            current = self._current
            if current is None:
                return False
            entry, started_at, gen = current
            if gen != self._gen:
                return False  # already superseded
            if time.monotonic() - started_at < min_age_s:
                return False  # not the hung batch the caller observed
            self._gen += 1
            self._current = None
            self._abandoned = [t for t in self._abandoned if t.is_alive()]
            self._abandoned.append(self._thread)
            if not self._closed and len(self._abandoned) <= MAX_ABANDONED:
                self._thread = threading.Thread(
                    target=self._run, args=(self._gen,),
                    name=f"{self._name}-{self._gen}", daemon=True)
                self._thread.start()
            elif not self._closed:
                self._orphaned = True
                log.error("%d abandoned dispatch threads are still inside "
                          "their calls: no fresh thread; the first to "
                          "return serves on", len(self._abandoned))
        self._m_aborted.inc()
        self._fail_entry(entry, exc)
        return True

    # -- lifecycle ---------------------------------------------------------

    def close(self, wait: bool = True, grace_s: float = 10.0) -> None:
        """Stop accepting; drain in-flight work within `grace_s`, then
        deterministically FAIL whatever is still pending. Healthy path:
        the sentinel lands behind already-submitted batches, they run,
        the thread exits, nothing is left to fail. Wedged path: the
        sentinel can't even be queued (or the thread never exits) — the
        in-flight batch and every queued batch get `DispatcherClosed`
        so no caller hangs across shutdown."""
        if self._closed:
            return
        self._closed = True
        try:
            # bounded: while batches drain normally the slot frees within
            # the grace; a wedged pipeline leaves the slot full forever
            self._ready.put(self._SENTINEL,
                            timeout=grace_s if wait else 0.001)
        except queue.Full:
            pass
        if not wait:
            # fire-and-forget close keeps its old contract: submitted
            # work is left to complete on its own; only a WAITED close
            # escalates to drain-and-fail. (Even when the sentinel put
            # was dropped on a full queue, the run loop notices
            # _closed once the queue drains and exits on its own.)
            return
        self._thread.join(timeout=grace_s)
        if self._thread.is_alive():
            # wedged in-flight batch: its callers unblock too (no
            # replacement thread is spawned once closed)
            self.fail_current(
                DispatcherClosed("dispatcher closed while its batch was "
                                 "still executing"))
        self._drain_and_fail(
            DispatcherClosed("dispatcher closed before this batch was "
                             "dispatched"))

    def _drain_and_fail(self, exc: BaseException) -> None:
        """Empty the ready queue, failing every batch's futures with
        `exc` — nothing queued may hang once no thread will serve it."""
        while True:
            try:
                entry = self._ready.get_nowait()
            except queue.Empty:
                return
            if entry is self._SENTINEL:
                continue
            self._fail_entry(entry, exc)

    @staticmethod
    def _fail_entry(entry: Tuple, exc: BaseException) -> None:
        _fn, fail = entry
        if fail is None:
            log.error("abandoned batch had no failure channel: %s", exc)
            return
        try:
            fail(exc)
        except Exception:  # noqa: BLE001 - shutdown must keep going
            log.exception("batch failure channel raised")

    def _run(self, gen: int) -> None:
        while True:
            if self._closed:
                # a sentinel dropped on a full queue at close time must
                # not leak this thread: once closed, keep draining (by
                # running — the healthy-close contract) and exit the
                # moment the queue is empty instead of blocking in get()
                try:
                    entry = self._ready.get_nowait()
                except queue.Empty:
                    return
            else:
                entry = self._ready.get()
            # no stale-generation check here on purpose: _gen only
            # advances through fail_current, which requires an in-flight
            # _current record carrying the LIVE generation — and
            # _current is always None while this thread waits in get(),
            # so a thread that just popped an entry is the live one (a
            # superseded thread exits at the bottom-of-loop check and
            # never re-enters get())
            if entry is self._SENTINEL:
                return
            fn, _fail = entry
            with self._cur_lock:
                self._current = (entry, time.monotonic(), gen)
            try:
                fn()
            except Exception:  # noqa: BLE001 - futures already failed; keep serving
                log.exception("dispatch batch escaped its error handler")
            finally:
                with self._cur_lock:
                    # only OUR batch record: a watchdog restart may have
                    # installed the live thread's batch meanwhile
                    if self._current is not None and self._current[2] == gen:
                        self._current = None
            if self._gen != gen:
                with self._cur_lock:
                    if not self._orphaned:
                        # abandoned mid-execution: the live thread serves
                        return
                    # no live thread: this one serves on as the live one
                    self._orphaned = False
                    gen = self._gen
                    me = threading.current_thread()
                    self._abandoned.remove(me)
                    self._thread = me
