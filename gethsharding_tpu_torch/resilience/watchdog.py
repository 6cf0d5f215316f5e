"""Dispatch watchdog: a hung device dispatch must fail, not hang (the
port's copy of the JAX package's `resilience/watchdog.py`).

The serving tier funnels every device call through ONE dispatch thread
(`serving/pipeline.PipelinedDispatcher`). That thread is a single
point of failure: a wedged call (a stalled device call, a chaos hang)
blocks the thread forever, every queued batch behind it, and every
caller parked on a future — the notary silently stops voting.

`DispatchWatchdog` is a monitor thread over the dispatcher's in-flight
batch. When the batch's age crosses `deadline_s` it calls
`dispatcher.fail_current(DeadlineExceeded(...))`, which

- fails the stuck batch's futures (callers already handle errored
  batches per the serving contract — and a `FailoverSigBackend` above
  counts the `DeadlineExceeded` as a primary fault, feeding the
  breaker);
- hands the ready-batch queue to a FRESH dispatch thread so the next
  batch serves immediately (the stuck thread is daemon; it notices it
  was superseded when its device call finally returns and exits).

On the card the watchdog frees the host thread only: a CUDA kernel
cannot be abandoned. The kernels the hung thread already queued still
run to their end, and the fresh thread's launches queue behind them on
the same (default) stream, so a kernel that truly never ends stalls the
fresh thread's work too. What the watchdog recovers from is a hang
OUTSIDE the backend's lock, such as the chaos ``dispatch.<op>`` rule's
sleep, which comes before the inner call. `TorchSigBackend` holds one
lock over a call's staging and launches, and on the sample and
multiproof paths over the synchronize and readback too: a call that
hangs inside it (a wedged kernel, a stalled marshal) keeps the lock, so
the fresh thread blocks on it behind the stale one, its batch fails at
the next deadline, and so on. The dispatcher bounds that pile-up
(`serving/pipeline.MAX_ABANDONED`); it does not cure it.

Counters: ``resilience/watchdog/timeouts`` / ``/restarts``. The
optional `on_timeout` hook is for wiring that wants the event
directly (the exception path through the failover face needs nothing).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.resilience.errors import DeadlineExceeded

log = logging.getLogger("resilience.watchdog")


class DispatchWatchdog:
    """Deadline monitor + restarter for a `PipelinedDispatcher`."""

    def __init__(self, dispatcher, deadline_s: float = 5.0,
                 poll_s: Optional[float] = None,
                 on_timeout: Optional[Callable[[], None]] = None,
                 name: str = "serving-watchdog",
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        if deadline_s <= 0:
            raise ValueError("watchdog deadline must be positive")
        self.dispatcher = dispatcher
        self.deadline_s = deadline_s
        # poll fast enough that a hang is declared well inside ~1.25x
        # the deadline, slow enough to cost nothing when healthy
        self.poll_s = poll_s if poll_s is not None \
            else max(0.005, deadline_s / 4.0)
        self.on_timeout = on_timeout
        self.timeouts = 0
        self._m_timeouts = registry.counter("resilience/watchdog/timeouts")
        self._m_restarts = registry.counter("resilience/watchdog/restarts")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the MONITOR must outlive
                # its own failures (e.g. thread-spawn exhaustion inside
                # fail_current on a degraded host): a dead watchdog is a
                # silent return to the unmonitored hang it exists to
                # prevent
                log.exception("watchdog tick failed; monitor continues")

    def _tick(self) -> None:
        age = self.dispatcher.current_batch_age()
        if age is None or age <= self.deadline_s:
            return
        exc = DeadlineExceeded(
            f"device dispatch hung for {age:.3f}s "
            f"(deadline {self.deadline_s:.3f}s); batch abandoned "
            f"and dispatcher restarted")
        # min_age_s closes the observe-then-abandon race: if the hung
        # batch completed and a fresh one started since the age read,
        # the fresh batch's age is under the deadline and survives
        if self.dispatcher.fail_current(exc, min_age_s=self.deadline_s):
            self.timeouts += 1
            self._m_timeouts.inc()
            self._m_restarts.inc()
            # a hung dispatch is exactly what the black box exists for:
            # freeze the last-N events/spans/wire ledgers to disk
            RECORDER.trigger("watchdog_timeout", dump=True,
                             age_s=round(age, 3),
                             deadline_s=self.deadline_s)
            log.error("dispatch watchdog fired: %s", exc)
            if self.on_timeout is not None:
                try:
                    self.on_timeout()
                except Exception:  # noqa: BLE001 - hook must not kill us
                    log.exception("watchdog on_timeout hook failed")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
