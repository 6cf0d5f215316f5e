"""Service base: lifecycle, background loops and the error funnel (the
port's copy of the JAX package's `actors/base.py`).

Parity with the `sharding.Service` contract (`sharding/interfaces.go:30`)
and `utils.HandleServiceErrors` (`sharding/utils/service.go:11`): services
start loops on threads, report failures to an error list (logged, never
fatal), and stop via a shared shutdown event.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional


class Service:
    """Base lifecycle: start() spawns registered loops, stop() joins them."""

    name = "service"
    # a supervisor may restart a leaf actor as a fresh instance; services
    # others hold references to (DB, client) stay False
    supervisable = False

    def __init__(self):
        self._threads: List[threading.Thread] = []
        self._shutdown = threading.Event()
        self.errors: List[str] = []
        self.log = logging.getLogger(f"sharding.{self.name}")
        self._started = False
        self._crashed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._shutdown.clear()
        self.log.info("Starting %s service", self.name)
        self.on_start()

    def stop(self) -> None:
        if not self._started:
            return
        self.log.info("Stopping %s service", self.name)
        self._shutdown.set()
        self.on_stop()
        for thread in self._threads:
            thread.join(timeout=5.0)
        self._threads.clear()
        self._started = False

    def on_start(self) -> None:  # override
        pass

    def on_stop(self) -> None:  # override
        pass

    @property
    def running(self) -> bool:
        return self._started

    # -- helpers -----------------------------------------------------------

    def spawn(self, target: Callable[[], None],
              name: Optional[str] = None) -> None:
        thread = threading.Thread(
            target=self._guard(target), name=name or f"{self.name}-loop",
            daemon=True,
        )
        self._threads.append(thread)
        thread.start()

    def _guard(self, target: Callable[[], None]) -> Callable[[], None]:
        def runner():
            try:
                target()
            except Exception as exc:  # funnel, never crash the node
                self.record_error(f"{self.name} loop crashed: {exc!r}")
                self._crashed = True

        return runner

    @property
    def crashed(self) -> bool:
        """True when a background loop died on an exception, or a run of
        callback failures reached FAILURE_THRESHOLD (the signal a
        supervisor restarts on); cleared only by a fresh instance."""
        return self._crashed

    # -- callback-driven failure detection ---------------------------------
    # Head-subscription actors like the notary funnel per-callback errors;
    # consecutive failures with no success in between mark the service
    # crashed.

    FAILURE_THRESHOLD = 5

    def record_failure(self, message: str) -> None:
        self.record_error(message)
        self._consecutive_failures = getattr(
            self, "_consecutive_failures", 0) + 1
        if self._consecutive_failures >= self.FAILURE_THRESHOLD:
            self._crashed = True

    def record_success(self) -> None:
        self._consecutive_failures = 0

    def record_error(self, message: str) -> None:
        self.errors.append(message)
        self.log.error(message)

    def stopped(self) -> bool:
        return self._shutdown.is_set()

    def wait(self, timeout: float) -> bool:
        """Sleep that wakes early on shutdown; True if shutting down."""
        return self._shutdown.wait(timeout)
