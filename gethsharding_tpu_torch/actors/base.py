"""Service base: lifecycle and the error funnel (the port's copy of the
JAX package's `actors/base.py`; its background loops, `spawn`, come with
the first port service that runs one).

Parity with the `sharding.Service` contract (`sharding/interfaces.go:30`)
and `utils.HandleServiceErrors` (`sharding/utils/service.go:11`): services
report failures to an error list (logged, never fatal), and stop via a
shared shutdown event.
"""

from __future__ import annotations

import logging
import threading
from typing import List


class Service:
    """Base lifecycle: start() runs on_start, stop() runs on_stop."""

    name = "service"
    # a supervisor may restart a leaf actor as a fresh instance; services
    # others hold references to (DB, client) stay False
    supervisable = False

    def __init__(self):
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
        self._started = False

    def on_start(self) -> None:  # override
        pass

    def on_stop(self) -> None:  # override
        pass

    @property
    def running(self) -> bool:
        return self._started

    @property
    def crashed(self) -> bool:
        """True when a run of callback failures reached
        FAILURE_THRESHOLD."""
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
