"""Typed event feeds: the in-process pub/sub backbone (the port's copy
of the JAX package's `p2p/feed.py`).

Parity with `event/feed.go` (Feed.Subscribe/Send) and the per-type feed map
in `sharding/p2p/feed.go:27`: a Feed fans a posted value out to every
subscriber's queue; Subscription supports unsubscribe and iteration with
timeouts (services poll with their shutdown event).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, List, Optional


class Subscription:
    def __init__(self, feed: "Feed", maxsize: int = 1024):
        self._feed = feed
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)
        self.active = True

    def deliver(self, item: Any) -> None:
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            # drop-oldest policy keeps slow consumers from blocking the bus
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                pass

    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocking receive; raises queue.Empty on timeout."""
        return self._queue.get(timeout=timeout)

    def try_get(self) -> Optional[Any]:
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def unsubscribe(self) -> None:
        self.active = False
        self._feed._remove(self)


class Feed:
    """Fan-out channel: every send reaches all active subscribers."""

    def __init__(self):
        self._subs: List[Subscription] = []
        self._lock = threading.Lock()

    def subscribe(self, maxsize: int = 1024) -> Subscription:
        sub = Subscription(self, maxsize=maxsize)
        with self._lock:
            self._subs.append(sub)
        return sub

    def _remove(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def send(self, item: Any) -> int:
        """Deliver to all subscribers; returns the number reached."""
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            sub.deliver(item)
        return len(subs)

    @property
    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)
