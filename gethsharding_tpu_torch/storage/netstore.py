"""Networked chunk store: content retrieval between nodes over shardp2p
(the port's copy of the JAX package's `storage/netstore.py`; parity
`swarm/storage/netstore.go:1`).

A NetStore fronts a local `ChunkStore` with a network fetcher, the pull
model of `netstore.go:188` + `swarm/network/fetcher.go` on the shardp2p
typed-message plane:

- `ChunkRequest(key)` is broadcast to peers; any node holding the chunk
  answers the requesting peer directly with `ChunkDelivery(key, span,
  payload)`;
- every incoming delivery is verified content-addressed —
  `chunk_key(span, payload)` must equal the claimed key — and must have
  been solicited before it lands in the local store, so a malicious peer
  can waste a request but never poison content or grow the store;
- `retrieve(root)` walks the chunk tree exactly like
  `ChunkStore.retrieve`, faulting each missing chunk in from the network.

Sizes are bounded by construction: every legal chunk payload (leaf data
or a 128-key interior node) is <= 4096 bytes; oversized deliveries are
dropped at the handler.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.p2p.service import Message, P2PServer
from gethsharding_tpu_torch.resilience.errors import (FetchAborted,
                                                      TransientError)
from gethsharding_tpu_torch.resilience.policy import (POLL_MISS,
                                                      RetryExecutor,
                                                      RetryPolicy,
                                                      poll_probe)
from gethsharding_tpu_torch.storage.chunker import (
    CHUNK_SIZE, ChunkStore, ChunkStoreError, chunk_key)


class _ChunkMiss(TransientError):
    """No peer delivered the chunk within one fetch attempt."""


@dataclass(frozen=True)
class ChunkRequest:
    """Who has this chunk? (fetcher broadcast)"""

    key: bytes


@dataclass(frozen=True)
class ChunkDelivery:
    """A chunk, delivered to the requesting peer."""

    key: bytes
    span: int
    payload: bytes


class NetStore(Service):
    """Local ChunkStore + shardp2p fetcher/server (netstore.go role)."""

    name = "netstore"
    supervisable = True

    def __init__(self, store: Optional[ChunkStore] = None,
                 p2p: Optional[P2PServer] = None,
                 poll_interval: float = 0.02,
                 fetch_timeout: float = 3.0,
                 fetch_attempts: int = 3):
        super().__init__()
        self.store = store if store is not None else ChunkStore()
        self.p2p = p2p
        self.poll_interval = poll_interval
        self.fetch_timeout = fetch_timeout
        # network-fetch retry seam (resilience/policy): each attempt
        # RE-BROADCASTS the chunk request — a dropped request frame or a
        # briefly partitioned holder costs one capped backoff instead of
        # failing the whole retrieval; retries/giveups are counted under
        # resilience/retry/netstore/*. The attempts SHARE the
        # fetch_timeout budget (per-attempt wait = timeout / attempts),
        # so callers that tuned fetch_timeout keep their worst-case
        # latency — the retries buy re-broadcasts, not extra waiting.
        self._attempt_timeout = fetch_timeout / max(1, fetch_attempts)
        self._fetch_retry = RetryExecutor(
            "netstore",
            RetryPolicy(attempts=max(1, fetch_attempts),
                        base_s=poll_interval, cap_s=0.25,
                        deadline_s=fetch_timeout,
                        retryable=(_ChunkMiss,)))
        self.chunks_served = 0
        self.chunks_fetched = 0
        self.deliveries_rejected = 0
        self._req_sub = None
        self._del_sub = None
        # keys with an open fetch: only SOLICITED deliveries are stored
        # (the reference NetStore admits chunks through open fetchers
        # only — without this, any peer could grow the local store with
        # self-consistent junk chunks forever)
        self._fetching: set = set()
        self._fetch_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.p2p is None:
            return  # purely local store: nothing to serve or fetch
        self.p2p.start()  # attach: a server only serving must still RECEIVE
        self._req_sub = self.p2p.subscribe(ChunkRequest)
        self._del_sub = self.p2p.subscribe(ChunkDelivery)
        self.spawn(self._handle_requests, name="netstore-requests")
        self.spawn(self._handle_deliveries, name="netstore-deliveries")

    def on_stop(self) -> None:
        for sub in (self._req_sub, self._del_sub):
            if sub is not None:
                sub.unsubscribe()

    # -- serving side ------------------------------------------------------

    def _handle_requests(self) -> None:
        while not self.stopped():
            msg = self._next(self._req_sub)
            if msg is None:
                continue
            try:
                span, payload = self.store.chunk(bytes(msg.data.key))
            except ChunkStoreError:
                continue  # not ours to serve
            self.p2p.send(ChunkDelivery(key=bytes(msg.data.key), span=span,
                                        payload=payload), msg.peer)
            self.chunks_served += 1

    def _handle_deliveries(self) -> None:
        while not self.stopped():
            msg = self._next(self._del_sub)
            if msg is None:
                continue
            key = bytes(msg.data.key)
            span = int(msg.data.span)
            payload = bytes(msg.data.payload)
            with self._fetch_lock:
                solicited = key in self._fetching
            # content-addressing IS the authentication: a delivery whose
            # key does not commit to (span, payload) is discarded — and
            # span must be a valid u64 BEFORE chunk_key packs it, or a
            # hostile frame would crash this loop for good
            if (not solicited or len(payload) > CHUNK_SIZE
                    or not 0 <= span < (1 << 64)
                    or chunk_key(span, payload) != key):
                self.deliveries_rejected += 1
                continue
            self.store.put_chunk(span, payload)
            self.chunks_fetched += 1

    def _next(self, sub) -> Optional[Message]:
        try:
            return sub.get(timeout=self.poll_interval)
        except Exception:
            return None

    # -- fetching side -----------------------------------------------------

    def get_chunk(self, key: bytes) -> tuple:
        """(span, payload) — local store first, then the network (each
        retry attempt re-broadcasts the request under the fetch retry
        policy)."""
        try:
            return self.store.chunk(key)
        except ChunkStoreError:
            pass
        if self.p2p is None or self.stopped():
            raise ChunkStoreError(f"missing chunk {key.hex()} (offline)")
        key = bytes(key)

        def attempt() -> tuple:
            self.p2p.broadcast(ChunkRequest(key=key))
            got = poll_probe(
                lambda: self.store.chunk(key), self.wait,
                interval_s=self.poll_interval,
                polls=int(self._attempt_timeout / self.poll_interval),
                not_ready=(ChunkStoreError,))
            if got is POLL_MISS:
                raise _ChunkMiss(f"chunk {key.hex()} not delivered")
            return got

        with self._fetch_lock:
            self._fetching.add(key)
        try:
            return self._fetch_retry.call(attempt)
        except (_ChunkMiss, FetchAborted):
            raise ChunkStoreError(
                f"chunk {key.hex()} unavailable on the network") from None
        finally:
            with self._fetch_lock:
                self._fetching.discard(key)

    def store_content(self, data: bytes) -> bytes:
        """Publish content locally; peers pull chunks on demand (the
        swarm pull-sync model). Returns the 32-byte root key."""
        return self.store.store(data)

    def retrieve(self, root: bytes) -> bytes:
        """Reassemble + verify content under `root`, faulting missing
        chunks in from peers — ChunkStore's ONE tree walk with this
        store's network-faulting chunk reader plugged in."""
        return self.store.retrieve(root, fetch=self.get_chunk)
