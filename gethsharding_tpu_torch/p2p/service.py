"""P2P server: typed feeds + directed send + broadcast over a process-local
hub (the port's copy of the JAX package's `p2p/service.py`; the
cross-process `RemoteHub` of `p2p/remote.py` presents the same face).

The reference's shardp2p holds a `map[reflect.Type]*event.Feed` and stubs
out Send/Broadcast (`sharding/p2p/service.go:41-50`). Here the same feed-map
API is kept (`feed(MessageType)`) and the transport intent is implemented:
a `Hub` connects any number of `P2PServer` instances (one per actor/node in
a simulation, or one per process over the RPC bridge later); `send` routes
to one peer, `broadcast` to all others. Messages arrive wrapped in
`Message(peer, data)` so handlers can reply to the requesting peer —
mirroring `p2p.Message{Peer, Data}` (`sharding/p2p/message.go`).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Type

from gethsharding_tpu_torch.p2p.feed import Feed, Subscription

# Protocol identity carried in the cross-process handshake — the
# `p2p.Protocol{Name, Version}` + NetworkId gate of the reference's RLPx
# layer (p2p/protocol.go:26, eth/handler.go status exchange), minus the
# crypto (the relay rides a trusted local RPC link, not the open internet).
PROTOCOL_NAME = "shardp2p"
PROTOCOL_VERSION = 1


@dataclass(frozen=True)
class Peer:
    """Identity of a remote server attached to the same hub."""

    peer_id: int

    def __repr__(self) -> str:  # pragma: no cover
        return f"Peer({self.peer_id})"


@dataclass(frozen=True)
class Message:
    """Envelope delivered to feeds: the sending peer + payload."""

    peer: Peer
    data: Any


class Hub:
    """Process-local interconnect: the 'network' behind P2PServer instances."""

    def __init__(self):
        self._servers: Dict[int, "P2PServer"] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def attach(self, server: "P2PServer") -> Peer:
        with self._lock:
            peer = Peer(next(self._ids))
            self._servers[peer.peer_id] = server
            return peer

    def detach(self, peer: Peer) -> None:
        with self._lock:
            self._servers.pop(peer.peer_id, None)

    def route(self, sender: Peer, target: Peer, data: Any) -> bool:
        with self._lock:
            server = self._servers.get(target.peer_id)
        if server is None:
            return False
        server._deliver(Message(peer=sender, data=data))
        return True

    def broadcast(self, sender: Peer, data: Any) -> int:
        with self._lock:
            targets = [s for pid, s in self._servers.items()
                       if pid != sender.peer_id]
        for server in targets:
            server._deliver(Message(peer=sender, data=data))
        return len(targets)


class P2PServer:
    """Per-node p2p endpoint with typed feeds.

    Lifecycle parity with `sharding/p2p/service.go` (NewServer :23,
    Start/Stop logging-only :28-38): a server is usable as soon as it is
    constructed; start/stop manage hub attachment.
    """

    def __init__(self, hub: Optional[Hub] = None):
        self.hub = hub or Hub()
        self._feeds: Dict[Type, Feed] = {}
        self._lock = threading.Lock()
        self.self_peer: Optional[Peer] = None

    # -- service lifecycle -------------------------------------------------

    def start(self) -> None:
        if self.self_peer is None:
            self.self_peer = self.hub.attach(self)

    def stop(self) -> None:
        if self.self_peer is not None:
            self.hub.detach(self.self_peer)
            self.self_peer = None

    # -- feed map (parity: Feed(msg) sharding/p2p/feed.go:27) --------------

    def feed(self, msg_type: Type) -> Feed:
        with self._lock:
            if msg_type not in self._feeds:
                self._feeds[msg_type] = Feed()
            return self._feeds[msg_type]

    def subscribe(self, msg_type: Type, maxsize: int = 1024) -> Subscription:
        return self.feed(msg_type).subscribe(maxsize=maxsize)

    def _deliver(self, message: Message) -> None:
        feed = self.feed(type(message.data))
        feed.send(message)

    # -- transport ---------------------------------------------------------

    def send(self, data: Any, peer: Peer) -> bool:
        """Directed send to one peer (implements the reference's TODO)."""
        if self.self_peer is None:
            self.start()
        return self.hub.route(self.self_peer, peer, data)

    def broadcast(self, data: Any) -> int:
        """Send to every other server on the hub."""
        if self.self_peer is None:
            self.start()
        return self.hub.broadcast(self.self_peer, data)

    def loopback(self, data: Any) -> None:
        """Inject a message into our own feeds (simulator pattern)."""
        if self.self_peer is None:
            self.start()
        self._deliver(Message(peer=self.self_peer, data=data))
