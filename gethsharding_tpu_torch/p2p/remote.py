"""RemoteHub: the shardp2p feed bus across OS processes (the port's copy of
the JAX package's `p2p/remote.py`).

The in-process `Hub` gives actors typed pub/sub within one process; this
adapter runs the SAME `P2PServer` API across processes, with the role
split of the reference's p2p stack:

- the chain process's relay / standalone bootnode (`rpc/server.py`
  shard_p2p*) is the FIRST-CONTACT tier — authenticated attach and the
  initial peer table (`cmd/bootnode` role);
- ongoing introduction is DECENTRALIZED: signed peer announces +
  liveness-checked gossip over the direct sockets (`p2p/discovery.py` —
  the `p2p/discover` + `p2p/dial.go` + ENR role), so the relay's death
  stops neither directed sends nor broadcasts between introduced peers;
- message payloads flow PEER TO PEER over direct TCP sockets
  (`p2p/direct.py`): mutual secp256k1 authentication and (when the host
  offers AEAD) ephemeral-ECDH AES-256-GCM frames — the RLPx transport
  role (`p2p/rlpx.go:86,178`). Broadcast is a direct fan-out over the
  peer directory; the relay is a per-peer FALLBACK path, not a
  chokepoint.

Attaching REQUIRES an identity: the handshake carries the node's
account and a signature over a relay-issued challenge, so `account` in
the peer table is proven, not claimed. The relay refuses unsigned or
forged attaches; peers refuse direct connections whose account doesn't
match the relay's table or a verified announce. Wire format: the codec
registry in `rpc/codec.py` (type-tagged JSON).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

from gethsharding_tpu_torch.p2p import direct
from gethsharding_tpu_torch.p2p.discovery import (
    PeerDirectory, PeerTableRequest, PeerTableResponse)
from gethsharding_tpu_torch.p2p.service import (
    Message, Peer, PROTOCOL_NAME, PROTOCOL_VERSION)
from gethsharding_tpu_torch.rpc import codec
from gethsharding_tpu_torch.rpc.client import RPCClient

log = logging.getLogger("p2p.remote")

GOSSIP_INTERVAL_S = float(os.environ.get("GETHSHARDING_P2P_GOSSIP_S", "25"))


class RemoteHub:
    """Hub duck-type backed by the chain-process relay + direct sockets.

    One RemoteHub carries ONE attached P2PServer (one actor process); its
    peer id is allocated by the relay and is meaningful across every
    process attached to the same relay.
    """

    def __init__(self, rpc: RPCClient, network_id: Optional[int] = None,
                 accounts=None, account=None):
        self.rpc = rpc
        self.network_id = network_id
        self._server = None
        self._self_peer: Optional[Peer] = None
        self._accounts = accounts      # AccountManager (holds the key)
        self._account = account        # Address20
        self._listener: Optional[direct.PeerListener] = None
        self._dialer: Optional[direct.DirectDialer] = None
        self._peer_info_cache: dict = {}  # peer ids never recycle
        self.directory: Optional[PeerDirectory] = None
        self._gossip_stop = threading.Event()
        self._gossip_thread: Optional[threading.Thread] = None
        rpc.on_notification("shard_p2p", self._on_message)

    @classmethod
    def dial(cls, host: str, port: int,
             network_id: Optional[int] = None,
             accounts=None, account=None) -> "RemoteHub":
        """Dial the relay. The identity (accounts manager + address) can
        also be supplied later via `set_identity` — it must be present by
        the time a P2PServer attaches."""
        return cls(RPCClient(host, port), network_id=network_id,
                   accounts=accounts, account=account)

    def set_identity(self, accounts, account) -> None:
        """Bind the node's key (AccountManager + Address20) used to sign
        the attach and direct-peer handshakes."""
        self._accounts = accounts
        self._account = account

    @property
    def account_hex(self) -> Optional[str]:
        return None if self._account is None else bytes(self._account).hex()

    def close(self) -> None:
        self._gossip_stop.set()
        if self._gossip_thread is not None:
            self._gossip_thread.join(timeout=2.0)
            self._gossip_thread = None
        if self._dialer is not None:
            self._dialer.close()
        if self._listener is not None:
            self._listener.stop()
            self._listener = None
        self.rpc.close()

    def _sign(self, digest: bytes) -> bytes:
        return self._accounts.sign_hash(self._account, digest)

    # -- Hub surface (p2p/service.py) --------------------------------------

    def attach(self, server) -> Peer:
        if self._server is not None:
            raise RuntimeError("RemoteHub carries exactly one P2PServer; "
                               "dial another connection per actor")
        if self._accounts is None or self._account is None:
            raise RuntimeError(
                "p2p identity required: the relay refuses unsigned "
                "attaches (set_identity or dial(accounts=, account=))")
        if self.network_id is None:
            self.network_id = self.rpc.call("shard_networkId")
        # register the delivery target BEFORE the relay learns about the
        # peer: it may start pushing the instant the attach call lands
        self._server = server
        self._listener = direct.PeerListener(
            deliver=self._deliver, resolve=self.peer_info,
            network_id=self.network_id, sign=self._sign,
            account_hex=self.account_hex)
        self._listener.start()
        challenge = bytes.fromhex(self.rpc.call("shard_p2pChallenge"))
        handshake = {
            "protocol": PROTOCOL_NAME,
            "version": PROTOCOL_VERSION,
            "network_id": self.network_id,
            "account": self.account_hex,
            "sig": self._sign(
                direct.attach_digest(self.network_id, challenge)).hex(),
            "endpoint": list(self._listener.address),
        }
        try:
            peer_id = self.rpc.call("shard_p2pAttach", handshake)
        except Exception:
            self._server = None
            self._listener.stop()
            self._listener = None
            raise
        self._dialer = direct.DirectDialer(
            network_id=self.network_id, account_hex=self.account_hex,
            sign=self._sign)
        self._self_peer = Peer(peer_id)
        # decentralized introduction: publish our signed announce, seed
        # the directory from the relay's first-contact table, and start
        # the gossip loop (p2p/discovery.py)
        self.directory = PeerDirectory(self.network_id)
        self.directory.make_self(peer_id, self.account_hex,
                                 self._listener.address, self._sign)
        self._seed_from_relay()
        try:
            # one relay fan-out of our announce so already-attached peers
            # learn us even before their next gossip round
            kind, payload = codec.enc_p2p(
                PeerTableResponse(announces=(self.directory.self_announce,)))
            self.rpc.call("shard_p2pBroadcast", peer_id, kind, payload)
        except Exception:
            pass
        self.gossip_once()
        self._gossip_thread = threading.Thread(
            target=self._gossip_loop, daemon=True, name="p2p-gossip")
        self._gossip_thread.start()
        return self._self_peer

    # -- decentralized introduction ----------------------------------------

    def _seed_from_relay(self) -> None:
        """First-contact peer list from the relay/bootnode table
        (unsigned claims — dialable, never re-gossiped)."""
        try:
            peers = self.rpc.call("shard_p2pPeers") or []
        except Exception:
            return
        for entry in peers:
            pid = entry.get("id")
            if pid is None or pid == self._self_peer.peer_id:
                continue
            self.directory.add_claim(pid, entry.get("account"),
                                     entry.get("endpoint"))

    def gossip_once(self, fanout: int = 3) -> None:
        """One gossip round: ask up to `fanout` live peers for their
        verified tables (responses merge in `_deliver`)."""
        if self.directory is None or self._self_peer is None:
            return
        req = PeerTableRequest()
        sent = 0
        for pid, info in self.directory.live_peers(self._self_peer.peer_id):
            if sent >= fanout:
                break
            if self._direct_send(pid, info, req):
                sent += 1

    def _gossip_loop(self) -> None:
        while not self._gossip_stop.wait(GOSSIP_INTERVAL_S):
            try:
                # relay re-seed rides the background cadence, NEVER the
                # broadcast hot path (a hung relay must not add its RPC
                # timeout to every broadcast)
                self._seed_from_relay()
                self.gossip_once()
            except Exception:  # pragma: no cover - keep the loop alive
                log.exception("gossip round failed")

    def _direct_send(self, peer_id: int, info: dict, data: Any) -> bool:
        """One frame straight to a peer's listener (no relay)."""
        if self._dialer is None or not info.get("endpoint"):
            return False
        kind, payload = codec.enc_p2p(data)
        ok = self._dialer.send(tuple(info["endpoint"]),
                               self._self_peer.peer_id, kind, payload,
                               expect_account=info.get("account"))
        if self.directory is not None:
            (self.directory.mark_ok if ok
             else self.directory.mark_failed)(peer_id)
        return ok

    def detach(self, peer: Peer) -> None:
        """Detach = end of this hub's life (it carries exactly one
        P2PServer): deregister from the relay and close the connection,
        so a stopped node leaks neither socket nor reader threads."""
        self._server = None
        try:
            self.rpc.call("shard_p2pDetach", peer.peer_id)
        except Exception:  # connection may already be down
            pass
        self.close()

    def peer_info(self, peer_id: int) -> Optional[dict]:
        """Peer lookup: relay table (cached: relay ids never recycle),
        then the gossip directory — so resolution outlives the relay."""
        info = self._peer_info_cache.get(peer_id)
        if info is None:
            try:
                info = self.rpc.call("shard_p2pPeerInfo", peer_id)
            except Exception:
                info = None
            if info is not None:
                self._peer_info_cache[peer_id] = info
        if info is None and self.directory is not None:
            info = self.directory.lookup(peer_id)
        return info

    def route(self, sender: Peer, target: Peer, data: Any) -> bool:
        """Directed send: peer-to-peer over the direct socket; the relay
        is the fallback only when the peer's listener is unreachable."""
        kind, payload = codec.enc_p2p(data)
        info = self.peer_info(target.peer_id)
        if (info is not None and info.get("endpoint")
                and self._dialer is not None):
            # DirectDialer.send retries a stale cached connection once
            # internally; a dial/handshake failure falls straight back to
            # the relay (retrying here would stack HANDSHAKE_TIMEOUT
            # stalls on the data-plane hot path)
            if self._dialer.send(tuple(info["endpoint"]), sender.peer_id,
                                 kind, payload,
                                 expect_account=info.get("account")):
                if self.directory is not None:
                    self.directory.mark_ok(target.peer_id)
                return True
            if self.directory is not None:
                self.directory.mark_failed(target.peer_id)
            log.warning("direct send to peer %d failed; relay fallback",
                        target.peer_id)
        try:
            return self.rpc.call("shard_p2pSend", sender.peer_id,
                                 target.peer_id, kind, payload)
        except Exception:
            return False  # relay gone AND no direct path

    def broadcast(self, sender: Peer, data: Any) -> int:
        """Fan out over direct peer sockets (the devp2p runPeer pattern,
        `p2p/server.go:882`); the relay carries only the per-peer
        FALLBACK for endpoints we cannot reach — it is no longer the
        broadcast chokepoint, and a dead relay no longer silences the
        network between introduced peers."""
        if self.directory is None:
            kind, payload = codec.enc_p2p(data)
            return self.rpc.call("shard_p2pBroadcast", sender.peer_id,
                                 kind, payload)
        delivered = 0
        kind, payload = codec.enc_p2p(data)
        for pid, info in self.directory.live_peers(sender.peer_id):
            if self._direct_send(pid, info, data):
                delivered += 1
                continue
            try:
                if self.rpc.call("shard_p2pSend", sender.peer_id, pid,
                                 kind, payload):
                    delivered += 1
            except Exception:
                pass  # relay gone too: the peer is unreachable this round
        # peers attached to the relay WITHOUT a direct listener (the
        # attach protocol permits it) are reachable only via the relay
        for pid in self.directory.relay_only_peers(sender.peer_id):
            try:
                if self.rpc.call("shard_p2pSend", sender.peer_id, pid,
                                 kind, payload):
                    delivered += 1
            except Exception:
                break  # relay down: none of them are reachable
        return delivered

    # -- inbound -----------------------------------------------------------

    def _deliver(self, message: Message) -> None:
        # gossip control frames are the hub's own traffic — answer/merge
        # here, never surface them to the actor's feeds
        if isinstance(message.data, PeerTableRequest):
            if self.directory is not None and self._self_peer is not None:
                info = self.peer_info(message.peer.peer_id)
                if info is not None:
                    self._direct_send(
                        message.peer.peer_id, info,
                        PeerTableResponse(
                            announces=tuple(self.directory.gossip_set())))
            return
        if isinstance(message.data, PeerTableResponse):
            if self.directory is not None:
                self.directory.merge(message.data.announces)
            return
        server = self._server
        if server is not None:
            server._deliver(message)

    def _on_message(self, params: dict) -> None:
        if self._server is None:
            return
        try:
            data = codec.dec_p2p(params["type"], params["payload"])
        except Exception:
            log.exception("undecodable p2p message")
            return
        self._deliver(Message(peer=Peer(params["from"]), data=data))
