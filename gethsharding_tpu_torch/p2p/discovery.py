"""Decentralized peer introduction: signed announces + liveness-checked
gossip over the authenticated direct data plane (the port's copy of the JAX
package's `p2p/discovery.py`).

Role parity: the reference's discovery tier — the Kademlia peer table
(`p2p/discover/table.go:68`), dial scheduling (`p2p/dial.go:1`) and
discv5's SIGNED node records (ENR: account-bound, seq-versioned). The
chain-process relay / bootnode remains only the FIRST contact:

- every node publishes a `PeerAnnounce` — its (peer_id, account,
  endpoint) self-signed over the network id and a monotonic `seq`, so
  any third party can verify the binding without trusting the gossiper
  (a forwarded announce is evidence, not a claim);
- each node keeps a `PeerDirectory` of announces (verified) plus
  relay-table entries (claims, used for dialing exactly as the relay
  flow always did — the direct handshake's mutual auth still pins the
  dialed listener to the expected account);
- `PeerTableRequest`/`PeerTableResponse` frames ride the SAME
  authenticated direct sockets as data messages; `RemoteHub` answers
  them internally and merges what peers return, with per-peer failure
  counts aging dead entries out of the broadcast set.

With that, introduction survives the relay: once two nodes have
exchanged announces, directed sends, broadcasts and body exchange all
run peer-to-peer with the relay process gone.

Scale bound (documented, by design): the directory is FLAT — verified
announces gossip to every peer and the table caps at MAX_VERIFIED
entries with liveness aging, so lookups are O(1) and table state/churn
traffic are O(n) per node. That is the right trade at this framework's
deployment scale (a devnet or a pod-local fleet of dozens of actor
processes: the reference's own devnet topology), where the XOR-bucket
Kademlia structure (`p2p/discover/table.go:68`) would add lookup
round-trips without shrinking any real table. What changes at
thousand-node WAN scale: the flat table stops fitting (MAX_VERIFIED
evicts live peers) and O(n) gossip dominates — the upgrade path is
XOR-distance buckets over the EXISTING verified announces (they already
carry the node identity the distance metric needs) with the same
authenticated frames serving FINDNODE-style bucket queries; nothing in
the data plane or the announce format would change.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.p2p import direct

# a peer whose direct endpoint failed this many consecutive times is
# dropped from the live set until a fresh announce or successful send
DEAD_AFTER_FAILURES = 3

# table bound: one verified announce per ACCOUNT (an attacker with one
# key cannot mint unbounded peer_ids into everyone's tables) and a hard
# entry cap with lowest-seq eviction (memory + broadcast-fanout bound)
MAX_VERIFIED = 512


@dataclass(frozen=True)
class PeerAnnounce:
    """Self-signed node record (the ENR analog)."""

    peer_id: int
    account: str      # 20-byte hex, no 0x
    host: str
    port: int
    seq: int          # monotonic per node; higher wins on merge
    sig: bytes        # secp256k1 over announce_digest, 65 bytes


@dataclass(frozen=True)
class PeerTableRequest:
    """Ask a peer for its verified announce table (+ its own record)."""


@dataclass(frozen=True)
class PeerTableResponse:
    announces: tuple  # tuple[PeerAnnounce, ...]


def announce_digest(network_id: int, peer_id: int, account_hex: str,
                    host: str, port: int, seq: int) -> bytes:
    return keccak256(
        b"shardp2p-announce:" + network_id.to_bytes(8, "big")
        + peer_id.to_bytes(8, "big")
        + bytes.fromhex(account_hex.lower().removeprefix("0x"))
        + host.encode() + b":" + port.to_bytes(4, "big")
        + seq.to_bytes(8, "big"))


def verify_announce(network_id: int, ann: PeerAnnounce) -> bool:
    try:
        digest = announce_digest(network_id, ann.peer_id, ann.account,
                                 ann.host, int(ann.port), int(ann.seq))
    except (ValueError, AttributeError, OverflowError):
        return False
    return direct.prove(digest, ann.sig, ann.account)


class PeerDirectory:
    """Thread-safe table of peers: verified announces + relay claims.

    Only VERIFIED announces are re-served to other peers (a node never
    launders unsigned relay claims into gossip); claims still feed the
    local dial/broadcast set, with the direct handshake's mutual auth as
    the enforcement point."""

    def __init__(self, network_id: int):
        self.network_id = network_id
        self._lock = threading.Lock()
        self._verified: Dict[int, PeerAnnounce] = {}
        self._claims: Dict[int, dict] = {}     # peer_id -> {account, endpoint}
        self._relay_only: set = set()          # attached without a listener
        self._failures: Dict[int, int] = {}
        self.self_announce: Optional[PeerAnnounce] = None

    # -- self record -------------------------------------------------------

    def make_self(self, peer_id: int, account_hex: str,
                  endpoint: Tuple[str, int],
                  sign: Callable[[bytes], bytes]) -> PeerAnnounce:
        host, port = endpoint
        seq = int(time.time() * 1000)
        sig = sign(announce_digest(self.network_id, peer_id, account_hex,
                                   host, int(port), seq))
        ann = PeerAnnounce(peer_id=peer_id, account=account_hex,
                           host=host, port=int(port), seq=seq, sig=sig)
        with self._lock:
            self.self_announce = ann
            self._verified[peer_id] = ann
        return ann

    # -- merge paths -------------------------------------------------------

    def merge(self, announces) -> int:
        """Verify + absorb gossiped announces; returns how many entries
        were new or fresher (higher seq). One entry per account; the
        table is hard-capped with lowest-seq eviction."""
        changed = 0
        for ann in announces:
            if not isinstance(ann, PeerAnnounce):
                continue
            if not verify_announce(self.network_id, ann):
                continue
            acct = ann.account.lower().removeprefix("0x")
            with self._lock:
                held = self._verified.get(ann.peer_id)
                if held is not None and held.seq >= ann.seq:
                    continue
                # one announce per account: the freshest wins, older
                # peer_ids signed by the same key are dropped
                stale = [pid for pid, a in self._verified.items()
                         if a.account.lower().removeprefix("0x") == acct
                         and pid != ann.peer_id]
                if any(self._verified[pid].seq >= ann.seq for pid in stale):
                    continue
                for pid in stale:
                    del self._verified[pid]
                self_pid = (self.self_announce.peer_id
                            if self.self_announce is not None else None)
                while len(self._verified) >= MAX_VERIFIED:
                    victim = min(
                        (pid for pid in self._verified if pid != self_pid),
                        key=lambda pid: self._verified[pid].seq,
                        default=None)
                    if victim is None:
                        break
                    del self._verified[victim]
                self._verified[ann.peer_id] = ann
                self._claims.pop(ann.peer_id, None)
                self._relay_only.discard(ann.peer_id)
                self._failures.pop(ann.peer_id, None)  # fresh evidence
                changed += 1
        return changed

    def add_claim(self, peer_id: int, account: Optional[str],
                  endpoint) -> None:
        """Relay-table entry (unsigned): usable for dialing, never
        re-gossiped. Endpoint-less peers (the relay protocol allows an
        attach without a listener) are tracked as RELAY-ONLY so
        broadcasts still reach them through the relay."""
        with self._lock:
            if peer_id in self._verified:
                return
            if not endpoint:
                self._relay_only.add(peer_id)
                return
            self._claims[peer_id] = {
                "account": (account or "").lower().removeprefix("0x"),
                "endpoint": (endpoint[0], int(endpoint[1])),
            }
            self._relay_only.discard(peer_id)

    def relay_only_peers(self, exclude: int) -> List[int]:
        """Peers reachable only through the relay (no direct endpoint)."""
        with self._lock:
            return [pid for pid in self._relay_only
                    if pid != exclude and pid not in self._verified
                    and pid not in self._claims]

    # -- reads -------------------------------------------------------------

    def gossip_set(self) -> List[PeerAnnounce]:
        with self._lock:
            return list(self._verified.values())

    def lookup(self, peer_id: int) -> Optional[dict]:
        """peer_info-shaped view: {"account", "endpoint"} or None."""
        with self._lock:
            ann = self._verified.get(peer_id)
            if ann is not None:
                return {"account": ann.account,
                        "endpoint": (ann.host, ann.port)}
            claim = self._claims.get(peer_id)
            return dict(claim) if claim is not None else None

    def live_peers(self, exclude: int) -> List[Tuple[int, dict]]:
        """Dialable peers (verified + claims) that are not failure-aged."""
        with self._lock:
            out = []
            for pid, ann in self._verified.items():
                if pid == exclude:
                    continue
                if self._failures.get(pid, 0) >= DEAD_AFTER_FAILURES:
                    continue
                out.append((pid, {"account": ann.account,
                                  "endpoint": (ann.host, ann.port)}))
            for pid, claim in self._claims.items():
                if pid == exclude or pid in self._verified:
                    continue
                if self._failures.get(pid, 0) >= DEAD_AFTER_FAILURES:
                    continue
                out.append((pid, dict(claim)))
            return out

    # -- liveness ----------------------------------------------------------

    def mark_ok(self, peer_id: int) -> None:
        with self._lock:
            self._failures.pop(peer_id, None)

    def mark_failed(self, peer_id: int) -> None:
        with self._lock:
            self._failures[peer_id] = self._failures.get(peer_id, 0) + 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._verified) + len(self._claims)
