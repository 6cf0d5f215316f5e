"""Direct authenticated + encrypted peer sockets for shardp2p (the
de-starred data plane; the port's copy of the JAX package's
`p2p/direct.py`).

The chain-process relay (`rpc/server.py` shard_p2p*) remains the
INTRODUCTION service — it allocates peer ids and keeps the table of
(account, listener endpoint) per peer — but directed message payloads
flow over direct TCP sockets between actor processes. This is the
reference's RLPx role split (`p2p/rlpx.go:86,178` authenticated
encrypted transport vs `p2p/dial.go`/discovery introduction), with the
same security class: MUTUAL secp256k1 authentication and, when the host
offers AEAD primitives, ephemeral-ECDH-derived AES-256-GCM frame
encryption (the modern equivalent of RLPx's ECIES handshake +
AES-CTR/keccak-MAC frames).

Wire protocol:

  1. listener -> dialer (plaintext JSON line):
       {"challenge": hex32, "eph_pub": hex64?}          # eph iff AEAD
  2. dialer -> listener (plaintext JSON line):
       {"peer_id": N, "account": hex20, "sig": hex65,
        "challenge2": hex32, "eph_pub": hex64?}
       sig  = sign(keccak(b"shardp2p-direct:" || nid8 || challenge ||
                          dialer_eph || listener_eph))
  3. listener -> dialer (first frame; encrypted iff both sides sent
     eph_pub):
       {"ok": true, "account": hex20, "sig2": hex65} | {"error": ...}
       sig2 = sign(keccak(b"shardp2p-accept:" || nid8 || challenge2 ||
                          dialer_eph || listener_eph))
  4. data frames: {"type": kind, "payload": ...} — plaintext newline
     JSON, or AES-256-GCM with 4-byte big-endian length prefix and a
     per-direction 12-byte counter nonce.

Security properties: the dialer's signature binds BOTH ephemeral keys
to its relay-registered account (verified against the relay's table for
the claimed peer id), the listener's signature binds them to the
account the dialer looked up for the endpoint — so neither end can be
impersonated and a middle man cannot substitute ephemeral keys without
breaking a signature. Fresh challenges on both sides prevent replay.
Per-direction keys derive as keccak256(ecdh_x || direction-label).
"""

from __future__ import annotations

import json
import logging
import secrets
import socket
import socketserver
import struct
import threading
from typing import Callable, Optional, Tuple

from gethsharding_tpu_torch.crypto import secp256k1
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.p2p.service import Message, Peer
from gethsharding_tpu_torch.rpc import codec

log = logging.getLogger("p2p.direct")

HANDSHAKE_TIMEOUT = 10.0

try:  # AEAD frames need the host's cryptography package; gate, don't require
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except Exception:  # pragma: no cover - AEAD-less host
    AESGCM = None

    class InvalidTag(Exception):  # noqa: N818 - mirror cryptography's name
        pass


SEND_TIMEOUT = 30.0  # post-handshake socket timeout: a peer that stops
# draining must stall only its own connection, never the caller forever


def attach_digest(network_id: int, challenge: bytes) -> bytes:
    """What an attaching node signs to prove its account to the relay."""
    return keccak256(b"shardp2p-attach:" + network_id.to_bytes(8, "big")
                     + challenge)


def direct_digest(network_id: int, challenge: bytes,
                  dialer_eph: bytes = b"", listener_eph: bytes = b"") -> bytes:
    """What a dialing node signs: account + BOTH ephemeral keys."""
    return keccak256(b"shardp2p-direct:" + network_id.to_bytes(8, "big")
                     + challenge + dialer_eph + listener_eph)


def accept_digest(network_id: int, challenge2: bytes,
                  dialer_eph: bytes = b"", listener_eph: bytes = b"") -> bytes:
    """What the accepting listener signs: mutual authentication."""
    return keccak256(b"shardp2p-accept:" + network_id.to_bytes(8, "big")
                     + challenge2 + dialer_eph + listener_eph)


def prove(digest: bytes, sig65: bytes, account_hex: str) -> bool:
    """Does the signature recover to the claimed 20-byte hex account?"""
    try:
        addr = secp256k1.ecrecover_address(
            digest, secp256k1.Signature.from_bytes65(sig65))
    except (ValueError, AssertionError):
        return False
    return bytes(addr).hex() == account_hex.lower().removeprefix("0x")


# -- AEAD channel ----------------------------------------------------------


def _ephemeral_keypair() -> Tuple[int, bytes]:
    priv = (int.from_bytes(secrets.token_bytes(32), "big")
            % (secp256k1.N - 1)) + 1
    pub = secp256k1.pubkey_from_priv(priv)
    # raw 64-byte X || Y (no SEC1 prefix): fixed width for the digests
    return priv, pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def _ecdh_secret(priv: int, peer_pub64: bytes) -> bytes:
    pub = (int.from_bytes(peer_pub64[:32], "big"),
           int.from_bytes(peer_pub64[32:], "big"))
    if not secp256k1.is_on_curve(pub):
        raise ValueError("ephemeral key not on curve")
    shared = secp256k1.point_mul(priv, pub)
    return keccak256(shared[0].to_bytes(32, "big"))


class _Channel:
    """One direction of AES-256-GCM framing with a counter nonce."""

    def __init__(self, key: bytes):
        self.aead = AESGCM(key)
        self.counter = 0
        self.lock = threading.Lock()

    def seal(self, plaintext: bytes) -> bytes:
        with self.lock:
            nonce = self.counter.to_bytes(12, "big")
            self.counter += 1
        blob = self.aead.encrypt(nonce, plaintext, None)
        return struct.pack(">I", len(blob)) + blob

    def open_frame(self, rfile) -> Optional[bytes]:
        header = rfile.read(4)
        if len(header) < 4:
            return None
        (length,) = struct.unpack(">I", header)
        if length > 16 * 1024 * 1024:
            raise ValueError("oversized frame")
        blob = rfile.read(length)
        if len(blob) < length:
            return None
        with self.lock:
            nonce = self.counter.to_bytes(12, "big")
            self.counter += 1
        return self.aead.decrypt(nonce, blob, None)


def _derive_channels(secret: bytes, dialer_side: bool):
    """(send, recv) channels; keys separated by direction labels."""
    k_d2l = keccak256(secret + b"dialer->listener")
    k_l2d = keccak256(secret + b"listener->dialer")
    if dialer_side:
        return _Channel(k_d2l), _Channel(k_l2d)
    return _Channel(k_l2d), _Channel(k_d2l)


# -- inbound ---------------------------------------------------------------


class PeerListener:
    """Inbound side: accepts authenticated (and, when possible,
    encrypted) peer connections and delivers their frames into the
    local P2PServer."""

    def __init__(self, deliver: Callable[[Message], None],
                 resolve: Callable[[int], Optional[dict]],
                 network_id: int, sign: Callable[[bytes], bytes],
                 account_hex: str, host: str = "127.0.0.1"):
        self.deliver = deliver
        self.resolve = resolve
        self.network_id = network_id
        self.sign = sign
        self.account_hex = account_hex
        listener = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                listener._handle(self)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, 0), Handler)
        self.address: Tuple[str, int] = self._tcp.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True, name="p2p-listener")
        self._thread.start()

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- connection handling ----------------------------------------------

    def _handle(self, handler) -> None:
        handler.connection.settimeout(HANDSHAKE_TIMEOUT)
        challenge = secrets.token_bytes(32)
        eph_priv, eph_pub = (None, b"")
        if AESGCM is not None:
            eph_priv, eph_pub = _ephemeral_keypair()
        try:
            greeting = {"challenge": challenge.hex()}
            if eph_pub:
                greeting["eph_pub"] = eph_pub.hex()
            handler.wfile.write((json.dumps(greeting) + "\n").encode())
            handler.wfile.flush()

            hello = json.loads(handler.rfile.readline())
            peer_id = int(hello["peer_id"])
            account = str(hello["account"])
            sig = bytes.fromhex(hello["sig"])
            challenge2 = bytes.fromhex(hello["challenge2"])
            dialer_eph = bytes.fromhex(hello.get("eph_pub", ""))
            encrypt = bool(eph_pub) and bool(dialer_eph)

            # downgrade protection: each side's digests use the keys it
            # SENT for its own slot and the keys it RECEIVED for the
            # peer's — so a middle man stripping either eph_pub breaks
            # one of the two signatures instead of silently forcing
            # plaintext (the dialer's sig commits to the listener key it
            # saw; our sig2 commits to the key we actually offered)
            err = self._verify(peer_id, account, sig, challenge,
                               dialer_eph, eph_pub)
            sig2 = self.sign(accept_digest(
                self.network_id, challenge2, dialer_eph, eph_pub))
            reply = ({"ok": True, "account": self.account_hex,
                      "sig2": sig2.hex()}
                     if err is None else {"error": err})
            if encrypt and err is None:
                secret = _ecdh_secret(eph_priv, dialer_eph)
                send, recv = _derive_channels(secret, dialer_side=False)
                handler.wfile.write(send.seal(json.dumps(reply).encode()))
            else:
                handler.wfile.write((json.dumps(reply) + "\n").encode())
            handler.wfile.flush()
            if err is not None:
                log.warning("refused direct peer %s: %s", account, err)
                return
        except (OSError, ValueError, KeyError, TypeError, InvalidTag,
                json.JSONDecodeError):
            return
        handler.connection.settimeout(None)
        try:
            while True:
                if encrypt:
                    raw = recv.open_frame(handler.rfile)
                    if raw is None:
                        break
                else:
                    raw = handler.rfile.readline()
                    if not raw:
                        break
                    raw = raw.strip()
                    if not raw:
                        continue
                frame = json.loads(raw)
                data = codec.dec_p2p(frame["type"], frame["payload"])
                self.deliver(Message(peer=Peer(peer_id), data=data))
        except (OSError, ValueError, KeyError, InvalidTag,
                json.JSONDecodeError):
            log.debug("direct peer %d connection ended", peer_id)

    def _verify(self, peer_id: int, account: str, sig: bytes,
                challenge: bytes, dialer_eph: bytes,
                listener_eph: bytes) -> Optional[str]:
        digest = direct_digest(self.network_id, challenge, dialer_eph,
                               listener_eph)
        if not prove(digest, sig, account):
            return "signature does not prove the claimed account"
        meta = self.resolve(peer_id)
        if meta is None:
            return f"unknown relay peer id {peer_id}"
        on_file = (meta.get("account") or "").lower().removeprefix("0x")
        if on_file != account.lower().removeprefix("0x"):
            return "account does not match the relay's table for this peer"
        return None


# -- outbound --------------------------------------------------------------


class DirectDialer:
    """Outbound side: a cache of authenticated connections to peer
    listeners; `send` dials + handshakes on first use per endpoint."""

    def __init__(self, network_id: int, account_hex: str,
                 sign: Callable[[bytes], bytes]):
        self.network_id = network_id
        self.account_hex = account_hex
        self.sign = sign
        self._conns: dict = {}  # endpoint -> (sock, rfile, wfile, channel)
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for sock, *_ in conns.values():
            try:
                sock.close()
            except OSError:
                pass

    def send(self, endpoint: Tuple[str, int], self_peer_id: int,
             kind: str, payload, expect_account: Optional[str] = None
             ) -> bool:
        """One frame to the peer listening at `endpoint`; False when the
        peer is unreachable or either handshake check fails (caller
        falls back to the relay). `expect_account` pins the listener's
        identity to the relay's table entry (mutual auth)."""
        frame = json.dumps({"type": kind, "payload": payload}).encode()
        for attempt in (0, 1):  # one retry on a stale cached connection
            conn = self._get(tuple(endpoint), self_peer_id, expect_account)
            if conn is None:
                return False
            sock, _, wfile, channel, wlock = conn
            try:
                wire = (channel.seal(frame) if channel is not None
                        else frame + b"\n")
                # per-connection lock: one hung peer must never wedge
                # sends to every other peer
                with wlock:
                    wfile.write(wire)
                    wfile.flush()
                return True
            except OSError:
                self._drop(tuple(endpoint))
        return False

    def _get(self, endpoint: Tuple[str, int], self_peer_id: int,
             expect_account: Optional[str]):
        with self._lock:
            conn = self._conns.get(endpoint)
        if conn is not None:
            return conn
        try:
            sock = socket.create_connection(endpoint,
                                            timeout=HANDSHAKE_TIMEOUT)
            rfile = sock.makefile("rb")
            wfile = sock.makefile("wb")
            greeting = json.loads(rfile.readline())
            challenge = bytes.fromhex(greeting["challenge"])
            listener_eph = bytes.fromhex(greeting.get("eph_pub", ""))
            encrypt = AESGCM is not None and bool(listener_eph)
            eph_priv, eph_pub = (_ephemeral_keypair() if encrypt
                                 else (None, b""))
            challenge2 = secrets.token_bytes(32)
            # downgrade protection: sign over OUR sent key (possibly
            # empty) and the listener key AS RECEIVED — a stripped
            # greeting makes the listener's verification fail, a
            # stripped hello makes our sig2 check below fail
            sig = self.sign(direct_digest(
                self.network_id, challenge, eph_pub, listener_eph))
            hello = {"peer_id": self_peer_id, "account": self.account_hex,
                     "sig": sig.hex(), "challenge2": challenge2.hex()}
            if eph_pub:
                hello["eph_pub"] = eph_pub.hex()
            wfile.write((json.dumps(hello) + "\n").encode())
            wfile.flush()

            send = recv = None
            if encrypt:
                secret = _ecdh_secret(eph_priv, listener_eph)
                send, recv = _derive_channels(secret, dialer_side=True)
                raw = recv.open_frame(rfile)
                reply = json.loads(raw) if raw is not None else {}
            else:
                reply = json.loads(rfile.readline())
            if not reply.get("ok"):
                log.warning("direct handshake refused by %s: %s", endpoint,
                            reply.get("error"))
                sock.close()
                return None
            # mutual authentication: the listener must prove the account
            # the relay's table advertises for this endpoint, committing
            # to the same (sent, received) ephemeral-key view
            sig2 = bytes.fromhex(reply.get("sig2", ""))
            listed = reply.get("account", "")
            digest2 = accept_digest(self.network_id, challenge2,
                                    eph_pub, listener_eph)
            if not prove(digest2, sig2, listed) or (
                    expect_account is not None
                    and listed.lower().removeprefix("0x")
                    != expect_account.lower().removeprefix("0x")):
                log.warning("direct listener at %s failed mutual auth",
                            endpoint)
                sock.close()
                return None
            sock.settimeout(SEND_TIMEOUT)
        except (OSError, ValueError, KeyError, InvalidTag,
                json.JSONDecodeError) as exc:
            log.debug("direct dial to %s failed: %s", endpoint, exc)
            return None
        conn = (sock, rfile, wfile, send, threading.Lock())
        with self._lock:
            existing = self._conns.get(endpoint)
            if existing is not None:
                # a racing first-send finished its handshake before us:
                # keep theirs, close ours (no leaked socket/handler)
                try:
                    sock.close()
                except OSError:
                    pass
                return existing
            self._conns[endpoint] = conn
        return conn

    def _drop(self, endpoint: Tuple[str, int]) -> None:
        with self._lock:
            conn = self._conns.pop(endpoint, None)
        if conn is not None:
            try:
                conn[0].close()
            except OSError:
                pass
