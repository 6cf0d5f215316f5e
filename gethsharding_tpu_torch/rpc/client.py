"""RPC client + RemoteMainchain: dial a chain process and act on it (the
port's copy of the JAX package's `rpc/client.py`; its `FrontendPool` waits
for the port's `fleet/`).

Parity: `ethclient` + `sharding/mainchain/utils.go:17-22` (dialRPC).
`RemoteMainchain` implements the same backend surface as
`SimulatedMainchain` (duck-typed), so `SMCClient(backend=RemoteMainchain
.dial(...))` turns any sharding actor into a genuinely separate OS
process from the chain — the reference's process topology (N actor
processes <-> one mainchain node over RPC).

A background reader thread routes responses by id and dispatches
`shard_subscription` notifications to head subscribers (the
`SubscribeNewHead` flow, `sharding/notary/notary.go:33-38`).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import queue
import socket
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from gethsharding_tpu_torch import tracing
from gethsharding_tpu_torch.rpc import codec
from gethsharding_tpu_torch.smc.state_machine import SMCRevert
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

log = logging.getLogger("rpc.client")


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"rpc error {code}: {message}")
        self.code = code
        self.message = message


def _dec_block(obj: dict):
    """ONE decoder for the block wire shape (codec.dec_block) — a local
    duplicate here silently dropped the `extra` (engine seal) field when
    enc_block grew it."""
    return codec.dec_block(obj)


@dataclass
class RemoteReceipt:
    tx_hash: Hash32
    status: int
    block_number: int


class RPCClient:
    """Newline-delimited JSON-RPC 2.0 over a stream socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._sock.settimeout(None)
        self._file = self._sock.makefile("rwb")
        self._ids = itertools.count(1)
        self._pending: dict = {}
        self._pending_lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._head_subscribers: List[Callable] = []
        self._notification_hooks: dict = {}
        self._timeout = timeout
        self._closed = False
        # set once the reader has ended: a later call fails at once
        # instead of waiting out its timeout on a dead socket
        self._lost = False
        # notifications are dispatched OFF the reader thread: subscriber
        # callbacks (e.g. the notary head loop) issue further RPC calls,
        # which would deadlock if the reader were blocked inside them
        self._notifications: "queue.Queue" = queue.Queue()
        # held while a notification's callbacks run; `quiesce` takes it
        self._dispatch_lock = threading.Lock()
        self._quiesced = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="rpc-client-dispatch")
        self._dispatcher.start()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="rpc-client-reader")
        self._reader.start()

    def close(self) -> None:
        self._closed = True
        self._notifications.put(None)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        # drain both service threads (bounded: the socket is dead and the
        # dispatch queue got its sentinel, so neither can block long).
        # A subscriber callback may close() from the dispatcher thread
        # itself — never join the current thread.
        me = threading.current_thread()
        for thread in (self._dispatcher, self._reader):
            if thread is not me:
                thread.join(timeout=5.0)

    # -- request/response --------------------------------------------------

    def call(self, method: str, *params):
        rid = next(self._ids)
        event = threading.Event()
        slot: dict = {"event": event}
        with self._pending_lock:
            if self._lost:
                raise ConnectionError(f"rpc call {method}: connection lost")
            self._pending[rid] = slot
        # cross-process trace propagation: the caller's active span
        # context rides the request as a `trace` envelope field, and the
        # server adopts it as its handler span's trace/parent — one
        # trace id from a router's route span down into the replica's
        # dispatch spans. Extra envelope keys are legal JSON-RPC.
        # Trace-plane methods get NO span and NO envelope: a span per
        # shipped batch re-enters the export buffer it ships (see
        # codec.TRACE_PLANE_METHODS).
        span_cm = (contextlib.nullcontext()
                   if method in codec.TRACE_PLANE_METHODS
                   else tracing.span(f"rpc/client/{method}"))
        with span_cm as client_span:
            request = {"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": list(params)}
            ctx = (tracing.current_context()
                   if client_span is not None else None)
            if ctx is not None:
                request["trace"] = {"trace_id": ctx[0], "span_id": ctx[1]}
            payload = (json.dumps(request) + "\n").encode()
            try:
                with self._write_lock:
                    self._file.write(payload)
                    self._file.flush()
            except (OSError, ValueError):
                # dead socket (the server was killed/restarted): the
                # reply will never come — reclaim the pending slot
                # instead of leaking it, and let the caller's
                # transport-error handling (e.g. RpcReplicaBackend's
                # redial) classify the failure
                with self._pending_lock:
                    self._pending.pop(rid, None)
                raise
            if not event.wait(self._timeout):
                with self._pending_lock:
                    self._pending.pop(rid, None)
                raise TimeoutError(f"rpc call {method} timed out")
            if "trace" in slot and client_span is not None:
                # the server's handler trace id: equal to ours once the
                # server stitches, the REMOTE id against an older server
                # — either way caller logs correlate to replica traces
                client_span.tag(remote_trace=slot["trace"])
            ctx = slot.get("trace_ctx")
            if isinstance(ctx, dict) and client_span is not None:
                # newer servers also return the handler SPAN id: the
                # exact remote span this call produced, unambiguous
                # even when retries/hedges reuse one trace id
                client_span.tag(remote_span=ctx.get("span_id"))
            if "error" in slot:
                err = slot["error"]
                if err.get("data") == "SMCRevert":
                    raise SMCRevert(err.get("message", ""))
                raise RPCError(err.get("code", -1), err.get("message", ""))
            return slot.get("result")

    def subscribe_heads(self, callback: Callable) -> Callable[[], None]:
        # registration is caller-thread territory while the dispatcher
        # iterates a snapshot copy: the list mutations take the pending
        # lock so concurrent subscribe/unsubscribe can't lose entries
        with self._pending_lock:
            self._head_subscribers.append(callback)
        self.call("shard_subscribe", "newHeads")

        def unsubscribe() -> None:
            with self._pending_lock:
                if callback in self._head_subscribers:
                    self._head_subscribers.remove(callback)

        return unsubscribe

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Stop dispatching notifications and wait (up to `timeout` s) for
        the callback in flight to return. A node stopping over this client
        calls it first, so that no head callback runs while its services
        close under it (the chain process keeps sealing blocks). The
        port's own; calls and replies are unaffected. True once idle."""
        self._quiesced = True
        if not self._dispatch_lock.acquire(timeout=timeout):
            return False
        self._dispatch_lock.release()
        return True

    def on_notification(self, method: str, callback: Callable) -> None:
        """Route push notifications with the given method (e.g. the
        shard_p2p relay) to `callback(params)` off the reader thread."""
        with self._pending_lock:
            self._notification_hooks[method] = callback

    def _read_loop(self) -> None:
        try:
            for raw in self._file:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                method = msg.get("method")
                if method == "shard_subscription":
                    self._notifications.put(
                        ("heads", _dec_block(msg["params"]["result"])))
                    continue
                if method in self._notification_hooks:
                    self._notifications.put((method, msg.get("params")))
                    continue
                rid = msg.get("id")
                with self._pending_lock:
                    slot = self._pending.pop(rid, None)
                if slot is not None:
                    if "trace" in msg:
                        # the handler-span trace id the server returns
                        # on the envelope — surfaced as the caller
                        # span's `remote_trace` tag (it was received
                        # and silently discarded before)
                        slot["trace"] = msg["trace"]
                    if "traceCtx" in msg:
                        slot["trace_ctx"] = msg["traceCtx"]
                    if "error" in msg:
                        slot["error"] = msg["error"]
                    else:
                        slot["result"] = msg.get("result")
                    slot["event"].set()
        except (OSError, ValueError):
            pass
        finally:
            if not self._closed:
                log.warning("rpc connection lost")
            self._notifications.put(None)
            # unblock all waiters
            with self._pending_lock:
                self._lost = True
                pending = list(self._pending.values())
                self._pending.clear()
            for slot in pending:
                slot["error"] = {"code": -32000, "message": "connection lost"}
                slot["event"].set()

    def _dispatch_loop(self) -> None:
        while True:
            item = self._notifications.get()
            if item is None:
                return
            method, payload = item
            with self._dispatch_lock:
                if not self._quiesced:
                    self._dispatch(method, payload)

    def _dispatch(self, method, payload) -> None:
        if method == "heads":
            for callback in list(self._head_subscribers):
                try:
                    callback(payload)
                except Exception:  # noqa: BLE001 - subscriber owns it
                    log.exception("head subscriber failed")
            return
        hook = self._notification_hooks.get(method)
        if hook is not None:
            try:
                hook(payload)
            except Exception:  # noqa: BLE001
                log.exception("notification hook %s failed", method)


class RemoteMainchain:
    """Client-side mainchain backend over RPC (SimulatedMainchain's duck
    type, minus in-process-only internals)."""

    def __init__(self, rpc: RPCClient):
        self.rpc = rpc

    @classmethod
    def dial(cls, host: str, port: int, timeout: float = 30.0
             ) -> "RemoteMainchain":
        return cls(RPCClient(host, port, timeout=timeout))

    def close(self) -> None:
        self.rpc.close()

    # chain reader
    @property
    def block_number(self) -> int:
        return self.rpc.call("shard_blockNumber")

    def current_period(self) -> int:
        return self.rpc.call("shard_currentPeriod")

    def block_by_number(self, number: Optional[int] = None):
        return _dec_block(self.rpc.call("shard_blockByNumber", number))

    def subscribe_new_head(self, callback) -> Callable[[], None]:
        return self.rpc.subscribe_heads(callback)

    # SMC views
    def get_notary_in_committee(self, sender: Address20, shard_id: int):
        return Address20(codec.dec_bytes(self.rpc.call(
            "shard_getNotaryInCommittee", codec.enc_bytes(sender), shard_id)))

    def notary_registry(self, address: Address20):
        return codec.dec_registry(self.rpc.call(
            "shard_notaryRegistry", codec.enc_bytes(address)))

    def committee_context(self) -> dict:
        ctx = self.rpc.call("shard_committeeContext")
        return {
            "period": ctx["period"],
            "sample_size": ctx["sampleSize"],
            "blockhash": codec.dec_bytes(ctx["blockhash"]),
            "pool": [None if a is None else codec.dec_bytes(a)
                     for a in ctx["pool"]],
        }

    def collation_record(self, shard_id: int, period: int):
        return codec.dec_record(self.rpc.call(
            "shard_collationRecord", shard_id, period))

    def last_submitted_collation(self, shard_id: int) -> int:
        return self.rpc.call("shard_lastSubmittedCollation", shard_id)

    def last_approved_collation(self, shard_id: int) -> int:
        return self.rpc.call("shard_lastApprovedCollation", shard_id)

    def notary_by_pool_index(self, index: int) -> Optional[Address20]:
        addr = self.rpc.call("shard_notaryByPoolIndex", index)
        return None if addr is None else Address20(codec.dec_bytes(addr))

    def has_voted(self, shard_id: int, index: int) -> bool:
        return self.rpc.call("shard_hasVoted", shard_id, index)

    def get_vote_count(self, shard_id: int) -> int:
        return self.rpc.call("shard_getVoteCount", shard_id)

    def shard_count(self) -> int:
        return self.rpc.call("shard_shardCount")

    def balance_of(self, account: Address20) -> int:
        return self.rpc.call("shard_balanceOf", codec.enc_bytes(account))

    def transaction_receipt(self, tx_hash: Hash32):
        obj = self.rpc.call("shard_transactionReceipt",
                            codec.enc_bytes(tx_hash))
        return None if obj is None else RemoteReceipt(
            tx_hash=Hash32(codec.dec_bytes(obj["txHash"])),
            status=obj["status"], block_number=obj["blockNumber"])

    def trace_transaction(self, tx_hash: Hash32):
        """Event-level execution trace of a sealed tx (the
        debug_traceTransaction analog); None for unknown hashes."""
        return self.rpc.call("shard_traceTransaction",
                             codec.enc_bytes(tx_hash))

    def verify_period_batch(self, period: int, device=None):
        """The chain process's vote-log replay; it runs on the chain
        process's own device, so the caller's `device` is not sent."""
        return self.rpc.call("shard_verifyPeriodBatch", period)

    # transactions
    def register_notary(self, sender: Address20, value=None,
                        bls_pubkey=None, bls_pop=None) -> RemoteReceipt:
        return self._receipt(self.rpc.call(
            "shard_registerNotary", codec.enc_bytes(sender),
            codec.enc_g2(bls_pubkey), codec.enc_g1(bls_pop)))

    def deregister_notary(self, sender: Address20) -> RemoteReceipt:
        return self._receipt(self.rpc.call(
            "shard_deregisterNotary", codec.enc_bytes(sender)))

    def release_notary(self, sender: Address20) -> RemoteReceipt:
        return self._receipt(self.rpc.call(
            "shard_releaseNotary", codec.enc_bytes(sender)))

    def add_header(self, sender: Address20, shard_id: int, period: int,
                   chunk_root: Hash32, signature: bytes = b"") -> RemoteReceipt:
        return self._receipt(self.rpc.call(
            "shard_addHeader", codec.enc_bytes(sender), shard_id, period,
            codec.enc_bytes(chunk_root), codec.enc_bytes(signature)))

    def submit_vote(self, sender: Address20, shard_id: int, period: int,
                    index: int, chunk_root: Hash32,
                    bls_sig=None) -> RemoteReceipt:
        return self._receipt(self.rpc.call(
            "shard_submitVote", codec.enc_bytes(sender), shard_id, period,
            index, codec.enc_bytes(chunk_root), codec.enc_g1(bls_sig)))

    # dev-mode chain control
    def network_id(self) -> int:
        return self.rpc.call("shard_networkId")

    def mirror_snapshot(self) -> dict:
        """Bulk SMC state snapshot (json int keys restored in place)."""
        from gethsharding_tpu_torch.mainchain.mirror import restore_int_keys

        return restore_int_keys(self.rpc.call("shard_mirrorSnapshot"))

    def audit_data(self, period: int) -> dict:
        """Bulk period-audit data (one round trip; shard keys restored)."""
        data = self.rpc.call("shard_auditData", period)
        data["shards"] = {int(k): v for k, v in data["shards"].items()}
        return data

    def chain_config(self, **overrides):
        """Fetch the chain process's protocol constants as a Config.
        `overrides` replace node-local knobs (e.g. windback_depth) that
        are not chain consensus parameters."""
        from gethsharding_tpu_torch.params import Config

        fields = self.rpc.call("shard_chainConfig")
        fields.update(overrides)
        return Config(**fields)

    def p2p_peers(self) -> list:
        """The relay's attached-peer table (admin_peers analog)."""
        return self.rpc.call("shard_p2pPeers")

    def fund(self, account: Address20, amount: int) -> None:
        self.rpc.call("shard_fund", codec.enc_bytes(account), amount)

    def commit(self):
        return _dec_block(self.rpc.call("shard_commit"))

    def fast_forward(self, periods: int) -> int:
        return self.rpc.call("shard_fastForward", periods)

    def set_head(self, number: int):
        """Dev-mode chain rollback (smc/chain.py set_head)."""
        return _dec_block(self.rpc.call("shard_setHead", number))

    @staticmethod
    def _receipt(obj: dict) -> RemoteReceipt:
        return RemoteReceipt(tx_hash=Hash32(codec.dec_bytes(obj["txHash"])),
                             status=obj["status"],
                             block_number=obj["blockNumber"])
