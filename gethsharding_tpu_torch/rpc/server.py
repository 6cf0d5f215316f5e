"""RPCServer: expose a SimulatedMainchain over JSON-RPC 2.0 (the port's copy
of the JAX package's `rpc/server.py`).

Parity: `rpc/server.go:46` + the IPC codec (`rpc/ipc.go`,
`rpc/json.go`) — newline-delimited JSON-RPC 2.0 frames over a stream
socket, one goroutine-equivalent thread per connection, `shard_subscribe`
push notifications for new heads (the `eth_subscribe` pattern the notary's
head loop depends on, `sharding/notary/notary.go:33-38`).

SMC reverts map to JSON-RPC error code 3 (geth's revert error code) with
the revert reason in `message`; the client re-raises them as `SMCRevert`
so actor-side control flow is identical in- and cross-process.

The verification methods (`shard_verifyCommittees`, `shard_ecrecover`,
`shard_verifyAggregates`, `shard_dasVerify`, `shard_dasPolyVerify`) submit
to one shared serving tier, so the handler threads never launch a kernel:
the tier's dispatch thread does, on the device of the injected backend
(`TorchSigBackend` on the card in a chain process started with
`--sigbackend torch`). The handlers of modules the port has not ported
(the trace export plane, the profiler and device scope) refuse by naming
the module.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import threading
import time
from typing import Optional

from gethsharding_tpu_torch import tracing
from gethsharding_tpu_torch.rpc import codec
from gethsharding_tpu_torch.p2p.service import (
    PROTOCOL_NAME as P2P_PROTOCOL_NAME,
    PROTOCOL_VERSION as P2P_PROTOCOL_VERSION,
)
from gethsharding_tpu_torch.smc.chain import SimulatedMainchain
from gethsharding_tpu_torch.smc.state_machine import SMCRevert
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

log = logging.getLogger("rpc.server")

REVERT_CODE = 3
METHOD_NOT_FOUND = -32601
INVALID_REQUEST = -32600
INTERNAL_ERROR = -32603

# per-connection dispatch concurrency: one socket carries MANY
# multiplexed requests (a fleet frontend funnels every routed call for
# a replica over ONE RPCClient), so handling them serially in the read
# loop would cap a replica at one in-flight request per upstream and
# starve the serving tier's coalescing + queue-depth signal. Each
# request dispatches on its own worker; the bound makes the read loop
# itself the backpressure once a connection has this many in flight.
CONN_CONCURRENCY = int(os.environ.get(
    "GETHSHARDING_RPC_CONN_CONCURRENCY", "64"))


def serve_connection(handler, dispatch, note_inflight,
                     name: str = "rpc-conn-worker") -> None:
    """The connection loop of the port's JSON-RPC servers (`RPCServer` and
    the fleet frontend): one newline-delimited request a line, each
    dispatched on a worker of its own so one slow call never serializes
    the connection. `dispatch(raw, write_lock)` returns the response dict
    (None for a notification) and may write on the socket itself under
    `write_lock`; `note_inflight(+1 / -1)` brackets each request."""
    write_lock = threading.Lock()
    slots = threading.BoundedSemaphore(max(1, CONN_CONCURRENCY))
    workers = []

    def serve_one(raw: bytes) -> None:
        try:
            try:
                response = dispatch(raw, write_lock)
            finally:
                note_inflight(-1)
            if response is not None:
                with write_lock:
                    handler.wfile.write(
                        (json.dumps(response) + "\n").encode())
                    handler.wfile.flush()
        except (OSError, ValueError):
            pass  # peer gone mid-response: its client already knows
        finally:
            slots.release()

    try:
        for raw in handler.rfile:
            raw = raw.strip()
            if not raw:
                continue
            note_inflight(+1)
            # concurrent dispatch, bounded: responses multiplex back by
            # request id (the client's pending map reorders), and once
            # CONN_CONCURRENCY requests are in flight the read loop
            # blocks here — TCP backpressure to the sender
            slots.acquire()
            worker = threading.Thread(target=serve_one, args=(raw,),
                                      daemon=True, name=name)
            workers.append(worker)
            worker.start()
            if len(workers) > CONN_CONCURRENCY:
                workers = [w for w in workers if w.is_alive()]
    except (OSError, ValueError):
        pass
    finally:
        # drain in-flight workers briefly (shared deadline, not
        # per-thread): their responses are undeliverable now, and they
        # are daemons — this just keeps teardown orderly
        deadline = time.monotonic() + 1.0
        for worker in workers:
            worker.join(timeout=max(0.0, deadline - time.monotonic()))


def traced_call(req: dict, method: str, fn, params):
    """Run one handler under its ``rpc/<method>`` span. An inbound `trace`
    envelope (`RPCClient.call` attaches the caller's span context) is
    adopted: the handler span joins the remote trace and parents under
    the remote span, stitching a router-traced request into this
    process's spans. Returns (result, (trace_id, span_id) of the handler
    span, or None while tracing is off)."""
    inbound = req.get("trace")
    ctx = None
    if isinstance(inbound, dict):
        ctx = (inbound.get("trace_id"), inbound.get("span_id"))
    with tracing.span(f"rpc/{method}", ctx=ctx) as handler_span:
        result = fn(*params)
    trace_id = getattr(handler_span, "trace_id", None)
    if trace_id is None:
        return result, None
    return result, (trace_id, handler_span.span_id)


def envelope(rid, result, handler_ctx) -> Optional[dict]:
    """The response frame (None for a notification). Extra envelope keys
    are legal JSON-RPC (clients read `result`/`error` only): the handler
    span's trace id rides back as `trace`, and the full context as
    `traceCtx`, whose span_id stitches this exact request/response pair
    (a trace id alone is ambiguous under retries and hedges)."""
    if rid is None:
        return None
    response = {"jsonrpc": "2.0", "id": rid, "result": result}
    if handler_ctx is not None:
        response["trace"] = handler_ctx[0]
        response["traceCtx"] = {"trace_id": handler_ctx[0],
                                "span_id": handler_ctx[1]}
    return response


class RPCServer:
    """Threaded JSON-RPC server over TCP (host, port) — port 0 picks a
    free one (`server.address` reports the bound endpoint)."""

    def __init__(self, backend: SimulatedMainchain,
                 host: str = "127.0.0.1", port: int = 0,
                 sig_backend=None, das=None, device=None):
        self.backend = backend
        # where `shard_verifyPeriodBatch` replays the vote log and, when
        # no `sig_backend` is injected, where the verification RPCs run
        # (None: the card, which raises where there is none; "cpu" for
        # the plain versions), on the serving tier's dispatch thread
        self.device = device
        # data-availability sampling provider (a das.service.DASService,
        # or anything with get_sample/da_status): backs the light-client
        # sample surface `shard_getSample` / `shard_daStatus`. None =
        # this process holds no blobs; the methods answer "unknown".
        self._das = das
        self._subscribers: dict = {}  # wfile -> (lock, peer id)
        self._sub_lock = threading.Lock()
        # verification serving seam: handler threads SUBMIT signature
        # work to the coalescing tier instead of driving a backend
        # inline, so concurrent RPC clients share device dispatches
        # (serving/). Built lazily on first use when
        # not injected — chain processes that never verify pay nothing.
        self._sig_backend = sig_backend
        self._sig_serving = None
        self._sig_serving_owned = False
        # fleet drain lifecycle: a DRAINING server refuses NEW
        # verification work with a typed "replica draining" error (the
        # router retries on the next replica) while in-flight requests
        # finish; `shard_health` exports the flag plus the breaker /
        # serving state the router's health sweep reads
        self.draining = False
        self._inflight = 0
        server = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                server._handle_connection(self)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.address = self._tcp.server_address  # (host, bound_port)
        self._thread: Optional[threading.Thread] = None
        self._unsubscribe = backend.subscribe_new_head(self._on_head)
        # shardp2p relay: peer id -> (wfile, write lock); actors in other
        # processes attach here for introduction (authenticated peer
        # table + broadcast); directed payloads flow peer-to-peer over
        # the listeners the peers advertise (p2p/direct.py)
        self._p2p_peers: dict = {}
        self._p2p_meta: dict = {}
        self._p2p_ids = 1
        self._p2p_challenges: dict = {}  # wfile -> pending nonce
        self.p2p_relayed_sends = 0  # directed sends that fell back to us
        self.method_calls: dict = {}  # per-method request counts

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True, name="rpc-server")
        self._thread.start()
        log.info("RPC listening on %s:%d", *self.address)

    def stop(self, grace_s: float = 5.0) -> None:
        """Graceful shutdown: stop admitting NEW verification work,
        give in-flight RPC requests a bounded grace to finish, then
        close the serving tier — whose `PipelinedDispatcher.close(
        wait=True)` semantics drain what it can and FAIL the rest with
        `DispatcherClosed`, so a router-initiated drain never strands a
        caller on a future nothing will resolve."""
        self.draining = True
        deadline = time.monotonic() + grace_s
        while self._inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        if self._unsubscribe is not None:
            self._unsubscribe()
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # detach under the same lock `_serving()` builds under — a
        # handler still lazily building the tier must never race the
        # teardown's write; close() runs outside the lock (it joins
        # serving threads and must not hold the server's lock doing it)
        with self._sub_lock:
            serving = self._sig_serving if self._sig_serving_owned else None
            if serving is not None:
                self._sig_serving = None
        if serving is not None:
            serving.close()

    def drain(self) -> dict:
        """Router/operator-initiated drain: refuse new verification
        work, drain-and-fail the serving queues (in-flight batches get
        their grace, queued futures fail with `DispatcherClosed` /
        `QueueClosed` instead of hanging). The RPC control surface
        (`shard_drain`) calls this; `stop()` completes the shutdown."""
        self.draining = True
        with self._sub_lock:
            serving = self._sig_serving
        if serving is not None and hasattr(serving, "close") \
                and self._sig_serving_owned:
            serving.close()
        return {"draining": True, "inflight": self._inflight}

    # -- head push (eth_subscribe newHeads parity) -------------------------

    def _on_head(self, block) -> None:
        note = (json.dumps({
            "jsonrpc": "2.0",
            "method": "shard_subscription",
            "params": {"subscription": "newHeads",
                       "result": codec.enc_block(block)},
        }) + "\n").encode()
        with self._sub_lock:
            targets = list(self._subscribers.items())
        for wfile, (lock, peer) in targets:
            try:
                with lock:
                    wfile.write(note)
                    wfile.flush()
            except (OSError, ValueError) as exc:
                # connection-level failures only: the peer reset/broke
                # the pipe (OSError) or the handler already closed its
                # wfile (ValueError). Anything else is a server bug and
                # must surface to the head-feed caller, not silently
                # unsubscribe a healthy peer.
                with self._sub_lock:
                    self._subscribers.pop(wfile, None)
                log.warning("dropping head subscriber %s: %s", peer, exc)

    # -- connection loop ---------------------------------------------------

    def _handle_connection(self, handler) -> None:
        try:
            serve_connection(
                handler,
                lambda raw, write_lock: self._dispatch(raw, handler,
                                                       write_lock),
                self._note_inflight)
        finally:
            with self._sub_lock:
                self._subscribers.pop(handler.wfile, None)
                self._p2p_challenges.pop(handler.wfile, None)
                dead = [pid for pid, (wf, _) in self._p2p_peers.items()
                        if wf is handler.wfile]
                for pid in dead:
                    self._p2p_peers.pop(pid, None)
                    self._p2p_meta.pop(pid, None)

    def _note_inflight(self, delta: int) -> None:
        with self._sub_lock:
            self._inflight += delta

    def _dispatch(self, raw: bytes, handler, write_lock) -> Optional[dict]:
        try:
            req = json.loads(raw)
        except json.JSONDecodeError:
            return {"jsonrpc": "2.0", "id": None,
                    "error": {"code": INVALID_REQUEST, "message": "bad json"}}
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params", [])
        handler_ctx = None
        with self._sub_lock:
            self.method_calls[method] = self.method_calls.get(method, 0) + 1
        try:
            if method == "shard_subscribe":
                try:
                    peer = "%s:%d" % handler.client_address[:2]
                except (TypeError, IndexError):
                    peer = repr(handler.client_address)
                with self._sub_lock:
                    self._subscribers[handler.wfile] = (write_lock, peer)
                result = "newHeads"
            elif method == "shard_p2pChallenge":
                import secrets

                nonce = secrets.token_bytes(32)
                with self._sub_lock:
                    self._p2p_challenges[handler.wfile] = nonce
                result = nonce.hex()
            elif method == "shard_p2pAttach":
                handshake = params[0] if params else {}
                self._check_handshake(handshake)
                account = self._check_attach_signature(handshake, handler)
                endpoint = handshake.get("endpoint")
                with self._sub_lock:
                    peer_id = self._p2p_ids
                    self._p2p_ids += 1
                    self._p2p_peers[peer_id] = (handler.wfile, write_lock)
                    self._p2p_meta[peer_id] = {
                        "account": account,
                        "endpoint": (None if endpoint is None
                                     else list(endpoint)),
                        "version": handshake.get(
                            "version", P2P_PROTOCOL_VERSION),
                    }
                result = peer_id
            else:
                fn = getattr(self, "rpc_" + method.replace("shard_", "", 1),
                             None)
                if fn is None:
                    return {"jsonrpc": "2.0", "id": rid,
                            "error": {"code": METHOD_NOT_FOUND,
                                      "message": f"unknown method {method}"}}
                # per-request handler span: parents any serving-tier
                # request spans the handler submits (the cross-process
                # attribution seam); see `traced_call` and `envelope`
                if method in codec.TRACE_PLANE_METHODS:
                    # the trace plane is invisible to tracing (see
                    # codec.TRACE_PLANE_METHODS): no handler span, no
                    # trace fields on the response envelope
                    result = fn(*params)
                else:
                    result, handler_ctx = traced_call(req, method, fn,
                                                      params)
        except SMCRevert as exc:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": REVERT_CODE, "message": str(exc),
                              "data": "SMCRevert"}}
        except Exception as exc:  # noqa: BLE001 - RPC boundary
            log.exception("rpc %s failed", method)
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": INTERNAL_ERROR, "message": str(exc)}}
        return envelope(rid, result, handler_ctx)

    # -- method surface (shard_* namespace) --------------------------------
    # views

    def rpc_blockNumber(self):
        return self.backend.block_number

    def rpc_currentPeriod(self):
        return self.backend.current_period()

    def rpc_blockByNumber(self, number=None):
        return codec.enc_block(self.backend.block_by_number(number))

    def rpc_shardCount(self):
        return self.backend.smc.shard_count

    def rpc_getNotaryInCommittee(self, sender, shard_id):
        return codec.enc_bytes(self.backend.get_notary_in_committee(
            Address20(codec.dec_bytes(sender)), shard_id))

    def rpc_committeeContext(self):
        ctx = self.backend.committee_context()
        return {
            "period": ctx["period"],
            "sampleSize": ctx["sample_size"],
            "blockhash": codec.enc_bytes(ctx["blockhash"]),
            "pool": [None if a is None else codec.enc_bytes(a)
                     for a in ctx["pool"]],
        }

    def rpc_notaryRegistry(self, address):
        return codec.enc_registry(self.backend.notary_registry(
            Address20(codec.dec_bytes(address))))

    def rpc_collationRecord(self, shard_id, period):
        return codec.enc_record(self.backend.collation_record(shard_id, period))

    def rpc_lastSubmittedCollation(self, shard_id):
        return self.backend.last_submitted_collation(shard_id)

    def rpc_lastApprovedCollation(self, shard_id):
        return self.backend.last_approved_collation(shard_id)

    def rpc_notaryByPoolIndex(self, index):
        addr = self.backend.notary_by_pool_index(index)
        return None if addr is None else codec.enc_bytes(addr)

    def rpc_hasVoted(self, shard_id, index):
        return self.backend.smc.has_voted(shard_id, index)

    def rpc_getVoteCount(self, shard_id):
        return self.backend.smc.get_vote_count(shard_id)

    def rpc_balanceOf(self, address):
        return self.backend.balance_of(Address20(codec.dec_bytes(address)))

    def rpc_transactionReceipt(self, tx_hash):
        receipt = self.backend.transaction_receipt(
            Hash32(codec.dec_bytes(tx_hash)))
        return None if receipt is None else codec.enc_receipt(receipt)

    def rpc_traceTransaction(self, tx_hash):
        """The debug_traceTransaction role (`eth/api_tracer.go`) for the
        native engine: the SMC's emitted events ARE the execution trace
        (one entry per state-machine effect), returned with the receipt
        frame. None for unknown hashes."""
        receipt = self.backend.transaction_receipt(
            Hash32(codec.dec_bytes(tx_hash)))
        if receipt is None:
            return None
        def enc_arg(value):
            if isinstance(value, (bytes, bytearray)) \
                    or hasattr(value, "__bytes__"):  # Address20 / Hash32
                return codec.enc_bytes(bytes(value))
            return value

        return {
            "txHash": codec.enc_bytes(receipt.tx_hash),
            "status": receipt.status,
            "blockNumber": receipt.block_number,
            "trace": [{"event": e.name,
                       "args": {k: enc_arg(v) for k, v in e.args.items()}}
                      for e in receipt.events],
        }

    def rpc_verifyPeriodBatch(self, period):
        """The chain-side vote-log replay through the batched vote kernel,
        run on the serving tier's dispatch thread like every other device
        call of this process (a handler thread never launches)."""
        return self._on_dispatch_thread(
            lambda: self.backend.verify_period_batch(period,
                                                     device=self.device))

    def _on_dispatch_thread(self, fn):
        """Run `fn` on the serving tier's one dispatch thread and wait for
        its result (directly where the composition has no batcher)."""
        batcher, probe, hops = None, self._serving(), 0
        while probe is not None and hops < 8 and batcher is None:
            batcher = getattr(probe, "batcher", None)
            probe, hops = getattr(probe, "inner", None), hops + 1
        if batcher is None:
            return fn()
        return batcher.call_on_dispatch_thread(fn)

    # -- verification serving (the coalescing tier) ------------------------

    def _serving(self):
        """The shared serving backend, built on first use. Injected
        backends that already expose `submit` (a `ServingSigBackend`)
        are used as-is (and not closed by us); a plain `SigBackend`
        gets wrapped."""
        with self._sub_lock:
            if self._sig_serving is None:
                inner = self._sig_backend
                if inner is not None and hasattr(inner, "submit"):
                    self._sig_serving = inner
                else:
                    from gethsharding_tpu_torch.device import resolve_device
                    from gethsharding_tpu_torch.serving import ServingSigBackend
                    from gethsharding_tpu_torch.sigbackend import build_backend

                    if inner is None:
                        # the port's kernels on `self.device` (None: the
                        # card, which raises where there is none)
                        inner = build_backend(
                            "torch", resolve_device(self.device))
                    self._sig_serving = ServingSigBackend(inner)
                    self._sig_serving_owned = True
            return self._sig_serving

    def _check_accepting(self, method: str) -> None:
        if self.draining:
            # the router's retry ladder keys on this phrase: a draining
            # replica is a routing fact, not a caller error
            raise RuntimeError(f"replica draining: {method} refused")

    def rpc_ecrecover(self, digests, sigs, klass=None, tenant=None):
        """Batch address recovery for external clients (txpool feeders,
        light verifiers). The serving backend's sync face enqueues and
        parks the handler thread on the request's future — while this
        batch waits out its flush window, other connection threads
        enqueue into the SAME dispatch, so N concurrent small requests
        cost one device batch instead of N. (The sync face also records
        the future_wake trace phase — one await-then-wake sequence for
        every entry point, serving/backend.py.) The optional trailing
        `klass`/`tenant` params tag the request's admission class and
        quota bucket (serving/classes.py) — a catch-up replayer passes
        ``"catchup_replay"`` and is shed first under overload."""
        self._check_accepting("shard_ecrecover")
        from gethsharding_tpu_torch.serving.classes import admission_class

        serving = self._serving()
        digests = [codec.dec_bytes(d) for d in digests]
        sigs = [codec.dec_bytes(s) for s in sigs]
        if klass is not None or tenant is not None:
            # tenant without class still enters the context: the quota
            # must charge the tenant even when the caller says nothing
            # about class (default interactive, this op's default)
            with admission_class(klass or "interactive", tenant):
                out = serving.ecrecover_addresses(digests, sigs)
        else:
            out = serving.ecrecover_addresses(digests, sigs)
        return [None if addr is None else codec.enc_bytes(bytes(addr))
                for addr in out]

    def rpc_verifyAggregates(self, messages, agg_sigs, agg_pks,
                             klass=None, tenant=None):
        """Batch aggregate-vote verification over the serving tier (the
        coalescing analog of the notary's bls_verify_aggregates); the
        optional trailing params tag the admission class like
        shard_ecrecover's."""
        self._check_accepting("shard_verifyAggregates")
        from gethsharding_tpu_torch.serving.classes import admission_class

        serving = self._serving()
        args = ([codec.dec_bytes(m) for m in messages],
                [codec.dec_g1(s) for s in agg_sigs],
                [codec.dec_g2(p) for p in agg_pks])
        if klass is not None or tenant is not None:
            # see shard_ecrecover: a tenant tag alone still charges the
            # quota under this op's default class
            with admission_class(klass or "interactive", tenant):
                out = serving.bls_verify_aggregates(*args)
        else:
            out = serving.bls_verify_aggregates(*args)
        return [bool(b) for b in out]

    def rpc_verifyCommittees(self, messages, sig_rows, pk_rows,
                             pk_row_keys=None, klass=None, tenant=None):
        """The committee plane over the wire: batch aggregate-and-
        verify of per-row vote signatures + member pubkeys through the
        serving tier (the op the notary's period audit drives — with
        this RPC a fleet frontend balances audits cross-process
        instead of pinning them to the caller's device). `pk_row_keys`
        are the optional per-row pk-plane cache keys (wire form:
        codec.enc_pk_row_keys), so a repeat committee stays
        device-resident on the replica exactly as it would in-process.
        The optional trailing `klass`/`tenant` tag admission like
        shard_ecrecover's (a notary's bulk_audit context rides the
        wire as an explicit klass; tenant-only still charges the quota
        under this op's default class)."""
        self._check_accepting("shard_verifyCommittees")
        from gethsharding_tpu_torch.serving.classes import admission_class

        serving = self._serving()
        args = ([codec.dec_bytes(m) for m in messages],
                codec.dec_g1_rows(sig_rows),
                codec.dec_g2_rows(pk_rows))
        keys = None if pk_row_keys is None else [
            None if k is None else str(k) for k in pk_row_keys]
        if klass is not None or tenant is not None:
            with admission_class(klass or "interactive", tenant):
                out = serving.bls_verify_committees(*args,
                                                    pk_row_keys=keys)
        else:
            out = serving.bls_verify_committees(*args, pk_row_keys=keys)
        return [bool(b) for b in out]

    def rpc_dasVerify(self, chunks, indices, proofs, roots,
                      klass=None, tenant=None):
        """The DAS sample-verdict plane over the wire: one verdict per
        (chunk, index, proof path, root) row through the serving tier
        (serving op `das_verify`, default class bulk_audit via the
        per-op map). Malformed rows cost a False verdict, never an
        error — the same hostile-input contract as the in-process op."""
        self._check_accepting("shard_dasVerify")
        from gethsharding_tpu_torch.serving.classes import admission_class

        serving = self._serving()
        args = codec.dec_das_call(chunks, indices, proofs, roots)
        if klass is not None or tenant is not None:
            with admission_class(klass or "bulk_audit", tenant):
                out = serving.das_verify_samples(*args)
        else:
            out = serving.das_verify_samples(*args)
        return [bool(b) for b in out]

    def rpc_dasPolyVerify(self, commitments, index_rows, eval_rows,
                          proofs, ns, klass=None, tenant=None):
        """The DAS multiproof-verdict plane over the wire: one verdict
        per sampled collation row (64-byte poly commitment, sampled
        index set, claimed evaluations, 64-byte multiproof, domain
        size) through the serving tier (serving op `das_poly_verify`,
        default class bulk_audit via the per-op map; light clients
        pass `interactive`). Malformed rows cost a False verdict,
        never an error."""
        self._check_accepting("shard_dasPolyVerify")
        from gethsharding_tpu_torch.serving.classes import admission_class

        serving = self._serving()
        args = codec.dec_das_poly_call(commitments, index_rows, eval_rows,
                                       proofs, ns)
        if klass is not None or tenant is not None:
            with admission_class(klass or "bulk_audit", tenant):
                out = serving.das_verify_multiproofs(*args)
        else:
            out = serving.das_verify_multiproofs(*args)
        return [bool(b) for b in out]

    def rpc_health(self):
        """The replica-health surface a fleet router sweeps: the drain
        flag, the failover breaker's state (if the injected backend
        composes one), and the serving tier's per-class queue depths.
        One round trip, cheap enough for sub-second polling."""
        from gethsharding_tpu_torch.resilience.breaker import breaker_of

        payload = {"draining": self.draining,
                   # minus one: this health request is itself in flight
                   "inflight": max(0, self._inflight - 1),
                   "breaker": None, "serving": None}
        backend = self._sig_backend
        if backend is not None:
            breaker = breaker_of(backend)
            if breaker is not None:
                payload["breaker"] = breaker.state_name
        with self._sub_lock:
            serving = self._sig_serving
        batcher = getattr(serving, "batcher", None)
        if batcher is None:
            # the serving tier may hide under a failover/soundness face
            probe, hops = serving, 0
            while probe is not None and hops < 8 and batcher is None:
                batcher = getattr(probe, "batcher", None)
                probe, hops = getattr(probe, "inner", None), hops + 1
        if batcher is not None:
            payload["serving"] = {
                "shed": batcher.shed_by_class(),
                "quota_rejections": batcher.quota_rejections(),
                "depth": {op: batcher.class_depths(op)
                          for op in batcher.dispatch_counts},
            }
        return payload

    def rpc_drain(self):
        """Router/operator-initiated drain (see `drain()`)."""
        return self.drain()

    def rpc_metrics(self):
        """Metrics federation: this replica's full registry snapshot in
        ONE round trip — the scrape the fleet router's background
        health sweep folds into its own registry under
        ``fleet/replica/<name>/...`` (plus fleet-level aggregates), so
        a router's /status answers "which replica's chip is slow"
        without dialing N dashboards. Snapshots are plain JSON-safe
        dicts (counters/gauges/timers/histograms)."""
        from gethsharding_tpu_torch.metrics import DEFAULT_REGISTRY

        return DEFAULT_REGISTRY.snapshot()

    # -- the trace export plane and the profiler: not ported -------------

    @staticmethod
    def _unported(method: str, module: str):
        raise RuntimeError(
            f"{method}: the port has no {module} yet (ROADMAP.md, queue A "
            f"item 8)")

    def rpc_traceHandshake(self):
        self._unported("shard_traceHandshake", "tracing/export.py")

    def rpc_traceExport(self, payload):
        self._unported("shard_traceExport", "fleettrace/")

    def rpc_traceAttribution(self):
        self._unported("shard_traceAttribution", "fleettrace/")

    def rpc_traceExemplars(self, limit=8):
        self._unported("shard_traceExemplars", "fleettrace/")

    def rpc_profileStart(self, mode=None, hz=None):
        self._unported("shard_profileStart", "devscope/")

    def rpc_profileStop(self):
        self._unported("shard_profileStop", "devscope/")

    def rpc_profileStacks(self):
        self._unported("shard_profileStacks", "devscope/")

    def rpc_devscopeStatus(self):
        self._unported("shard_devscopeStatus", "devscope/")

    def rpc_servingStats(self):
        """Dispatch/coalescing counters of the serving tier (None until
        the first submit builds it), and the port's own: this process's
        kernel launches by name so far and the device backend's
        `last_timing` (its last call's launches, G2 bytes shipped, hit
        rows), which a fleet's caller reads to see what a replica ran."""
        with self._sub_lock:
            serving = self._sig_serving
        if serving is None or not hasattr(serving, "batcher"):
            return None
        from gethsharding_tpu_torch.ops import _build

        probe, hops, timing = serving, 0, None
        while probe is not None and hops < 8 and timing is None:
            timing = getattr(probe, "last_timing", None)
            probe, hops = getattr(probe, "inner", None), hops + 1
        if timing is not None:
            timing = {k: (v.item() if hasattr(v, "item") else v)
                      for k, v in timing.items()}
        return {"dispatches": dict(serving.batcher.dispatch_counts),
                "shed": serving.batcher.shed_counts(),
                "launches": {name: n for name, n in
                             _build.launch_counts().items() if n},
                "last_timing": timing}

    # -- data-availability sampling (the light-client sample surface) ------

    def rpc_getSample(self, shard_id, period, indices):
        """Sampled chunks + inclusion proofs for (shard, period) from
        this process's DAS provider — the RPC (light-client) face of
        the shardp2p DASampleRequest flow: a client that can reach no
        sampling peers still gets proof-carrying samples it verifies
        locally against the returned commitment. None when no provider
        holds the blob."""
        if self._das is None:
            return None
        from gethsharding_tpu_torch.das.service import MAX_SAMPLE_INDICES

        status = self._das.da_status(int(shard_id), int(period))
        if not status.get("known"):
            return None
        samples = []
        # same per-request cap as the p2p serving side
        for index in list(indices)[:MAX_SAMPLE_INDICES]:
            sample = self._das.get_sample(int(shard_id), int(period),
                                          int(index))
            if sample is None:
                continue
            samples.append({
                "index": sample["index"],
                "chunk": codec.enc_bytes(sample["chunk"]),
                "proof": [codec.enc_bytes(node)
                          for node in sample["proof"]],
            })
        commitment = self._das.commitment(int(shard_id), int(period))
        out = {
            "dasRoot": codec.enc_bytes(commitment.das_root),
            "chunkRoot": codec.enc_bytes(commitment.chunk_root),
            "k": commitment.k,
            "n": commitment.n,
            "bodyLen": commitment.body_len,
            "signature": codec.enc_bytes(commitment.signature),
            "samples": samples,
        }
        # poly plane: under --da-proofs=poly the k merkle paths above
        # collapse to ONE constant-size multiproof over the whole set
        # (das/pcs.py) — the client verifies it against polyCommitment
        poly = bytes(getattr(commitment, "poly_commitment", b""))
        if poly:
            out["polyCommitment"] = codec.enc_bytes(poly)
        if getattr(self._das, "proof_mode", "merkle") == "poly":
            multi = self._das.get_multiproof(
                int(shard_id), int(period),
                [int(i) for i in list(indices)[:MAX_SAMPLE_INDICES]])
            if multi is not None:
                out["multiproof"] = {
                    "indices": list(multi["indices"]),
                    "chunks": [codec.enc_bytes(c)
                               for c in multi["chunks"]],
                    "proof": codec.enc_bytes(multi["proof"]),
                }
        return out

    def rpc_daStatus(self, shard_id, period):
        """Is a DAS commitment known for (shard, period), and what
        shape is the erasure extension? `known: false` with
        `provider: false` means this process runs no DAS plane at
        all."""
        if self._das is None:
            return {"known": False, "provider": False,
                    "shard_id": int(shard_id), "period": int(period)}
        status = self._das.da_status(int(shard_id), int(period))
        status["provider"] = True
        return status

    # transactions

    def rpc_registerNotary(self, sender, bls_pubkey=None, bls_pop=None):
        return codec.enc_receipt(self.backend.register_notary(
            Address20(codec.dec_bytes(sender)),
            bls_pubkey=codec.dec_g2(bls_pubkey),
            bls_pop=codec.dec_g1(bls_pop)))

    def rpc_deregisterNotary(self, sender):
        return codec.enc_receipt(self.backend.deregister_notary(
            Address20(codec.dec_bytes(sender))))

    def rpc_releaseNotary(self, sender):
        return codec.enc_receipt(self.backend.release_notary(
            Address20(codec.dec_bytes(sender))))

    def rpc_addHeader(self, sender, shard_id, period, chunk_root, signature):
        return codec.enc_receipt(self.backend.add_header(
            Address20(codec.dec_bytes(sender)), shard_id, period,
            Hash32(codec.dec_bytes(chunk_root)),
            codec.dec_bytes(signature)))

    def rpc_submitVote(self, sender, shard_id, period, index, chunk_root,
                       bls_sig=None):
        return codec.enc_receipt(self.backend.submit_vote(
            Address20(codec.dec_bytes(sender)), shard_id, period, index,
            Hash32(codec.dec_bytes(chunk_root)),
            bls_sig=codec.dec_g1(bls_sig)))

    # dev-mode chain control (the SimulatedBackend Commit/FastForward
    # surface, exposed so a test or orchestrator process can steer the chain)

    # shardp2p relay (the cross-process feed-bus transport; see
    # p2p/remote.py)

    def _p2p_push(self, peer_id, note_bytes) -> bool:
        with self._sub_lock:
            entry = self._p2p_peers.get(peer_id)
        if entry is None:
            return False
        wfile, lock = entry
        try:
            with lock:
                wfile.write(note_bytes)
                wfile.flush()
            return True
        except OSError:
            with self._sub_lock:
                self._p2p_peers.pop(peer_id, None)
            return False

    @staticmethod
    def _p2p_note(to_id, from_id, kind, payload) -> bytes:
        return (json.dumps({
            "jsonrpc": "2.0", "method": "shard_p2p",
            "params": {"to": to_id, "from": from_id, "type": kind,
                       "payload": payload},
        }) + "\n").encode()

    def _check_handshake(self, handshake: dict) -> None:
        """Protocol/version/network gate (p2p/protocol.go + the eth status
        exchange, scoped to the relay's trust model). Absent fields pass —
        an attacher that states nothing claims nothing — but any STATED
        field must match."""
        proto = handshake.get("protocol", P2P_PROTOCOL_NAME)
        if proto != P2P_PROTOCOL_NAME:
            raise ValueError(f"protocol mismatch: {proto!r}")
        version = handshake.get("version", P2P_PROTOCOL_VERSION)
        if version != P2P_PROTOCOL_VERSION:
            raise ValueError(
                f"version mismatch: peer {version}, ours {P2P_PROTOCOL_VERSION}")
        network = handshake.get("network_id")
        ours = self.backend.config.network_id
        if network is not None and network != ours:
            raise ValueError(f"network mismatch: peer {network}, ours {ours}")

    def _check_attach_signature(self, handshake: dict, handler) -> str:
        """Authenticated attach: the claimed account must be PROVEN by a
        secp256k1 signature over a challenge this relay issued on this
        connection. Unsigned or forged attaches are refused — the
        reference's RLPx authenticates both ends cryptographically
        (p2p/rlpx.go:178); a self-claimed identity would let any process
        impersonate a notary on the data-availability plane."""
        from gethsharding_tpu_torch.p2p import direct

        account = handshake.get("account")
        sig_hex = handshake.get("sig")
        if not account or not sig_hex:
            raise ValueError(
                "unsigned attach refused: account + sig required")
        with self._sub_lock:
            challenge = self._p2p_challenges.pop(handler.wfile, None)
        if challenge is None:
            raise ValueError(
                "no pending challenge: call shard_p2pChallenge first")
        digest = direct.attach_digest(self.backend.config.network_id,
                                      challenge)
        if not direct.prove(digest, bytes.fromhex(sig_hex), account):
            raise ValueError(
                "attach signature does not prove the claimed account")
        return account.lower().removeprefix("0x")

    def rpc_p2pPeers(self):
        """Attached-peer table (admin_peers parity for the relay)."""
        with self._sub_lock:
            return [{"id": pid, **self._p2p_meta.get(pid, {})}
                    for pid in sorted(self._p2p_peers)]

    def rpc_networkId(self):
        return self.backend.config.network_id

    def rpc_auditData(self, period):
        """Bulk period-audit pull (records + vote sigs + voter pubkeys):
        ONE round trip for what would be O(shards) record reads plus
        O(votes) registry lookups (mainchain/mirror.assemble_audit_data)."""
        from gethsharding_tpu_torch.mainchain.mirror import assemble_audit_data

        return assemble_audit_data(self.backend, period)

    def rpc_mirrorSnapshot(self):
        """Bulk state-mirror pull: ONE round trip for what would be
        ~3 calls per shard (mainchain/mirror.py)."""
        from gethsharding_tpu_torch.mainchain.mirror import assemble_snapshot

        return assemble_snapshot(self.backend)

    def rpc_chainConfig(self):
        """The chain process's protocol constants — attached actors adopt
        these instead of trusting their own flags (one source of truth
        for period/committee math across processes)."""
        import dataclasses

        return dataclasses.asdict(self.backend.config)

    def rpc_p2pDetach(self, peer_id):
        with self._sub_lock:
            self._p2p_peers.pop(peer_id, None)
            self._p2p_meta.pop(peer_id, None)
        return True

    def rpc_p2pPeerInfo(self, peer_id):
        """Introduction lookup: the proven account + direct-listener
        endpoint for one peer (None if unknown)."""
        with self._sub_lock:
            meta = self._p2p_meta.get(peer_id)
        return None if meta is None else dict(meta)

    def rpc_p2pStats(self):
        return {"relayed_sends": self.p2p_relayed_sends,
                "peers": len(self._p2p_peers)}

    def rpc_methodStats(self):
        """Per-method request counts (chatter observability: the mirror's
        O(1)-per-head contract is asserted against these)."""
        with self._sub_lock:
            return dict(self.method_calls)

    def rpc_p2pSend(self, from_id, to_id, kind, payload):
        # handler threads are concurrent: the relayed-sends count is a
        # read-modify-write and takes the same lock as the peer tables
        with self._sub_lock:
            self.p2p_relayed_sends += 1
        return self._p2p_push(to_id,
                              self._p2p_note(to_id, from_id, kind, payload))

    def rpc_p2pBroadcast(self, from_id, kind, payload):
        with self._sub_lock:
            targets = [pid for pid in self._p2p_peers if pid != from_id]
        delivered = 0
        for pid in targets:
            if self._p2p_push(pid, self._p2p_note(pid, from_id, kind,
                                                  payload)):
                delivered += 1
        return delivered

    def rpc_fund(self, address, amount):
        self.backend.fund(Address20(codec.dec_bytes(address)), amount)
        return True

    def rpc_commit(self):
        return codec.enc_block(self.backend.commit())

    def rpc_fastForward(self, periods):
        self.backend.fast_forward(periods)
        return self.backend.block_number

    def rpc_setHead(self, number):
        """Dev-mode rollback (debug_setHead parity)."""
        return codec.enc_block(self.backend.set_head(number))

    def rpc_blockRange(self, start, end):
        """Blocks [start, end] inclusive — the header-download surface a
        follower chain process syncs from (eth/downloader role)."""
        start, end = int(start), int(end)
        if start < 0 or end > self.backend.block_number or end - start > 4096:
            raise ValueError("bad block range")
        return [codec.enc_block(self.backend.block_by_number(n))
                for n in range(start, end + 1)]

    def rpc_stateCheckpoint(self):
        """Full-state checkpoint at the current head (the fast-sync
        pivot-state analog) for follower chain processes."""
        return self.backend.state_checkpoint()

    def rpc_stateSeq(self):
        """Cheap state identity for followers' steady-state polling."""
        return self.backend.state_seq()
