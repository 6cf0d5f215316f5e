"""Standalone fleet frontend: the router as its own failure domain (the
port's copy of the JAX package's `fleet/frontend.py`).

`python -m gethsharding_tpu_torch.fleet.frontend --replica HOST:PORT ...`

Until this process existed the router lived IN the caller: an actor
composing `RouterSigBackend` died with its router, and every actor
process re-learned replica health from scratch. The frontend is the
reference design's availability boundary made real — actors reach a
verification plane over RPC (`geth sharding --actor notary` dials a
node; here they dial the frontend), and the frontend owns:

- the **replica registry** — one `RpcReplicaBackend` per
  ``--replica HOST:PORT``, redialing lazily after a connection loss so
  a replica killed and restarted on the same endpoint re-enters
  without operator action;
- the **health sweep** — the router's background thread reads
  ``shard_health``, scrapes ``shard_metrics`` federation snapshots,
  probes draining replicas, and runs the hedge-storm watch;
- **drain orchestration** — ``shard_drainReplica`` /
  ``shard_undrainReplica`` drain one replica through the breaker-probe
  path, ``shard_drain`` drains the frontend itself (new verification
  work refused with the typed "replica draining" phrase a PARENT
  router retries, so frontends can be stacked/fleeted too);
- **request hedging** — ``--fleet-hedge-ms`` /
  ``GETHSHARDING_TORCH_FLEET_HEDGE_MS`` arms the router's tail-cutting
  duplicate dispatch (fleet/router.py).

The served surface is the FULL serving RPC plane set —
``shard_ecrecover`` / ``shard_verifyAggregates`` /
``shard_verifyCommittees`` / ``shard_dasVerify`` — plus the
``shard_health`` / ``shard_metrics`` / ``shard_fleetStatus`` control
plane, over `rpc/server.py`'s newline-delimited JSON-RPC 2.0 framing
(`serve_connection`, `traced_call`, `envelope`) and `rpc/codec.py`, so
`RPCClient` and `RpcReplicaBackend` dial a frontend exactly as they dial
a chain_server replica. Inbound `trace`
envelopes are adopted (the caller's span context parents the
frontend's route/attempt spans, which parent the replica's handler
spans — one stitched trace across three processes).

Elastic additions:

- **runtime membership** — ``shard_addReplica`` /
  ``shard_removeReplica`` / ``shard_fleetReconfigure`` /
  ``shard_membership`` drive the mutable registry
  (fleet/membership.py): admissions enter DRAINING and earn HEALTHY
  through the health sweep, removals drain before they detach, and
  every topology change bumps a journaled epoch
  (``--membership-journal`` / ``GETHSHARDING_TORCH_FLEET_EPOCH_JOURNAL``)
  so a restarted frontend reconverges to the last acked topology;
- **replicated frontends** — ``--peer HOST:PORT`` names the OTHER
  frontends of a fleet-of-frontends: a background gossip thread
  exchanges ``(epoch, endpoints)`` and converges last-writer-wins
  (``GETHSHARDING_TORCH_FLEET_EPOCH_GOSSIP_S`` paces it), local mutations
  push eagerly, and actors fail over between frontends with
  `rpc.client.FrontendPool` on the same draining/connection-lost
  taxonomy the router uses against replicas;
- **autoscaling** — ``--autoscale`` boots the SLO-driven controller
  (fleet/autoscaler.py) over this frontend's membership plane, with a
  ``ChainServerSpawner`` creating/reclaiming replica processes
  (``--autoscale-backend`` defaults to ``torch``, the port's kernels on
  the card; the JAX package's defaults to ``python``).

The frontend process resolves no device and launches nothing: its
replicas run the kernels. At exit it writes one line ``frontend at
exit: {json}`` on stderr with its kernel launches (none), whether it
ever made a CUDA context (it does not), the RPC methods it served, the
replicas' states and the hedge ledger. ``--trace`` collects its spans
in the port's in-memory tracer and adopts inbound trace envelopes;
``--trace-out``, ``--fleettrace`` and the trace-plane RPCs refuse,
naming ``tracing/export.py`` and ``fleettrace/``, which the port has
not yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socketserver
import sys
import threading
import time
from typing import List, Optional

from gethsharding_tpu_torch import metrics, tracing
from gethsharding_tpu_torch.fleet.membership import (
    DuplicateReplicaError,
    FleetMembership,
    MembershipJournal,
    UnknownReplicaError,
)
from gethsharding_tpu_torch.fleet.router import (
    AllReplicasDraining,
    FleetRouter,
    Replica,
    RpcReplicaBackend,
)
from gethsharding_tpu_torch.resilience.errors import DeadlineExceeded
from gethsharding_tpu_torch.rpc.server import (INTERNAL_ERROR,
                                               INVALID_REQUEST,
                                               METHOD_NOT_FOUND, RPCServer,
                                               envelope, serve_connection,
                                               traced_call)
from gethsharding_tpu_torch.serving.queue import ServingOverloadError

log = logging.getLogger("fleet.frontend")

OVERLOAD_CODE = -32010  # typed: shed / all-draining / deadline / drain
MEMBERSHIP_CODE = -32011  # typed: duplicate / unknown endpoint

# caller-visible failures that are the fleet's WEATHER, not a bug: they
# ship with their class name on the wire under OVERLOAD_CODE so a
# caller can tell a shed from a crash. ServingOverloadError covers the
# shed/quota/expiry family.
TYPED_FAILURES = (AllReplicasDraining, ServingOverloadError,
                  DeadlineExceeded)

# control-plane mistakes with their own code: an operator (or a peer's
# gossip) naming an endpoint that is already / never was a member gets
# the class name back, never a logged internal error
MEMBERSHIP_FAILURES = (DuplicateReplicaError, UnknownReplicaError)


class FrontendServer:
    """Threaded JSON-RPC server over TCP serving a `FleetRouter`'s
    verification planes (port 0 picks a free one; `.address` reports
    the bound endpoint). Owns the router: `stop()` closes it, which
    stops the health sweep and closes every replica backend."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0,
                 membership: Optional[FleetMembership] = None,
                 peers: Optional[List[str]] = None,
                 gossip_interval_s: Optional[float] = None):
        self.router = router
        self.membership = membership
        self.autoscaler = None  # attach_autoscaler wires one
        # frontend-level drain: refuse NEW verification work with the
        # typed "replica draining" phrase (a parent router retries its
        # next frontend) while in-flight requests finish
        self.draining = False
        self._inflight = 0
        self._lock = threading.Lock()
        self.method_calls: dict = {}
        # peer frontends (a fleet OF frontends): membership epochs
        # gossip between them, last-writer-wins on the epoch counter
        self.peers = [str(p) for p in (peers or [])]
        if gossip_interval_s is None:
            gossip_interval_s = float(os.environ.get(
                "GETHSHARDING_TORCH_FLEET_EPOCH_GOSSIP_S", "1.0") or 1.0)
        self.gossip_interval_s = gossip_interval_s
        self._peer_clients: dict = {}
        self._peer_lock = threading.Lock()
        self._stop_gossip = threading.Event()
        self._gossip_thread: Optional[threading.Thread] = None
        server = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                server._handle_connection(self)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.address = self._tcp.server_address
        self._thread: Optional[threading.Thread] = None
        self._conns: set = set()  # live connection sockets, severed on stop

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True,
            name="fleet-frontend")
        self._thread.start()
        if self.peers and self.membership is not None:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop, daemon=True,
                name="fleet-gossip")
            self._gossip_thread.start()
        log.info("fleet frontend listening on %s:%d", *self.address)

    def attach_autoscaler(self, autoscaler) -> None:
        """Wire (and start) the SLO-driven autoscale loop over this
        frontend's membership plane; `stop()` owns its shutdown."""
        self.autoscaler = autoscaler
        autoscaler.start()

    def stop(self, grace_s: float = 5.0, notice_s: float = 0.1) -> None:
        """Graceful shutdown, DRAIN BEFORE SEVER: mark the frontend
        draining and keep answering for a short notice window
        (`notice_s`) so callers racing the shutdown get the typed
        "replica draining" refusal — a `FrontendPool` peer fails over
        on it without burning a retry on a bare connection reset. Then
        give in-flight requests a bounded grace and SEVER the remaining
        connections (an in-flight caller gets the typed connection
        loss its retry policy handles — never a response that will
        silently never come) and close the router (health sweep
        joined, hedge pool drained, replica backends closed)."""
        import socket as socket_mod

        self.draining = True
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self._stop_gossip.set()
        now = time.monotonic()
        notice_deadline = now + max(0.0, notice_s)
        deadline = now + grace_s
        while time.monotonic() < deadline:
            if self._inflight == 0 and time.monotonic() >= notice_deadline:
                break
            time.sleep(0.01)
        self._tcp.shutdown()
        self._tcp.server_close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket_mod.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._gossip_thread is not None:
            self._gossip_thread.join(timeout=2.0)
        with self._peer_lock:
            clients, self._peer_clients = dict(self._peer_clients), {}
        for client in clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001 - already dead
                pass
        self.router.close()

    # -- membership gossip (fleet OF frontends) ----------------------------

    def _peer_call(self, peer: str, method: str, *params):
        """One control-plane RPC against a peer frontend, on a cached
        (lazily redialed) client; any failure drops the client so the
        next call redials — a restarted peer re-enters the gossip
        without operator action."""
        from gethsharding_tpu_torch.rpc.client import RPCClient

        with self._peer_lock:
            client = self._peer_clients.get(peer)
        if client is None:
            host, port = peer.rsplit(":", 1)
            client = RPCClient(host, int(port), timeout=5.0)
            with self._peer_lock:
                if self._peer_clients.get(peer) is None:
                    self._peer_clients[peer] = client
                else:  # lost a benign race with another dialer
                    client.close()
                    client = self._peer_clients[peer]
        try:
            return client.call(method, *params)
        except Exception:
            with self._peer_lock:
                if self._peer_clients.get(peer) is client:
                    del self._peer_clients[peer]
            try:
                client.close()
            except Exception:  # noqa: BLE001 - already dead
                pass
            raise

    def _gossip_loop(self) -> None:
        while not self._stop_gossip.wait(self.gossip_interval_s):
            try:
                self.gossip_once()
            except Exception:  # noqa: BLE001 - gossip must survive
                log.exception("membership gossip failed")

    def gossip_once(self) -> int:
        """Pull every peer's ``(epoch, endpoints)`` and adopt any
        strictly newer one (last-writer-wins). Returns the number of
        adoptions — two frontends that diverged during a partition
        converge within one gossip interval of it healing."""
        if self.membership is None:
            return 0
        adopted = 0
        for peer in self.peers:
            try:
                snap = self._peer_call(peer, "shard_membership")
            except Exception:  # noqa: BLE001 - peer down: retry next tick
                continue
            if not isinstance(snap, dict):
                continue
            try:
                if self.membership.adopt(int(snap.get("epoch", 0)),
                                         snap.get("endpoints") or []):
                    adopted += 1
            except Exception:  # noqa: BLE001 - a bad payload must not
                log.exception("adopting gossip from %s failed", peer)
        return adopted

    def _push_topology(self) -> None:
        """Eager push after a LOCAL mutation: offer the new epoch to
        every peer so convergence does not wait for their next pull.
        Best-effort — a down peer catches up by gossip later."""
        if self.membership is None or not self.peers:
            return
        snap = self.membership.snapshot()
        for peer in self.peers:
            try:
                self._peer_call(peer, "shard_fleetReconfigure",
                                snap["endpoints"], snap["epoch"])
            except Exception:  # noqa: BLE001 - peer down: gossip heals
                log.info("membership push to %s failed (gossip will "
                         "converge it)", peer)

    # -- connection loop (rpc/server.py framing) ---------------------------

    def _handle_connection(self, handler) -> None:
        with self._lock:
            self._conns.add(handler.connection)
        try:
            serve_connection(handler,
                             lambda raw, write_lock: self._dispatch(raw),
                             self._note_inflight,
                             name="frontend-conn-worker")
        finally:
            with self._lock:
                self._conns.discard(handler.connection)

    def _note_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta

    def _dispatch(self, raw: bytes) -> Optional[dict]:
        try:
            req = json.loads(raw)
        except json.JSONDecodeError:
            return {"jsonrpc": "2.0", "id": None,
                    "error": {"code": INVALID_REQUEST,
                              "message": "bad json"}}
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params", [])
        with self._lock:
            self.method_calls[method] = self.method_calls.get(method, 0) + 1
        fn = getattr(self, "rpc_" + method.replace("shard_", "", 1), None)
        if fn is None:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": METHOD_NOT_FOUND,
                              "message": f"unknown method {method}"}}
        try:
            result, handler_ctx = traced_call(req, method, fn, params)
        except Exception as exc:  # noqa: BLE001 - RPC boundary
            # typed overload/drain failures keep their class name on
            # the wire so a caller can tell a shed from a bug;
            # everything else is internal
            if isinstance(exc, MEMBERSHIP_FAILURES):
                return {"jsonrpc": "2.0", "id": rid,
                        "error": {"code": MEMBERSHIP_CODE,
                                  "message":
                                      f"{type(exc).__name__}: {exc}"}}
            typed = isinstance(exc, TYPED_FAILURES) or (
                isinstance(exc, RuntimeError)
                and str(exc).startswith("replica draining"))
            if not typed:
                log.exception("frontend rpc %s failed", method)
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": OVERLOAD_CODE if typed
                              else INTERNAL_ERROR,
                              "message": f"{type(exc).__name__}: {exc}"}}
        return envelope(rid, result, handler_ctx)

    # -- the verification planes -------------------------------------------

    def _check_accepting(self, method: str) -> None:
        if self.draining:
            # the same phrase rpc/server.py uses: a parent router's
            # retry ladder keys on it
            raise RuntimeError(f"replica draining: {method} refused")

    def _route(self, op: str, *args, affinity=None, klass=None,
               tenant=None, **kwargs):
        return self.router.call(op, *args, affinity=affinity,
                                klass=klass, tenant=tenant, **kwargs)

    def rpc_ecrecover(self, digests, sigs, klass=None, tenant=None):
        from gethsharding_tpu_torch.rpc import codec

        self._check_accepting("shard_ecrecover")
        out = self._route("ecrecover_addresses",
                          [codec.dec_bytes(d) for d in digests],
                          [codec.dec_bytes(s) for s in sigs],
                          klass=klass, tenant=tenant)
        return [None if addr is None else codec.enc_bytes(bytes(addr))
                for addr in out]

    def rpc_verifyAggregates(self, messages, agg_sigs, agg_pks,
                             klass=None, tenant=None):
        from gethsharding_tpu_torch.rpc import codec

        self._check_accepting("shard_verifyAggregates")
        out = self._route("bls_verify_aggregates",
                          [codec.dec_bytes(m) for m in messages],
                          [codec.dec_g1(s) for s in agg_sigs],
                          [codec.dec_g2(p) for p in agg_pks],
                          klass=klass, tenant=tenant)
        return [bool(b) for b in out]

    def rpc_verifyCommittees(self, messages, sig_rows, pk_rows,
                             pk_row_keys=None, klass=None, tenant=None):
        from gethsharding_tpu_torch.rpc import codec

        self._check_accepting("shard_verifyCommittees")
        keys = None if pk_row_keys is None else [
            None if k is None else str(k) for k in pk_row_keys]
        affinity = None
        if keys:
            affinity = next((k for k in keys if k is not None), None)
        out = self._route("bls_verify_committees",
                          [codec.dec_bytes(m) for m in messages],
                          codec.dec_g1_rows(sig_rows),
                          codec.dec_g2_rows(pk_rows),
                          pk_row_keys=keys, affinity=affinity,
                          klass=klass, tenant=tenant)
        return [bool(b) for b in out]

    def rpc_dasVerify(self, chunks, indices, proofs, roots,
                      klass=None, tenant=None):
        from gethsharding_tpu_torch.rpc import codec

        self._check_accepting("shard_dasVerify")
        args = codec.dec_das_call(chunks, indices, proofs, roots)
        affinity = args[3][0].hex() if args[3] else None
        out = self._route("das_verify_samples", *args,
                          affinity=affinity, klass=klass, tenant=tenant)
        return [bool(b) for b in out]

    def rpc_dasPolyVerify(self, commitments, index_rows, eval_rows,
                          proofs, ns, klass=None, tenant=None):
        from gethsharding_tpu_torch import slo
        from gethsharding_tpu_torch.rpc import codec

        self._check_accepting("shard_dasPolyVerify")
        args = codec.dec_das_poly_call(commitments, index_rows,
                                       eval_rows, proofs, ns)
        affinity = args[0][0].hex() if args[0] else None
        started = time.monotonic()
        try:
            out = self._route("das_verify_multiproofs", *args,
                              affinity=affinity, klass=klass,
                              tenant=tenant)
        except Exception:
            if klass == "interactive":
                slo.record("das_light", ok=False,
                           latency_s=time.monotonic() - started)
            raise
        if klass == "interactive":
            slo.record("das_light", ok=True,
                       latency_s=time.monotonic() - started)
        return [bool(b) for b in out]

    def rpc_getSample(self, shard_id, period, indices):
        """Light-client sample plane: proxy `shard_getSample` to the
        first replica that holds the blob (the frontend has no shard
        state of its own). Rendezvous-ordered on the (shard, period)
        key so repeated light-client pulls for one collation land on
        the same replica's cache; a replica without the blob answers
        None and the walk continues. None = no replica can serve."""
        from gethsharding_tpu_torch import slo

        self._check_accepting("shard_getSample")
        started = time.monotonic()
        ok = False
        try:
            affinity = f"sample|{int(shard_id)}|{int(period)}"
            for replica in self.router.route(affinity=affinity):
                call = getattr(replica.backend, "_call", None)
                if call is None:
                    continue
                try:
                    out = call("shard_getSample", int(shard_id),
                               int(period), [int(i) for i in indices])
                except Exception:  # noqa: BLE001 - walk to next replica
                    continue
                if out is not None:
                    ok = True
                    return out
            return None
        finally:
            slo.record("das_light", ok=ok,
                       latency_s=time.monotonic() - started)

    # -- control plane -----------------------------------------------------

    def rpc_health(self):
        """The same shape a replica's shard_health serves, so a parent
        router can sweep a fleet OF frontends: the frontend's drain
        flag, in-flight count, and how many replicas are accepting."""
        members = self.router.members()
        accepting = sum(1 for r in members if r.accepting)
        health = {"draining": self.draining or accepting == 0,
                  "inflight": max(0, self._inflight - 1),
                  "breaker": None,
                  "accepting_replicas": accepting,
                  "replicas": len(members)}
        if self.membership is not None:
            health["epoch"] = self.membership.epoch
        return health

    def rpc_metrics(self):
        # the ROUTER's registry: build_frontend may wire a private one,
        # and the fleet/replica/hedge series a parent router federates
        # live there, not necessarily in the process default
        return self.router.registry.snapshot()

    def rpc_fleetStatus(self):
        """The one-glance fleet answer: per-replica states and the hedge
        ledger (issued/won/wasted/audit_faults/storm), with the
        membership and the autoscaler where they run. (The JAX
        package's also carries the trace collector's counters; the port
        has no `fleettrace/` yet.)"""
        status = {"replicas": self.router.states(),
                  "hedge": self.router.hedge_stats(),
                  "draining": self.draining}
        if self.membership is not None:
            status["membership"] = {"epoch": self.membership.epoch,
                                    "endpoints":
                                        self.membership.endpoints(),
                                    "peers": list(self.peers)}
        if self.autoscaler is not None:
            status["autoscale"] = self.autoscaler.status()
        return status

    # -- membership control plane ------------------------------------------

    def _require_membership(self) -> FleetMembership:
        if self.membership is None:
            raise RuntimeError("membership control plane is not "
                               "enabled on this frontend")
        return self.membership

    def rpc_addReplica(self, endpoint):
        """Admit ``HOST:PORT`` as a new replica: it enters DRAINING and
        earns HEALTHY through the health sweep's half-open probe (no
        healthy-by-assertion). Bumps and pushes the membership epoch."""
        out = self._require_membership().add(str(endpoint))
        self._push_topology()
        return out

    def rpc_removeReplica(self, endpoint):
        """Drain-then-detach the member at ``HOST:PORT`` (or a boot
        replica's name): routing stops immediately, the registry row
        detaches once its in-flight work finishes."""
        out = self._require_membership().remove(str(endpoint))
        self._push_topology()
        return out

    def rpc_fleetReconfigure(self, endpoints, epoch=None):
        """Set the full topology in one call. With `epoch` this is the
        GOSSIP form: adopt iff strictly newer (last-writer-wins), never
        bump — peers pushing the same epoch back and forth stay
        convergent. Without, it is the OPERATOR form: diff, apply, and
        bump."""
        membership = self._require_membership()
        endpoints = [str(e) for e in endpoints]
        if epoch is not None:
            adopted = membership.adopt(int(epoch), endpoints)
            return {"adopted": adopted, "epoch": membership.epoch,
                    "endpoints": membership.endpoints()}
        out = membership.reconfigure(endpoints)
        self._push_topology()
        return out

    def rpc_membership(self):
        """The gossip payload: ``(epoch, endpoints)`` plus per-replica
        states for operators."""
        return self._require_membership().snapshot()

    # -- the trace plane: not ported ----------------------------------------

    def rpc_traceHandshake(self):
        RPCServer._unported("shard_traceHandshake", "tracing/export.py")

    def rpc_traceExport(self, payload):
        RPCServer._unported("shard_traceExport", "fleettrace/")

    def rpc_traceAttribution(self):
        RPCServer._unported("shard_traceAttribution", "fleettrace/")

    def rpc_traceExemplars(self, limit=8):
        RPCServer._unported("shard_traceExemplars", "fleettrace/")

    def rpc_drain(self):
        """Drain the FRONTEND: refuse new verification work (typed) so
        a parent balancer moves on; in-flight requests finish."""
        self.draining = True
        return {"draining": True, "inflight": self._inflight}

    def rpc_drainReplica(self, name):
        """Operator drain of ONE replica through the router's drain
        path (it re-enters only after `shard_undrainReplica` plus a
        healthy breaker)."""
        self.router.drain(str(name))
        return self.router.states()[str(name)]

    def rpc_undrainReplica(self, name):
        self.router.undrain(str(name))
        return self.router.states()[str(name)]


def build_frontend(endpoints: List[str], host: str = "127.0.0.1",
                   port: int = 0, hedge_ms: Optional[float] = None,
                   health_interval_s: float = 0.25,
                   chaos=None, timeout_s: float = 30.0,
                   registry: metrics.Registry = metrics.DEFAULT_REGISTRY,
                   peers: Optional[List[str]] = None,
                   gossip_interval_s: Optional[float] = None,
                   membership_journal: Optional[str] = None,
                   ) -> FrontendServer:
    """Dial every ``HOST:PORT`` endpoint as an `RpcReplicaBackend`
    replica (named ``r0..rN`` in endpoint order) behind a hedging
    `FleetRouter`, served by a `FrontendServer` with a runtime
    membership plane over the same registry. `chaos` (a ChaosSchedule)
    is consulted at every replica wire's ``fleet.transport`` seam.
    `membership_journal` (or ``GETHSHARDING_TORCH_FLEET_EPOCH_JOURNAL``)
    names a SQLite path persisting ``(epoch, endpoints)``; on boot the
    journal's last acked topology overrides `endpoints`."""
    replicas = []
    seed = {}
    for i, endpoint in enumerate(endpoints):
        ep_host, ep_port = endpoint.rsplit(":", 1)
        backend = RpcReplicaBackend.dial(ep_host, int(ep_port),
                                         timeout=timeout_s, chaos=chaos)
        replicas.append(Replica(f"r{i}", backend, health=backend.health,
                                registry=registry))
        seed[f"r{i}"] = endpoint
    router = FleetRouter(replicas, health_interval_s=health_interval_s,
                         hedge_ms=hedge_ms, registry=registry)

    def make_replica(endpoint: str) -> Replica:
        # lazy dial: a just-spawned replica may not be listening yet;
        # the first routed call (or health probe) dials through the
        # backend's lazy-redial path, so admission never blocks on a
        # cold endpoint
        ep_host, ep_port = endpoint.rsplit(":", 1)
        backend = RpcReplicaBackend.dial_lazy(
            ep_host, int(ep_port), timeout=timeout_s, chaos=chaos)
        return Replica(endpoint, backend, health=backend.health,
                       registry=registry)

    journal = None
    journal_path = membership_journal or os.environ.get(
        "GETHSHARDING_TORCH_FLEET_EPOCH_JOURNAL", "")
    if journal_path:
        from gethsharding_tpu_torch.db.kv import SqliteKV

        journal = MembershipJournal(SqliteKV(journal_path),
                                    registry=registry)
    membership = FleetMembership(router, make_replica, journal=journal,
                                 seed=seed, registry=registry)
    membership.restore()
    return FrontendServer(router, host=host, port=port,
                          membership=membership, peers=peers,
                          gossip_interval_s=gossip_interval_s)


# the JAX package's options whose modules the port has not ported
UNPORTED = {
    "--trace-out": "tracing/export.py",
    "--fleettrace": "fleettrace/",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="fleet-frontend")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--replica", action="append", default=[],
                        metavar="HOST:PORT",
                        help="a chain_server replica to balance "
                             "(repeatable; at least one required)")
    parser.add_argument("--peer", action="append", default=[],
                        metavar="HOST:PORT",
                        help="another frontend of this fleet "
                             "(repeatable): membership epochs gossip "
                             "between peers, last-writer-wins")
    parser.add_argument("--membership-journal", default="",
                        metavar="PATH",
                        help="SQLite path persisting the membership "
                             "(epoch, endpoints); a restarted frontend "
                             "reconverges to the last acked topology "
                             "(default: "
                             "GETHSHARDING_TORCH_FLEET_EPOCH_JOURNAL)")
    parser.add_argument("--gossip-interval", type=float, default=None,
                        metavar="SECONDS",
                        help="peer membership-gossip period (default: "
                             "GETHSHARDING_TORCH_FLEET_EPOCH_GOSSIP_S, "
                             "1.0)")
    parser.add_argument("--autoscale", action="store_true",
                        help="run the SLO-driven autoscaler "
                             "(fleet/autoscaler.py) over this "
                             "frontend's membership plane, spawning/"
                             "reclaiming chain_server subprocesses "
                             "(bounds and thresholds from "
                             "GETHSHARDING_TORCH_AUTOSCALE_*)")
    parser.add_argument("--autoscale-backend", default="torch",
                        help="--sigbackend for autoscaler-spawned "
                             "chain_servers (torch: the port's kernels "
                             "on the card)")
    parser.add_argument("--autoscale-min", type=int, default=None,
                        help="autoscaler floor (overrides "
                             "GETHSHARDING_TORCH_AUTOSCALE_MIN)")
    parser.add_argument("--autoscale-max", type=int, default=None,
                        help="autoscaler ceiling (overrides "
                             "GETHSHARDING_TORCH_AUTOSCALE_MAX)")
    parser.add_argument("--autoscale-interval", type=float, default=None,
                        help="autoscaler control-loop period in "
                             "seconds (overrides "
                             "GETHSHARDING_TORCH_AUTOSCALE_INTERVAL_S)")
    parser.add_argument("--fleet-hedge-ms", type=float, default=None,
                        help="interactive hedge-delay floor in ms "
                             "(default: GETHSHARDING_TORCH_FLEET_HEDGE_MS, "
                             "0 = hedging off): a request still "
                             "pending after max(this, the primary "
                             "replica's observed latency quantile) is "
                             "re-issued to the next affinity replica, "
                             "first verdict wins")
    parser.add_argument("--health-interval", type=float, default=0.25,
                        metavar="SECONDS",
                        help="background health-sweep period (health + "
                             "metrics federation + drain probes + "
                             "hedge-storm watch)")
    parser.add_argument("--replica-timeout", type=float, default=30.0,
                        help="per-call RPC timeout against a replica")
    parser.add_argument("--chaos", default="", metavar="SPEC",
                        help="seeded chaos at the replica wires' "
                             "fleet.transport seam (delay/partition "
                             "modes; resilience/chaos.py)")
    parser.add_argument("--runtime", type=float, default=0.0,
                        help="seconds before exit (0 = forever)")
    parser.add_argument("--trace", action="store_true",
                        help="collect frontend handler/route/attempt "
                             "spans in the in-memory tracer")
    parser.add_argument("--trace-out", default="",
                        help="not ported: the Chrome trace export waits "
                             "for tracing/export.py")
    parser.add_argument("--trace-ring", type=int, default=4096,
                        help="finished-span ring capacity")
    parser.add_argument("--fleettrace", action="store_true",
                        help="not ported: the cross-process trace "
                             "collector waits for fleettrace/")
    parser.add_argument("--verbosity", default="warning")
    return parser


def refused(args) -> str:
    """The first unported option given, named with its module ('' when
    none is)."""
    given = {"--trace-out": bool(args.trace_out),
             "--fleettrace": args.fleettrace}
    for option, on in given.items():
        if on:
            return (f"{option}: the port has no {UNPORTED[option]} yet "
                    f"(ROADMAP.md, queue A)")
    return ""


def exit_summary(server: FrontendServer, replicas: dict) -> dict:
    """What this process served and launched: its kernel launches (a
    frontend launches none), whether it made a CUDA context, the RPC
    methods by name, the replicas' states as they stood before the
    shutdown (`replicas`) and the hedge ledger."""
    launches, cuda = {}, False
    build = sys.modules.get("gethsharding_tpu_torch.ops._build")
    if build is not None:
        launches = {name: n for name, n in build.launch_counts().items()
                    if n}
    torch = sys.modules.get("torch")
    if torch is not None:
        cuda = bool(torch.cuda.is_initialized())
    return {"launches": launches, "cuda_initialized": cuda,
            "methods": dict(sorted(server.method_calls.items())),
            "replicas": replicas,
            "hedge": server.router.hedge_stats()}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.replica:
        parser.error("at least one --replica HOST:PORT is required")
    reason = refused(args)
    if reason:
        print(f"fleet-frontend: {reason}", file=sys.stderr)
        return 2

    # SIGTERM must run the drain path (stop() below: typed drain
    # notice, in-flight grace, autoscaler reclaiming its spawned
    # chain_servers) — the default handler would orphan the children
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))

    logging.basicConfig(
        level=getattr(logging, args.verbosity.upper()),
        format="%(asctime)s %(levelname)-7s %(name)s  %(message)s",
        datefmt="%H:%M:%S")
    if args.trace:
        tracing.enable(ring_spans=args.trace_ring)

    chaos = None
    if args.chaos:
        from gethsharding_tpu_torch.resilience.chaos import (parse_spec,
                                                             unwired_seams)

        try:
            chaos = parse_spec(args.chaos)
        except ValueError as exc:
            print(f"fleet-frontend: --chaos: {exc}", file=sys.stderr)
            return 2
        unwired = unwired_seams(chaos, ("fleet",))
        if unwired:
            log.warning("chaos spec names seams the frontend never "
                        "wires: %s (only fleet.transport fires here)",
                        unwired)

    # the SLO plane boots with the frontend so its shard_metrics
    # snapshot carries slo/<class> series from the first scrape
    from gethsharding_tpu_torch import slo

    slo.tracker()
    server = build_frontend(args.replica, host=args.host, port=args.port,
                            hedge_ms=args.fleet_hedge_ms,
                            health_interval_s=args.health_interval,
                            chaos=chaos, timeout_s=args.replica_timeout,
                            peers=args.peer,
                            gossip_interval_s=args.gossip_interval,
                            membership_journal=args.membership_journal)
    server.start()
    if args.autoscale:
        from gethsharding_tpu_torch.fleet.autoscaler import (
            AutoscaleConfig, Autoscaler, ChainServerSpawner)

        cfg = AutoscaleConfig.from_env()
        if args.autoscale_min is not None:
            cfg.min_replicas = args.autoscale_min
        if args.autoscale_max is not None:
            cfg.max_replicas = args.autoscale_max
        if args.autoscale_interval is not None:
            cfg.interval_s = args.autoscale_interval
        spawner = ChainServerSpawner(sigbackend=args.autoscale_backend,
                                     host=args.host)
        server.attach_autoscaler(
            Autoscaler(server.membership, spawner, config=cfg))
    print(json.dumps({"host": server.address[0],
                      "port": server.address[1]}), flush=True)
    deadline = time.monotonic() + args.runtime if args.runtime else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        replicas = server.router.states()
        server.stop()
        print("frontend at exit: "
              + json.dumps(exit_summary(server, replicas), sort_keys=True),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
