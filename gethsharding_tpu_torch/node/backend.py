"""ShardNode: the service container for one sharding actor (the port's copy
of the JAX package's `node/backend.py`).

Parity: `sharding/node/backend.go` (New :55, Start :98, registerService/
fetchService :151-174, registerActorService :245) — services register in
dependency order (shardDB -> p2p -> mainchain client -> state mirror ->
netstore and DAS service (`da_mode="sampled"`) -> txpool -> actor ->
simulator -> syncer), start in registration order, stop in reverse. The
registry is keyed by service type with typed fetch. A light node
(`actors/light.py`) holds no shard data: it runs no netstore (its DAS
service, under `da_mode="sampled"`, has no store of its own), no
simulator and no syncer.

The node runs on `device` (None: the CUDA card, which raises where there
is none; "cpu" runs the kernels' plain versions): the notary's
`TorchSigBackend` and the observer's replay both take it. A light node
verifies on the host by design and launches nothing, so it resolves no
device (`device` and `mesh_devices` are ignored, and it starts where
there is no card): its innermost backend is the host's `python` one
whatever `sig_backend` names, and the wrappers asked for compose over it
as for every actor, inert, since no service of a light node calls them.
What the port has not ported yet is refused by a `ValueError` that names
the missing module (`UNPORTED`). With `mesh_devices` above 1
(`--mesh-devices`, or `$GETHSHARDING_TORCH_MESH_DEVICES`) a `torch`
backend audits over that many slots (`sigbackend/layout.py`): distinct
cards, or `device` repeated; too few cards raise `requested N devices,
only M visible`, and the node's own device is slot 0.

The signature backend is composed innermost first, each layer optional,
as the JAX package composes it: device backend (`sig_backend`) -> chaos
injection (`chaos`) -> serving tier (`serving`) -> soundness spot-check
(`soundness_rate`) -> failover breaker (``sig_backend="failover-*"``).
Chaos sits where device faults originate; the breaker sits outside the
serving tier so a watchdog's `DeadlineExceeded` surfacing from a serving
future counts as a primary fault; the spot-checker sits between them,
so it audits what the device delivered through the tier and its
`SoundnessViolation` trips the breaker. One instance node-wide: one
admission queue per device, one breaker per node. A proposer's txpool
recovers senders through the composed backend when one is composed, and
on the host when none is (the JAX package's node does the same).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Type, TypeVar

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.actors.light import LightClient
from gethsharding_tpu_torch.actors.notary import Notary
from gethsharding_tpu_torch.actors.observer import Observer
from gethsharding_tpu_torch.actors.proposer import Proposer
from gethsharding_tpu_torch.actors.simulator import Simulator
from gethsharding_tpu_torch.actors.syncer import Syncer
from gethsharding_tpu_torch.actors.txpool import TXPool
from gethsharding_tpu_torch.core.shard import Shard
from gethsharding_tpu_torch.das.service import PROOF_MODES, DASService
from gethsharding_tpu_torch.db.shard_db import ShardDB
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.mainchain.mirror import StateMirror
from gethsharding_tpu_torch.p2p.service import Hub, P2PServer
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.resilience.journal import VoteJournal
from gethsharding_tpu_torch.sigbackend import (BACKEND_NAMES, SigBackend,
                                              build_backend, get_backend)
from gethsharding_tpu_torch.sigbackend.layout import resolve_slots
from gethsharding_tpu_torch.smc.chain import SimulatedMainchain
from gethsharding_tpu_torch.storage.netstore import NetStore

S = TypeVar("S")

# the reference's node options the port does not have yet, with the
# module each waits for (ROADMAP.md, queue A item 8)
UNPORTED = {
    "fleet_frontend": "fleet/",
    "http_port": "node/http_status.py",
}


def refuse(option: str) -> ValueError:
    return ValueError(
        f"{option}: the port has no {UNPORTED[option]} yet (ROADMAP.md, "
        f"queue A item 8)")


class ShardNode:
    """One sharding node: an actor plus its support services."""

    ACTORS = ("notary", "proposer", "observer", "light")

    def __init__(self, actor: str = "observer", shard_id: int = 0,
                 config: Config = DEFAULT_CONFIG,
                 backend: Optional[SimulatedMainchain] = None,
                 hub: Optional[Hub] = None,
                 data_dir: str = "", in_memory_db: bool = True,
                 deposit: bool = False,
                 txpool_interval: Optional[float] = 5.0,
                 simulator_interval: float = 15.0,
                 sig_backend: str = "torch",
                 device=None,
                 password: Optional[str] = None,
                 supervise: bool = False,
                 supervise_interval: float = 1.0,
                 http_port: Optional[int] = None,
                 serving: bool = False,
                 serving_config=None,
                 chaos=None,
                 soundness_rate: Optional[float] = None,
                 da_mode: str = "full",
                 da_samples: int = 16,
                 da_parity: float = 0.5,
                 da_proofs: str = "merkle",
                 fleet_frontend: Optional[str] = None,
                 mesh_devices: Optional[int] = None):
        if actor not in self.ACTORS:
            raise ValueError(f"unknown actor {actor!r}; pick from {self.ACTORS}")
        if da_mode not in ("full", "sampled"):
            raise ValueError(f"unknown da_mode {da_mode!r}; "
                             "pick 'full' or 'sampled'")
        if da_proofs not in PROOF_MODES:
            raise ValueError(f"unknown da_proofs {da_proofs!r}; "
                             "pick 'merkle' or 'poly'")
        for option, given in (
                ("fleet_frontend", fleet_frontend is not None),
                ("http_port", http_port is not None)):
            if given:
                raise refuse(option)
        if sig_backend not in BACKEND_NAMES:
            raise ValueError(f"unknown sigbackend {sig_backend!r}; choose "
                             f"from {BACKEND_NAMES}")
        failover = sig_backend.startswith("failover-")
        inner_name = sig_backend[len("failover-"):] if failover \
            else sig_backend
        if serving and inner_name.startswith("serving-"):
            raise ValueError("--serving already wraps the backend; use "
                             "the bare backend name with --serving")
        self.actor = actor
        self.shard_id = shard_id
        self.config = config
        if actor == "light":
            # nothing of a light node computes on a device (see the module
            # docstring): no device, and the host's backend innermost
            self.slots = self.device = None
            inner_name = inner_name.replace("torch", "python")
        else:
            # no fallback: a node without a card, or with fewer cards than
            # its mesh asks for, raises here unless the caller asked for
            # the CPU
            target = (resolve_slots(device, mesh_devices)
                      if inner_name.endswith("torch")
                      else resolve_device(device))
            self.slots = target if isinstance(target, list) else None
            self.device = self.slots[0] if self.slots else target
        self._serving_backend = None
        self.sig_backend = self._compose(inner_name, failover, serving,
                                         serving_config, chaos,
                                         soundness_rate)
        self._services: Dict[Type, object] = {}
        self._order: List[object] = []
        self._factories: Dict[Type, object] = {}
        self.restarts: Dict[str, int] = {}
        self._restart_times: Dict[str, List[float]] = {}
        self._given_up: set = set()
        self.supervisor: Optional[Supervisor] = (
            Supervisor(self, interval=supervise_interval)
            if supervise else None)

        # registration order mirrors backend.go:55-96
        shard_db = ShardDB(data_dir=data_dir, in_memory=in_memory_db)
        self._register(shard_db)

        p2p = P2PServer(hub=hub)
        self._register(p2p)

        # node identity: with a datadir and a password, load or create an
        # encrypted key file so that the address survives restarts
        # (accounts/keystore parity; smc_client.go:218 unlock flow)
        account = None
        accounts_mgr = None
        if data_dir and password is not None:
            from gethsharding_tpu_torch.mainchain.accounts import (
                AccountManager)
            from gethsharding_tpu_torch.mainchain.keystore import Keystore

            keystore = Keystore(f"{data_dir}/keystore")
            accounts_mgr = AccountManager()
            account = accounts_mgr.import_key(
                keystore.load_or_create(password))

        client = SMCClient(backend=backend, config=config,
                           deposit_flag=deposit, accounts=accounts_mgr,
                           account=account)
        self._register(client)
        if hub is not None and hasattr(hub, "set_identity"):
            # a cross-process hub (p2p/remote.py) signs its attach and
            # direct-peer handshakes with the node's key: the identity is
            # proven, not claimed
            hub.set_identity(client.accounts, client.account())

        shard = Shard(shard_id=shard_id, shard_db=shard_db.db)
        self.shard = shard

        # the downloader/fetcher analog: a per-head SMC state mirror giving
        # local reads between heads and warm restart snapshots, registered
        # before the actors so the notary's hot loop can consume it
        self._register_factory(
            lambda: StateMirror(client=client, shard_db=shard_db.db))

        # the data-availability sampling plane (da_mode "sampled"): a
        # NetStore, whose store the extended chunks are filed into (parity
        # chunks are ordinary content-addressed chunks peers can pull),
        # and the one DASService the actor shares: proposers publish
        # through it, sampled notaries fetch k chunks with their proofs.
        # Registered before the actors so their factories close over it.
        self.da_mode = da_mode
        self.das_service: Optional[DASService] = None
        if da_mode == "sampled":
            store = None
            if actor != "light":
                netstore = NetStore(p2p=p2p)
                self._register(netstore)
                store = netstore.store
            self.das_service = DASService(
                client=client, p2p=p2p, store=store,
                parity_ratio=da_parity, samples=da_samples, chaos=chaos,
                proof_mode=da_proofs)
            self._register(self.das_service)
        das = self.das_service

        if actor == "proposer":
            # sender recovery through the composed backend; on the host
            # when no wrapper was asked for, as in the JAX package's node
            txpool = TXPool(simulate_interval=txpool_interval,
                            sig_backend=(self.sig_backend if self._composed
                                         else None))
            self._register(txpool)
            self._register_factory(
                lambda: Proposer(client=client, txpool=txpool,
                                 shard=shard, config=config, das=das))
        elif actor == "notary":
            # crash-safe vote journal through the node's own shard KV (a
            # datadir node gets SQLite durability); the knob turns it off
            journal = None
            if os.environ.get("GETHSHARDING_TORCH_VOTE_JOURNAL", "1") != "0":
                journal = VoteJournal(shard_db.db)
            # one backend node-wide: a restarted notary keeps its tables
            self._register_factory(
                lambda: Notary(client=client, shard=shard, p2p=p2p,
                               config=config, deposit_flag=deposit,
                               sig_backend=self.sig_backend,
                               mirror=self.service(StateMirror),
                               journal=journal, das=das,
                               da_mode=da_mode))
        elif actor == "light":
            # the les/light role: no shard data, SMC-anchored proof-verified
            # sampling over shardp2p
            self._register_factory(
                lambda: LightClient(client=client, p2p=p2p, das=das))
        else:
            # the observer replays where the backend runs: on the card for
            # `torch` (and its wrappers), on the host for `python`
            self._register_factory(
                lambda: Observer(client=client, shard=shard,
                                 replay_engine=(
                                     "python" if sig_backend.endswith(
                                         "python") else "torch"),
                                 device=self.device))

        if actor not in ("notary", "light"):
            # non-notary nodes run the simulator (backend.go:303)
            self._register_factory(
                lambda: Simulator(client=client, p2p=p2p,
                                  shard_id=shard_id,
                                  tick_interval=simulator_interval))

        if actor != "light":  # a light node holds no bodies to serve
            self._register_factory(
                lambda: Syncer(client=client, shard=shard, p2p=p2p))

    # -- the signature backend ---------------------------------------------

    def _compose(self, inner_name, failover, serving, serving_config,
                 chaos, soundness_rate) -> SigBackend:
        """device -> chaos -> serving -> soundness -> failover (see the
        module docstring)."""
        device = composed = build_backend(inner_name,
                                          self.slots or self.device)
        if inner_name.startswith("serving-"):
            self._serving_backend = device
        if chaos is not None:
            from gethsharding_tpu_torch.resilience.chaos import (
                ChaosSigBackend)

            composed = ChaosSigBackend(composed, chaos)
        if serving:
            from gethsharding_tpu_torch.serving import (ServingConfig,
                                                        ServingSigBackend)

            composed = ServingSigBackend(
                composed, config=serving_config or ServingConfig())
            self._serving_backend = composed
        if soundness_rate is None:
            soundness_rate = float(os.environ.get(
                "GETHSHARDING_TORCH_SOUNDNESS_RATE", "0") or 0)
        if soundness_rate > 0:
            from gethsharding_tpu_torch.resilience.soundness import (
                SpotCheckSigBackend)

            composed = SpotCheckSigBackend(composed, rate=soundness_rate)
        if failover:
            from gethsharding_tpu_torch.resilience.breaker import (
                FailoverSigBackend)

            composed = FailoverSigBackend(composed, get_backend("python"))
        # whether a wrapper was asked for: the txpool recovers through the
        # backend only then
        self._composed = composed is not device
        return composed

    # -- registry (backend.go:151-174) ------------------------------------

    def _register(self, service: object) -> None:
        kind = type(service)
        if kind in self._services:
            raise ValueError(f"service {kind.__name__} already registered")
        self._services[kind] = service
        self._order.append(service)

    def _register_factory(self, factory) -> None:
        """Register a service built by `factory`; the factory is kept so a
        supervisor can replace a crashed instance with a fresh one
        (restart-as-fresh-instance, node/service.go:78-83)."""
        service = factory()
        self._register(service)
        self._factories[type(service)] = factory

    def service(self, kind: Type[S]) -> S:
        """Typed fetch (fetchService parity)."""
        if kind not in self._services:
            raise KeyError(f"unknown service {kind.__name__}")
        return self._services[kind]  # type: ignore[return-value]

    @property
    def services(self) -> List[object]:
        return list(self._order)

    # -- lifecycle (backend.go:98-133) ------------------------------------

    def start(self) -> None:
        for service in self._order:
            service.start()
        if self.supervisor is not None:
            self.supervisor.start()

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        for service in reversed(self._order):
            try:
                service.stop()
            except Exception:
                pass
        if self._serving_backend is not None:
            # after the consumers: a draining actor must still resolve
            self._serving_backend.close()

    # -- supervision (failure detection / elastic recovery) ----------------

    MAX_RESTARTS = 3          # ... within RESTART_WINDOW seconds
    RESTART_WINDOW = 300.0    # transient crashes outside the window decay

    def heal(self) -> List[str]:
        """Replace every crashed supervisable service with a fresh
        instance built by its registered factory. Returns the names of
        services restarted in this pass. More than MAX_RESTARTS
        replacements within RESTART_WINDOW seconds means the crash is
        systemic: the instance is then stopped and left down for good."""
        restarted: List[str] = []
        now = time.monotonic()
        for i, service in enumerate(list(self._order)):
            if not isinstance(service, Service) or not service.crashed:
                continue
            if not service.supervisable:
                continue
            kind = type(service)
            factory = self._factories.get(kind)
            if factory is None:
                continue
            if service.name in self._given_up:
                continue
            window = [t for t in self._restart_times.get(service.name, [])
                      if now - t < self.RESTART_WINDOW]
            if len(window) >= self.MAX_RESTARTS:
                self._restart_times.pop(service.name, None)
                self._given_up.add(service.name)
                if service.running:  # budget exhausted: leave it down
                    service.record_error(
                        f"giving up on {service.name}: {len(window)} "
                        f"restarts within {self.RESTART_WINDOW:.0f}s — "
                        f"crash is systemic, leaving the service down")
                    try:
                        service.stop()
                    except Exception:
                        pass
                continue
            window.append(now)
            self._restart_times[service.name] = window
            self.restarts[service.name] = self.restarts.get(
                service.name, 0) + 1
            try:
                service.stop()
            except Exception:
                pass
            try:
                fresh = factory()
                # carry the crash history forward for observability
                fresh.errors.extend(service.errors)
                fresh.start()
            except Exception as exc:
                # a failed rebuild must not kill the supervisor loop; the
                # attempt still burned restart budget
                service.record_error(
                    f"restart of {service.name} failed: {exc!r}")
                continue
            self._services[kind] = fresh
            self._order[i] = fresh
            restarted.append(fresh.name)
        return restarted

    # -- conveniences ------------------------------------------------------

    @property
    def client(self) -> SMCClient:
        return self.service(SMCClient)

    @property
    def p2p(self) -> P2PServer:
        return self.service(P2PServer)

    def errors(self) -> List[str]:
        out: List[str] = []
        for service in self._order:
            if isinstance(service, Service):
                out.extend(service.errors)
        return out


class Supervisor(Service):
    """Failure detector and elastic recovery for one ShardNode: every
    `interval` it scans the node's services for crashed background loops
    and replaces them through `ShardNode.heal` (bounded by
    ShardNode.MAX_RESTARTS)."""

    name = "supervisor"

    def __init__(self, node: ShardNode, interval: float = 1.0):
        super().__init__()
        self.node = node
        self.interval = interval
        self.restarts_performed = 0

    def on_start(self) -> None:
        self.spawn(self._watch)

    def _watch(self) -> None:
        while not self.wait(self.interval):
            for name in self.node.heal():
                self.restarts_performed += 1
                self.log.warning("restarted crashed service %s "
                                 "(fresh instance)", name)
