"""Fleet-scale serving: the shard-aware router over admission classes (the
port's copy of the JAX package's `fleet/`).

The serving tier (gethsharding_tpu_torch/serving/) coalesces ONE process's
callers onto one device; the north star is millions of users hitting
many frontends that share few devices. This package is the horizontal
story on top of it:

- ``router.py`` — a lightweight shard-aware router/balancer in front
  of N ``chain_server`` replicas: consistent shard→replica affinity
  (rendezvous hashing, so the device-resident pk-plane LRU stays warm),
  per-replica health read from the breaker/soundness state, retry-on-
  next-replica through the existing ``resilience/policy`` executors,
  breaker-aware draining (a tripped or corrupt-flagged replica stops
  taking new work, finishes in-flight, and re-enters only after its
  half-open differential probe re-promotes the primary), and request
  HEDGING for tail robustness (an interactive call still pending after
  its class-aware hedge delay is duplicated to the next affinity
  replica, first verdict wins, losses discarded with accounting).

- ``frontend.py`` — the standalone router process: owns the replica
  registry, health sweep and drain orchestration, and serves the full
  serving RPC plane set (ecrecover / aggregates / committees / DAS) to
  actors over JSON-RPC — the fleet's failure-domain boundary
  (``python -m gethsharding_tpu_torch.fleet.frontend``). Frontends replicate:
  ``--peer`` gossips membership epochs last-writer-wins, and actors
  fail over between frontends with `rpc.client.FrontendPool`.

- ``membership.py`` — the replica registry as a RUNTIME control plane:
  ``shard_addReplica`` / ``shard_removeReplica`` /
  ``shard_fleetReconfigure`` mutate it under affinity-preserving
  admission (DRAINING→probe→healthy in, drain-then-detach out), every
  topology change bumps a journaled epoch.

- ``autoscaler.py`` — the SLO-driven controller: scale-out on
  fast-burn or sustained queue depth, scale-in only when the slow burn
  is clean and depth is near zero, hysteresis + cooldowns, driving a
  pluggable `ReplicaSpawner` (subprocess chain_servers for real use,
  on the card by default).

The admission-class vocabulary (``interactive`` / ``bulk_audit`` /
``catchup_replay``: priorities, weighted batch shares, per-class
deadlines, the thread-local ``admission_class`` tagging context) lives
in ``serving/classes.py`` — it is policy the admission queue itself
enforces, so the dependency runs one way (fleet → serving, never
back). It is re-exported here because the fleet is where the classes
earn their keep.
"""

from gethsharding_tpu_torch.fleet.router import (
    AllReplicasDraining,
    FleetRouter,
    Replica,
    ReplicaState,
    RouterSigBackend,
    RpcReplicaBackend,
)
from gethsharding_tpu_torch.serving.classes import (
    ADMISSION_CLASSES,
    CLASS_BULK_AUDIT,
    CLASS_CATCHUP,
    CLASS_INTERACTIVE,
    ClassPolicy,
    SHED_ORDER,
    admission_class,
    class_for,
    current_admission,
    default_policies,
)

# the frontend server resolves lazily (PEP 562, the resilience
# package's idiom): `python -m gethsharding_tpu_torch.fleet.frontend` must
# not find the module already half-imported by the package (runpy's
# double-execution warning), and routers that never serve a frontend
# skip its socketserver machinery
_LAZY = {
    "FrontendServer": ("frontend", "FrontendServer"),
    "build_frontend": ("frontend", "build_frontend"),
    "FleetMembership": ("membership", "FleetMembership"),
    "MembershipJournal": ("membership", "MembershipJournal"),
    "DuplicateReplicaError": ("membership", "DuplicateReplicaError"),
    "UnknownReplicaError": ("membership", "UnknownReplicaError"),
    "Autoscaler": ("autoscaler", "Autoscaler"),
    "AutoscaleConfig": ("autoscaler", "AutoscaleConfig"),
    "ReplicaSpawner": ("autoscaler", "ReplicaSpawner"),
    "ChainServerSpawner": ("autoscaler", "ChainServerSpawner"),
}


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(f"{__name__}.{module_name}")
    value = getattr(module, attr)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


__all__ = [
    "ADMISSION_CLASSES",
    "AllReplicasDraining",
    "CLASS_BULK_AUDIT",
    "CLASS_CATCHUP",
    "CLASS_INTERACTIVE",
    "ClassPolicy",
    "FleetRouter",
    "Replica",
    "ReplicaState",
    "RouterSigBackend",
    "RpcReplicaBackend",
    "SHED_ORDER",
    "admission_class",
    "class_for",
    "current_admission",
    "default_policies",
    *sorted(_LAZY),
]
