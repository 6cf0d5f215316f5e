"""The port's fleet (`gethsharding_tpu_torch/fleet/`), its `FrontendPool`,
the seeded jitter of `resilience/policy.py`, the ``fleet.transport`` chaos
seam and `ClassedSigBackend`, held against the JAX package's on the CPU.

Every scenario runs in both packages from the same seeds on in-process
replicas over each package's scalar `PythonSigBackend`, and what the two
give is compared with exact equality:

1. routing: the rendezvous order of `FleetRouter.route` for the same
   replica names and affinity keys, the keyless least-in-flight order,
   drain, undrain and re-entry, `AllReplicasDraining`, the minimal
   reshuffle of an admission;
2. a seeded call sequence under the same chaos spec
   (``fleet.transport:mode=delay|partition`` and ``backend.*``): verdicts,
   typed errors, per-replica counts, states, retries, injected counts;
3. hedging, driven by events (a primary that waits until the hedge has
   answered): `hedge_stats` after a won hedge, a loser that fails, and a
   bulk call that never hedges; the hedge-storm latch; the metrics
   federation fold;
4. membership: epochs, typed errors, gossip adoption, the journal's
   records and `restore()`;
5. the autoscaler's decisions on the same SLO-burn and queue-depth feed
   with a fake spawner;
6. `RetryPolicy(seed=...)` delays and `retry_call`;
7. the frontend over RPC replicas (every plane, the control plane, the
   typed codes, the refusals by module), gossip between frontends and
   `FrontendPool` failover;
8. one frontend OS process over two port `chain_server` processes
   (``--sigbackend torch``, the CPU asked for through
   ``GETHSHARDING_TORCH_DEVICE=cpu``) against the reference `python`
   backend's verdicts on a small period.

No wall-clock bound below a few seconds is asserted: the hedges wait on
events, and the router's trip cooldowns are set beyond the test's length.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT, REF = "gethsharding_tpu_torch", "gethsharding_tpu"
PKGS = (PORT, REF)


def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, metrics=mod("metrics"), fleet=mod("fleet"),
        router=mod("fleet.router"), membership=mod("fleet.membership"),
        autoscaler=mod("fleet.autoscaler"), frontend=mod("fleet.frontend"),
        chaos=mod("resilience.chaos"), policy=mod("resilience.policy"),
        errors=mod("resilience.errors"), sig=mod("sigbackend"),
        kv=mod("db.kv"), client=mod("rpc.client"), codec=mod("rpc.codec"),
        server=mod("rpc.server"), serving=mod("serving"),
        serving_backend=mod("serving.backend"),
        classes=mod("serving.classes"), chain=mod("smc.chain"),
        ecdsa=mod("crypto.secp256k1"), bls=mod("crypto.bn256"),
        keccak=mod("crypto.keccak").keccak256)


P = {root: pkg(root) for root in PKGS}


@pytest.fixture(scope="module", autouse=True)
def _recorder_dir(tmp_path_factory):
    """Both packages' flight-recorder bundles under a temporary
    directory (the hedge-storm latch dumps one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("port_recorder")))
        mp.setenv("GETHSHARDING_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("ref_recorder")))
        yield


def ecdsa_cases(m, n: int, tag: bytes = b"torch-fleet"):
    cases = []
    for i in range(n):
        priv = int.from_bytes(m.keccak(tag + b"-%d" % i), "big") % m.ecdsa.N
        digest = m.keccak(tag + b"-msg-%d" % i)
        cases.append((digest, m.ecdsa.sign(digest, priv).to_bytes65(),
                      bytes(m.ecdsa.priv_to_address(priv))))
    return cases


def committee_rows(m, n: int = 3, tamper: int = 1):
    msgs, sig_rows, pk_rows, keys = [], [], [], []
    for i in range(n):
        tag = b"tfc-%d" % i
        ks = [m.bls.bls_keygen(tag + bytes([j])) for j in range(2)]
        sigs = [m.bls.bls_sign(tag, sk) for sk, _ in ks]
        if i == tamper:
            sigs[0] = m.bls.bls_sign(b"tampered", ks[0][0])
        msgs.append(tag)
        sig_rows.append(sigs)
        pk_rows.append([pk for _, pk in ks])
        keys.append((i, i * 7))
    return msgs, sig_rows, pk_rows, keys


def plain_replicas(m, names, registry, **kw):
    return [m.router.Replica(name, m.sig.PythonSigBackend(), probe=None,
                             registry=registry, **kw) for name in names]


# == 1. routing ===============================================================

KEYS = [f"shard-{i}" for i in range(48)] + ["0xabc", "(3, 21)", "r0"]


@pytest.mark.parametrize("names", [
    ["r0"], ["r0", "r1"], ["r0", "r1", "r2"],
    ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003", "10.0.0.7:80"],
    [f"r{i}" for i in range(8)],
], ids=["1", "2", "3", "endpoints", "8"])
def test_route_order_matches_reference(names):
    orders = {}
    for root, m in P.items():
        registry = m.metrics.Registry()
        replicas = plain_replicas(m, names, registry)
        router = m.router.FleetRouter(replicas, health_interval_s=0.0,
                                      registry=registry)
        try:
            keyed = {k: [r.name for r in router.route(k)] for k in KEYS}
            for i, replica in enumerate(replicas):
                replica.in_flight = (7 * i + 3) % 4
            keyless = [r.name for r in router.route()]
        finally:
            router.close()
        orders[root] = (keyed, keyless)
    assert orders[PORT] == orders[REF]
    assert sorted(orders[PORT][1]) == sorted(names)


def _drain_scenario(m):
    registry = m.metrics.Registry()
    router = m.router.FleetRouter(
        plain_replicas(m, ["r0", "r1", "r2"], registry),
        health_interval_s=0.0, registry=registry)
    out = {}
    try:
        orders = {k: [r.name for r in router.route(k)] for k in KEYS[:8]}
        victim = orders["shard-0"][0]
        router.drain(victim)
        out["drained"] = router.states()
        out["moved"] = {k: [r.name for r in router.route(k)]
                        for k in KEYS[:8]}
        router.undrain(victim)
        out["back"] = {k: [r.name for r in router.route(k)]
                       for k in KEYS[:8]}
        out["undrained"] = router.states()
        for name in ("r0", "r1", "r2"):
            router.drain(name)
        try:
            router.call("ecrecover_addresses", [m.keccak(b"x")],
                        [b"\x00" * 65])
            out["all_draining"] = None
        except m.router.AllReplicasDraining as exc:
            out["all_draining"] = str(exc)
        out["counters"] = {k: registry.counter(f"fleet/router/{k}").value
                           for k in ("calls", "failovers", "all_draining")}
        out["orders"] = orders
        out["victim"] = victim
    finally:
        router.close()
    return out


def test_drain_undrain_reentry_match_reference():
    got = {root: _drain_scenario(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    port = got[PORT]
    victim = port["victim"]
    assert port["drained"][victim]["state"] == "draining"
    assert port["moved"]["shard-0"] == port["orders"]["shard-0"][1:]
    assert port["back"] == port["orders"]
    assert port["undrained"][victim]["reentries"] == 1
    assert port["all_draining"] is not None
    assert port["counters"]["all_draining"] == 1


def _admission_reshuffle(m):
    registry = m.metrics.Registry()
    boot = plain_replicas(m, ["r0", "r1", "r2"], registry)
    router = m.router.FleetRouter(boot, health_interval_s=0.0,
                                  registry=registry)
    membership = m.membership.FleetMembership(
        router, lambda e: m.router.Replica(e, m.sig.PythonSigBackend(),
                                           probe=None, registry=registry),
        seed={f"r{i}": f"boot:{i}" for i in range(3)}, registry=registry)
    try:
        before = {k: router.route(affinity=k)[0].name for k in KEYS}
        membership.add("ep:new")
        router.refresh(force=True)
        after = {k: router.route(affinity=k)[0].name for k in KEYS}
        membership.remove("ep:new")
        restored = {k: router.route(affinity=k)[0].name for k in KEYS}
    finally:
        router.close()
    return before, after, restored


def test_admission_moves_only_rendezvous_minimal_keys_as_reference():
    got = {root: _admission_reshuffle(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    before, after, restored = got[PORT]
    moved = {k for k in KEYS if after[k] != before[k]}
    assert moved and all(after[k] == "ep:new" for k in moved)
    assert restored == before


# == 2. a seeded call sequence under chaos ====================================

CHAOS_SPECS = {
    "partition": "fleet.transport=0.35,fleet.transport:mode=partition",
    "delay": "fleet.transport=0.5,fleet.transport:mode=delay,delay_s=0.001",
    "backend": ("backend.ecrecover_addresses=0.3,fleet.transport=0.15,"
                "fleet.transport:mode=partition"),
    "first-n": "backend.ecrecover_addresses=4",
}


def _chaos_sequence(m, spec: str, calls: int = 36):
    registry = m.metrics.Registry()
    schedules, replicas = [], []
    for i in range(3):
        schedule = m.chaos.parse_spec(f"seed={11 + i},{spec}")
        schedules.append(schedule)
        backend = m.chaos.TransportChaos(
            m.chaos.ChaosSigBackend(m.sig.PythonSigBackend(), schedule),
            schedule)
        # the cooldown outlasts the test: a tripped replica stays out
        replicas.append(m.router.Replica(
            f"r{i}", backend, probe=None, trip_threshold=3,
            trip_cooldown_s=1e6, registry=registry))
    router = m.router.FleetRouter(replicas, health_interval_s=0.0,
                                  registry=registry)
    cases = ecdsa_cases(m, 4, tag=b"chaos-seq")
    keys = ["shard-0", "shard-1", None, "shard-2", "shard-3", None]
    verdicts = []
    try:
        for i in range(calls):
            digest, sig, want = cases[i % len(cases)]
            try:
                out = router.call("ecrecover_addresses", [digest], [sig],
                                  affinity=keys[i % len(keys)])
                verdicts.append(("ok", [bytes(a) for a in out] == [want]))
            except Exception as exc:  # noqa: BLE001 - the compared outcome
                verdicts.append(("err", type(exc).__name__))
        states = router.states()
    finally:
        router.close()
    counters = {name: registry.counter(name).value for name in (
        "fleet/router/calls", "fleet/router/failovers",
        "fleet/router/all_draining",
        "resilience/retry/fleet.route/retries",
        "resilience/retry/fleet.route/giveups")}
    injected = [dict(s.injected) for s in schedules]
    return verdicts, states, counters, injected


@pytest.mark.parametrize("spec", sorted(CHAOS_SPECS))
def test_seeded_chaos_call_sequence_matches_reference(spec):
    got = {root: _chaos_sequence(m, CHAOS_SPECS[spec])
           for root, m in P.items()}
    assert got[PORT] == got[REF]
    verdicts, states, counters, injected = got[PORT]
    # every answer the router gave is right; what failed failed typed
    assert all(ok for kind, ok in verdicts if kind == "ok")
    assert {v for kind, v in verdicts if kind == "err"} <= {
        "AllReplicasDraining", "InjectedFault"}
    assert sum(sum(i.values()) for i in injected) > 0
    if spec == "delay":
        assert all(kind == "ok" for kind, _ in verdicts)
        assert counters["fleet/router/failovers"] == 0


def test_transport_disturb_timeline_matches_reference():
    timelines = {}
    for root, m in P.items():
        schedule = m.chaos.parse_spec(
            "seed=9,fleet.transport=0.4,fleet.transport:mode=partition")
        line = []
        for _ in range(64):
            try:
                m.chaos.transport_disturb(schedule)
                line.append(0)
            except m.chaos.InjectedFault:
                line.append(1)
        m.chaos.transport_disturb(None)
        m.chaos.transport_disturb(m.chaos.ChaosSchedule(seed=1))
        timelines[root] = (line, dict(schedule.injected))
    assert timelines[PORT] == timelines[REF]
    assert 0 < sum(timelines[PORT][0]) < 64
    m = P[PORT]
    assert m.chaos.unwired_seams(m.chaos.parse_spec(
        "fleet.transport=1,backend.ecrecover_addresses=1"), ("fleet",)) \
        == ["backend.ecrecover_addresses"]


# == 3. hedging, the storm latch, the federation fold =========================

class Gate:
    """A replica backend that holds each call until `release` is set, then
    answers from the scalar backend (or raises `fail`)."""

    def __init__(self, m, fail=None):
        self.inner = m.sig.PythonSigBackend()
        self.name = "gate"
        self.release = threading.Event()
        self.entered = threading.Event()
        self.fail = fail

    def ecrecover_addresses(self, digests, sigs65):
        self.entered.set()
        assert self.release.wait(60)
        if self.fail is not None:
            raise self.fail
        return self.inner.ecrecover_addresses(digests, sigs65)


def _hedge_scenario(m, fail=False, klass=None):
    registry = m.metrics.Registry()
    gate = Gate(m, fail=m.errors.TransientError("gated") if fail else None)
    r0 = m.router.Replica("r0", gate, probe=None, registry=registry)
    r1 = m.router.Replica("r1", m.sig.PythonSigBackend(), probe=None,
                          registry=registry)
    # a 0.5 s fuse: the primary starts on the pool long before it burns
    router = m.router.FleetRouter([r0, r1], health_interval_s=0.0,
                                  hedge_ms=500.0, registry=registry)
    key = next(k for k in KEYS if router.route(k)[0].name == "r0")
    (digest, sig, want), = ecdsa_cases(m, 1, tag=b"hedge")
    try:
        if klass is not None:
            # bulk never hedges: the caller waits the primary out
            threading.Timer(0.3, gate.release.set).start()
        got = router.call("ecrecover_addresses", [digest], [sig],
                          affinity=key, klass=klass)
        gate.release.set()
        expect_wasted = 0 if klass is not None else 1
        deadline = time.monotonic() + 30
        while router.hedge_stats()["wasted"] < expect_wasted \
                and time.monotonic() < deadline:
            time.sleep(0.01)   # the loser finishes on the pool
        stats = router.hedge_stats()
        routed = {r.name: r.describe()["routed"] for r in (r0, r1)}
    finally:
        gate.release.set()
        router.close()
    return [bytes(a) for a in got] == [want], stats, routed


@pytest.mark.parametrize("case", ["won", "loser_fails", "bulk"])
def test_hedge_stats_match_reference(case):
    kw = {"won": {}, "loser_fails": {"fail": True},
          "bulk": {"klass": "bulk_audit"}}[case]
    got = {root: _hedge_scenario(m, **kw) for root, m in P.items()}
    assert got[PORT] == got[REF]
    ok, stats, routed = got[PORT]
    assert ok
    if case == "bulk":
        assert stats["issued"] == 0 and routed == {"r0": 1, "r1": 0}
    else:
        assert (stats["issued"], stats["won"], stats["wasted"]) == (1, 1, 1)
        assert stats["loser_failures"] == (1 if case == "loser_fails"
                                           else 0)
        assert routed == {"r0": 1, "r1": 1}


def test_hedge_storm_latch_and_bulk_budget_match_reference(monkeypatch):
    got = {}
    for root, m in P.items():
        prefix = "GETHSHARDING_TORCH_FLEET" if root == PORT \
            else "GETHSHARDING_FLEET"
        monkeypatch.setenv(f"{prefix}_HEDGE_BULK_MIN_BUDGET", "0.5")
        registry = m.metrics.Registry()
        replica = m.router.Replica("r0", m.sig.PythonSigBackend(),
                                   probe=None, registry=registry)
        router = m.router.FleetRouter([replica], health_interval_s=0.0,
                                      hedge_ms=5.0, registry=registry)
        try:
            steps = []
            router._m_calls.inc(20)
            router._m_hedge_wasted.inc(10)
            router._check_hedge_storm()
            steps.append(router.hedge_stats())
            router._m_calls.inc(40)
            router._check_hedge_storm()
            steps.append(router.hedge_stats())
            delays = [router._hedge_delay_s(replica, c, keyed=k)
                      for c in ("interactive", "bulk_audit",
                                "catchup_replay") for k in (True, False)]
        finally:
            router.close()
        got[root] = (steps, delays,
                     registry.gauge("fleet/hedge/storm").value)
    assert got[PORT] == got[REF]
    steps, delays, _ = got[PORT]
    assert steps[0]["storm"] == 1 and steps[1]["storm"] == 0
    assert delays[0] == 0.005 and delays[4] == 0.0


def test_metrics_federation_fold_matches_reference():
    snapshot = {
        "serving/ecrecover/dispatch_latency": {
            "type": "timer", "count": 9, "mean_s": 0.01, "p50_s": 0.009,
            "p95_s": 0.02, "p99_s": 0.031},
        "serving/class/bulk_audit/queue_depth": {"type": "gauge",
                                                 "value": 17},
        "serving/class/interactive/queue_depth": {"type": "gauge",
                                                  "value": 3},
        "sig/bls/verified": {"type": "counter", "count": 12,
                             "rate_1m": 0.5},
        "das/hist": {"type": "histogram", "count": 2, "mean": 1.5,
                     "p50": 1, "p95": 2, "p99": 2},
        "notary/ignored": {"type": "counter", "count": 1},
    }
    got = {}
    for root, m in P.items():
        registry = m.metrics.Registry()
        router = m.router.FleetRouter(
            plain_replicas(m, ["r0"], registry), health_interval_s=0.0,
            registry=registry)
        depth = {c: 0 for c in m.classes.ADMISSION_CLASSES}
        try:
            router._fold_metrics("r0", snapshot, depth)
            p99 = router._dispatch_p99(snapshot)
        finally:
            router.close()
        got[root] = ({k: v for k, v in registry.snapshot().items()
                      if k.startswith("fleet/replica/r0/")
                      and not k.endswith(("/routed", "/failures",
                                          "/state"))}, depth, p99)
    assert got[PORT] == got[REF]
    assert got[PORT][1]["bulk_audit"] == 17 and got[PORT][2] == 0.031


# == 4. membership ============================================================

def _membership_life(m):
    registry = m.metrics.Registry()
    kv = m.kv.MemoryKV()

    def make(endpoint):
        return m.router.Replica(endpoint, m.sig.PythonSigBackend(),
                                probe=None, registry=registry)

    router = m.router.FleetRouter(
        plain_replicas(m, ["r0", "r1"], registry), health_interval_s=0.0,
        registry=registry)
    journal = m.membership.MembershipJournal(kv, registry=registry)
    membership = m.membership.FleetMembership(
        router, make, journal=journal,
        seed={"r0": "boot:0", "r1": "boot:1"}, registry=registry)
    steps = []
    try:
        steps.append(membership.restore())
        steps.append(membership.add("ep:a"))
        steps.append(router.states()["ep:a"]["state"])
        router.refresh(force=True)
        steps.append(router.states()["ep:a"]["state"])
        for bad in (lambda: membership.add("ep:a"),
                    lambda: membership.remove("ep:never")):
            try:
                bad()
            except (m.membership.DuplicateReplicaError,
                    m.membership.UnknownReplicaError) as exc:
                steps.append((type(exc).__name__, str(exc)))
        steps.append(membership.add("ep:b"))
        steps.append(membership.remove("ep:a"))
        steps.append(membership.remove("r1"))
        steps.append(membership.reconfigure(["boot:0", "ep:b", "ep:c"]))
        steps.append(membership.adopt(2, ["boot:0"]))           # stale
        steps.append(membership.adopt(9, ["boot:0", "ep:d"]))   # newer
        steps.append(membership.snapshot())
        records = {k: kv.get(k) for k in (b"fm/epoch", b"fm/topology")}
    finally:
        router.close()
    # a restarted frontend boots from its stale command line
    registry2 = m.metrics.Registry()
    router2 = m.router.FleetRouter(
        plain_replicas(m, ["r0"], registry2), health_interval_s=0.0,
        registry=registry2)
    try:
        membership2 = m.membership.FleetMembership(
            router2, make,
            journal=m.membership.MembershipJournal(kv, registry=registry2),
            seed={"r0": "boot:0"}, registry=registry2)
        restored = (membership2.restore(), membership2.epoch,
                    membership2.endpoints(), sorted(router2.states()))
    finally:
        router2.close()
    return steps, records, restored


def test_membership_epochs_and_journal_restore_match_reference():
    got = {root: _membership_life(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    steps, records, restored = got[PORT]
    assert steps[0] is False                        # fresh journal
    assert steps[2] == "draining" and steps[3] == "healthy"
    assert int.from_bytes(records[b"fm/epoch"], "big") == 9
    assert json.loads(records[b"fm/topology"]) == ["boot:0", "ep:d"]
    assert restored == (True, 9, ["boot:0", "ep:d"], ["ep:d", "r0"])


# == 5. the autoscaler ========================================================

class FakeSpawner:
    def __init__(self):
        self.count = 0
        self.retired = []

    def spawn(self) -> str:
        endpoint = f"spawn:{self.count}"
        self.count += 1
        return endpoint

    def retire(self, endpoint: str) -> None:
        self.retired.append(endpoint)

    def close(self) -> None:
        pass


CALM = {"burn_fast": 0.0, "burn_slow": 0.0, "depth": 0.0, "p99": 0.0}
HOT = {"burn_fast": 5.0, "burn_slow": 3.0, "depth": 10.0, "p99": 0.5}
DEEP = {"burn_fast": 0.0, "burn_slow": 0.0, "depth": 100.0, "p99": 0.0}
FEEDS = {
    "burn-then-calm": ({}, [(0.0, HOT), (1.0, HOT), (11.0, CALM),
                            (14.5, CALM), (15.5, CALM), (20.0, HOT),
                            (31.0, HOT)]),
    "sustained-depth": ({"out_depth": 64.0},
                        [(0.0, DEEP), (1.0, CALM), (2.0, DEEP),
                         (5.5, DEEP), (16.0, CALM), (19.5, CALM),
                         (20.5, CALM), (31.0, CALM), (34.5, CALM)]),
    "held-at-max": ({"max_replicas": 2, "cooldown_s": 0.0},
                    [(0.0, HOT), (1.0, HOT), (2.0, DEEP), (6.0, DEEP)]),
}


def _autoscale_feed(m, cfg_kwargs, feed):
    registry = m.metrics.Registry()
    router = m.router.FleetRouter(
        plain_replicas(m, ["r0"], registry), health_interval_s=0.0,
        registry=registry)
    membership = m.membership.FleetMembership(
        router, lambda e: m.router.Replica(e, m.sig.PythonSigBackend(),
                                           probe=None, registry=registry),
        seed={"r0": "boot:0"}, registry=registry)
    signals = dict(CALM)
    base = dict(min_replicas=1, max_replicas=3, sustain_s=3.0,
                cooldown_s=10.0)
    base.update(cfg_kwargs)
    spawner = FakeSpawner()
    scaler = m.autoscaler.Autoscaler(
        membership, spawner, config=m.autoscaler.AutoscaleConfig(**base),
        registry=registry, signals=lambda: dict(signals))
    decisions = []
    try:
        for now, sig in feed:
            signals.clear()
            signals.update(sig)
            decision = scaler.tick(now=now)
            decisions.append((decision, membership.endpoints()))
        status = scaler.status()
        status.pop("cooldown")          # read off the wall clock
    finally:
        router.close()
    counters = {k: registry.counter(f"fleet/autoscale/{k}").value
                for k in ("out", "in", "held")}
    return decisions, spawner.retired, status, counters


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_autoscaler_decisions_match_reference(feed):
    cfg_kwargs, ticks = FEEDS[feed]
    got = {root: _autoscale_feed(m, cfg_kwargs, ticks)
           for root, m in P.items()}
    assert got[PORT] == got[REF]
    decisions = [d["action"] for d, _ in got[PORT][0]]
    assert "out" in decisions
    if feed == "held-at-max":
        assert decisions[1] == "held"


def test_autoscale_config_knobs_take_the_port_prefix(monkeypatch):
    m = P[PORT]
    monkeypatch.setenv("GETHSHARDING_TORCH_AUTOSCALE_MAX", "7")
    monkeypatch.setenv("GETHSHARDING_AUTOSCALE_MAX", "9")
    assert m.autoscaler.AutoscaleConfig.from_env().max_replicas == 7
    defaults = {root: P[root].autoscaler.AutoscaleConfig()
                for root in PKGS}
    assert vars(defaults[PORT]) == vars(defaults[REF])
    spawner = m.autoscaler.ChainServerSpawner()
    ref_spawner = P[REF].autoscaler.ChainServerSpawner()
    assert (spawner.sigbackend, ref_spawner.sigbackend) == ("torch",
                                                            "python")


def test_spawner_without_a_card_fails_the_decision(monkeypatch):
    """No fallback: where there is no card a `--sigbackend torch` replica
    exits before its banner, so the spawn raises and the autoscaler's
    scale-out fails with it; nothing is admitted and no `python` replica
    stands in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the replica would serve")
    m = P[PORT]
    monkeypatch.delenv("GETHSHARDING_TORCH_DEVICE", raising=False)
    registry = m.metrics.Registry()
    router = m.router.FleetRouter(plain_replicas(m, ["r0"], registry),
                                  health_interval_s=0.0, registry=registry)
    membership = m.membership.FleetMembership(
        router, lambda e: m.router.Replica(e, m.sig.PythonSigBackend(),
                                           probe=None, registry=registry),
        seed={"r0": "boot:0"}, registry=registry)
    spawner = m.autoscaler.ChainServerSpawner(spawn_timeout_s=120)
    scaler = m.autoscaler.Autoscaler(
        membership, spawner, config=m.autoscaler.AutoscaleConfig(),
        registry=registry, signals=lambda: dict(HOT))
    try:
        with pytest.raises(RuntimeError, match="no address banner"):
            scaler.tick(now=0.0)
        assert membership.endpoints() == ["boot:0"]
        assert spawner.spawned() == [] and membership.epoch == 0
    finally:
        router.close()


# == 6. retry policies ========================================================

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seeded_jitter_delays_match_reference(seed):
    delays = {}
    for root, m in P.items():
        out = []
        for jitter in (0.5, 0.0, 1.0):
            policy = m.policy.RetryPolicy(attempts=12, base_s=0.01,
                                          cap_s=0.5, jitter=jitter,
                                          seed=seed)
            out.append([policy.backoff_s(k) for k in range(12)])
        delays[root] = out
    assert delays[PORT] == delays[REF]
    assert delays[PORT][1] == [min(0.5, 0.01 * 2 ** k) for k in range(12)]


def _retry_life(m):
    registry = m.metrics.Registry()
    slept = []
    executor = m.policy.RetryExecutor(
        "torch-fleet-test",
        m.policy.RetryPolicy(attempts=5, base_s=0.02, cap_s=0.1, seed=3),
        registry=registry, sleep=slept.append)
    outcomes = []
    for fails, exc in ((2, ConnectionError), (9, TimeoutError),
                       (1, FileNotFoundError), (1, ValueError)):
        state = {"n": 0}

        def flaky():
            state["n"] += 1
            if state["n"] <= fails:
                raise exc("flaky")
            return state["n"]

        try:
            outcomes.append(("ok", executor.call(flaky)))
        except Exception as err:  # noqa: BLE001 - the compared outcome
            outcomes.append(("err", type(err).__name__, state["n"]))
    counts = {k: registry.counter(
        f"resilience/retry/torch-fleet-test/{k}").value
        for k in ("retries", "giveups")}
    state = {"n": 0}

    def twice():
        state["n"] += 1
        if state["n"] < 3:
            raise ConnectionError("again")
        return "done"

    one_shot = m.policy.retry_call(
        twice, seam="torch-fleet-oneshot",
        policy=m.policy.RetryPolicy(attempts=3, base_s=0.0, seed=1))
    return outcomes, slept, counts, (one_shot, state["n"])


def test_retry_call_and_executor_match_reference():
    got = {root: _retry_life(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    outcomes, slept, counts, one_shot = got[PORT]
    assert outcomes[0] == ("ok", 3)
    assert outcomes[1] == ("err", "TimeoutError", 5)
    assert outcomes[2] == ("err", "FileNotFoundError", 1)
    assert counts == {"retries": 6, "giveups": 1}
    assert one_shot == ("done", 3)


# == ClassedSigBackend ========================================================

def test_classed_backend_matches_reference():
    got = {}
    for root, m in P.items():
        registry = m.metrics.Registry()
        serving = m.serving.ServingSigBackend(
            m.sig.PythonSigBackend(), m.serving.ServingConfig(flush_us=200),
            registry=registry)
        try:
            classed = serving.classed("catchup_replay", tenant="t1")
            (digest, sig, want), = ecdsa_cases(m, 1, tag=b"classed")
            msgs, sig_rows, pk_rows, keys = committee_rows(m)
            out = ([bytes(a) for a in classed.ecrecover_addresses(
                        [digest], [sig])] == [want],
                   classed.bls_verify_committees(msgs, sig_rows, pk_rows,
                                                 pk_row_keys=keys),
                   classed.bls_verify_committees_async(
                       msgs, sig_rows, pk_rows).result(timeout=60),
                   classed.name, classed.klass, classed.tenant,
                   registry.counter(
                       "serving/class/catchup_replay/requests").value)
            classed.close()        # a view never closes the tier
            out += (serving.bls_verify_committees(msgs[:1], sig_rows[:1],
                                                  pk_rows[:1]),)
            with pytest.raises(ValueError):
                serving.classed("nope")
        finally:
            serving.close()
        got[root] = out[:3] + out[4:]
    assert got[PORT] == got[REF]
    assert got[PORT][1] == [True, False, True]


# == 7. the frontend over RPC replicas ========================================

def _replica_servers(m, n=2):
    out = []
    for _ in range(n):
        serving = m.serving.ServingSigBackend(
            m.sig.PythonSigBackend(), m.serving.ServingConfig(flush_us=200),
            registry=m.metrics.Registry())
        server = m.server.RPCServer(m.chain.SimulatedMainchain(),
                                    sig_backend=serving)
        server.start()
        out.append((server, serving))
    return out


def _rpc_error(m, call):
    try:
        call()
    except m.client.RPCError as exc:
        return exc.code, exc.message.split(":")[0]
    return None


def _frontend_life(m):
    replicas = _replica_servers(m)
    endpoints = ["%s:%d" % server.address for server, _ in replicas]
    registry = m.metrics.Registry()
    frontend = m.frontend.build_frontend(endpoints, health_interval_s=0.0,
                                         registry=registry)
    frontend.start()
    client = m.client.RPCClient(*frontend.address, timeout=60)
    enc = m.codec
    out = {}
    try:
        cases = ecdsa_cases(m, 3, tag=b"fe")
        out["ecrecover"] = [client.call(
            "shard_ecrecover", [enc.enc_bytes(d)], [enc.enc_bytes(s)])
            == [enc.enc_bytes(w)] for d, s, w in cases]
        msgs, sig_rows, pk_rows, keys = committee_rows(m)
        committee = ([enc.enc_bytes(x) for x in msgs],
                     enc.enc_g1_rows(sig_rows), enc.enc_g2_rows(pk_rows),
                     enc.enc_pk_row_keys(keys))
        out["committees"] = client.call("shard_verifyCommittees",
                                        *committee)
        out["committees_bulk"] = client.call(
            "shard_verifyCommittees", *committee, "bulk_audit", "tenant-a")
        agg_keys = [m.bls.bls_keygen(b"fe-agg-%d" % j) for j in range(3)]
        agg_sig = m.bls.bls_aggregate_sigs(
            [m.bls.bls_sign(b"fe-agg", sk) for sk, _ in agg_keys])
        agg_pk = m.bls.bls_aggregate_pks([pk for _, pk in agg_keys])
        out["aggregates"] = client.call(
            "shard_verifyAggregates",
            [enc.enc_bytes(b"fe-agg"), enc.enc_bytes(b"fe-other")],
            [enc.enc_g1(agg_sig)] * 2, [enc.enc_g2(agg_pk)] * 2)
        health = client.call("shard_health")
        out["health"] = health
        out["drain_r0"] = client.call("shard_drainReplica", "r0")["state"]
        out["after_drain"] = client.call(
            "shard_ecrecover", [enc.enc_bytes(cases[0][0])],
            [enc.enc_bytes(cases[0][1])]) == [enc.enc_bytes(cases[0][2])]
        out["undrain_r0"] = client.call("shard_undrainReplica",
                                        "r0")["state"]
        status = client.call("shard_fleetStatus")
        out["membership"] = client.call("shard_membership")["epoch"]
        added = client.call("shard_addReplica", endpoints[0] + "0")
        out["add"] = (added["epoch"], added["state"])
        out["duplicate"] = _rpc_error(m, lambda: client.call(
            "shard_addReplica", endpoints[0] + "0"))
        out["unknown"] = _rpc_error(m, lambda: client.call(
            "shard_removeReplica", "ep:never"))
        removed = client.call("shard_removeReplica", endpoints[0] + "0")
        out["remove"] = (removed["detached"], removed["epoch"])
        out["unknown_method"] = _rpc_error(m, lambda: client.call(
            "shard_nope"))
        out["drain"] = client.call("shard_drain")["draining"]
        out["refused"] = _rpc_error(m, lambda: client.call(
            "shard_ecrecover", [], []))
        out["metrics"] = "fleet/router/calls" in client.call(
            "shard_metrics")
        out["methods"] = dict(frontend.method_calls)
    finally:
        client.close()
        frontend.stop(grace_s=1.0, notice_s=0.0)
        for server, serving in replicas:
            server.stop()
            serving.close()
    return out, status


def test_frontend_over_rpc_replicas_matches_reference():
    got = {root: _frontend_life(m) for root, m in P.items()}
    port, port_status = got[PORT]
    ref, ref_status = got[REF]
    assert port == ref
    assert port["ecrecover"] == [True] * 3
    assert port["committees"] == port["committees_bulk"] == [True, False,
                                                             True]
    assert port["aggregates"] == [True, False]
    assert port["drain_r0"] == "draining" and port["undrain_r0"] == \
        "healthy"
    assert port["duplicate"] == (-32011, "DuplicateReplicaError")
    assert port["unknown"] == (-32011, "UnknownReplicaError")
    assert port["refused"] == (-32010, "RuntimeError")
    # the JAX package's status also carries its trace collector's view
    assert set(ref_status) - set(port_status) == {"fleettrace"}


@pytest.mark.parametrize("method,module", [
    ("shard_traceHandshake", "tracing/export.py"),
    ("shard_traceExport", "fleettrace/"),
    ("shard_traceAttribution", "fleettrace/"),
    ("shard_traceExemplars", "fleettrace/"),
])
def test_frontend_trace_plane_refuses_by_module(method, module):
    m = P[PORT]
    registry = m.metrics.Registry()
    router = m.router.FleetRouter(plain_replicas(m, ["r0"], registry),
                                  health_interval_s=0.0, registry=registry)
    frontend = m.frontend.FrontendServer(router)
    frontend.start()
    client = m.client.RPCClient(*frontend.address, timeout=30)
    try:
        params = [{}] if method == "shard_traceExport" else []
        with pytest.raises(m.client.RPCError, match=f"no {module} yet"):
            client.call(method, *params)
    finally:
        client.close()
        frontend.stop(grace_s=1.0, notice_s=0.0)


@pytest.mark.parametrize("argv,module", [
    (["--trace-out", "t.json"], "tracing/export.py"),
    (["--fleettrace"], "fleettrace/"),
], ids=["trace-out", "fleettrace"])
def test_frontend_refuses_unported_options_by_module(argv, module, capsys):
    m = P[PORT]
    assert m.frontend.main(["--replica", "127.0.0.1:1"] + argv) == 2
    assert f"no {module} yet" in capsys.readouterr().err


def test_frontend_flags_match_reference():
    import argparse

    real = argparse.ArgumentParser.parse_args
    seen = {}

    def grab(parser, args=None, namespace=None):
        seen[parser.prog] = parser
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            P[REF].frontend.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    ref = {a.dest: a for a in seen["fleet-frontend"]._actions}
    port = {a.dest: a for a in P[PORT].frontend.build_parser()._actions}
    assert sorted(port) == sorted(ref)
    for dest, action in port.items():
        assert action.option_strings == ref[dest].option_strings, dest
        if dest != "autoscale_backend":
            assert action.default == ref[dest].default, dest
    assert (port["autoscale_backend"].default,
            ref["autoscale_backend"].default) == ("torch", "python")


def _gossip_life(m):
    def frontend(peers=None):
        registry = m.metrics.Registry()
        router = m.router.FleetRouter(plain_replicas(m, ["r0"], registry),
                                      health_interval_s=0.0,
                                      registry=registry)
        membership = m.membership.FleetMembership(
            router, lambda e: m.router.Replica(
                e, m.sig.PythonSigBackend(), probe=None,
                registry=registry),
            seed={"r0": "boot:0"}, registry=registry)
        server = m.frontend.FrontendServer(
            router, membership=membership, peers=peers or [],
            gossip_interval_s=3600.0)
        server.start()
        return server

    server_b = frontend()
    server_a = frontend(peers=["127.0.0.1:%d" % server_b.address[1]])
    client = m.client.RPCClient(*server_a.address, timeout=30)
    steps = []
    try:
        steps.append(client.call("shard_addReplica", "ep:pushed")["epoch"])
        steps.append((server_b.membership.epoch,
                      server_b.membership.endpoints()))
        server_b.membership.add("ep:pulled")
        steps.append(server_a.gossip_once())
        steps.append((server_a.membership.epoch,
                      server_a.membership.endpoints()))
        snap = server_a.membership.snapshot()
        steps.append(client.call("shard_fleetReconfigure",
                                 snap["endpoints"], snap["epoch"]))
        steps.append(client.call("shard_fleetReconfigure",
                                 ["boot:0"]))
        steps.append((server_b.membership.epoch,
                      server_b.membership.endpoints()))
        steps.append(client.call("shard_health")["epoch"])
    finally:
        client.close()
        server_a.stop(grace_s=1.0, notice_s=0.0)
        server_b.stop(grace_s=1.0, notice_s=0.0)
    return steps


def test_membership_gossip_between_frontends_matches_reference():
    got = {root: _gossip_life(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    steps = got[PORT]
    assert steps[1] == (1, ["boot:0", "ep:pushed"])
    assert steps[3] == (2, ["boot:0", "ep:pulled", "ep:pushed"])
    assert steps[6] == (3, ["boot:0"])


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _pool_life(m):
    replicas = _replica_servers(m, n=1)
    endpoint = "%s:%d" % replicas[0][0].address
    frontends = [m.frontend.build_frontend(
        [endpoint], health_interval_s=0.0, registry=m.metrics.Registry())
        for _ in range(2)]
    for frontend in frontends:
        frontend.start()
    names = ["127.0.0.1:%d" % f.address[1] for f in frontends]
    (digest, sig, want), = ecdsa_cases(m, 1, tag=b"pool")
    call = lambda pool: [bytes(a) for a in pool.ecrecover_addresses(
        [digest], [sig])] == [want]
    steps, stopped = [], set()
    pool = m.client.FrontendPool.dial(",".join(names), timeout=30)
    dead = m.client.FrontendPool(["127.0.0.1:%d" % _free_port(), names[1]],
                                 timeout=30)
    try:
        steps.append((call(pool), pool.failovers, names.index(
            pool.primary())))
        # the first frontend drains: its typed refusal fails the pool over
        frontends[0].draining = True
        steps.append((call(pool), pool.failovers, names.index(
            pool.primary())))
        frontends[0].stop(grace_s=1.0, notice_s=0.0)
        stopped.add(0)
        steps.append((call(pool), pool.failovers, names.index(
            pool.primary())))
        steps.append(pool.call("shard_health")["replicas"])
        # a pool whose first frontend was never up fails over on the dial
        steps.append((call(dead), dead.failovers))
        # every frontend gone: the last error propagates
        frontends[1].stop(grace_s=1.0, notice_s=0.0)
        stopped.add(1)
        try:
            call(pool)
            steps.append(None)
        except Exception as exc:  # noqa: BLE001 - the compared outcome
            steps.append(isinstance(exc, ConnectionError))
    finally:
        pool.close()
        dead.close()
        for i, frontend in enumerate(frontends):
            if i not in stopped:
                frontend.stop(grace_s=1.0, notice_s=0.0)
        for server, serving in replicas:
            server.stop()
            serving.close()
    return steps


def test_frontend_pool_failover_matches_reference():
    got = {root: _pool_life(m) for root, m in P.items()}
    assert got[PORT] == got[REF]
    steps = got[PORT]
    assert steps[0] == (True, 0, 0)
    assert steps[1] == (True, 1, 1)
    assert steps[2] == (True, 1, 1)
    assert steps[4] == (True, 1)
    assert steps[5] is True


def test_rpc_replica_backend_types_draining_and_redials():
    """A draining replica's refusal and a lost connection both surface as
    `ConnectionError` (the router's retry class), and a backend dialed
    lazily connects on first use and redials after its replica restarts
    on the same endpoint."""
    m = P[PORT]
    (server, serving), = _replica_servers(m, n=1)
    host, port = server.address
    backend = m.router.RpcReplicaBackend.dial_lazy(host, port, timeout=30)
    (digest, sig, want), = ecdsa_cases(m, 1, tag=b"redial")
    try:
        assert backend.client is None
        assert [bytes(a) for a in backend.ecrecover_addresses(
            [digest], [sig])] == [want]
        assert backend.health()["draining"] is False
        stats = backend._call("shard_servingStats")
        # the port's own keys: launches so far (none on the host's scalar
        # backend) and the device backend's last_timing (none there)
        assert stats["launches"] == {} and stats["last_timing"] is None
        assert stats["dispatches"]["ecrecover_addresses"] == 1
        backend.drain()
        with pytest.raises(ConnectionError, match="draining"):
            backend.ecrecover_addresses([digest], [sig])
        server.stop()
        serving.close()
        with pytest.raises(ConnectionError):
            backend.ecrecover_addresses([digest], [sig])
        serving = m.serving.ServingSigBackend(m.sig.PythonSigBackend())
        server = m.server.RPCServer(m.chain.SimulatedMainchain(),
                                    host=host, port=port,
                                    sig_backend=serving)
        server.start()
        assert [bytes(a) for a in backend.ecrecover_addresses(
            [digest], [sig])] == [want]
    finally:
        backend.close()
        server.stop()
        serving.close()
    with pytest.raises(ConnectionError, match="closed|lost"):
        backend.ecrecover_addresses([digest], [sig])


# == 8. a frontend process over two chain_server processes ====================

def _spawn(argv, env, log):
    proc = subprocess.Popen([sys.executable, "-m"] + argv, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=log, env=env,
                            text=True)
    line = proc.stdout.readline()
    assert line, f"{argv[0]} printed no address"
    addr = json.loads(line)
    return proc, f"{addr['host']}:{addr['port']}"


def _exit_line(path: Path, prefix: str) -> dict:
    line = [l for l in path.read_text().splitlines() if prefix in l][-1]
    return json.loads(line.split(prefix, 1)[1])


def test_frontend_process_over_chain_servers_equals_reference(tmp_path):
    """`python -m gethsharding_tpu_torch.fleet.frontend` over two port
    `chain_server`s run with `--sigbackend torch` on the CPU: a small
    period's keyed committees (a tampered row among them) and their repeat
    give the reference `python` backend's verdicts, the affinity keeps
    each key on one replica, and the frontend's exit line shows no launch
    and no CUDA context."""
    env = dict(os.environ, GETHSHARDING_TORCH_DEVICE="cpu",
               GETHSHARDING_TORCH_PERFWATCH_DIR=str(tmp_path / "bundles"))
    procs, logs = [], []
    try:
        endpoints = []
        for i in range(2):
            log = open(tmp_path / f"replica-{i}.log", "w")
            logs.append(log)
            proc, endpoint = _spawn(
                ["gethsharding_tpu_torch.rpc.chain_server", "--sigbackend",
                 "torch", "--quorum", "1"], env, log)
            procs.append(proc)
            endpoints.append(endpoint)
        log = open(tmp_path / "frontend.log", "w")
        logs.append(log)
        argv = ["gethsharding_tpu_torch.fleet.frontend",
                "--health-interval", "0.25", "--replica-timeout", "600"]
        for endpoint in endpoints:
            argv += ["--replica", endpoint]
        proc, front = _spawn(argv, env, log)
        procs.append(proc)
        m = P[PORT]
        enc = m.codec
        host, port = front.rsplit(":", 1)
        client = m.client.RPCClient(host, int(port), timeout=600)
        msgs, sig_rows, pk_rows, keys = committee_rows(m, n=4, tamper=2)
        want = P[REF].sig.get_backend("python").bls_verify_committees(
            msgs, sig_rows, pk_rows)
        try:
            got, routed = [], []
            for rep in range(2):
                for i in range(len(msgs)):
                    got.append(client.call(
                        "shard_verifyCommittees",
                        [enc.enc_bytes(msgs[i])],
                        enc.enc_g1_rows(sig_rows[i:i + 1]),
                        enc.enc_g2_rows(pk_rows[i:i + 1]),
                        enc.enc_pk_row_keys(keys[i:i + 1]),
                        "bulk_audit")[0])
                routed.append({name: r["routed"] for name, r in client.call(
                    "shard_fleetStatus")["replicas"].items()})
        finally:
            client.close()
        assert got == [bool(v) for v in want] * 2
        assert want == [True, True, False, True]
        # the repeat landed where the first pass did: the routed counts
        # doubled replica for replica
        assert {k: 2 * v for k, v in routed[0].items()} == routed[1]
        for p in procs[::-1]:
            p.terminate()
        for p in procs:
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    frontend = _exit_line(tmp_path / "frontend.log", "frontend at exit: ")
    assert frontend["launches"] == {} and frontend["cuda_initialized"] is \
        False
    assert frontend["methods"]["shard_verifyCommittees"] == 8
    served = [_exit_line(tmp_path / f"replica-{i}.log",
                         "chain-server at exit: ") for i in range(2)]
    assert sum(s["methods"].get("shard_verifyCommittees", 0)
               for s in served) == 8
    assert sum(s["serving"]["bls_committee"][0] for s in served) == 8
