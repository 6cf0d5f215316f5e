"""The port's resilience plane (`gethsharding_tpu_torch/resilience/`:
chaos, soundness, breaker, watchdog; `slo/`; the node's composition and
CLI) held against the JAX package's, on the CPU:

1. chaos: `parse_spec` on the same specs gives the same rules, modes and
   seed, `decide` the same decision sequence over 1,000 calls a seam,
   `mode=corrupt` corrupts the same results the same way, malformed specs
   fail naming the same token, `unwired_seams` and the mainchain proxy
   behave alike;
2. soundness: `detection_probability` and `dispatches_to_detect` over a
   grid, the per-dispatch decision and row subset for each (seed, op,
   dispatch index), the invariant cases of `tests/test_soundness.py`, a
   mismatch's message and counters, the audit of async and `submit`
   futures at pull time (counted once);
3. breaker: the same fault script over stub backends on an injected clock
   gives the same state sequence, results and counters (sync, async and
   `submit` faces); watchdog: a hung stub dispatch fails its batch with
   `DeadlineExceeded` and the next batch is served, the stale thread's
   late call included; the dispatcher's drain-and-fail close;
4. SLO: the same events give the same snapshot, a breach included;
5. the node: the wrappers compose in the JAX package's order, layer by
   layer; the txpool recovers through the composed backend where the
   JAX package's does; the devnet of `tests/torch_node_script.py` at
   `device="cpu"` with `serving=True`, `sig_backend="failover-torch"` and
   a soundness rate of 1.0 (1 row) gives the JAX package's votes and
   records, with the breaker closed and no mismatch; the CLI loop with
   the serving and resilience flags.

No wall-clock bound below a second is asserted; the flight recorder
writes under `tmp_path`.
"""

import importlib
import json
import logging
import re
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import pytest
import torch

import torch_node_script as script

torch.set_num_threads(2)

PORT, REF = "gethsharding_tpu_torch", "gethsharding_tpu"
PKGS = (PORT, REF)


def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, metrics=mod("metrics"), sig=mod("sigbackend"),
        serving=mod("serving"), queue=mod("serving.queue"),
        pipeline=mod("serving.pipeline"), chaos=mod("resilience.chaos"),
        soundness=mod("resilience.soundness"),
        breaker=mod("resilience.breaker"), errors=mod("resilience.errors"),
        slo=mod("slo.tracker"), chain=mod("smc.chain"),
        params=mod("params"), node=mod("node.backend"),
        txpool=mod("actors.txpool"))


@pytest.fixture(scope="module", autouse=True)
def _recorder_dir(tmp_path_factory):
    """The flight recorder's bundles under a temporary directory for the
    whole module, its module-scoped fixtures included."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("recorder")))
        yield


def outcome(fn):
    """A call's result, or its exception as (type name, message)."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return (type(exc).__name__, str(exc))


def counts(registry) -> dict:
    """A registry's counts and values (not its clock-dependent rates)."""
    return {k: {f: v for f, v in snap.items()
                if f not in ("rate_per_s", "rate_1m")}
            for k, snap in registry.snapshot().items()}


def stub(m, name="stub", **overrides):
    """A deterministic backend of package `m`: ecrecover answers the
    digest's first 20 bytes, verdict ops a parity of the message; any op
    can be replaced through `overrides`."""

    class Stub(m.sig.SigBackend):
        def __init__(self):
            self.name = name
            self.calls = 0

        def ecrecover_addresses(self, digests, sigs65):
            self.calls += 1
            return [bytes(d)[:20] for d in digests]

        def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
            self.calls += 1
            return [len(bytes(x)) % 2 == 0 for x in messages]

        def bls_verify_committees(self, messages, sig_rows, pk_rows,
                                  pk_row_keys=None):
            self.calls += 1
            return [len(s) > 0 and len(bytes(x)) % 2 == 0
                    for x, s in zip(messages, sig_rows)]

        def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                        pk_row_keys=None):
            out = self.bls_verify_committees(messages, sig_rows, pk_rows)
            return m.sig.VerdictFuture(lambda: out)

        def das_verify_samples(self, chunks, indices, proofs, roots):
            self.calls += 1
            return [bytes(c)[:1] == b"\x01" for c in chunks]

    backend = Stub()
    for op, fn in overrides.items():
        setattr(backend, op, fn)
    return backend


DIGESTS = [bytes([i]) * 32 for i in range(1, 6)]
SIGS = [b"\x00" * 65] * 5
MSGS = [b"ab", b"abc", b"abcd", b"", b"x" * 9]
SIG_ROWS = [[1], [1, 2], [], [3], [4]]


# == 1. chaos =================================================================

_SPECS = [
    "seed=7,backend.bls_verify_committees=2,mainchain.collation_record=0.3",
    "seed=11, backend.*=0.25, dispatch.ecrecover_addresses=1, "
    "das.sample_fetch=always",
    "seed=5,backend.*:mode=corrupt,mainchain=0.5",
    "backend.ecrecover_addresses:mode=corrupt,backend.ecrecover_addresses=3,"
    "fleet.transport=0.3,fleet.transport:mode=delay,delay_s=0.1,seed=2",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_and_decisions_equal_reference(spec):
    seams = ("backend.bls_verify_committees", "backend.ecrecover_addresses",
             "backend.das_verify_samples", "dispatch.ecrecover_addresses",
             "mainchain.collation_record", "mainchain.block_number",
             "das.sample_fetch", "fleet.transport", "client.sign")
    got = []
    for root in PKGS:
        schedule = pkg(root).chaos.parse_spec(spec)
        fields = (schedule.seed, schedule.rules, schedule.modes,
                  schedule.delay_s)
        decisions = {seam: [schedule.decide(seam) for _ in range(1000)]
                     for seam in seams}
        got.append((fields, decisions,
                    {s: schedule.mode_for(s) for s in seams},
                    dict(schedule.injected),
                    pkg(root).chaos.unwired_seams(
                        schedule, ("mainchain", "backend", "dispatch"))))
    assert got[0] == got[1]
    assert got[0][3]                     # the spec injected somewhere


_BAD_SPECS = ["not-a-rule", "backend.x:mode=explode", "backend.x:rate=1",
              "seed=x", "backend.op=zz", "mainchain.a:mode=corrupt",
              "dispatch.b:mode=corrupt", "backend.c:mode=delay",
              "fleet.transport:mode=corrupt"]


@pytest.mark.parametrize("spec", _BAD_SPECS)
def test_malformed_specs_fail_like_reference(spec):
    got = [outcome(lambda: pkg(root).chaos.parse_spec(spec))
           for root in PKGS]
    assert got[0] == got[1]
    assert got[0][0] == "ValueError"


@pytest.mark.parametrize("op", ["ecrecover_addresses", "bls_verify_committees",
                                "das_verify_samples", "async"])
def test_corrupt_mode_equals_reference(op):
    """`backend.*:mode=corrupt` at a rate: the same calls corrupted, the
    same rows, the same way; an empty batch passes off the books."""
    got = []
    for root in PKGS:
        m = pkg(root)
        schedule = m.chaos.parse_spec("seed=9,backend.*:mode=corrupt,"
                                      "backend=0.5")
        front = m.chaos.ChaosSigBackend(stub(m), schedule)
        out = []
        for i in range(24):
            k = 1 + i % 5
            if op == "ecrecover_addresses":
                res = front.ecrecover_addresses(DIGESTS[:k], SIGS[:k])
                res = [None if a is None else bytes(a) for a in res]
            elif op == "das_verify_samples":
                res = front.das_verify_samples([b"\x01", b"\x00"] * k,
                                               [0, 1] * k, [[]] * 2 * k,
                                               [b"r"] * 2 * k)
            elif op == "async":
                res = front.bls_verify_committees_async(
                    MSGS[:k], SIG_ROWS[:k], SIG_ROWS[:k]).result()
            else:
                res = front.bls_verify_committees(MSGS[:k], SIG_ROWS[:k],
                                                  SIG_ROWS[:k])
            out.append(res)
        assert front.bls_verify_committees([], [], []) == []
        got.append((out, dict(schedule.injected)))
    assert got[0] == got[1]
    assert got[0][1]


@pytest.mark.parametrize("root", PKGS)
def test_loud_faults_and_hangs_at_the_backend_seams(root):
    m = pkg(root)
    schedule = m.chaos.parse_spec("seed=1,backend.ecrecover_addresses=2,"
                                  "dispatch.das_verify_samples=1")
    front = m.chaos.ChaosSigBackend(stub(m), schedule, hang_s=0.05)
    for _ in range(2):
        with pytest.raises(m.chaos.InjectedFault):
            front.ecrecover_addresses(DIGESTS[:1], SIGS[:1])
    assert front.ecrecover_addresses(DIGESTS[:1], SIGS[:1]) == [
        DIGESTS[0][:20]]
    assert front.das_verify_samples([b"\x01"], [0], [[]], [b"r"]) == [True]
    assert schedule.injected == {"backend.ecrecover_addresses": 2,
                                 "dispatch.das_verify_samples": 1}
    assert isinstance(m.chaos.InjectedFault("x"), ConnectionError)


def test_mainchain_proxy_equals_reference():
    got = []
    for root in PKGS:
        m = pkg(root)
        chain = m.chain.SimulatedMainchain(m.params.Config(quorum_size=1))
        schedule = m.chaos.ChaosSchedule(
            rules={"mainchain.block_number": 2,
                   "mainchain.collation_record": 0.5}, seed=4)
        proxy = m.chaos.wrap(chain, schedule, "mainchain")
        out = [outcome(lambda: proxy.block_number) for _ in range(3)]
        out += [outcome(lambda: proxy.collation_record(0, 1))
                for _ in range(20)]
        _ = proxy.config              # no rule names it: off the books
        got.append((out, schedule.calls("mainchain.config"),
                    dict(schedule.injected)))
    assert got[0] == got[1]
    assert got[0][0][2] == 0 and got[0][1] == 0


# == 2. soundness =============================================================

@pytest.mark.parametrize("batch_rows", [1, 7, 64, 112])
def test_soundness_accounting_equals_reference(batch_rows):
    grid = [(rate, rows, corrupt)
            for rate in (0.01, 0.05, 0.25, 1.0) for rows in (1, 4, 9)
            for corrupt in sorted({1, max(1, batch_rows // 3), batch_rows})]
    got = []
    for root in PKGS:
        s = pkg(root).soundness
        got.append([(s.detection_probability(r, k, batch_rows, c),
                     s.detection_probability(r, k, batch_rows, c, 17),
                     s.dispatches_to_detect(r, k, batch_rows, c),
                     s.dispatches_to_detect(r, k, batch_rows, c, 0.9))
                    for r, k, c in grid])
    assert got[0] == got[1]
    for root in PKGS:
        s = pkg(root).soundness
        assert outcome(lambda: s.detection_probability(1.5, 1, 4)) == \
            outcome(lambda: pkg(REF).soundness.detection_probability(1.5, 1,
                                                                     4))
        assert s.DEFAULT_RATE == 0.05 and s.DEFAULT_ROWS == 4


@pytest.mark.parametrize("seed", [0, 3, 41])
def test_spot_check_decisions_and_rows_equal_reference(seed):
    got = []
    for root in PKGS:
        m = pkg(root)
        spot = m.soundness.SpotCheckSigBackend(
            stub(m), rate=0.3, rows=3, seed=seed,
            registry=m.metrics.Registry())
        picks = []
        for op in m.soundness.AUDITED_OPS:
            for _ in range(200):
                check, idx = spot._tick(op)
                picks.append((op, idx, check,
                              spot._select_rows(op, idx, 1 + idx % 40)))
        got.append(picks)
    assert got[0] == got[1]


def test_soundness_knobs_from_the_port_prefix(monkeypatch):
    m = pkg(PORT)
    monkeypatch.setenv("GETHSHARDING_TORCH_SOUNDNESS_RATE", "0.5")
    monkeypatch.setenv("GETHSHARDING_TORCH_SOUNDNESS_ROWS", "2")
    monkeypatch.setenv("GETHSHARDING_TORCH_SOUNDNESS_SEED", "9")
    spot = m.soundness.SpotCheckSigBackend(stub(m),
                                           registry=m.metrics.Registry())
    assert (spot.rate, spot.rows, spot.seed) == (0.5, 2, 9)
    assert spot.reference.name == "python"
    assert spot.describe()["dispatches_p99_64"] == \
        m.soundness.dispatches_to_detect(0.5, 2, 64)
    monkeypatch.delenv("GETHSHARDING_TORCH_SOUNDNESS_RATE")
    monkeypatch.delenv("GETHSHARDING_TORCH_SOUNDNESS_ROWS")
    spot = m.soundness.SpotCheckSigBackend(stub(m),
                                           registry=m.metrics.Registry())
    assert (spot.rate, spot.rows) == (0.05, 4)


_INVARIANT_CASES = {
    "short plane": ("ecrecover_addresses",
                    lambda d, s: [bytes(x)[:20] for x in d][:-1]),
    "19-byte address": ("ecrecover_addresses",
                        lambda d, s: [b"\x01" * 19 for _ in d]),
    "verdict 2": ("das_verify_samples", lambda c, i, p, r: [2] * len(c)),
    "verdict string": ("das_verify_samples",
                       lambda c, i, p, r: ["yes"] * len(c)),
    "empty committee True": (
        "bls_verify_committees",
        lambda msgs, sigs, pks, pk_row_keys=None: [True] * len(msgs)),
}


@pytest.mark.parametrize("case", sorted(_INVARIANT_CASES))
def test_invariant_violations_equal_reference(case):
    op, bad = _INVARIANT_CASES[case]
    args = {"ecrecover_addresses": (DIGESTS[:3], SIGS[:3]),
            "das_verify_samples": ([b"\x01"], [0], [[]], [b"r"]),
            "bls_verify_committees": ([b"m", b"n"], [[], [1]], [[], [2]])}
    got = []
    for root in PKGS:
        m = pkg(root)
        registry = m.metrics.Registry()
        spot = m.soundness.SpotCheckSigBackend(
            stub(m, **{op: bad}), rate=0.0, registry=registry)
        got.append((outcome(lambda: getattr(spot, op)(*args[op])),
                    counts(registry)))
    assert got[0] == got[1]
    assert got[0][0][0] == "SoundnessViolation"


def test_mismatch_and_pull_time_audits_equal_reference():
    """A corrupting primary at rate 1: the sync call, the async future
    (polled twice, counted once) and the serving `submit` future all
    raise the same `SoundnessViolation`; a clean backend passes."""
    got = []
    FULL = [[1], [1, 2], [5], [3], [4]]      # no empty committee row
    for root in PKGS:
        m = pkg(root)
        registry = m.metrics.Registry()
        ref = stub(m, "reference")
        flip = lambda msgs, sigs, pks, pk_row_keys=None: [
            not v for v in ref.bls_verify_committees(msgs, sigs, pks)]
        corrupt = stub(m, "corrupt", bls_verify_committees=flip)
        corrupt.bls_verify_committees_async = (
            lambda *a, pk_row_keys=None: m.sig.VerdictFuture(
                lambda: flip(*a)))
        spot = m.soundness.SpotCheckSigBackend(
            corrupt, rate=1.0, rows=2, seed=1, reference=ref,
            registry=registry)
        out = [outcome(lambda: spot.bls_verify_committees(MSGS, FULL, FULL))]
        future = spot.bls_verify_committees_async(MSGS, FULL, FULL)
        out += [outcome(future.result), outcome(future.result)]
        serving = m.serving.ServingSigBackend(
            stub(m, "clean"), m.serving.ServingConfig(flush_us=1000),
            registry=m.metrics.Registry())
        try:
            clean = m.soundness.SpotCheckSigBackend(
                serving, rate=1.0, rows=2, reference=ref,
                registry=registry)
            sub = clean.submit("ecrecover_addresses", DIGESTS, SIGS)
            out += [outcome(lambda: sub.result(timeout=30)), sub.done()]
        finally:
            serving.close()
        got.append((out, counts(registry)))
    assert got[0] == got[1]
    out, seen = got[0]
    assert out[0][0] == out[1][0] == out[2][0] == "SoundnessViolation"
    assert out[3] == [d[:20] for d in DIGESTS]
    assert seen["resilience/soundness/bls_verify_committees/mismatches"][
        "count"] == 2
    assert seen["resilience/soundness/ecrecover_addresses/checks"][
        "count"] == 1


# == 3. breaker, watchdog, dispatcher =========================================

def _breaker_run(root, script_steps, face="sync"):
    """Run `script_steps` [(clock, primary mode)] through a failover
    backend over a scripted primary; the timeline of (result, state,
    primary calls) and the breaker's counters."""
    m = pkg(root)
    now = [0.0]
    registry = m.metrics.Registry()
    mode = ["ok"]

    def primary_ecrecover(digests, sigs65):
        primary.calls += 1
        kind = mode[0]
        if kind == "raise":
            raise RuntimeError("device on fire")
        if kind == "shed":
            raise m.queue.ServingOverloadError("queue full")
        if kind == "caller":
            raise ValueError("ragged")
        if kind == "violation":
            raise m.errors.SoundnessViolation("spot check")
        if kind == "deadline":
            raise m.errors.DeadlineExceeded("hung")
        if kind == "wrong":
            return [b"\x00" * 20 for _ in digests]
        return [bytes(d)[:20] for d in digests]

    primary = stub(m, "primary", ecrecover_addresses=primary_ecrecover)
    if face == "submit":
        def submit(op, *args, **kwargs):
            future = Future()
            try:
                future.set_result(getattr(primary, op)(*args))
            except Exception as exc:  # noqa: BLE001 - a failed future
                future.set_exception(exc)
            return future
        primary.submit = submit
    breaker = m.breaker.CircuitBreaker(name="t", fault_threshold=2,
                                       reset_s=5.0, registry=registry,
                                       clock=lambda: now[0])
    backend = m.breaker.FailoverSigBackend(
        primary, stub(m, "fallback"), breaker=breaker, registry=registry)
    timeline = []
    for t, kind in script_steps:
        now[0], mode[0] = t, kind
        if face == "submit":
            res = outcome(lambda: backend.submit(
                "ecrecover_addresses", DIGESTS[:2], SIGS[:2]).result())
        else:
            res = outcome(lambda: backend.ecrecover_addresses(DIGESTS[:2],
                                                              SIGS[:2]))
        timeline.append((t, kind, res, breaker.state_name, primary.calls,
                         breaker.epoch))
    return timeline, {k: v.get("count", v.get("value"))
                      for k, v in registry.snapshot().items()}


_SCRIPTS = {
    "trip, probe raises, probe matches": [
        (0, "ok"), (1, "raise"), (2, "ok"), (3, "raise"), (4, "raise"),
        (5, "ok"), (8.9, "ok"), (9, "raise"), (10, "ok"), (14, "ok"),
        (14.5, "ok")],
    "probe mismatch and violation": [
        (0, "deadline"), (0, "raise"), (5, "wrong"), (6, "ok"), (10, "ok"),
        (10.1, "violation"), (11, "violation"), (16, "violation"),
        (21, "ok"), (22, "ok")],
    "weather is no fault": [
        (0, "shed"), (0, "caller"), (0, "raise"), (0, "shed"),
        (0, "caller"), (0, "raise"), (5, "shed"), (5, "ok"), (6, "ok")],
}


@pytest.mark.parametrize("face", ["sync", "submit"])
@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_breaker_timeline_equals_reference(name, face):
    port = _breaker_run(PORT, _SCRIPTS[name], face)
    assert port == _breaker_run(REF, _SCRIPTS[name], face)
    states = [step[3] for step in port[0]]
    assert "open" in states and states[-1] == "closed"


@pytest.mark.parametrize("root", PKGS)
def test_breaker_async_face_and_stale_epochs(root):
    """Async faults surface at pull time and are served from the
    fallback, counted once however often the future is polled; faults of
    futures submitted before a re-close do not re-trip."""
    m = pkg(root)
    now = [0.0]
    registry = m.metrics.Registry()
    fail = [True]

    def async_committees(msgs, sigs, pks, pk_row_keys=None):
        def finalize():
            if fail[0]:
                raise RuntimeError("pull-time fault")
            return [True] * len(msgs)
        return m.sig.VerdictFuture(finalize)

    primary = stub(m, "primary",
                   bls_verify_committees_async=async_committees)
    breaker = m.breaker.CircuitBreaker(name="a", fault_threshold=2,
                                       reset_s=1.0, registry=registry,
                                       clock=lambda: now[0])
    backend = m.breaker.FailoverSigBackend(primary, stub(m, "fallback"),
                                           breaker=breaker,
                                           registry=registry)
    want = stub(m).bls_verify_committees(MSGS, SIG_ROWS, SIG_ROWS)
    stale = backend.bls_verify_committees_async(MSGS, SIG_ROWS, SIG_ROWS)
    f = backend.bls_verify_committees_async(MSGS, SIG_ROWS, SIG_ROWS)
    assert f.result() == want and f.result() == want
    assert breaker.state_name == "closed"
    assert stale.result() == want
    assert breaker.state_name == "open"
    now[0] = 2.0
    fail[0] = False
    assert backend.bls_verify_committees_async(
        MSGS, SIG_ROWS, SIG_ROWS).result() == want          # the probe
    assert breaker.state_name == "closed"
    fail[0] = True
    late = [backend.bls_verify_committees_async(MSGS, SIG_ROWS, SIG_ROWS)
            for _ in range(1)]
    breaker._epoch += 1          # a recovery between submit and pull
    assert late[0].result() == want
    assert breaker.state_name == "closed"
    assert registry.counter("resilience/breaker/a/primary_faults").value \
        == 3


def test_breaker_knobs_from_the_port_prefix(monkeypatch):
    m = pkg(PORT)
    breaker = m.breaker.CircuitBreaker(registry=m.metrics.Registry())
    assert (breaker.fault_threshold, breaker.reset_s) == (3, 5.0)
    monkeypatch.setenv("GETHSHARDING_TORCH_BREAKER_THRESHOLD", "4")
    monkeypatch.setenv("GETHSHARDING_TORCH_BREAKER_RESET_S", "0.5")
    breaker = m.breaker.CircuitBreaker(registry=m.metrics.Registry())
    assert (breaker.fault_threshold, breaker.reset_s) == (4, 0.5)


def _hang_backend(m, hangs=1):
    """First `hangs` calls block on `release` (a wedged dispatch); every
    call's result is kept in `outs`, the late ones included."""
    release = threading.Event()
    state = {"hangs": hangs, "outs": [], "threads": set()}

    def ecrecover(digests, sigs65):
        state["threads"].add(threading.current_thread().ident)
        if state["hangs"] > 0:
            state["hangs"] -= 1
            release.wait(30.0)
        out = [bytes(d)[:20] for d in digests]
        state["outs"].append(out)
        return out

    return stub(m, "hang", ecrecover_addresses=ecrecover), release, state


@pytest.mark.parametrize("root", PKGS)
def test_watchdog_fails_hung_batch_and_serves_the_next(root):
    m = pkg(root)
    registry = m.metrics.Registry()
    backend, release, state = _hang_backend(m)
    serving = m.serving.ServingSigBackend(
        backend, m.serving.ServingConfig(flush_us=100.0, watchdog_s=1.0),
        registry=registry)
    want = [d[:20] for d in DIGESTS[:2]]
    try:
        with pytest.raises(m.errors.DeadlineExceeded, match="hung"):
            serving.ecrecover_addresses(DIGESTS[:2], SIGS[:2])
        assert serving.ecrecover_addresses(DIGESTS[:2], SIGS[:2]) == want
        release.set()                     # the stale thread's late call
        deadline = time.monotonic() + 10
        while len(state["outs"]) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert state["outs"] == [want, want]
        assert len(state["threads"]) == 2
        assert registry.counter("resilience/watchdog/timeouts").value == 1
        assert registry.counter(
            "serving/pipeline/aborted_batches").value == 1
    finally:
        release.set()
        serving.close()


@pytest.mark.parametrize("root", PKGS)
def test_watchdog_timeout_feeds_the_breaker(root):
    """A chaos hang under serving surfaces as `DeadlineExceeded`; the
    failover face above counts a primary fault and answers from the
    fallback."""
    m = pkg(root)
    schedule = m.chaos.ChaosSchedule(
        seed=3, rules={"dispatch.ecrecover_addresses": 1})
    serving = m.serving.ServingSigBackend(
        m.chaos.ChaosSigBackend(stub(m), schedule, hang_s=3.0),
        m.serving.ServingConfig(flush_us=100.0, watchdog_s=1.0),
        registry=m.metrics.Registry())
    registry = m.metrics.Registry()
    breaker = m.breaker.CircuitBreaker(name="wd", fault_threshold=3,
                                       reset_s=60, registry=registry)
    backend = m.breaker.FailoverSigBackend(serving, stub(m, "fallback"),
                                           breaker=breaker,
                                           registry=registry)
    want = [d[:20] for d in DIGESTS[:1]]
    try:
        assert backend.ecrecover_addresses(DIGESTS[:1], SIGS[:1]) == want
        assert registry.counter(
            "resilience/breaker/wd/primary_faults").value == 1
        assert backend.ecrecover_addresses(DIGESTS[:1], SIGS[:1]) == want
        assert registry.counter(
            "resilience/breaker/wd/primary_calls").value == 2
        assert breaker.state_name == "closed"
    finally:
        serving.close()


def test_dispatcher_caps_abandoned_threads():
    """A hang that every dispatch thread meets (a backend's lock held by
    the hung call) holds at most `MAX_ABANDONED` abandoned threads plus
    the live one: past the cap a fail starts no thread, and the first
    abandoned thread whose call returns serves the queue on. Restarted
    threads are named by their generation."""
    m = pkg(PORT)
    cap = m.pipeline.MAX_ABANDONED
    dispatcher = m.pipeline.PipelinedDispatcher(
        name="t-cap", registry=m.metrics.Registry())
    gate, entered = threading.Event(), threading.Semaphore(0)
    failed, served = [], threading.Event()
    ran_on = []

    def wedged():
        entered.release()
        gate.wait(30.0)

    alive = lambda: sorted(t.name for t in threading.enumerate()
                           if t.name.startswith("t-cap"))
    try:
        for _ in range(cap + 1):
            dispatcher.submit(wedged, fail=failed.append)
            assert entered.acquire(timeout=10.0)
            assert dispatcher.fail_current(
                m.errors.DeadlineExceeded("hung"))
        assert alive() == ["t-cap"] + [f"t-cap-{g}"
                                       for g in range(1, cap + 1)]
        dispatcher.submit(lambda: (ran_on.append(
            threading.current_thread().name), served.set()))
        gate.set()
        assert served.wait(10.0)
        deadline = time.monotonic() + 10
        while len(alive()) > 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert alive() == ran_on
        assert len(failed) == cap + 1
        assert all(isinstance(e, m.errors.DeadlineExceeded) for e in failed)
    finally:
        gate.set()
        dispatcher.close(wait=True, grace_s=2.0)


@pytest.mark.parametrize("root", PKGS)
def test_dispatcher_close_fails_queued_work(root):
    m = pkg(root)
    dispatcher = m.pipeline.PipelinedDispatcher(
        name="t-close", registry=m.metrics.Registry())
    started, release = threading.Event(), threading.Event()
    failed = []

    def slow():
        started.set()
        release.wait(10.0)

    dispatcher.submit(slow, fail=failed.append)
    assert started.wait(10.0)
    dispatcher.submit(lambda: failed.append("ran"), fail=failed.append)
    dispatcher.close(wait=True, grace_s=0.2)
    release.set()
    assert len(failed) == 2
    assert all(isinstance(e, m.errors.DispatcherClosed) for e in failed)
    with pytest.raises(RuntimeError, match="closed"):
        dispatcher.submit(lambda: None)


def test_flight_recorder_dumps_where_the_trigger_points(tmp_path,
                                                         monkeypatch):
    """A fatal trigger's bundle lands in the directory set when it fired,
    even if the setting changes before the dump thread writes; a second
    trigger inside the rate limit writes none."""
    from gethsharding_tpu_torch.perfwatch.recorder import FlightRecorder

    m = pkg(PORT)
    here, later = tmp_path / "here", tmp_path / "later"
    monkeypatch.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR", str(here))
    recorder = FlightRecorder(registry=m.metrics.Registry())
    recorder.record("chaos_decision", seam="backend.x", index=0)
    recorder.trigger("breaker_trip", dump=True, breaker="t")
    monkeypatch.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR", str(later))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            here.is_dir() and any(here.iterdir())
            and not recorder._dump_pending):
        time.sleep(0.01)
    (bundle,) = list(here.iterdir())
    assert sorted(p.name for p in bundle.iterdir()) == [
        "events.json", "manifest.json", "metrics.json", "spans.json"]
    assert "breaker_trip" in bundle.name and not later.exists()
    assert recorder.dump("again", str(here)) is None     # rate-limited


# == 4. SLO ===================================================================

def _slo_events():
    out = []
    for i in range(400):
        t = 1000.0 + i * 0.7
        out.append(("interactive", i % 50 != 0, 0.002 * (i % 13), t))
        out.append(("bulk_audit", True, 0.3 + (i % 7), t))
        if i > 300:
            out.append(("integrity", i % 3 != 0, None, t))
        out.append(("no_such_objective", False, None, t))
    return out


def test_slo_snapshot_equals_reference():
    got = []
    for root in PKGS:
        m = pkg(root)
        registry = m.metrics.Registry()
        tracker = m.slo.SLOTracker(registry=registry)
        for name, ok, latency, t in _slo_events():
            tracker.record(name, ok=ok, latency_s=latency, now=t)
        got.append((tracker.describe(now=1300.0),
                    {k: v for k, v in counts(registry).items()
                     if k.startswith("slo/")}))
    assert got[0] == got[1]
    assert got[0][0]["integrity"]["breaches"] == 1
    assert set(got[0][0]) == set(pkg(REF).slo.DEFAULT_OBJECTIVES)


def test_slo_objective_knobs_from_the_port_prefix(monkeypatch):
    m = pkg(PORT)
    monkeypatch.setenv("GETHSHARDING_TORCH_SLO_INTERACTIVE_P99_MS", "0")
    monkeypatch.setenv("GETHSHARDING_TORCH_SLO_BULK_AUDIT_AVAILABILITY",
                       "0.9")
    objectives = m.slo.default_objectives()
    assert objectives["interactive"].latency_target_s is None
    assert objectives["bulk_audit"].availability == 0.9
    assert m.slo.tracker() is m.slo.tracker()


# == 5. the node and the CLI ==================================================

def _layers(backend):
    names = []
    while backend is not None:
        names.append(type(backend).__name__)
        backend = getattr(backend, "inner", None)
    return names


_COMPOSITIONS = {
    "serving": {"serving": True},
    "chaos": {"chaos": "seed=1,backend.ecrecover_addresses=0.1"},
    "soundness": {"soundness_rate": 0.5},
    "failover": {"failover": True},
    "all": {"serving": True, "chaos": "seed=2", "soundness_rate": 1.0,
            "failover": True},
    "none": {},
}


@pytest.mark.parametrize("actor", ["notary", "proposer"])
@pytest.mark.parametrize("name", sorted(_COMPOSITIONS))
def test_composition_follows_reference(name, actor):
    """device -> chaos -> serving -> soundness -> failover, layer by
    layer as the JAX package composes it; the proposer's txpool recovers
    through the composed backend exactly where the JAX package's does."""
    options = dict(_COMPOSITIONS[name])
    got = []
    for root, device_name in ((PORT, "torch"), (REF, "python")):
        m = pkg(root)
        kw = {"sig_backend": ("failover-" if options.get("failover")
                              else "") + device_name}
        if root == PORT:
            kw["device"] = "cpu"
        for key in ("serving", "soundness_rate"):
            if key in options:
                kw[key] = options[key]
        if "chaos" in options:
            kw["chaos"] = m.chaos.parse_spec(options["chaos"])
        node = m.node.ShardNode(actor=actor,
                                backend=m.chain.SimulatedMainchain(),
                                txpool_interval=None, **kw)
        try:
            if actor == "notary":
                sig = node.service(
                    importlib.import_module(f"{root}.actors.notary").Notary
                ).sig_backend
                got.append(_layers(sig)[:-1])
            else:
                pool = node.service(m.txpool.TXPool)
                got.append(None if pool.sig_backend is None
                           else _layers(pool.sig_backend)[:-1])
        finally:
            node.stop()
    assert got[0] == got[1]


def test_serving_flag_with_a_serving_name_refused_like_reference():
    got = [outcome(lambda: pkg(root).node.ShardNode(
        sig_backend=f"serving-{dev}", serving=True,
        **({"device": "cpu"} if root == PORT else {})))
        for root, dev in ((PORT, "torch"), (REF, "python"))]
    assert got[0] == got[1] and got[0][0] == "ValueError"


@pytest.fixture(scope="module")
def wrapped_devnet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_SOUNDNESS_ROWS", "1")
        m = script.modules(PORT)
        registry = pkg(PORT).metrics.DEFAULT_REGISTRY
        before = {k: v.get("count") for k, v in registry.snapshot().items()}
        # the proposers recover their transactions' senders on the host:
        # through the tier each would be a plain recovery (~13 s a call
        # on this CPU); the card's smoke runs them through it
        out = script.run(m, script.cpu_config(m), script.CPU_POOL, 2,
                         {"sig_backend": "failover-torch", "device": "cpu",
                          "serving": True, "soundness_rate": 1.0},
                         proposer_kw={"sig_backend": "torch",
                                      "serving": False,
                                      "soundness_rate": 0.0})
        after = {k: v.get("count") for k, v in registry.snapshot().items()}
    out["counters"] = {k: (v or 0) - (before.get(k) or 0)
                       for k, v in after.items() if v is not None}
    return out


@pytest.fixture(scope="module")
def ref_devnet():
    m = script.modules(REF)
    return script.run(m, script.cpu_config(m), script.CPU_POOL, 2,
                      {"sig_backend": "python"})


def test_wrapped_devnet_equals_reference(wrapped_devnet, ref_devnet):
    """The port's devnet behind serving, soundness (rate 1, one row) and
    failover: every period's shard DBs, votes, records, counters and
    errors are the JAX package's plain devnet's."""
    assert script.jsonable(wrapped_devnet["summaries"]) == \
        script.jsonable(ref_devnet["summaries"])
    notary = wrapped_devnet["nodes"]["notary"]
    assert _layers(notary.sig_backend) == [
        "FailoverSigBackend", "SpotCheckSigBackend", "ServingSigBackend",
        "TorchSigBackend"]


def test_wrapped_devnet_breaker_and_checks(wrapped_devnet):
    c = wrapped_devnet["counters"]
    assert c["resilience/breaker/sigbackend/trips"] == 0
    assert c["resilience/breaker/sigbackend/fallback_calls"] == 0
    assert c["resilience/breaker/sigbackend/primary_calls"] > 0
    for op in ("ecrecover_addresses", "bls_verify_committees"):
        assert c[f"resilience/soundness/{op}/checks"] > 0, op
        assert c[f"resilience/soundness/{op}/mismatches"] == 0
        assert c[f"resilience/soundness/{op}/invariant_violations"] == 0
    assert c["serving/ecrecover/dispatches"] > 0
    assert c["serving/bls_committee/dispatches"] > 0
    for name, node in wrapped_devnet["nodes"].items():
        assert node.errors() == []
        if not name.startswith("proposer"):
            assert node.sig_backend.breaker.state_name == "closed"


def _txpool_through_serving(root):
    m = pkg(root)
    types = importlib.import_module(f"{root}.core.types")
    sp = importlib.import_module(f"{root}.core.state_processor")
    registry = m.metrics.Registry()
    serving = m.serving.ServingSigBackend(
        m.sig.PythonSigBackend(), m.serving.ServingConfig(flush_us=1000),
        registry=registry)
    broken = stub(m, "broken", ecrecover_addresses=lambda d, s: 1 / 0)
    out = []
    try:
        pool = m.txpool.TXPool(simulate_interval=None, sig_backend=serving)
        for nonce in range(3):
            tx = sp.sign_transaction(types.Transaction(
                nonce=nonce, gas_price=1, gas_limit=21000, value=1,
                payload=b"pay-%d" % nonce), 0x1234567 + nonce % 2)
            if nonce == 2:
                tx.s ^= 1                 # recovers some other address
            out.append(outcome(lambda: pool.submit(tx)))
        out.append(sorted((bytes(h).hex(), bytes(a).hex())
                          for h, a in pool._senders.items()))
        out.append(registry.counter("serving/ecrecover/requests").value)
        bad = m.txpool.TXPool(simulate_interval=None, sig_backend=broken)
        out.append(outcome(lambda: bad.submit(tx)))
    finally:
        serving.close()
    return out


def test_txpool_recovers_through_the_serving_tier():
    """A proposer's txpool behind the tier: each admission is a serving
    request (on the card, an `ecrecover` launch on the dispatch thread);
    a failing backend is a pool rejection, as in the JAX package."""
    got = _txpool_through_serving(PORT)
    assert got == _txpool_through_serving(REF)
    assert len(got[3]) == 3 and got[4] == 3
    assert got[5][0] == "TxPoolError"


def test_cli_node_loop_with_the_resilience_flags(caplog):
    from gethsharding_tpu_torch.node import cli

    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--deposit", "--runtime", "1.5",
         "--blocktime", "0.02", "--periodlength", "2", "--serving",
         "--serving-watchdog-s", "5", "--soundness-rate", "0.05",
         "--sigbackend", "failover-torch", "--chaos",
         "seed=1,client.sign=always"])
    assert (args.serving_max_batch, args.serving_flush_us,
            args.serving_queue_cap, args.serving_policy,
            args.serving_quota_rows) == (128, 500.0, 4096, "block", None)
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args, device="cpu") == 0
    text = caplog.text
    assert "period 1 sealed (block 2)" in text
    assert "sigbackend=failover+soundness+serving+chaos+torch" in text
    assert "targets a seam this node never wraps" in text
    assert "service error" not in text
    summary = json.loads(re.search(
        r"sigbackend failover\+soundness\+serving\+chaos\+torch at exit: "
        r"(\{.*\})", text).group(1))
    assert summary["state"] == "closed" and summary["launches"] == {}
    assert cli.run_cli(["sharding", "--chaos", "backend.x:mode=explode",
                        "--verbosity", "error"]) == 2


def test_cli_exit_summary_counts_the_breakers_routes(caplog):
    """The CLI's exit summary reads the breaker's counters: a primary that
    raises (a kernel that fails to build or launch) shows as a primary
    fault and a fallback call, though the caller got its answer from the
    host."""
    from gethsharding_tpu_torch.node import cli

    m = pkg(PORT)

    def explode(digests, sigs65):
        raise RuntimeError("kernel launch failed")

    failover = m.breaker.FailoverSigBackend(
        stub(m, ecrecover_addresses=explode), fallback=stub(m, name="host"))
    node = SimpleNamespace(sig_backend=failover)
    log = logging.getLogger("sharding.node")

    def summary():
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="sharding"):
            cli.log_failover_summary(log, node)
        return json.loads(re.search(r"at exit: (\{.*\})",
                                    caplog.text).group(1))

    before = summary()
    assert failover.ecrecover_addresses(DIGESTS, SIGS) == [
        d[:20] for d in DIGESTS]
    after = summary()
    keys = ("primary_calls", "primary_faults", "fallback_calls", "trips")
    assert {k: after[k] - before[k] for k in keys} == {
        "primary_calls": 1, "primary_faults": 1, "fallback_calls": 1,
        "trips": 0}
    assert after["state"] == "closed"
    caplog.clear()
    cli.log_failover_summary(log, SimpleNamespace(sig_backend=stub(m)))
    assert "at exit" not in caplog.text
